"""MoE training: the port's ``TrainStep`` over ``MoEForCausalLM`` vs the JAX package's, on CPU.

A JAX ``MoEForCausalLM`` is built from ``paddle.seed``; its parameters go
through numpy into the port (``models/bridge.py``), and both train on the
same token batch (inputs = labels) in float32, the port on its plain
versions. Bars:

  * gradients of step 1 (read off a JAX ``SGD(learning_rate=1.0)`` step,
    exact to an ulp of each parameter) within 1e-6 absolute;
  * ``MoEConfig.tiny()``, AdamW(1e-3), 2 steps, with the train fusions on
    and off (``tests/test_train_fusion.py``'s MoE case): losses within
    1e-5 relative, every parameter within 1e-5 absolute but for at most 2
    elements a tensor, which must lie within 5e-5. (Measured: one
    lm_head element is 1.01e-5 off after step 1; its gradient is 3.8e-9,
    a sum that cancels to 1e-6 of the tensor's largest, where AdamW's
    first step g / (|g| + 1e-8) turns an ulp-level difference in g into
    1e-5 of update. Every other element is within 3e-6.) The port's
    fused and unfused runs agree within 1e-5 everywhere;
  * AdamW8bit on a lane-aligned config, 2 steps, each from the JAX run's
    parameters and optimizer state: the loss within 1e-5 relative and each
    parameter's change within 5e-3 of the JAX step's, all but at most 4
    elements a tensor within 1e-5 (``tests/test_torch_train.py``'s bar and
    reasons); planted optimizer faults (no update, betas swapped) must
    fail it;
  * the MoE launch plan (``fusion.moe_train_kernel_launches_per_step``):
    the attention-half plans equal the JAX package's for every family set,
    the counts at 3 layers are pinned, and a CPU step calls each kernel's
    plain version exactly as often as the plan says its kernel launches.
"""

from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import optimizer as jopt
from paddle_tpu.framework import flags as jflags
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.models.moe import MoEConfig as JaxConfig
from paddle_tpu.models.moe import MoEForCausalLM as JaxMoE

from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.bridge import (load_numpy_params,
                                            optimizer_state_from_numpy)
from paddle_tpu_torch.models.moe import MoEConfig, MoEForCausalLM
from paddle_tpu_torch.ops.kernels import flash_attention as k1
from paddle_tpu_torch.ops.kernels import fused_norm_matmul as k2
from paddle_tpu_torch.ops.kernels import fused_norm_rope as k67
from paddle_tpu_torch.ops.kernels import fusion
from paddle_tpu_torch.ops.kernels import grouped_matmul as k1314

#: lane-aligned widths (every projection a multiple of 128)
LANE = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=64,
            rope_theta=10000.0, num_experts=4, top_k=2)


def _ids(shape=(2, 16), seed=6):
    return np.random.default_rng(seed).integers(0, 256, size=shape)


def _configs(lane=False):
    if lane:
        return JaxConfig(**LANE), MoEConfig(**LANE)
    return JaxConfig.tiny(), MoEConfig.tiny()


@contextlib.contextmanager
def _both_flags(**kw):
    old = ({k: jflags.get_flag(k) for k in kw},
           {k: tflags.get_flag(k) for k in kw})
    jflags.set_flags(kw)
    tflags.set_flags(kw)
    try:
        yield
    finally:
        jflags.set_flags(old[0])
        tflags.set_flags(old[1])


def _jax_run(jcfg, opt_name, ids, steps, lr=1e-3, seed=5):
    paddle.seed(seed)
    m = JaxMoE(jcfg)
    params = {n: np.asarray(p._array) for n, p in m.named_parameters()}
    opt = getattr(jopt, opt_name)(learning_rate=lr,
                                  parameters=m.parameters())
    step = JaxTrainStep(m, lambda o, lb: m.loss(o, lb), opt)
    t = paddle.to_tensor(ids.astype(np.int64))
    return params, [float(step(t, t)) for _ in range(steps)], step


def _port_run(cfg, opt_name, params, ids, steps):
    m = MoEForCausalLM(cfg, device="cpu")
    load_numpy_params(m, params)
    opt = getattr(topt, opt_name)(learning_rate=1e-3,
                                  parameters=m.parameters())
    step = TrainStep(m, lambda o, lb: m.loss(o, lb), opt)
    t = torch.tensor(ids)
    return m, [float(step(t, t)) for _ in range(steps)], step


def _final(jstep):
    return {n: np.asarray(a) for n, a in jstep.params.items()}


def _params(model):
    return {n: p.detach().float().numpy() for n, p in model.named_parameters()}


def test_moe_gradients_match_jax():
    jcfg, cfg = _configs()
    ids = _ids()
    params, _, jstep = _jax_run(jcfg, "SGD", ids, 1, lr=1.0)
    jgrad = {n: params[n] - p1 for n, p1 in _final(jstep).items()}
    model = MoEForCausalLM(cfg, device="cpu").train()
    load_numpy_params(model, params)
    t = torch.tensor(ids)
    model.loss(model(t), t).backward()
    assert sorted(jgrad) == sorted(n for n, _ in model.named_parameters())
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jgrad[n], rtol=0,
                                   atol=1e-6, err_msg=n)


@pytest.mark.parametrize("fused", [True, False])
def test_moe_train_step_adamw_matches_jax(fused):
    jcfg, cfg = _configs()
    ids = _ids()
    with _both_flags(fused_train=fused):
        assert bool(fusion.enabled_train_fusions()) == fused
        params, jl, jstep = _jax_run(jcfg, "AdamW", ids, 2)
        model, tl, _ = _port_run(cfg, "AdamW", params, ids, 2)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    ref, got = _final(jstep), _params(model)
    assert sorted(got) == sorted(ref)
    for n in got:
        diff = np.abs(got[n] - ref[n])
        assert diff.max() <= 5e-5, (n, diff.max())
        assert (diff > 1e-5).sum() <= 2, (n, (diff > 1e-5).sum())
    if fused:
        with _both_flags(fused_train=False):
            off, l_off, _ = _port_run(cfg, "AdamW", params, ids, 2)
        np.testing.assert_allclose(tl, l_off, rtol=1e-5)
        for n, a in _params(off).items():
            np.testing.assert_allclose(got[n], a, rtol=0, atol=1e-5,
                                       err_msg=n)


def _jax_opt_state(jstep):
    return {n: {k: np.asarray(v) for k, v in st.items()}
            for n, st in jstep._opt_state.items()}


def _assert_update_close(model, before, ref, tol=1e-5, few=4, wtol=5e-3):
    """Each tensor's change in the port against the JAX step's: every
    element within ``wtol``, all but ``few`` within ``tol`` (the few are
    float8 code flips; ``tests/test_torch_train.py`` says why)."""
    for n, p in model.named_parameters():
        diff = np.abs((p.detach().float().numpy() - before[n])
                      - (ref[n] - before[n]))
        assert diff.max() <= wtol, f"{n}: update differs by {diff.max()}"
        assert (diff > tol).sum() <= few, (
            f"{n}: update differs by over {tol} at {(diff > tol).sum()} "
            f"elements")


def _plant(optimizer, fault):
    if fault == "no_update":
        optimizer.update = lambda *a, **k: None
    elif fault == "betas_swapped":
        optimizer._beta1, optimizer._beta2 = (optimizer._beta2,
                                              optimizer._beta1)


@pytest.mark.parametrize("fault", [None, "no_update", "betas_swapped"])
def test_moe_train_step_adamw8bit_matches_jax(fault):
    jcfg, cfg = _configs(lane=True)
    ids = _ids()
    params, _, jstep = _jax_run(jcfg, "AdamW8bit", ids, 0)
    model, _, step = _port_run(cfg, "AdamW8bit", params, ids, 0)
    _plant(step.optimizer, fault)
    jt, tt = paddle.to_tensor(ids.astype(np.int64)), torch.tensor(ids)
    check = (pytest.raises(AssertionError, match="update differs")
             if fault else contextlib.nullcontext())
    with check:
        for _ in range(2):
            before = _final(jstep)
            load_numpy_params(model, before)
            optimizer_state_from_numpy(step.optimizer, _jax_opt_state(jstep),
                                       global_step=jstep._step_count)
            jl = float(jstep(jt, jt))
            tl = float(step(tt, tt))
            np.testing.assert_allclose(tl, jl, rtol=1e-5)
            _assert_update_close(model, before, _final(jstep))


def test_moe_launch_plan_counts(monkeypatch):
    """The plan at 3 layers (the chip's mixtral-8x7b-3L-train cell) with
    every family on: 9 K2, 3 K1, 3 K5, 12 K12, 4 K6, 4 K7, 18 K13, 9 K14 and
    33 K8 (10 tensors a layer + 3); with the families off no K2 and every norm
    in K6/K7. A CPU step of the tiny model calls each kernel's plain
    version as often as its plan says the kernel launches."""
    import paddle_tpu.ops.pallas.fusion as jfusion

    for enabled in (fusion.TRAIN_FUSIONS, ("attn_epilogue",),
                    ("norm_matmul",), ("moe_grouped_bwd",), ()):
        assert (fusion.train_layer_plan(enabled, attn_only=True)
                == jfusion.train_layer_plan(enabled, attn_only=True))
    plan = fusion.moe_train_kernel_launches_per_step(
        3, 33, enabled=fusion.TRAIN_FUSIONS)
    assert plan == {"flash_attention": 3, "flash_attention_bwd": 3,
                    "flash_attention_bwd_fused": 0, "fused_rope": 12,
                    "fused_norm_matmul": 9, "rms_norm_fwd": 4,
                    "rms_norm_bwd": 4, "grouped_matmul": 18,
                    "segment_dw": 9, "adamw8bit": 33}
    off = fusion.moe_train_kernel_launches_per_step(3, 33, enabled=())
    assert (off["fused_norm_matmul"], off["rms_norm_fwd"],
            off["segment_dw"], off["adamw8bit"]) == (0, 7, 0, 0)

    calls = dict.fromkeys(plan, 0)
    for mod, fn, key in (
            (k1, "flash_attention_fwd_reference", "flash_attention"),
            (k1, "flash_attention_bwd_reference", "flash_attention_bwd"),
            (k2, "_reference", "fused_norm_matmul"),
            (k67, "rms_norm_fwd_reference", "rms_norm_fwd"),
            (k67, "rms_norm_bwd_reference", "rms_norm_bwd"),
            (k67, "rope_reference", "fused_rope"),
            (k1314, "grouped_matmul_reference", "grouped_matmul"),
            (k1314, "segment_dw_reference", "segment_dw")):
        orig = getattr(mod, fn)
        monkeypatch.setattr(mod, fn, lambda *a, _o=orig, _k=key, **kw: (
            calls.__setitem__(_k, calls[_k] + 1), _o(*a, **kw))[1])
    _, cfg = _configs()
    model = MoEForCausalLM(cfg, device="cpu")
    n_tensors = sum(1 for _ in model.parameters())
    step = TrainStep(model, lambda o, lb: model.loss(o, lb),
                     topt.AdamW8bit(learning_rate=1e-3,
                                    parameters=model.parameters()))
    t = torch.tensor(_ids())
    step(t, t)
    want = fusion.moe_train_kernel_launches_per_step(
        cfg.num_hidden_layers, n_tensors)
    want.pop("adamw8bit")
    calls.pop("adamw8bit")
    assert n_tensors == 10 * cfg.num_hidden_layers + 3
    assert calls == want
