"""Llama training: the port's ``TrainStep`` vs the JAX package's, on CPU.

A JAX ``LlamaForCausalLM`` is built from ``paddle.seed(0)``; its parameters
go through numpy into the port (``models/bridge.py``). Both train on the
same token batch (inputs = labels, the next-token loss) for a few steps in
float32, the port on its plain versions. The bars are the JAX package's
own train-fusion bars (``tests/test_train_fusion.py``):

  * ``LlamaConfig.tiny()``, AdamW(1e-3), 3 steps: losses within 1e-5
    relative, every parameter within 1e-5 absolute — plain, with
    ``fused_head_loss`` (a 7-token loss chunk that does not divide the 30
    tokens), and with ``recompute`` at ``core_attn`` granularity (whose
    parameters equal the port's run without recompute bit for bit; see
    the test for why they are held to the reference's plain run);
  * the lane-aligned config of the JAX package's kernels-live test with
    AdamW8bit, 2 steps, each from the JAX run's parameters and optimizer
    state, loaded through the bridge: every parameter's change within 5e-3
    of the JAX package's change, and all but at most 4 elements a tensor
    within 1e-5 (a step moves a weight by ~1e-3; the few are float8 code
    flips); planted faults (no update, beta1 and beta2 swapped) must fail
    that bar; and a free 2-step run whose losses agree within 1e-5
    relative, the second tied to the first update;
  * ``accumulate_steps=2`` (two microbatches, one update): the loss within
    1e-5 and the merged f32 gradient within 1e-6 of the JAX package's (the
    test says why not the parameters after AdamW);
  * the port with its train fusions off (``fused_train=False``: the
    unfused train plan) equals the port with them on: losses within 1e-5
    relative, parameters within 1e-5 (the JAX package's fused-vs-unfused
    bar; only rms_norm's forward and backward formulas differ, in f32);
  * ``flash_save_residuals`` under ``core_attn``: the recompute reuses the
    first forward's (out, lse), half the flash forwards, same parameters;
  * the optimizer-state bridge: the port's AdamW8bit state round-trips
    through numpy bit for bit, and the JAX state after one step, loaded
    into the port, makes the JAX package's second update (the AdamW8bit
    bar above).
"""

from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import optimizer as jopt
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama

from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.bridge import (load_numpy_params,
                                            optimizer_state_from_numpy,
                                            optimizer_state_to_numpy)
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops.kernels import fusion

#: tests/test_train_fusion.py's kernels-live config (lane-aligned widths)
LANE = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=64,
            rope_theta=10000.0)


def _ids(vocab, shape, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, size=shape)


def _configs(kw, lane=False):
    if lane:
        return JaxConfig(**LANE, **kw), LlamaConfig(**LANE, **kw)
    return JaxConfig.tiny(**kw), LlamaConfig.tiny(**kw)


def _jax_run(jcfg, opt_name, ids, steps, accumulate=1, lr=1e-3):
    paddle.seed(0)
    m = JaxLlama(jcfg)
    params = {n: np.asarray(p._array) for n, p in m.named_parameters()}
    opt = getattr(jopt, opt_name)(learning_rate=lr,
                                  parameters=m.parameters())
    step = JaxTrainStep(m, lambda lg, lb: m.loss(lg, lb), opt,
                        accumulate_steps=accumulate)
    t = paddle.to_tensor(ids.astype(np.int64))
    losses = [float(step(t, t)) for _ in range(steps)]
    return params, losses, step


def _port_run(cfg, opt_name, params, ids, steps, accumulate=1):
    m = LlamaForCausalLM(cfg, device="cpu")
    load_numpy_params(m, params)
    opt = getattr(topt, opt_name)(learning_rate=1e-3,
                                  parameters=m.parameters())
    step = TrainStep(m, lambda o, lb: m.loss(o, lb), opt,
                     accumulate_steps=accumulate)
    t = torch.tensor(ids)
    losses = [float(step(t, t)) for _ in range(steps)]
    return m, losses, step


def _final(jstep):
    return {n: np.asarray(a) for n, a in jstep.params.items()}


def _assert_close(model, losses, ref_params, ref_losses, wtol, ltol=1e-5):
    np.testing.assert_allclose(losses, ref_losses, rtol=ltol)
    got = {n: p.detach().float().numpy() for n, p in model.named_parameters()}
    assert sorted(got) == sorted(ref_params)
    for n in got:
        np.testing.assert_allclose(got[n], ref_params[n], rtol=0, atol=wtol,
                                   err_msg=n)


@contextlib.contextmanager
def _port_flags(**kw):
    old = {k: tflags.get_flag(k) for k in kw}
    tflags.set_flags(kw)
    try:
        yield
    finally:
        tflags.set_flags(old)


@pytest.mark.parametrize("variant", ["plain", "fused_head"])
def test_train_step_adamw_matches_jax(variant):
    kw = {"plain": {},
          "fused_head": dict(fused_head_loss=True, loss_chunk_size=7)}[
              variant]
    jcfg, cfg = _configs(kw)
    ids = _ids(jcfg.vocab_size, (2, 16))
    params, jl, jstep = _jax_run(jcfg, "AdamW", ids, 3)
    model, tl, _ = _port_run(cfg, "AdamW", params, ids, 3)
    _assert_close(model, tl, _final(jstep), jl, wtol=1e-5)


def test_train_step_adamw_recompute_matches_jax():
    """``recompute`` at ``core_attn``: the port's losses match the JAX
    package's recompute run (1e-5), and its parameters equal its own run
    without recompute BIT FOR BIT (the gradients must not depend on the
    granularity), which is held to the JAX run without recompute at 1e-5.
    The JAX package's two runs themselves differ by up to 4.7e-5 at one
    lm_head element after 3 steps (XLA orders the rematerialized sums
    differently; that element's gradient is near 0, where Adam's m/sqrt(v)
    turns an ulp of gradient into a visible step), so a 1e-5 bar holds
    against the reference's plain run, not across its two lowerings."""
    jcfg, cfg = _configs(dict(recompute=True,
                              recompute_granularity="core_attn"))
    jcfg0, cfg0 = _configs({})
    ids = _ids(jcfg.vocab_size, (2, 16))
    params, jl, _ = _jax_run(jcfg, "AdamW", ids, 3)
    _, jl0, jstep0 = _jax_run(jcfg0, "AdamW", ids, 3)
    model, tl, _ = _port_run(cfg, "AdamW", params, ids, 3)
    model0, tl0, _ = _port_run(cfg0, "AdamW", params, ids, 3)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl == tl0
    for (n, p), (_, p0) in zip(model.named_parameters(),
                               model0.named_parameters()):
        assert torch.equal(p, p0), n
    _assert_close(model0, tl0, _final(jstep0), jl0, wtol=1e-5)


def _jax_opt_state(jstep):
    return {n: {k: np.asarray(v) for k, v in st.items()}
            for n, st in jstep._opt_state.items()}


def _assert_update_close(model, before, ref, tol=1e-5, few=4, wtol=5e-3):
    """One optimizer step from the common parameters ``before``: each
    tensor's change in the port (its parameters now minus ``before``)
    against the JAX package's (``ref`` minus ``before``). Every element
    within ``wtol``, all but ``few`` of each tensor within ``tol``, well
    under a step's ~lr = 1e-3 move: the few are float8 code flips, where
    an ulp of gradient rounds a moment to the next e4m3 code (1/8 of its
    value apart)."""
    for n, p in model.named_parameters():
        diff = np.abs((p.detach().float().numpy() - before[n])
                      - (ref[n] - before[n]))
        assert diff.max() <= wtol, f"{n}: update differs by {diff.max()}"
        assert (diff > tol).sum() <= few, (
            f"{n}: update differs by over {tol} at {(diff > tol).sum()} "
            f"elements")


def _plant(optimizer, fault):
    """A planted optimizer fault the AdamW8bit parity bar must catch."""
    if fault == "no_update":
        optimizer.update = lambda *a, **k: None
    elif fault == "betas_swapped":
        optimizer._beta1, optimizer._beta2 = (optimizer._beta2,
                                              optimizer._beta1)


@pytest.mark.parametrize("fault", [None, "no_update", "betas_swapped"])
def test_train_step_adamw8bit_matches_jax(fault):
    """AdamW8bit on the lane-aligned config, in two ways.

    Synced, 2 steps: before each port step the JAX run's parameters and
    optimizer state are loaded into the port (``models/bridge.py``); the
    loss is held at 1e-5 relative and each parameter's change to the JAX
    step's change (``_assert_update_close``: at most 1 element a tensor
    lies past 1e-5 here, at most 6.2e-4). Free, 2 steps: the losses agree
    within 1e-5 relative (1.3e-6 at step 2 here), so the second is tied to
    the port's own first update. (The parameters of a free run are not
    held past step 1: ulp-level gradient differences flip 1 m code and 1 v
    code of lm_head's 32,768 at step 1, and after step 2 one element lies
    8.6e-3 away, since Adam's m/sqrt(v) divides by the coarsest code.)

    A planted fault in the port's optimizer (``fault``) must fail the
    synced update bar: skipping the update, or swapping beta1 and beta2
    (the same first step, a far-off second)."""
    jcfg, cfg = _configs({}, lane=True)
    ids = _ids(jcfg.vocab_size, (2, 16))
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
    if fault is None:
        _, jl, _ = _jax_run(jcfg, "AdamW8bit", ids, 2)
        _, tl, _ = _port_run(cfg, "AdamW8bit", params, ids, 2)
        np.testing.assert_allclose(tl, jl, rtol=1e-5)


def test_train_step_gradient_merge_matches_jax():
    """``accumulate_steps=2`` (two microbatches, one update): the merged
    step's loss and its mean f32 gradient against the JAX package's. The
    JAX gradient is read off a JAX ``SGD(learning_rate=1.0)`` step (p0 - p1,
    exact to an ulp of p, ~1e-8); the port's is the f32 mean it hands its
    optimizer, and its AdamW step from that gradient equals a plain AdamW
    step with the same gradient bit for bit. (Parameters after merged AdamW
    steps are not compared to 1e-5: one up_proj element of 8,192 has a
    merged gradient of -3.1e-8, against 4.1e-3 typical, where AdamW's
    g / (|g| + 1e-8) turns an ulp of gradient into 1.2e-5 of update.)"""
    jcfg, cfg = _configs({})
    ids = _ids(jcfg.vocab_size, (2, 2, 12))       # 2 microbatches of 2
    params, jl, jstep = _jax_run(jcfg, "SGD", ids, 1, accumulate=2,
                                 lr=1.0)
    model, tl, step = _port_run(cfg, "AdamW", params, ids, 0, accumulate=2)
    seen = {}
    adam_step = step.optimizer.step
    step.optimizer.step = lambda grads: (seen.update(grads),
                                         adam_step(grads=grads))
    t = torch.tensor(ids)
    loss = float(step(t, t))
    np.testing.assert_allclose(loss, jl[0], rtol=1e-5)
    jgrad = {n: params[n] - p1 for n, p1 in _final(jstep).items()}
    assert sorted(seen) == sorted(jgrad)
    for n in seen:
        assert seen[n].dtype == torch.float32
        np.testing.assert_allclose(seen[n].numpy(), jgrad[n], rtol=0,
                                   atol=1e-6, err_msg=n)
    ref = LlamaForCausalLM(cfg, device="cpu").train()
    load_numpy_params(ref, params)
    opt = topt.AdamW(learning_rate=1e-3,
                     parameters=list(ref.named_parameters()))
    opt.step(grads=seen)
    for (n, p), (_, r) in zip(model.named_parameters(),
                              ref.named_parameters()):
        assert torch.equal(p, r), n


def test_train_fusions_on_and_off_agree():
    jcfg, cfg = _configs(dict(recompute=True))
    paddle.seed(0)
    params = {n: np.asarray(p._array)
              for n, p in JaxLlama(jcfg).named_parameters()}
    ids = _ids(cfg.vocab_size, (2, 16))
    on, l_on, _ = _port_run(cfg, "AdamW", params, ids, 3)
    with _port_flags(fused_train=False):
        assert fusion.enabled_train_fusions() == ()
        off, l_off, _ = _port_run(cfg, "AdamW", params, ids, 3)
    ref = {n: p.detach().numpy() for n, p in off.named_parameters()}
    _assert_close(on, l_on, ref, l_off, wtol=1e-5)


def test_flash_save_residuals_skips_the_recompute_forward(monkeypatch):
    """``core_attn`` with ``flash_save_residuals`` keeps the attention's
    (out, lse) from the first forward, so the recompute in backward runs
    the flash forward L times a step instead of 2L; the parameters do not
    change."""
    from paddle_tpu_torch.ops.kernels import flash_attention as k1

    jcfg, cfg = _configs(dict(recompute=True,
                              recompute_granularity="core_attn"))
    paddle.seed(0)
    params = {n: np.asarray(p._array)
              for n, p in JaxLlama(jcfg).named_parameters()}
    ids = _ids(cfg.vocab_size, (2, 16))
    calls = []
    fwd = k1.flash_attention_fwd_reference
    monkeypatch.setattr(k1, "flash_attention_fwd_reference",
                        lambda *a: calls.append(1) or fwd(*a))
    runs = {}
    for keep in (False, True):
        calls.clear()
        with _port_flags(flash_save_residuals=keep):
            runs[keep] = _port_run(cfg, "AdamW", params, ids, 2)
        L = cfg.num_hidden_layers
        assert len(calls) == 2 * L * (1 if keep else 2), (keep, len(calls))
    assert runs[False][1] == runs[True][1]
    for (n, a), (_, b) in zip(runs[False][0].named_parameters(),
                              runs[True][0].named_parameters()):
        assert torch.equal(a, b), n


def test_optimizer_state_bridge():
    jcfg, cfg = _configs({}, lane=True)
    ids = _ids(jcfg.vocab_size, (2, 16))
    params, jl, jstep = _jax_run(jcfg, "AdamW8bit", ids, 1)
    # the JAX state after step 1 -> the port, then one more step in both
    jstate = _jax_opt_state(jstep)
    before = _final(jstep)
    model, _, step = _port_run(cfg, "AdamW8bit", before, ids, 0)
    optimizer_state_from_numpy(step.optimizer, jstate,
                               global_step=jstep._step_count)
    t = torch.tensor(ids)
    loss = float(step(t, t))
    jl2 = float(jstep(paddle.to_tensor(ids.astype(np.int64)),
                      paddle.to_tensor(ids.astype(np.int64))))
    np.testing.assert_allclose(loss, jl2, rtol=1e-5)
    _assert_update_close(model, before, _final(jstep))
    # the port's state round-trips bit for bit
    out = optimizer_state_to_numpy(step.optimizer)
    assert sorted(out) == sorted(jstate)
    for name, st in out.items():
        assert st["m_q"].dtype == np.uint8
        before = {k: v.clone() for k, v in step.optimizer.state()[name]
                  .items()}
        optimizer_state_from_numpy(step.optimizer, {name: st})
        for k, v in step.optimizer.state()[name].items():
            assert torch.equal(v.view(torch.uint8) if v.dtype ==
                               torch.float8_e4m3fn else v,
                               before[k].view(torch.uint8) if v.dtype ==
                               torch.float8_e4m3fn else before[k])
    with pytest.raises(KeyError):
        optimizer_state_from_numpy(step.optimizer, {"nope": {}})


def test_train_launch_plan_counts():
    """The train plans equal the JAX package's for every family set, and
    the plan-derived kernel launches of one train step at the chip's
    8-layer recipe: 2 K1 and 10 K2 a layer under recompute (1 K1 with
    ``flash_save_residuals``), one K5 a layer (one K9 instead under
    ``flash_bwd_impl="fused"`` where the backward's dispatch takes it), 6
    K12 a layer (q and k, forward twice, backward once), the final norm in
    K6/K7, one K8 per parameter tensor (9 per layer + 3)."""
    import paddle_tpu.ops.pallas.fusion as jfusion

    for enabled in (fusion.TRAIN_FUSIONS, ("attn_epilogue",),
                    ("norm_matmul",), ()):
        assert (fusion.train_layer_plan(enabled)
                == jfusion.train_layer_plan(enabled))
        assert (fusion.train_head_plan(enabled)
                == jfusion.train_head_plan(enabled))
        assert fusion.train_opt_plan(enabled) == jfusion.train_opt_plan(
            enabled)
    kw = dict(recompute=True, granularity="core_attn", fused_head_loss=True)
    plan = fusion.train_kernel_launches_per_step(
        8, 9 * 8 + 3, enabled=fusion.TRAIN_FUSIONS, **kw)
    assert plan == {"flash_attention": 16, "flash_attention_bwd": 8,
                    "flash_attention_bwd_fused": 0, "fused_rope": 48,
                    "fused_norm_matmul": 80, "rms_norm_fwd": 1,
                    "rms_norm_bwd": 1, "adamw8bit": 75}
    with _port_flags(flash_bwd_impl="fused"):
        with pytest.raises(ValueError, match="attn_shape"):
            fusion.train_kernel_launches_per_step(
                8, 75, enabled=fusion.TRAIN_FUSIONS, **kw)
        fused = fusion.train_kernel_launches_per_step(
            8, 75, enabled=fusion.TRAIN_FUSIONS,
            attn_shape=(4, 2048, 32, 128), **kw)
        # past the JAX package's 512 MiB cap on the dQ partials: K5
        capped = fusion.train_kernel_launches_per_step(
            8, 75, enabled=fusion.TRAIN_FUSIONS,
            attn_shape=(1, 8192, 17, 128), **kw)
    assert fused == {**plan, "flash_attention_bwd": 0,
                     "flash_attention_bwd_fused": 8}
    assert capped == plan
    with _port_flags(flash_save_residuals=True):
        keep = fusion.train_kernel_launches_per_step(
            8, 75, enabled=fusion.TRAIN_FUSIONS, **kw)
    assert keep["flash_attention"] == 8
    off = fusion.train_kernel_launches_per_step(8, 75, enabled=(), **kw)
    assert (off["fused_norm_matmul"], off["rms_norm_fwd"],
            off["rms_norm_bwd"], off["adamw8bit"]) == (0, 33, 17, 0)
