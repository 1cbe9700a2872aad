"""Fine-tuning on a left-padded batch: the port vs the JAX package, on CPU.

The fine-tuning step is ``TrainStep(model, loss, AdamW(LinearWarmup(
CosineAnnealingDecay(...)), grad_clip=ClipGradByGlobalNorm(...)))`` called
as ``step((ids, attn_mask), labels)``: a key-padding mask (bool, True on
real tokens) over a LEFT-padded batch of mixed lengths, so that the key
bias changes real rows (right padding would not: no real query sees a
right-pad key under the causal mask), and labels -100 on the pads and on
each row's prompt (its first quarter of real tokens). A JAX
``LlamaForCausalLM`` built from ``paddle.seed`` hands its parameters to the
port through numpy; both run in f32, the port on its plain versions. The
bars are ``tests/test_torch_train.py``'s:

  * ``LlamaConfig.tiny()``, AdamW, 3 steps, the global-norm clip active
    (the pre-clip norm is checked to exceed it) and the schedule's warm-up
    and decay: the step-1 clipped gradients within 1e-6 absolute (read off
    a JAX ``SGD(1.0)`` step with the same clip), losses within 1e-5
    relative, each step's learning rate equal to the JAX package's, every
    parameter within 1e-5 absolute but for at most 2 elements a tensor,
    which must lie within 5e-5 (``tests/test_torch_moe_train.py``'s bar:
    one down_proj element is 1.25e-5 off after 3 steps; its clipped
    gradient is 1.1e-9, where AdamW's g / (|g| + 1e-8) turns an ulp of
    gradient into 1e-5 of update; the gradients agree within 6e-8);
  * the same with ``recompute`` at ``core_attn``, with and without
    ``flash_save_residuals``: losses within 1e-5 of the JAX package's
    recompute run, parameters equal to the port's own run without
    recompute bit for bit (the mask rides the recompute as an input);
  * the same under ``flash_bwd_impl="fused"``: a CPU step calls the
    one-pass backward's plain version once a layer and the split one never
    (the dispatch picks K9's route), with the same losses and parameters;
  * AdamW8bit on the lane-aligned config, 2 steps, each from the JAX run's
    parameters and optimizer state: loss within 1e-5 relative and each
    parameter's change within 5e-3 of the JAX step's, all but at most 4
    elements a tensor within 1e-5 (float8 code flips);
  * ``accumulate_steps=2``: the loss within 1e-5 and the gradient the
    optimizer applies, merged in f32 and THEN clipped, within 1e-6 of the
    JAX package's (read off a JAX ``SGD(1.0)`` step with the same clip);
  * eval logits under the mask within 1e-5 at real positions, finite at
    the pads, and the mask matters (the unmasked logits move);
  * a general (per-query) mask routes to the plain attention, counted;
  * the MoE model: logits and aux under the mask within 1e-5, and its
    step-1 gradients (JAX ``SGD(1.0)``) within 1e-6.
"""

from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.framework import flags as jflags
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.moe import MoEConfig as JaxMoEConfig
from paddle_tpu.models.moe import MoEForCausalLM as JaxMoE
from paddle_tpu.optimizer import lr as jlr

from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.bridge import (load_numpy_params,
                                            optimizer_state_from_numpy)
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.models.moe import MoEConfig, MoEForCausalLM
from paddle_tpu_torch.ops import kernels as tkernels
from paddle_tpu_torch.ops.kernels import flash_attention as k1
from paddle_tpu_torch.optimizer import lr as tlr

LANE = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=64,
            rope_theta=10000.0)
LENGTHS = (16, 11, 5)     # real tokens per row of a 16-wide batch
CLIP = 0.5


def _batch(vocab, lengths=LENGTHS, s=16, seed=3):
    """(ids, mask (B, 1, 1, S) bool, labels) of a left-padded batch."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, vocab, size=(len(lengths), s))
    mask = np.zeros((len(lengths), s), bool)
    labels = ids.copy()
    for i, n in enumerate(lengths):
        ids[i, :s - n] = 0
        mask[i, s - n:] = True
        labels[i, :s - n + n // 4] = -100
    return ids, mask[:, None, None, :], labels


def _scheds():
    return (jlr.LinearWarmup(jlr.CosineAnnealingDecay(1e-3, T_max=10), 2,
                             2e-4, 1e-3),
            tlr.LinearWarmup(tlr.CosineAnnealingDecay(1e-3, T_max=10), 2,
                             2e-4, 1e-3))


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


def _jax_sft(jcfg, batch, steps, opt_name="AdamW", accumulate=1, lr=None):
    ids, mask, labels = batch
    paddle.seed(0)
    m = JaxLlama(jcfg)
    params = {n: np.asarray(p._array) for n, p in m.named_parameters()}
    sched = _scheds()[0] if lr is None else lr
    opt = getattr(jopt, opt_name)(learning_rate=sched,
                                  parameters=m.parameters(),
                                  grad_clip=jnn.ClipGradByGlobalNorm(CLIP))
    step = JaxTrainStep(m, lambda o, lb: m.loss(o, lb), opt,
                        accumulate_steps=accumulate)
    inputs = (paddle.to_tensor(ids.astype(np.int64)),
              paddle.to_tensor(mask))
    lb = paddle.to_tensor(labels.astype(np.int64))
    lrs, losses = [], []
    for _ in range(steps):
        lrs.append(opt.get_lr())
        losses.append(float(step(inputs, lb)))
    return params, losses, lrs, step


def _port_sft(cfg, params, batch, steps, opt_name="AdamW", accumulate=1):
    ids, mask, labels = batch
    m = LlamaForCausalLM(cfg, device="cpu")
    load_numpy_params(m, params)
    clip = tnn.ClipGradByGlobalNorm(CLIP)
    opt = getattr(topt, opt_name)(learning_rate=_scheds()[1],
                                  parameters=m.parameters(), grad_clip=clip)
    step = TrainStep(m, lambda o, lb: m.loss(o, lb), opt,
                     accumulate_steps=accumulate)
    inputs = (torch.tensor(ids), torch.tensor(mask))
    lrs, losses = [], []
    for _ in range(steps):
        losses.append(float(step(inputs, torch.tensor(labels))))
        lrs.append(step.last_lr)
    return m, losses, lrs, step


def _final(jstep):
    return {n: np.asarray(a) for n, a in jstep.params.items()}


def _assert_params(model, ref, wtol=1e-5, few=2, far=5e-5):
    """Every parameter within ``wtol`` of ``ref`` but for at most ``few``
    elements a tensor, which must lie within ``far``."""
    got = {n: p.detach().float().numpy() for n, p in model.named_parameters()}
    assert sorted(got) == sorted(ref)
    for n in got:
        diff = np.abs(got[n] - ref[n])
        assert diff.max() <= far, f"{n}: {diff.max()}"
        assert (diff > wtol).sum() <= few, (
            f"{n}: {(diff > wtol).sum()} elements past {wtol}")


def _clipped_step1_grads(cfg, params, batch):
    """{name: clipped gradient} of the port's first step."""
    ids, mask, labels = batch
    m = LlamaForCausalLM(cfg, device="cpu").train()
    load_numpy_params(m, params)
    m.loss(m(torch.tensor(ids), torch.tensor(mask)),
           torch.tensor(labels)).backward()
    named = sorted(m.named_parameters())
    clip = tnn.ClipGradByGlobalNorm(CLIP)
    out = clip([(p, p.grad) for _, p in named])
    assert clip.last_global_norm.item() > CLIP
    return {n: g for (n, _), (_, g) in zip(named, out)}


def test_sft_step_adamw_clip_schedule_matches_jax():
    jcfg, cfg = JaxConfig.tiny(), LlamaConfig.tiny()
    batch = _batch(cfg.vocab_size)
    params, jl, jlrs, jstep = _jax_sft(jcfg, batch, 3)
    _, _, _, jsgd = _jax_sft(jcfg, batch, 1, "SGD", lr=1.0)
    for n, g in _clipped_step1_grads(cfg, params, batch).items():
        np.testing.assert_allclose(g.numpy(), params[n] - _final(jsgd)[n],
                                   rtol=0, atol=1e-6, err_msg=n)
    model, tl, tlrs, step = _port_sft(cfg, params, batch, 3)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tlrs == jlrs and len(set(tlrs)) == 3
    assert step.optimizer._grad_clip.last_global_norm.item() > CLIP
    _assert_params(model, _final(jstep))


@pytest.mark.parametrize("keep", [False, True])
def test_sft_recompute_core_attn_with_the_mask(keep):
    kw = dict(recompute=True, recompute_granularity="core_attn")
    jcfg, cfg = JaxConfig.tiny(**kw), LlamaConfig.tiny(**kw)
    batch = _batch(cfg.vocab_size)
    with _both_flags(flash_save_residuals=keep):
        params, jl, _, _ = _jax_sft(jcfg, batch, 3)
        model, tl, _, _ = _port_sft(cfg, params, batch, 3)
    model0, tl0, _, _ = _port_sft(LlamaConfig.tiny(), params, batch, 3)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl == tl0
    for (n, p), (_, p0) in zip(model.named_parameters(),
                               model0.named_parameters()):
        assert torch.equal(p, p0), n


def test_sft_fused_backward_route_matches_jax(monkeypatch):
    jcfg, cfg = JaxConfig.tiny(), LlamaConfig.tiny()
    batch = _batch(cfg.vocab_size)
    calls = {"split": 0, "fused": 0}
    for name, key in (("flash_attention_bwd_reference", "split"),
                      ("flash_attention_bwd_fused_reference", "fused")):
        orig = getattr(k1, name)
        monkeypatch.setattr(k1, name, lambda *a, _o=orig, _k=key: (
            calls.__setitem__(_k, calls[_k] + 1), _o(*a))[1])
    with _both_flags(flash_bwd_impl="fused"):
        params, jl, _, jstep = _jax_sft(jcfg, batch, 2)
        model, tl, _, _ = _port_sft(cfg, params, batch, 2)
    assert calls == {"split": 0, "fused": 2 * cfg.num_hidden_layers}
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _assert_params(model, _final(jstep))


def _assert_update_close(model, before, ref, tol=1e-5, few=4, wtol=5e-3):
    for n, p in model.named_parameters():
        diff = np.abs((p.detach().float().numpy() - before[n])
                      - (ref[n] - before[n]))
        assert diff.max() <= wtol, f"{n}: update differs by {diff.max()}"
        assert (diff > tol).sum() <= few, (
            f"{n}: update differs by over {tol} at {(diff > tol).sum()} "
            f"elements")


def test_sft_step_adamw8bit_matches_jax():
    jcfg, cfg = JaxConfig(**LANE), LlamaConfig(**LANE)
    batch = _batch(cfg.vocab_size)
    params, _, _, jstep = _jax_sft(jcfg, batch, 0, "AdamW8bit")
    model, _, _, step = _port_sft(cfg, params, batch, 0, "AdamW8bit")
    ids, mask, labels = batch
    jin = (paddle.to_tensor(ids.astype(np.int64)), paddle.to_tensor(mask))
    jlb = paddle.to_tensor(labels.astype(np.int64))
    tin = (torch.tensor(ids), torch.tensor(mask))
    for _ in range(2):
        before = _final(jstep)
        load_numpy_params(model, before)
        optimizer_state_from_numpy(
            step.optimizer, {n: {k: np.asarray(v) for k, v in st.items()}
                             for n, st in jstep._opt_state.items()},
            global_step=jstep._step_count)
        assert step.optimizer.get_lr() == jstep.optimizer.get_lr()
        jl = float(jstep(jin, jlb))
        tl = float(step(tin, torch.tensor(labels)))
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        _assert_update_close(model, before, _final(jstep))


def test_sft_gradient_merge_clips_after_the_merge():
    jcfg, cfg = JaxConfig.tiny(), LlamaConfig.tiny()
    ids, mask, labels = _batch(cfg.vocab_size, lengths=(16, 9, 12, 4))
    batch = tuple(x.reshape(2, 2, *x.shape[1:]) for x in (ids, mask, labels))
    params, jl, _, jstep = _jax_sft(jcfg, batch, 1, "SGD", accumulate=2,
                                    lr=1.0)
    model, _, _, step = _port_sft(cfg, params, batch, 0, accumulate=2)
    seen = []
    clip = step.optimizer._grad_clip
    step.optimizer._grad_clip = lambda pg: seen.append(clip(pg)) or seen[-1]
    loss = float(step((torch.tensor(batch[0]), torch.tensor(batch[1])),
                      torch.tensor(batch[2])))
    np.testing.assert_allclose(loss, jl[0], rtol=1e-5)
    assert clip.last_global_norm.item() > CLIP
    names = sorted(n for n, _ in model.named_parameters())
    jgrad = {n: params[n] - p1 for n, p1 in _final(jstep).items()}
    assert len(seen[0]) == len(names)
    for n, (_, g) in zip(names, seen[0]):       # sorted-name order
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), jgrad[n], rtol=0, atol=1e-6,
                                   err_msg=n)


def test_eval_logits_with_the_mask_match_jax():
    jcfg, cfg = JaxConfig.tiny(), LlamaConfig.tiny()
    ids, mask, _ = _batch(cfg.vocab_size)
    paddle.seed(0)
    jm = JaxLlama(jcfg)
    jm.eval()
    params = {n: np.asarray(p._array) for n, p in jm.named_parameters()}
    want = np.asarray(jm(paddle.to_tensor(ids.astype(np.int64)),
                         paddle.to_tensor(mask))._array)
    tm = LlamaForCausalLM(cfg, device="cpu")
    load_numpy_params(tm, params)
    for m in (mask, mask[:, 0, 0, :]):          # (B,1,1,S) and (B,S)
        got = tm(torch.tensor(ids), torch.tensor(m)).numpy()
        real = mask[:, 0, 0, :]
        np.testing.assert_allclose(got[real], want[real], rtol=1e-5,
                                   atol=1e-5)
        assert np.isfinite(got).all()
    free = tm(torch.tensor(ids)).numpy()
    assert np.abs(free[real] - want[real]).max() > 1e-2


def test_general_mask_routes_to_the_plain_attention():
    """A per-query (B, 1, S, S) mask is not key-level: the port sends it to
    the plain attention, as the JAX package sends it to its reference
    lowering, and counts the route; the logits match the JAX package's."""
    jcfg, cfg = JaxConfig.tiny(), LlamaConfig.tiny()
    ids, mask, _ = _batch(cfg.vocab_size)
    full = np.broadcast_to(mask, (3, 1, 16, 16)) & np.tril(
        np.ones((16, 16), bool))[None, None]
    full = full | np.eye(16, dtype=bool)[None, None]
    paddle.seed(0)
    jm = JaxLlama(jcfg)
    jm.eval()
    params = {n: np.asarray(p._array) for n, p in jm.named_parameters()}
    want = np.asarray(jm(paddle.to_tensor(ids.astype(np.int64)),
                         paddle.to_tensor(full))._array)
    tm = LlamaForCausalLM(cfg, device="cpu")
    load_numpy_params(tm, params)
    tkernels.reset_launch_counts()
    got = tm(torch.tensor(ids), torch.tensor(full)).numpy()
    assert tkernels.route_counts() == {
        "plain_attention_route": cfg.num_hidden_layers}
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    tkernels.reset_launch_counts()
    tm(torch.tensor(ids), torch.tensor(mask))
    assert tkernels.route_counts() == {"plain_attention_route": 0}


def _moe_pair(seed=5):
    jcfg, cfg = JaxMoEConfig.tiny(), MoEConfig.tiny()
    paddle.seed(seed)
    jm = JaxMoE(jcfg)
    params = {n: np.asarray(p._array) for n, p in jm.named_parameters()}
    tm = MoEForCausalLM(cfg, device="cpu")
    load_numpy_params(tm, params)
    return jcfg, jm, tm, params


def test_moe_forward_and_gradients_with_the_mask_match_jax():
    jcfg, jm, tm, params = _moe_pair()
    ids, mask, labels = _batch(jcfg.vocab_size)
    jin = (paddle.to_tensor(ids.astype(np.int64)), paddle.to_tensor(mask))
    jm.eval()
    jl, ja = jm(*jin)
    with torch.no_grad():
        tl, ta = tm(torch.tensor(ids), torch.tensor(mask))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl._array), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(ta.item(), float(np.asarray(ja._array)),
                               rtol=1e-5)
    # step-1 gradients under the mask: a JAX SGD(1.0) step's p0 - p1
    jm.train()
    opt = jopt.SGD(learning_rate=1.0, parameters=jm.parameters())
    jstep = JaxTrainStep(jm, lambda o, lb: jm.loss(o, lb), opt)
    jstep(jin, paddle.to_tensor(labels.astype(np.int64)))
    jgrad = {n: params[n] - np.asarray(a) for n, a in jstep.params.items()}
    tm.train()
    tm.loss(tm(torch.tensor(ids), torch.tensor(mask)),
            torch.tensor(labels)).backward()
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jgrad[n], rtol=0,
                                   atol=1e-6, err_msg=n)
