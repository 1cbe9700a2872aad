"""The training slice's kernels' plain versions vs the JAX package, on CPU.

Same numpy inputs through the JAX function (its Pallas kernel in interpret
mode, as the JAX package's own kernel tests run it) and the port's
counterpart, which on CPU tensors runs the kernel's plain version:

  * K5 (flash backward): the port's plain (out, lse) forward and
    backward vs ``_flash_core`` and its custom VJP (``_pallas_fwd`` and the
    split ``_pallas_bwd``), B=1, S 128 and 192 (padded tiles), H=4, Hk 2
    and 4, D=128, causal. f32: both compute the same f32 formulas, in
    other orders — 2e-5 relative to each gradient's largest element. bf16:
    both round p and ds to bf16 before their products and each gradient
    once, but the interpret kernel's forward normalizes its output after
    rounding p and the plain one before, so out, Delta and every rounded
    value may differ by a bf16 ulp or two — 3e-2 relative to the largest
    element (a 2^-6 ulp of its magnitude, with room 2);
  * K6/K7 (RMSNorm): ``fused_rms_norm`` forward and its gradients vs the
    JAX package's ``fused_rms_norm`` with its Pallas kernels — f32 within
    1e-6 (summation order only); bf16 within one bf16 ulp of the output
    (2^-7 relative) and of dx, dw (f32 sums of bf16 products, cast);
  * K8 (AdamW8bit): the plain update vs ``adamw8bit_reference`` and the
    interpret-mode ``_pallas_adamw8bit`` over 3 steps, weight decay on and
    off, with an f32 param and with a bf16 param plus f32 master, at an odd
    size: m/v codes BIT-IDENTICAL, scales within 3e-7 relative, params and
    master within step * 3e-7 (the JAX package's own bars for its fused
    kernel, ``tests/test_train_fusion.py``);
  * the chunked ``linear_cross_entropy`` (a chunk that does not divide N,
    ignored labels, untied and tied weights): loss and gradients vs the
    JAX package's, f32, 1e-5 relative.
"""

from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import loss_ops
from paddle_tpu_torch.ops.kernels import flash_attention as k1
from paddle_tpu_torch.ops.kernels import fused_norm_rope as k67
from paddle_tpu_torch.ops.kernels import fused_optimizer_update as k8

fa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")
fnr = importlib.import_module("paddle_tpu.ops.pallas.fused_norm_rope")
fou = importlib.import_module("paddle_tpu.ops.pallas.fused_optimizer_update")
jloss = importlib.import_module("paddle_tpu.ops.loss_ops")

_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a, dtype):
    """The same values as a JAX array and a CPU torch tensor."""
    jd, td = _DT[dtype]
    j = jnp.asarray(a, jd)
    t = torch.tensor(np.asarray(j.astype(jnp.float32))).to(td)
    return j, t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ------------------------------------------------------------------ K5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,hk", [(128, 2), (192, 4)])
def test_flash_bwd_plain_matches_pallas(monkeypatch, dtype, s, hk):
    monkeypatch.setattr(fa, "_INTERPRET", True)
    rng = np.random.default_rng(s + hk)
    h, d = 4, 128
    (qj, qt), (kj, kt), (vj, vt), (gj, gt) = (
        _pair(rng.normal(size=shape) * 0.3, dtype)
        for shape in ((1, s, h, d), (1, s, hk, d), (1, s, hk, d),
                      (1, s, h, d)))
    scale = 1.0 / np.sqrt(d)
    out_j, vjp = jax.vjp(
        lambda q, k, v: fa._flash_core(q, k, v, None, True, scale),
        qj, kj, vj)
    grads_j = vjp(gj)
    out_t, lse_t = k1.flash_attention_fwd(qt, kt, vt, causal=True)
    grads_t = k1.flash_attention_bwd(qt, kt, vt, out_t, lse_t, gt,
                                     causal=True)
    rel = 2e-5 if dtype == "float32" else 3e-2
    for name, a, b in zip(("out", "dq", "dk", "dv"),
                          (out_t,) + tuple(grads_t),
                          (out_j,) + tuple(grads_j)):
        a, b = _np(a), _np(b)
        err = np.abs(a - b).max() / np.abs(b).max()
        assert err <= rel, f"{name}: {err:.2e} > {rel}"


def test_flash_train_autograd_equals_the_wrappers():
    """flash_attention_train's gradients are the plain backward's."""
    rng = np.random.default_rng(7)
    q, k, v = (torch.tensor(rng.normal(size=sh) * 0.3, dtype=torch.float32,
                            requires_grad=True)
               for sh in ((2, 40, 4, 128), (2, 40, 2, 128), (2, 40, 2, 128)))
    g = torch.tensor(rng.normal(size=(2, 40, 4, 128)), dtype=torch.float32)
    k1.flash_attention_train(q, k, v).backward(g)
    with torch.no_grad():
        out, lse = k1.flash_attention_fwd(q, k, v, causal=True)
        ref = k1.flash_attention_bwd(q, k, v, out, lse, g, causal=True)
    for a, b in zip((q.grad, k.grad, v.grad), ref):
        assert torch.equal(a, b)


# ------------------------------------------------------------------ K6/K7


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_plain_matches_pallas(monkeypatch, dtype):
    monkeypatch.setattr(fnr, "_INTERPRET", True)
    rng = np.random.default_rng(3)
    (xj, xt), (gj, gt) = (_pair(rng.normal(size=(2, 8, 256)), dtype)
                          for _ in range(2))
    wj, wt = _pair(rng.random(256) + 0.5, dtype)
    out_j, vjp = jax.vjp(lambda x, w: fnr.fused_rms_norm(x, w, 1e-5),
                         xj, wj)
    dx_j, dw_j = vjp(gj)
    xt.requires_grad_(True)
    wt.requires_grad_(True)
    out_t = k67.fused_rms_norm(xt, wt, 1e-5)
    out_t.backward(gt)
    tol = 1e-6 if dtype == "float32" else 2.0 ** -7
    for name, a, b in (("out", out_t, out_j), ("dx", xt.grad, dx_j),
                       ("dw", wt.grad, dw_j)):
        a, b = _np(a), _np(b)
        err = np.abs(a - b).max() / np.abs(b).max()
        assert err <= tol, f"{name}: {err:.2e} > {tol}"


# ------------------------------------------------------------------ K8


def _codes(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


@pytest.mark.parametrize("wd", [0.0, 0.01])
@pytest.mark.parametrize("master", [False, True])
def test_adamw8bit_plain_matches_reference_and_pallas(monkeypatch, wd,
                                                      master):
    monkeypatch.setattr(fou, "_INTERPRET", True)
    rng = np.random.default_rng(4)
    shape = (129, 65)                      # odd size: a padded last block
    p32 = rng.normal(size=shape).astype(np.float32)
    n, padded, nb = fou._q8_meta(jnp.asarray(p32))
    st_j = {"m_q": jnp.zeros((padded,), jnp.float8_e4m3fn),
            "m_s": jnp.zeros((nb,), jnp.float32),
            "v_q": jnp.zeros((padded,), jnp.float8_e4m3fn),
            "v_s": jnp.zeros((nb,), jnp.float32)}
    if master:
        st_j["master"] = jnp.asarray(p32)
        p_j = jnp.asarray(p32, jnp.bfloat16)
    else:
        p_j = jnp.asarray(p32)
    st_k = dict(st_j)                      # the interpret-mode kernel's run
    p_k = p_j
    p_t = torch.tensor(np.asarray(p_j.astype(jnp.float32))).to(
        torch.bfloat16 if master else torch.float32)
    st_t = k8.init_state(p_t, master)
    if master:
        st_t["master"].copy_(torch.tensor(p32))
    kw = dict(weight_decay=wd, lr_scale=1.0, beta1=0.9, beta2=0.999,
              eps=1e-8)
    for step in range(1, 4):
        g = rng.normal(size=shape).astype(np.float32)
        gj = jnp.asarray(g, p_j.dtype)
        p_j, st_j = fou.adamw8bit_reference(p_j, gj, st_j, 1e-2, step, **kw)
        p32k = st_k.get("master", p_k.astype(jnp.float32))
        new, mq, ms, vq, vs = fou._pallas_adamw8bit(
            p32k, gj, st_k, 1e-2, step, wd, 1.0, 0.9, 0.999, 1e-8, shape, n)
        st_k = {"m_q": mq, "m_s": ms, "v_q": vq, "v_s": vs}
        if master:
            st_k["master"] = new
        p_k = new.astype(p_j.dtype)
        k8.adamw8bit_update(p_t, torch.tensor(np.asarray(
            gj.astype(jnp.float32))).to(p_t.dtype), st_t, 1e-2, step, **kw)
        for st in (st_j, st_k):
            for key in ("m_q", "v_q"):
                assert np.array_equal(_codes(st_t[key]), _codes(st[key])), (
                    key, step)
            for key in ("m_s", "v_s"):
                np.testing.assert_allclose(_np(st_t[key]), _np(st[key]),
                                           rtol=3e-7, atol=0)
            if master:
                np.testing.assert_allclose(_np(st_t["master"]),
                                           _np(st["master"]), rtol=0,
                                           atol=step * 3e-7)
        for p in (p_j, p_k):
            np.testing.assert_allclose(
                _np(p_t), _np(p), rtol=0,
                atol=step * 3e-7 if not master else 2.0 ** -8)


def test_adamw8bit_weight_only_rule():
    p = torch.zeros(16, dtype=torch.int8)
    st = k8.init_state(torch.zeros(16), False)
    with pytest.raises(ValueError, match="weight-only"):
        k8.adamw8bit_update(p, torch.zeros(16), st, 1e-3, 1, 0.0, 1.0, 0.9,
                            0.999, 1e-8)


# ------------------------------------------------------- chunked loss


@pytest.mark.parametrize("tied", [False, True])
def test_linear_cross_entropy_matches_jax(tied):
    rng = np.random.default_rng(5)
    n, hdim, vocab, chunk = 23, 16, 40, 7          # 7 does not divide 23
    h = rng.normal(size=(n, hdim)).astype(np.float32)
    w = rng.normal(size=(vocab, hdim) if tied else (hdim, vocab)).astype(
        np.float32) * 0.3
    lbl = rng.integers(0, vocab, size=(n,))
    lbl[[3, 11]] = -100                             # ignored tokens
    lce = jloss.linear_cross_entropy.__wrapped__
    loss_j, (dh_j, dw_j) = jax.value_and_grad(
        lambda a, b: lce(a, b, jnp.asarray(lbl), transpose_weight=tied,
                         chunk_size=chunk), argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(w))
    ht = torch.tensor(h, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    loss_t = loss_ops.linear_cross_entropy(ht, wt, torch.tensor(lbl),
                                           transpose_weight=tied,
                                           chunk_size=chunk)
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(_np(ht.grad), _np(dh_j), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(_np(wt.grad), _np(dw_j), rtol=1e-5,
                               atol=1e-6)
    # the unchunked cross_entropy over the full logits agrees too
    logits = torch.tensor(h) @ (torch.tensor(w).T if tied
                                else torch.tensor(w))
    ce = loss_ops.cross_entropy(logits, torch.tensor(lbl))
    np.testing.assert_allclose(ce.item(), float(loss_j), rtol=1e-5)
