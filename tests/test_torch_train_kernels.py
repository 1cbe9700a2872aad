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
    JAX package's, f32, 1e-5 relative;
  * the key-bias forms of K1 and K5, and K9 (the one-pass backward): the
    port's plain versions vs ``_flash_core`` with a left-padded key bias
    (``_pallas_fwd``, ``_pallas_bwd``) and under ``flash_bwd_impl="fused"``
    (``_pallas_bwd_fused``, spied), causal and not, GQA groups 1 and 4, S
    not a multiple of the 128-row blocks; the bars as for K5, over the
    real query rows (a fully masked row's output depends on each side's
    tiles; it is finite, and its dO is 0 as a loss leaves it);
  * K12 (rope): the plain forward and its VJP vs ``_rope_core`` in
    interpret mode (``_pallas_rope`` both ways), random tables, f32 within
    1e-6 (XLA may fuse a multiply-add), bf16 within one bf16 ulp;
  * ``_key_bias_from_mask`` on every mask form, against the JAX package's;
  * the backward dispatch (``bwd_uses_fused``) against the JAX package's
    ``_bwd_prologue`` choice on shapes on both sides of its 512 MiB cap;
  * the host-side rules K5 and K9 rely on, each against brute force over
    positions: the block orders (``_dkv_walks``, ``_dq_walks``, and K1's
    ``_fwd_walks`` over its 128-row query tiles) cover every live (batch,
    key tile, head, query tile) exactly once, longest walks first, leaving
    out the key tiles a bias masks whole; the key-tile liveness under a
    bias (``_key_tile_live``)
    is "every key <= -1e30"; K9's dS slots (``_pair_slot``) number the
    live pairs 0 .. ``fused_partial_pairs`` - 1.
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


#: (N, H) of K7's split: one row, fewer rows than SMs, rows off every
#: grid's even split, H from one vector to the kernel's limit, the train
#: step's final norm (8192 x 4096)
_RMS_BWD_PLANS = [(1, 8), (1, 256), (37, 4096), (131, 1000), (133, 8192),
                  (1000, 4096), (8192, 4096), (8193, 64)]


@pytest.mark.parametrize("sms", [132, 7])
@pytest.mark.parametrize("n,h", _RMS_BWD_PLANS)
def test_rms_bwd_plan_splits_rows_once(n, h, sms):
    """K7's split (``bwd_plan``, the kernel's own arithmetic): min(N, SMs)
    CTAs, each a non-empty run of consecutive rows, the runs in CTA order
    covering every row once and differing by at most one row; its ring of
    row slots (x and g, 4H bytes each) and w fit the shared memory."""
    grid, slots, runs = k67.bwd_plan(n, h, sms)
    assert grid == min(n, sms) == len(runs)
    at = 0
    for first, rows in runs:
        assert first == at and rows >= 1
        at += rows
    assert at == n
    assert max(r for _, r in runs) - min(r for _, r in runs) <= 1
    assert 2 <= slots <= 16
    assert 2 * h + slots * 4 * h <= 227 * 1024


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


# ------------------------------------------------------------ K1/K5 bias, K9


def _left_pad(b, sk, pads):
    keep = np.arange(sk)[None, :] >= np.asarray(pads)[:, None]
    return np.where(keep, 0.0, -1e30).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["split", "fused"])
@pytest.mark.parametrize("s,h,hk,causal,pads", [
    (192, 4, 1, True, (0, 70)), (128, 4, 4, True, (100, 5)),
    (192, 4, 4, False, (20, 0)), (128, 8, 2, True, None)])
def test_flash_bias_and_fused_plain_match_pallas(monkeypatch, dtype, impl, s,
                                                h, hk, causal, pads):
    from paddle_tpu.framework import flags as jflags

    monkeypatch.setattr(fa, "_INTERPRET", True)
    seen = []
    for name in ("_pallas_bwd", "_pallas_bwd_fused"):
        orig = getattr(fa, name)
        monkeypatch.setattr(fa, name, lambda *a, _o=orig, _n=name, **kw: (
            seen.append(_n), _o(*a, **kw))[1])
    rng = np.random.default_rng(s + h + hk)
    b, d = 2, 128
    (qj, qt), (kj, kt), (vj, vt), (gj, gt) = (
        _pair(rng.normal(size=shape) * 0.3, dtype)
        for shape in ((b, s, h, d), (b, s, hk, d), (b, s, hk, d),
                      (b, s, h, d)))
    scale = 1.0 / np.sqrt(d)
    bias = None if pads is None else _left_pad(b, s, pads)
    live = np.ones((b, s), bool)
    if pads is not None:           # rows that see no unmasked key
        pos = np.arange(s)[None, :] + (0 if causal else s - 1)
        live = pos >= np.asarray(pads)[:, None]
        gj = jnp.where(jnp.asarray(live)[:, :, None, None], gj, 0)
        gt = gt * torch.tensor(live)[:, :, None, None]
    jb = None if bias is None else jnp.asarray(bias)
    old = jflags.get_flag("flash_bwd_impl")
    jflags.set_flags({"flash_bwd_impl": impl})
    try:
        out_j, vjp = jax.vjp(
            lambda q, k, v: fa._flash_core(q, k, v, jb, causal, scale),
            qj, kj, vj)
        grads_j = vjp(gj)[:3]
    finally:
        jflags.set_flags({"flash_bwd_impl": old})
    assert seen == ["_pallas_bwd" if impl == "split" else
                    "_pallas_bwd_fused"]
    tb = None if bias is None else torch.tensor(bias)
    out_t, lse_t = k1.flash_attention_fwd(qt, kt, vt, causal, None, tb)
    bwd = (k1.flash_attention_bwd_fused if impl == "fused"
           else k1.flash_attention_bwd)
    grads_t = bwd(qt, kt, vt, out_t, lse_t, gt, causal, None, tb)
    assert np.isfinite(_np(out_t)).all()
    rel = 2e-5 if dtype == "float32" else 3e-2
    for name, a, r in zip(("out", "dq", "dk", "dv"),
                          (out_t,) + tuple(grads_t),
                          (out_j,) + tuple(grads_j)):
        a, r = _np(a), _np(r)
        assert np.isfinite(a).all(), name
        if name in ("out", "dq"):        # per query row: the real ones
            a, r = a[live], r[live]
        err = np.abs(a - r).max() / np.abs(r).max()
        assert err <= rel, f"{name}: {err:.2e} > {rel}"


@pytest.mark.parametrize("causal,sq,sk,pads", [
    (True, 130, 130, (0, 70)), (True, 200, 64, (0, 0)),
    (False, 77, 77, (77, 3))])
def test_dead_row_completion_equals_the_plain_version(causal, sq, sk, pads):
    """K1 writes zeros for a query that sees no key and K5/K9 give it no
    term; the wrappers' completion (``_fill_dead_rows``,
    ``_add_dead_rows_dv``) turns that into the plain version's answer,
    contiguous, as the kernels' next launch needs. Emulated on CPU: the
    plain version with such rows zeroed (forward) or with their dO zeroed
    (backward) stands in for the kernel."""
    rng = np.random.default_rng(sq + sk)
    b, h, hk, d = 2, 4, 2, 128
    q, do = (torch.tensor(rng.normal(size=(b, sq, h, d)), dtype=torch.float32)
             for _ in range(2))
    k, v = (torch.tensor(rng.normal(size=(b, sk, hk, d)),
                         dtype=torch.float32) for _ in range(2))
    bias = torch.tensor(_left_pad(b, sk, pads))
    out, lse = k1.flash_attention_fwd_reference(q, k, v, causal, None, bias)
    dead = k1._dead_rows(lse).transpose(1, 2)[..., None]
    assert bool(dead.any())
    filled = k1._fill_dead_rows(out.masked_fill(dead, 0.0), v, lse)
    assert filled.is_contiguous()
    torch.testing.assert_close(filled, out, rtol=1e-5, atol=1e-6)
    ref = k1.flash_attention_bwd_reference(q, k, v, out, lse, do, causal,
                                           None, bias)
    part = k1.flash_attention_bwd_reference(q, k, v, out, lse,
                                            do.masked_fill(dead, 0.0),
                                            causal, None, bias)
    dv = k1._add_dead_rows_dv(part[2], do, lse)
    assert dv.is_contiguous()
    torch.testing.assert_close(dv, ref[2], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(part[0], ref[0])        # no dQ, dK terms
    torch.testing.assert_close(part[1], ref[1])


def test_key_bias_from_mask_matches_jax():
    rng = np.random.default_rng(9)
    b, sk = 3, 10
    keep = rng.random((b, sk)) > 0.3
    add = rng.normal(size=(b, sk)).astype(np.float32)
    cases = [keep, keep[:1], keep[0], keep[:, None, None, :],
             keep[:1, None, None, :], add, add[:1], add[0],
             add[:, None, None, :], None,
             keep[:, None, :, None].repeat(sk, 2),     # general: (B,1,S,S)
             np.ones((b, 1, 4, sk), bool), keep[:2]]   # general shapes
    for m in cases:
        jb, jok = fa._key_bias_from_mask(None if m is None else jnp.asarray(m),
                                         b, sk)
        tb, tok = k1._key_bias_from_mask(None if m is None else
                                         torch.tensor(m), b, sk)
        assert tok == jok
        if jb is None:
            assert tb is None
            continue
        assert tb.dtype == torch.float32 and tb.shape == (b, sk)
        assert tb.is_contiguous()
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


@pytest.mark.parametrize("shape", [
    (1, 8192, 16, 128), (1, 8192, 17, 128), (4, 2048, 32, 128),
    (2, 192, 4, 128), (1, 130, 4, 64), (64, 2048, 32, 128)])
@pytest.mark.parametrize("impl", ["split", "fused"])
def test_bwd_dispatch_matches_jax_prologue(shape, impl):
    """``bwd_uses_fused`` against the kernel ``_bwd_prologue`` picks,
    traced abstractly (no arrays are made): (1, 8192, 16, 128) sits at
    the 512 MiB cap exactly (fused), 17 heads just past it (split)."""
    from paddle_tpu.framework import flags as jflags
    from paddle_tpu_torch.framework import flags as tflags

    b, s, h, d = shape
    picked = []

    def prologue(q, k, v, out, do):
        r = fa._bwd_prologue(q, k, v, None, out, do, True)
        picked.append(r[-1])
        return r[0]

    old = jflags.get_flag("flash_bwd_impl"), tflags.get_flag("flash_bwd_impl")
    jflags.set_flags({"flash_bwd_impl": impl})
    tflags.set_flags({"flash_bwd_impl": impl})
    try:
        sds = [jax.ShapeDtypeStruct(x, jnp.bfloat16) for x in
               ((b, s, h, d), (b, s, 1, d), (b, s, 1, d), (b, s, h, d),
                (b, s, h, d))]
        jax.eval_shape(prologue, *sds)
        fused = k1.bwd_uses_fused(b, s, s, h, d)
    finally:
        jflags.set_flags({"flash_bwd_impl": old[0]})
        tflags.set_flags({"flash_bwd_impl": old[1]})
    assert fused == (picked[0] is fa._pallas_bwd_fused)
    if impl == "fused" and shape[:3] in ((1, 8192, 16), (4, 2048, 32)):
        assert fused
    if shape[:3] in ((1, 8192, 17), (64, 2048, 32)) or impl == "split":
        assert not fused


# (Sq, Sk): ragged tiles, Sk > Sq and Sq > Sk, and offsets Sk - Sq of 1
# and 65, where a key tile's first query sits on a tile's last row
_WALK_SHAPES = ((130, 130), (64, 200), (77, 300), (200, 64), (1, 1),
                (129, 130), (100, 165), (2048, 2048))


def _brute_live_pairs(sq, sk, causal):
    """(query tile, key tile) pairs where some query of the tile sees some
    key of the other, by brute force over the positions."""
    if not causal:
        return {(i, j) for i in range(-(-sq // 64))
                for j in range(-(-sk // 64))}
    return {(i // 64, j // 64) for i in range(sq) for j in range(sk)
            if j <= i + sk - sq}


def test_fused_partial_pairs_count_the_live_tiles():
    """K9's dS partial buffer holds the causally live (query tile, key
    tile) pairs: 528 of 32 x 32 at S = 2048; all of them without the
    causal mask; none for queries before the first key. Each pair has its
    own slot (``_pair_slot``, the kernel's ``pair_base(qt) + kt``): the
    slots are 0 .. n_pairs - 1, each once. A slot is a 64 x 64 bf16 dS
    tile: 0.52 GiB at B=4, H=32, S=2048 causal, a quarter of the f32 dQ
    partials (64 x 128) it replaced."""
    assert k1.fused_partial_pairs(2048, 2048, True) == 32 * 33 // 2
    assert k1.fused_partial_pairs(2048, 2048, False) == 32 * 32
    assert k1.fused_partial_pairs(100, 100, True) == 3
    assert k1.fused_partial_pairs(200, 64, True) == 2
    assert 4 * 32 * 528 * 64 * 64 * 2 / 2**30 == pytest.approx(0.515625)
    for sq, sk in _WALK_SHAPES:
        for causal in (True, False):
            live = _brute_live_pairs(sq, sk, causal)
            n = k1.fused_partial_pairs(sq, sk, causal)
            assert n == len(live)
            slots = sorted(k1._pair_slot(qt, kt, sq, sk, causal)
                           for qt, kt in live)
            assert slots == list(range(n))


def _brute_tile_live(bias, sk):
    """Per (row, 64-key tile): not every key's bias is <= -1e30."""
    out = []
    for row in bias.tolist():
        out.append([int(any(not (row[j] <= -1e30)
                            for j in range(t, min(t + 64, sk))))
                    for t in range(0, sk, 64)])
    return out


@pytest.mark.parametrize("sk", [1, 64, 130, 300])
def test_key_tile_liveness_is_all_keys_masked(sk):
    """``_key_tile_live``: a 64-key tile is dead for row b iff every key of
    it has bias <= -1e30 (a left pad, a mask of -inf, or a masked gap);
    any other bias (0, -1e4, NaN) keeps it live. No bias: None (every tile
    live)."""
    rng = np.random.default_rng(sk)
    rows = [np.zeros(sk), np.full(sk, -1e30)]
    for pad in (0, 63, 64, 65, 129, sk - 1, sk):
        r = np.zeros(sk)
        r[:min(pad, sk)] = -1e30
        rows.append(r)
    gap = np.zeros(sk)
    gap[64:200] = -np.inf
    rows.append(gap)
    mixed = np.where(rng.random(sk) < 0.9, -1e30, -1e4)
    rows.append(mixed)
    nan = np.full(sk, -1e30)
    nan[sk // 2] = np.nan
    rows.append(nan)
    bias = torch.tensor(np.stack(rows), dtype=torch.float32)
    live = k1._key_tile_live(bias, sk)
    assert live.dtype == torch.int32 and live.shape == (len(rows),
                                                        -(-sk // 64))
    assert live.tolist() == _brute_tile_live(bias, sk)
    keep = torch.arange(sk)[None, :] >= torch.tensor([0, sk // 2])[:, None]
    mask_bias = k1._key_bias_from_mask(keep, 2, sk)[0]
    assert k1._key_tile_live(mask_bias, sk).tolist() == \
        _brute_tile_live(mask_bias, sk)
    assert k1._key_tile_live(None, sk) is None


@pytest.mark.parametrize("sq,sk", _WALK_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hk,g", [(2, 1), (1, 4), (1, 8)])
def test_bwd_walks_cover_each_live_pair_once(sq, sk, causal, hk, g):
    """The block orders K5 and K9 launch (``_dkv_walks``: a block per
    (b, kv head, key tile), key tiles ascending; ``_dq_walks``: a block per
    (b, head, query tile), query tiles descending) cover every live
    (b, key tile, head, query tile) exactly once, with and without key
    tiles a bias masks whole; without a bias each grid runs its longest
    walks first (the work never grows along the launch order)."""
    b, h = 2, hk * g
    pairs = _brute_live_pairs(sq, sk, causal)
    nk = -(-sk // 64)
    dead = [[False] * nk, [kt % 3 == 0 for kt in range(nk)]]
    for tile_live in (None, [[int(not d) for d in row] for row in dead]):
        want = sorted((bi, kt, hi, qt) for bi in range(b) for hi in range(h)
                      for qt, kt in pairs
                      if tile_live is None or tile_live[bi][kt])
        dkv = k1._dkv_walks(b, sq, sk, h, hk, causal, tile_live)
        assert len(dkv) == b * hk * nk
        got = sorted((bi, kt, hi, qt) for bi, j, kt, walk in dkv
                     for hi, qt in walk)
        assert got == want
        assert all(hi // g == j for _, j, _, walk in dkv for hi, _ in walk)
        dq = k1._dq_walks(b, sq, sk, h, causal, tile_live)
        assert len(dq) == b * h * -(-sq // 64)
        got = sorted((bi, kt, hi, qt) for bi, hi, qt, kts in dq
                     for kt in kts)
        assert got == want
        assert all(kts == sorted(kts) for *_, kts in dq)
        if tile_live is None:
            for walks in ([len(w) for *_, w in dkv],
                          [len(kts) for *_, kts in dq]):
                assert walks == sorted(walks, reverse=True)


def _brute_fwd_pairs(b, sq, sk, causal, tile_live):
    """Per batch row: the (128-row query tile, 64-key tile) pairs where
    some query of the first sees some key of the second and the bias
    leaves the key tile live, by brute force over the positions."""
    out = []
    for bi in range(b):
        pairs = {(i // 128, j // 64) for i in range(sq) for j in range(sk)
                 if not causal or j <= i + sk - sq}
        out.append({(qt, kt) for qt, kt in pairs
                    if tile_live is None or tile_live[bi][kt]})
    return out


@pytest.mark.parametrize("sq,sk", _WALK_SHAPES + ((300, 700), (700, 300)))
@pytest.mark.parametrize("causal", [True, False])
def test_fwd_walks_cover_each_live_pair_once(sq, sk, causal):
    """K1's block order (``_fwd_walks``: a block per (b, head, 128-row
    query tile), query tiles descending) walks every live (query tile, key
    tile) pair of every head exactly once, key tiles ascending; a key tile
    the bias masks whole (``_key_tile_live`` 0) is left out; without a bias
    the longest walks come first. Sq != Sk both ways, causal and not."""
    b, h = 2, 3
    nk = -(-sk // 64)
    dead = [[False] * nk, [kt % 3 == 1 or kt < 2 for kt in range(nk)]]
    for tile_live in (None, [[int(not d) for d in row] for row in dead]):
        want = _brute_fwd_pairs(b, sq, sk, causal, tile_live)
        blocks = k1._fwd_walks(b, sq, sk, h, causal, tile_live)
        assert len(blocks) == b * h * -(-sq // 128)
        for bi in range(b):
            for hi in range(h):
                got = [(qt, kt) for bb, hh, qt, kts in blocks
                       if (bb, hh) == (bi, hi) for kt in kts]
                assert len(got) == len(set(got))
                assert set(got) == want[bi]
        assert all(kts == sorted(kts) for *_, kts in blocks)
        assert [qt for *_, qt, _ in blocks] == sorted(
            (qt for *_, qt, _ in blocks), reverse=True)
        if tile_live is None:
            walks = [len(kts) for *_, kts in blocks]
            assert walks == sorted(walks, reverse=True)
        else:  # the dead tiles are left out, the causal range kept
            for bb, _, qt, kts in blocks:
                n = k1._fwd_key_tiles(qt, sq, sk, causal)
                assert kts == [kt for kt in range(n) if tile_live[bb][kt]]


# ------------------------------------------------------------------ K12


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 6, 4, 128), (1, 5, 3, 256)])
def test_rope_plain_matches_pallas(monkeypatch, dtype, shape):
    monkeypatch.setattr(fnr, "_INTERPRET", True)
    calls = []
    orig = fnr._pallas_rope
    monkeypatch.setattr(fnr, "_pallas_rope", lambda *a: (
        calls.append(1), orig(*a))[1])
    rng = np.random.default_rng(sum(shape))
    b, s, h, d = shape
    xj, xt = _pair(rng.normal(size=shape), dtype)
    gj, gt = _pair(rng.normal(size=shape), dtype)
    emb = rng.normal(size=(s, d)).astype(np.float32)    # random tables
    cos, sin = np.cos(emb), np.sin(emb)
    out_j, vjp = jax.vjp(lambda x: fnr._rope_core(x, jnp.asarray(cos),
                                                   jnp.asarray(sin)), xj)
    dx_j, = vjp(gj)
    assert len(calls) == 2                          # forward and its VJP
    xt.requires_grad_(True)
    out_t = k67.fused_rope(xt, torch.tensor(cos), torch.tensor(sin))
    out_t.backward(gt)
    assert out_t.dtype == xt.dtype and k67.rope_launches == 0
    tol = 1e-6 if dtype == "float32" else 2.0 ** -7
    for name, a, r in (("out", out_t, out_j), ("dx", xt.grad, dx_j)):
        a, r = _np(a), _np(r)
        err = np.abs(a - r).max() / np.abs(r).max()
        assert err <= tol, f"{name}: {err:.2e} > {tol}"
