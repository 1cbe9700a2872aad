"""Ragged and masked attention: the PyTorch port vs the JAX package, on CPU.

The port's modules that hold K10 (paged_attention.py), K11
(ragged_paged_attention.py) and the ragged and masked forms of K3
(fused_rope_attend.py) run their plain versions on CPU tensors; here they
get the same numpy-made inputs as the JAX functions, whose Pallas kernels
run in interpret mode (the modules' ``_INTERPRET`` toggles, as
tests/test_ragged_attention.py and tests/test_fused_decode.py do; a spy
asserts the Pallas body really ran). Cases follow
tests/test_ragged_attention.py: a mixed wave (a decode row, a slot with
no rows, a chunked-prefill segment, padding rows), int8 pools, a permuted
block table, a poisoned row that must not leak across slots, and the
ragged cache write (placement, dropped rows, int8 quantize-on-write).

Tolerances (f32): 2e-5 where the sides sum in a different order (online
vs two-pass softmax, XLA vs torch einsum); 3e-6 for freshly rotated pool
cells (XLA may fuse a*cos + b*sin into an FMA, the port rounds each op);
exact where the arithmetic is the same op sequence.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.models import kv_cache as jkv
from paddle_tpu.ops.pallas import fused_rope_attend as jfra
from paddle_tpu.ops.pallas import paged_attention as jpa
from paddle_tpu.ops.pallas import ragged_paged_attention as jrpa

from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.models import kv_cache as tkv
from paddle_tpu_torch.ops.kernels import fused_rope_attend as tfra
from paddle_tpu_torch.ops.kernels import fusion as tfusion
from paddle_tpu_torch.ops.kernels import paged_attention as tpa
from paddle_tpu_torch.ops.kernels import ragged_paged_attention as trpa

TOL = dict(rtol=2e-5, atol=2e-5)


def _t(a):
    return torch.tensor(np.asarray(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _spy(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def wrapped(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(module, name, wrapped)
    return calls


def _caches(seed=0, int8=False, b=3, hk=2, d=128, page=8, cap=32,
            lens=(17, 25, 9), layers=1):
    """The same prefilled cache on both sides (tests/test_ragged_attention
    .py's _cache_case), plus the rng for the wave."""
    rng = np.random.default_rng(seed)
    s = max(lens)
    jc = jkv.create_paged_cache(layers, b, cap, hk, d, page_size=page,
                                dtype="int8" if int8 else jnp.float32)
    tc = tkv.create_paged_cache(layers, b, cap, hk, d, page_size=page,
                                dtype=torch.int8 if int8 else torch.float32)
    for layer in range(layers):
        k = rng.normal(size=(b, s, hk, d)).astype(np.float32)
        v = rng.normal(size=(b, s, hk, d)).astype(np.float32)
        jc = jkv.prefill_paged_cache(jc, layer, jnp.asarray(k),
                                     jnp.asarray(v),
                                     jnp.asarray(lens, jnp.int32))
        tc = tkv.prefill_paged_cache(tc, layer, _t(k), _t(v),
                                     torch.tensor(lens, dtype=torch.int32))
    return jc, tc, rng


def _wave(rng, t=16, h=4, hk=2, d=128):
    return tuple(rng.normal(size=shape).astype(np.float32)
                 for shape in ((t, h, d), (t, hk, d), (t, hk, d)))


def _assert_same_cache(tc, jc, atol=0.0):
    names = ["k_pages", "v_pages", "block_tables", "seq_lens"]
    if tc.quantized:
        names += ["k_scales", "v_scales"]
    for name in names:
        np.testing.assert_allclose(_np(getattr(tc, name)),
                                   np.asarray(getattr(jc, name)),
                                   rtol=atol, atol=atol, err_msg=name)


def _layer(cache):
    ks, vs = tkv.layer_scales(cache, 0)
    return cache.k_pages[0], cache.v_pages[0], ks, vs


# name -> (q_start, q_lens, fresh_lens, page_lens) of a 3-slot wave
WAVES = {
    # slot 0 decodes (ctx 17 incl. self), slot 1 has no rows, slot 2
    # prefills 7 rows on 9 tokens of context; rows 10.. are padding
    "mixed": ((0, 0, 3), (1, 0, 7), (0, 0, 7), (17, 0, 9)),
    # two decode rows and a 5-row chunk (rows 1 and 2 swap slot order)
    "decode_and_chunk": ((0, 3, 1), (1, 5, 1), (0, 5, 0), (18, 25, 10)),
    # a chunk that starts a slot (no page context) and one that continues
    "fresh_only": ((0, 0, 6), (6, 0, 4), (6, 0, 4), (0, 0, 9)),
}


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("wave", sorted(WAVES))
def test_ragged_attention_matches_jax_kernel(monkeypatch, wave, int8):
    """K11's plain version vs the JAX package's dispatch, which runs the
    Pallas kernel in interpret mode; padding rows are exact zeros."""
    monkeypatch.setattr(jrpa, "_INTERPRET", True)
    calls = _spy(monkeypatch, jrpa, "_pallas_ragged")
    jc, tc, rng = _caches(seed=1, int8=int8)
    q, kf, vf = _wave(rng)
    lens = [np.asarray(x, np.int32) for x in WAVES[wave]]
    ks, vs = jkv.layer_scales(jc, 0)
    j = jrpa.ragged_paged_attention_pure(
        jnp.asarray(q), jc.k_pages[0], jc.v_pages[0], jc.block_tables,
        *(jnp.asarray(x) for x in (lens[3], lens[0], lens[1], lens[2])),
        jnp.asarray(kf), jnp.asarray(vf), k_scales=ks, v_scales=vs)
    assert calls, "the Pallas ragged kernel did not run"
    kp, vp, tks, tvs = _layer(tc)
    t = trpa.ragged_paged_attention_pure(
        _t(q), kp, vp, tc.block_tables,
        *(_t(x) for x in (lens[3], lens[0], lens[1], lens[2])), _t(kf),
        _t(vf), k_scales=tks, v_scales=tvs)
    np.testing.assert_allclose(_np(t), np.asarray(j), **TOL)
    used = np.zeros(16, bool)
    for s, n in zip(lens[0], lens[1]):
        used[s:s + n] = True
    assert not _np(t)[~used].any()
    assert trpa.launches == 0  # CPU tensors never launch


def test_permuted_block_table_matches_jax():
    rng = np.random.default_rng(4)
    b, hk, d, page, n_pages = 2, 2, 128, 8, 4
    kp = rng.normal(size=(hk, b * n_pages, page, d)).astype(np.float32)
    vp = rng.normal(size=(hk, b * n_pages, page, d)).astype(np.float32)
    bt = np.asarray([[5, 2, 7, 0], [1, 6, 3, 4]], np.int32)
    q, kf, vf = _wave(rng, t=8)
    lens = [np.asarray(x, np.int32) for x in ((27, 13), (0, 2), (1, 3),
                                              (0, 3))]
    args = (q, kp, vp, bt, *lens, kf, vf)
    j = jrpa.ragged_paged_attention_reference(*(jnp.asarray(a) for a in args))
    t = trpa.ragged_paged_attention_reference(*(_t(a) for a in args))
    np.testing.assert_allclose(_np(t), np.asarray(j), **TOL)


def test_poison_row_does_not_leak_across_slots():
    """One slot's non-finite chunk rows leave its neighbours' outputs
    finite and equal to the JAX package's, while the poisoned slot's own
    row stays non-finite (tests/test_ragged_attention.py's case)."""
    jc, tc, rng = _caches(seed=5)
    q, kf, vf = _wave(rng)
    for x in (q, kf, vf):
        x[4] = np.nan
    lens = [np.asarray(x, np.int32) for x in ((18, 9, 10), (0, 3, 8),
                                              (1, 4, 2), (0, 4, 2))]
    j = jrpa.ragged_paged_attention_pure(
        jnp.asarray(q), jc.k_pages[0], jc.v_pages[0], jc.block_tables,
        *(jnp.asarray(x) for x in lens), jnp.asarray(kf), jnp.asarray(vf))
    kp, vp, _, _ = _layer(tc)
    t = _np(trpa.ragged_paged_attention_pure(
        _t(q), kp, vp, tc.block_tables, *(_t(x) for x in lens), _t(kf),
        _t(vf)))
    assert np.isfinite(t[0]).all() and np.isfinite(t[8:10]).all()
    assert not np.isfinite(t[4]).all()
    for rows in (slice(0, 1), slice(8, 10), slice(3, 4)):
        np.testing.assert_allclose(t[rows], np.asarray(j)[rows], **TOL)


def test_decode_rows_match_paged_attention():
    """A decode-only wave through the ragged plain version equals paged
    attention on the same queries (the greedy-parity contract between the
    batcher's waves and its segment steps)."""
    _, tc, rng = _caches(seed=2)
    q, kf, vf = _wave(rng, t=8)
    kp, vp, _, _ = _layer(tc)
    lens = tc.seq_lens
    r = trpa.ragged_paged_attention_reference(
        _t(q), kp, vp, tc.block_tables, lens, torch.arange(3, dtype=torch.int32),
        torch.ones(3, dtype=torch.int32), torch.zeros(3, dtype=torch.int32),
        _t(kf), _t(vf))
    p = tpa.paged_attention_reference(_t(q)[:3], kp, vp, tc.block_tables,
                                      lens)
    np.testing.assert_allclose(_np(r)[:3], _np(p), rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_paged_attention_pure_matches_jax_kernel(monkeypatch, int8):
    """K10's plain version vs the JAX dispatch (Pallas in interpret mode),
    lengths 0 and across page boundaries."""
    monkeypatch.setattr(jpa, "_INTERPRET", True)
    calls = _spy(monkeypatch, jpa, "_pallas_paged")
    jc, tc, rng = _caches(seed=3, int8=int8, page=32 if int8 else 8,
                          cap=64)
    q = rng.normal(size=(3, 4, 128)).astype(np.float32)
    lens = np.asarray([0, 25, 33], np.int32)
    ks, vs = jkv.layer_scales(jc, 0)
    j = jpa.paged_attention_pure(jnp.asarray(q), jc.k_pages[0],
                                 jc.v_pages[0], jc.block_tables,
                                 jnp.asarray(lens), k_scales=ks, v_scales=vs)
    assert calls, "the Pallas paged kernel did not run"
    kp, vp, tks, tvs = _layer(tc)
    t = tpa.paged_attention_pure(_t(q), kp, vp, tc.block_tables, _t(lens),
                                 k_scales=tks, v_scales=tvs)
    np.testing.assert_allclose(_np(t), np.asarray(j), **TOL)
    assert not _np(t)[0].any() and tpa.launches == 0


# ------------------------------------------------------- the cache writes


def test_append_tokens_ragged_places_and_drops():
    """Decode rows and chunk rows land at their (slot, position) cells;
    invalid rows, even ones aimed at a live row's cell, write nothing."""
    b, hk, d, page = 2, 2, 16, 8
    jc = jkv.create_paged_cache(1, b, 32, hk, d, page_size=page)
    tc = tkv.create_paged_cache(1, b, 32, hk, d, page_size=page)
    kr = (np.arange(6, dtype=np.float32)[:, None, None]
          * np.ones((6, hk, d), np.float32))
    row_slot = np.asarray([0, 1, 1, 1, 0, -1], np.int32)
    row_pos = np.asarray([7, 0, 1, 2, 7, 0], np.int32)
    valid = np.asarray([1, 1, 1, 1, 0, 0], bool)
    args = (kr + 1, (kr + 1) * 2, row_slot, row_pos, valid)
    jc = jkv.append_tokens_ragged(jc, 0, *(jnp.asarray(a) for a in args))
    tc = tkv.append_tokens_ragged(tc, 0, *(_t(a) for a in args))
    _assert_same_cache(tc, jc)
    np.testing.assert_array_equal(_np(tc.k_pages)[0, :, 0, 7, :], 1.0)
    # a wave of invalid rows alone writes nothing
    before = tc.k_pages.clone()
    tkv.append_tokens_ragged(tc, 0, _t(kr + 9), _t(kr + 9), _t(row_slot),
                             _t(row_pos), torch.zeros(6, dtype=torch.bool))
    assert torch.equal(tc.k_pages, before)


def test_append_tokens_ragged_int8_matches_jax():
    """Quantize-on-write: codes and scales equal the JAX package's, and
    one token per slot equals append_token_masked's write."""
    b, hk, d, page = 3, 2, 16, 8
    rng = np.random.default_rng(8)
    kv = rng.normal(size=(5, hk, d)).astype(np.float32)
    args = (kv, kv * 2, np.asarray([0, 2, 2, 1, -1], np.int32),
            np.asarray([3, 9, 10, 0, 4], np.int32),
            np.asarray([1, 1, 1, 1, 0], bool))
    jc = jkv.create_paged_cache(1, b, 32, hk, d, page_size=page,
                                dtype="int8")
    tc = tkv.create_paged_cache(1, b, 32, hk, d, page_size=page,
                                dtype=torch.int8)
    jc = jkv.append_tokens_ragged(jc, 0, *(jnp.asarray(a) for a in args))
    tc = tkv.append_tokens_ragged(tc, 0, *(_t(a) for a in args))
    _assert_same_cache(tc, jc)
    one = [tkv.create_paged_cache(1, b, 32, hk, d, page_size=page,
                                  dtype=torch.int8) for _ in "rm"]
    rows = _t(kv[:3])
    one[0] = tkv.append_tokens_ragged(
        one[0], 0, rows, rows * 2, torch.tensor([0, 1, 2]),
        torch.tensor([3, 0, 9]), torch.ones(3, dtype=torch.bool))
    one[1] = tkv.append_token_masked(
        one[1]._replace(seq_lens=torch.tensor([3, 0, 9], dtype=torch.int32)),
        0, rows, rows * 2, torch.ones(3, dtype=torch.bool))
    for name in ("k_pages", "v_pages", "k_scales", "v_scales"):
        assert torch.equal(getattr(one[0], name), getattr(one[1], name)), \
            name


def test_advance_masked_matches_jax():
    jc, tc, _ = _caches(seed=9)
    active = np.asarray([True, False, True])
    jc = jkv.advance_masked(jc, jnp.asarray(active))
    tc = tkv.advance_masked(tc, torch.tensor(active))
    _assert_same_cache(tc, jc)


# ---------------------------------------- the unfused chains and fused K3


def _ragged_inputs(rng, jc, t=16, h=4, hk=2, d=128):
    """A mixed wave over _caches' slots (seq_lens 17, 25, 9): slot 0
    decodes, slot 1 sits out, slot 2 prefills 6 rows; rows 7.. are
    padding. Returns the JAX-side arrays."""
    q, k, v = _wave(rng, t, h, hk, d)
    cos = rng.normal(size=(t, d)).astype(np.float32)
    sin = rng.normal(size=(t, d)).astype(np.float32)
    seq = np.asarray(jc.seq_lens)
    row_slot = np.asarray([0, 2, 2, 2, 2, 2, 2] + [-1] * (t - 7), np.int32)
    row_pos = np.asarray([seq[0]] + [seq[2] + i for i in range(6)]
                         + [0] * (t - 7), np.int32)
    valid = row_slot >= 0
    q_start = np.asarray([0, 0, 1], np.int32)
    q_lens = np.asarray([1, 0, 6], np.int32)
    fresh = np.asarray([0, 0, 6], np.int32)
    page_lens = np.asarray([seq[0] + 1, 0, seq[2]], np.int32)
    return (q, k, v, cos, sin), (row_slot, row_pos, valid, page_lens,
                                 q_start, q_lens, fresh)


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_ragged_reference_matches_jax_chain(int8):
    """rope -> ragged append -> ragged attention, both sides' plain chains:
    the output and the pools (written cells within the rope bound)."""
    jc, tc, rng = _caches(seed=10, int8=int8, cap=40)
    rows, wave = _ragged_inputs(rng, jc)
    j_out, j_cache = jfra.ragged_reference(
        *(jnp.asarray(a) for a in rows), jc, 0,
        *(jnp.asarray(a) for a in wave))
    t_out, t_cache = tfra.ragged_reference(*(_t(a) for a in rows), tc, 0,
                                           *(_t(a) for a in wave))
    np.testing.assert_allclose(_np(t_out), np.asarray(j_out), **TOL)
    if int8:
        # a code whose rotated input sits on a rounding boundary may round
        # the other way across the two sides' rope: within 1 code
        for name in ("k_pages", "v_pages"):
            diff = np.abs(_np(getattr(t_cache, name)).astype(int)
                          - np.asarray(getattr(j_cache, name)).astype(int))
            assert diff.max() <= 1, name
    else:
        _assert_same_cache(t_cache, j_cache, atol=3e-6)


def test_fused_ragged_entry_matches_jax_kernel(monkeypatch):
    """The fused ragged entry (the plain chain on CPU tensors) vs the JAX
    package's fused kernel in interpret mode: output and pools."""
    monkeypatch.setattr(jfra, "_INTERPRET", True)
    calls = _spy(monkeypatch, jfra, "_pallas_fused")
    jc, tc, rng = _caches(seed=11, cap=40)
    rows, wave = _ragged_inputs(rng, jc)
    j_out, j_cache = jfra.fused_rope_append_attend(
        *(jnp.asarray(a) for a in rows), jc, 0,
        *(jnp.asarray(a) for a in wave))
    assert calls, "the Pallas fused kernel did not run"
    t_out, t_cache = tfra.fused_rope_append_attend(
        *(_t(a) for a in rows), tc, 0, *(_t(a) for a in wave))
    np.testing.assert_allclose(_np(t_out), np.asarray(j_out), **TOL)
    _assert_same_cache(t_cache, j_cache, atol=3e-6)
    assert tfra.ragged_launches == 0
    # the fresh_pool_read form (speculative verify) against the kernel's
    # spec variant, on an f32 and on an int8 cache
    fpr = np.asarray([True, False, True])
    for int8 in (False, True):
        jc, tc, rng = _caches(seed=12, int8=int8, cap=40)
        rows, wave = _ragged_inputs(rng, jc)
        n_calls = len(calls)
        j_out, j_cache = jfra.fused_rope_append_attend(
            *(jnp.asarray(a) for a in rows), jc, 0,
            *(jnp.asarray(a) for a in wave),
            fresh_pool_read=jnp.asarray(fpr))
        assert len(calls) > n_calls, "the Pallas fused kernel did not run"
        t_out, t_cache = tfra.fused_rope_append_attend(
            *(_t(a) for a in rows), tc, 0, *(_t(a) for a in wave),
            fresh_pool_read=torch.tensor(fpr))
        np.testing.assert_allclose(_np(t_out), np.asarray(j_out), **TOL)
        if not int8:
            _assert_same_cache(t_cache, j_cache, atol=3e-6)


@pytest.mark.parametrize("fused", [True, False], ids=["kernel", "chain"])
def test_masked_decode_matches_jax(monkeypatch, fused):
    """The decode form with an ``active`` mask: inactive slots write
    nothing and return zeros. ``fused`` holds the port's entry against the
    JAX fused kernel (interpret mode), else the two plain chains."""
    monkeypatch.setattr(jfra, "_INTERPRET", True)
    jc, tc, rng = _caches(seed=12, cap=40)
    q = rng.normal(size=(3, 4, 128)).astype(np.float32)
    k, v = (rng.normal(size=(3, 2, 128)).astype(np.float32) for _ in "kv")
    cos, sin = (rng.normal(size=(3, 128)).astype(np.float32) for _ in "cs")
    active = np.asarray([True, False, True])
    rows = (q, k, v, cos, sin)
    jfn = (jfra.fused_rope_append_attend_decode if fused
           else jfra.decode_reference)
    tfn = (tfra.fused_rope_append_attend_decode if fused
           else tfra.decode_reference)
    j_out, j_cache = jfn(*(jnp.asarray(a) for a in rows), jc, 0,
                         jnp.asarray(active))
    t_out, t_cache = tfn(*(_t(a) for a in rows), tc, 0, _t(active))
    np.testing.assert_allclose(_np(t_out), np.asarray(j_out), **TOL)
    assert not _np(t_out)[1].any()
    _assert_same_cache(t_cache, j_cache, atol=3e-6)


@pytest.mark.parametrize("plan", ["norm_matmul,rope_append_attend",
                                  "norm_matmul"])
def test_fusion_seams_route_by_plan(monkeypatch, plan):
    """The attend seams take K3's entries with the fusion on and the
    unfused chains (K10 / K11 on the card) with it off; on CPU both give
    the same output and pools."""
    jc, tc, rng = _caches(seed=13, cap=40)
    rows, wave = _ragged_inputs(rng, jc)
    copy = tc._replace(k_pages=tc.k_pages.clone(),
                       v_pages=tc.v_pages.clone())
    ref_out, ref_cache = tfra.ragged_reference(
        *(_t(a) for a in rows), copy, 0, *(_t(a) for a in wave), plain=True)
    seen = []
    monkeypatch.setattr(tfra, "fused_rope_append_attend",
                        lambda *a, **kw: seen.append("fused")
                        or tfra.ragged_reference(*a, **kw))
    old = tflags.get_flag("fused_decode_fusions")
    tflags.set_flags({"fused_decode_fusions": plan})
    try:
        out, cache = tfusion.ragged_attend(*(_t(a) for a in rows), tc, 0,
                                           *(_t(a) for a in wave))
    finally:
        tflags.set_flags({"fused_decode_fusions": old})
    assert seen == (["fused"] if "rope" in plan else [])
    torch.testing.assert_close(out, ref_out, rtol=0, atol=0)
    torch.testing.assert_close(cache.k_pages, ref_cache.k_pages, rtol=0,
                               atol=0)


def test_planned_launches_unfused_attend():
    """With rope_append_attend off the plan counts one attention kernel
    (K10 per decode step, K11 per wave) per layer."""
    assert tfusion.planned_kernel_launches(32, enabled=("norm_matmul",)) == {
        "norm_matmul": 161, "rope_append_attend": 0, "paged_attention": 32}
    assert tfusion.planned_kernel_launches(2, enabled=()) == {
        "norm_matmul": 0, "rope_append_attend": 0, "paged_attention": 2}
