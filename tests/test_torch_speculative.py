"""Speculative decoding's pieces: the PyTorch port vs the JAX package, on CPU.

``inference/speculative.py``: ``NGramDraft`` (host numpy), ``greedy_accept``
and ``segment_row_index`` (device ops) against the JAX package's on its unit
cases (tests/test_spec_decode.py) and on seeded random ones, bitwise.
``kv_cache.advance_by``, the rewind. The ``fresh_pool_read`` forms of the
ragged attention's plain chains (``fused_rope_attend.ragged_reference`` and
``fusion.ragged_attend`` in both plans, ``ragged_paged_attention_pure``):
the same numpy-made wave through the JAX package's ``ragged_reference``,
at head_dim 128 on a bf16 pool (f32 activations, so the pool-dtype cast
really rounds the flagged rows) and on an int8 pool; output within 1e-5
(the two sides sum in different orders), pools bit-identical. The wave's q
and k are dyadic numbers with few bits and the cos / sin quarters, so
every rope product and sum is exact in f32 on both sides (XLA may fuse
them into an FMA) and the written cells can be held bit for bit.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.inference import speculative as jspec
from paddle_tpu.models import kv_cache as jkv
from paddle_tpu.ops.pallas import fused_rope_attend as jfra

from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.inference import speculative as tspec
from paddle_tpu_torch.models import kv_cache as tkv
from paddle_tpu_torch.ops.kernels import fused_rope_attend as tfra
from paddle_tpu_torch.ops.kernels import fusion as tfusion
from paddle_tpu_torch.ops.kernels import ragged_paged_attention as trpa

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.tensor(np.asarray(a))


# ------------------------------------------------------------ NGramDraft


NGRAM_CASES = [
    # (n, min_n, history, k) — the reference's unit cases
    (3, 1, [1, 2, 3, 4, 5, 9, 1, 2, 3], 2),
    (3, 1, [1, 2, 3, 4, 5, 9, 1, 2, 3], 1),
    (2, 2, [7, 8, 1, 7, 8, 2, 7, 8], 1),
    (3, 1, [5, 1, 2, 3, 9, 4, 1, 2, 3], 1),
    (3, 1, list(range(10)), 4),
    (3, 1, [3], 4),
    (3, 1, [], 4),
    (3, 1, list(range(10)), 0),
    (2, 2, [9, 1, 2], 2),
]


@pytest.mark.parametrize("case", range(len(NGRAM_CASES)))
def test_ngram_draft_unit_cases_match_jax(case):
    n, min_n, hist, k = NGRAM_CASES[case]
    hist = np.asarray(hist, np.int32)
    want = jspec.NGramDraft(n, min_n).propose(hist, k)
    got = tspec.NGramDraft(n, min_n).propose(hist, k)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(4))
def test_ngram_draft_random_histories_match_jax(seed):
    """Histories over a small vocabulary (matches are frequent), every
    (n, min_n, k) the proposer takes."""
    rng = np.random.default_rng(seed)
    for _ in range(40):
        hist = rng.integers(0, 5, size=int(rng.integers(0, 30))).astype(
            np.int32)
        n = int(rng.integers(1, 5))
        min_n = int(rng.integers(1, n + 1))
        k = int(rng.integers(0, 6))
        np.testing.assert_array_equal(
            tspec.NGramDraft(n, min_n).propose(hist, k),
            jspec.NGramDraft(n, min_n).propose(hist, k))


@pytest.mark.parametrize("n,min_n", [(0, 1), (2, 3), (2, 0)])
def test_ngram_draft_ctor_validation(n, min_n):
    with pytest.raises(ValueError):
        tspec.NGramDraft(n=n, min_n=min_n)


# --------------------------------------------------------- greedy_accept


ACCEPT_CASES = [
    # (cand, drafts, k_eff, remaining, keywords) — the reference's cases
    ([[10, 11, 12, 13]], [[10, 11, 99]], [3], [8], {}),
    ([[1, 2, 3, 4]], [[1, 2, 3]], [3], [8], {}),
    ([[1, 2, 3, 4]], [[9, 2, 3]], [3], [8], {}),
    ([[1, 2, 3]], [[1, 2]], [1], [8], {}),
    ([[1, 2, 3]], [[1, 2]], [2], [1], {}),
    ([[1, 7, 3]], [[1, 3]], [2], [8], {"eos": 7}),
    ([[1, 2, 3]], [[1, 2]], [2], [8], {"fin_ok": [[True, False, True]]}),
    ([[1, 2, 3]], [[1, 2]], [2], [8], {"gate": [False]}),
]


def _accept_both(cand, drafts, k_eff, remaining, kw):
    jkw = {k: (jnp.asarray(v) if k != "eos" else v) for k, v in kw.items()}
    tkw = {k: (torch.tensor(v) if k != "eos" else v) for k, v in kw.items()}
    je, jn = jspec.greedy_accept(*(jnp.asarray(x, jnp.int32) for x in (
        cand, drafts, k_eff, remaining)), **jkw)
    te, tn = tspec.greedy_accept(*(torch.tensor(np.asarray(x, np.int32))
                                   for x in (cand, drafts, k_eff,
                                             remaining)), **tkw)
    assert te.dtype == torch.bool and tn.dtype == torch.int32
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    return te.numpy(), tn.numpy()


@pytest.mark.parametrize("case", range(len(ACCEPT_CASES)))
def test_greedy_accept_unit_cases_match_jax(case):
    emit, n = _accept_both(*ACCEPT_CASES[case])
    if case == 0:       # drafts 10, 11 accepted, bonus cand[2]
        np.testing.assert_array_equal(emit[0], [True, True, True, False])
        assert n[0] == 3
    if case == 5:       # the eos itself is emitted, nothing after it
        np.testing.assert_array_equal(emit[0], [True, True, False])


@pytest.mark.parametrize("seed", range(4))
def test_greedy_accept_random_waves_match_jax(seed):
    """Random slots over a 3-token vocabulary (frequent matches): k_eff,
    budgets, eos, non-finite rows and the gate all mixed."""
    rng = np.random.default_rng(seed)
    b, k = 16, 4
    for trial in range(10):
        cand = rng.integers(0, 3, size=(b, k + 1))
        drafts = np.where(rng.random((b, k)) < 0.1, -1,
                          rng.integers(0, 3, size=(b, k)))
        kw = {}
        if trial % 2:
            kw["eos"] = int(rng.integers(0, 3))
        if trial % 3 == 1:
            kw["fin_ok"] = rng.random((b, k + 1)) > 0.15
        if trial % 4 == 2:
            kw["gate"] = rng.random(b) > 0.2
        _accept_both(cand, drafts, rng.integers(0, k + 1, size=b),
                     rng.integers(0, 7, size=b), kw)


# ----------------------------------------------------- segment_row_index


@pytest.mark.parametrize("q_start,q_len,k1,t", [
    ([0, 5], [3, 1], 4, 16),                 # the reference's case
    ([0, 5, 6, 30], [5, 0, 20, 4], 5, 32),   # an empty and a long segment
    ([28, 0], [6, 2], 3, 32),                # clamped to the wave
])
def test_segment_row_index_matches_jax(q_start, q_len, k1, t):
    want = jspec.segment_row_index(jnp.asarray(q_start, jnp.int32),
                                   jnp.asarray(q_len, jnp.int32), k1, t)
    got = tspec.segment_row_index(torch.tensor(q_start, dtype=torch.int32),
                                  torch.tensor(q_len, dtype=torch.int32),
                                  k1, t)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_advance_by_matches_jax():
    jc = jkv.create_paged_cache(1, 3, 32, 2, 16, page_size=8)
    tc = tkv.create_paged_cache(1, 3, 32, 2, 16, page_size=8)
    seq = np.asarray([5, 0, 17], np.int32)
    jc = jc._replace(seq_lens=jnp.asarray(seq))
    tc = tc._replace(seq_lens=torch.tensor(seq))
    delta = np.asarray([3, 0, 1], np.int32)
    got = tkv.advance_by(tc, torch.tensor(delta)).seq_lens
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jkv.advance_by(jc, jnp.asarray(delta))
                                .seq_lens))


# ------------------------------------------- the fresh_pool_read chains


LENS = (17, 25, 9)        # the slots' old lengths


def _dyadic(rng, shape, bits=4):
    """Values m / 2**bits with |m| < 2**(bits + 2): their rope products and
    sums with quarter-valued cos / sin are exact in f32 (and in bf16)."""
    return (rng.integers(-(2 ** (bits + 2)) + 1, 2 ** (bits + 2),
                         size=shape) / 2.0 ** bits).astype(np.float32)


def _spec_case(seed, pool, t=16, h=4, hk=2, d=128, page=8, cap=40):
    """The same prefilled cache on both sides (``pool`` "bf16": a bf16 pool
    under f32 activations; "int8") and a verify-shaped wave over it: slot
    0 a 4-row verify segment (its token and 3 drafts), slot 1 a 5-row
    prompt chunk, slot 2 a 1-row verify segment (no drafts); rows 10..
    pad the wave."""
    rng = np.random.default_rng(seed)
    b = len(LENS)
    jdt = {"bf16": jnp.bfloat16, "int8": "int8"}[pool]
    tdt = {"bf16": torch.bfloat16, "int8": torch.int8}[pool]
    jc = jkv.create_paged_cache(1, b, cap, hk, d, page_size=page, dtype=jdt)
    tc = tkv.create_paged_cache(1, b, cap, hk, d, page_size=page, dtype=tdt)
    s = max(LENS)
    k = rng.normal(size=(b, s, hk, d)).astype(np.float32)
    v = rng.normal(size=(b, s, hk, d)).astype(np.float32)
    lens = np.asarray(LENS, np.int32)
    jc = jkv.prefill_paged_cache(jc, 0, jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(lens))
    tc = tkv.prefill_paged_cache(tc, 0, _t(k), _t(v), _t(lens))
    for name in ("k_pages", "v_pages", "k_scales", "v_scales"):
        if getattr(tc, name) is not None:
            assert np.array_equal(
                getattr(tc, name).float().numpy(),
                np.asarray(getattr(jc, name)).astype(np.float32)), name
    q = _dyadic(rng, (t, h, d))
    kr = _dyadic(rng, (t, hk, d))
    vr = rng.normal(size=(t, hk, d)).astype(np.float32)
    cos = rng.integers(-4, 5, size=(t, d)).astype(np.float32) / 4
    sin = rng.integers(-4, 5, size=(t, d)).astype(np.float32) / 4
    segs = [(0, 4, LENS[0]), (1, 5, LENS[1]), (2, 1, LENS[2])]
    row_slot = np.full((t,), -1, np.int32)
    row_pos = np.zeros((t,), np.int32)
    q_start = np.zeros((b,), np.int32)
    q_lens = np.zeros((b,), np.int32)
    row = 0
    for slot, n, seq in segs:
        q_start[slot], q_lens[slot] = row, n
        row_slot[row:row + n] = slot
        row_pos[row:row + n] = np.arange(seq, seq + n)
        row += n
    wave = (row_slot, row_pos, row_slot >= 0, lens.copy(), q_start, q_lens,
            q_lens.copy())
    return jc, tc, (q, kr, vr, cos, sin), wave


def _cache_bits(c):
    return {n: np.asarray(getattr(c, n)).astype(np.float32)
            if not isinstance(getattr(c, n), torch.Tensor)
            else getattr(c, n).float().numpy()
            for n in ("k_pages", "v_pages", "k_scales", "v_scales")
            if getattr(c, n) is not None}


FLAGS = {"none": None, "all": (1, 1, 1), "verify": (1, 0, 1),
         "off": (0, 0, 0)}


@pytest.mark.parametrize("flag", sorted(FLAGS))
@pytest.mark.parametrize("pool", ["bf16", "int8"])
def test_ragged_reference_fresh_pool_read_matches_jax(pool, flag):
    jc, tc, rows, wave = _spec_case(3, pool)
    fpr = FLAGS[flag]
    jkw = {} if fpr is None else {"fresh_pool_read": jnp.asarray(fpr, bool)}
    tkw = {} if fpr is None else {"fresh_pool_read": torch.tensor(
        fpr, dtype=torch.bool)}
    j_out, j_cache = jfra.ragged_reference(
        *(jnp.asarray(a) for a in rows), jc, 0,
        *(jnp.asarray(a) for a in wave), **jkw)
    t_out, t_cache = tfra.ragged_reference(*(_t(a) for a in rows), tc, 0,
                                           *(_t(a) for a in wave), **tkw)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), **TOL)
    jb, tb = _cache_bits(j_cache), _cache_bits(t_cache)
    for name in tb:
        np.testing.assert_array_equal(tb[name], jb[name], err_msg=name)
    # the plain version (plain=True) reads the same numbers
    _, tc2, _, _ = _spec_case(3, pool)
    p_out, _ = tfra.ragged_reference(*(_t(a) for a in rows), tc2, 0,
                                     *(_t(a) for a in wave), plain=True,
                                     **tkw)
    np.testing.assert_allclose(p_out.numpy(), np.asarray(j_out), **TOL)


@pytest.mark.parametrize("pool", ["bf16", "int8"])
def test_fresh_pool_read_changes_flagged_slots_only(pool):
    """Not vacuous: the flag moves the verify slots' rows (a bf16 pool
    rounds the f32 fresh v, an int8 pool quantizes both) and no other row;
    an all-False flag is the plain wave bit for bit."""
    outs = {}
    for flag in ("none", "off", "verify"):
        _, tc, rows, wave = _spec_case(3, pool)
        fpr = FLAGS[flag]
        kw = {} if fpr is None else {"fresh_pool_read": torch.tensor(
            fpr, dtype=torch.bool)}
        outs[flag], _ = tfra.ragged_reference(
            *(_t(a) for a in rows), tc, 0, *(_t(a) for a in wave), **kw)
    assert torch.equal(outs["none"], outs["off"])
    moved = (outs["verify"] != outs["none"]).any(dim=(1, 2))
    row_slot = torch.tensor(_spec_case(3, pool)[3][0])
    flagged = (row_slot == 0) | (row_slot == 2)
    assert moved[flagged].any()
    assert not moved[~flagged].any()


@pytest.mark.parametrize("plan", ["norm_matmul,rope_append_attend",
                                  "norm_matmul"])
@pytest.mark.parametrize("pool", ["bf16", "int8"])
def test_ragged_attend_seam_carries_the_flag(pool, plan):
    """``fusion.ragged_attend(fresh_pool_read=)`` in both plans against the
    JAX package's seam with its plain lowering."""
    jc, tc, rows, wave = _spec_case(5, pool)
    fpr = FLAGS["verify"]
    j_out, _ = jfra.ragged_reference(
        *(jnp.asarray(a) for a in rows), jc, 0,
        *(jnp.asarray(a) for a in wave),
        fresh_pool_read=jnp.asarray(fpr, bool))
    old = tflags.get_flag("fused_decode_fusions")
    tflags.set_flags({"fused_decode_fusions": plan})
    try:
        t_out, _ = tfusion.ragged_attend(
            *(_t(a) for a in rows), tc, 0, *(_t(a) for a in wave),
            fresh_pool_read=torch.tensor(fpr, dtype=torch.bool))
    finally:
        tflags.set_flags({"fused_decode_fusions": old})
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), **TOL)


def test_fresh_through_pool_is_the_jax_roundtrip():
    """The carriers themselves, bitwise: codes * scale of the JAX
    ``quantize_cells`` on an int8 pool, the bf16 cast on a bf16 pool."""
    rng = np.random.default_rng(8)
    rows = rng.normal(size=(12, 2, 128)).astype(np.float32)
    for quantized, jdt, tdt in ((True, None, torch.int8),
                                (False, jnp.bfloat16, torch.bfloat16)):
        want = jfra._pool_roundtrip(jnp.asarray(rows), quantized, jdt)
        got = trpa.pool_roundtrip(_t(rows), quantized, tdt)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
