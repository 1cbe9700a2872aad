"""The paged decode walk of K10 and K3's decode forms, modelled on the CPU.

``csrc/paged_walk.cuh`` splits each (kv head, slot) walk in whole pages
across a thread-block cluster and merges the ranks' partial softmax states
in rank order. Its grid and ranges are mirrored by
``paged_attention.walk_plan`` / ``walk_range`` / ``walk_items`` (checked
here against the rule and brute force, and on the card against the
kernel's own decoding in ``tests/test_torch_cuda_kernels.py``); its
arithmetic by ``paged_attention.split_walk_reference``, held here against
the JAX package's Pallas kernels in interpret mode (``_pallas_paged``
through ``paged_attention_pure``; ``_pallas_fused`` through the decode
``fused_rope_append_attend_decode``, behind the port's rope and cache
writers), at lengths on page and range edges, with an ``active`` mask and
on the int8 cache, for every cluster size. Tolerances as
``tests/test_torch_ragged_attention.py``: 2e-5 (f32 sums in another
order); written cells within 3e-6 (bf16-free f32 rope, XLA may fuse an
FMA), int8 codes within 1 and scales within 1e-6 relative.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.models import kv_cache as jkv
from paddle_tpu.ops.pallas import fused_rope_attend as jfra
from paddle_tpu.ops.pallas import paged_attention as jpa

from paddle_tpu_torch.models import kv_cache as tkv
from paddle_tpu_torch.models.llama import apply_rotary_rows
from paddle_tpu_torch.ops.kernels import paged_attention as tpa

TOL = dict(rtol=2e-5, atol=2e-5)
CLUSTERS = (1, 2, 4, 8)
CAP = 160


def _t(a):
    return torch.tensor(np.asarray(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------ the plan


def _rule(bhk, pps, sms):
    """The cluster rule written out: the least power of two up to 8 (and
    up to pps) whose bhk * cs CTAs cover the SMs, else the largest."""
    allowed = [c for c in CLUSTERS if c == 1 or c <= pps]
    covering = [c for c in allowed if bhk * c >= sms]
    return min(covering) if covering else max(allowed)


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("cap", [48, 160, 640])
@pytest.mark.parametrize("page", [16, 32])
def test_walk_ranges_cover_every_cell_once(page, cap, sms):
    """For every B x Hk from 2 to 64 and every length 0..cap: cs follows
    the rule, the ranks' ranges are whole pages, contiguous in rank order,
    balanced within a page, and cover each cell of [0, n) exactly once."""
    pps = -(-cap // page)
    for bhk in range(2, 65):
        cs, grid = tpa.walk_plan(bhk, 1, pps, sms)
        assert (cs, grid) == (_rule(bhk, pps, sms), bhk * cs), bhk
        if bhk % 8 == 0:  # the rule sees B x Hk alone
            assert tpa.walk_plan(bhk // 8, 8, pps, sms) == (cs, grid)
        for n in range(cap + 1):
            ranges = [tpa.walk_range(n, page, pps, r, cs) for r in range(cs)]
            cells = []
            for lo, hi in ranges:
                assert 0 <= lo <= hi <= pps
                cells += range(lo * page, min(hi * page, n))
            assert cells == list(range(n)), (bhk, n)
            assert ranges[0][0] == 0 and all(
                a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
            sizes = [hi - lo for lo, hi in ranges]
            assert max(sizes) - min(sizes) <= 1
            # only the last rank's range may end inside a page
            for lo, hi in ranges[:-1]:
                assert hi * page <= n


def test_walk_items_follow_the_ranges():
    """``walk_items``' rows are (rank, lo, hi) in (slot, kv head, rank)
    order, one cluster of ``walk_plan``'s size per (kv head, slot)."""
    lens, hk, pps, page = (0, 17, 600, 129), 8, 40, 16
    cs, grid = tpa.walk_plan(len(lens), hk, pps)
    rows = tpa.walk_items(lens, hk, pps, page)
    assert (cs, grid, len(rows)) == (8, 256, 256)
    for i, row in enumerate(rows):
        b, rank = i // (hk * cs), i % cs
        assert row == (rank, *tpa.walk_range(lens[b], page, pps, rank, cs))
    assert rows[-1] == (7, 7, 9) and rows[0] == (0, 0, 0)


# ------------------------------------------- the arithmetic vs the JAX kernels


def _caches(rng, int8, b, hk, page, lens):
    """The same prefilled cache on both sides at lengths ``lens``."""
    jc = jkv.create_paged_cache(1, b, CAP, hk, 128, page_size=page,
                                dtype="int8" if int8 else jnp.float32)
    tc = tkv.create_paged_cache(1, b, CAP, hk, 128, page_size=page,
                                dtype=torch.int8 if int8 else torch.float32)
    s = max(max(lens), 1)
    k, v = (rng.normal(size=(b, s, hk, 128)).astype(np.float32)
            for _ in "kv")
    lens = np.asarray(lens, np.int32)
    jc = jkv.prefill_paged_cache(jc, 0, jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(lens))
    tc = tkv.prefill_paged_cache(tc, 0, _t(k), _t(v), _t(lens))
    return jc, tc


def _edge_lens(page, cs):
    """Walk lengths on page and range edges: 0, 1, page - 1, page, page +
    1, each inner range end of a walk of 7 pages +- 1 (for cs), CAP - 1."""
    ends = sorted({tpa.walk_range(7 * page, page, CAP // page, r, cs)[1]
                   for r in range(cs - 1)})
    edges = {0, 1, page - 1, page, page + 1, CAP - 1}
    for e in ends:
        edges |= {e * page - 1, e * page, e * page + 1}
    return tuple(sorted(x for x in edges if 0 <= x < CAP))


@pytest.fixture(scope="module")
def paged_case():
    """Per (int8, cs): the cache, q, lengths and the JAX kernel's output
    (Pallas in interpret mode; a spy checks that it ran)."""
    done = {}

    def get(int8, cs):
        page = 32 if int8 else 16
        lens = _edge_lens(page, cs)
        key = (int8, lens)
        if key not in done:
            rng = np.random.default_rng(20 + int8)
            b, hk = len(lens), 2
            jc, tc = _caches(rng, int8, b, hk, page, lens)
            q = rng.normal(size=(b, 8, 128)).astype(np.float32)
            calls = []
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(jpa, "_INTERPRET", True)
                real = jpa._pallas_paged
                mp.setattr(jpa, "_pallas_paged",
                           lambda *a, **kw: calls.append(1) or real(*a, **kw))
                ks, vs = jkv.layer_scales(jc, 0)
                j = jpa.paged_attention_pure(
                    jnp.asarray(q), jc.k_pages[0], jc.v_pages[0],
                    jc.block_tables, jnp.asarray(np.asarray(lens, np.int32)),
                    k_scales=ks, v_scales=vs)
            assert calls, "the Pallas paged kernel did not run"
            done[key] = (tc, q, lens, np.asarray(j))
        return done[key]

    return get


def _walk(tc, q, lens, cs, drop_last=False):
    ks, vs = tkv.layer_scales(tc, 0)
    return _np(tpa.split_walk_reference(
        _t(q), tc.k_pages[0], tc.v_pages[0], tc.block_tables,
        _t(np.asarray(lens, np.int32)), k_scales=ks, v_scales=vs, cs=cs,
        drop_last=drop_last))


@pytest.mark.parametrize("cs", CLUSTERS)
@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_split_walk_matches_jax_paged_kernel(paged_case, int8, cs):
    """K10's split walk vs ``_pallas_paged`` at every edge length; a
    length-0 slot is exact zeros."""
    tc, q, lens, j = paged_case(int8, cs)
    t = _walk(tc, q, lens, cs)
    np.testing.assert_allclose(t, j, **TOL)
    assert not t[list(lens).index(0)].any()


@pytest.mark.parametrize("cs", CLUSTERS)
@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_split_walk_without_its_last_range_fails(paged_case, int8, cs):
    """The fault control ``chip_smoke.py`` runs: the last range's partial
    left out moves every nonempty walk's output far past the tolerance."""
    tc, q, lens, j = paged_case(int8, cs)
    t = _walk(tc, q, lens, cs, drop_last=True)
    err = np.abs(t - j) - (TOL["atol"] + TOL["rtol"] * np.abs(j))
    for b, n in enumerate(lens):
        assert (err[b].max() > 0) == (n > 0), n


# positions (seq_lens) of the decode cases: the walk covers pos + 1 cells,
# so pos on a page start puts K3's own cell first in its page, and at 16,
# 48 and 112 (page 16) first in the last rank's range for cs 2, 4 and 8
DECODE_POS = {16: (0, 1, 15, 16, 17, 31, 47, 48, 49, 111, 112, CAP - 1),
              32: (0, 1, 31, 32, 33, 63, 64, 65, 95, 96, CAP - 1)}


@pytest.fixture(scope="module")
def decode_case():
    """Per (int8, active): inputs and the JAX fused decode kernel's output
    and cache (Pallas in interpret mode)."""
    done = {}

    def get(int8, masked):
        if (int8, masked) not in done:
            page = 32 if int8 else 16
            pos = DECODE_POS[page]
            b, hk = len(pos), 2
            rng = np.random.default_rng(30 + 2 * int8 + masked)
            jc, tc = _caches(rng, int8, b, hk, page, pos)
            rows = (rng.normal(size=(b, 8, 128)),
                    *(rng.normal(size=(b, hk, 128)) for _ in "kv"),
                    *(rng.normal(size=(b, 128)) for _ in "cs"))
            rows = tuple(r.astype(np.float32) for r in rows)
            active = (np.arange(b) % 3 != 1) if masked else None
            calls = []
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(jfra, "_INTERPRET", True)
                real = jfra._pallas_fused
                mp.setattr(jfra, "_pallas_fused",
                           lambda *a, **kw: calls.append(1) or real(*a, **kw))
                j_out, j_cache = jfra.fused_rope_append_attend_decode(
                    *(jnp.asarray(r) for r in rows), jc, 0,
                    None if active is None else jnp.asarray(active))
            assert calls, "the Pallas fused kernel did not run"
            done[(int8, masked)] = (tc, rows, active, np.asarray(j_out),
                                    j_cache)
        return done[(int8, masked)]

    return get


def _split_decode(tc, rows, active, cs):
    """rope -> the cache write -> the split walk over pos + 1 cells (0 for
    an inactive slot): what K3's decode form computes."""
    q, k, v, cos, sin = (_t(r) for r in rows)
    q2, k2 = apply_rotary_rows(q, k, cos, sin)
    cache = tc._replace(**{n: getattr(tc, n).clone() for n in (
        "k_pages", "v_pages", "k_scales", "v_scales")
        if getattr(tc, n) is not None})
    if active is None:
        cache = tkv.append_token(cache, 0, k2, v)
        lens = cache.seq_lens + 1
    else:
        act = _t(active)
        cache = tkv.append_token_masked(cache, 0, k2, v, act)
        lens = torch.where(act, cache.seq_lens + 1,
                           torch.zeros_like(cache.seq_lens))
    ks, vs = tkv.layer_scales(cache, 0)
    out = tpa.split_walk_reference(q2, cache.k_pages[0], cache.v_pages[0],
                                   cache.block_tables, lens, k_scales=ks,
                                   v_scales=vs, cs=cs)
    return _np(out), cache


@pytest.mark.parametrize("cs", CLUSTERS)
@pytest.mark.parametrize("masked", [False, True], ids=["all", "active"])
@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_split_walk_matches_jax_fused_decode(decode_case, int8, masked, cs):
    """K3's decode form as the split walk computes it (rope, the cell
    written, the walk over pos + 1 cells) vs ``_pallas_fused`` in its
    decode use: outputs, the written cells; inactive slots write nothing
    and return zeros."""
    tc, rows, active, j_out, j_cache = decode_case(int8, masked)
    t_out, t_cache = _split_decode(tc, rows, active, cs)
    np.testing.assert_allclose(t_out, j_out, **TOL)
    if active is not None:
        assert not t_out[~active].any()
    if int8:
        for name in ("k_pages", "v_pages"):
            diff = np.abs(_np(getattr(t_cache, name)).astype(int)
                          - np.asarray(getattr(j_cache, name)).astype(int))
            assert diff.max() <= 1, name
        for name in ("k_scales", "v_scales"):
            np.testing.assert_allclose(_np(getattr(t_cache, name)),
                                       np.asarray(getattr(j_cache, name)),
                                       rtol=1e-6, atol=0, err_msg=name)
    else:
        for name in ("k_pages", "v_pages"):
            np.testing.assert_allclose(_np(getattr(t_cache, name)),
                                       np.asarray(getattr(j_cache, name)),
                                       rtol=3e-6, atol=3e-6, err_msg=name)
    if active is not None:
        # an inactive slot's cells are as they were
        for name in ("k_pages", "v_pages"):
            old, new = _np(getattr(tc, name)), _np(getattr(t_cache, name))
            bt = _np(tc.block_tables)
            for b in np.flatnonzero(~active):
                np.testing.assert_array_equal(new[:, :, bt[b]],
                                              old[:, :, bt[b]])
