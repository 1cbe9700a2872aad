"""The ragged walk of K11 and K3's ragged form, modelled on the CPU.

``csrc/ragged_walk.cuh`` runs a grid that depends on shapes only and
decodes its work on the device: a walk item for each decode row (its page
walk split in whole pages across a thread-block cluster, the ranks'
partial softmax states merged in rank order) and tile items of 64 MMA rows
for every other slot's rows. Its grid and items are mirrored by
``ragged_paged_attention.ragged_plan`` / ``ragged_items`` (checked here
against the rule and a brute-force count, and on the card against the
kernel's own decoding in ``tests/test_torch_cuda_kernels.py``); its
arithmetic by ``ragged_paged_attention.split_ragged_reference``, held here
against the JAX package's Pallas kernels in interpret mode
(``_pallas_ragged`` through ``ragged_paged_attention_pure``;
``_pallas_fused`` through the ragged ``fused_rope_append_attend``, behind
the port's rope and cache writers) on the waves of
``tests/ragged_wave_cases.py``, for GQA groups 1, 2, 4 and 8 and every
cluster size, with a poisoned slot; and on an int8 cache (page cells read
as code * scale, the fresh source at full precision) for groups 1 and 4
and clusters of 1 and 4. Tolerances as
``tests/test_torch_ragged_attention.py``: 2e-5 (f32 sums in another
order); written cells within 3e-6 (f32 rope, XLA may fuse an FMA), int8
codes within 1 and scales within 1e-6 relative.
"""

from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.models import kv_cache as jkv
from paddle_tpu.ops.pallas import fused_rope_attend as jfra
from paddle_tpu.ops.pallas import ragged_paged_attention as jrpa

from paddle_tpu_torch.models import kv_cache as tkv
from paddle_tpu_torch.models.llama import apply_rotary_rows
from paddle_tpu_torch.ops.kernels import fused_rope_attend as tfra
from paddle_tpu_torch.ops.kernels import paged_attention as tpa
from paddle_tpu_torch.ops.kernels import ragged_paged_attention as trpa

from ragged_wave_cases import edge_waves, layout

TOL = dict(rtol=2e-5, atol=2e-5)
CLUSTERS = (1, 2, 4, 8)
GROUPS = (1, 2, 4, 8)
# the int8 cases: fewer groups and cluster sizes (each reruns the JAX
# kernels in interpret mode)
INT8_GROUPS = (1, 4)
INT8_CLUSTERS = (1, 4)


def _int8_cases(*axes):
    """pytest params over ``axes`` (name, values, int8 values) twice: the
    f32 cases under the ids they always had, then the int8 cases, their ids
    ending in ``-int8``."""
    out = []
    for int8 in (False, True):
        for combo in itertools.product(*(v8 if int8 else v
                                         for _, v, v8 in axes)):
            out.append(pytest.param(*combo, int8, id="-".join(
                map(str, combo)) + ("-int8" if int8 else "")))
    return out


def _t(a):
    return torch.tensor(np.asarray(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------ the plan


def _plan_waves(page, g):
    """Waves for the plan: the edge waves, a decode-only wave, a wave of
    one-row chunks and a mixed wave of chunk lengths around the tile edge,
    each also padded to T = 264."""
    r = 64 // g
    waves = list(edge_waves(g, page).values())
    waves.append([(p * page + e, 1, 0) for p, e in
                  itertools.product((0, 1, 6), (-1, 0, 1)) if p * page + e >= 0])
    waves.append([(3, 1, 1), (0, 1, 1), (0, 0, 0), (page, 2, 2)])
    waves.append([(0, 2 * r - 1, 2 * r - 1), (page - 1, 2 * r + 1, 2 * r + 1),
                  (40, 1, 0), (0, 0, 0), (5 * page, 3, 0)])
    out = []
    for slots in waves:
        lay = layout(slots)
        out.append(lay)
        if lay["t"] < 264:
            out.append(layout(slots, 264))
    return out


@pytest.mark.parametrize("sms", [8, 24, 48, 132])
@pytest.mark.parametrize("g", GROUPS)
@pytest.mark.parametrize("page", [16, 32])
def test_ragged_items_cover_every_row_and_cell_once(page, g, sms):
    """For each wave: the cluster size is the page walk's rule (clusters of
    1, 2, 4 and 8 across the ``sms`` values); per kv head the CTAs with
    work come first and fit the plan's clusters; each walk slot is one
    cluster whose ranks are 0..cs - 1 in order and whose (first, end) key
    ranges cover the slot's cells [0, page_lens) exactly once; each other
    slot's rows are covered by its tiles of 64 / g rows exactly once, in
    order, each walking its pages and its fresh keys up to its last row;
    idle slots and rows of no segment get no item."""
    hk, r = 2, 64 // g
    for lay in _plan_waves(page, g):
        t, b = lay["t"], len(lay["seq"])
        pps = lay["cap"] // page
        ql, pl, fl = lay["q_lens"], lay["page_lens"], lay["fresh_lens"]
        cs, clusters, ctas = trpa.ragged_plan(t, b, hk, g, pps, sms)
        assert cs == tpa.walk_plan(b, hk, pps, sms)[0]
        rows = trpa.ragged_items(ql, pl, fl, t, hk, g, pps, page, sms)
        assert len(rows) == ctas == hk * clusters * cs
        walks = [i for i in range(b) if ql[i] == 1 and fl[i] == 0]
        tiles = [(i, k) for i in range(b) if ql[i] and i not in walks
                 for k in range(-(-ql[i] // r))]
        for kh in range(hk):
            head = rows[kh * clusters * cs:(kh + 1) * clusters * cs]
            assert all(x[2] == kh for x in head)
            kinds = [x[0] for x in head]
            work = len(walks) * cs + len(tiles)
            assert kinds == ([trpa.RAGGED_WALK] * len(walks) * cs
                             + [trpa.RAGGED_TILE] * len(tiles)
                             + [trpa.RAGGED_EMPTY] * (len(head) - work))
            for wi, slot in enumerate(walks):
                ranks = head[wi * cs:(wi + 1) * cs]
                assert [x[1] for x in ranks] == [slot] * cs
                assert [x[3] for x in ranks] == list(range(cs))
                cells = []
                for _, _, _, _, first, end in ranks:
                    assert first % page == 0
                    cells += range(first, end)
                assert cells == list(range(pl[slot])), (slot, pl[slot])
            got = [(x[1], x[3]) for x in head[len(walks) * cs:work]]
            assert got == tiles
            for (slot, k), x in zip(tiles, head[len(walks) * cs:work]):
                last = min(ql[slot], (k + 1) * r)
                assert x[4:] == (0, pl[slot] + min(fl[slot], last))
            covered = [0] * t
            for slot in walks:
                covered[lay["q_start"][slot]] += 1
            for slot, k in tiles:
                s0 = lay["q_start"][slot]
                for row in range(s0 + k * r, s0 + min(ql[slot], (k + 1) * r)):
                    covered[row] += 1
            assert covered == [int(s >= 0) for s in lay["row_slot"]]


def test_ragged_plan_takes_every_cluster_size():
    """The SM counts of the coverage test give the ``walks`` wave (eight
    slots, two kv heads, 10 pages a slot) clusters of 1, 2, 4 and 8."""
    lay = layout(edge_waves(4, 16)["walks"])
    got = [trpa.ragged_plan(lay["t"], 8, 2, 4, lay["cap"] // 16, sms)[0]
           for sms in (8, 24, 48, 132)]
    assert got == [1, 2, 4, 8]


def test_ragged_plan_bounds_the_work_of_every_wave():
    """The clusters a kv head are the most work any wave of T rows over B
    slots can make (at least one): brute force over every split of the
    rows into B slots of walks and chunks (tiles of 16 rows, g 4; clusters
    of 4)."""
    for t, b in ((8, 4), (16, 4), (24, 3), (40, 3), (40, 2), (16, 1)):
        cs, clusters, _ = trpa.ragged_plan(t, b, 1, 4, 40, sms=4 * b)
        assert cs == 4
        most = 1
        for qs in itertools.product(range(t + 1), repeat=b):
            if sum(qs) > t:
                continue
            ones = [i for i, q in enumerate(qs) if q == 1]
            for w in range(len(ones) + 1):   # w of the one-row slots decode
                nt = sum(-(-q // 16) for q in qs) - w
                most = max(most, w + -(-nt // cs))
        assert clusters == most, (t, b, clusters, most)


# ------------------------------------------- the arithmetic vs the JAX kernels


def _wave_case(rng, g, page, name, hk=2, int8=False):
    """The same cache on both sides (f32, or int8 codes with per-cell
    scales; block tables permuted, K/V of every slot prefilled to its
    page_lens), the wave's rows and layout."""
    lay = layout(edge_waves(g, page)[name])
    b, cap, t = len(lay["seq"]), lay["cap"], lay["t"]
    jc = jkv.create_paged_cache(1, b, cap, hk, 128, page_size=page,
                                dtype="int8" if int8 else jnp.float32)
    tc = tkv.create_paged_cache(1, b, cap, hk, 128, page_size=page,
                                dtype=torch.int8 if int8 else torch.float32)
    perm = rng.permutation(b * (cap // page)).reshape(b, -1).astype(np.int32)
    jc = jc._replace(block_tables=jnp.asarray(perm))
    tc = tc._replace(block_tables=_t(perm))
    s = max(max(lay["page_lens"]), 1)
    k, v = (rng.normal(size=(b, s, hk, 128)).astype(np.float32)
            for _ in "kv")
    lens = np.asarray(lay["page_lens"], np.int32)
    jc = jkv.prefill_paged_cache(jc, 0, jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(lens))
    tc = tkv.prefill_paged_cache(tc, 0, _t(k), _t(v), _t(lens))
    rows = (rng.normal(size=(t, hk * g, 128)),
            *(rng.normal(size=(t, hk, 128)) for _ in "kv"))
    return jc, tc, tuple(x.astype(np.float32) for x in rows), lay


def _lens(lay):
    return [np.asarray(lay[k], np.int32)
            for k in ("page_lens", "q_start", "q_lens", "fresh_lens")]


def _poison(rows, lay):
    """NaN q, k and v in the second row of the chunk slot with old length
    2 page + 3 (the ``chunks`` wave's second slot)."""
    row = lay["q_start"][1] + 1
    for x in rows:
        x[row] = np.nan
    return row


@pytest.fixture(scope="module")
def ragged_case():
    """Per (g, wave, int8): the inputs and the JAX ragged kernel's output
    (Pallas in interpret mode; a spy checks that it ran). The ``chunks``
    wave carries a poisoned row."""
    done = {}

    def get(g, name, int8=False):
        if (g, name, int8) not in done:
            rng = np.random.default_rng(40 + g + (name == "walks"))
            jc, tc, rows, lay = _wave_case(rng, g, 16, name, int8=int8)
            poisoned = _poison(rows, lay) if name == "chunks" else None
            q, kf, vf = rows
            calls = []
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(jrpa, "_INTERPRET", True)
                real = jrpa._pallas_ragged
                mp.setattr(jrpa, "_pallas_ragged",
                           lambda *a, **kw: calls.append(1) or real(*a, **kw))
                ks, vs = jkv.layer_scales(jc, 0)
                j = jrpa.ragged_paged_attention_pure(
                    jnp.asarray(q), jc.k_pages[0], jc.v_pages[0],
                    jc.block_tables, *(jnp.asarray(x) for x in _lens(lay)),
                    jnp.asarray(kf), jnp.asarray(vf), k_scales=ks,
                    v_scales=vs)
            assert calls, "the Pallas ragged kernel did not run"
            done[(g, name, int8)] = (tc, rows, lay, poisoned, np.asarray(j))
        return done[(g, name, int8)]

    return get


def _split(tc, rows, lay, cs, drop_last=False):
    q, kf, vf = (_t(x) for x in rows)
    ks, vs = tkv.layer_scales(tc, 0)
    return _np(trpa.split_ragged_reference(
        q, tc.k_pages[0], tc.v_pages[0], tc.block_tables,
        *(_t(x) for x in _lens(lay)), trpa.zero_non_finite(kf),
        trpa.zero_non_finite(vf), k_scales=ks, v_scales=vs, cs=cs,
        drop_last=drop_last))


@pytest.mark.parametrize("g,name,cs,int8", _int8_cases(
    ("g", GROUPS, INT8_GROUPS), ("name", ("chunks", "walks"), ("chunks", "walks")),
    ("cs", CLUSTERS, INT8_CLUSTERS)))
def test_split_ragged_matches_jax_ragged_kernel(ragged_case, g, name, cs,
                                                int8):
    """K11's arithmetic (walks split over cs ranks, whole tiles) vs
    ``_pallas_ragged``: rows of no segment and a walk over nothing but its
    own cell as the kernel writes them; the poisoned row's NaNs stay in
    its own row. ``int8``: on an int8 cache."""
    tc, rows, lay, poisoned, j = ragged_case(g, name, int8)
    t = _split(tc, rows, lay, cs)
    keep = np.ones(len(t), bool)
    if poisoned is not None:
        assert not np.isfinite(t[poisoned]).all()
        keep[poisoned] = False
    assert np.isfinite(t[keep]).all()
    np.testing.assert_allclose(t[keep], j[keep], **TOL)
    assert not t[[s < 0 for s in lay["row_slot"]]].any()


@pytest.mark.parametrize("g,int8", _int8_cases(
    ("g", GROUPS, INT8_GROUPS)))
def test_split_ragged_without_its_last_range_fails(ragged_case, g, int8):
    """The fault control ``chip_smoke.py`` runs: the last range's partial
    left out moves every nonempty walk's row far past the tolerance, and
    no other row (``int8``: on an int8 cache)."""
    tc, rows, lay, _, j = ragged_case(g, "walks", int8)
    for cs in INT8_CLUSTERS if int8 else CLUSTERS:
        t = _split(tc, rows, lay, cs, drop_last=True)
        err = np.abs(t - j) - (TOL["atol"] + TOL["rtol"] * np.abs(j))
        for slot, (q, f, n) in enumerate(zip(
                lay["q_lens"], lay["fresh_lens"], lay["page_lens"])):
            start = lay["q_start"][slot]
            rows_ = slice(start, start + q)
            walk = q == 1 and f == 0
            assert (err[rows_].max(initial=-1) > 0) == (walk and n > 0), (
                cs, slot)


@pytest.fixture(scope="module")
def fused_case():
    """Per (g, int8): the ``chunks`` wave through the JAX fused ragged
    kernel (Pallas in interpret mode), the old lengths prefilled: output
    and cache."""
    done = {}

    def get(g, int8=False):
        if (g, int8) not in done:
            rng = np.random.default_rng(60 + g)
            lay = layout(edge_waves(g, 16)["chunks"])
            b, cap, t, hk = len(lay["seq"]), lay["cap"], lay["t"], 2
            jc = jkv.create_paged_cache(1, b, cap, hk, 128, page_size=16,
                                        dtype="int8" if int8 else jnp.float32)
            tc = tkv.create_paged_cache(
                1, b, cap, hk, 128, page_size=16,
                dtype=torch.int8 if int8 else torch.float32)
            s = max(lay["seq"])
            k, v = (rng.normal(size=(b, s, hk, 128)).astype(np.float32)
                    for _ in "kv")
            seq = np.asarray(lay["seq"], np.int32)
            jc = jkv.prefill_paged_cache(jc, 0, jnp.asarray(k),
                                         jnp.asarray(v), jnp.asarray(seq))
            tc = tkv.prefill_paged_cache(tc, 0, _t(k), _t(v), _t(seq))
            rows = (rng.normal(size=(t, hk * g, 128)),
                    *(rng.normal(size=(t, hk, 128)) for _ in "kv"),
                    *(rng.normal(size=(t, 128)) for _ in "cs"))
            rows = tuple(x.astype(np.float32) for x in rows)
            rs = np.asarray(lay["row_slot"], np.int32)
            wave = (rs, np.asarray(lay["row_pos"], np.int32), rs >= 0,
                    *_lens(lay))
            calls = []
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(jfra, "_INTERPRET", True)
                real = jfra._pallas_fused
                mp.setattr(jfra, "_pallas_fused",
                           lambda *a, **kw: calls.append(1) or real(*a, **kw))
                j_out, j_cache = jfra.fused_rope_append_attend(
                    *(jnp.asarray(x) for x in rows), jc, 0,
                    *(jnp.asarray(x) for x in wave))
            assert calls, "the Pallas fused kernel did not run"
            done[(g, int8)] = (tc, rows, wave, np.asarray(j_out), j_cache)
        return done[(g, int8)]

    return get


POOLS = ("k_pages", "v_pages", "k_scales", "v_scales")


def _pool_copy(tc):
    return tc._replace(**{n: getattr(tc, n).clone() for n in POOLS
                          if getattr(tc, n) is not None})


def _split_fused(tc, rows, wave, cs):
    """rope -> the ragged cache write -> the split walk: what K3's ragged
    form computes (on an int8 cache: each written cell quantized, every
    page cell read as code * scale, the chunks' own rows fresh)."""
    q, k, v, cos, sin = (_t(x) for x in rows)
    row_slot, row_pos, valid, *lens = (_t(x) for x in wave)
    q2, k2 = apply_rotary_rows(q, k, cos, sin)
    cache = tkv.append_tokens_ragged(_pool_copy(tc), 0, k2, v, row_slot,
                                     row_pos, valid)
    ks, vs = tkv.layer_scales(cache, 0)
    out = trpa.split_ragged_reference(
        q2, cache.k_pages[0], cache.v_pages[0], cache.block_tables, *lens,
        trpa.zero_non_finite(k2), trpa.zero_non_finite(v), k_scales=ks,
        v_scales=vs, cs=cs)
    return _np(out), cache


@pytest.mark.parametrize("g,cs,int8", _int8_cases(
    ("g", GROUPS, INT8_GROUPS), ("cs", CLUSTERS, INT8_CLUSTERS)))
def test_split_ragged_matches_jax_fused_ragged(fused_case, g, cs, int8):
    """K3's ragged form as the split walk computes it (rope, every segment
    row's cell written, the walk) vs ``_pallas_fused`` in its ragged use:
    outputs and the written cells (``int8``: codes within 1, the differing
    ones counted, scales within 1e-6 relative); the port's fused entry (the
    plain chain on CPU tensors) writes the same cells."""
    tc, rows, wave, j_out, j_cache = fused_case(g, int8)
    t_out, t_cache = _split_fused(tc, rows, wave, cs)
    np.testing.assert_allclose(t_out, j_out, **TOL)
    assert not t_out[~wave[2]].any()
    if int8:
        for name in ("k_pages", "v_pages"):
            dq = np.abs(_np(getattr(t_cache, name)).astype(np.int32)
                        - np.asarray(getattr(j_cache, name), np.int32))
            print(f"{name}: {int((dq > 0).sum())} codes differ")
            assert dq.max() <= 1, name
        for name in ("k_scales", "v_scales"):
            np.testing.assert_allclose(_np(getattr(t_cache, name)),
                                       np.asarray(getattr(j_cache, name)),
                                       rtol=1e-6, atol=0, err_msg=name)
    else:
        for name in ("k_pages", "v_pages"):
            np.testing.assert_allclose(_np(getattr(t_cache, name)),
                                       np.asarray(getattr(j_cache, name)),
                                       rtol=3e-6, atol=3e-6, err_msg=name)
    _, e_cache = tfra.fused_rope_append_attend(
        *(_t(x) for x in rows), _pool_copy(tc), 0, *(_t(x) for x in wave))
    for name in POOLS[:4 if int8 else 2]:
        assert torch.equal(getattr(e_cache, name), getattr(t_cache, name))
