"""K13's and K14's persistent walks, modelled in Python, against brute force (CPU).

``grouped_matmul.gmm_items``, ``sdw_items``, ``sdw_slices`` and
``persistent_blocks`` give the order in which the blocks of the two
kernels' persistent grids take their work items and the rows each item
reads (``csrc/grouped_matmul.cu``, ``csrc/segment_dw.cu``; the card
tests hold the kernels' own decoding to these functions). Here, over many
group offsets — empty first, middle and last groups, T = 1, boundaries on
and off 64 and 128, one group holding every row, random splits — and
grids smaller than the 132 SMs:

  * K13: every (row, column) of y is written by exactly one item, and by
    an item of the row's own group; items of parked steps run no slice;
  * K14: every (group, k-tile, n-tile) output tile is one item, the
    groups come longest first, and the rows an item sums are exactly its
    group's (the last slice's rows past the group are the masked ones);
    an empty group's items run no slice;
  * every item goes to exactly one block, min(items, SMs) blocks in all;
  * K13's group-wise int8/int4 forms (128-column tiles) write every
    output once, as its 256-column forms do.
"""

from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels import grouped_matmul as gm

#: group sizes: empty first / middle / last groups, T = 1, boundaries on
#: and off 64 and 128, one group holding every row, a group of one row
_SIZES = [(1,), (0, 1, 0), (37, 0, 200, 91), (0, 300, 5, 0),
          (0, 0, 513, 0), (128, 128, 129, 127), (64, 64, 0, 192),
          (63, 65, 1, 4915), (256,), (0, 0, 0, 7), (7, 0, 0, 0),
          (1, 1, 1, 1, 1, 1, 1, 1)]
#: seeded random splits of a few hundred rows over 2 to 9 groups
_RNG = np.random.default_rng(0)
_SIZES += [tuple(int(v) for v in _RNG.multinomial(
    int(_RNG.integers(1, 700)), _RNG.dirichlet(np.full(e, 0.6))))
           for e in (2, 3, 5, 8, 9) for _ in range(2)]
#: 64 experts, a third of them empty and many of equal size
_SIZES.append(tuple(0 if i % 3 == 0 else (i * 37) % 5 * 16 + i % 7
                    for i in range(64)))
#: (K, N): a narrow K off the 64-row slice, N off the 256-column tile,
#: both operand shapes of the Mixtral layer (their bands differ)
_SHAPES = [(72, 200), (128, 136), (4096, 520), (14336, 4096)]


def _offsets(sizes):
    return [0, *itertools.accumulate(sizes)]


def _group_of_rows(off):
    """Each row's group, by brute force over the offsets."""
    t = off[-1]
    grp = np.full(t, -1)
    for g in range(len(off) - 1):
        grp[off[g]:off[g + 1]] = g
    assert (grp >= 0).all()
    return grp


@pytest.mark.parametrize("kdim,n", _SHAPES)
@pytest.mark.parametrize("sizes", _SIZES)
def test_gmm_items_write_every_output_once_by_its_group(sizes, kdim, n):
    off = _offsets(sizes)
    t, e = off[-1], len(sizes)
    n_tiles, n_nt = -(-t // gm.TILE_M), -(-n // gm.TILE_N)
    items = gm.gmm_items(off, t, kdim, n)
    assert len(items) == (n_tiles + e - 1) * n_nt
    grp = _group_of_rows(off)
    written = np.zeros((t, n_nt), dtype=np.int64)
    live = 0
    for tile, g, lo, hi, nt, slices in items:
        assert 0 <= nt < n_nt and 0 <= tile < n_tiles
        if hi <= lo:                                  # a parked step
            assert slices == 0
            continue
        live += 1
        assert slices == -(-kdim // gm.SLICE)
        assert tile * gm.TILE_M <= lo < hi <= (tile + 1) * gm.TILE_M
        assert (grp[lo:hi] == g).all(), "rows of another group"
        written[lo:hi, nt] += 1
    assert (written == 1).all(), "an output written twice or never"
    # one live step per (tile, group) the rows meet, per n-tile
    meets = {(r // gm.TILE_M, grp[r]) for r in range(t)}
    assert live == len(meets) * n_nt


@pytest.mark.parametrize("kdim,n", _SHAPES)
@pytest.mark.parametrize("sizes", _SIZES)
def test_gmm_items_at_the_group_wise_tile_width(sizes, kdim, n):
    """K13's group-wise int8/int4 forms walk 128-column tiles
    (``quant_tile_n``): every (row, column tile) written once, by an item
    of the row's group, in the same banded step order."""
    off = _offsets(sizes)
    t, e = off[-1], len(sizes)
    tile_n = gm.quant_tile_n(64)
    assert (tile_n, gm.quant_tile_n(-1)) == (128, gm.TILE_N)
    n_tiles, n_nt = -(-t // gm.TILE_M), -(-n // tile_n)
    items = gm.gmm_items(off, t, kdim, n, tile_n)
    assert len(items) == (n_tiles + e - 1) * n_nt
    grp = _group_of_rows(off)
    written = np.zeros((t, n_nt), dtype=np.int64)
    for tile, g, lo, hi, nt, slices in items:
        assert 0 <= nt < n_nt
        if hi > lo:
            assert (grp[lo:hi] == g).all()
            written[lo:hi, nt] += 1
        else:
            assert slices == 0
    assert (written == 1).all()
    # the same (tile, group, lo, hi) steps as at 256 columns
    wide = gm.gmm_items(off, t, kdim, n)
    assert sorted({it[:4] for it in items}) == sorted({it[:4] for it in wide})


@pytest.mark.parametrize("kdim,n", _SHAPES)
@pytest.mark.parametrize("sizes", _SIZES)
def test_sdw_items_sum_exactly_their_group_rows(sizes, kdim, n):
    off = _offsets(sizes)
    t, e = off[-1], len(sizes)
    n_mt, n_nt = -(-kdim // gm.TILE_M), -(-n // gm.TILE_N)
    items = gm.sdw_items(off, t, kdim, n)
    assert sorted((g, mt, nt) for g, mt, nt, *_ in items) == [
        (g, mt, nt) for g in range(e) for mt in range(n_mt)
        for nt in range(n_nt)]
    slices = [it[5] for it in items]
    assert slices == sorted(slices, reverse=True), "not longest first"
    grp = _group_of_rows(off)
    for g, _, _, lo, hi, n_k in items:
        assert (lo, hi) == (off[g], off[g + 1])
        walk = gm.sdw_slices(lo, hi)
        assert len(walk) == n_k == -(-sizes[g] // gm.SLICE)
        summed = [r for r0, kept in walk for r in range(r0, r0 + kept)]
        assert summed == list(range(off[g], off[g + 1]))
        assert all((grp[r0:r0 + kept] == g).all() for r0, kept in walk)
        for r0, kept in walk[:-1]:
            assert kept == gm.SLICE and r0 + gm.SLICE <= hi
        if walk:                          # the last slice's masked rows
            r0, kept = walk[-1]
            masked = range(r0 + kept, r0 + gm.SLICE)
            assert all(r >= hi for r in masked)
            assert all(r >= t or grp[r] != g for r in masked)


def test_sdw_items_rank_ties_by_group_index():
    items = gm.sdw_items([0, 64, 64, 128, 200], 200, 128, 256)
    assert [it[0] for it in items] == [3, 0, 2, 1]


@pytest.mark.parametrize("sms", [1, 7, 132])
@pytest.mark.parametrize("n_items", [1, 5, 131, 132, 133, 2160])
def test_persistent_blocks_take_every_item_once(n_items, sms):
    blocks = gm.persistent_blocks(n_items, sms)
    assert len(blocks) == min(n_items, sms)
    assert sorted(itertools.chain(*blocks)) == list(range(n_items))
    for b, got in enumerate(blocks):
        assert got == list(range(b, n_items, len(blocks)))


def test_gmm_items_follow_group_tile_walk_in_bands():
    """The banded order: ``band`` steps walk fastest, then the n-tiles."""
    off = [0, 100, 100, 900, 1000]
    items = gm.gmm_items(off, 1000, 14336, 4096)
    band = gm._band(14336)
    assert band == 4
    walk = [v.tolist() for v in gm.group_tile_walk(
        torch.tensor(off, dtype=torch.int32), gm.TILE_M, 8, 4)]
    first = items[:band * 16]
    assert [it[4] for it in first[:band]] == [0] * band
    assert [(it[0], it[1]) for it in first[:band]] == [
        (walk[0][s], walk[1][s]) for s in range(band)]
    assert [it[4] for it in first[band:2 * band]] == [1] * band
