"""The quantized tiled body's persistent walk, modelled in Python, against brute force (CPU).

``quant_matmul.quant_tiles`` gives the order in which the blocks of the
tiled weight-only product (K4, and K2's int8/int4 forms, with M > 16:
``csrc/wgmma_quant_tiles.cuh``) take their output tiles, and
``quant_matmul.block_n`` the tiles' width; the card test
``test_quant_tiles_on_the_card_match_the_model`` holds the kernel's own
decoding to them. Here, at the prefill and train shapes, at M, N and K off
the tiles, and at grids smaller than the 132 SMs:

  * every element of y lies in exactly one tile of the walk;
  * the tiles come band after band of ``_band(K)`` row tiles, the row
    tiles of a band fastest, then the column tiles;
  * the persistent blocks take every tile once, min(tiles, SMs) blocks.

``quant_matmul.small_plan`` and ``small_items`` do the same for the
small-M body (M <= 16: ``csrc/skinny_tiles.cuh``): the cluster size and
CTAs of its one rule, and the (output tile, cluster rank) items its CTAs
decode; the card test ``test_small_items_on_the_card_match_the_model``
holds the kernel to them. Here, at the decode widths of K2 and K4, at N
off the 64-wide tile and at K of one and of a few slices, for M = 1, 8
and 16 and per-channel and group-wise (64, 128) scales:

  * every (tile, rank) is one item, and a tile's ranks cover its K once,
    in rank order;
  * every K range is whole 128-row slices and whole scale groups;
  * CTA b is rank b % cs of cluster b // cs, which takes tiles b // cs,
    b // cs + grid / cs, ...;
  * the cluster is the least that covers 7/8 of the SMs, and the grid
    turns persistent (cs 1, two CTAs an SM) only past two CTAs an SM;
  * the grid covers 7/8 of the SMs at every main-path width.
"""

from __future__ import annotations

import collections

import numpy as np
import pytest

from paddle_tpu_torch.ops.kernels import grouped_matmul as gm
from paddle_tpu_torch.ops.kernels import quant_matmul as qm

#: (M, K, N): one row, a row tile and one row, M/N/K off the tiles, the
#: Llama-3-8B prefill shapes (q, k/v, gate/up, o_proj, down_proj), the
#: train step's gate/up, and a K large enough for a band of one row tile
_SHAPES = [(17, 128, 16), (129, 384, 272), (300, 1152, 784),
           (1024, 4096, 4096), (1024, 4096, 1024), (1024, 4096, 14336),
           (1024, 14336, 4096), (8192, 4096, 14336), (640, 131072, 512)]
_WIDTHS = [128, 256]
_CHECKS = ["each element once", "band order", "blocks take each tile once"]


def _band_order(m, kdim, n, bn):
    """The walk by its definition: band after band, a band's row tiles
    fastest."""
    n_mt, n_nt, band = -(-m // qm.TILE_M), -(-n // bn), gm._band(kdim)
    return [(mt, nt) for first in range(0, n_mt, band) for nt in range(n_nt)
            for mt in range(first, min(first + band, n_mt))]


@pytest.mark.parametrize("sms", [gm.H100_SMS, 7])
@pytest.mark.parametrize("bn", _WIDTHS)
@pytest.mark.parametrize("m,kdim,n", _SHAPES)
@pytest.mark.parametrize("check", _CHECKS)
def test_quant_tile_walk(check, m, kdim, n, bn, sms):
    tiles = qm.quant_tiles(m, kdim, n, bn)
    n_mt, n_nt = -(-m // qm.TILE_M), -(-n // bn)
    assert len(tiles) == n_mt * n_nt
    if check == "each element once":
        if m * n <= 1 << 22:
            cover = np.zeros((m, n), dtype=np.int32)
            for mt, nt in tiles:
                cover[mt * qm.TILE_M:(mt + 1) * qm.TILE_M,
                      nt * bn:(nt + 1) * bn] += 1
            assert (cover == 1).all()
        assert sorted(tiles) == [(mt, nt) for mt in range(n_mt)
                                 for nt in range(n_nt)]
    elif check == "band order":
        assert tiles == _band_order(m, kdim, n, bn)
    else:
        blocks = gm.persistent_blocks(len(tiles), sms)
        assert len(blocks) == min(len(tiles), sms)
        taken = sorted(i for b in blocks for i in b)
        assert taken == list(range(len(tiles)))
        for b, items in enumerate(blocks):
            assert items == list(range(b, len(tiles), len(blocks)))


@pytest.mark.parametrize("m,n,gs,fused_norm,want", [
    (1024, 14336, -1, True, 256),    # K2 gate/up: 448 tiles of 256
    (1024, 4096, -1, True, 256),     # K2 q, K4 o_proj: 128 tiles
    (1024, 4096, -1, False, 256),
    (1024, 1024, -1, True, 128),     # K2 k/v: 32 tiles of 256 -> 64 of 128
    (1024, 4096, 128, False, 128),   # K4 group-wise: always 128
    (1024, 4096, 64, True, 256),     # K2 group-wise scales in its B tile
    (8448, 256, -1, True, 128),      # 66 tiles of 256: half the SMs
    (8449, 256, -1, True, 256),      # 67 tiles of 256
    (17, 784, -1, False, 128)])
def test_quant_block_n_fills_the_card(m, n, gs, fused_norm, want):
    assert qm.block_n(m, n, gs, fused_norm) == want


# ---- the small-M body (M <= 16: csrc/skinny_tiles.cuh) ----------------------

#: (K, N): the decode step's K2 widths (k/v, q, gate/up, the LM head) and
#: K4's o_proj and down_proj, N off the 64-wide tile (8, 40, 1000), K of
#: one slice and of a few
_SMALL_SHAPES = [(4096, 1024), (4096, 4096), (4096, 14336), (4096, 128256),
                 (14336, 4096), (128, 8), (128, 40), (4096, 1000),
                 (384, 40), (1152, 1000)]
#: the main paths' widths, whose grids must cover the card
_SMALL_MAIN = {(4096, 1024), (4096, 4096), (4096, 14336), (4096, 128256),
               (14336, 4096)}
_SMALL_CHECKS = ["each tile's K once", "whole slices and groups",
                 "walk order", "the least cluster", "covers the SMs"]


@pytest.mark.parametrize("gs", [-1, 64, 128])
@pytest.mark.parametrize("m", [1, 8, 16])
@pytest.mark.parametrize("kdim,n", _SMALL_SHAPES)
@pytest.mark.parametrize("check", _SMALL_CHECKS)
def test_small_walk(check, kdim, n, m, gs):
    """The small-M body's plan and walk (``small_plan``, ``small_items``),
    by their definitions: one rule for every M <= 16 and scale form."""
    assert 1 <= m <= qm.SMALL_MAX_M
    cs, grid = qm.small_plan(kdim, n)
    rows = qm.small_items(kdim, n)
    tiles, slices = -(-n // qm.SMALL_BN), kdim // qm.SMALL_BK
    assert len(rows) == tiles * cs and None not in rows
    assert cs in (1, 2, 4, 8) and cs <= slices and grid % cs == 0
    if check == "each tile's K once":
        # each (tile, rank) once, and a tile's ranks cover K once, in order
        assert sorted((r[0], r[1]) for r in rows) == sorted(set(
            (r[0], r[1]) for r in rows))
        for tile in range(tiles):
            cover = np.zeros(slices, dtype=np.int32)
            ranges = [rows[tile * cs + rank][2:] for rank in range(cs)]
            for lo, hi in ranges:
                assert lo < hi
                cover[lo:hi] += 1
            assert (cover == 1).all()
            assert [lo for lo, _ in ranges] == sorted(lo for lo, _ in ranges)
    elif check == "whole slices and groups":
        for _, _, lo, hi in rows:
            assert 0 <= lo < hi <= slices
            if gs > 0:
                assert (lo * qm.SMALL_BK) % gs == 0
                assert (hi * qm.SMALL_BK) % gs == 0
    elif check == "walk order":
        # CTA b: cluster b // cs, rank b % cs, tiles b // cs + j * grid / cs
        for tile in range(tiles):
            for rank in range(cs):
                b, step, lo, hi = rows[tile * cs + rank]
                assert b % cs == rank and b < grid
                assert tile == b // cs + step * (grid // cs)
                assert (lo, hi) == (slices * rank // cs,
                                    slices * (rank + 1) // cs)
    elif check == "the least cluster":
        if cs > 1:  # half the cluster would not cover 7/8 of the SMs
            assert 8 * tiles * (cs // 2) < 7 * gm.H100_SMS
        if cs < 8 and 2 * cs <= slices:
            assert 8 * tiles * cs >= 7 * gm.H100_SMS
        if grid < tiles * cs:  # persistent: cs 1, two CTAs an SM, each
            # taking ceil(T / grid) tiles or one fewer
            assert cs == 1 and grid == 2 * gm.H100_SMS
            taken = collections.Counter(r[0] for r in rows)
            assert len(taken) == grid
            assert max(taken.values()) == -(-tiles // grid)
            assert min(taken.values()) == tiles // grid
    else:
        assert grid <= 2 * gm.H100_SMS
        if (kdim, n) in _SMALL_MAIN:
            assert 8 * grid >= 7 * gm.H100_SMS
