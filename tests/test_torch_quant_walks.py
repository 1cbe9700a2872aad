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
"""

from __future__ import annotations

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
