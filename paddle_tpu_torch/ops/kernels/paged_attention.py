"""Paged decode attention (``paddle_tpu/ops/pallas/paged_attention.py``).

Only the plain version, which the plain rope -> append -> attend chain
(``fused_rope_attend.decode_reference``) uses. The TPU kernel
``_pallas_paged`` runs only with the ``rope_append_attend`` fusion off and
is ported in a later slice.

Layout: q (B, H, D); k/v_pages (Hk, P, page, D); block_tables (B, pps)
int32; seq_lens (B,) int32; on an int8 cache k/v_scales (Hk, P, page, 1).
"""

from __future__ import annotations

import math

import torch

_NEG_INF = -1e30


def paged_attention_reference(q, k_pages, v_pages, block_tables, seq_lens,
                              scale=None, k_scales=None, v_scales=None):
    """Gather pages densely, masked f32 softmax. seq_lens == 0 returns
    exact zeros. With ``k_scales``/``v_scales`` the pages hold int8 codes,
    dequantized per cell (code * scale in f32) after the gather."""
    hk, _, page, d = k_pages.shape
    b, h, _ = q.shape
    g = h // hk
    scale = scale or (1.0 / math.sqrt(d))
    bt = block_tables.long()
    k = k_pages[:, bt]                    # (Hk, B, pps, page, D)
    v = v_pages[:, bt]
    if k_scales is not None:
        k = k.float() * k_scales[:, bt]
        v = v.float() * v_scales[:, bt]
    max_len = bt.shape[1] * page
    k = k.transpose(0, 1).reshape(b, hk, max_len, d).float()
    v = v.transpose(0, 1).reshape(b, hk, max_len, d).float()
    qg = q.reshape(b, hk, g, d).float()
    s = torch.einsum("bkgd,bknd->bkgn", qg, k) * scale
    pos = torch.arange(max_len, device=q.device)[None, None, None, :]
    lens = seq_lens.long()[:, None, None, None]
    s = torch.where(pos < lens, s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgn,bknd->bkgd", p, v)
    out = torch.where(lens > 0, out, torch.zeros_like(out))
    return out.reshape(b, h, d).to(q.dtype)
