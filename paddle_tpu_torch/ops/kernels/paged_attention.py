"""Paged decode attention (``paddle_tpu/ops/pallas/paged_attention.py``).

Kernel K10 (``csrc/paged_attention.cu``) replaces the TPU kernel
``_pallas_paged``: one query row per slot over the slot's first
``seq_lens[b]`` cells, found through its block table. It runs in the
unfused decode chain (``fused_rope_attend.decode_reference``), which the
segment steps of the continuous batcher take with the
``rope_append_attend`` fusion off.

Layout: q (B, H, D); k/v_pages (Hk, P, page, D); block_tables (B, pps)
int32; seq_lens (B,) int32; on an int8 cache k/v_scales (Hk, P, page, 1).

On CPU tensors ``paged_attention_pure`` runs the plain version; on CUDA
tensors it launches K10 or raises (K10 reads bf16 pools only: an int8
cache raises ``NotImplementedError``).
"""

from __future__ import annotations

import math

import torch

from . import _build

_NEG_INF = -1e30

#: K10 launches since the last reset (incremented only where it launches)
launches = 0


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


def paged_attention_pure(q, k_pages, v_pages, block_tables, seq_lens,
                         scale=None, k_scales=None, v_scales=None):
    """The plain version on CPU tensors, K10 on CUDA tensors."""
    global launches
    if not q.is_cuda:
        return paged_attention_reference(q, k_pages, v_pages, block_tables,
                                         seq_lens, scale, k_scales=k_scales,
                                         v_scales=v_scales)
    if k_scales is not None:
        raise NotImplementedError(
            "the paged_attention kernel reads bf16 pools only; its int8 "
            "form is still to be ported (ROADMAP.md, Queue 1)")
    b, h, d = q.shape
    hk, p_total, page, _ = k_pages.shape
    pps = block_tables.shape[1]
    if d != 128 or h % hk or h // hk > 8:
        raise ValueError(f"paged_attention kernel needs head_dim 128 and at "
                         f"most 8 query heads per kv head, got q "
                         f"{tuple(q.shape)} with {hk} kv heads")
    bf = torch.bfloat16
    _build.check_cuda("q", q, bf)
    _build.check_cuda("k_pages", k_pages, bf)
    _build.check_cuda("v_pages", v_pages, bf, k_pages.shape)
    _build.check_cuda("block_tables", block_tables, torch.int32, (b, pps))
    _build.check_cuda("seq_lens", seq_lens, torch.int32, (b,))
    out = torch.empty_like(q)
    _build.launch("pt_paged_attention", q.data_ptr(), k_pages.data_ptr(),
                  v_pages.data_ptr(), block_tables.data_ptr(),
                  seq_lens.data_ptr(), out.data_ptr(), b, h, hk, p_total,
                  page, pps, scale or 1.0 / math.sqrt(d), _build.stream_of(q))
    launches += 1
    return out
