"""Ragged paged attention for mixed prefill/decode waves
(``paddle_tpu/ops/pallas/ragged_paged_attention.py``).

Kernel K11 (``csrc/ragged_paged_attention.cu``) replaces the TPU kernel
``_pallas_ragged``. One wave of T query rows mixes chunked-prefill rows and
single-token decode rows; slot b owns the contiguous rows
``[q_start[b], q_start[b] + q_lens[b])`` and each of its rows attends, in
one softmax, to two sources:

  * the slot's page-resident context, positions < ``page_lens[b]``
    (a decode row: old context + its own just-appended cell; a prefill
    row: old context only);
  * the wave's own fresh K/V rows of the same slot, causal within the
    chunk: key offset <= row offset and < ``fresh_lens[b]``.

Rows outside every segment, and rows with no visible key, are exact
zeros. Layout: q_rows (T, H, D); k/v_pages (Hk, P, page, D);
block_tables (B, pps); page_lens/q_start/q_lens/fresh_lens (B,) int32;
k/v_fresh (T, Hk, D); on an int8 cache k/v_scales (Hk, P, page, 1).

On CPU tensors ``ragged_paged_attention_pure`` runs the plain version; on
CUDA tensors it launches K11 or raises (K11 reads bf16 pools only: an
int8 cache raises ``NotImplementedError``).
"""

from __future__ import annotations

import math

import torch

from . import _build

_NEG_INF = -1e30

#: K11 launches since the last reset (incremented only where it launches)
launches = 0


def _row_owners(t, q_start, q_lens):
    """(row_valid (T,), row_slot (T,), row_off (T,)) of a wave: the slot
    whose segment holds each row (slot 0 for rows of no segment)."""
    rows = torch.arange(t, device=q_start.device)[:, None]
    qs, ql = q_start.long()[None, :], q_lens.long()[None, :]
    in_slot = (rows >= qs) & (rows < qs + ql)                   # (T, B)
    row_valid = in_slot.any(dim=1)
    row_slot = torch.argmax(in_slot.int(), dim=1)
    row_off = torch.arange(t, device=q_start.device) - q_start.long()[
        row_slot]
    return row_valid, row_slot, row_off


def ragged_paged_attention_reference(q_rows, k_pages, v_pages, block_tables,
                                     page_lens, q_start, q_lens, fresh_lens,
                                     k_fresh, v_fresh, scale=None,
                                     k_scales=None, v_scales=None):
    """Dense lowering: per-row gather of the owning slot's pages and the
    fresh wave block, one masked f32 softmax over both sources (the JAX
    reference's op structure, so a decode row reduces in the order of
    ``paged_attention_reference``)."""
    hk, _, page, d = k_pages.shape
    t, h, _ = q_rows.shape
    g = h // hk
    scale = scale or (1.0 / math.sqrt(d))
    row_valid, row_slot, row_off = _row_owners(t, q_start, q_lens)
    plens = page_lens.long()[row_slot]
    fl = fresh_lens.long()[row_slot]

    bt_rows = block_tables.long()[row_slot]                     # (T, n)
    k_ctx = k_pages[:, bt_rows]                                 # (Hk,T,n,page,D)
    v_ctx = v_pages[:, bt_rows]
    if k_scales is not None:
        k_ctx = k_ctx.float() * k_scales[:, bt_rows]
        v_ctx = v_ctx.float() * v_scales[:, bt_rows]
    max_len = block_tables.shape[1] * page
    k_ctx = k_ctx.transpose(0, 1).reshape(t, hk, max_len, d).float()
    v_ctx = v_ctx.transpose(0, 1).reshape(t, hk, max_len, d).float()
    qg = q_rows.reshape(t, hk, g, d).float()
    s1 = torch.einsum("tkgd,tknd->tkgn", qg, k_ctx) * scale
    pos = torch.arange(max_len, device=q_rows.device)[None, None, None, :]
    s1 = torch.where(pos < plens[:, None, None, None], s1,
                     torch.full_like(s1, _NEG_INF))

    s2 = torch.einsum("tkgd,ukd->tkgu", qg, k_fresh.float()) * scale
    vis2 = ((row_slot[None, :] == row_slot[:, None])
            & row_valid[None, :]
            & (row_off[None, :] <= row_off[:, None])
            & (row_off[None, :] < fl[:, None])
            & (fl[:, None] > 0))                                # (T, T)
    s2 = torch.where(vis2[:, None, None, :], s2, torch.full_like(s2,
                                                                 _NEG_INF))
    p = torch.softmax(torch.cat([s1, s2], dim=-1), dim=-1)
    out = (torch.einsum("tkgn,tknd->tkgd", p[..., :max_len], v_ctx)
           + torch.einsum("tkgu,ukd->tkgd", p[..., max_len:],
                          v_fresh.float()))
    keep = (row_valid & ((plens > 0) | (fl > 0)))[:, None, None, None]
    out = torch.where(keep, out, torch.zeros_like(out))
    return out.reshape(t, h, d).to(q_rows.dtype)


def zero_non_finite(x):
    """Non-finite values of ``x`` replaced by 0: the fresh source is where
    rows of different slots meet in a value product, and a 0-weight times
    NaN is NaN, so a poisoned slot's fresh rows must not carry NaN into
    its neighbours' outputs (its own NaN queries keep it detected)."""
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


def ragged_paged_attention_pure(q_rows, k_pages, v_pages, block_tables,
                                page_lens, q_start, q_lens, fresh_lens,
                                k_fresh, v_fresh, scale=None,
                                k_scales=None, v_scales=None):
    """The plain version on CPU tensors (after zeroing non-finite fresh
    K/V), K11 on CUDA tensors (which zeroes them as it loads them)."""
    global launches
    hk, p_total, page, d = k_pages.shape
    scale = scale or (1.0 / math.sqrt(d))
    if not q_rows.is_cuda:
        return ragged_paged_attention_reference(
            q_rows, k_pages, v_pages, block_tables, page_lens, q_start,
            q_lens, fresh_lens, zero_non_finite(k_fresh),
            zero_non_finite(v_fresh), scale, k_scales=k_scales,
            v_scales=v_scales)
    if k_scales is not None:
        raise NotImplementedError(
            "the ragged_paged_attention kernel reads bf16 pools only; its "
            "int8 form is still to be ported (ROADMAP.md, Queue 1)")
    t, h, _ = q_rows.shape
    b, pps = block_tables.shape
    check_wave_shapes(q_rows, hk)
    bf, i32 = torch.bfloat16, torch.int32
    _build.check_cuda("q_rows", q_rows, bf)
    _build.check_cuda("k_pages", k_pages, bf)
    _build.check_cuda("v_pages", v_pages, bf, k_pages.shape)
    _build.check_cuda("block_tables", block_tables, i32)
    for name, x in (("page_lens", page_lens), ("q_start", q_start),
                    ("q_lens", q_lens), ("fresh_lens", fresh_lens)):
        _build.check_cuda(name, x, i32, (b,))
    _build.check_cuda("k_fresh", k_fresh, bf, (t, hk, d))
    _build.check_cuda("v_fresh", v_fresh, bf, (t, hk, d))
    out = torch.zeros_like(q_rows)       # rows of no segment stay zero
    _build.launch("pt_ragged_paged_attention", q_rows.data_ptr(),
                  k_pages.data_ptr(), v_pages.data_ptr(),
                  block_tables.data_ptr(), page_lens.data_ptr(),
                  q_start.data_ptr(), q_lens.data_ptr(),
                  fresh_lens.data_ptr(), k_fresh.data_ptr(),
                  v_fresh.data_ptr(), out.data_ptr(), t, b, h, hk, p_total,
                  page, pps, scale, _build.stream_of(q_rows))
    launches += 1
    return out


def check_wave_shapes(q_rows, hk):
    """The ragged kernels' shape rule: head_dim 128 and a GQA group that
    divides 32 (one block holds 32 query rows: 32 / g wave rows)."""
    _, h, d = q_rows.shape
    g = h // hk if h % hk == 0 else 0
    if d != 128 or g not in (1, 2, 4, 8):
        raise ValueError(f"the ragged attention kernels need head_dim 128 "
                         f"and 1, 2, 4 or 8 query heads per kv head, got q "
                         f"{tuple(q_rows.shape)} with {hk} kv heads")
