"""Paged decode attention (``paddle_tpu/ops/pallas/paged_attention.py``).

Kernel K10 (``csrc/paged_attention.cu``) replaces the TPU kernel
``_pallas_paged``: one query row per slot over the slot's first
``seq_lens[b]`` cells, found through its block table. It runs in the
unfused decode chain (``fused_rope_attend.decode_reference``), which the
segment steps of the continuous batcher take with the
``rope_append_attend`` fusion off. K10 and K3's decode form share one page
walk (``csrc/paged_walk.cuh``): each (kv head, slot) walk split in whole
pages across a thread-block cluster of ``walk_plan``'s size, the pages
brought in by bulk copies and scored on the tensor cores, the ranks'
partial softmax states merged in rank order. ``walk_plan`` and
``walk_items`` model its grid and ranges; ``split_walk_reference`` is a
plain model of the split and its rank-order merge (tests and
``chip_smoke.py`` use them; the port's paths never call them).

Layout: q (B, H, D); k/v_pages (Hk, P, page, D); block_tables (B, pps)
int32; seq_lens (B,) int32; on an int8 cache k/v_scales (Hk, P, page, 1).

On CPU tensors ``paged_attention_pure`` runs the plain version; on CUDA
tensors it launches K10 or raises: bf16 pools, or an int8 cache's codes
with its per-cell f32 scales (page % 4 == 0, ``check_scale_pools``), each
cell read as code * scale. A q that requires grad raises with grad
enabled (the launch is invisible to autograd).
"""

from __future__ import annotations

import math

import torch

from . import _build
from .grouped_matmul import H100_SMS

_NEG_INF = -1e30

#: the walk's largest cluster (``csrc/paged_walk.cuh`` MAX_CS)
WALK_MAX_CS = 8

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


def walk_plan(b, hk, pps, sms=H100_SMS):
    """The page walk's grid (``cluster_size`` in ``csrc/paged_walk.cuh``),
    one rule for K10 and every decode form of K3: (cluster size, CTAs).
    The least power of two cs (at most 8, and at most ``pps``, the pages a
    slot can hold) whose B x Hk x cs CTAs cover the SMs; the grid is
    (Hk x cs, B), one cluster per (kv head, slot)."""
    cs = 1
    while cs < WALK_MAX_CS and 2 * cs <= pps and b * hk * cs < sms:
        cs *= 2
    return cs, b * hk * cs


def walk_range(n, page, pps, rank, cs):
    """Rank ``rank`` of ``cs``'s pages [lo, hi) of a walk over n cells
    (``range_of``): the contiguous whole pages np r / cs .. np (r + 1) / cs
    of the np = min(ceil(n / page), pps) pages the walk needs."""
    np_ = min(-(-n // page), pps)
    return np_ * rank // cs, np_ * (rank + 1) // cs


def walk_items(lens, hk, pps, page, sms=H100_SMS):
    """The walk as its CTAs decode it (``items_kernel``) for walks over
    ``lens`` (one length a slot): row (b * Hk + kh) * cs + rank is (rank,
    first page, end page)."""
    cs, _ = walk_plan(len(lens), hk, pps, sms)
    return [(rank, *walk_range(int(n), page, pps, rank, cs))
            for n in lens for _ in range(hk) for rank in range(cs)]


def split_walk_reference(q, k_pages, v_pages, block_tables, seq_lens,
                         scale=None, k_scales=None, v_scales=None, cs=1,
                         drop_last=False):
    """A plain model of the split walk, in f32: for each slot, rank r of
    ``cs`` runs an online softmax over its pages (``walk_range``), one max
    and one rescale a page (the kernel takes them a chunk of pages at a
    time: the same function, rounded elsewhere); the ranks' partial
    (m, l, acc) merge in rank order; out = acc / max(l, 1e-30) (zeros for
    length 0). ``drop_last`` leaves the last range's partial out: a fault
    the attention checks must catch. Never called by the port's paths."""
    hk, _, page, d = k_pages.shape
    b, h, _ = q.shape
    g = h // hk
    pps = block_tables.shape[1]
    scale = scale or (1.0 / math.sqrt(d))
    qg = q.reshape(b, hk, g, d).float() * scale
    out = torch.zeros((b, hk, g, d), dtype=torch.float32, device=q.device)
    for bi in range(b):
        n = int(seq_lens[bi])
        parts = []
        for rank in range(cs):
            m = torch.full((hk, g), _NEG_INF, device=q.device)
            l = torch.zeros((hk, g), device=q.device)
            acc = torch.zeros((hk, g, d), device=q.device)
            for pg in range(*walk_range(n, page, pps, rank, cs)):
                cnt = min(page, n - pg * page)
                phys = int(block_tables[bi, pg])
                k = k_pages[:, phys, :cnt].float()
                v = v_pages[:, phys, :cnt].float()
                if k_scales is not None:
                    k = k * k_scales[:, phys, :cnt]
                    v = v * v_scales[:, phys, :cnt]
                s = torch.einsum("kgd,knd->kgn", qg[bi], k)
                m_new = torch.maximum(m, s.amax(-1))
                corr = torch.exp(m - m_new)
                p = torch.exp(s - m_new[..., None])
                l = l * corr + p.sum(-1)
                acc = acc * corr[..., None] + torch.einsum("kgn,knd->kgd", p, v)
                m = m_new
            parts.append((m, l, acc))
        if drop_last:
            parts = parts[:-1]
        if not parts:
            continue
        mt = torch.stack([pm for pm, _, _ in parts]).amax(0)
        lt = sum(pl * torch.exp(pm - mt) for pm, pl, _ in parts)
        at = sum(pa * torch.exp(pm - mt)[..., None] for pm, _, pa in parts)
        out[bi] = at / lt.clamp_min(1e-30)[..., None]
    return out.reshape(b, h, d).to(q.dtype)


def check_scale_pools(k_pages, k_scales, v_scales):
    """An int8 cache's scale pools as the walk bodies copy them: f32, one
    scale a cell ((..., page, 1) beside (..., page, D) codes), contiguous,
    and a page's scales a whole number of 16-byte pieces (page % 4 == 0)."""
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales come together")
    page = k_pages.shape[-2]
    if page % 4:
        raise ValueError(f"the attention kernels copy a page's int8 scales "
                         f"in 16-byte units: page {page} is not a multiple "
                         f"of 4")
    shape = k_pages.shape[:-1] + (1,)
    _build.check_cuda("k_scales", k_scales, torch.float32, shape)
    _build.check_cuda("v_scales", v_scales, torch.float32, shape)


def paged_attention_pure(q, k_pages, v_pages, block_tables, seq_lens,
                         scale=None, k_scales=None, v_scales=None):
    """The plain version on CPU tensors, K10 on CUDA tensors (its int8
    form with ``k_scales``/``v_scales``)."""
    global launches
    if not q.is_cuda:
        return paged_attention_reference(q, k_pages, v_pages, block_tables,
                                         seq_lens, scale, k_scales=k_scales,
                                         v_scales=v_scales)
    b, h, d = q.shape
    hk, p_total, page, _ = k_pages.shape
    pps = block_tables.shape[1]
    if d != 128 or h % hk or h // hk > 8:
        raise ValueError(f"paged_attention kernel needs head_dim 128 and at "
                         f"most 8 query heads per kv head, got q "
                         f"{tuple(q.shape)} with {hk} kv heads")
    quant = k_scales is not None or v_scales is not None
    bf = torch.bfloat16
    pool = torch.int8 if quant else bf
    _build.check_cuda("q", q, bf)
    _build.check_cuda("k_pages", k_pages, pool)
    _build.check_cuda("v_pages", v_pages, pool, k_pages.shape)
    if quant:
        check_scale_pools(k_pages, k_scales, v_scales)
    _build.check_cuda("block_tables", block_tables, torch.int32, (b, pps))
    _build.check_cuda("seq_lens", seq_lens, torch.int32, (b,))
    _build.check_no_grad("paged_attention", q, k_pages, v_pages)
    out = torch.empty_like(q)
    head = (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr())
    tail = (block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(), b,
            h, hk, p_total, page, pps, scale or 1.0 / math.sqrt(d),
            _build.stream_of(q))
    if quant:
        _build.launch("pt_paged_attention_int8", *head, k_scales.data_ptr(),
                      v_scales.data_ptr(), *tail)
    else:
        _build.launch("pt_paged_attention", *head, *tail)
    launches += 1
    return out
