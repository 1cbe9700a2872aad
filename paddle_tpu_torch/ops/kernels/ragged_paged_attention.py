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
CUDA tensors it launches K11 or raises: bf16 pools, or an int8 cache's
codes with its per-cell f32 scales (page % 4 == 0), each page cell read
as code * scale while the fresh rows stay bf16. A q that requires grad
raises with grad enabled (the launch is invisible to autograd).

``fresh_pool_read`` (B,) bool marks slots whose fresh K/V are read through
the pool's representation (speculative verify segments,
``inference/speculative.py``): on an int8 cache each such row becomes the
codes and scale it would have in the pool (``kv_cache.quantize_cells``),
read as code * scale; on a float cache it is cast to the pool dtype, which
for bf16 rows on a bf16 pool changes no bit. The TPU kernel takes the
roundtripped rows as an f32 fresh source, which the JAX package's
``fused_rope_attend._pool_roundtrip`` builds in plain ops. K11 takes the
flag instead and quantizes the flagged rows itself, in shared memory, as
its cell writer does: its fresh source is bf16 on the tensor cores, which
no f32 operand feeds exactly, and plain ops on the card would do a
kernel's work. The plain version applies the roundtrip in plain ops
before its softmax (after zeroing non-finite values, the kernel's order).

K11 and K3's ragged form share one body (``csrc/ragged_walk.cuh``): a grid
that depends on shapes only, whose CTAs decode their work on the device —
a walk item for each decode row (a slot with q_lens 1 and fresh_lens 0),
its page walk split in whole pages across a thread-block cluster and
merged in rank order, and tile items of ``RAGGED_ROWS`` MMA rows for every
other slot's rows. ``ragged_plan`` and ``ragged_items`` model its grid and
items; ``split_ragged_reference`` is a plain model of its arithmetic
(tests and ``chip_smoke.py`` use them; the port's paths never call them).
"""

from __future__ import annotations

import math

import torch

from . import _build
from .grouped_matmul import H100_SMS
from .paged_attention import check_scale_pools, walk_plan, walk_range

_NEG_INF = -1e30

#: a tile item's MMA rows (``csrc/ragged_walk.cuh`` ROWS): 64 / g wave
#: rows times the g query heads of one kv head
RAGGED_ROWS = 64
#: the kinds of a ragged CTA's item (``ragged_items``' first field)
RAGGED_EMPTY, RAGGED_WALK, RAGGED_TILE = 0, 1, 2

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


def pool_roundtrip(rows, quantized, pool_dtype):
    """Fresh rows as a page read would give them back, in f32: codes *
    scale of ``kv_cache.quantize_cells`` on an int8 pool, the pool-dtype
    cast on a float pool (the JAX package's ``_pool_roundtrip``)."""
    r32 = rows.float()
    if quantized:
        from ...models.kv_cache import quantize_cells

        codes, scales = quantize_cells(r32)
        return codes.float() * scales
    return r32.to(pool_dtype).float()


def fresh_through_pool(k_fresh, v_fresh, fresh_pool_read, q_start, q_lens,
                       quantized, pool_dtype):
    """The fresh sources (k, v) as the plain versions read them: non-finite
    values zeroed (the kernels zero them as they load them), then, where
    ``fresh_pool_read`` (B,) is given, as f32 carriers: the rows of the
    slots it marks through ``pool_roundtrip``, every other row upcast
    (exact)."""
    k_fresh, v_fresh = zero_non_finite(k_fresh), zero_non_finite(v_fresh)
    if fresh_pool_read is None:
        return k_fresh, v_fresh
    t = k_fresh.shape[0]
    row_valid, row_slot, _ = _row_owners(t, q_start, q_lens)
    sel = (fresh_pool_read.bool()[row_slot] & row_valid)[:, None, None]
    return tuple(
        torch.where(sel, pool_roundtrip(x, quantized, pool_dtype), x.float())
        for x in (k_fresh, v_fresh))


def ragged_paged_attention_pure(q_rows, k_pages, v_pages, block_tables,
                                page_lens, q_start, q_lens, fresh_lens,
                                k_fresh, v_fresh, scale=None,
                                k_scales=None, v_scales=None,
                                fresh_pool_read=None):
    """The plain version on CPU tensors (on the fresh K/V as
    ``fresh_through_pool`` gives them), K11 on CUDA tensors (which zeroes
    non-finite fresh values as it loads them; its int8 form with
    ``k_scales``/``v_scales``, the fresh K/V still bf16, flagged slots'
    rows quantized in the kernel)."""
    global launches
    hk, p_total, page, d = k_pages.shape
    scale = scale or (1.0 / math.sqrt(d))
    quant = k_scales is not None or v_scales is not None
    if not q_rows.is_cuda:
        k_fresh, v_fresh = fresh_through_pool(
            k_fresh, v_fresh, fresh_pool_read, q_start, q_lens, quant,
            k_pages.dtype)
        return ragged_paged_attention_reference(
            q_rows, k_pages, v_pages, block_tables, page_lens, q_start,
            q_lens, fresh_lens, k_fresh, v_fresh, scale, k_scales=k_scales,
            v_scales=v_scales)
    t, h, _ = q_rows.shape
    b, pps = block_tables.shape
    check_wave_shapes(q_rows, hk)
    bf, i32 = torch.bfloat16, torch.int32
    pool = torch.int8 if quant else bf
    _build.check_cuda("q_rows", q_rows, bf)
    _build.check_cuda("k_pages", k_pages, pool)
    _build.check_cuda("v_pages", v_pages, pool, k_pages.shape)
    if quant:
        check_scale_pools(k_pages, k_scales, v_scales)
    _build.check_cuda("block_tables", block_tables, i32)
    for name, x in (("page_lens", page_lens), ("q_start", q_start),
                    ("q_lens", q_lens), ("fresh_lens", fresh_lens)):
        _build.check_cuda(name, x, i32, (b,))
    _build.check_cuda("k_fresh", k_fresh, bf, (t, hk, d))
    _build.check_cuda("v_fresh", v_fresh, bf, (t, hk, d))
    fpr = flag_pointer(fresh_pool_read, b)
    _build.check_no_grad("ragged_paged_attention", q_rows, k_pages, v_pages,
                         k_fresh, v_fresh)
    out = torch.empty_like(q_rows)       # K11 writes every row
    head = (q_rows.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr())
    tail = (block_tables.data_ptr(), page_lens.data_ptr(), q_start.data_ptr(),
            q_lens.data_ptr(), fresh_lens.data_ptr(), fpr, k_fresh.data_ptr(),
            v_fresh.data_ptr(), out.data_ptr(), t, b, h, hk, p_total, page,
            pps, scale, _build.stream_of(q_rows))
    if quant:
        _build.launch("pt_ragged_paged_attention_int8", *head,
                      k_scales.data_ptr(), v_scales.data_ptr(), *tail)
    else:
        _build.launch("pt_ragged_paged_attention", *head, *tail)
    launches += 1
    return out


def flag_pointer(fresh_pool_read, b):
    """The device pointer of a (B,) bool ``fresh_pool_read`` for the ragged
    kernels (checked), or 0 (NULL: no slot flagged) for None."""
    if fresh_pool_read is None:
        return 0
    _build.check_cuda("fresh_pool_read", fresh_pool_read, torch.bool, (b,))
    return fresh_pool_read.data_ptr()


def check_wave_shapes(q_rows, hk):
    """The ragged kernels' shape rule: head_dim 128 and a GQA group of 1,
    2, 4 or 8 (a tile item holds 64 / g wave rows of g heads; a walk item
    the g heads of one row, padded to 16 MMA rows)."""
    _, h, d = q_rows.shape
    g = h // hk if h % hk == 0 else 0
    if d != 128 or g not in (1, 2, 4, 8):
        raise ValueError(f"the ragged attention kernels need head_dim 128 "
                         f"and 1, 2, 4 or 8 query heads per kv head, got q "
                         f"{tuple(q_rows.shape)} with {hk} kv heads")


# ------------------------------------------------ the ragged walk's model


def _is_walk(q_len, fresh):
    return q_len == 1 and fresh == 0


def _max_tiles(rows, slots, r):
    """The most tiles of r rows that ``rows`` wave rows make over at most
    ``slots`` slots of at least one row each."""
    if rows <= 0 or slots <= 0:
        return 0
    return rows if rows <= slots else slots + (rows - slots) // r


def ragged_plan(t, b, hk, g, pps, sms=H100_SMS):
    """The ragged walk's grid (``csrc/ragged_walk.cuh`` plan): (cluster
    size, clusters a kv head, CTAs). The cluster size is the page walk's
    (``walk_plan``); a kv head gets the most clusters any wave of t rows
    over b slots can need: w walk clusters (one a decode row) and then its
    tiles of ``RAGGED_ROWS // g`` rows in clusters of cs, maximised over
    w, at least one. The grid is (clusters x cs, Hk)."""
    cs, _ = walk_plan(b, hk, pps, sms)
    r = RAGGED_ROWS // g
    clusters = max([1] + [w + -(-_max_tiles(t - w, b - w, r) // cs)
                          for w in range(min(b, t) + 1)])
    return cs, clusters, clusters * cs * hk


def _decode(q_lens, fresh_lens, r, cs, cluster, rank):
    """The item of (cluster, rank): (kind, slot, rank or tile)."""
    walks = [b for b, (q, f) in enumerate(zip(q_lens, fresh_lens))
             if _is_walk(q, f)]
    if cluster < len(walks):
        return RAGGED_WALK, walks[cluster], rank
    tau = (cluster - len(walks)) * cs + rank
    for b, (q, f) in enumerate(zip(q_lens, fresh_lens)):
        if q <= 0 or _is_walk(q, f):
            continue
        nt = -(-q // r)
        if tau < nt:
            return RAGGED_TILE, b, tau
        tau -= nt
    return RAGGED_EMPTY, -1, 0


def ragged_items(q_lens, page_lens, fresh_lens, t, hk, g, pps, page,
                 sms=H100_SMS):
    """The ragged walk as its CTAs decode it (``items_kernel``): one row
    (kind, slot, kv head, rank or tile, first key, end key) a CTA, in grid
    order (kv head, then CTA). A walk's keys are its rank's cells [lo page,
    min(hi page, n)) of the slot's n = page_lens cells (``walk_range``); a
    tile's are [0, page_lens + its fresh keys), its fresh keys
    min(fresh_lens, its last row offset + 1); an empty CTA is (0, -1, kh,
    0, 0, 0)."""
    q_lens, page_lens, fresh_lens = (
        [int(x) for x in v] for v in (q_lens, page_lens, fresh_lens))
    cs, clusters, _ = ragged_plan(t, len(q_lens), hk, g, pps, sms)
    r = RAGGED_ROWS // g
    rows = []
    for kh in range(hk):
        for cta in range(clusters * cs):
            kind, b, idx = _decode(q_lens, fresh_lens, r, cs, cta // cs,
                                   cta % cs)
            first = end = 0
            if kind == RAGGED_WALK:
                lo, hi = walk_range(page_lens[b], page, pps, idx, cs)
                first, end = lo * page, min(hi * page, page_lens[b])
            elif kind == RAGGED_TILE:
                end = page_lens[b] + min(fresh_lens[b],
                                         min(q_lens[b], (idx + 1) * r))
            rows.append((kind, b, kh, idx, first, end))
    return rows


def split_ragged_reference(q_rows, k_pages, v_pages, block_tables,
                           page_lens, q_start, q_lens, fresh_lens, k_fresh,
                           v_fresh, scale=None, k_scales=None, v_scales=None,
                           cs=1, drop_last=False, drop_tile_page=False):
    """A plain model of the ragged walk's arithmetic, in f32. A walk item
    (a slot whose one row decodes: q_lens 1, fresh_lens 0): rank r of
    ``cs`` runs an online softmax over its pages (``walk_range``), one max
    and one rescale a page, and the ranks' partial (m, l, acc) merge in
    rank order (``drop_last`` leaves the last range's partial out: a fault
    the attention checks must catch). Every other slot's rows: one softmax
    a row over its pages and its causal fresh keys (u <= the row's offset,
    u < fresh_lens; ``k_fresh`` / ``v_fresh`` as given: the callers zero
    their non-finite values and, for flagged slots, pass them through
    ``fresh_through_pool``; ``drop_tile_page`` leaves each such slot's last
    page out, the control of a wave with no walk). out = acc / max(l,
    1e-30); rows of no
    segment and rows with no visible key are zeros. With ``k_scales`` /
    ``v_scales`` the pages hold int8 codes, each page cell read as code *
    scale in f32 (the fresh keys as given). Never called by the port's
    paths."""
    hk, _, page, d = k_pages.shape
    t, h, _ = q_rows.shape
    g = h // hk
    pps = block_tables.shape[1]
    scale = scale or (1.0 / math.sqrt(d))
    dev = q_rows.device
    qg = q_rows.reshape(t, hk, g, d).float() * scale
    out = torch.zeros((t, hk, g, d), dtype=torch.float32, device=dev)
    for bi in range(block_tables.shape[0]):
        q0, qn = int(q_start[bi]), int(q_lens[bi])
        n, fresh = int(page_lens[bi]), int(fresh_lens[bi])
        if qn <= 0:
            continue
        if _is_walk(qn, fresh):
            parts = []
            for rank in range(cs):
                m = torch.full((hk, g), _NEG_INF, device=dev)
                l = torch.zeros((hk, g), device=dev)
                acc = torch.zeros((hk, g, d), device=dev)
                for pg in range(*walk_range(n, page, pps, rank, cs)):
                    cnt = min(page, n - pg * page)
                    phys = int(block_tables[bi, pg])
                    k = k_pages[:, phys, :cnt].float()
                    v = v_pages[:, phys, :cnt].float()
                    if k_scales is not None:
                        k = k * k_scales[:, phys, :cnt]
                        v = v * v_scales[:, phys, :cnt]
                    s = torch.einsum("kgd,knd->kgn", qg[q0], k)
                    m_new = torch.maximum(m, s.amax(-1))
                    corr = torch.exp(m - m_new)
                    p = torch.exp(s - m_new[..., None])
                    l = l * corr + p.sum(-1)
                    acc = (acc * corr[..., None]
                           + torch.einsum("kgn,knd->kgd", p, v))
                    m = m_new
                parts.append((m, l, acc))
            if drop_last:
                parts = parts[:-1]
            if not parts:
                continue
            mt = torch.stack([pm for pm, _, _ in parts]).amax(0)
            lt = sum(pl * torch.exp(pm - mt) for pm, pl, _ in parts)
            at = sum(pa * torch.exp(pm - mt)[..., None]
                     for pm, _, pa in parts)
            out[q0] = at / lt.clamp_min(1e-30)[..., None]
            continue
        # every row of the slot over its pages and its causal fresh keys
        if drop_tile_page and n:
            n = (-(-n // page) - 1) * page
        pages = block_tables[bi, :min(-(-n // page), pps)].long()
        k_ctx = k_pages[:, pages].reshape(hk, -1, d)[:, :n].float()
        v_ctx = v_pages[:, pages].reshape(hk, -1, d)[:, :n].float()
        if k_scales is not None:
            k_ctx = k_ctx * k_scales[:, pages].reshape(hk, -1, 1)[:, :n]
            v_ctx = v_ctx * v_scales[:, pages].reshape(hk, -1, 1)[:, :n]
        k_new = k_fresh[q0:q0 + qn].float().transpose(0, 1)    # (hk, qn, d)
        v_new = v_fresh[q0:q0 + qn].float().transpose(0, 1)
        keys = torch.cat([k_ctx, k_new], dim=1)
        vals = torch.cat([v_ctx, v_new], dim=1)
        q = qg[q0:q0 + qn].permute(1, 2, 0, 3)                  # (hk, g, qn, d)
        s = torch.einsum("kgrd,knd->kgrn", q, keys)
        off = torch.arange(qn, device=dev)
        u = torch.arange(qn, device=dev)
        fresh_vis = (u[None, :] <= off[:, None]) & (u[None, :] < fresh)
        vis = torch.cat([torch.ones((qn, n), dtype=torch.bool, device=dev),
                         fresh_vis], dim=1)
        s = torch.where(vis, s, torch.full_like(s, -math.inf))
        m = s.amax(-1, keepdim=True).clamp_min(_NEG_INF)
        p = torch.where(vis, torch.exp(s - m), torch.zeros_like(s))
        o = (torch.einsum("kgrn,knd->kgrd", p, vals)
             / p.sum(-1, keepdim=True).clamp_min(1e-30))
        out[q0:q0 + qn] = o.permute(2, 0, 1, 3)
    return out.reshape(t, h, d).to(q_rows.dtype)
