"""Grouped (segmented) matmul over expert-sorted token rows (``paddle_tpu/ops/pallas/grouped_matmul.py``).

The dropless-MoE primitive: tokens sorted by expert id give each expert
one contiguous row block, described by ``group_offsets`` (E + 1 int32,
rows ``offsets[e] .. offsets[e+1]`` are group e's, ``offsets[E] == T``),
and ``y[r] = x[r] @ w[group_of(r)]`` runs with no per-expert padding.

Kernel K13 (``csrc/grouped_matmul.cu``) replaces ``_pallas_grouped_matmul``:
its work items are the (step, n-tile) pairs of the ``group_tile_walk`` over
128-row tiles, each decoded on the card from the offsets, so no count
returns to the host. Its transposed form reads the stacked weight as
(E, N, K) and multiplies by ``w[g]^T`` in place: the backward's dX.
Kernel K14 (``csrc/segment_dw.cu``) replaces ``_pallas_segment_dw``:
``dw[e] = x_e^T @ dy_e`` in f32, an optional scale, cast at the end; an
empty group writes zeros. Both bound by tensor-core operations at the
MoE train shapes, both run ``csrc/wgmma_tiles.cuh``: 128 x 256 tiles,
``wgmma`` on TMA-fed stages, one producer warp and two consumer
warpgroups, a persistent grid of one block an SM. ``gmm_items``,
``sdw_items``, ``sdw_slices`` and ``persistent_blocks`` model the order
in which the blocks take their items and the rows each item reads; the
card tests hold the kernels' own decoding to them.

K13's int8/int4 forms (``csrc/grouped_matmul_quant.cu``, ``gmm_quant``)
take weight-only quantized expert weights: codes int8 (E, K, N) or
nibble-packed int4 (E, K/2, N), scales f32 (E, N) per channel or
(E, K/g, N) group-wise (``quantize_grouped_weight``, the JAX package's
layout). They run K4's body (``csrc/wgmma_quant_tiles.cuh``) on K13's
items: the raw codes reach shared memory through a 3-D map with the
expert outermost and become an exact bf16 tile there, the f32 sum is
scaled once (per channel, 128 x 256 tiles) or per K-group (128 x 128),
and an item writes its rows [lo, hi) only. ``gmm_items`` models both
tile widths (``quant_tile_n``).

``grouped_matmul`` is the ``autograd.Function`` the MoE route calls (the
JAX package's custom VJP): K13 forward, K13's transposed form for dX, and
dW through ``segment_dw_pure``'s epilogue seam (K14 with the cast riding
it), which runs K14 when the ``moe_grouped_bwd`` train family is on. With
codes and scales it is the quantized VJP: K13's int8/int4 form forward;
dX expands the codes with the dequant rule (``_expand_expert_weight``)
and runs the fp grouped product on the same offsets (on the card a bf16
(E, K, N) stack through K13's transposed form, elsewhere f32 as the JAX
package does); codes, scales and offsets take no gradient. On CUDA
tensors every wrapper launches its kernel or raises (also with
``flags.grouped_matmul_kernel`` or the family off); only ``plain=True``
runs the plain versions there. On CPU tensors they run the plain
versions, which loop over the groups' row slices with f32 accumulation
(never the JAX reference's (E, T, K) masked tensors).
"""

from __future__ import annotations

import torch

from ...framework import flags
from . import _build

#: K13 launches (its bf16 forward and dX forms), K13 int8/int4 launches
#: and K14 launches since the last reset (incremented only where each
#: launches)
launches = 0
quant_launches = 0
dw_launches = 0

#: K13/K14's block tile rows and columns and their reduction slice
#: (``csrc/wgmma_tiles.cuh`` BM, BN, BK)
TILE_M, TILE_N, SLICE = 128, 256, 64
#: the H100's SMs: the persistent grid's blocks (one an SM)
H100_SMS = 132

#: epilogue op kinds the dW seam understands (JAX ``DW_EPILOGUE_OPS``)
DW_EPILOGUE_OPS = ("scale", "cast")

def quant_tile_n(group_size=-1):
    """The column tile of K13's int8/int4 forms: 128 group-wise (its
    partial sum and its total, 2 x 64 registers), else 256."""
    return 128 if group_size > 0 else TILE_N


def group_tile_walk(group_offsets, bm, n_tiles, n_groups,
                    min_one_step: bool = False):
    """The (tile_m, group, row_lo, row_hi) int32 vectors of the step walk,
    each ``n_tiles + n_groups - 1`` long: step i covers rows
    [row_lo[i], row_hi[i]) of m-tile tile_m[i] against group[i]'s weight;
    steps past the walk are parked on the last tile with an empty range.
    ``min_one_step`` gives each EMPTY group one empty step too (the TPU
    segment-dW kernel's output blocks are per group). The same integers as
    the JAX package's; K13 computes its own step the same way on the card
    (``walk_step`` in ``csrc/grouped_tiles.cuh``)."""
    off = group_offsets.to(torch.int64)
    sizes = off[1:] - off[:-1]
    start_tile = torch.div(off[:-1], bm, rounding_mode="floor")
    end_tile = torch.clamp(torch.div(off[1:] - 1, bm, rounding_mode="floor"),
                           min=0)
    count = torch.where(sizes > 0, end_tile - start_tile + 1,
                        1 if min_one_step else 0)
    cum = torch.cumsum(count, 0)
    i = torch.arange(n_tiles + n_groups - 1, device=off.device)
    g = torch.searchsorted(cum, i, right=True)
    parked = g >= n_groups
    gc = torch.clamp(g, max=n_groups - 1)
    prev = torch.where(gc > 0, cum[torch.clamp(gc - 1, min=0)], 0)
    tile = torch.clamp(start_tile[gc] + (i - prev), max=n_tiles - 1)
    tile = torch.where(parked, n_tiles - 1, tile)
    row_lo = torch.where(parked, 0, torch.maximum(off[gc], tile * bm))
    row_hi = torch.where(parked, 0, torch.minimum(off[gc + 1],
                                                  (tile + 1) * bm))
    return tuple(v.to(torch.int32) for v in (tile, gc, row_lo, row_hi))


def _band(kdim):
    """K13's band: the row tiles whose x rows fill ~16 MB of L2."""
    return min(max((16 << 20) // (TILE_M * kdim * 2), 1), 16)


def _swizzle(bid, n_band, n_other, band):
    """``swizzle`` of ``csrc/grouped_tiles.cuh``: item ``bid`` walks
    ``band`` indices of the banded axis fastest, then the other axis."""
    first = bid // (band * n_other) * band
    width = min(band, n_band - first)
    local = bid - first * n_other
    return first + local % width, local // width


def gmm_items(group_offsets, t, kdim, n, tile_n=TILE_N):
    """K13's work items in walk order, as the kernel decodes them: one
    (tile, group, lo, hi, n_tile, slices) per (step, n-tile) of the banded
    walk over the ``group_tile_walk``'s n_tiles + E - 1 steps of 128 rows.
    The item writes rows [lo, hi) of ``tile`` against ``group``'s weight
    in columns [tile_n n_tile, tile_n (n_tile + 1)) (``tile_n`` 256, or
    128 for the group-wise int8/int4 forms, ``quant_tile_n``); a parked
    step has lo == hi and no slices."""
    e = len(group_offsets) - 1
    n_tiles = -(-t // TILE_M)
    walk = [v.tolist() for v in group_tile_walk(
        torch.as_tensor(group_offsets, dtype=torch.int32), TILE_M, n_tiles,
        e)]
    n_steps, n_nt, band = n_tiles + e - 1, -(-n // tile_n), _band(kdim)
    items = []
    for i in range(n_steps * n_nt):
        step, nt = _swizzle(i, n_steps, n_nt, band)
        tile, g, lo, hi = (v[step] for v in walk)
        items.append((tile, g, lo, hi, nt, -(-kdim // SLICE) if hi > lo
                      else 0))
    return items


def sdw_items(group_offsets, t, kdim, n):
    """K14's work items in walk order, as the kernel decodes them: one
    (group, k_tile, n_tile, lo, hi, slices) per output tile, the groups
    ranked by rows, most first (ties by index), and within a group the
    smaller of the two output axes fastest. The item sums rows [lo, hi)
    (``sdw_slices``); an empty group's items run no slice and write
    zeros."""
    off = [min(max(int(v), 0), t) for v in group_offsets]
    e = len(off) - 1
    rows = [max(0, off[g + 1] - off[g]) for g in range(e)]
    n_mt, n_nt = -(-kdim // TILE_M), -(-n // TILE_N)
    items = []
    for g in sorted(range(e), key=lambda g: (-rows[g], g)):
        lo, hi = off[g], max(off[g], off[g + 1])
        for local in range(n_mt * n_nt):
            mt, nt = ((local % n_mt, local // n_mt) if kdim <= n
                      else (local // n_nt, local % n_nt))
            items.append((g, mt, nt, lo, hi, -(-(hi - lo) // SLICE)))
    return items


def sdw_slices(lo, hi):
    """The (first row, rows kept) of each 64-row slice a K14 item reads
    for group rows [lo, hi): the first starts at lo; the last one's other
    ``SLICE - kept`` rows belong to the next group (or lie past T), and
    the kernel zeroes them in shared memory before its products."""
    return [(r, min(SLICE, hi - r)) for r in range(lo, hi, SLICE)]


def persistent_blocks(n_items, sms=H100_SMS):
    """The item indices each block of K13's and K14's persistent grid
    takes: min(n_items, sms) blocks, block b items b, b + grid, ..."""
    grid = min(n_items, sms)
    return [list(range(b, n_items, grid)) for b in range(grid)]


def _bounds(group_offsets):
    """The offsets as Python ints (a host read: plain versions only)."""
    return [int(v) for v in group_offsets.tolist()]


def _quantized(weight_dtype, scales):
    """Whether (weight_dtype, scales) name int8/int4 codes; raises on codes
    without scales or an unknown type (the JAX package's errors)."""
    from .quant_matmul import WEIGHT_TYPES

    if weight_dtype in (None, "fp"):
        return False
    if weight_dtype not in WEIGHT_TYPES:
        raise ValueError(f"weight_dtype must be fp, int8 or int4, got "
                         f"{weight_dtype!r}")
    if scales is None:
        raise ValueError(f"weight_dtype {weight_dtype!r} requires scales")
    return True


def _expand_expert_weight(w, scales, weight_dtype, group_size, k, dtype):
    """Stacked (E, ...) codes + scales -> the dense (E, K, N) stack in
    ``dtype``, each expert through THE dequant rule
    (``quant_matmul.dequant_weight``: code and scale cast to ``dtype`` and
    multiplied there); fp weights are only cast."""
    from .quant_matmul import dequant_weight

    if weight_dtype in (None, "fp"):
        return w.to(dtype)
    return torch.stack([dequant_weight(w[e], scales[e], weight_dtype,
                                       group_size, k=k, dtype=dtype)
                        for e in range(w.shape[0])])


def grouped_matmul_reference(x, group_offsets, w, scales=None,
                             weight_dtype="fp", group_size=-1,
                             trans_w=False):
    """K13's plain version: for each group, its row slice times its weight
    (``w[e]``, or ``w[e]^T`` for the (E, N, K) stack with ``trans_w``; with
    int8/int4 codes the expert dequantized into x's dtype, as the JAX
    reference lowering does), f32-accumulated, rounded once to x's dtype;
    rows in no group are 0."""
    from ..loss_ops import _mm_f32
    from .quant_matmul import dequant_weight

    quant = _quantized(weight_dtype, scales)
    if quant and trans_w:
        raise ValueError("the quantized grouped matmul has no trans_w form")
    n = w.shape[1] if trans_w else w.shape[2]
    y = torch.zeros((x.shape[0], n), dtype=x.dtype, device=x.device)
    off = _bounds(group_offsets)
    for e in range(w.shape[0]):
        lo, hi = off[e], off[e + 1]
        if hi > lo:
            we = (dequant_weight(w[e], scales[e], weight_dtype, group_size,
                                 k=x.shape[1], dtype=x.dtype) if quant
                  else w[e].T if trans_w else w[e])
            y[lo:hi] = _mm_f32(x[lo:hi], we).to(x.dtype)
    return y


def _apply_dw_epilogue(dw, epilogue):
    for kind, arg in (epilogue or ()):
        if kind == "scale":
            dw = dw * arg
        elif kind == "cast":
            dw = dw.to(arg)
        else:
            raise ValueError(f"unknown dw epilogue op {kind!r}")
    return dw


def segment_dw_reference(x, dy, group_offsets, e, epilogue=None):
    """K14's plain version: ``dw[g] = x_g^T @ dy_g`` per group's row slice
    in f32 (zeros for an empty group), then the epilogue ops."""
    from ..loss_ops import _mm_f32

    dw = torch.zeros((e, x.shape[1], dy.shape[1]), dtype=torch.float32,
                     device=x.device)
    off = _bounds(group_offsets)
    for g in range(e):
        lo, hi = off[g], off[g + 1]
        if hi > lo:
            dw[g] = _mm_f32(x[lo:hi].T, dy[lo:hi])
    return _apply_dw_epilogue(dw, epilogue)


def tolerance(x, group_offsets, w, ref, trans_w=False):
    """Per-element bound on |K13 - plain| from the inputs. Both sum the
    exact products of bf16 values in f32, in different orders: each sum is
    ~K/16 tensor-core accumulations, each rounding by at most 2^-24 of a
    running sum below S = |x| @ |w| (taken per group), so they differ by at
    most ~K/8 * 2^-24 * S; K/4 * 2^-24 * S leaves a factor 2. Each output
    is then rounded to bf16 once in both: one ulp, 2^-7 * |out| ->
    1e-2 * |ref|."""
    k = x.shape[1]
    spread = grouped_matmul_reference(x.abs(), group_offsets, w.abs(),
                                      trans_w=trans_w).float()
    return k / 4 * 2.0 ** -24 * spread + 1e-2 * ref.float().abs() + 1e-6


def quant_tolerance(x, group_offsets, codes, scales, weight_dtype,
                    group_size, ref):
    """Per-element bound on |K13 int8/int4 - plain| from the inputs. K13
    sums the exact products x * code in f32 and scales the sum (per
    channel) or each group's partial sum (group-wise), so before its one
    output rounding it is the f32 product of x with the weight W
    dequantized in f32, up to the f32 summation order (``tolerance``'s
    K/4 * 2^-24 * S, S = |x| @ |W| per group). The plain version first
    rounds each dequantized weight code * scale to bf16, at most 2^-8
    relative: 2^-8 * S more. Each output is then rounded to bf16 once in
    both: one ulp, 2^-7 * |out| -> 1e-2 * |ref|. In all
    (K/4 * 2^-24 + 2^-8) * S + 1e-2 * |ref| (K4's ``tolerance`` with the
    summation term)."""
    k = x.shape[1]
    w32 = _expand_expert_weight(codes, scales, weight_dtype, group_size, k,
                                torch.float32)
    spread = grouped_matmul_reference(x.float().abs(), group_offsets,
                                      w32.abs())
    return ((k / 4 * 2.0 ** -24 + 2.0 ** -8) * spread
            + 1e-2 * ref.float().abs() + 1e-6)


def dw_tolerance(x, dy, group_offsets, e, ref):
    """Per-element bound on |K14 - plain| (as ``tolerance``, over each
    group's n_e rows: n_e / 4 * 2^-24 * (|x_e|^T @ |dy_e|), plus one bf16
    ulp when the output is bf16)."""
    spread = segment_dw_reference(x.abs(), dy.abs(), group_offsets, e)
    off = group_offsets.to(torch.float32)
    rows = (off[1:] - off[:-1]).reshape(e, 1, 1)
    ulp = 1e-2 if ref.dtype == torch.bfloat16 else 0.0
    return rows / 4 * 2.0 ** -24 * spread + ulp * ref.float().abs() + 1e-6


def _check(name, x, group_offsets, w_name, w, w_k, n, n_groups):
    """Raise unless x (T, K) meets a K-deep operand ``w`` of N columns as
    the kernels take them: contiguous bf16 on 16-byte-aligned addresses
    (TMA's), K and N multiples of 8, int32 offsets of E + 1 entries, all
    on the card."""
    if x.dim() != 2 or x.shape[1] != w_k or w_k % 8 or n % 8:
        raise ValueError(f"{name} kernel needs x (T, K) against {w_name} "
                         f"of K rows, K % 8 == 0 and N % 8 == 0; got x "
                         f"{tuple(x.shape)}, {w_name} {tuple(w.shape)}")
    _build.check_cuda("x", x, torch.bfloat16)
    _build.check_cuda(w_name, w, torch.bfloat16)
    _build.check_cuda("group_offsets", group_offsets, torch.int32,
                      (n_groups + 1,))


def gmm(x, group_offsets, w, trans_w=False):
    """y (T, N) = x[r] @ w[group(r)] for x (T, K) and w (E, K, N) (or x[r] @
    w[group(r)]^T for w (E, N, K) with ``trans_w``): K13 on CUDA tensors,
    the plain version on CPU tensors."""
    global launches
    if not x.is_cuda:
        return grouped_matmul_reference(x, group_offsets, w, trans_w=trans_w)
    if not flags.get_flag("grouped_matmul_kernel"):
        raise NotImplementedError(
            "the grouped matmul runs as kernel K13 on CUDA tensors; "
            "flags.grouped_matmul_kernel is off (plain=True runs the plain "
            "version)")
    _build.check_no_grad("grouped_matmul", x, w)
    e = w.shape[0]
    n, w_k = (w.shape[1], w.shape[2]) if trans_w else (w.shape[2],
                                                       w.shape[1])
    _check("grouped_matmul", x, group_offsets, "w", w, w_k, n, e)
    t, kdim = x.shape
    y = torch.empty((t, n), dtype=x.dtype, device=x.device)
    if t:
        _build.launch("pt_grouped_matmul", x.data_ptr(),
                      group_offsets.data_ptr(), w.data_ptr(), y.data_ptr(),
                      t, kdim, n, e, int(trans_w), _build.stream_of(x))
        launches += 1
    return y


def gmm_quant(x, group_offsets, codes, scales, weight_dtype="int8",
              group_size=-1):
    """y (T, N) = x[r] @ dequant(codes[group(r)], scales[group(r)]) for x
    (T, K): K13's int8/int4 form on CUDA tensors (bf16 x, K % 128 == 0,
    N % 16 == 0, codes (E, K | K/2, N) and scales (E, N) or (E, K/g, N)
    as ``quant_matmul.check_quantized`` takes them), the plain version on
    CPU tensors."""
    global quant_launches
    if not x.is_cuda:
        return grouped_matmul_reference(x, group_offsets, codes, scales,
                                        weight_dtype, group_size)
    if not flags.get_flag("grouped_matmul_kernel"):
        raise NotImplementedError(
            "the quantized grouped matmul runs as K13's int8/int4 form on "
            "CUDA tensors; flags.grouped_matmul_kernel is off (plain=True "
            "runs the plain version)")
    from .quant_matmul import WEIGHT_TYPES, check_quantized

    _build.check_no_grad("grouped_matmul_quant", x, codes, scales)
    if x.dim() != 2 or x.shape[1] % 128:
        raise ValueError(f"grouped_matmul_quant kernel needs x (T, K) with "
                         f"K % 128 == 0, got {tuple(x.shape)}")
    t, kdim = x.shape
    e, n = codes.shape[0], codes.shape[-1]
    check_quantized("grouped_matmul_quant", codes, scales, weight_dtype,
                    group_size, kdim, n, n_groups=e)
    _build.check_cuda("x", x, torch.bfloat16)
    _build.check_cuda("group_offsets", group_offsets, torch.int32, (e + 1,))
    y = torch.empty((t, n), dtype=x.dtype, device=x.device)
    if t:
        _build.launch("pt_grouped_matmul_quant", x.data_ptr(),
                      group_offsets.data_ptr(), codes.data_ptr(),
                      scales.data_ptr(), y.data_ptr(), t, kdim, n, e,
                      WEIGHT_TYPES[weight_dtype], int(group_size),
                      _build.stream_of(x))
        quant_launches += 1
    return y


def segment_dw(x, dy, group_offsets, e, scale=None, out_dtype=torch.float32):
    """dw (E, K, N) = scale * x_g^T @ dy_g per group, cast to ``out_dtype``
    (f32 or bf16): K14 on CUDA tensors, the plain version on CPU tensors."""
    global dw_launches
    epilogue = ((() if scale is None else (("scale", scale),))
                + (("cast", out_dtype),))
    if not x.is_cuda:
        return segment_dw_reference(x, dy, group_offsets, e, epilogue)
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"segment_dw kernel writes float32 or bfloat16, "
                         f"got {out_dtype}")
    _build.check_no_grad("segment_dw", x, dy)
    if dy.dim() != 2 or dy.shape[0] != x.shape[0]:
        raise ValueError(f"segment_dw needs dy (T, N) beside x (T, K), got "
                         f"{tuple(dy.shape)} and {tuple(x.shape)}")
    _check("segment_dw", x, group_offsets, "dy", dy, x.shape[1],
           dy.shape[1], e)
    t, kdim = x.shape
    n = dy.shape[1]
    dw = torch.empty((e, kdim, n), dtype=out_dtype, device=x.device)
    _build.launch("pt_segment_dw", x.data_ptr(), dy.data_ptr(),
                  group_offsets.data_ptr(), dw.data_ptr(), t, kdim, n, e,
                  float(1.0 if scale is None else scale),
                  int(out_dtype == torch.float32), _build.stream_of(x))
    dw_launches += 1
    return dw


def segment_dw_pure(x, dy, group_offsets, e, epilogue=None, plain=False):
    """The backward's per-group outer product with an EPILOGUE SEAM (the
    train fusion pass's ``moe_grouped_bwd`` family): on CUDA tensors K14
    with a leading ``("scale", s)`` and a trailing ``("cast", dtype)``
    applied as each block flushes — it raises when the family is off
    (flag-resolved) or the epilogue holds anything else; on CPU tensors,
    or with ``plain``, the plain outer products then the epilogue ops."""
    from . import fusion

    epilogue = tuple(epilogue or ())
    if not x.is_cuda or plain:
        return segment_dw_reference(x, dy, group_offsets, e, epilogue)
    scale, out_dtype = None, torch.float32
    for j, (kind, arg) in enumerate(epilogue):
        if kind not in DW_EPILOGUE_OPS:
            raise ValueError(f"unknown dw epilogue op {kind!r}")
        if kind == "scale" and j == 0:
            scale = arg
        elif kind == "cast" and j == len(epilogue) - 1:
            out_dtype = arg
        else:
            raise NotImplementedError(
                f"dw epilogue {epilogue}: K14 takes a leading scale and a "
                f"trailing cast only")
    if not fusion.train_fusion_on("moe_grouped_bwd"):
        raise NotImplementedError(
            "the segment dW runs as kernel K14 on CUDA tensors; the "
            "moe_grouped_bwd train family is off (flags fused_train, "
            "fused_train_fusions; plain=True runs the plain version)")
    return segment_dw(x, dy, group_offsets, e, scale, out_dtype)


def _gmm(x, group_offsets, w, trans_w, plain):
    if plain:
        return grouped_matmul_reference(x, group_offsets, w, trans_w=trans_w)
    return gmm(x, group_offsets, w, trans_w)


class _GroupedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group_offsets, w, plain):
        ctx.save_for_backward(x, group_offsets, w)
        ctx.plain = plain
        return _gmm(x, group_offsets, w, False, plain)

    @staticmethod
    def backward(ctx, dy):
        x, offs, w = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # the transpose grouped matmul: the same offsets against w^T
            dx = _gmm(dy, offs, w.to(dy.dtype), True, ctx.plain).to(x.dtype)
        if ctx.needs_input_grad[2]:
            # the cast that follows the outer product rides the seam
            dw = segment_dw_pure(x, dy, offs, w.shape[0],
                                 epilogue=(("cast", w.dtype),),
                                 plain=ctx.plain)
        return dx, None, dw, None


class _GroupedMatmulQuant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group_offsets, codes, scales, weight_dtype,
                group_size, plain):
        ctx.save_for_backward(group_offsets, codes, scales)
        ctx.quant = (weight_dtype, group_size, x.shape[1], x.dtype)
        ctx.plain = plain
        if plain:
            return grouped_matmul_reference(x, group_offsets, codes, scales,
                                            weight_dtype, group_size)
        return gmm_quant(x, group_offsets, codes, scales, weight_dtype,
                         group_size)

    @staticmethod
    def backward(ctx, dy):
        offs, codes, scales = ctx.saved_tensors
        weight_dtype, group_size, kdim, x_dtype = ctx.quant
        dy = dy.contiguous()
        dx = None
        if ctx.needs_input_grad[0]:
            # dx = dy @ dequant(w[g])^T on the same offsets: the dense
            # (E, K, N) stack read transposed in place
            if dy.is_cuda and not ctx.plain:
                wd = _expand_expert_weight(codes, scales, weight_dtype,
                                           group_size, kdim, dy.dtype)
                dx = gmm(dy, offs, wd, trans_w=True)
            else:  # the JAX package's rule: f32 throughout
                wd = _expand_expert_weight(codes, scales, weight_dtype,
                                           group_size, kdim, torch.float32)
                dx = grouped_matmul_reference(dy.float(), offs, wd,
                                              trans_w=True)
            dx = dx.to(x_dtype)
        return dx, None, None, None, None, None, None


def grouped_matmul(x, group_offsets, w, scales=None, weight_dtype="fp",
                   group_size=-1, plain=False):
    """``y[r] = x[r] @ w[group_of(r)]`` for expert-sorted rows, with a
    gradient: x (T, K), group_offsets (E + 1,) int32, w (E, K, N). K13
    forward, K13's transposed form for dx, K14 for dw (``segment_dw_pure``,
    the cast to w's dtype as its epilogue); the offsets take no gradient.
    With ``weight_dtype`` "int8" / "int4", w holds codes (E, K | K/2, N)
    and ``scales`` their scales: K13's int8/int4 form forward, dx through
    the dequantized stack, and no gradient for codes, scales or offsets.
    ``plain`` runs the plain versions on any device (the on-card
    reference)."""
    if _quantized(weight_dtype, scales):
        return _GroupedMatmulQuant.apply(x, group_offsets, w, scales,
                                         weight_dtype, int(group_size),
                                         plain)
    return _GroupedMatmul.apply(x, group_offsets, w, plain)


def quantize_grouped_weight(w, algo="weight_only_int8", group_size=-1):
    """Quantize a stacked (E, K, N) expert weight per expert with THE
    shared absmax rule (``extra_vision._weight_quantize_pure``): (codes,
    scales) in ``grouped_matmul``'s stacked layout, on w's device."""
    from ..extra_vision import _weight_quantize_pure

    codes, scales = zip(*[_weight_quantize_pure(w[e], algo=algo,
                                                group_size=group_size)
                          for e in range(w.shape[0])])
    return torch.stack(codes), torch.stack(scales)
