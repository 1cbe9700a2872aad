"""Weight-only int8/int4 matmul (``paddle_tpu/ops/pallas/quant_matmul.py``).

Kernel K4 (``csrc/quant_matmul.cu``) replaces the TPU kernel
``_pallas_quant_matmul`` (``_qmm_kernel``): y = x @ dequant(codes, scales)
with the codes kept packed all the way into shared memory. As on the TPU,
the raw codes (exact in bf16) meet x in the tensor cores with f32
accumulation; a per-channel scale multiplies the sum once at the end, a
group-wise scale multiplies each K-group's partial sum. One entry point
takes any M. For decode (M <= 16) the small-M body of
``csrc/skinny_tiles.cuh`` (shared with K2's M <= 16 forms): the raw codes
stream through a TMA ring on every SM and become a bf16 tile that
``wgmma`` reads as its A operand (W^T . x^T); K is split across a
thread-block cluster and the partials summed in rank order, on the grid
``small_plan`` gives and ``small_items`` models. For prefill the Hopper
body of ``csrc/wgmma_quant_tiles.cuh`` (shared with K2's tiled forms): the
codes ride a TMA ring and become a bf16 tile in shared memory before the
``wgmma``s, on a persistent grid of one block an SM whose walk over the
output tiles ``quant_tiles`` models.

Layout (the JAX package's): codes int8 (K, N), or nibble-packed int8
(ceil(K/2), N) for int4 (byte i: row 2i low nibble, row 2i+1 high nibble);
scales f32 (N,) per output channel or (ceil(K/g), N) group-wise.

On CPU tensors ``quant_matmul_pure`` runs the plain version
(``quant_matmul_reference``); on CUDA tensors it launches K4 or raises.
With a gradient on x it runs under an ``autograd.Function`` whose forward
is that same call and whose backward is the JAX package's weight-only rule
(``quant_matmul_dx``: the f32 product with the dequantized weight, codes
and scales constants). The JAX ``weight_only_kernel`` flag has no
counterpart here.
"""

from __future__ import annotations

import math

import torch

from . import _build
from .grouped_matmul import H100_SMS, _band, _swizzle

#: the tiled body's block tile rows (``csrc/wgmma_quant_tiles.cuh`` BM)
TILE_M = 128

#: the largest M the small-M body takes, its output tile width and ring
#: slice depth, and its largest cluster (``csrc/skinny_tiles.cuh``)
SMALL_MAX_M, SMALL_BN, SMALL_BK, SMALL_MAX_CS = 16, 64, 128, 8

#: K4 launches since the last reset (incremented only where it launches)
launches = 0

#: the C entry points' weight-type codes
WEIGHT_TYPES = {"int8": 1, "int4": 2}


class QuantizedWeight:
    """One weight-only quantized parameter: packed codes, scales and the
    static metadata (``weight_dtype`` "int8" | "int4", ``group_size`` -1
    for per-channel, the logical (K, N) ``shape``)."""

    def __init__(self, codes, scales, weight_dtype, group_size, shape):
        self.codes = codes
        self.scales = scales
        self.weight_dtype = weight_dtype
        self.group_size = int(group_size)
        self.shape = tuple(shape)

    @property
    def nbytes(self):
        return (self.codes.numel() * self.codes.element_size()
                + self.scales.numel() * self.scales.element_size())

    def __repr__(self):
        return (f"QuantizedWeight({self.weight_dtype}, shape={self.shape}, "
                f"group_size={self.group_size})")


def dequant_weight(codes, scales, weight_dtype="int8", group_size=-1,
                   k=None, dtype=torch.float32):
    """Expand (codes, scales) to the dense (K, N) weight in ``dtype``: code
    and scale are each cast to ``dtype`` and multiplied there."""
    if weight_dtype == "int4":
        from ..extra_vision import _unpack_int4

        w = _unpack_int4(codes)
        if k is not None:
            w = w[:k]  # drop the packer's zero pad row (odd K)
    else:
        w = codes
    w = w.to(dtype)
    s = scales.to(dtype)
    if group_size == -1 or s.dim() == 1:
        return w * s.reshape(1, -1)
    return w * s.repeat_interleave(group_size, dim=0)[:w.shape[0]]


def block_n(m, n, group_size=-1, fused_norm=False, sms=H100_SMS):
    """The tiled body's block tile columns (``block_n`` in
    ``csrc/wgmma_quant_tiles.cuh``), one rule for K4 and for K2 with a
    dense or quantized W (``fused_norm``; K2 dense is ``block_n(m, n)``):
    128 for K4's group-wise form (its partial sum and total) and where
    256-wide tiles would fill at most half the SMs, else 256."""
    if group_size > 0 and not fused_norm:
        return 128
    return 128 if 2 * -(-m // TILE_M) * -(-n // 256) <= sms else 256


def small_plan(kdim, n, sms=H100_SMS):
    """The small-M body's grid (``plan_for`` in ``csrc/skinny_tiles.cuh``),
    one rule for every form and every M <= 16: (cluster size, CTAs). T =
    ceil(N / 64) output tiles; the cluster size is the least power of two
    (at most 8, and at most K / 128 slices) whose T x cs CTAs cover 7/8 of
    the SMs; where T x cs would exceed two CTAs an SM, a persistent grid
    of 2 x SMs CTAs (cs is then 1)."""
    tiles, slices = -(-n // SMALL_BN), kdim // SMALL_BK
    cs = 1
    while cs < SMALL_MAX_CS and 2 * cs <= slices and 8 * tiles * cs < 7 * sms:
        cs *= 2
    return cs, (2 * sms if tiles * cs > 2 * sms else tiles * cs)


def small_items(kdim, n, sms=H100_SMS):
    """The small-M body's work as its CTAs decode it (``items_kernel``):
    row ``tile * cs + rank`` is (CTA, its step at that tile, first slice,
    end slice), slices of ``SMALL_BK`` k-rows. Cluster c = CTA // cs takes
    tiles c, c + grid / cs, ...; rank r = CTA % cs takes the contiguous
    slices S r / cs .. S (r + 1) / cs of the S = K / 128."""
    cs, grid = small_plan(kdim, n, sms)
    tiles, slices = -(-n // SMALL_BN), kdim // SMALL_BK
    rows = [None] * (tiles * cs)
    for b in range(grid):
        rank, clusters = b % cs, grid // cs
        for step, tile in enumerate(range(b // cs, tiles, clusters)):
            rows[tile * cs + rank] = (b, step, slices * rank // cs,
                                      slices * (rank + 1) // cs)
    return rows


def quant_tiles(m, kdim, n, bn):
    """The tiled body's output tiles (row tile, column tile) in walk order,
    as its blocks decode them (M > 16): tiles of ``TILE_M`` rows x ``bn``
    columns, ``_band(kdim)`` row tiles (their x rows ~16 MB together)
    walking fastest, then the column tiles, band after band. Block b of
    the persistent grid takes tiles b, b + grid, ...
    (``grouped_matmul.persistent_blocks``)."""
    n_mt, n_nt = -(-m // TILE_M), -(-n // bn)
    return [_swizzle(i, n_mt, n_nt, _band(kdim)) for i in range(n_mt * n_nt)]


def quant_matmul_reference(x, codes, scales, weight_dtype="int8",
                           group_size=-1):
    """K4's plain version: dequantize into ``x.dtype``, then one matmul
    (f32 accumulation) and one cast back to ``x.dtype``."""
    w = dequant_weight(codes, scales, weight_dtype, group_size,
                       k=x.shape[-1], dtype=x.dtype)
    return torch.matmul(x, w)


def tolerance(x, codes, scales, weight_dtype, group_size, ref):
    """Per-element bound on |K4 out - plain out|, from the inputs. K4 sums
    the exact products x * code in f32 and then scales the sum (per
    channel) or each group's partial sum; the plain version first rounds
    each code * scale to bf16, at most 2^-8 relative, so before the output
    rounding the two differ by at most 2^-8 * (|x| @ |W|), W the weight
    dequantized in f32 (f32 summation-order differences are far below
    that). Each output is then rounded to bf16 once in both: at most one
    ulp apart, 2^-7 * |out| -> 1e-2 * |ref|."""
    w = dequant_weight(codes, scales, weight_dtype, group_size,
                       k=x.shape[-1], dtype=torch.float32)
    spread = x.float().abs() @ w.abs()
    return 2.0 ** -8 * spread + 1e-2 * ref.float().abs() + 1e-6


def check_quantized(name, codes, scales, weight_dtype, group_size, kdim, n,
                    n_groups=None):
    """Raise unless (codes, scales) are contiguous CUDA tensors laid out as
    the kernels read them for a (kdim, n) weight: int8 codes (K, N) or
    packed (K/2, N), f32 scales (N,) or (K/g, N), N % 16 == 0; with
    ``n_groups`` a stack of that many such weights (K13's experts), each
    shape led by it."""
    if weight_dtype not in WEIGHT_TYPES:
        raise ValueError(f"{name}: weight_dtype must be int8 or int4, "
                         f"got {weight_dtype!r}")
    if group_size not in (-1, 64, 128) or (group_size > 0
                                           and kdim % group_size):
        raise ValueError(f"{name}: group_size {group_size} does not divide "
                         f"K = {kdim} (or is not -1, 64, 128)")
    if n % 16:
        raise ValueError(f"{name}: quantized weights need N % 16 == 0, "
                         f"got N = {n}")
    rows = kdim // 2 if weight_dtype == "int4" else kdim
    lead = () if n_groups is None else (n_groups,)
    _build.check_cuda(f"{name}.codes", codes, torch.int8, lead + (rows, n))
    s_shape = (n,) if group_size == -1 else (kdim // group_size, n)
    _build.check_cuda(f"{name}.scales", scales, torch.float32,
                      lead + s_shape)


def quant_matmul_dx(g, codes, scales, weight_dtype, group_size, kdim,
                    dtype):
    """The weight-only backward rule (the JAX package's
    ``_pallas_with_vjp``): dx = (g in f32) @ dequant(codes, scales)^T in
    f32, cast to x's ``dtype``. Codes and scales are constants. Plain ops:
    the reference computes this product outside any kernel too."""
    w = dequant_weight(codes, scales, weight_dtype, group_size, k=kdim,
                       dtype=torch.float32)
    return (g.float() @ w.T).to(dtype)


def _quant_matmul(x, codes, scales, weight_dtype, group_size):
    """The forward with no gradient: K4 on CUDA tensors, the plain version
    on CPU tensors."""
    if not x.is_cuda:
        return quant_matmul_reference(x, codes, scales, weight_dtype,
                                      group_size)
    kdim = x.shape[-1]
    n = codes.shape[-1]
    m = int(math.prod(x.shape[:-1]))
    if kdim % 128:
        raise ValueError(f"quant_matmul kernel needs K % 128 == 0, got x "
                         f"{tuple(x.shape)}")
    x2 = x.reshape(m, kdim)
    _build.check_no_grad("quant_matmul", x2, codes, scales)
    _build.check_cuda("x", x2, torch.bfloat16)
    check_quantized("w", codes, scales, weight_dtype, group_size, kdim, n)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m:
        _build.launch("pt_quant_matmul", x2.data_ptr(), codes.data_ptr(),
                      scales.data_ptr(), y.data_ptr(), m, kdim, n,
                      WEIGHT_TYPES[weight_dtype], int(group_size),
                      _build.stream_of(x))
        _build.count(globals())
    return y.reshape(x.shape[:-1] + (n,))


class _QuantMatmul(torch.autograd.Function):
    """K4 (or its plain version) forward, the weight-only rule backward."""

    @staticmethod
    def forward(ctx, x, codes, scales, weight_dtype, group_size):
        ctx.save_for_backward(codes, scales)
        ctx.meta = (weight_dtype, group_size, x.shape[-1], x.dtype)
        return _quant_matmul(x, codes, scales, weight_dtype, group_size)

    @staticmethod
    def backward(ctx, g):
        codes, scales = ctx.saved_tensors
        return (quant_matmul_dx(g, codes, scales, *ctx.meta), None, None,
                None, None)


def quant_matmul_pure(x, codes, scales, weight_dtype="int8", group_size=-1):
    """y = x @ dequant(codes, scales); x (..., K). K4 on CUDA tensors (bf16
    x, K % 128 == 0, N % 16 == 0), the plain version on CPU tensors. With
    a gradient on x, its backward is ``quant_matmul_dx``; codes and scales
    take none (on CUDA tensors, codes or scales that require grad
    raise)."""
    if torch.is_grad_enabled() and x.requires_grad:
        if x.is_cuda:
            _build.check_no_grad("quant_matmul", codes, scales)
        return _QuantMatmul.apply(x, codes, scales, weight_dtype,
                                  group_size)
    return _quant_matmul(x, codes, scales, weight_dtype, group_size)


def quant_matmul_qw(x, qw: QuantizedWeight):
    """``quant_matmul_pure`` over a ``QuantizedWeight``."""
    return quant_matmul_pure(x, qw.codes, qw.scales,
                             weight_dtype=qw.weight_dtype,
                             group_size=qw.group_size)
