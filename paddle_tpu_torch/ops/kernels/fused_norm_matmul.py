"""Fused RMSNorm + (quant-)matmul (``paddle_tpu/ops/pallas/fused_norm_matmul.py``).

Kernel K2 (``csrc/norm_matmul.cu``) replaces both TPU variants — the
resident ``_pallas_fnm`` (M <= 1024) and the streamed ``_pallas_fnm_streamed``
(M > 1024) — with one entry point that handles any M: the normalized rows
are built tile by tile in shared memory and never written to device
memory. With M > 16 it launches two kernels: each row's rstd once (M
floats of scratch), then the Hopper body of ``csrc/wgmma_quant_tiles.cuh``
(shared with K4): x and W slices ride a TMA ring, three producer warps
normalize each x slice in place, and two consumer warpgroups run
``wgmma`` on 128 x 256 (or 128 x 128) tiles of a persistent grid whose
walk ``quant_matmul.quant_tiles`` models at the width
``quant_matmul.block_n`` picks. A dense bf16 W reaches ``wgmma`` straight
from the ring; a weight-only ``QuantizedWeight`` (int8 or packed int4,
per-channel or group-wise scales) is dequantized in shared memory exactly
as ``_fnm_kernel`` does it, bf16(code) * bf16(scale) rounded to bf16,
before the bf16 products. With M <= 16 (decode) one kernel does both, the
small-M body of ``csrc/skinny_tiles.cuh`` (shared with K4): a TMA ring
streams W on every SM as the ``wgmma``'s A operand (W^T . x^T), rstd is
computed inside it, and K is split across a thread-block cluster whose
partials are summed in rank order (``quant_matmul.small_plan`` and
``small_items`` model the walk); no rstd scratch.

On CPU tensors ``fused_norm_matmul_pure`` runs the unfused chain
(``_reference``); on CUDA tensors it launches K2 or raises.

``fused_norm_multi_matmul_pure`` is the training plan's grouped node (one
norm, all its matmul consumers) as an ``autograd.Function``: K2 once per
consumer forward, and a backward that differentiates the plain chain
(``_multi_reference``) with plain matmuls, as the JAX package's
``_fnm_multi_call`` custom VJP does outside any kernel; the norm weight gets
ONE gradient. Weight-only quantized weights train too (x and the norm
weight take gradients, codes and scales none): a single ``QuantizedWeight``
under ``_NormMatmulQuant`` (K2's quantized form forward, the JAX package's
``_fnm_kc_bwd`` backward); a group with quantized consumers as the JAX
package routes it, the norm then one weight-only matmul (K4) each.
"""

from __future__ import annotations

import math

import torch

from . import _build
from .quant_matmul import (SMALL_MAX_M, WEIGHT_TYPES, QuantizedWeight,
                           check_quantized)

#: K2 launches since the last reset (incremented only where it launches)
launches = 0


def _reference(x, norm_w, eps, w):
    """The unfused chain — rms_norm then the plain (dequant-)matmul."""
    from ...models.llama import _pure_rms, _wmm

    return _wmm(_pure_rms(x, norm_w, eps), w, plain=True)


def _norm_matmul(x, norm_w, eps, w):
    """The forward with no gradient: K2 on CUDA tensors, the unfused chain
    on CPU tensors."""
    if not x.is_cuda:
        return _reference(x, norm_w, eps, w)
    quantized = isinstance(w, QuantizedWeight)
    kdim, n = w.shape
    m = int(math.prod(x.shape[:-1]))
    if x.shape[-1] != kdim or kdim % 128 or n % 8:
        raise ValueError(f"norm_matmul kernel needs K % 128 == 0 and "
                         f"N % 8 == 0, got x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}")
    x2 = x.reshape(m, kdim)
    _build.check_no_grad("norm_matmul", x2, norm_w,
                         *((w.codes, w.scales) if quantized else (w,)))
    _build.check_cuda("x", x2, torch.bfloat16)
    _build.check_cuda("norm_w", norm_w, torch.bfloat16, (kdim,))
    if quantized:
        check_quantized("w", w.codes, w.scales, w.weight_dtype,
                        w.group_size, kdim, n)
    else:
        _build.check_cuda("w", w, torch.bfloat16)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m:
        # rstd scratch for the tiled body (M > 16); the small-M body keeps
        # rstd in shared memory
        scratch = (torch.empty((m,), dtype=torch.float32, device=x.device)
                   if m > SMALL_MAX_M else None)
        rstd = 0 if scratch is None else scratch.data_ptr()
        if quantized:
            _build.launch("pt_norm_matmul_quant", x2.data_ptr(),
                          norm_w.data_ptr(), w.codes.data_ptr(),
                          w.scales.data_ptr(), rstd, y.data_ptr(),
                          m, kdim, n, WEIGHT_TYPES[w.weight_dtype],
                          w.group_size, float(eps), _build.stream_of(x))
        else:
            _build.launch("pt_norm_matmul", x2.data_ptr(), norm_w.data_ptr(),
                          w.data_ptr(), rstd, y.data_ptr(), m,
                          kdim, n, float(eps), _build.stream_of(x))
        _build.count(globals())
    return y.reshape(x.shape[:-1] + (n,))


class _NormMatmulQuant(torch.autograd.Function):
    """K2's quantized form (or the unfused chain on CPU tensors) forward;
    the backward differentiates the unfused chain for dx and d norm_w, the
    matmul's part by the weight-only rule (the JAX package's
    ``_fnm_kc_bwd``). Codes and scales take no gradient."""

    @staticmethod
    def forward(ctx, x, norm_w, eps, qw):
        ctx.eps, ctx.qw = eps, qw
        ctx.save_for_backward(x, norm_w)
        return _norm_matmul(x, norm_w, eps, qw)

    @staticmethod
    def backward(ctx, g):
        from ...models.llama import _pure_rms
        from .quant_matmul import quant_matmul_dx

        x, norm_w = ctx.saved_tensors
        qw = ctx.qw
        with torch.enable_grad():
            xa = x.detach().requires_grad_(True)
            nwa = norm_w.detach().requires_grad_(True)
            xn = _pure_rms(xa, nwa, ctx.eps)
        dxn = quant_matmul_dx(g, qw.codes, qw.scales, qw.weight_dtype,
                              qw.group_size, qw.shape[0], xn.dtype)
        dx, dnw = torch.autograd.grad(xn, (xa, nwa), dxn.reshape(xn.shape))
        return dx, dnw, None, None


def fused_norm_matmul_pure(x, norm_w, eps, w):
    """y = rms_norm(x, norm_w, eps) @ w; x (..., K), w (K, N) dense or a
    ``QuantizedWeight`` of logical shape (K, N). A ``QuantizedWeight``
    with a gradient on x or norm_w runs under ``_NormMatmulQuant`` (on
    CUDA tensors, codes or scales that require grad raise); a dense w with
    a gradient raises on CUDA tensors (training reaches K2 through
    ``fused_norm_multi_matmul_pure``)."""
    if (isinstance(w, QuantizedWeight) and torch.is_grad_enabled()
            and (x.requires_grad or norm_w.requires_grad)):
        if x.is_cuda:
            _build.check_no_grad("norm_matmul", w.codes, w.scales)
        return _NormMatmulQuant.apply(x, norm_w, eps, w)
    return _norm_matmul(x, norm_w, eps, w)


def _multi_reference(x, norm_w, eps, ws):
    """The unfused chain for a consumer group: ONE norm feeding N
    matmuls."""
    from ...models.llama import _pure_rms

    xn = _pure_rms(x, norm_w, eps)
    return tuple(xn @ w for w in ws)


class _NormMultiMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, norm_w, eps, *ws):
        ctx.eps = eps
        ctx.save_for_backward(x, norm_w, *ws)
        return tuple(fused_norm_matmul_pure(x, norm_w, eps, w) for w in ws)

    @staticmethod
    def backward(ctx, *gs):
        from ...models.llama import _pure_rms

        x, norm_w, *ws = ctx.saved_tensors
        with torch.enable_grad():
            xa = x.detach().requires_grad_(True)
            nwa = norm_w.detach().requires_grad_(True)
            xn = _pure_rms(xa, nwa, ctx.eps)
        xn2 = xn.detach().reshape(-1, xn.shape[-1])
        dws, dxn = [], None
        for w, g in zip(ws, gs):
            g2 = g.reshape(-1, g.shape[-1])
            dws.append(xn2.T @ g2)
            part = g2 @ w.T
            dxn = part if dxn is None else dxn + part
        dx, dnw = torch.autograd.grad(xn, (xa, nwa),
                                      dxn.reshape(xn.shape))
        return (dx, dnw, None, *dws)


def fused_norm_multi_matmul_pure(x, norm_w, eps, ws):
    """The training plan's grouped norm->matmul node: rms_norm folded into
    every matmul consumer in ``ws``. Returns the outputs in consumer order,
    with a gradient. Dense weights: ``_NormMultiMatmul`` (K2 per consumer,
    one VJP). With a ``QuantizedWeight`` consumer the JAX package's route:
    the norm (K6 forward, K7 backward on CUDA tensors), then each consumer
    through its own matmul (K4 under the weight-only rule for a quantized
    one); a group of one quantized consumer (the LM head) is K2's quantized
    form with the unfused chain's backward, the same function fused."""
    if not any(isinstance(w, QuantizedWeight) for w in ws):
        return _NormMultiMatmul.apply(x, norm_w, eps, *ws)
    if len(ws) == 1:
        return (fused_norm_matmul_pure(x, norm_w, eps, ws[0]),)
    from ...models.llama import _wmm
    from .fused_norm_rope import fused_rms_norm

    xn = fused_rms_norm(x, norm_w, eps)
    return tuple(_wmm(xn, w) for w in ws)
