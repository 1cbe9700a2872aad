"""Fused RMSNorm + matmul (``paddle_tpu/ops/pallas/fused_norm_matmul.py``).

Kernel K2 (``csrc/norm_matmul.cu``) replaces both TPU variants — the
resident ``_pallas_fnm`` (M <= 1024) and the streamed ``_pallas_fnm_streamed``
(M > 1024) — with one kernel that handles any M: the normalized rows are
built tile by tile in shared memory and never written to device memory.
Dense bf16 weights only; weight-only int8/int4 is a later slice.

On CPU tensors ``fused_norm_matmul_pure`` runs the unfused chain
(``_reference``); on CUDA tensors it launches K2 or raises.
"""

from __future__ import annotations

import math

import torch

from . import _build

#: K2 launches since the last reset (incremented only where it launches)
launches = 0


def _reference(x, norm_w, eps, w):
    """The unfused chain — rms_norm then the matmul."""
    from ...models.llama import _pure_rms, _wmm

    return _wmm(_pure_rms(x, norm_w, eps), w)


def fused_norm_matmul_pure(x, norm_w, eps, w):
    """y = rms_norm(x, norm_w, eps) @ w; x (..., K), w (K, N)."""
    global launches
    if not x.is_cuda:
        return _reference(x, norm_w, eps, w)
    kdim, n = w.shape
    m = int(math.prod(x.shape[:-1]))
    if x.shape[-1] != kdim or kdim % 128 or n % 8:
        raise ValueError(f"norm_matmul kernel needs K % 128 == 0 and "
                         f"N % 8 == 0, got x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}")
    if m > 65535 * 64:
        raise ValueError(f"norm_matmul kernel takes at most {65535 * 64} "
                         f"rows, got {m}")
    x2 = x.reshape(m, kdim)
    _build.check_cuda("x", x2, torch.bfloat16)
    _build.check_cuda("norm_w", norm_w, torch.bfloat16, (kdim,))
    _build.check_cuda("w", w, torch.bfloat16)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m:
        _build.launch("pt_norm_matmul", x2.data_ptr(), norm_w.data_ptr(),
                      w.data_ptr(), y.data_ptr(), m, kdim, n, float(eps),
                      _build.stream_of(x))
        launches += 1
    return y.reshape(x.shape[:-1] + (n,))
