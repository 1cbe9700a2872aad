#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``paddle_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--profile]

``--profile`` adds torch.profiler traces of the serving runs (device time
by kernel class, device busy share). Phases, in order; any failure raises and the process exits nonzero:

1. device   — the card's name and power limit (nvidia-smi); TF32 and
               reduced-precision bf16 matmul reductions off, so the plain
               versions accumulate in f32.
2. build    — nvcc builds every ``paddle_tpu_torch/csrc/*.cu`` for sm_90a.
3. kernels  — each kernel against its plain PyTorch version on the card,
               in bf16 at the Llama-3-8B shapes of the serving paths, with
               kernel / plain / library times and the least time the card
               could take (``bound_ms``): K1, K2, K3 (bf16), then K4
               (weight-only int8, and one int4 group-128 shape), K2 with
               int8 weights and K3 on an int8 cache (page 32).
4. serving  — Llama-3-8B (all 32 layers, full width, seeded random bf16
               weights) greedy ``generate_paged`` for B=8, prompt 128,
               32 new tokens; the kernels' launch counts must equal the
               fully fused plan's; the logits of every generated position
               (prefill and each decode step) are held against a plain
               teacher-forced forward in f32, with the plain bf16 forward
               as the yardstick and two controls (fp16, a K3-style
               fault); timing is the median of 5 full rollouts.
5. serving, int8w+int8kv — the same model quantized on the card
               (``quantize_for_inference``: int8 weights, per-channel
               scales), served with ``cache_dtype="int8"``, page 32; the
               counts must equal 32 K1 + 161 K2 + 64 K4 per prefill and
               32 K3 + 161 K2 + 64 K4 per decode step; the logits are held
               against the plain forward of the quantized function (int8
               weights dequantized per call, decode attention over
               quantize->dequantized K/V) in the same way.
6. result   — a ``{"kernels": [...]}`` line, then the last line
               ``{"ok": true, "device": {...}}``.

Needs a CUDA device and the CUDA toolkit; imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16 tensor-core
# FLOP/s, f32 (non-tensor) FLOP/s
HBM_BYTES_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

SEED = 0
B, PROMPT, NEW = 8, 128, 32
PAGE = 16
PAGE_INT8 = 32     # the int8 cache's page (docs/SERVING.md: page_size=32)
ROLLOUTS = 5       # timed full rollouts (and prefills); medians reported


def log(*a):
    print(*a, flush=True)


def bound(nbytes, flops, peak):
    """(least ms for this work, what bounds it)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


class ColdTimer:
    """Per-call device time from CUDA events, L2 flushed before each call
    (every call on the serving path reads its weights or pages cold). A
    spin kernel holds the stream while the host enqueues the start event,
    the call and the end event, so the host's time in the wrapper is not
    counted as device time."""

    SPIN_CYCLES = 2_000_000          # ~1 ms at H100 clocks

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, iters=20, warmup=2):
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(self.SPIN_CYCLES)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        return statistics.median(times)


def check_flash(torch, timer, k1):
    """K1 at the prefill shape: B=8, S=128, H=32, Hk=8, D=128, causal."""
    b, s, h, hk, d = B, PROMPT, 32, 8, 128
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    q, k, v = (torch.randn((b, s, n, d), generator=g, device="cuda",
                           dtype=torch.bfloat16) for n in (h, hk, hk))
    out, lse = k1.flash_attention_fwd(q, k, v, causal=True)
    ref, ref_lse = k1.flash_attention_fwd_reference(q, k, v, causal=True)
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    # per element: one bf16 ulp of the output plus the two versions'
    # different p roundings, 2^-7 * (P @ |V|) (k1.fwd_tolerance says why).
    # lse sums f32 probabilities in both: only the summation order differs.
    tol = k1.fwd_tolerance(q, k, v, ref, causal=True)
    assert bool((diff <= tol).all()), (
        f"flash out max_abs_err {err}, worst err/tol "
        f"{(diff / tol).max().item():.3f}")
    log(f"K1 worst err/tol {(diff / tol).max().item():.3f}, tol range "
        f"{tol.min().item():.2e}..{tol.max().item():.2e}")
    assert lse_err <= 1e-3, f"flash lse max_abs_err {lse_err}"
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    kt, vt = (x.repeat_interleave(h // hk, dim=1) for x in (kt, vt))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms = timer(lambda: k1.flash_attention_fwd(q, k, v, causal=True))
    plain = timer(lambda: k1.flash_attention_fwd_reference(q, k, v, True))
    lib = timer(lambda: sdpa(qt, kt, vt, is_causal=True))
    pairs = sum(min(s, i + 1) for i in range(s))          # causal, offset 0
    flops = 4 * d * pairs * b * h
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + out.numel()) \
        + 4 * lse.numel()
    bms, by = bound(nbytes, flops, BF16_FLOPS)
    log(f"K1 flash_attention_fwd B{b} S{s} H{h}/{hk}: max_abs_err {err:.3e} "
        f"lse_err {lse_err:.3e} kernel_ms {ms:.4f} plain_ms {plain:.4f} "
        f"library_ms {lib:.4f} (SDPA) bound_ms {bms:.4f} ({by})")
    return {"name": "flash_attention_fwd", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/flash_attention.cu",
            "replaces": "paddle_tpu/ops/pallas/flash_attention.py:481",
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bms, "bound_by": by, "library_ms": lib,
            "shape": f"B{b} S{s} H{h} Hk{hk} D{d} causal"}


NM_SHAPES = [(8, 4096, 14336), (8, 4096, 4096), (8, 4096, 1024),
             (8, 4096, 128256), (1024, 4096, 14336), (1024, 4096, 4096),
             (1024, 4096, 1024)]


def check_norm_matmul(torch, timer, k2):
    """K2 at every decode (M=8) and prefill (M=1024) projection shape."""
    eps = 1e-5
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    rows, errs = [], []
    rms_norm = getattr(torch.nn.functional, "rms_norm", None)
    for m, kdim, n in NM_SHAPES:
        x = torch.randn((m, kdim), generator=g, device="cuda",
                        dtype=torch.bfloat16)
        nw = (torch.rand((kdim,), generator=g, device="cuda") + 0.5).to(
            torch.bfloat16)
        w = (torch.randn((kdim, n), generator=g, device="cuda")
             / math.sqrt(kdim)).to(torch.bfloat16)
        y = k2.fused_norm_matmul_pure(x, nw, eps, w)
        ref = k2._reference(x, nw, eps, w)
        torch.cuda.synchronize()
        diff = (y.float() - ref.float()).abs()
        err = diff.max().item()
        # both round one f32 dot per element to bf16 (1 ulp = 2^-8
        # relative); the f32 sums differ only in order, and rstd may
        # differ by 1 f32 ulp: |err| <= 1e-2 * |ref| + 2e-2
        ok = bool((diff <= 2e-2 + 1e-2 * ref.float().abs()).all())
        assert ok, f"norm_matmul {m}x{kdim}x{n} max_abs_err {err}"
        ms = timer(lambda: k2.fused_norm_matmul_pure(x, nw, eps, w))
        plain = timer(lambda: k2._reference(x, nw, eps, w))
        lib = (timer(lambda: torch.matmul(rms_norm(x, (kdim,), nw, eps), w))
               if rms_norm is not None else None)
        nbytes = 2 * (m * kdim + kdim + kdim * n + m * n)
        bms, by = bound(nbytes, 2 * m * n * kdim, BF16_FLOPS)
        log(f"K2 norm_matmul M{m} K{kdim} N{n}: max_abs_err {err:.3e} "
            f"kernel_ms {ms:.4f} plain_ms {plain:.4f} library_ms "
            f"{lib if lib is None else round(lib, 4)} (rms_norm+matmul) "
            f"bound_ms {bms:.4f} ({by})")
        rows.append({"shape": f"M{m} K{kdim} N{n}", "max_abs_err": err,
                     "ms": ms, "plain_ms": plain, "bound_ms": bms,
                     "bound_by": by, "library_ms": lib})
        errs.append(err)
        del x, w, y, ref, diff
    head = rows[0]  # the decode gate/up shape stands for the kernel
    return {"name": "norm_matmul", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/norm_matmul.cu",
            "replaces": "paddle_tpu/ops/pallas/fused_norm_matmul.py:128",
            "also_replaces": "paddle_tpu/ops/pallas/fused_norm_matmul.py:225",
            "max_abs_err": max(errs), "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "shape": head["shape"], "shapes": rows}


def check_rope_attend(torch, timer, k3, kv_cache, rope_tables):
    """K3 at the first decode step's shape: B=8, H=32, Hk=8, D=128, page
    16, seq_lens 128 (tests/test_torch_cuda_kernels.py covers other cell
    offsets)."""
    b, h, hk, d, n_layers, layer = B, 32, 8, 128, 2, 1
    cap = PROMPT + NEW
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    cache = kv_cache.create_paged_cache(n_layers, b, cap, hk, d, PAGE,
                                        dtype=torch.bfloat16, device="cuda")
    for pool in (cache.k_pages, cache.v_pages):
        pool.copy_(torch.randn(pool.shape, generator=g, device="cuda"))
    lens = torch.full((b,), PROMPT, device="cuda", dtype=torch.int32)
    cache = cache._replace(seq_lens=lens)
    q = torch.randn((b, h, d), generator=g, device="cuda",
                    dtype=torch.bfloat16)
    k, v = (torch.randn((b, hk, d), generator=g, device="cuda",
                        dtype=torch.bfloat16) for _ in range(2))
    cos_t, sin_t = rope_tables(cap, d, 500000.0, device="cuda")
    cos, sin = cos_t[lens.long()], sin_t[lens.long()]

    def clone(c):
        return c._replace(k_pages=c.k_pages.clone(),
                          v_pages=c.v_pages.clone())

    ck, cp = clone(cache), clone(cache)
    out, ck = k3.fused_rope_append_attend_decode(q, k, v, cos, sin, ck,
                                                 layer)
    ref, cp = k3.decode_reference(q, k, v, cos, sin, cp, layer)
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    # attention in f32 in both (order differs), one bf16 output rounding
    assert bool((diff <= 1e-2 + 1e-2 * ref.float().abs()).all()), \
        f"rope_append_attend out max_abs_err {err}"
    # the written cells: each rope product and the sum are separately
    # rounded f32 ops in both versions, so the pools must match bit for bit
    pool_diff = int((ck.k_pages != cp.k_pages).sum()
                    + (ck.v_pages != cp.v_pages).sum())
    assert pool_diff == 0, f"{pool_diff} pool cells differ"
    ms = timer(lambda: k3.fused_rope_append_attend_decode(
        q, k, v, cos, sin, ck, layer))
    plain = timer(lambda: k3.decode_reference(q, k, v, cos, sin, cp, layer))
    cells = int((lens + 1).sum().item())           # cells attended per head
    nbytes = (2 * (q.numel() + 2 * k.numel() + out.numel())
              + 4 * (cos.numel() + sin.numel())
              + 2 * 2 * (cells - b) * hk * d        # pages read (K and V)
              + 2 * 2 * b * hk * d                  # the new cells written
              + 4 * (cache.block_tables.numel() + b))
    flops = 4 * cells * h * d
    bms, by = bound(nbytes, flops, F32_FLOPS)
    log(f"K3 rope_append_attend_decode B{b} H{h}/{hk} page{PAGE} lens "
        f"{lens.tolist()}: max_abs_err {err:.3e} pool cells differing "
        f"{pool_diff} kernel_ms {ms:.4f} plain_ms {plain:.4f} bound_ms "
        f"{bms:.4f} ({by})")
    return {"name": "rope_append_attend_decode", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/rope_append_attend.cu",
            "replaces": "paddle_tpu/ops/pallas/fused_rope_attend.py:441",
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bms, "bound_by": by, "library_ms": None,
            "shape": f"B{b} H{h} Hk{hk} D{d} page{PAGE} seq_lens{PROMPT}"}


QMM_SHAPES = [(8, 4096, 4096, "int8", -1), (8, 14336, 4096, "int8", -1),
              (1024, 4096, 4096, "int8", -1),
              (1024, 14336, 4096, "int8", -1),
              (8, 14336, 4096, "int4", 128)]


def _quantize(torch, g, kdim, n, wd="int8", gs=-1):
    """A seeded random (kdim, n) weight, quantized as quantize_for_inference
    does: (QuantizedWeight, the bf16 weight)."""
    from paddle_tpu_torch.ops.extra_vision import _weight_quantize_pure
    from paddle_tpu_torch.ops.kernels.quant_matmul import QuantizedWeight

    w = torch.randn((kdim, n), generator=g, device="cuda") / math.sqrt(kdim)
    codes, scales = _weight_quantize_pure(w, f"weight_only_{wd}", gs)
    return QuantizedWeight(codes, scales, wd, gs, (kdim, n)), w.to(
        torch.bfloat16)


def check_quant_matmul(torch, timer, k4):
    """K4 at the o_proj and down_proj shapes of decode (M=8) and prefill
    (M=1024), int8 per channel, and one decode shape int4 group 128."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    rows, errs = [], []
    for m, kdim, n, wd, gs in QMM_SHAPES:
        x = torch.randn((m, kdim), generator=g, device="cuda",
                        dtype=torch.bfloat16)
        qw, wb = _quantize(torch, g, kdim, n, wd, gs)
        args = (qw.codes, qw.scales, wd, gs)
        y = k4.quant_matmul_pure(x, *args)
        ref = k4.quant_matmul_reference(x, *args)
        torch.cuda.synchronize()
        diff = (y.float() - ref.float()).abs()
        err = diff.max().item()
        # the kernel scales the exact code sums, the plain version rounds
        # each code * scale to bf16 first (k4.tolerance derives the bound)
        tol = k4.tolerance(x, *args, ref)
        worst = (diff / tol).max().item()
        assert worst <= 1, (f"quant_matmul {m}x{kdim}x{n} {wd} g{gs} "
                            f"max_abs_err {err}, worst err/tol {worst:.3f}")
        ms = timer(lambda: k4.quant_matmul_pure(x, *args))
        plain = timer(lambda: k4.quant_matmul_reference(x, *args))
        # library: dequant then torch.matmul, two calls (int8 per channel)
        lib = (timer(lambda: x @ (qw.codes.to(torch.bfloat16)
                                  * qw.scales.to(torch.bfloat16)))
               if (wd, gs) == ("int8", -1) else None)
        dense = timer(lambda: x @ wb)
        nbytes = (2 * m * kdim + qw.codes.numel() + 4 * qw.scales.numel()
                  + 2 * m * n)
        bms, by = bound(nbytes, 2 * m * n * kdim, BF16_FLOPS)
        log(f"K4 quant_matmul M{m} K{kdim} N{n} {wd} g{gs}: max_abs_err "
            f"{err:.3e} (worst err/tol {worst:.3f}) kernel_ms {ms:.4f} "
            f"plain_ms {plain:.4f} library_ms "
            f"{lib if lib is None else round(lib, 4)} (dequant + matmul) "
            f"bf16_matmul_ms {dense:.4f} bound_ms {bms:.4f} ({by})")
        rows.append({"shape": f"M{m} K{kdim} N{n} {wd} g{gs}",
                     "max_abs_err": err, "err_over_tol": worst, "ms": ms,
                     "plain_ms": plain, "bound_ms": bms, "bound_by": by,
                     "library_ms": lib, "bf16_matmul_ms": dense})
        errs.append(err)
        del x, qw, wb, y, ref, diff, tol
    head = rows[1]  # the decode down_proj shape stands for the kernel
    return {"name": "quant_matmul", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/quant_matmul.cu",
            "replaces": "paddle_tpu/ops/pallas/quant_matmul.py:181",
            "max_abs_err": max(errs), "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "shape": head["shape"], "shapes": rows}


NM_INT8_SHAPES = [(8, 4096, 14336), (8, 4096, 4096), (8, 4096, 1024),
                  (8, 4096, 128256), (1024, 4096, 14336)]


def check_norm_matmul_int8(torch, timer, k2):
    """K2 with int8 weights (per channel) at the decode shapes and the
    prefill gate/up shape. The kernel dequantizes each weight exactly as
    the plain chain does, so only the summation order differs."""
    eps = 1e-5
    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    rows, errs = [], []
    rms_norm = getattr(torch.nn.functional, "rms_norm", None)
    for m, kdim, n in NM_INT8_SHAPES:
        x = torch.randn((m, kdim), generator=g, device="cuda",
                        dtype=torch.bfloat16)
        nw = (torch.rand((kdim,), generator=g, device="cuda") + 0.5).to(
            torch.bfloat16)
        qw, _ = _quantize(torch, g, kdim, n)
        y = k2.fused_norm_matmul_pure(x, nw, eps, qw)
        ref = k2._reference(x, nw, eps, qw)
        torch.cuda.synchronize()
        diff = (y.float() - ref.float()).abs()
        err = diff.max().item()
        # as K2 dense: one bf16 output rounding in both, f32 sums in a
        # different order, rstd within 1 f32 ulp
        ok = bool((diff <= 2e-2 + 1e-2 * ref.float().abs()).all())
        assert ok, f"norm_matmul int8 {m}x{kdim}x{n} max_abs_err {err}"
        ms = timer(lambda: k2.fused_norm_matmul_pure(x, nw, eps, qw))
        plain = timer(lambda: k2._reference(x, nw, eps, qw))
        lib = (timer(lambda: torch.matmul(
            rms_norm(x, (kdim,), nw, eps),
            qw.codes.to(torch.bfloat16) * qw.scales.to(torch.bfloat16)))
            if rms_norm is not None else None)
        nbytes = (2 * (m * kdim + kdim + m * n) + qw.codes.numel()
                  + 4 * qw.scales.numel())
        bms, by = bound(nbytes, 2 * m * n * kdim, BF16_FLOPS)
        log(f"K2 norm_matmul int8 M{m} K{kdim} N{n}: max_abs_err {err:.3e} "
            f"kernel_ms {ms:.4f} plain_ms {plain:.4f} library_ms "
            f"{lib if lib is None else round(lib, 4)} (rms_norm + dequant "
            f"+ matmul) bound_ms {bms:.4f} ({by})")
        rows.append({"shape": f"M{m} K{kdim} N{n} int8", "max_abs_err": err,
                     "ms": ms, "plain_ms": plain, "bound_ms": bms,
                     "bound_by": by, "library_ms": lib})
        errs.append(err)
        del x, qw, y, ref, diff
    head = rows[0]  # the decode gate/up shape stands for the kernel
    return {"name": "norm_matmul_int8", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/norm_matmul.cu",
            "replaces": "paddle_tpu/ops/pallas/fused_norm_matmul.py:128",
            "also_replaces": "paddle_tpu/ops/pallas/fused_norm_matmul.py:225",
            "max_abs_err": max(errs), "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "shape": head["shape"], "shapes": rows}


def check_rope_attend_int8(torch, timer, k3, kv_cache, rope_tables):
    """K3 on an int8 cache: B=8, H=32, Hk=8 (g=4), page 32, lengths near
    160 across page boundaries, pools filled by the int8 prefill from
    random K/V. Output, the written cells' codes and scales, every other
    cell untouched."""
    b, h, hk, d, n_layers, layer = B, 32, 8, 128, 2, 1
    cap = PROMPT + NEW
    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    cache = kv_cache.create_paged_cache(n_layers, b, cap, hk, d, PAGE_INT8,
                                        dtype=torch.int8, device="cuda")
    lens = torch.tensor([159, 151, 144, 136, 129, 128, 127, 120],
                        device="cuda", dtype=torch.int32)
    for i in range(n_layers):
        kv = torch.randn((2, b, cap, hk, d), generator=g, device="cuda",
                         dtype=torch.bfloat16)
        cache = kv_cache.prefill_paged_cache(cache, i, kv[0], kv[1], lens)
    q = torch.randn((b, h, d), generator=g, device="cuda",
                    dtype=torch.bfloat16)
    k, v = (torch.randn((b, hk, d), generator=g, device="cuda",
                        dtype=torch.bfloat16) for _ in range(2))
    cos_t, sin_t = rope_tables(cap, d, 500000.0, device="cuda")
    cos, sin = cos_t[lens.long()], sin_t[lens.long()]
    pools = ("k_pages", "v_pages", "k_scales", "v_scales")

    def clone(c):
        return c._replace(**{n: getattr(c, n).clone() for n in pools})

    ck, cp = clone(cache), clone(cache)
    out, ck = k3.fused_rope_append_attend_decode(q, k, v, cos, sin, ck,
                                                 layer)
    ref, cp = k3.decode_reference(q, k, v, cos, sin, cp, layer)
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    assert bool((diff <= 1e-2 + 1e-2 * ref.float().abs()).all()), \
        f"rope_append_attend int8 out max_abs_err {err}"
    # written cells: the rotated k rounds bit-exactly as in the plain
    # chain and both quantize with IEEE division and round-half-even, so
    # codes and scales should match exactly; the JAX package allows 1 code
    code_diff = 0
    for name in ("k_pages", "v_pages"):
        dq = (getattr(ck, name).int() - getattr(cp, name).int()).abs()
        assert int(dq.max()) <= 1, f"{name}: a code differs by > 1"
        code_diff += int((dq > 0).sum())
    scale_diff = sum(int((getattr(ck, n) != getattr(cp, n)).sum())
                     for n in ("k_scales", "v_scales"))
    assert scale_diff == 0, f"{scale_diff} scales differ"
    written = torch.zeros(cache.k_scales.shape, dtype=torch.bool,
                          device="cuda")
    rows = torch.arange(b, device="cuda")
    phys = cache.block_tables[rows, (lens // PAGE_INT8).long()].long()
    written[layer, :, phys, (lens % PAGE_INT8).long()] = True
    for name in pools:
        keep = (~written).expand_as(getattr(cache, name))
        assert torch.equal(getattr(ck, name)[keep],
                           getattr(cache, name)[keep]), \
            f"{name}: a cell other than the new ones changed"
    ms = timer(lambda: k3.fused_rope_append_attend_decode(
        q, k, v, cos, sin, ck, layer))
    plain = timer(lambda: k3.decode_reference(q, k, v, cos, sin, cp, layer))
    cells = int((lens + 1).sum().item())           # cells attended per head
    cell_bytes = d + 4                             # int8 codes + f32 scale
    nbytes = (2 * (q.numel() + 2 * k.numel() + out.numel())
              + 4 * (cos.numel() + sin.numel())
              + 2 * (cells - b) * hk * cell_bytes  # pages read (K and V)
              + 2 * b * hk * cell_bytes            # the new cells written
              + 4 * (cache.block_tables.numel() + b))
    flops = 4 * cells * h * d
    bms, by = bound(nbytes, flops, F32_FLOPS)
    log(f"K3 rope_append_attend_decode int8 B{b} H{h}/{hk} page{PAGE_INT8} "
        f"lens {lens.tolist()}: max_abs_err {err:.3e} codes differing "
        f"{code_diff} scales differing {scale_diff} kernel_ms {ms:.4f} "
        f"plain_ms {plain:.4f} bound_ms {bms:.4f} ({by})")
    return {"name": "rope_append_attend_decode_int8", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/rope_append_attend.cu",
            "replaces": "paddle_tpu/ops/pallas/fused_rope_attend.py:441",
            "max_abs_err": err, "codes_differing": code_diff,
            "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
            "library_ms": None,
            "shape": f"B{b} H{h} Hk{hk} D{d} page{PAGE_INT8} int8 "
                     f"seq_lens{lens.tolist()}"}


def _kernel_class(name):
    if "flash_fwd_kernel" in name:
        return "K1 flash_attention_fwd"
    mm = re.search(r"matmul_(?:small|tiled)_kernel<([^>]*)>", name)
    if mm:  # template arguments end with NORM, weight type, scale mode
        norm, wt = (a.strip() for a in mm.group(1).split(",")[-3:-1])
        wd = {"0": "bf16", "1": "int8", "2": "int4"}.get(wt, wt)
        return (f"K2 norm_matmul ({wd})" if norm == "true"
                else f"K4 quant_matmul ({wd})")
    if "matmul_small_kernel" in name or "matmul_tiled_kernel" in name:
        return "K2/K4 matmul"
    if "rope_append_attend_kernel" in name:
        return "K3 rope_append_attend"
    if "gemm" in name or "nvjet" in name or "cutlass" in name \
            or "xmma" in name:
        return "cuBLAS matmul (o_proj, down_proj)"
    return "other (elementwise, gather, argmax, copies)"


def profile_window(torch, fn, label):
    """Device time by kernel class, and the device's busy share of the
    window's wall time, from a torch.profiler trace of ``fn()``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, by_class = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        cls = _kernel_class(e.name)
        n, t = by_class.get(cls, (0, 0.0))
        by_class[cls] = (n + 1, t + (end - start))
    if not spans:
        log(f"profile {label}: the trace holds no device events; device "
            f"time not measured")
        return None
    spans.sort()
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s_, e_ in spans[1:]:
        if s_ > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s_, e_
        else:
            cur_e = max(cur_e, e_)
    busy += cur_e - cur_s
    total = sum(t for _, t in by_class.values())
    log(f"profile {label}: wall {wall_us / 1e3:.2f} ms, device busy "
        f"{busy / 1e3:.2f} ms ({100 * busy / wall_us:.1f}% of wall), "
        f"kernel time {total / 1e3:.2f} ms")
    for cls, (n, t) in sorted(by_class.items(), key=lambda kv: -kv[1][1]):
        log(f"  {cls}: {n} launches, {t / 1e3:.3f} ms "
            f"({100 * t / total:.1f}%)")
    return {"wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3,
            "by_class_ms": {c: t / 1e3 for c, (_, t) in by_class.items()}}


def attention_missing_own_cell(q, k, v, causal=True, scale=None):
    """A fault control for the serving check, never used by the port: the
    plain attention with p kept in f32 (as K3 does), where every query
    from position PROMPT on (the decode steps) misses its own key, the
    cell it has just appended -- the fault K3 would have if it read that
    cell before its write landed."""
    import torch

    b, s, h, d = q.shape
    g = h // k.shape[2]
    kr, vr = (x.repeat_interleave(g, dim=2).float() for x in (k, v))
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr)
    logits = logits * (scale or 1.0 / math.sqrt(d))
    i = torch.arange(s, device=q.device)
    keep = (i[None, :] <= i[:, None]) & ~(
        (i[:, None] >= PROMPT) & (i[None, :] == i[:, None]))
    p = logits.masked_fill(~keep, -1e30).softmax(dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vr).to(q.dtype)


def check_logits(logits, ref_f32, ref_bf16, ctl_fp16, ctl_fault, label):
    """The counted run's logits at every generated position against the
    plain f32 forward, with the plain bf16 forward as the yardstick and the
    two controls; returns the readings."""
    steps = NEW - 1

    def rel_err(a):
        """Per position: the largest row relative L2 error against f32."""
        return ((a - ref_f32).norm(dim=-1) / ref_f32.norm(dim=-1)).amax(0)

    rel_k, rel_p, rel_16, rel_f = (rel_err(a) for a in
                                   (logits, ref_bf16, ctl_fp16, ctl_fault))
    ratio = rel_k / rel_p
    readings = {
        "kernel_vs_f32": rel_k.tolist(), "plain_bf16_vs_f32": rel_p.tolist(),
        "kernel_over_plain": ratio.tolist(),
        "control_fp16_over_plain": (rel_16 / rel_p).tolist(),
        "control_fault_over_plain": (rel_f / rel_p).tolist()}
    log(f"{label}: logits vs the plain f32 forward, max row rel L2 err "
        f"(prefill, decode steps 1..{steps}): kernel path "
        f"{rel_k[0]:.3e} / max {rel_k[1:].max():.3e}; plain bf16 "
        f"{rel_p[0]:.3e} / max {rel_p[1:].max():.3e}; kernel/plain ratio "
        f"max {ratio.max():.3f} min {ratio.min():.3f}; controls over plain "
        f"bf16, max: fp16 {(rel_16 / rel_p).max():.3f}, missing own cell "
        f"{(rel_f / rel_p).max():.3f}; argmax agreement with f32 kernel "
        f"{(logits.argmax(-1) == ref_f32.argmax(-1)).float().mean():.3f} "
        f"plain bf16 {(ref_bf16.argmax(-1) == ref_f32.argmax(-1)).float().mean():.3f}")
    # Both bf16 paths round activations to bf16 (2^-9 relative) at every
    # op, in different places and orders, and 32 random-weight layers
    # amplify that noise: the plain bf16 path is the yardstick. At every
    # generated position the kernel path must be no further from the f32
    # computation than twice the plain bf16 path's distance (independent
    # rounding patterns of equal size give a ratio near 1).
    assert bool((ratio <= 2).all()), \
        f"{label}: kernel/plain bf16 error ratio {ratio}"
    return readings


def drive(torch, kernels, model, ids, expected, label, profile, **kw):
    """One serving path's main-path run: a full-length warm-up, then THE
    counted ``generate_paged`` run (the launch counters must equal
    ``expected``), its outputs checked, then the medians of ROLLOUTS full
    rollouts and of ROLLOUTS prefills, with their spread, and the peak
    memory from the counted run on. ``profile``: also trace a prefill and
    a full rollout with torch.profiler. Returns (counts, tokens, logits,
    stats)."""
    vocab = model.config.vocab_size
    steps = NEW - 1

    def timed_generate(n_new):
        torch.cuda.synchronize()
        t = time.perf_counter()
        model.generate_paged(ids, max_new_tokens=n_new, **kw)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    timed_generate(NEW)                        # warm-up at the full length
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    out, logits = model.generate_paged(        # THE counted main-path run
        ids, max_new_tokens=NEW, return_logits=True, **kw)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    log(f"{label}: launches {counts} expected {expected}")
    assert counts == expected, f"launch counts {counts} != plan {expected}"

    assert tuple(out.shape) == (B, PROMPT + NEW), out.shape
    assert out.dtype == torch.int32
    assert bool((out[:, :PROMPT] == ids).all()), "prompt not echoed"
    assert bool(((out >= 0) & (out < vocab)).all()), "bad token ids"
    assert tuple(logits.shape) == (B, NEW, vocab), logits.shape
    assert bool(torch.isfinite(logits).all()), "non-finite logits"
    assert bool((logits.argmax(-1).to(torch.int32) == out[:, PROMPT:]).all()
                ), "tokens are not the argmax of their logits"

    totals = [timed_generate(NEW) for _ in range(ROLLOUTS)]
    prefills = [timed_generate(1) for _ in range(ROLLOUTS)]
    total_ms, prefill_ms = statistics.median(totals), statistics.median(
        prefills)
    decode_ms = total_ms - prefill_ms
    tok_s = B * steps / (decode_ms / 1e3)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"{label}: generate_paged B{B} prompt {PROMPT} new {NEW} page "
        f"{kw['page_size']}, {ROLLOUTS} runs each: total_ms "
        f"{[round(t, 1) for t in totals]} (median {total_ms:.1f}), "
        f"prefill_ms {[round(t, 1) for t in prefills]} (median "
        f"{prefill_ms:.1f}); decode {decode_ms / steps:.2f} ms/step, "
        f"{tok_s:.1f} tok/s; max_memory_allocated {peak_gib:.2f} GiB")
    if profile:
        with torch.inference_mode():
            profile_window(torch, lambda: model.generate_paged(
                ids, max_new_tokens=1, **kw), f"{label} prefill")
            profile_window(torch, lambda: model.generate_paged(
                ids, max_new_tokens=NEW, **kw),
                f"{label} prefill + {steps} decode steps")
    return counts, out, logits, {
        "prefill_ms": prefill_ms, "prefill_ms_runs": prefills,
        "decode_tok_s": tok_s, "total_ms": total_ms, "total_ms_runs": totals,
        "max_memory_allocated_gib": peak_gib}


def prompt_ids(torch, cfg):
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    return torch.randint(0, cfg.vocab_size, (B, PROMPT), generator=g,
                         device="cuda")


def serve(torch, kernels, profile=False):
    """Llama-3-8B greedy generate_paged at full width on the card."""
    from paddle_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                               prompt_logits_pure)
    from paddle_tpu_torch.ops.kernels import flash_attention as k1
    from paddle_tpu_torch.ops.kernels import fusion

    cfg = LlamaConfig.llama3_8b(dtype="bfloat16")
    L = cfg.num_hidden_layers
    steps = NEW - 1
    # the main path is the fully fused plan: every norm -> matmul in K2,
    # every decode attend tail in K3 (a flag that turns a fusion off makes
    # the port raise on the card rather than run plain ops)
    assert fusion.enabled_fusions() == fusion.FUSIONS, (
        f"fusion flags not at their defaults: {fusion.enabled_fusions()}")
    plan = fusion.planned_kernel_launches(L, enabled=fusion.FUSIONS)
    # per token: q, k, v, gate, up in every layer plus the head; one K3
    # per layer
    assert plan == {"norm_matmul": 5 * L + 1, "rope_append_attend": L}, plan
    expected = {"flash_attention": L,
                "fused_norm_matmul": plan["norm_matmul"] * (1 + steps),
                "fused_rope_attend": plan["rope_append_attend"] * steps,
                "quant_matmul": 0}

    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, seed=SEED)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"serving: Llama-3-8B {L} layers, "
        f"{n_params / 1e9:.3f}B params bf16, init "
        f"{time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB; plan per token "
        f"{plan}, kernel_launches_per_token "
        f"{fusion.kernel_launches_per_token(L, fused=True)}")
    counts, out, logits, stats = drive(torch, kernels, model,
                                       prompt_ids(torch, cfg), expected,
                                       "serving", profile, page_size=PAGE)

    # ---- end-to-end check: the counted run's logits at every generated
    # position (prefill and all 31 decode steps) against one teacher-forced
    # plain forward over the tokens it produced (plain attention, no
    # paged cache, no kernel), in f32 as the yardstick and in bf16
    seq = out[:, :PROMPT + NEW - 1].long()
    prms = model.param_dict()

    def plain_logits(params):
        return prompt_logits_pure(params, seq, cfg, plain=True)[
            :, PROMPT - 1:].float()

    with torch.inference_mode():
        ref_bf16 = plain_logits(prms)
        fault_attention, k1._reference_attention = (
            k1._reference_attention, attention_missing_own_cell)
        try:
            ctl_fault = plain_logits(prms)
        finally:
            k1._reference_attention = fault_attention
        ctl_fp16 = plain_logits({n: p.half() for n, p in prms.items()})
        ref_f32 = plain_logits({n: p.float() for n, p in prms.items()})

    stats["logits_check"] = check_logits(logits, ref_f32, ref_bf16, ctl_fp16,
                                         ctl_fault, "serving")
    return counts, stats


def int8_cache_attention(reference):
    """A plain attention for the teacher-forced reference of the int8w+
    int8kv path, built on ``reference`` (an attention with
    ``_reference_attention``'s signature): the prompt's queries see fp K/V,
    as the prefill's flash attention does; every query from position
    PROMPT on (the decode steps) sees each key and value cell quantized to
    int8 and dequantized, as the int8 cache serves it."""
    import torch
    from paddle_tpu_torch.models.kv_cache import quantize_cells

    def qdq(x):
        codes, scales = quantize_cells(x)     # per (b, s, head) cell
        return (codes.float() * scales).to(x.dtype)

    def attention(q, k, v, causal=True, scale=None):
        fp = reference(q, k, v, causal, scale)
        cached = reference(q, qdq(k), qdq(v), causal, scale)
        return torch.cat([fp[:, :PROMPT], cached[:, PROMPT:]], dim=1)

    return attention


def serve_int8(torch, kernels, profile=False):
    """Llama-3-8B int8w+int8kv greedy generate_paged at full width: the
    phase-1 model quantized on the card (int8 weights, per-channel scales),
    its bf16 matmul weights then freed, served with an int8 paged cache at
    page 32."""
    from paddle_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                               prompt_logits_pure,
                                               quantize_for_inference)
    from paddle_tpu_torch.ops.kernels import flash_attention as k1
    from paddle_tpu_torch.ops.kernels import fusion
    from paddle_tpu_torch.ops.kernels.quant_matmul import QuantizedWeight

    cfg = LlamaConfig.llama3_8b(dtype="bfloat16")
    L = cfg.num_hidden_layers
    steps = NEW - 1
    assert fusion.enabled_fusions() == fusion.FUSIONS, (
        f"fusion flags not at their defaults: {fusion.enabled_fusions()}")
    plan = fusion.planned_kernel_launches(L, enabled=fusion.FUSIONS,
                                          quantized=True)
    # per token: K2 for q, k, v, gate, up in every layer plus the head, K4
    # for o_proj and down_proj, one K3 per layer
    assert plan == {"norm_matmul": 161, "rope_append_attend": 32,
                    "quant_matmul": 64}, plan
    # 32 K1 + 161 K2 + 64 K4 per prefill, 32 K3 + 161 K2 + 64 K4 per step
    expected = {"flash_attention": 32,
                "fused_norm_matmul": 161 * (1 + steps),
                "fused_rope_attend": 32 * steps,
                "quant_matmul": 64 * (1 + steps)}

    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, seed=SEED)
    qparams = quantize_for_inference(model)
    for name, p in model.named_parameters():
        if isinstance(qparams[name], QuantizedWeight):
            p.data = p.data.new_empty(0)     # the int8 model keeps codes
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    n_q = sum(isinstance(p, QuantizedWeight) for p in qparams.values())
    q_bytes = sum(p.nbytes if isinstance(p, QuantizedWeight)
                  else p.numel() * p.element_size()
                  for p in qparams.values())
    log(f"serving int8w+int8kv: Llama-3-8B {L} layers, {n_q} weights "
        f"quantized on the card (int8, per channel) in "
        f"{time.perf_counter() - t0:.1f}s; params {q_bytes / 1e9:.3f} GB, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated; plan "
        f"per token {plan}")
    counts, out, logits, stats = drive(
        torch, kernels, model, prompt_ids(torch, cfg), expected,
        "serving int8w+int8kv", profile, page_size=PAGE_INT8,
        params=qparams, cache_dtype="int8")
    stats["params_gb"] = q_bytes / 1e9

    # ---- the counted run's logits against the teacher-forced plain
    # forward of the quantized function: plain dequant-matmuls (into the
    # activations' dtype, so the f32 forward dequantizes into f32 per call)
    # and int8_cache_attention
    seq = out[:, :PROMPT + NEW - 1].long()
    plain_attention = k1._reference_attention

    def plain_logits(dtype, attention):
        prms = {n: p if isinstance(p, QuantizedWeight) else p.to(dtype)
                for n, p in qparams.items()}
        k1._reference_attention = attention
        try:
            return prompt_logits_pure(prms, seq, cfg, plain=True)[
                :, PROMPT - 1:].float()
        finally:
            k1._reference_attention = plain_attention

    with torch.inference_mode():
        int8_attention = int8_cache_attention(plain_attention)
        ref_bf16 = plain_logits(torch.bfloat16, int8_attention)
        ctl_fault = plain_logits(torch.bfloat16, int8_cache_attention(
            attention_missing_own_cell))
        ctl_fp16 = plain_logits(torch.float16, int8_attention)
        ref_f32 = plain_logits(torch.float32, int8_attention)
    stats["logits_check"] = check_logits(logits, ref_f32, ref_bf16, ctl_fp16,
                                         ctl_fault, "serving int8w+int8kv")
    return counts, stats


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from paddle_tpu_torch.models import kv_cache
    from paddle_tpu_torch.models.llama import _rope_tables
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import flash_attention as k1
    from paddle_tpu_torch.ops.kernels import fused_norm_matmul as k2
    from paddle_tpu_torch.ops.kernels import fused_rope_attend as k3
    from paddle_tpu_torch.ops.kernels import quant_matmul as k4

    # ---- 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    # ---- 2. build
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    log(f"build: {lib} in {time.perf_counter() - t0:.1f}s")
    for line in (lib.parent / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log("  " + line.strip())

    # ---- 3. kernels vs plain
    timer = ColdTimer(torch)
    rows = [check_flash(torch, timer, k1),
            check_norm_matmul(torch, timer, k2),
            check_rope_attend(torch, timer, k3, kv_cache, _rope_tables)]
    rows_int8 = [check_quant_matmul(torch, timer, k4),
                 check_norm_matmul_int8(torch, timer, k2),
                 check_rope_attend_int8(torch, timer, k3, kv_cache,
                                        _rope_tables)]
    del timer
    torch.cuda.empty_cache()

    # ---- 4. serving main path (bf16), then 5. int8w+int8kv; each row's
    # launches come from the run of its own path
    profile = "--profile" in sys.argv
    counts, stats = serve(torch, kernels, profile=profile)
    torch.cuda.empty_cache()
    counts_int8, stats_int8 = serve_int8(torch, kernels, profile=profile)
    by_module = {"flash_attention_fwd": "flash_attention",
                 "norm_matmul": "fused_norm_matmul",
                 "norm_matmul_int8": "fused_norm_matmul",
                 "rope_append_attend_decode": "fused_rope_attend",
                 "rope_append_attend_decode_int8": "fused_rope_attend",
                 "quant_matmul": "quant_matmul"}
    for row in rows:
        row["launches"] = counts[by_module[row["name"]]]
    rows[0]["launches_int8w_int8kv"] = counts_int8["flash_attention"]
    for row in rows_int8:
        row["launches"] = counts_int8[by_module[row["name"]]]
    rows += rows_int8
    log(f"max_memory_allocated while serving: bf16 "
        f"{stats['max_memory_allocated_gib']:.2f} GiB, int8w+int8kv "
        f"{stats_int8['max_memory_allocated_gib']:.2f} GiB")

    # ---- 6. result
    log(json.dumps({"serving": stats, "serving_int8w_int8kv": stats_int8}))
    log(json.dumps({"kernels": rows}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
