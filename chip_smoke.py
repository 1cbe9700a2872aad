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
               int8 weights and K3 on an int8 cache (page 32), then the
               continuous batcher's kernels on its mixed wave (T = 264
               rows: two prefill chunks, decode rows at lengths 97-600,
               an idle slot, padding rows): K11, K3's ragged form, K10
               and K3's masked decode form.
4. serving  — Llama-3-8B (all 32 layers, full width, seeded random bf16
               weights) greedy ``generate_paged`` for B=8, prompt 128,
               32 new tokens; the kernels' launch counts must equal the
               fully fused plan's; the logits of every generated position
               (prefill and each decode step) are held against a plain
               teacher-forced forward in f32, with the plain bf16 forward
               as the yardstick and two controls (fp16, a K3-style
               fault); timing is the median of 3 full rollouts.
5. serving, int8w+int8kv — the same model quantized on the card
               (``quantize_for_inference``: int8 weights, per-channel
               scales), served with ``cache_dtype="int8"``, page 32; the
               counts must equal 32 K1 + 161 K2 + 64 K4 per prefill and
               32 K3 + 161 K2 + 64 K4 per decode step; the logits are held
               against the plain forward of the quantized function (int8
               weights dequantized per call, decode attention over
               quantize->dequantized K/V) in the same way.
6. serving, continuous batching — the bf16 model through
               ``ContinuousBatcher(max_batch=8, max_seq=640, page_size=16,
               segment=16, prefill_chunk=256, prefix_caching=False)``: 24
               seeded requests (prompts 32-512 tokens, 16-64 new tokens,
               arrivals at segments 0-6), once in the default fused plan
               (32 K3-ragged per wave, 32 K3-masked per segment step) and
               once with ``fused_decode_fusions="norm_matmul"`` (32 K11
               per wave, 32 K10 per step); 161 K2 per wave or step in
               both. Every request must finish "ok" with exactly its
               max_new_tokens, no slot step wasted, the counts equal to
               the plan, and every emitted token must pass the
               teacher-forced rule (``check_batcher_tokens``), which two
               fault controls must fail; timing is the median of 3 runs
               after a warm-up.
7. result   — a ``{"kernels": [...]}`` line, then the last line
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
ROLLOUTS = 3       # timed full rollouts (and prefills); medians reported

# the continuous batcher's configuration (phase 6 and its kernels):
# ContinuousBatcher(max_batch=8, max_seq=640, page_size=16,
# prefill_chunk=256) -> waves of T = 264 rows, 40 pages per slot
BB, BSEQ, BCHUNK = 8, 640, 256
BT = -(-(BB + BCHUNK) // 8) * 8
# the kernels phase's mixed wave, by slot: old length and prompt chunk;
# slots 0 and 1 prefill 100 rows on 64 tokens of context and 156 rows
# from 0, slot WAVE_IDLE sits out (q_lens 0), the others decode one row at
# lengths 97-600 (across page boundaries); rows 0, 1 and 5 pad the wave
WAVE_SEQ = (64, 0, 96, 127, 255, 383, 511, 599)
WAVE_CHUNK = (100, 156, 0, 0, 0, 0, 0, 0)
WAVE_IDLE = 5
N_REQUESTS = 24


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
             (1024, 4096, 1024), (BT, 4096, 14336), (BT, 4096, 4096),
             (BT, 4096, 1024)]


def check_norm_matmul(torch, timer, k2):
    """K2 at every projection shape of a decode step (M=8), a solo
    prefill (M=1024) and a batcher wave (M=BT=264)."""
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
    ref, cp = k3.decode_reference(q, k, v, cos, sin, cp, layer,
                                   plain=True)
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
    plain = timer(lambda: k3.decode_reference(q, k, v, cos, sin, cp, layer,
                                   plain=True))
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
    ref, cp = k3.decode_reference(q, k, v, cos, sin, cp, layer,
                                   plain=True)
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
    plain = timer(lambda: k3.decode_reference(q, k, v, cos, sin, cp, layer,
                                   plain=True))
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


def attention_tolerance(ref, abs_ref):
    """Per element, for an attention kernel against its plain version on
    the same bf16 inputs: both take f32 scores, softmax and p @ V, in
    different orders, and round the output to bf16 once. So one bf16 ulp
    of the output (2^-7 |ref|) plus f32 order noise, bounded by 2^-12 of
    p @ |V| (``abs_ref``: the plain version with |V| in place of V, the
    same probabilities). Rows that are exact zeros in both (padding, no
    visible key) get a tiny floor, so err/tol reads 0 there."""
    return (2.0 ** -7 * ref.float().abs() + 2.0 ** -12 * abs_ref.float()
            ).clamp_min(1e-30)


def batcher_wave(torch, kv_cache, rope_tables, seed):
    """The kernels phase's mixed wave at the batcher's shapes: a 2-layer
    bf16 cache (B=8, Hk=8, page 16, 40 pages per slot) of random K/V at
    the old lengths WAVE_SEQ; the wave's rows (q (T, 32, 128), k, v
    (T, 8, 128), cos/sin (T, 128) at each row's position) and its layout
    (row_slot, row_pos, valid, page_lens, q_start, q_lens, fresh_lens) as
    ContinuousBatcher._build_ragged_step lays a wave out."""
    b, h, hk, d = BB, 32, 8, 128
    g = torch.Generator(device="cuda").manual_seed(seed)
    cache = kv_cache.create_paged_cache(2, b, BSEQ, hk, d, PAGE,
                                        dtype=torch.bfloat16, device="cuda")
    for pool in (cache.k_pages, cache.v_pages):
        pool.copy_(torch.randn(pool.shape, generator=g, device="cuda"))
    cache = cache._replace(seq_lens=torch.tensor(
        WAVE_SEQ, dtype=torch.int32, device="cuda"))
    row_slot, row_pos = [-1] * BT, [0] * BT
    q_start, q_lens, fresh, page_lens = [0] * b, [0] * b, [0] * b, [0] * b
    row = b
    for i, (seq, chunk) in enumerate(zip(WAVE_SEQ, WAVE_CHUNK)):
        if chunk:
            q_start[i], q_lens[i], fresh[i], page_lens[i] = (row, chunk,
                                                             chunk, seq)
            row_slot[row:row + chunk] = [i] * chunk
            row_pos[row:row + chunk] = range(seq, seq + chunk)
            row += chunk
        elif i != WAVE_IDLE:
            q_start[i], q_lens[i], page_lens[i] = i, 1, seq + 1
            row_slot[i], row_pos[i] = i, seq
    assert row == BT, row
    i32 = dict(dtype=torch.int32, device="cuda")
    rs, rp = torch.tensor(row_slot, **i32), torch.tensor(row_pos, **i32)
    wave = (rs, rp, rs >= 0, torch.tensor(page_lens, **i32),
            torch.tensor(q_start, **i32), torch.tensor(q_lens, **i32),
            torch.tensor(fresh, **i32))
    cos_t, sin_t = rope_tables(BSEQ, d, 500000.0, device="cuda")
    rows = tuple(torch.randn(shape, generator=g, device="cuda",
                             dtype=torch.bfloat16)
                 for shape in ((BT, h, d), (BT, hk, d), (BT, hk, d)))
    return cache, rows + (cos_t[rp.long()], sin_t[rp.long()]), wave


def _pool_copy(cache, **pools):
    """The cache with its own copy of its K/V pools (or the given ones)."""
    return cache._replace(k_pages=pools.get("k", cache.k_pages).clone(),
                          v_pages=pools.get("v", cache.v_pages).clone())


def _written_cells(torch, cache, layer, slots, positions):
    """(L, Hk, P, page) mask of the cells at (slot, position) in ``layer``."""
    mask = torch.zeros(cache.k_pages.shape[:-1], dtype=torch.bool,
                       device="cuda")
    slots, positions = slots.long(), positions.long()
    phys = cache.block_tables[slots, positions // PAGE].long()
    mask[layer, :, phys, positions % PAGE] = True
    return mask


def _check_pools(torch, new, ref, old, written, label):
    """Pools bit-identical to the plain chain's, and every cell outside
    the written ones as it was."""
    for name in ("k_pages", "v_pages"):
        a, b_, o = (getattr(c, name) for c in (new, ref, old))
        differing = int((a != b_).sum())
        assert differing == 0, f"{label}: {differing} {name} values differ"
        keep = ~written
        assert torch.equal(a[keep], o[keep]), \
            f"{label}: a {name} cell other than the written ones changed"


def check_ragged_attention(torch, timer, k11, kv_cache, rope_tables):
    """K11 on the mixed wave (layer 1's pools; q, fresh K/V random)."""
    cache, (q, kf, vf, _, _), wave = batcher_wave(torch, kv_cache,
                                                  rope_tables, SEED + 8)
    kp, vp = cache.k_pages[1], cache.v_pages[1]
    lens = wave[3:]                       # page_lens, q_start, q_lens, fresh
    args = (q, kp, vp, cache.block_tables, *lens)
    out = k11.ragged_paged_attention_pure(*args, kf, vf)
    ref = k11.ragged_paged_attention_reference(*args, kf, vf)
    abs_ref = k11.ragged_paged_attention_reference(
        q, kp, vp.abs(), cache.block_tables, *lens, kf, vf.abs())
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    worst = (diff / attention_tolerance(ref, abs_ref)).max().item()
    assert worst <= 1, f"ragged_paged_attention worst err/tol {worst:.3f}"
    pad = wave[0] < 0
    assert not out[pad].any(), "a padding row is not zero"
    ms = timer(lambda: k11.ragged_paged_attention_pure(*args, kf, vf))
    plain = timer(lambda: k11.ragged_paged_attention_reference(*args, kf,
                                                               vf))
    page_lens, _, q_lens, fresh = (x.long() for x in lens)
    # per row: its slot's visible pages plus its causal share of the chunk
    keys = int((page_lens * q_lens).sum()
               + (fresh * (fresh + 1) // 2).sum())
    nbytes = (2 * (q.numel() + kf.numel() + vf.numel() + out.numel())
              + 2 * 2 * int(page_lens.sum()) * 8 * 128
              + 4 * (cache.block_tables.numel() + 4 * BB))
    bms, by = bound(nbytes, 4 * keys * 32 * 128, BF16_FLOPS)
    log(f"K11 ragged_paged_attention T{BT} H32/8 page{PAGE} chunks "
        f"{WAVE_CHUNK[:2]} decode lens {lens[0][2:].tolist()}: max_abs_err "
        f"{diff.max().item():.3e} (worst err/tol {worst:.3f}) kernel_ms "
        f"{ms:.4f} plain_ms {plain:.4f} bound_ms {bms:.4f} ({by})")
    return {"name": "ragged_paged_attention", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
            "replaces": "paddle_tpu/ops/pallas/ragged_paged_attention.py:244",
            "max_abs_err": diff.max().item(), "err_over_tol": worst,
            "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
            "library_ms": None,
            "shape": f"T{BT} B{BB} H32 Hk8 D128 page{PAGE} mixed wave"}


def check_rope_attend_ragged(torch, timer, k3, kv_cache, rope_tables):
    """K3's ragged form on the mixed wave: output, the written cells bit
    for bit against the plain chain, every other cell untouched."""
    cache, rows, wave = batcher_wave(torch, kv_cache, rope_tables, SEED + 9)
    layer = 1
    ck, cp = _pool_copy(cache), _pool_copy(cache)
    out, ck = k3.fused_rope_append_attend(*rows, ck, layer, *wave)
    ref, cp = k3.ragged_reference(*rows, cp, layer, *wave, plain=True)
    q, k, v, cos, sin = rows
    ca = _pool_copy(cache, v=cache.v_pages.abs())
    abs_ref, _ = k3.ragged_reference(q, k, v.abs(), cos, sin, ca, layer,
                                     *wave, plain=True)
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    worst = (diff / attention_tolerance(ref, abs_ref)).max().item()
    assert worst <= 1, f"rope_append_attend ragged worst err/tol {worst:.3f}"
    valid = wave[2]
    assert not out[~valid].any(), "a padding row is not zero"
    written = _written_cells(torch, cache, layer, wave[0][valid],
                             wave[1][valid])
    _check_pools(torch, ck, cp, cache, written, "rope_append_attend ragged")
    ms = timer(lambda: k3.fused_rope_append_attend(*rows, ck, layer, *wave))
    plain = timer(lambda: k3.ragged_reference(*rows, cp, layer, *wave,
                                              plain=True))
    page_lens, _, q_lens, fresh = (x.long() for x in wave[3:])
    keys = int((page_lens * q_lens).sum() + (fresh * (fresh + 1) // 2).sum())
    n_valid = int(valid.sum())
    # decode rows read their own new cell back: pages read = page_lens
    # minus the cells this wave writes
    read_cells = int(page_lens.sum()) - int((q_lens * (fresh == 0)).sum())
    nbytes = (2 * (q.numel() + k.numel() + v.numel() + out.numel())
              + 4 * (cos.numel() + sin.numel())
              + 2 * 2 * (read_cells + n_valid) * 8 * 128
              + 4 * (cache.block_tables.numel() + BT + 4 * BB))
    bms, by = bound(nbytes, 4 * keys * 32 * 128, BF16_FLOPS)
    log(f"K3 rope_append_attend ragged T{BT} H32/8 page{PAGE}: max_abs_err "
        f"{diff.max().item():.3e} (worst err/tol {worst:.3f}) pool values "
        f"differing 0, {n_valid} rows written, kernel_ms {ms:.4f} plain_ms "
        f"{plain:.4f} bound_ms {bms:.4f} ({by})")
    return {"name": "rope_append_attend_ragged", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/rope_append_attend.cu",
            "replaces": "paddle_tpu/ops/pallas/fused_rope_attend.py:441",
            "max_abs_err": diff.max().item(), "err_over_tol": worst,
            "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
            "library_ms": None,
            "shape": f"T{BT} B{BB} H32 Hk8 D128 page{PAGE} mixed wave"}


def _segment_step_inputs(torch, kv_cache, rope_tables, seed):
    """A segment step's decode rows at the batcher's shapes: the mixed
    wave's cache at old lengths WAVE_SEQ, q (8, 32, 128), k/v (8, 8, 128),
    cos/sin at each slot's position, every slot active but WAVE_IDLE."""
    cache, _, _ = batcher_wave(torch, kv_cache, rope_tables, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 100)
    q = torch.randn((BB, 32, 128), generator=g, device="cuda",
                    dtype=torch.bfloat16)
    k, v = (torch.randn((BB, 8, 128), generator=g, device="cuda",
                        dtype=torch.bfloat16) for _ in "kv")
    cos_t, sin_t = rope_tables(BSEQ, 128, 500000.0, device="cuda")
    pos = cache.seq_lens.long()
    active = torch.ones(BB, dtype=torch.bool, device="cuda")
    active[WAVE_IDLE] = False
    return cache, (q, k, v, cos_t[pos], sin_t[pos]), active


def check_paged_attention(torch, timer, k10, kv_cache, rope_tables):
    """K10 at a segment step's shape: lengths WAVE_SEQ + 1, 0 for the idle
    slot."""
    cache, (q, _, _, _, _), active = _segment_step_inputs(
        torch, kv_cache, rope_tables, SEED + 10)
    lens = torch.where(active, cache.seq_lens + 1, 0).to(torch.int32)
    kp, vp = cache.k_pages[1], cache.v_pages[1]
    args = (q, kp, vp, cache.block_tables, lens)
    out = k10.paged_attention_pure(*args)
    ref = k10.paged_attention_reference(*args)
    abs_ref = k10.paged_attention_reference(q, kp, vp.abs(),
                                            cache.block_tables, lens)
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    worst = (diff / attention_tolerance(ref, abs_ref)).max().item()
    assert worst <= 1, f"paged_attention worst err/tol {worst:.3f}"
    assert not out[WAVE_IDLE].any(), "the length-0 slot is not zero"
    ms = timer(lambda: k10.paged_attention_pure(*args))
    plain = timer(lambda: k10.paged_attention_reference(*args))
    cells = int(lens.sum())
    nbytes = (2 * (q.numel() + out.numel()) + 2 * 2 * cells * 8 * 128
              + 4 * (cache.block_tables.numel() + BB))
    bms, by = bound(nbytes, 4 * cells * 32 * 128, BF16_FLOPS)
    log(f"K10 paged_attention B{BB} H32/8 page{PAGE} lens {lens.tolist()}: "
        f"max_abs_err {diff.max().item():.3e} (worst err/tol {worst:.3f}) "
        f"kernel_ms {ms:.4f} plain_ms {plain:.4f} bound_ms {bms:.4f} ({by})")
    return {"name": "paged_attention", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/paged_attention.cu",
            "replaces": "paddle_tpu/ops/pallas/paged_attention.py:142",
            "max_abs_err": diff.max().item(), "err_over_tol": worst,
            "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
            "library_ms": None,
            "shape": f"B{BB} H32 Hk8 D128 page{PAGE} lens {lens.tolist()}"}


def check_rope_attend_masked(torch, timer, k3, kv_cache, rope_tables):
    """K3's decode form with an active mask at a segment step's shape: the
    idle slot writes nothing and returns zeros."""
    cache, rows, active = _segment_step_inputs(torch, kv_cache, rope_tables,
                                               SEED + 11)
    layer = 1
    ck, cp = _pool_copy(cache), _pool_copy(cache)
    out, ck = k3.fused_rope_append_attend_decode(*rows, ck, layer, active)
    ref, cp = k3.decode_reference(*rows, cp, layer, active, plain=True)
    q, k, v, cos, sin = rows
    ca = _pool_copy(cache, v=cache.v_pages.abs())
    abs_ref, _ = k3.decode_reference(q, k, v.abs(), cos, sin, ca, layer,
                                     active, plain=True)
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    worst = (diff / attention_tolerance(ref, abs_ref)).max().item()
    assert worst <= 1, f"rope_append_attend masked worst err/tol {worst:.3f}"
    assert not out[WAVE_IDLE].any(), "the inactive slot is not zero"
    slots = torch.arange(BB, device="cuda")[active]
    written = _written_cells(torch, cache, layer, slots,
                             cache.seq_lens[active])
    _check_pools(torch, ck, cp, cache, written, "rope_append_attend masked")
    ms = timer(lambda: k3.fused_rope_append_attend_decode(*rows, ck, layer,
                                                          active))
    plain = timer(lambda: k3.decode_reference(*rows, cp, layer, active,
                                              plain=True))
    n_act = int(active.sum())
    cells = int((cache.seq_lens + 1)[active].sum())
    nbytes = (2 * (q.numel() + k.numel() + v.numel() + out.numel())
              + 4 * (cos.numel() + sin.numel()) + BB
              + 2 * 2 * (cells - n_act) * 8 * 128   # pages read
              + 2 * 2 * n_act * 8 * 128             # the new cells written
              + 4 * (cache.block_tables.numel() + BB))
    bms, by = bound(nbytes, 4 * cells * 32 * 128, BF16_FLOPS)
    log(f"K3 rope_append_attend masked B{BB} H32/8 page{PAGE} lens "
        f"{cache.seq_lens.tolist()} idle slot {WAVE_IDLE}: max_abs_err "
        f"{diff.max().item():.3e} (worst err/tol {worst:.3f}) pool values "
        f"differing 0, kernel_ms {ms:.4f} plain_ms {plain:.4f} bound_ms "
        f"{bms:.4f} ({by})")
    return {"name": "rope_append_attend_masked", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/rope_append_attend.cu",
            "replaces": "paddle_tpu/ops/pallas/fused_rope_attend.py:441",
            "max_abs_err": diff.max().item(), "err_over_tol": worst,
            "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
            "library_ms": None,
            "shape": f"B{BB} H32 Hk8 D128 page{PAGE} seq_lens "
                     f"{list(WAVE_SEQ)} active but slot {WAVE_IDLE}"}


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
        return "K3 rope_append_attend (decode)"
    if "ragged_attend_kernel<true>" in name:
        return "K3 rope_append_attend (ragged)"
    if "ragged_attend_kernel<false>" in name:
        return "K11 ragged_paged_attention"
    if "paged_attention_kernel" in name:
        return "K10 paged_attention"
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


def attention_dropping(keep):
    """A fault control for the serving checks, never used by the port:
    the plain attention (p kept in f32, as the kernels keep it) where
    query i sees key j only if ``keep(i, j)`` (an (S, S) bool mask of the
    causal positions) — rows with no visible key give zeros, as the
    kernels do."""
    import torch

    def attention(q, k, v, causal=True, scale=None):
        b, s, h, d = q.shape
        g = h // k.shape[2]
        kr, vr = (x.repeat_interleave(g, dim=2).float() for x in (k, v))
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr)
        logits = logits * (scale or 1.0 / math.sqrt(d))
        i = torch.arange(s, device=q.device)
        vis = (i[None, :] <= i[:, None]) & keep(i[:, None], i[None, :])
        p = logits.masked_fill(~vis, -1e30).softmax(dim=-1)
        p = p * vis.any(dim=-1)[:, None].to(p.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", p, vr).to(q.dtype)

    return attention


def missing_own_cell(start):
    """The fault K3 would have if it read its new cell before its write
    landed: every query from position ``start`` on (the decode steps)
    misses its own key."""
    return attention_dropping(lambda i, j: ~((i >= start) & (j == i)))


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
    assert plan == {"norm_matmul": 5 * L + 1, "rope_append_attend": L,
                    "paged_attention": 0}, plan
    expected = dict.fromkeys(kernels.launch_counts(), 0)
    expected.update({
        "flash_attention": L,
        "fused_norm_matmul": plan["norm_matmul"] * (1 + steps),
        "fused_rope_attend": plan["rope_append_attend"] * steps})

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
            k1._reference_attention, missing_own_cell(PROMPT))
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
                    "paged_attention": 0, "quant_matmul": 64}, plan
    # 32 K1 + 161 K2 + 64 K4 per prefill, 32 K3 + 161 K2 + 64 K4 per step
    expected = dict.fromkeys(kernels.launch_counts(), 0)
    expected.update({"flash_attention": 32,
                     "fused_norm_matmul": 161 * (1 + steps),
                     "fused_rope_attend": 32 * steps,
                     "quant_matmul": 64 * (1 + steps)})

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
            missing_own_cell(PROMPT)))
        ctl_fp16 = plain_logits(torch.float16, int8_attention)
        ref_f32 = plain_logits(torch.float32, int8_attention)
    stats["logits_check"] = check_logits(logits, ref_f32, ref_bf16, ctl_fp16,
                                         ctl_fault, "serving int8w+int8kv")
    return counts, stats


def batcher_requests(vocab):
    """The 24 seeded requests of phase 6: (prompt ids, max_new_tokens,
    arrival_segment), prompt lengths uniform in 32-512, max_new_tokens in
    16-64, arrivals in 0-6."""
    import numpy as np

    rng = np.random.default_rng(SEED + 12)
    return [(rng.integers(0, vocab, size=int(rng.integers(32, 513)))
             .astype(np.int32), int(rng.integers(16, 65)),
             int(rng.integers(0, 7))) for _ in range(N_REQUESTS)]


def check_batcher_tokens(torch, cfg, prms, reqs, done, label):
    """Every emitted token against a teacher-forced plain forward of its
    request (prompt + the tokens it emitted before): at each generated
    position, the emitted token's f32 logit must lie within 2 x E of the
    f32 maximum, E being the plain bf16 forward's largest logit error
    against the plain f32 forward at that position. (If the kernel path's
    logits are within E of the f32 ones, its argmax is within 2E of the
    f32 maximum.) Token identity with solo generate_paged cannot be asked
    on the card: bf16 summation orders differ and random 8B weights
    amplify it. Two fault controls must fail the rule somewhere: tokens
    picked by a plain bf16 forward whose decode positions miss their own
    cell (a K3/K11 that drops the own cell), and by one whose prompt rows
    miss their own 256-token chunk (a K11 that drops the fresh source)."""
    from paddle_tpu_torch.models.llama import prompt_logits_pure
    from paddle_tpu_torch.ops.kernels import flash_attention as k1

    plain_attention = k1._reference_attention
    prms32 = {n: p.float() for n, p in prms.items()}
    worst, n_pos, n_argmax = 0.0, 0, 0
    ctl = {"missing own cell": [0, 0.0], "fresh source dropped": [0, 0.0]}
    with torch.inference_mode():
        for rid, (prompt, n_new, _) in enumerate(reqs):
            toks = done[rid].tokens
            n0 = len(prompt)
            seq = torch.tensor([list(map(int, prompt)) + toks[:-1]],
                               device="cuda")

            def logits(params, attention=plain_attention):
                k1._reference_attention = attention
                try:
                    return prompt_logits_pure(params, seq, cfg, plain=True)[
                        0, n0 - 1:].float()
                finally:
                    k1._reference_attention = plain_attention

            f32 = logits(prms32)
            err = (logits(prms) - f32).abs().amax(-1)          # E per position
            top = f32.amax(-1)

            def ratio(tokens):
                return ((top - f32.gather(-1, tokens[:, None])[:, 0])
                        / err.clamp_min(1e-30))

            r = ratio(torch.tensor(toks, device="cuda"))
            worst = max(worst, r.max().item())
            n_pos += len(toks)
            n_argmax += int((f32.argmax(-1).cpu()
                             == torch.tensor(toks)).sum())
            faults = {
                "missing own cell": missing_own_cell(n0),
                "fresh source dropped": attention_dropping(
                    lambda i, j: (i >= n0) | (j < i // BCHUNK * BCHUNK))}
            for name, attention in faults.items():
                rc = ratio(logits(prms, attention).argmax(-1))
                ctl[name][0] += int((rc > 2).sum())
                ctl[name][1] = max(ctl[name][1], rc.max().item())
            del f32, err
    del prms32
    torch.cuda.empty_cache()
    log(f"{label}: teacher-forced rule over {n_pos} emitted tokens: worst "
        f"(f32 max - f32 logit of the token) / E {worst:.3f} (bound 2), "
        f"tokens equal to the f32 argmax {n_argmax}/{n_pos}; controls "
        + ", ".join(f"{k}: {v[0]}/{n_pos} positions fail, worst {v[1]:.2f}"
                    for k, v in ctl.items()))
    assert worst <= 2, f"{label}: an emitted token fails the rule ({worst})"
    for name, (fails, _) in ctl.items():
        assert fails > 0, f"{label}: the {name} control passes the rule"
    return {"worst_ratio": worst, "positions": n_pos,
            "f32_argmax_agreement": n_argmax / n_pos,
            "control_failing_positions": {k: v[0] for k, v in ctl.items()},
            "control_worst_ratio": {k: v[1] for k, v in ctl.items()}}


BATCHER_PLANS = (("fused", "norm_matmul,rope_append_attend"),
                 ("unfused attention", "norm_matmul"))


def serve_batcher(torch, kernels, profile=False):
    """Llama-3-8B bf16 through the continuous batcher at full width, in
    both attention-tail settings (BATCHER_PLANS)."""
    from paddle_tpu_torch.framework import flags
    from paddle_tpu_torch.inference import ContinuousBatcher
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops.kernels import fusion

    cfg = LlamaConfig.llama3_8b(dtype="bfloat16")
    L = cfg.num_hidden_layers
    model = LlamaForCausalLM(cfg, seed=SEED)
    reqs = batcher_requests(cfg.vocab_size)
    n_tokens = sum(n for _, n, _ in reqs)
    log(f"serving, continuous batching: {N_REQUESTS} requests, prompts "
        f"{sum(len(p) for p, _, _ in reqs)} tokens "
        f"({min(len(p) for p, _, _ in reqs)}-"
        f"{max(len(p) for p, _, _ in reqs)}), {n_tokens} new tokens, "
        f"arrivals {sorted(t for _, _, t in reqs)}")

    def run_once():
        eng = ContinuousBatcher(model, max_batch=BB, max_seq=BSEQ,
                                page_size=PAGE, segment=16,
                                prefill_chunk=BCHUNK, prefix_caching=False)
        for prompt, n_new, t in reqs:
            eng.submit(prompt, max_new_tokens=n_new, arrival_segment=t)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = eng.run()
        torch.cuda.synchronize()
        return done, eng.stats, time.perf_counter() - t0

    out = {}
    old = flags.get_flag("fused_decode_fusions")
    try:
        for label, fusions in BATCHER_PLANS:
            flags.set_flags({"fused_decode_fusions": fusions})
            plan = fusion.planned_kernel_launches(L)
            run_once()                                   # warm-up
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launch_counts()
            done, st, wall = run_once()                  # THE counted run
            counts = kernels.launch_counts()
            waves, steps = st["ragged_steps"], st["decode_steps"]
            fused = plan["rope_append_attend"] > 0
            per = plan["rope_append_attend"] + plan["paged_attention"]
            expected = dict.fromkeys(counts, 0)
            expected["fused_norm_matmul"] = plan["norm_matmul"] * (waves
                                                                   + steps)
            expected["fused_rope_attend_ragged" if fused
                     else "ragged_paged_attention"] = per * waves
            expected["fused_rope_attend" if fused
                     else "paged_attention"] = per * steps
            log(f"batcher {label}: launches {counts} expected {expected}")
            assert plan["norm_matmul"] == 5 * L + 1 and per == L, plan
            assert counts == expected, f"{counts} != plan {expected}"
            for rid, (prompt, n_new, _) in enumerate(reqs):
                req = done[rid]
                assert req.status == "ok", (rid, req.status)
                assert len(req.tokens) == n_new, (rid, len(req.tokens))
                assert all(0 <= t < cfg.vocab_size for t in req.tokens)
            assert st["wasted_slot_steps"] == 0, st
            assert st["bucket_pad_tokens"] == 0, st
            walls = [wall] + [run_once()[2] for _ in range(2)]
            wall_s = statistics.median(walls)
            peak = torch.cuda.max_memory_allocated() / 2**30
            keys = ("ragged_steps", "segments", "decode_steps",
                    "host_sync_count", "token_budget_util",
                    "prefill_tokens_admitted", "tokens_emitted")
            res = {"wall_s": wall_s, "wall_s_runs": walls,
                   "generated_tok_s": n_tokens / wall_s,
                   "max_memory_allocated_gib": peak, "launches": counts,
                   **{k: st[k] for k in keys}}
            log(f"batcher {label}: wall {[round(w, 3) for w in walls]} s "
                f"(median {wall_s:.3f}), {n_tokens / wall_s:.1f} generated "
                f"tok/s, " + ", ".join(f"{k} {st[k]}" for k in keys)
                + f", max_memory_allocated {peak:.2f} GiB")
            if profile:
                with torch.inference_mode():
                    res["profile"] = profile_window(
                        torch, run_once, f"batcher {label}")
            res["tokens_check"] = check_batcher_tokens(
                torch, cfg, model.param_dict(), reqs, done,
                f"batcher {label}")
            out[label] = res
    finally:
        flags.set_flags({"fused_decode_fusions": old})
    return out


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
    from paddle_tpu_torch.ops.kernels import paged_attention as k10
    from paddle_tpu_torch.ops.kernels import quant_matmul as k4
    from paddle_tpu_torch.ops.kernels import ragged_paged_attention as k11

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

    # ---- 3. kernels vs plain, each row tagged with the path whose run
    # gives its launches
    timer = ColdTimer(torch)
    own = [(check_flash(torch, timer, k1), "generate_paged bf16"),
           (check_norm_matmul(torch, timer, k2), "generate_paged bf16"),
           (check_rope_attend(torch, timer, k3, kv_cache, _rope_tables),
            "generate_paged bf16"),
           (check_quant_matmul(torch, timer, k4), "generate_paged int8"),
           (check_norm_matmul_int8(torch, timer, k2), "generate_paged int8"),
           (check_rope_attend_int8(torch, timer, k3, kv_cache, _rope_tables),
            "generate_paged int8"),
           (check_ragged_attention(torch, timer, k11, kv_cache, _rope_tables),
            "batcher unfused attention"),
           (check_rope_attend_ragged(torch, timer, k3, kv_cache,
                                     _rope_tables), "batcher fused"),
           (check_paged_attention(torch, timer, k10, kv_cache, _rope_tables),
            "batcher unfused attention"),
           (check_rope_attend_masked(torch, timer, k3, kv_cache,
                                     _rope_tables), "batcher fused")]
    del timer
    torch.cuda.empty_cache()

    # ---- 4. serving (bf16), 5. int8w+int8kv, 6. continuous batching;
    # each path's counts are set to 0 just before its counted run and read
    # just after
    profile = "--profile" in sys.argv
    counts, stats = serve(torch, kernels, profile=profile)
    torch.cuda.empty_cache()
    counts_int8, stats_int8 = serve_int8(torch, kernels, profile=profile)
    torch.cuda.empty_cache()
    stats_batcher = serve_batcher(torch, kernels, profile=profile)
    paths = {"generate_paged bf16": counts,
             "generate_paged int8": counts_int8,
             **{f"batcher {label}": stats_batcher[label]["launches"]
                for label, _ in BATCHER_PLANS}}
    counter = {"flash_attention_fwd": "flash_attention",
               "norm_matmul": "fused_norm_matmul",
               "norm_matmul_int8": "fused_norm_matmul",
               "rope_append_attend_decode": "fused_rope_attend",
               "rope_append_attend_decode_int8": "fused_rope_attend",
               "quant_matmul": "quant_matmul",
               "ragged_paged_attention": "ragged_paged_attention",
               "rope_append_attend_ragged": "fused_rope_attend_ragged",
               "paged_attention": "paged_attention",
               "rope_append_attend_masked": "fused_rope_attend"}
    rows = []
    for row, path in own:
        c = counter[row["name"]]
        row["launches"] = paths[path][c]
        row["launches_path"] = path
        row["launches_by_path"] = {p: n[c] for p, n in paths.items()}
        assert row["launches"] > 0, (row["name"], path)
        rows.append(row)
    log(f"max_memory_allocated while serving: bf16 "
        f"{stats['max_memory_allocated_gib']:.2f} GiB, int8w+int8kv "
        f"{stats_int8['max_memory_allocated_gib']:.2f} GiB, batcher "
        + ", ".join(f"{k} {v['max_memory_allocated_gib']:.2f} GiB"
                    for k, v in stats_batcher.items()))

    # ---- 7. result
    log(json.dumps({"serving": stats, "serving_int8w_int8kv": stats_int8,
                    "serving_batcher": stats_batcher}))
    log(json.dumps({"kernels": rows}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
