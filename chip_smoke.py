#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``paddle_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--profile]

``--profile`` adds torch.profiler traces of the serving runs and of one
Llama, one fine-tuning and one MoE train step (device time by kernel
class, device busy share). Phases, in order; any failure raises and the process exits nonzero:

1. device   — the card's name and power limit (nvidia-smi); TF32 and
               reduced-precision bf16 matmul reductions off, so the plain
               versions accumulate in f32.
2. build    — nvcc builds every ``paddle_tpu_torch/csrc/*.cu`` for sm_90a.
3. kernels  — each kernel against its plain PyTorch version on the card,
               in bf16 at the Llama-3-8B shapes of the serving paths, with
               kernel / plain / library times and the least time the card
               could take (``bound_ms``): K1, K2 (the small-M body at
               M = 8 for every decode width and at M = 16 for gate/up,
               and the tiled path at the batcher's M = 264, the prefill's
               1024 and the train step's 8192, each at N = 1024, 4096 and
               14336), K3 (bf16), then K4 (weight-only int8 at the decode
               and prefill o_proj and down_proj shapes and at M = 16
               down_proj, down_proj also int8 and int4 group 128) and K2
               with int8 weights (the decode shapes, gate/up at M = 16,
               every prefill projection, gate/up also int4 group 128): at
               every K2 and K4 shape TFLOP/s, two calls bitwise equal, the
               work the card's CTAs decode equal to the Python walk model
               (tiles; and for M <= 16 cluster ranks and K ranges), and a
               fault control that must fail the rule (w_norm shifted by
               64 elements for dense W, the scales by 16 columns for
               quantized W); K3 on an int8 cache (page 32), then the
               continuous batcher's kernels on its mixed wave (T = 264
               rows: two prefill chunks, decode rows at lengths 97-600,
               an idle slot, padding rows): K11, K3's ragged form, K10
               and K3's masked decode form. The page walk's forms (K3
               decode bf16, int8, masked; K10) also log their plan
               (cluster size, CTAs, pages a CTA), check the (rank, page
               range) items their CTAs decode on the card against
               ``paged_attention.walk_items`` and two calls bitwise
               equal, and run a fault control that must fail the
               attention rule: the split walk's plain model
               (``split_walk_reference``) without its last range. The
               ragged forms (K11, K3 ragged) run that wave and a second
               one (a 256-row chunk on 256 cells of context, seven decode
               rows at lengths 97-600), each timed; on both they log their
               plan (cluster size, CTAs, tile and walk items, pages a CTA,
               the clusters with work against the most the card holds at
               once: all resident), check the items their CTAs decode on
               the card against ``ragged_paged_attention.ragged_items``,
               two calls bitwise equal, rows of no segment zeros (K3: the
               pools bit-identical to the plain chain's), and a fault
               control that must fail: ``split_ragged_reference`` with
               every walk's last range left out. Then the batcher's
               kernels on an int8 cache (page 32, every cell random K/V
               quantized on write): K11 and K3's ragged form on both waves
               and K10 and K3's masked form at the segment step's
               lengths, with the same plans,
               items, repeat, rows-of-no-segment and dropped-range checks
               (K3: codes within 1 of the plain chain's, counted, scales
               bit-identical, every other cell untouched) and the int8
               byte bounds (codes and an f32 scale a cell). Then the
               speculative verify wave (T = 264: a 224-row chunk on 32
               cells, six verify segments of 1 + 4 rows and one of 1 row
               at old lengths 92-595, 9 padding rows) through K11 and K3's
               ragged form with ``fresh_pool_read`` on the verify slots,
               bf16 and int8: within the attention tolerance of the plain
               versions with the pool roundtrip, bf16 bitwise equal to
               the unflagged call, int8 with the unflagged call further
               from the plain version (both logged), the plan and items,
               two calls bitwise equal, rows of no segment zero, K3's
               pools, and the dropped-page control (the wave has no walk:
               each tile's last page left out); and K2 at M = 40 (the
               solo verify step) for N 1024, 4096, 14336 and 128256.
4. serving  — Llama-3-8B (all 32 layers, full width, seeded random bf16
               weights) greedy ``generate_paged`` for B=8, prompt 128,
               32 new tokens; the kernels' launch counts must equal the
               fully fused plan's (32 K1 + 161 K2 + 64 K12 per prefill);
               the prefill's and the prompt-logits forward's K12 calls
               each bitwise equal to the f32 rotate-half chain
               (``chain_rope``); the logits of every generated position
               (prefill and each decode step) are held against a plain
               teacher-forced forward in f32, with the plain bf16 forward
               as the yardstick and two controls (fp16, a K3-style
               fault); timing is the median of 3 full rollouts.
4c. speculative decoding, solo (after phases 4 and 5, on their model)
               — ``generate_paged(spec_decode=True, spec_k=4)``: a warm-up
               with ``NGramDraft``, then the counted run with a draft that
               replays the warm-up's continuations (every fourth draft
               replaced): launches 32 K1 + 161 K2 + 64 K12 (+ 64 K4) for
               the prefill and 161 K2 + 32 K3-ragged (+ 64 K4) a verify step,
               drafts accepted and rejected, every emitted token held to
               the teacher-forced rule of phase 6 (its controls failing),
               the median of 3 spec rollouts beside the plain ones.
5. serving, int8w+int8kv — the same model quantized on the card
               (``quantize_for_inference``: int8 weights, per-channel
               scales), served with ``cache_dtype="int8"``, page 32; the
               counts must equal 32 K1 + 161 K2 + 64 K4 + 64 K12 per
               prefill and 32 K3 + 161 K2 + 64 K4 per decode step; the
               rope sites checked as in phase 4; the logits are held
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
6b. serving, int8w+int8kv continuous batching — the phase-6 model
               quantized on the card as in phase 5 (bf16 matmul weights
               freed) through ``ContinuousBatcher(quantized_params=...,
               cache_dtype="int8", page_size=32, ...)`` on the same 24
               requests, in both plans: counts equal to the plan plus 64
               K4 a wave and a step, every request "ok" with its
               max_new_tokens, no wasted slot step, and the teacher-forced
               rule held against the quantized function (int8 weights
               dequantized per call; attention through
               ``int8_batcher_attention``: a key quantize->dequantized
               where the batcher read it from its cache, fresh where the
               row's own chunk gave it, per the request's ``chunk_map``
               from the batcher's admission record), which its two
               controls must fail; walls the median of 3 after a warm-up,
               beside phase 6's.
6c. serving, speculative continuous batching — after each of phases 6
               and 6b, the same 24 requests with ``spec_decode=True,
               spec_k=4`` in both plans: once with ``NGramDraft`` (drafts
               proposed and accepted reported), then with a draft that
               replays that run's continuations (every fourth draft
               replaced): a warm-up and the counted run, whose launches
               must equal 161 K2 + 32 K3-ragged (or K11) (+ 64 K4) a wave
               and 0 K3-masked / K10 (no segment step), every request "ok"
               with its max_new_tokens, no wasted slot step, one readback
               a wave, drafts both accepted and rewound, every emitted
               token held to the teacher-forced rule (int8: through
               ``int8_batcher_attention``, a verify row reading every key
               as the cache serves it); walls the median of 3, beside
               phase 6's, with tokens_per_target_step.
7. training kernels — after the serving models are freed, each new
               kernel against its plain version at the Llama-3-8B train
               step's shapes, with times, bounds and library yardsticks:
               K1 without a mask (B=4 S=2048 32/8 heads, causal; SDPA
               causal with no mask; two calls bitwise equal), K5 (flash
               backward at that shape;
               SDPA's backward; achieved TFLOP/s and bound share, two
               calls bitwise equal), K6/K7 (RMSNorm forward/backward at 8192 x
               4096; F.rms_norm and its backward), K8 (AdamW8bit on a
               58.7M-element gate_proj-shaped param with its f32 master
               and on 3,000,001 elements, 3 steps with weight decay:
               codes bit-identical to the plain version); then, at the same
               attention shape with rows left-padded to real lengths
               (2048, 1792, 1280, 768), K1 (its skipped key tiles, which
               must be > 0 and equal the pure-Python model, and two calls
               bitwise equal) and K5 with the key bias and
               K9 (the one-pass backward) with it (K9 and K5 also timed
               without it; SDPA forward and backward under the same bool
               mask as the library; K5 and K9 each two calls bitwise
               equal, with TFLOP/s and bound share; K9's skipped key-tile
               blocks, which must be > 0 and equal the pure-Python model
               of the left pads, and its dS partials' bytes), and K12
               (rope) forward and transposed (its backward) at (4, 2048,
               32, 128) and (4, 2048, 8, 128), bit-equal to its plain
               versions, two calls bitwise equal, every instance's
               registers and spills (none); then one layer's training
               attend seam at those shapes with K12 and with the f32
               rotate-half chain: q2, k2, the output and the q/k/v
               gradients bitwise equal.
8. gradient check — a 2-layer full-width model (B=1, S=2048): the
               per-token losses and every parameter's gradient of the
               kernel path, the plain bf16 path and a plain f32 run;
               kernel-vs-f32 relative L2 error <= 2 x plain-bf16-vs-f32,
               which a fault control (K5 with Delta left at zero) must
               fail; then the same rule on a left-padded batch (B=2, row 1
               holding 1,100 real tokens, the key-padding mask through
               every block) under ``flash_bwd_impl`` "split" (K5 with the
               bias) and "fused" (K9), which two controls must fail: the
               bias dropped inside K1 and K9, and K9 with Delta at zero.
9. training — ``jit.TrainStep`` over Llama-3-8B widths cut to 8 layers
               (bf16, core_attn recompute, fused_head_loss, 4096-token loss
               chunks) with AdamW8bit(1e-4), B=4 x S=2048 random tokens:
               one warm-up step, then 3 timed steps whose K1, K2, K5, K6,
               K7, K8 and K12 counts must equal
               ``train_kernel_launches_per_step``'s plan (one K8 per
               parameter tensor: 75; 6 K12 a layer); the loss must fall;
               median step ms, tokens/s, the 6N+attention model-FLOP share
               of the bf16 peak (``mfu_6n_attn``), peak memory; then the
               chunked loss's forward + backward timed alone.
9b. fine-tuning — cell llama3-8b-8L-sft, after the phase-9 model is
               freed: the same model and recipe with
               ``flash_bwd_impl="fused"`` and ``AdamW8bit(LinearWarmup(
               CosineAnnealingDecay(1e-4, 1000), 2, 1e-5, 1e-4),
               grad_clip=ClipGradByGlobalNorm(1.0))`` on the batch
               left-padded to real lengths (2048, 1792, 1280, 768), a
               bool (B, S) mask, labels -100 on the pads and each row's
               first quarter: ``step((ids, mask), labels)``, one warm-up
               and 3 timed steps whose launches must equal the plan (16 K1
               + 80 K2 + 8 K9 + 0 K5 + 1 K6 + 1 K7 + 75 K8 + 48 K12 a
               step, no plain-attention route); the loss must fall, each
               step's lr follow the schedule and the clipped global norm be
               <= 1; step ms, tokens/s (real and all positions),
               ``mfu_6n_attn``, peak memory.
10. MoE kernels — after the Llama train model is freed, K13 (grouped
               matmul: forward at 4096 -> 14336 and 14336 -> 4096, and its
               transposed dX form) and K14 (segment dW at both weight
               shapes, bf16 out) against their plain versions at the
               Mixtral-8x7B train shapes: T = 16,384 routed rows split
               unevenly over 8 experts (one empty, one with 30%,
               boundaries off the 128-row tile); per-element tolerances
               from the inputs, K14's empty group all zeros, each form's
               two calls bitwise equal; times, TFLOP/s, bound shares, the
               kernels' registers and spills from the build log,
               ``torch._grouped_mm`` as the library yardstick where this
               torch has it, and for K14 (whose routing the library's
               grouped-K form refuses) the library and K14 again on the
               counts rounded to multiples of 8.
11. MoE gradient check — one full-width Mixtral layer's experts at B=1
               x S=2048 under a routing computed once in f32: y, dx and
               the three dWs of the kernel path, the plain bf16 path and
               the plain f32 path; kernel-vs-f32 relative L2 <= 2 x
               plain-bf16-vs-f32, which two controls (a group boundary
               moved by 64 rows, a group's last 64-row dW slice left
               out) must fail; then a 1-layer full-width MoEForCausalLM:
               per-token losses against its plain f32 forward and the
               token copies routed to another expert.
10b. quantized expert kernels — K13's int8/int4 forms (int8 and int4,
               per channel and group 128) at 4096 -> 14336 and 14336 ->
               4096 on phase 10's routing, the experts quantized on the
               card (``quantize_grouped_weight``): each element within
               ``grouped_matmul.quant_tolerance`` of the plain version
               (K13's summation bound plus one bf16 rounding of each
               weight the plain version dequantizes), two calls bitwise
               equal, the items the card decodes equal to ``gmm_items`` at
               the form's tile width (256, or 128 group-wise), the scales
               shifted by 16 columns failing the rule; kernel, plain and
               library times (dequant + ``torch._grouped_mm``), TFLOP/s,
               bound shares, registers and spills.
11b. quantized experts — cell mixtral-8x7b-1L-int8-experts, int8 per
               channel and int4 group 128 (``quantize_experts`` on the
               card): phase 11's expert check for y and dx against the
               quantized function in f32 (kernel-vs-f32 rel L2 <= 2 x
               plain-bf16-vs-f32; controls: a boundary moved by 64 rows,
               the scales shifted by 16 columns, must fail); the 1-layer
               full-width model's per-token losses against its plain f32
               forward on the same codes, and one forward + backward whose
               launches must equal
               ``moe_train_kernel_launches_per_step(1, 0,
               quantized_experts=True)`` (3 K13 int8/int4, 3 K13 dX, no
               K14); then B=4 x S=2048 forward + backward walls (median of
               3 after a warm-up) and peak memory, bf16 against each
               quantized form (fp expert stacks freed).
12. MoE training — cell mixtral-8x7b-3L-train: ``jit.TrainStep`` over
               Mixtral-8x7B widths cut to 3 layers (bf16, dropless
               routing, top-2 of 8 experts) with AdamW8bit(1e-4), B=4 x
               S=2048 random tokens: one warm-up step, then 3 timed steps
               whose K1, K2, K5, K6, K7, K8, K12, K13 and K14 counts must
               equal ``moe_train_kernel_launches_per_step``'s plan; the
               loss must fall; median step ms, tokens/s, ``mfu_6n_attn``
               over the active (top-2) parameters, peak memory, each
               layer's aux loss and routed rows per expert.
13. result  — a ``{"kernels": [...]}`` line, then the last line
               ``{"ok": true, "device": {...}}``.

Needs a CUDA device and the CUDA toolkit; imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import itertools
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
# the ragged forms' second wave: slot 0 prefills the second 256-row chunk
# of a 512-token prompt (256 cells of page context for every tile), the
# other seven decode one row at lengths 97-600
WAVE2_SEQ = (256, 96, 127, 255, 383, 447, 511, 599)
WAVE2_CHUNK = (256, 0, 0, 0, 0, 0, 0, 0)
RAGGED_WAVES = ((WAVE_SEQ, WAVE_CHUNK, WAVE_IDLE),
                (WAVE2_SEQ, WAVE2_CHUNK, None))
N_REQUESTS = 24
# speculative decoding (phases 3, 4c and 6c): drafts a verify segment
SPEC_K = 4
# the kernels phase's verify wave, the batcher's spec wave at T = 264: slot
# 0 prefills a 224-row chunk on 32 cells of context, the others verify
# their token and SPEC_K drafts (slot 4: no drafts, one row), marked
# fresh_pool_read, at old lengths whose last verify row lands at 97-600;
# 255 live rows, rows 255.. pad the wave
VERIFY_SEQ = (32, 92, 123, 251, 300, 379, 507, 595)
VERIFY_ROWS = (224, 5, 5, 5, 1, 5, 5, 5)


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


# M = 40: the solo verify step's projections and LM head (B = 8 rows of
# 1 + SPEC_K)
NM_SHAPES = [(8, 4096, 14336), (8, 4096, 4096), (8, 4096, 1024),
             (8, 4096, 128256), (16, 4096, 14336), (1024, 4096, 14336),
             (1024, 4096, 4096),
             (1024, 4096, 1024), (BT, 4096, 14336), (BT, 4096, 4096),
             (BT, 4096, 1024), (8192, 4096, 14336), (8192, 4096, 4096),
             (8192, 4096, 1024), (40, 4096, 1024), (40, 4096, 4096),
             (40, 4096, 14336), (40, 4096, 128256)]


def check_norm_matmul(torch, timer, k2):
    """K2 at every projection shape of a decode step (M=8, and gate/up at
    M=16: the small-M body's n16 bucket), a solo prefill (M=1024), a
    batcher wave (M=BT=264), the train step's forward (M=8192: B=4 x
    S=2048) and a solo verify step (M=40, the LM head included), with each
    row's TFLOP/s. At every shape: two calls bitwise
    equal, the work its CTAs decode as the Python walk model has it (the
    tiled body's tiles, or the small-M body's tiles, cluster ranks and K
    ranges), and w_norm shifted by 64 elements must fail the rule."""
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
        tol = 2e-2 + 1e-2 * ref.float().abs()
        ok = bool((diff <= tol).all())
        assert ok, f"norm_matmul {m}x{kdim}x{n} max_abs_err {err}"
        assert _same_bits(torch, lambda: (k2.fused_norm_matmul_pure(
            x, nw, eps, w),)), f"norm_matmul {m}x{kdim}x{n}: two calls differ"
        ms = timer(lambda: k2.fused_norm_matmul_pure(x, nw, eps, w))
        plain = timer(lambda: k2._reference(x, nw, eps, w))
        lib = (timer(lambda: torch.matmul(rms_norm(x, (kdim,), nw, eps), w))
               if rms_norm is not None else None)
        nbytes = 2 * (m * kdim + kdim + kdim * n + m * n)
        bms, by = bound(nbytes, 2 * m * n * kdim, BF16_FLOPS)
        row = {"shape": f"M{m} K{kdim} N{n}", "max_abs_err": err,
               "ms": ms, "plain_ms": plain, "bound_ms": bms,
               "bound_by": by, "library_ms": lib}
        ctl = k2.fused_norm_matmul_pure(x, nw.roll(64).contiguous(), eps, w)
        ctl_worst = ((ctl.float() - ref.float()).abs() / tol).max().item()
        extra = _form_checks(
            torch, row, lambda: k2.fused_norm_matmul_pure(x, nw, eps, w),
            ctl_worst, 2 * m * n * kdim, "w_norm-shift") \
            + "; " + _walk_check(torch, row, m, kdim, n)
        del ctl
        log(f"K2 norm_matmul M{m} K{kdim} N{n}: max_abs_err {err:.3e} "
            f"kernel_ms {ms:.4f} plain_ms {plain:.4f} library_ms "
            f"{lib if lib is None else round(lib, 4)} (rms_norm+matmul) "
            f"bound_ms {bms:.4f} ({by}); {extra}")
        rows.append(row)
        errs.append(err)
        del x, w, y, ref, diff, tol
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
    row = {"name": "rope_append_attend_decode"}
    walk = _walk_checks(
        torch, row, _decode_walk(kv_cache, (q, k, v, cos, sin), cp, layer,
                                 lens + 1), ref,
        lambda: k3.fused_rope_append_attend_decode(q, k, v, cos, sin, ck,
                                                   layer)[:1])
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
        f"{bms:.4f} ({by}); {walk}")
    return {**row, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/rope_append_attend.cu",
            "replaces": "paddle_tpu/ops/pallas/fused_rope_attend.py:441",
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bms, "bound_by": by, "library_ms": None,
            "shape": f"B{b} H{h} Hk{hk} D{d} page{PAGE} seq_lens{PROMPT}"}


QMM_SHAPES = [(8, 4096, 4096, "int8", -1), (8, 14336, 4096, "int8", -1),
              (16, 14336, 4096, "int8", -1), (1024, 4096, 4096, "int8", -1),
              (1024, 14336, 4096, "int8", -1),
              (1024, 14336, 4096, "int8", 128),
              (1024, 14336, 4096, "int4", 128),
              (8, 14336, 4096, "int4", 128)]
#: the scale columns the fault control shifts the scales by
SHIFT = 16


def _quantize(torch, g, kdim, n, wd="int8", gs=-1):
    """A seeded random (kdim, n) weight, quantized as quantize_for_inference
    does: (QuantizedWeight, the bf16 weight)."""
    from paddle_tpu_torch.ops.extra_vision import _weight_quantize_pure
    from paddle_tpu_torch.ops.kernels.quant_matmul import QuantizedWeight

    w = torch.randn((kdim, n), generator=g, device="cuda") / math.sqrt(kdim)
    codes, scales = _weight_quantize_pure(w, f"weight_only_{wd}", gs)
    return QuantizedWeight(codes, scales, wd, gs, (kdim, n)), w.to(
        torch.bfloat16)


def _shifted(qw):
    """The fault control's weight: qw with its scales shifted by SHIFT
    columns (every column scaled by another column's scale)."""
    from paddle_tpu_torch.ops.kernels.quant_matmul import QuantizedWeight

    return QuantizedWeight(qw.codes, qw.scales.roll(SHIFT, -1).contiguous(),
                           qw.weight_dtype, qw.group_size, qw.shape)


def _form_checks(torch, row, fn, ctl_worst, flops, control="shifted-scale"):
    """A K2 or K4 row's extra checks, into ``row``: two calls bitwise
    equal, TFLOP/s and bound share, and the fault control (its worst
    err/tol), which must fail the rule."""
    assert _same_bits(torch, lambda: (fn(),)), (
        f"{row['shape']}: two calls differ")
    row["control_worst_err_over_tol"] = ctl_worst
    assert ctl_worst > 1, (f"{row['shape']}: the {control} control "
                           f"passed (worst err/tol {ctl_worst:.3f})")
    return f"{_rate(row, flops)}; {control} control worst err/tol " \
        f"{ctl_worst:.3f} (fails, as it must)"


def _walk_check(torch, row, m, kdim, n, gs=-1, fused_norm=True):
    """The work the CTAs decode on the card must equal the Python model of
    the body the call runs, for this card's SM count: with M > 16 the
    tiled body's output tiles in walk order (``quant_matmul.quant_tiles``
    at the width ``block_n`` picks; K2 dense: ``block_n(m, n)``), with
    M <= 16 the small-M body's (tile, cluster rank) items: CTA, step and K
    range (``quant_matmul.small_items``)."""
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import quant_matmul as k4

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if m <= k4.SMALL_MAX_M:
        cs, grid = k4.small_plan(kdim, n, sms)
        want = k4.small_items(kdim, n, sms)
        tiles = -(-n // k4.SMALL_BN)
        out = torch.full((tiles * k4.SMALL_MAX_CS, 4), -1, dtype=torch.int32,
                         device="cuda")
        _build.launch("pt_small_matmul_items", kdim, n, out.data_ptr(),
                      _build.stream_of(out))
        got = out.cpu().tolist()
        assert got[:len(want)] == [list(r) for r in want] and all(
            r == [-1] * 4 for r in got[len(want):]), (
            f"{row['shape']}: the items decoded on the card differ from "
            f"quant_matmul.small_items (cs {cs}, grid {grid})")
        row["cluster"], row["ctas"], row["tiles"] = cs, grid, tiles
        return (f"{tiles} tiles of 64 x {cs} cluster ranks on {grid} CTAs "
                f"as the model walks them")
    bn = k4.block_n(m, n, gs, fused_norm, sms)
    want = k4.quant_tiles(m, kdim, n, bn)
    out = torch.full((len(want), 2), -1, dtype=torch.int32, device="cuda")
    _build.launch("pt_quant_matmul_items", m, kdim, n, bn, out.data_ptr(),
                  _build.stream_of(out))
    assert out.cpu().tolist() == [list(t) for t in want], (
        f"{row['shape']}: the tiles decoded on the card differ from "
        f"quant_matmul.quant_tiles at block_n {bn}")
    row["block_n"], row["tiles"] = bn, len(want)
    return f"{len(want)} tiles of 128 x {bn} as the model walks them"


def check_quant_matmul(torch, timer, k4):
    """K4 at the o_proj and down_proj shapes of decode (M=8; down_proj
    also at M=16) and prefill (M=1024), int8 per channel, and down_proj
    int8 and int4 group 128 at M = 1024, int4 group 128 at M = 8. At every
    shape: two calls bitwise equal, TFLOP/s, the work the CTAs decode as
    the Python walk model has it, and the kernel with its scales shifted
    by SHIFT columns must fail ``k4.tolerance``."""
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
        row = {"shape": f"M{m} K{kdim} N{n} {wd} g{gs}",
               "max_abs_err": err, "err_over_tol": worst, "ms": ms,
               "plain_ms": plain, "bound_ms": bms, "bound_by": by,
               "library_ms": lib, "bf16_matmul_ms": dense}
        ctl = k4.quant_matmul_qw(x, _shifted(qw))
        ctl_worst = ((ctl.float() - ref.float()).abs() / tol).max().item()
        extra = "; " + _form_checks(
            torch, row, lambda: k4.quant_matmul_pure(x, *args), ctl_worst,
            2 * m * n * kdim) + "; " + _walk_check(
                torch, row, m, kdim, n, gs, fused_norm=False)
        del ctl
        log(f"K4 quant_matmul M{m} K{kdim} N{n} {wd} g{gs}: max_abs_err "
            f"{err:.3e} (worst err/tol {worst:.3f}) kernel_ms {ms:.4f} "
            f"plain_ms {plain:.4f} library_ms "
            f"{lib if lib is None else round(lib, 4)} (dequant + matmul) "
            f"bf16_matmul_ms {dense:.4f} bound_ms {bms:.4f} ({by}){extra}")
        rows.append(row)
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


NM_INT8_SHAPES = [(8, 4096, 14336, "int8", -1), (8, 4096, 4096, "int8", -1),
                  (8, 4096, 1024, "int8", -1), (8, 4096, 128256, "int8", -1),
                  (16, 4096, 14336, "int8", -1),
                  (1024, 4096, 14336, "int8", -1),
                  (1024, 4096, 4096, "int8", -1),
                  (1024, 4096, 1024, "int8", -1),
                  (1024, 4096, 14336, "int4", 128)]


def check_norm_matmul_int8(torch, timer, k2):
    """K2 with quantized weights: int8 per channel at the decode shapes
    (gate/up also at M = 16) and every prefill projection shape (q, k/v,
    gate/up), and the prefill gate/up shape in int4 group 128. The kernel
    dequantizes each weight exactly as the plain chain does, so only the
    summation order differs. At every shape: two calls bitwise equal,
    TFLOP/s, the work the CTAs decode as the Python walk model has it, and
    the kernel with its scales shifted by SHIFT columns must fail the
    rule."""
    eps = 1e-5
    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    rows, errs = [], []
    rms_norm = getattr(torch.nn.functional, "rms_norm", None)
    for m, kdim, n, wd, gs in NM_INT8_SHAPES:
        x = torch.randn((m, kdim), generator=g, device="cuda",
                        dtype=torch.bfloat16)
        nw = (torch.rand((kdim,), generator=g, device="cuda") + 0.5).to(
            torch.bfloat16)
        qw, _ = _quantize(torch, g, kdim, n, wd, gs)
        y = k2.fused_norm_matmul_pure(x, nw, eps, qw)
        ref = k2._reference(x, nw, eps, qw)
        torch.cuda.synchronize()
        diff = (y.float() - ref.float()).abs()
        err = diff.max().item()
        # as K2 dense: one bf16 output rounding in both, f32 sums in a
        # different order, rstd within 1 f32 ulp
        tol = 2e-2 + 1e-2 * ref.float().abs()
        ok = bool((diff <= tol).all())
        assert ok, f"norm_matmul {wd} g{gs} {m}x{kdim}x{n} max_abs_err {err}"
        ms = timer(lambda: k2.fused_norm_matmul_pure(x, nw, eps, qw))
        plain = timer(lambda: k2._reference(x, nw, eps, qw))
        lib = (timer(lambda: torch.matmul(
            rms_norm(x, (kdim,), nw, eps),
            qw.codes.to(torch.bfloat16) * qw.scales.to(torch.bfloat16)))
            if rms_norm is not None and (wd, gs) == ("int8", -1) else None)
        nbytes = (2 * (m * kdim + kdim + m * n) + qw.codes.numel()
                  + 4 * qw.scales.numel())
        bms, by = bound(nbytes, 2 * m * n * kdim, BF16_FLOPS)
        row = {"shape": f"M{m} K{kdim} N{n} {wd} g{gs}", "max_abs_err": err,
               "ms": ms, "plain_ms": plain, "bound_ms": bms,
               "bound_by": by, "library_ms": lib}
        ctl = k2.fused_norm_matmul_pure(x, nw, eps, _shifted(qw))
        ctl_worst = ((ctl.float() - ref.float()).abs() / tol).max().item()
        extra = "; " + _form_checks(
            torch, row, lambda: k2.fused_norm_matmul_pure(x, nw, eps, qw),
            ctl_worst, 2 * m * n * kdim) + "; " + _walk_check(
                torch, row, m, kdim, n, gs)
        del ctl
        log(f"K2 norm_matmul {wd} g{gs} M{m} K{kdim} N{n}: max_abs_err "
            f"{err:.3e} kernel_ms {ms:.4f} plain_ms {plain:.4f} library_ms "
            f"{lib if lib is None else round(lib, 4)} (rms_norm + dequant "
            f"+ matmul) bound_ms {bms:.4f} ({by}){extra}")
        rows.append(row)
        errs.append(err)
        del x, qw, y, ref, diff, tol
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
    row = {"name": "rope_append_attend_decode_int8"}
    walk = _walk_checks(
        torch, row, _decode_walk(kv_cache, (q, k, v, cos, sin), cp, layer,
                                 lens + 1), ref,
        lambda: k3.fused_rope_append_attend_decode(q, k, v, cos, sin, ck,
                                                   layer)[:1])
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
        f"plain_ms {plain:.4f} bound_ms {bms:.4f} ({by}); {walk}")
    return {**row, "route": "cuda",
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


def _walk_checks(torch, row, walk, ref, run):
    """The page walk's checks for a K10 or K3-decode row, into ``row``.
    ``walk`` = (q, k_pages, v_pages, block_tables, lens, scales): the
    row's attention as K10's plain version takes it (for K3, its rotated q
    over the pools with its own cells written, lens = the walk lengths).
    The plan (cluster size, CTAs, the most pages a CTA walks); the (rank,
    first page, end page) the CTAs decode on the card equal to
    ``paged_attention.walk_items``; two calls of ``run`` bitwise equal;
    and the fault control, the split walk's plain model with the last
    range's partial left out, whose worst err/tol against ``ref`` must
    fail the ``attention_tolerance`` rule."""
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import paged_attention as k10

    q, kp, vp, bt, lens, scales = walk
    hk, _, page, _ = kp.shape
    b, pps = bt.shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cs, grid = k10.walk_plan(b, hk, pps, sms)
    want = k10.walk_items(lens.tolist(), hk, pps, page, sms)
    out = torch.full((grid, 3), -1, dtype=torch.int32, device="cuda")
    _build.launch("pt_paged_walk_items", lens.data_ptr(), out.data_ptr(), b,
                  hk, page, pps, _build.stream_of(out))
    assert out.cpu().tolist() == [list(r) for r in want], (
        f"{row['name']}: the items decoded on the card differ from "
        f"paged_attention.walk_items (cs {cs}, grid {grid})")
    pages = max(hi - lo for _, lo, hi in want)
    assert _same_bits(torch, run), f"{row['name']}: two calls differ"
    control = k10.split_walk_reference(q, kp, vp, bt, lens, **scales, cs=cs,
                                       drop_last=True)
    abs_ref = k10.paged_attention_reference(q, kp, vp.abs(), bt, lens,
                                            **scales)
    ctl = ((control.float() - ref.float()).abs()
           / attention_tolerance(ref, abs_ref)).max().item()
    row.update(cluster=cs, ctas=grid, pages_per_cta=pages,
               control_worst_err_over_tol=ctl)
    assert ctl > 1, (f"{row['name']}: the dropped-range control passed "
                     f"(worst err/tol {ctl:.3f})")
    return (f"plan: clusters of {cs} on {grid} CTAs, at most {pages} pages "
            f"a CTA, items on the card = walk_items; two calls bitwise "
            f"equal; last-range-dropped control worst err/tol {ctl:.3f} "
            f"(fails, as it must)")


def _decode_walk(kv_cache, rows, cache, layer, lens):
    """``_walk_checks``' ``walk`` for a K3 decode row: the rotated q over
    the plain chain's pools of ``layer`` (its own cells written) and the
    walk lengths ``lens`` (int32)."""
    from paddle_tpu_torch.models.llama import apply_rotary_rows

    q, k, _, cos, sin = rows
    q2, _ = apply_rotary_rows(q, k, cos, sin)
    ks, vs = kv_cache.layer_scales(cache, layer)
    return (q2, cache.k_pages[layer], cache.v_pages[layer],
            cache.block_tables, lens, dict(k_scales=ks, v_scales=vs))


def batcher_wave(torch, kv_cache, rope_tables, seed, seqs=WAVE_SEQ,
                 chunks=WAVE_CHUNK, idle=WAVE_IDLE, int8=False):
    """The kernels phase's mixed wave at the batcher's shapes: a 2-layer
    bf16 cache (B=8, Hk=8, page 16, 40 pages per slot) of random K/V at
    the old lengths ``seqs`` (``int8``: an int8 cache at page 32, 20 pages
    per slot, every cell random K/V quantized on write); the wave's rows
    (q (T, 32, 128), k, v (T, 8, 128), cos/sin (T, 128) at each row's
    position) and its layout (row_slot, row_pos, valid, page_lens, q_start,
    q_lens, fresh_lens) as ContinuousBatcher._build_ragged_step lays a wave
    out: slot i prefills ``chunks[i]`` rows, or decodes one row unless it
    is ``idle``."""
    b, h, hk, d = BB, 32, 8, 128
    g = torch.Generator(device="cuda").manual_seed(seed)
    cache = kv_cache.create_paged_cache(
        2, b, BSEQ, hk, d, PAGE_INT8 if int8 else PAGE,
        dtype=torch.int8 if int8 else torch.bfloat16, device="cuda")
    if int8:
        for codes, scales in ((cache.k_pages, cache.k_scales),
                              (cache.v_pages, cache.v_scales)):
            c, sc = kv_cache.quantize_cells(
                torch.randn(codes.shape, generator=g, device="cuda"))
            codes.copy_(c)
            scales.copy_(sc)
    for pool in () if int8 else (cache.k_pages, cache.v_pages):
        pool.copy_(torch.randn(pool.shape, generator=g, device="cuda"))
    cache = cache._replace(seq_lens=torch.tensor(
        seqs, dtype=torch.int32, device="cuda"))
    row_slot, row_pos = [-1] * BT, [0] * BT
    q_start, q_lens, fresh, page_lens = [0] * b, [0] * b, [0] * b, [0] * b
    row = b
    for i, (seq, chunk) in enumerate(zip(seqs, chunks)):
        if chunk:
            q_start[i], q_lens[i], fresh[i], page_lens[i] = (row, chunk,
                                                             chunk, seq)
            row_slot[row:row + chunk] = [i] * chunk
            row_pos[row:row + chunk] = range(seq, seq + chunk)
            row += chunk
        elif i != idle:
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
    """The cache with its own copy of its K/V pools (or the given ones) and,
    on an int8 cache, of its scale pools."""
    scales = {n: getattr(cache, n).clone() for n in ("k_scales", "v_scales")
              if getattr(cache, n) is not None}
    return cache._replace(k_pages=pools.get("k", cache.k_pages).clone(),
                          v_pages=pools.get("v", cache.v_pages).clone(),
                          **scales)


def _written_cells(torch, cache, layer, slots, positions):
    """(L, Hk, P, page) mask of the cells at (slot, position) in ``layer``."""
    page = cache.k_pages.shape[3]
    mask = torch.zeros(cache.k_pages.shape[:-1], dtype=torch.bool,
                       device="cuda")
    slots, positions = slots.long(), positions.long()
    phys = cache.block_tables[slots, positions // page].long()
    mask[layer, :, phys, positions % page] = True
    return mask


def _check_pools(torch, new, ref, old, written, label):
    """Pools bit-identical to the plain chain's (an int8 cache: codes
    within 1, for a rounding boundary, and scales bit-identical), and every
    cell outside the written ones as it was. Returns the codes that differ
    (0 on a bf16 cache)."""
    codes = 0
    names = ("k_pages", "v_pages") + (("k_scales", "v_scales")
                                      if new.quantized else ())
    for name in names:
        a, b_, o = (getattr(c, name) for c in (new, ref, old))
        if a.dtype == torch.int8:
            dq = (a.int() - b_.int()).abs()
            assert int(dq.max()) <= 1, f"{label}: a {name} code differs by > 1"
            codes += int((dq > 0).sum())
        else:
            differing = int((a != b_).sum())
            assert differing == 0, f"{label}: {differing} {name} values differ"
        keep = (~written)[..., None].expand_as(a)
        assert torch.equal(a[keep], o[keep]), \
            f"{label}: a {name} cell other than the written ones changed"
    return codes


def _ragged_checks(torch, label, entry, split, ref, abs_ref, run, lens,
                   scales=None, drop_tile_page=False):
    """The ragged walk's checks for a K11 or K3-ragged wave. ``split`` =
    (q, k_pages, v_pages, block_tables, page_lens, q_start, q_lens,
    fresh_lens, k_fresh, v_fresh): the wave's attention as K11's plain
    version takes it (for K3: its rotated q over the pools with the cells
    written, the rotated k, non-finite fresh values zeroed). The plan
    (cluster size, CTAs, tile and walk items, the most pages a CTA walks,
    the clusters with work against the most the card holds at once, from
    ``entry``, the form's plan export: all of them resident); the items
    the CTAs decode on the card equal to ``ragged_items``; two calls of
    ``run`` bitwise equal; and the fault control, the split walk's plain
    model with the last range of every walk left out (``scales``: an int8
    cache's, as keywords; ``drop_tile_page``: also every tile's last page,
    the control of a wave with no walk), whose worst err/tol against
    ``ref`` must fail the ``attention_tolerance`` rule. Returns (the plan's
    fields, a log line)."""
    import ctypes

    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import ragged_paged_attention as k11

    q, kp, vp, bt = split[:4]
    hk, _, page, _ = kp.shape
    t, h, _ = q.shape
    b, pps = bt.shape
    g = h // hk
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cs, clusters, ctas = k11.ragged_plan(t, b, hk, g, pps, sms)
    plan = (ctypes.c_int * 4)()
    _build.launch(entry, t, b, h, hk, page, pps, ctypes.addressof(plan))
    assert list(plan)[:2] == [cs, clusters], (label, list(plan), cs,
                                              clusters)
    page_lens, _, q_lens, fresh = (x.tolist() for x in lens)
    want = k11.ragged_items(q_lens, page_lens, fresh, t, hk, g, pps, page,
                            sms)
    out = torch.full((ctas, 6), -7, dtype=torch.int32, device="cuda")
    _build.launch("pt_ragged_items", lens[0].data_ptr(), lens[2].data_ptr(),
                  lens[3].data_ptr(), out.data_ptr(), t, b, h, hk, page, pps,
                  _build.stream_of(out))
    assert out.cpu().tolist() == [list(r) for r in want], (
        f"{label}: the items decoded on the card differ from ragged_items "
        f"(cs {cs}, grid {ctas})")
    tiles = sum(r[0] == k11.RAGGED_TILE for r in want)
    walks = sum(r[0] == k11.RAGGED_WALK for r in want)
    pages = max(-(-(r[5] - r[4]) // page) if r[0] == k11.RAGGED_WALK
                else -(-page_lens[r[1]] // page) for r in want if r[0])
    working = len({(r[2], i // cs) for i, r in enumerate(want) if r[0]})
    assert working <= plan[3], (f"{label}: {working} clusters with work, "
                                f"the card holds {plan[3]} at once")
    assert _same_bits(torch, run), f"{label}: two calls differ"
    control = k11.split_ragged_reference(*split, **(scales or {}), cs=cs,
                                         drop_last=True,
                                         drop_tile_page=drop_tile_page)
    ctl = ((control.float() - ref.float()).abs()
           / attention_tolerance(ref, abs_ref)).max().item()
    assert ctl > 1, (f"{label}: the dropped-range control passed (worst "
                     f"err/tol {ctl:.3f})")
    fields = dict(cluster=cs, ctas=ctas, tile_items=tiles, walk_items=walks,
                  pages_per_cta=pages, clusters_with_work=working,
                  clusters_resident=plan[3], smem_bytes=plan[2],
                  control_worst_err_over_tol=ctl)
    return fields, (
        f"plan: clusters of {cs}, {ctas} CTAs ({tiles} tile items, {walks} "
        f"walk CTAs), at most {pages} pages a CTA, {working} clusters with "
        f"work of {plan[3]} resident at once, {plan[2]} B of shared memory; "
        f"items on the card = ragged_items; two calls bitwise equal; "
        f"last-{'page' if drop_tile_page else 'range'}-dropped control "
        f"worst err/tol {ctl:.3f} (fails, as it must)")


def _wave_name(seqs, chunks, idle):
    parts = [f"chunk {c} on {s}" for s, c in zip(seqs, chunks) if c]
    dec = [s + 1 for i, (s, c) in enumerate(zip(seqs, chunks))
           if not c and i != idle]
    return (", ".join(parts) + f", decode lens {dec}"
            + (f", slot {idle} idle" if idle is not None else ""))


def _ragged_bound(q, out, lens, extra_bytes, written=0, int8=False):
    """(bound ms, by) of a ragged wave of the batcher's shapes (8 kv
    heads): q and out once, ``extra_bytes`` (the fresh K/V, ...), every
    visible page cell's K and V once (``written`` cells of them written by
    the call itself and not read; bf16, or ``int8`` codes and an f32
    scale), the block tables and layout, 4 D flops a (query row, visible
    key) pair."""
    page_lens, _, q_lens, fresh = (x.long() for x in lens)
    keys = int((page_lens * q_lens).sum() + (fresh * (fresh + 1) // 2).sum())
    cell = 128 + 4 if int8 else 2 * 128
    page = PAGE_INT8 if int8 else PAGE
    nbytes = (2 * (q.numel() + out.numel()) + extra_bytes
              + 2 * (int(page_lens.sum()) - written) * 8 * cell
              + 4 * (BB * (BSEQ // page) + 4 * BB))
    return bound(nbytes, 4 * keys * q.shape[1] * 128, BF16_FLOPS)


def _scales(cache, layer):
    """An int8 cache's scale pools of ``layer`` as keywords ({} on bf16)."""
    if not cache.quantized:
        return {}
    return {"k_scales": cache.k_scales[layer],
            "v_scales": cache.v_scales[layer]}


def _k11_wave(torch, timer, k11, kv_cache, rope_tables, seed, spec, int8):
    """K11 on one wave (layer 1's pools; q, fresh K/V random): checks,
    plan and times."""
    cache, (q, kf, vf, _, _), wave = batcher_wave(
        torch, kv_cache, rope_tables, seed, *spec, int8=int8)
    kp, vp = cache.k_pages[1], cache.v_pages[1]
    sc = _scales(cache, 1)
    lens = wave[3:]                       # page_lens, q_start, q_lens, fresh
    args = (q, kp, vp, cache.block_tables, *lens)
    out = k11.ragged_paged_attention_pure(*args, kf, vf, **sc)
    ref = k11.ragged_paged_attention_reference(*args, kf, vf, **sc)
    abs_ref = k11.ragged_paged_attention_reference(
        q, kp, vp.abs(), cache.block_tables, *lens, kf, vf.abs(), **sc)
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    worst = (diff / attention_tolerance(ref, abs_ref)).max().item()
    name = _wave_name(*spec)
    form = "K11 int8" if int8 else "K11"
    assert worst <= 1, f"{form} ({name}) worst err/tol {worst:.3f}"
    assert not out[wave[0] < 0].any(), \
        f"{form} ({name}): a padding row is not zero"
    plan, walk = _ragged_checks(
        torch, f"{form} ({name})",
        "pt_ragged_paged_attention_int8_plan" if int8
        else "pt_ragged_paged_attention_plan", (*args, kf, vf), ref, abs_ref,
        lambda: (k11.ragged_paged_attention_pure(*args, kf, vf, **sc),), lens,
        scales=sc)
    ms = timer(lambda: k11.ragged_paged_attention_pure(*args, kf, vf, **sc))
    plain = timer(lambda: k11.ragged_paged_attention_reference(*args, kf,
                                                               vf, **sc))
    bms, by = _ragged_bound(q, out, lens, 2 * (kf.numel() + vf.numel()),
                            int8=int8)
    page = kp.shape[2]
    log(f"{form} ragged_paged_attention T{BT} H32/8 page{page} {name}: "
        f"max_abs_err {diff.max().item():.3e} (worst err/tol {worst:.3f}) "
        f"kernel_ms {ms:.4f} plain_ms {plain:.4f} bound_ms {bms:.4f} ({by}); "
        f"{walk}")
    return {"max_abs_err": diff.max().item(), "err_over_tol": worst,
            "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
            "library_ms": None, **plan,
            "shape": f"T{BT} B{BB} H32 Hk8 D128 page{page}"
                     f"{' int8' if int8 else ''} {name}"}


def check_ragged_attention(torch, timer, k11, kv_cache, rope_tables,
                           int8=False):
    """K11 on the mixed wave and on the second wave (a 256-row chunk on
    256 cells of context, seven decode rows); ``int8``: on an int8 cache
    at page 32."""
    first, second = (_k11_wave(torch, timer, k11, kv_cache, rope_tables,
                               SEED + 8 + 10 * i + 100 * int8, spec, int8)
                     for i, spec in enumerate(RAGGED_WAVES))
    return {"name": "ragged_paged_attention" + ("_int8" if int8 else ""),
            "route": "cuda",
            "source": "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
            "replaces": "paddle_tpu/ops/pallas/ragged_paged_attention.py:244",
            **first, "second_wave": second}


def _k3_ragged_wave(torch, timer, k3, kv_cache, rope_tables, seed, spec,
                    int8):
    """K3's ragged form on one wave: output, the written cells against the
    plain chain (bf16: bit for bit; int8: codes within 1, scales bit for
    bit), every other cell untouched; plan and times."""
    from paddle_tpu_torch.models.llama import apply_rotary_rows
    from paddle_tpu_torch.ops.kernels import ragged_paged_attention as k11

    cache, rows, wave = batcher_wave(torch, kv_cache, rope_tables, seed,
                                     *spec, int8=int8)
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
    name = _wave_name(*spec)
    form = "K3 ragged int8" if int8 else "K3 ragged"
    assert worst <= 1, f"{form} ({name}) worst err/tol {worst:.3f}"
    valid = wave[2]
    assert not out[~valid].any(), \
        f"{form} ({name}): a padding row is not zero"
    written = _written_cells(torch, cache, layer, wave[0][valid],
                             wave[1][valid])
    codes = _check_pools(torch, ck, cp, cache, written, f"{form} ({name})")
    q2, k2 = apply_rotary_rows(q, k, cos, sin)
    lens = wave[3:]
    split = (q2, cp.k_pages[layer], cp.v_pages[layer], cp.block_tables,
             *lens, k11.zero_non_finite(k2), k11.zero_non_finite(v))
    plan, walk = _ragged_checks(
        torch, f"{form} ({name})",
        "pt_rope_append_attend_ragged_int8_plan" if int8
        else "pt_rope_append_attend_ragged_plan",
        split, ref, abs_ref,
        lambda: k3.fused_rope_append_attend(*rows, _pool_copy(cache), layer,
                                            *wave)[:1], lens,
        scales=_scales(cp, layer))
    ms = timer(lambda: k3.fused_rope_append_attend(*rows, ck, layer, *wave))
    plain = timer(lambda: k3.ragged_reference(*rows, cp, layer, *wave,
                                              plain=True))
    n_valid = int(valid.sum())
    page_lens, _, q_lens, fresh = (x.long() for x in lens)
    # decode rows read their own new cell back: the cells this wave writes
    # are not read from the pool
    own = int((q_lens * (fresh == 0)).sum())
    cell = 128 + 4 if int8 else 2 * 128
    bms, by = _ragged_bound(
        q, out, lens,
        2 * (k.numel() + v.numel()) + 4 * (cos.numel() + sin.numel())
        + 2 * n_valid * 8 * cell + 4 * BT, written=own, int8=int8)
    page = cache.k_pages.shape[3]
    log(f"{form} rope_append_attend T{BT} H32/8 page{page} {name}: "
        f"max_abs_err {diff.max().item():.3e} (worst err/tol {worst:.3f}) "
        f"pool values differing 0"
        + (f" but {codes} codes by 1" if int8 else "")
        + f", {n_valid} rows written, kernel_ms {ms:.4f} plain_ms "
        f"{plain:.4f} bound_ms {bms:.4f} ({by}); {walk}")
    return {"max_abs_err": diff.max().item(), "err_over_tol": worst,
            **({"codes_differing": codes} if int8 else {}),
            "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
            "library_ms": None, **plan,
            "shape": f"T{BT} B{BB} H32 Hk8 D128 page{page}"
                     f"{' int8' if int8 else ''} {name}"}


def check_rope_attend_ragged(torch, timer, k3, kv_cache, rope_tables,
                             int8=False):
    """K3's ragged form on the mixed wave and on the second wave;
    ``int8``: on an int8 cache at page 32."""
    first, second = (_k3_ragged_wave(torch, timer, k3, kv_cache,
                                     rope_tables, SEED + 9 + 10 * i
                                     + 100 * int8, spec, int8)
                     for i, spec in enumerate(RAGGED_WAVES))
    return {"name": "rope_append_attend_ragged" + ("_int8" if int8 else ""),
            "route": "cuda",
            "source": "paddle_tpu_torch/csrc/rope_append_attend.cu",
            "replaces": "paddle_tpu/ops/pallas/fused_rope_attend.py:441",
            **first, "second_wave": second}


def verify_wave(torch, kv_cache, rope_tables, seed, int8=False):
    """The kernels phase's verify wave (VERIFY_SEQ, VERIFY_ROWS), laid out
    as ContinuousBatcher's spec wave lays it out: prompt chunks first, then
    the verify segments in slot order; every segment's rows are fresh
    (fresh_lens = q_lens) over its old context (page_lens = old length).
    The cache as ``batcher_wave``'s (random K/V; int8: page 32, codes and
    scales of random K/V). Returns (cache, rows, wave, flag): the flag
    (B,) bool marks the verify segments."""
    b, h, hk, d = BB, 32, 8, 128
    cache, _, _ = batcher_wave(torch, kv_cache, rope_tables, seed,
                               seqs=VERIFY_SEQ, chunks=(BT - BB,) + (0,) * 7,
                               idle=None, int8=int8)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    row_slot, row_pos = [-1] * BT, [0] * BT
    q_start, flag = [0] * b, [False] * b
    row = 0
    for i in sorted(range(b), key=lambda i: VERIFY_ROWS[i] <= SPEC_K + 1):
        n, seq = VERIFY_ROWS[i], VERIFY_SEQ[i]
        q_start[i], flag[i] = row, n <= SPEC_K + 1
        row_slot[row:row + n] = [i] * n
        row_pos[row:row + n] = range(seq, seq + n)
        row += n
    assert row == sum(VERIFY_ROWS) == BT - 9, row
    i32 = dict(dtype=torch.int32, device="cuda")
    rs, rp = torch.tensor(row_slot, **i32), torch.tensor(row_pos, **i32)
    q_lens = torch.tensor(VERIFY_ROWS, **i32)
    wave = (rs, rp, rs >= 0, torch.tensor(VERIFY_SEQ, **i32),
            torch.tensor(q_start, **i32), q_lens, q_lens.clone())
    cos_t, sin_t = rope_tables(BSEQ, d, 500000.0, device="cuda")
    rows = tuple(torch.randn(shape, generator=g, device="cuda",
                             dtype=torch.bfloat16)
                 for shape in ((BT, h, d), (BT, hk, d), (BT, hk, d)))
    return (cache, rows + (cos_t[rp.long()], sin_t[rp.long()]), wave,
            torch.tensor(flag, dtype=torch.bool, device="cuda"))


VERIFY_NAME = (f"verify wave: chunk {VERIFY_ROWS[0]} on {VERIFY_SEQ[0]}, "
               f"verify segments (rows on old length) "
               + ", ".join(f"{n} on {s}" for n, s in zip(VERIFY_ROWS[1:],
                                                         VERIFY_SEQ[1:])))


def _flag_checks(torch, label, out, off, ref, abs_ref, int8):
    """A flagged form's output against its flagged plain version: worst
    err/tol, and on an int8 cache the same call without the flag (``off``),
    whose distance must be larger (the flag is what makes the verify rows
    read the pool's values). Returns (worst, flag-off worst or None)."""
    tol = attention_tolerance(ref, abs_ref)
    worst = ((out.float() - ref.float()).abs() / tol).max().item()
    assert worst <= 1, f"{label} worst err/tol {worst:.3f}"
    if not int8:
        assert torch.equal(out, off), f"{label}: the flag changed a bit"
        return worst, None
    worst_off = ((off.float() - ref.float()).abs() / tol).max().item()
    assert worst_off > worst, (f"{label}: flag off {worst_off:.3f} not "
                               f"further than flag on {worst:.3f}")
    return worst, worst_off


def check_ragged_attention_verify(torch, timer, k11, kv_cache, rope_tables,
                                  int8=False):
    """K11 with ``fresh_pool_read`` on the verify wave (layer 1's pools; q
    and fresh K/V random): within the attention tolerance of its plain
    version with the pool roundtrip (``fresh_through_pool``); bf16: bitwise
    the unflagged call; int8: the unflagged call further from it; plan,
    items, repeat, rows of no segment zero, the dropped-page control;
    times."""
    cache, (q, kf, vf, _, _), wave, flag = verify_wave(
        torch, kv_cache, rope_tables, SEED + 30 + 100 * int8, int8=int8)
    kp, vp = cache.k_pages[1], cache.v_pages[1]
    sc = _scales(cache, 1)
    lens = wave[3:]
    args = (q, kp, vp, cache.block_tables, *lens)
    kc, vc = k11.fresh_through_pool(kf, vf, flag, lens[1], lens[2], int8,
                                    kp.dtype)
    out = k11.ragged_paged_attention_pure(*args, kf, vf, **sc,
                                          fresh_pool_read=flag)
    off = k11.ragged_paged_attention_pure(*args, kf, vf, **sc)
    ref = k11.ragged_paged_attention_reference(*args, kc, vc, **sc)
    abs_ref = k11.ragged_paged_attention_reference(
        q, kp, vp.abs(), cache.block_tables, *lens, kc, vc.abs(), **sc)
    torch.cuda.synchronize()
    form = "K11 int8 fresh_pool_read" if int8 else "K11 fresh_pool_read"
    worst, worst_off = _flag_checks(torch, form, out, off, ref, abs_ref,
                                    int8)
    assert not out[wave[0] < 0].any(), f"{form}: a padding row is not zero"
    plan, walk = _ragged_checks(
        torch, f"{form} ({VERIFY_NAME})",
        "pt_ragged_paged_attention_int8_plan" if int8
        else "pt_ragged_paged_attention_plan", (*args, kc, vc), ref, abs_ref,
        lambda: (k11.ragged_paged_attention_pure(*args, kf, vf, **sc,
                                                 fresh_pool_read=flag),),
        lens, scales=sc, drop_tile_page=True)
    assert plan["walk_items"] == 0, plan
    ms = timer(lambda: k11.ragged_paged_attention_pure(
        *args, kf, vf, **sc, fresh_pool_read=flag))
    off_ms = timer(lambda: k11.ragged_paged_attention_pure(*args, kf, vf,
                                                           **sc))
    plain = timer(lambda: k11.ragged_paged_attention_reference(
        *args, *k11.fresh_through_pool(kf, vf, flag, lens[1], lens[2], int8,
                                       kp.dtype), **sc))
    bms, by = _ragged_bound(q, out, lens,
                            2 * (kf.numel() + vf.numel()) + BB, int8=int8)
    diff = (out.float() - ref.float()).abs().max().item()
    page = kp.shape[2]
    log(f"{form} ragged_paged_attention T{BT} H32/8 page{page} "
        f"{VERIFY_NAME}: max_abs_err {diff:.3e} (worst err/tol "
        f"{worst:.3f}" + (f"; flag off {worst_off:.3f}" if int8 else
                          "; flag off bitwise equal") + f") kernel_ms "
        f"{ms:.4f} (flag off {off_ms:.4f}) plain_ms {plain:.4f} bound_ms "
        f"{bms:.4f} ({by}); {walk}")
    return {"name": "ragged_paged_attention" + ("_int8" if int8 else "")
                    + "_verify",
            "route": "cuda",
            "source": "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
            "replaces": "paddle_tpu/ops/pallas/ragged_paged_attention.py:244",
            "max_abs_err": diff, "err_over_tol": worst,
            "flag_off_err_over_tol": worst_off, "ms": ms,
            "flag_off_ms": off_ms, "plain_ms": plain,
            "bound_ms": bms, "bound_by": by, "library_ms": None, **plan,
            "shape": f"T{BT} B{BB} H32 Hk8 D128 page{page}"
                     f"{' int8' if int8 else ''} {VERIFY_NAME}"}


def check_rope_attend_ragged_verify(torch, timer, k3, kv_cache, rope_tables,
                                    int8=False):
    """K3's ragged form with ``fresh_pool_read`` on the verify wave: as
    ``check_ragged_attention_verify``, plus the pools against the plain
    chain's (bf16: bit for bit; int8: codes within 1, scales bit for bit)
    and every other cell untouched."""
    from paddle_tpu_torch.models.llama import apply_rotary_rows
    from paddle_tpu_torch.ops.kernels import ragged_paged_attention as k11

    cache, rows, wave, flag = verify_wave(
        torch, kv_cache, rope_tables, SEED + 31 + 100 * int8, int8=int8)
    layer = 1
    ck, cp = _pool_copy(cache), _pool_copy(cache)
    out, ck = k3.fused_rope_append_attend(*rows, ck, layer, *wave,
                                          fresh_pool_read=flag)
    off, _ = k3.fused_rope_append_attend(*rows, _pool_copy(cache), layer,
                                         *wave)
    ref, cp = k3.ragged_reference(*rows, cp, layer, *wave, plain=True,
                                  fresh_pool_read=flag)
    q, k, v, cos, sin = rows
    ca = _pool_copy(cache, v=cache.v_pages.abs())
    abs_ref, _ = k3.ragged_reference(q, k, v.abs(), cos, sin, ca, layer,
                                     *wave, plain=True, fresh_pool_read=flag)
    torch.cuda.synchronize()
    form = ("K3 ragged int8 fresh_pool_read" if int8
            else "K3 ragged fresh_pool_read")
    worst, worst_off = _flag_checks(torch, form, out, off, ref, abs_ref,
                                    int8)
    valid = wave[2]
    assert not out[~valid].any(), f"{form}: a padding row is not zero"
    written = _written_cells(torch, cache, layer, wave[0][valid],
                             wave[1][valid])
    codes = _check_pools(torch, ck, cp, cache, written, form)
    q2, k2 = apply_rotary_rows(q, k, cos, sin)
    lens = wave[3:]
    kc, vc = k11.fresh_through_pool(k2, v, flag, lens[1], lens[2], int8,
                                    cache.k_pages.dtype)
    split = (q2, cp.k_pages[layer], cp.v_pages[layer], cp.block_tables,
             *lens, kc, vc)
    plan, walk = _ragged_checks(
        torch, f"{form} ({VERIFY_NAME})",
        "pt_rope_append_attend_ragged_int8_plan" if int8
        else "pt_rope_append_attend_ragged_plan", split, ref, abs_ref,
        lambda: k3.fused_rope_append_attend(*rows, _pool_copy(cache), layer,
                                            *wave, fresh_pool_read=flag)[:1],
        lens, scales=_scales(cp, layer), drop_tile_page=True)
    assert plan["walk_items"] == 0, plan
    ms = timer(lambda: k3.fused_rope_append_attend(*rows, ck, layer, *wave,
                                                   fresh_pool_read=flag))
    off_ms = timer(lambda: k3.fused_rope_append_attend(*rows, ck, layer,
                                                       *wave))
    plain = timer(lambda: k3.ragged_reference(*rows, cp, layer, *wave,
                                              plain=True,
                                              fresh_pool_read=flag))
    n_valid = int(valid.sum())
    cell = 128 + 4 if int8 else 2 * 128
    bms, by = _ragged_bound(
        q, out, lens,
        2 * (k.numel() + v.numel()) + 4 * (cos.numel() + sin.numel())
        + 2 * n_valid * 8 * cell + 4 * BT + BB, int8=int8)
    diff = (out.float() - ref.float()).abs().max().item()
    page = cache.k_pages.shape[3]
    log(f"{form} rope_append_attend T{BT} H32/8 page{page} {VERIFY_NAME}: "
        f"max_abs_err {diff:.3e} (worst err/tol {worst:.3f}"
        + (f"; flag off {worst_off:.3f}" if int8 else
           "; flag off bitwise equal")
        + f") pool values differing 0"
        + (f" but {codes} codes by 1" if int8 else "")
        + f", {n_valid} rows written, kernel_ms {ms:.4f} (flag off "
        f"{off_ms:.4f}) plain_ms {plain:.4f} bound_ms {bms:.4f} ({by}); "
        f"{walk}")
    return {"name": "rope_append_attend_ragged" + ("_int8" if int8 else "")
                    + "_verify",
            "route": "cuda",
            "source": "paddle_tpu_torch/csrc/rope_append_attend.cu",
            "replaces": "paddle_tpu/ops/pallas/fused_rope_attend.py:441",
            "max_abs_err": diff, "err_over_tol": worst,
            "flag_off_err_over_tol": worst_off,
            **({"codes_differing": codes} if int8 else {}),
            "ms": ms, "flag_off_ms": off_ms, "plain_ms": plain,
            "bound_ms": bms, "bound_by": by,
            "library_ms": None, **plan,
            "shape": f"T{BT} B{BB} H32 Hk8 D128 page{page}"
                     f"{' int8' if int8 else ''} {VERIFY_NAME}"}


def _segment_step_inputs(torch, kv_cache, rope_tables, seed, int8=False):
    """A segment step's decode rows at the batcher's shapes: the mixed
    wave's cache (``int8``: its int8 form) at old lengths WAVE_SEQ, q (8,
    32, 128), k/v (8, 8, 128), cos/sin at each slot's position, every slot
    active but WAVE_IDLE."""
    cache, _, _ = batcher_wave(torch, kv_cache, rope_tables, seed,
                               int8=int8)
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


def check_paged_attention(torch, timer, k10, kv_cache, rope_tables,
                          int8=False):
    """K10 at a segment step's shape: lengths WAVE_SEQ + 1, 0 for the idle
    slot; ``int8``: on an int8 cache at page 32."""
    cache, (q, _, _, _, _), active = _segment_step_inputs(
        torch, kv_cache, rope_tables, SEED + 10 + 100 * int8, int8=int8)
    lens = torch.where(active, cache.seq_lens + 1, 0).to(torch.int32)
    kp, vp = cache.k_pages[1], cache.v_pages[1]
    sc = _scales(cache, 1)
    args = (q, kp, vp, cache.block_tables, lens)
    out = k10.paged_attention_pure(*args, **sc)
    ref = k10.paged_attention_reference(*args, **sc)
    abs_ref = k10.paged_attention_reference(q, kp, vp.abs(),
                                            cache.block_tables, lens, **sc)
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    worst = (diff / attention_tolerance(ref, abs_ref)).max().item()
    form = "paged_attention" + (" int8" if int8 else "")
    assert worst <= 1, f"{form} worst err/tol {worst:.3f}"
    assert not out[WAVE_IDLE].any(), "the length-0 slot is not zero"
    row = {"name": "paged_attention" + ("_int8" if int8 else "")}
    walk = _walk_checks(torch, row, (*args, sc), ref,
                        lambda: (k10.paged_attention_pure(*args, **sc),))
    ms = timer(lambda: k10.paged_attention_pure(*args, **sc))
    plain = timer(lambda: k10.paged_attention_reference(*args, **sc))
    cells = int(lens.sum())
    cell = 128 + 4 if int8 else 2 * 128
    nbytes = (2 * (q.numel() + out.numel()) + 2 * cells * 8 * cell
              + 4 * (cache.block_tables.numel() + BB))
    bms, by = bound(nbytes, 4 * cells * 32 * 128, BF16_FLOPS)
    page = kp.shape[2]
    log(f"K10 {form} B{BB} H32/8 page{page} lens {lens.tolist()}: "
        f"max_abs_err {diff.max().item():.3e} (worst err/tol {worst:.3f}) "
        f"kernel_ms {ms:.4f} plain_ms {plain:.4f} bound_ms {bms:.4f} ({by}); "
        f"{walk}")
    return {**row, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/paged_attention.cu",
            "replaces": "paddle_tpu/ops/pallas/paged_attention.py:142",
            "max_abs_err": diff.max().item(), "err_over_tol": worst,
            "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
            "library_ms": None,
            "shape": f"B{BB} H32 Hk8 D128 page{page}"
                     f"{' int8' if int8 else ''} lens {lens.tolist()}"}


def check_rope_attend_masked(torch, timer, k3, kv_cache, rope_tables,
                             int8=False):
    """K3's decode form with an active mask at a segment step's shape: the
    idle slot writes nothing and returns zeros; ``int8``: on an int8 cache
    at page 32 (the int8 batcher's segment step; codes within 1 of the
    plain chain's, scales bit-identical)."""
    cache, rows, active = _segment_step_inputs(
        torch, kv_cache, rope_tables, SEED + 11 + 100 * int8, int8=int8)
    layer = 1
    form = "rope_append_attend masked" + (" int8" if int8 else "")
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
    assert worst <= 1, f"{form} worst err/tol {worst:.3f}"
    assert not out[WAVE_IDLE].any(), "the inactive slot is not zero"
    slots = torch.arange(BB, device="cuda")[active]
    written = _written_cells(torch, cache, layer, slots,
                             cache.seq_lens[active])
    codes = _check_pools(torch, ck, cp, cache, written, form)
    row = {"name": "rope_append_attend_masked" + ("_int8" if int8 else "")}
    lens = torch.where(active, cache.seq_lens + 1, 0).to(torch.int32)
    walk = _walk_checks(
        torch, row, _decode_walk(kv_cache, rows, cp, layer, lens), ref,
        lambda: k3.fused_rope_append_attend_decode(*rows, ck, layer,
                                                   active)[:1])
    ms = timer(lambda: k3.fused_rope_append_attend_decode(*rows, ck, layer,
                                                          active))
    plain = timer(lambda: k3.decode_reference(*rows, cp, layer, active,
                                              plain=True))
    n_act = int(active.sum())
    cells = int((cache.seq_lens + 1)[active].sum())
    cell = 128 + 4 if int8 else 2 * 128
    nbytes = (2 * (q.numel() + k.numel() + v.numel() + out.numel())
              + 4 * (cos.numel() + sin.numel()) + BB
              + 2 * (cells - n_act) * 8 * cell   # pages read
              + 2 * n_act * 8 * cell             # the new cells written
              + 4 * (cache.block_tables.numel() + BB))
    bms, by = bound(nbytes, 4 * cells * 32 * 128, BF16_FLOPS)
    page = cache.k_pages.shape[3]
    log(f"K3 {form} B{BB} H32/8 page{page} lens "
        f"{cache.seq_lens.tolist()} idle slot {WAVE_IDLE}: max_abs_err "
        f"{diff.max().item():.3e} (worst err/tol {worst:.3f}) pool values "
        f"differing 0" + (f" but {codes} codes by 1" if int8 else "")
        + f", kernel_ms {ms:.4f} plain_ms {plain:.4f} bound_ms "
        f"{bms:.4f} ({by}); {walk}")
    return {**row, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/rope_append_attend.cu",
            "replaces": "paddle_tpu/ops/pallas/fused_rope_attend.py:441",
            "max_abs_err": diff.max().item(), "err_over_tol": worst,
            **({"codes_differing": codes} if int8 else {}),
            "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
            "library_ms": None,
            "shape": f"B{BB} H32 Hk8 D128 page{page}"
                     f"{' int8' if int8 else ''} seq_lens "
                     f"{list(WAVE_SEQ)} active but slot {WAVE_IDLE}"}


def _kernel_class(name):
    if "norm_rstd_kernel" in name:  # every K2 call with M > 16 runs it first
        return "K2 norm_rstd"
    if "flash_delta_kernel" in name:
        return "K5/K9 delta (the backward's first pass)"
    if "flash_fwd_kernel" in name:
        return "K1 flash_attention_fwd"
    if "flash_bwd_fused_kernel" in name or "flash_dq_reduce_kernel" in name:
        return "K9 flash_attention_bwd_fused"
    if "rope_kernel" in name and "append" not in name:
        return "K12 rope"
    if "flash_dq_kernel" in name or "flash_dkv_kernel" in name:
        return "K5 flash_attention_bwd"
    if "rms_fwd_kernel" in name:
        return "K6 rms_norm_fwd"
    if "rms_bwd_kernel" in name or "rms_dw_sum_kernel" in name:
        return "K7 rms_norm_bwd"  # a call: the row kernel and the dw sum
    if "adamw8bit_kernel" in name:
        return "K8 adamw8bit"
    if "GroupWalk" in name:  # quant_wgmma_kernel<..., GroupWalk<BN>>
        return "K13 grouped_matmul (int8/int4)"
    if "grouped_matmul_kernel<false>" in name:
        return "K13 grouped_matmul (forward)"
    if "grouped_matmul_kernel<true>" in name:
        return "K13 grouped_matmul (dX form)"
    if "segment_dw_kernel" in name:
        return "K14 segment_dw"
    mm = re.search(r"(?:skinny|quant)_wgmma_kernel<([^>]*)>", name)
    if mm:  # template arguments start with NORM, weight type
        norm, wt = (a.strip() for a in mm.group(1).split(",")[:2])
        wd = {"0": "bf16", "1": "int8", "2": "int4"}.get(wt, wt)
        return (f"K2 norm_matmul ({wd})" if norm == "true"
                else f"K4 quant_matmul ({wd})")
    if "skinny_wgmma_kernel" in name or "quant_wgmma_kernel" in name:
        return "K2/K4 matmul"
    if "rope_append_attend_kernel" in name:
        return "K3 rope_append_attend (decode)"
    if "ragged_walk_kernel<true" in name:
        return "K3 rope_append_attend (ragged)"
    if "ragged_walk_kernel<false" in name:
        return "K11 ragged_paged_attention"
    if "paged_attention_kernel" in name:
        return "K10 paged_attention"
    if "gemm" in name or "nvjet" in name or "cutlass" in name \
            or "xmma" in name:
        return "cuBLAS matmul (serving: o_proj, down_proj; train: also " \
            "every backward product and the loss chunks)"
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


def replay_draft(continuations, vocab):
    """A ``DraftProposer`` replaying recorded continuations: for a history
    that begins with one of ``continuations``' prompts ((prompt, tokens)
    pairs: what a spec-off run emitted after it), the next tokens of that
    continuation, every fourth of them replaced by its successor mod
    ``vocab``, so that verify steps both accept drafts and reject (rewind)
    some. It records each proposal; ``accepted(outputs)`` counts, against
    the tokens a run finally emitted (prompt -> tokens), the proposed and
    the accepted draft tokens (a draft is accepted while it and every draft
    before it equal the emitted tokens)."""
    import numpy as np
    from paddle_tpu_torch.inference.speculative import DraftProposer

    class ReplayDraft(DraftProposer):
        def __init__(self):
            self.table = {tuple(map(int, p)): [
                (int(t) + 1) % vocab if i % 4 == 3 else int(t)
                for i, t in enumerate(toks)] for p, toks in continuations}
            self.lengths = sorted({len(p) for p in self.table})
            self.log = []

        def propose(self, history, k):
            hist = tuple(map(int, history))
            for n in self.lengths:
                toks = self.table.get(hist[:n])
                if toks is not None:
                    done = len(hist) - n
                    dr = np.asarray(toks[done:done + k], np.int32)
                    self.log.append((hist[:n], done, dr))
                    return dr
            return np.zeros((0,), np.int32)

        def accepted(self, outputs):
            proposed = accepted = 0
            for key, done, dr in self.log:
                toks = outputs[key]
                proposed += len(dr)
                for j, d in enumerate(dr):
                    if done + j >= len(toks) or toks[done + j] != d:
                        break
                    accepted += 1
            return proposed, accepted

    return ReplayDraft()


class _Done:
    """A finished request's fields that ``check_batcher_tokens`` reads."""

    def __init__(self, tokens, chunk_starts=(0,)):
        self.tokens, self.chunk_starts = list(tokens), list(chunk_starts)


def serve_spec(torch, kernels, model, ids, tokens, label, profile, int8,
               prms, **kw):
    """Phase 4c: solo ``generate_paged(spec_decode=True, spec_k=SPEC_K)``
    on the model and prompts of phase 4 (bf16) or 5 (``int8``): a warm-up
    with ``NGramDraft`` (its tokens against ``tokens``, that phase's
    spec-off run), then THE counted run with the draft replaying the
    warm-up's own continuations (every fourth draft replaced: on random
    bf16 weights near-ties make the spec path's tokens leave the spec-off
    run's within a few steps, after which a replay of those is rejected
    throughout): 32 K1 + 161 K2 (+ 64 K4) for the prefill, 161 K2 + 32
    K3-ragged (+ 64 K4) a verify step, no K3 decode; drafts both accepted
    and rejected; every emitted token held to ``check_batcher_tokens``'
    teacher-forced rule; then the median of ROLLOUTS spec rollouts.
    Returns (counts, stats)."""
    cfg = model.config
    steps = [0]
    build = model._build_spec_verify_step

    def counted_build(b, k):
        step = build(b, k)

        def counted(*a):
            steps[0] += 1
            return step(*a)

        return counted

    def run(draft):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model.generate_paged(ids, max_new_tokens=NEW, spec_decode=True,
                                   spec_k=SPEC_K, draft=draft, **kw)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    model._build_spec_verify_step = counted_build
    try:
        first, _ = run(None)                                # warm-up
        cont = [(ids[i].tolist(), first[i, PROMPT:].tolist())
                for i in range(B)]
        draft = replay_draft(cont, cfg.vocab_size)
        steps[0] = 0
        kernels.reset_launch_counts()
        out, ms = run(draft)                                # THE counted run
        counts = kernels.launch_counts()
        n = steps[0]
        walls = [ms] + [run(replay_draft(cont, cfg.vocab_size))[1]
                        for _ in range(ROLLOUTS - 1)]
        if profile:
            with torch.inference_mode():
                prof = profile_window(torch, lambda: run(replay_draft(
                    cont, cfg.vocab_size)), f"{label} spec rollout")
    finally:
        del model._build_spec_verify_step
    expected = dict.fromkeys(counts, 0)
    expected.update({"flash_attention": 32, "fused_rope": 64,
                     "fused_norm_matmul": 161 * (1 + n),
                     "fused_rope_attend_ragged": 32 * n})
    if int8:
        expected["quant_matmul"] = 64 * (1 + n)
    log(f"{label} spec: {n} verify steps, launches {counts} expected "
        f"{expected}")
    assert counts == expected, f"{counts} != plan {expected}"
    assert -(-(NEW - 1) // (SPEC_K + 1)) <= n <= NEW - 1, n
    assert tuple(out.shape) == (B, PROMPT + NEW), out.shape
    assert bool((out[:, :PROMPT] == ids).all()), "prompt not echoed"
    assert bool(((out >= 0) & (out < cfg.vocab_size)).all()), "bad ids"
    outputs = {tuple(ids[i].tolist()): out[i, PROMPT:].tolist()
               for i in range(B)}
    proposed, accepted = draft.accepted(outputs)
    log(f"{label} spec: drafts proposed {proposed}, accepted {accepted}, "
        f"rejected {proposed - accepted}; tokens equal to the NGramDraft "
        f"warm-up's {int((out == first).sum()) - B * PROMPT}/{B * NEW}, to "
        f"the spec-off run's {int((out[:, PROMPT:] == tokens).sum())}/"
        f"{B * NEW}")
    assert accepted > 0 and proposed > accepted, (proposed, accepted)
    reqs = [(ids[i].cpu().numpy(), NEW, 0) for i in range(B)]
    done = {i: _Done(out[i, PROMPT:].tolist()) for i in range(B)}
    check = check_batcher_tokens(torch, cfg, prms, reqs, done,
                                 f"{label} spec", int8=int8)
    wall = statistics.median(walls)
    log(f"{label} spec: generate_paged(spec_decode=True, spec_k={SPEC_K}) "
        f"B{B} prompt {PROMPT} new {NEW}: total_ms "
        f"{[round(w, 1) for w in walls]} (median {wall:.1f}), "
        f"{(NEW - 1) / n:.2f} tokens per row a verify step")
    stats = {"total_ms": wall, "total_ms_runs": walls, "verify_steps": n,
             "drafts_proposed": proposed, "drafts_accepted": accepted,
             "tokens_per_verify_step": (NEW - 1) / n, "tokens_check": check,
             "launches": counts}
    if profile:
        stats["profile"] = prof
    return counts, stats


def prompt_ids(torch, cfg):
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    return torch.randint(0, cfg.vocab_size, (B, PROMPT), generator=g,
                         device="cuda")


def serve(torch, kernels, profile=False):
    """Llama-3-8B greedy generate_paged at full width on the card."""
    from paddle_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                               prompt_logits_pure)
    from paddle_tpu_torch.ops.kernels import flash_attention as k1
    from paddle_tpu_torch.ops.kernels import fused_norm_rope as k67
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
        "flash_attention": L, "fused_rope": 2 * L,
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
    ids = prompt_ids(torch, cfg)
    counts, out, logits, stats = drive(torch, kernels, model, ids, expected,
                                       "serving", profile, page_size=PAGE)
    prms = model.param_dict()
    stats["rope_sites_check"] = check_prefill_rope(torch, k67, L, {
        "prefill": lambda: model.generate_paged(ids, max_new_tokens=1,
                                                page_size=PAGE),
        "prompt logits": lambda: prompt_logits_pure(prms, ids, cfg)},
        "serving")

    # ---- end-to-end check: the counted run's logits at every generated
    # position (prefill and all 31 decode steps) against one teacher-forced
    # plain forward over the tokens it produced (plain attention, no
    # paged cache, no kernel), in f32 as the yardstick and in bf16
    seq = out[:, :PROMPT + NEW - 1].long()

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
    del ref_bf16, ctl_fault, ctl_fp16, ref_f32
    # ---- 4c. the solo spec oracle on the same model and prompts
    counts_spec, stats["spec"] = serve_spec(
        torch, kernels, model, prompt_ids(torch, cfg), out[:, PROMPT:],
        "serving", profile, False, prms, page_size=PAGE)
    log(f"serving: spec rollout {stats['spec']['total_ms']:.1f} ms against "
        f"the plain rollout's {stats['total_ms']:.1f} ms (this run)")
    return counts, counts_spec, stats


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


def chunk_map(prompt_len, chunk_starts, length):
    """Per position of a request's teacher-forced sequence (``length``
    positions): the first position whose key the row reads fresh. A prompt
    row reads the cells before its chunk's start from the cache and its own
    chunk fresh; a decode row (position >= ``prompt_len``) reads every key
    from the cache, its own included. ``chunk_starts``: the prompt offsets
    at which the batcher admitted each chunk (``GenRequest.chunk_starts``)."""
    starts = sorted(chunk_starts)
    assert starts and starts[0] == 0 and starts[-1] < prompt_len, starts
    out = []
    for i in range(length):
        out.append(i + 1 if i >= prompt_len
                   else max(c for c in starts if c <= i))
    return out


def int8_batcher_attention(reference, starts, keep=None):
    """The plain attention of the int8 batcher's teacher-forced reference,
    built on ``reference`` (``_reference_attention``'s signature): query i
    sees key j <= i quantized to int8 and dequantized per (token, head)
    cell, as the batcher reads it from its int8 cache, where j <
    ``starts[i]`` (``chunk_map``), and at full precision where j >=
    starts[i] (the fresh rows of its own chunk). ``keep(i, j)`` (bool
    tensors) narrows the visible pairs for a fault control; a row left with
    no key gives zeros, as the kernels do."""
    import torch
    from paddle_tpu_torch.models.kv_cache import quantize_cells

    def qdq(x):
        codes, scales = quantize_cells(x)     # per (b, s, head) cell
        return (codes.float() * scales).to(x.dtype)

    def attention(q, k, v, causal=True, scale=None):
        s = q.shape[1]
        i = torch.arange(s, device=q.device)[:, None]
        j = i.T
        st = torch.tensor(starts[:s], device=q.device)[:, None]
        vis = j <= i
        if keep is not None:
            vis = vis & keep(i, j)
        mask = torch.cat([vis & (j < st), vis & (j >= st)], dim=1)
        out = reference(q, torch.cat([qdq(k), k], dim=1),
                        torch.cat([qdq(v), v], dim=1), False, scale,
                        attn_mask=mask)
        return out * mask.any(dim=1)[None, :, None, None].to(out.dtype)

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
    from paddle_tpu_torch.ops.kernels import fused_norm_rope as k67
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
    # 32 K1 + 161 K2 + 64 K4 + 64 K12 per prefill, 32 K3 + 161 K2 + 64 K4
    # per step
    expected = dict.fromkeys(kernels.launch_counts(), 0)
    expected.update({"flash_attention": 32, "fused_rope": 64,
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
    ids = prompt_ids(torch, cfg)
    counts, out, logits, stats = drive(
        torch, kernels, model, ids, expected, "serving int8w+int8kv",
        profile, page_size=PAGE_INT8, params=qparams, cache_dtype="int8")
    stats["params_gb"] = q_bytes / 1e9
    stats["rope_sites_check"] = check_prefill_rope(torch, k67, L, {
        "prefill": lambda: model.generate_paged(
            ids, max_new_tokens=1, page_size=PAGE_INT8, params=qparams,
            cache_dtype="int8"),
        "prompt logits": lambda: prompt_logits_pure(qparams, ids, cfg)},
        "serving int8w+int8kv")

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
    del ref_bf16, ctl_fault, ctl_fp16, ref_f32
    # ---- 4c. the solo spec oracle, int8w+int8kv
    counts_spec, stats["spec"] = serve_spec(
        torch, kernels, model, prompt_ids(torch, cfg), out[:, PROMPT:],
        "serving int8w+int8kv", profile, True, qparams,
        page_size=PAGE_INT8, params=qparams, cache_dtype="int8")
    log(f"serving int8w+int8kv: spec rollout "
        f"{stats['spec']['total_ms']:.1f} ms against the plain rollout's "
        f"{stats['total_ms']:.1f} ms (this run)")
    return counts, counts_spec, stats


def batcher_requests(vocab):
    """The 24 seeded requests of phase 6: (prompt ids, max_new_tokens,
    arrival_segment), prompt lengths uniform in 32-512, max_new_tokens in
    16-64, arrivals in 0-6."""
    import numpy as np

    rng = np.random.default_rng(SEED + 12)
    return [(rng.integers(0, vocab, size=int(rng.integers(32, 513)))
             .astype(np.int32), int(rng.integers(16, 65)),
             int(rng.integers(0, 7))) for _ in range(N_REQUESTS)]


def check_batcher_tokens(torch, cfg, prms, reqs, done, label, int8=False):
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
    miss their own chunk (a K11 that drops the fresh source).

    ``int8``: ``prms`` are ``quantize_for_inference``'s (int8 weights,
    dequantized per call in both forwards: f32 keeps the codes and casts
    the rest) and every forward's attention is
    ``int8_batcher_attention`` over the request's own ``chunk_map``, taken
    from the batcher's admission record (``chunk_starts``)."""
    from paddle_tpu_torch.models.llama import prompt_logits_pure
    from paddle_tpu_torch.ops.kernels import flash_attention as k1
    from paddle_tpu_torch.ops.kernels.quant_matmul import QuantizedWeight

    plain_attention = k1._reference_attention
    prms32 = {n: p if isinstance(p, QuantizedWeight) else p.float()
              for n, p in prms.items()}
    worst, n_pos, n_argmax = 0.0, 0, 0
    ctl = {"missing own cell": [0, 0.0], "fresh source dropped": [0, 0.0]}
    with torch.inference_mode():
        for rid, (prompt, n_new, _) in enumerate(reqs):
            toks = done[rid].tokens
            n0 = len(prompt)
            seq = torch.tensor([list(map(int, prompt)) + toks[:-1]],
                               device="cuda")
            if int8:
                starts = chunk_map(n0, done[rid].chunk_starts,
                                   seq.shape[1])

                def attention_with(keep=None):
                    return int8_batcher_attention(plain_attention, starts,
                                                  keep)
            else:
                def attention_with(keep=None):
                    return (plain_attention if keep is None
                            else attention_dropping(keep))

            def logits(params, attention):
                k1._reference_attention = attention
                try:
                    return prompt_logits_pure(params, seq, cfg, plain=True)[
                        0, n0 - 1:].float()
                finally:
                    k1._reference_attention = plain_attention

            f32 = logits(prms32, attention_with())
            err = (logits(prms, attention_with()) - f32).abs().amax(-1)
            top = f32.amax(-1)                         # E per position

            def ratio(tokens):
                return ((top - f32.gather(-1, tokens[:, None])[:, 0])
                        / err.clamp_min(1e-30))

            r = ratio(torch.tensor(toks, device="cuda"))
            worst = max(worst, r.max().item())
            n_pos += len(toks)
            n_argmax += int((f32.argmax(-1).cpu()
                             == torch.tensor(toks)).sum())
            if int8:
                st = torch.tensor(starts, device="cuda")
                fresh_dropped = (lambda i, j: (i >= n0)
                                 | (j < st[i.flatten()][:, None]))
            else:
                fresh_dropped = (lambda i, j: (i >= n0)
                                 | (j < i // BCHUNK * BCHUNK))
            faults = {
                "missing own cell": lambda i, j: ~((i >= n0) & (j == i)),
                "fresh source dropped": fresh_dropped}
            for name, keep in faults.items():
                rc = ratio(logits(prms, attention_with(keep)).argmax(-1))
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


def serve_batcher(torch, kernels, profile=False, int8=False):
    """Llama-3-8B through the continuous batcher at full width, in both
    attention-tail settings (BATCHER_PLANS): bf16 (phase 6) or, ``int8``,
    int8w+int8kv (phase 6b: the model quantized on the card as in phase 5,
    its bf16 matmul weights freed, an int8 cache at page 32; 64 K4 more a
    wave and a step)."""
    from paddle_tpu_torch.framework import flags
    from paddle_tpu_torch.inference import ContinuousBatcher
    from paddle_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                               quantize_for_inference)
    from paddle_tpu_torch.ops.kernels import fusion
    from paddle_tpu_torch.ops.kernels.quant_matmul import QuantizedWeight

    cfg = LlamaConfig.llama3_8b(dtype="bfloat16")
    L = cfg.num_hidden_layers
    model = LlamaForCausalLM(cfg, seed=SEED)
    kind = "int8w+int8kv" if int8 else "bf16"
    serve_kw = dict(page_size=PAGE)
    prms = model.param_dict()
    if int8:
        prms = quantize_for_inference(model)
        for name, p in model.named_parameters():
            if isinstance(prms[name], QuantizedWeight):
                p.data = p.data.new_empty(0)   # the int8 model keeps codes
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        serve_kw = dict(page_size=PAGE_INT8, quantized_params=prms,
                        cache_dtype="int8")
    reqs = batcher_requests(cfg.vocab_size)
    n_tokens = sum(n for _, n, _ in reqs)
    log(f"serving, continuous batching ({kind}): {N_REQUESTS} requests, "
        f"prompts {sum(len(p) for p, _, _ in reqs)} tokens "
        f"({min(len(p) for p, _, _ in reqs)}-"
        f"{max(len(p) for p, _, _ in reqs)}), {n_tokens} new tokens, "
        f"arrivals {sorted(t for _, _, t in reqs)}, page "
        f"{serve_kw['page_size']}, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")

    def run_once(**spec_kw):
        eng = ContinuousBatcher(model, max_batch=BB, max_seq=BSEQ,
                                segment=16, prefill_chunk=BCHUNK,
                                prefix_caching=False, **serve_kw, **spec_kw)
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
            label_ = f"batcher {'int8 ' if int8 else ''}{label}"
            flags.set_flags({"fused_decode_fusions": fusions})
            plan = fusion.planned_kernel_launches(L, quantized=int8)
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
            if int8:
                assert plan["quant_matmul"] == 2 * L, plan
                expected["quant_matmul"] = plan["quant_matmul"] * (waves
                                                                   + steps)
            log(f"{label_}: launches {counts} expected {expected}")
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
            log(f"{label_}: wall {[round(w, 3) for w in walls]} s "
                f"(median {wall_s:.3f}), {n_tokens / wall_s:.1f} generated "
                f"tok/s, " + ", ".join(f"{k} {st[k]}" for k in keys)
                + f", max_memory_allocated {peak:.2f} GiB")
            if profile:
                with torch.inference_mode():
                    res["profile"] = profile_window(torch, run_once, label_)
            res["tokens_check"] = check_batcher_tokens(
                torch, cfg, prms, reqs, done, label_, int8=int8)
            out[label] = res
        # ---- 6c. the same requests with speculative decoding, in both
        # plans
        for label, fusions in BATCHER_PLANS:
            flags.set_flags({"fused_decode_fusions": fusions})
            out[label]["spec"] = serve_batcher_spec(
                torch, kernels, fusion, cfg, prms, reqs, run_once,
                f"batcher {'int8 ' if int8 else ''}spec {label}", profile,
                int8, out[label])
    finally:
        flags.set_flags({"fused_decode_fusions": old})
    return out


def serve_batcher_spec(torch, kernels, fusion, cfg, prms, reqs, run_once,
                       label, profile, int8, plain):
    """Phase 6c in one plan: ``run_once(spec_decode=True, spec_k=SPEC_K)``
    with ``NGramDraft`` (drafts proposed and accepted reported), then with
    the replay draft over that run's own continuations (every fourth draft
    replaced; a replay of phase 6's tokens would be rejected from the first
    near-tie on, which random bf16 weights reach within a few tokens): a
    warm-up and THE counted run, whose launches must equal the plan (161 K2
    + 32 K3-ragged or K11 (+ 64 K4) a wave, no segment step: 0 K3-masked,
    0 K10), every request "ok" with its max_new_tokens, no wasted slot
    step, drafts both accepted and rejected (rewinds), one readback a wave,
    every emitted token held to ``check_batcher_tokens``' rule; walls the
    median of 3, beside ``plain``'s (phase 6 in the same plan)."""
    from paddle_tpu_torch.inference.speculative import NGramDraft

    L = cfg.num_hidden_layers
    n_tokens = sum(n for _, n, _ in reqs)
    spec = dict(spec_decode=True, spec_k=SPEC_K)

    def checked(done, st):
        for rid, (prompt, n_new, _) in enumerate(reqs):
            req = done[rid]
            assert req.status == "ok", (label, rid, req.status)
            assert len(req.tokens) == n_new, (label, rid, len(req.tokens))
        assert st["wasted_slot_steps"] == 0, st
        assert st["decode_steps"] == 0 and st["segments"] == 0, st
        assert st["host_sync_count"] == st["ragged_steps"], st
        return {k: st[k] for k in (
            "ragged_steps", "spec_steps", "draft_tokens_proposed",
            "draft_tokens_accepted", "acceptance_rate",
            "tokens_per_target_step", "host_sync_count")}

    done, st, wall = run_once(**spec, draft=NGramDraft())
    ngram = dict(checked(done, st), wall_s=wall)
    log(f"{label}, NGramDraft: " + ", ".join(
        f"{k} {v}" for k, v in ngram.items()))
    cont = [(prompt, done[rid].tokens)
            for rid, (prompt, _, _) in enumerate(reqs)]
    run_once(**spec, draft=replay_draft(cont, cfg.vocab_size))   # warm-up
    plan = fusion.planned_kernel_launches(L, quantized=int8)
    kernels.reset_launch_counts()
    done, st, wall = run_once(**spec, draft=replay_draft(
        cont, cfg.vocab_size))                                 # THE run
    counts = kernels.launch_counts()
    waves = st["ragged_steps"]
    fused = plan["rope_append_attend"] > 0
    expected = dict.fromkeys(counts, 0)
    expected["fused_norm_matmul"] = plan["norm_matmul"] * waves
    expected["fused_rope_attend_ragged" if fused
             else "ragged_paged_attention"] = L * waves
    if int8:
        expected["quant_matmul"] = plan["quant_matmul"] * waves
    log(f"{label}, replay draft: launches {counts} expected {expected}")
    assert counts == expected, f"{counts} != plan {expected}"
    res = checked(done, st)
    assert 0 < res["draft_tokens_accepted"] < res["draft_tokens_proposed"], \
        res
    walls = [wall] + [run_once(**spec, draft=replay_draft(
        cont, cfg.vocab_size))[2] for _ in range(2)]
    wall_s = statistics.median(walls)
    res.update(wall_s=wall_s, wall_s_runs=walls,
               generated_tok_s=n_tokens / wall_s, launches=counts,
               ngram=ngram)
    log(f"{label}, replay draft: wall {[round(w, 3) for w in walls]} s "
        f"(median {wall_s:.3f}) against {plain['wall_s']:.3f} s without "
        f"spec (this run), {n_tokens / wall_s:.1f} generated tok/s, "
        + ", ".join(f"{k} {v}" for k, v in res.items()
                    if k not in ("wall_s", "wall_s_runs", "launches",
                                 "generated_tok_s", "ngram")))
    if profile:
        with torch.inference_mode():
            res["profile"] = profile_window(torch, lambda: run_once(
                **spec, draft=replay_draft(cont, cfg.vocab_size)), label)
    res["tokens_check"] = check_batcher_tokens(torch, cfg, prms, reqs, done,
                                               label, int8=int8)
    return res


# ---------------------------------------------------------------------------
# Training (phases 7-9): the kernels K5-K8 at the train step's shapes, the
# full-width gradient check, the timed 8-layer train run
# ---------------------------------------------------------------------------

TB, TS = 4, 2048          # the train batch: B sequences of S tokens
TRAIN_LAYERS = 8          # of Llama-3-8B's 32: the AdamW8bit state of all
                          # 32 (~10 B/param, ~75 GB) does not fit one card
TRAIN_STEPS = 3           # timed steps after one warm-up step
ODD_NUMEL = 3_000_001     # K8 at a size with a ragged last 2048-block


def _rate(row, flops):
    """Achieved TFLOP/s and bound share of a timed kernel row, in place."""
    row["tflops"] = flops / row["ms"] / 1e9
    row["bound_share"] = row["bound_ms"] / row["ms"]
    return f"{row['tflops']:.1f} TFLOP/s, bound share {row['bound_share']:.3f}"


def _same_bits(torch, fn):
    """Whether two calls of fn give bitwise-equal tensors."""
    a, b = fn(), fn()
    return all(torch.equal(x, y) for x, y in zip(a, b))


def check_flash_train_fwd(torch, timer, k1, q, k, v):
    """K1 at the train step's attention shape without a mask (B=4,
    S=2048, 32/8 heads, causal) against its plain version, with SDPA
    causal (``is_causal=True, enable_gqa=True``) as the library."""
    b, s, h, d = q.shape
    hk = k.shape[2]
    out, lse = k1.flash_attention_fwd(q, k, v, causal=True)
    ref, ref_lse = k1.flash_attention_fwd_reference(q, k, v, causal=True)
    torch.cuda.synchronize()
    tol = k1.fwd_tolerance(q, k, v, ref, causal=True)
    worst = ((out.float() - ref.float()).abs() / tol).max().item()
    err = (out.float() - ref.float()).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    del tol, ref, ref_lse
    assert worst < 1.0 and lse_err <= 1e-3, (worst, lse_err)
    assert _same_bits(torch, lambda: k1.flash_attention_fwd(
        q, k, v, causal=True)), "K1: two calls differ"
    ms = timer(lambda: k1.flash_attention_fwd(q, k, v, causal=True))
    plain = timer(lambda: k1.flash_attention_fwd_reference(q, k, v, True),
                  iters=5)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    lib = timer(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True))
    del qt, kt, vt
    flops = 4 * d * (s * (s + 1) // 2) * b * h           # causal, offset 0
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + out.numel()) \
        + 4 * lse.numel()
    bms, by = bound(nbytes, flops, BF16_FLOPS)
    row = {"name": "flash_attention_fwd_train", "route": "cuda",
           "source": "paddle_tpu_torch/csrc/flash_attention.cu",
           "replaces": "paddle_tpu/ops/pallas/flash_attention.py:481",
           "max_abs_err": err, "worst_err_over_tol": worst, "ms": ms,
           "plain_ms": plain, "bound_ms": bms, "bound_by": by,
           "library_ms": lib, "shape": f"B{b} S{s} H{h} Hk{hk} D{d} causal"}
    log(f"K1 flash_attention_fwd B{b} S{s} H{h}/{hk} no mask: worst err/tol "
        f"{worst:.3f} max_abs_err {err:.3e} kernel_ms {ms:.4f} plain_ms "
        f"{plain:.4f} library_ms {lib:.4f} (SDPA causal, no mask) "
        f"bound_ms {bms:.4f} ({by}); {_rate(row, flops)}; factor "
        f"{ms / lib:.2f}")
    return row


def check_flash_bwd(torch, timer, k1):
    """K5 at the train step's attention shape: B=4, S=2048, 32/8 heads,
    D=128, causal, dO random; against its plain version from K1's own
    (out, lse), each gradient element within ``k1.bwd_tolerance``; two
    calls bitwise equal. Also K1 there without a mask
    (``check_flash_train_fwd``). Returns both rows."""
    b, s, h, hk, d = TB, TS, 32, 8, 128
    g = torch.Generator(device="cuda").manual_seed(SEED + 20)
    q, k, v, do = (torch.randn((b, s, n, d), generator=g, device="cuda",
                               dtype=torch.bfloat16) for n in (h, hk, hk, h))
    fwd_row = check_flash_train_fwd(torch, timer, k1, q, k, v)
    torch.cuda.empty_cache()
    out, lse = k1.flash_attention_fwd(q, k, v, causal=True)
    got = k1.flash_attention_bwd(q, k, v, out, lse, do, causal=True)
    ref = k1.flash_attention_bwd_reference(q, k, v, out, lse, do, True)
    torch.cuda.synchronize()
    tols = k1.bwd_tolerance(q, k, v, do, *ref, causal=True)
    worst, err = {}, 0.0
    for name, a, r, t in zip(("dq", "dk", "dv"), got, ref, tols):
        diff = (a.float() - r.float()).abs()
        worst[name] = (diff / t).max().item()
        err = max(err, diff.max().item())
        del diff
    del tols
    log(f"K5 worst err/tol {worst}")
    assert max(worst.values()) < 1.0, f"flash bwd worst err/tol {worst}"
    assert _same_bits(torch, lambda: k1.flash_attention_bwd(
        q, k, v, out, lse, do, True)), "K5: two calls differ"
    ms = timer(lambda: k1.flash_attention_bwd(q, k, v, out, lse, do, True))
    plain = timer(lambda: k1.flash_attention_bwd_reference(
        q, k, v, out, lse, do, True), iters=5)
    del got, ref
    torch.cuda.empty_cache()
    # the library yardstick: SDPA's backward alone (its forward outside)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))
    o = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True)
    dot = do.transpose(1, 2).contiguous()
    lib = timer(lambda: torch.autograd.grad(o, (qt, kt, vt), dot,
                                            retain_graph=True))
    del o, qt, kt, vt
    pairs = s * (s + 1) // 2                              # causal, offset 0
    flops = 5 * 2 * d * pairs * b * h
    nbytes = 2 * (2 * q.numel() + 2 * k.numel() + 2 * v.numel()
                  + out.numel() + do.numel()) + 4 * lse.numel()
    bms, by = bound(nbytes, flops, BF16_FLOPS)
    row = {"name": "flash_attention_bwd", "route": "cuda",
           "source": "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
           "replaces": "paddle_tpu/ops/pallas/flash_attention.py:533",
           "max_abs_err": err, "worst_err_over_tol": worst, "ms": ms,
           "plain_ms": plain, "bound_ms": bms, "bound_by": by,
           "library_ms": lib, "deterministic": True,
           "shape": f"B{b} S{s} H{h} Hk{hk} D{d} causal"}
    log(f"K5 flash_attention_bwd B{b} S{s} H{h}/{hk}: max_abs_err {err:.3e} "
        f"kernel_ms {ms:.4f} plain_ms {plain:.4f} library_ms {lib:.4f} "
        f"(SDPA backward) bound_ms {bms:.4f} ({by}); {_rate(row, flops)} "
        f"(5 products; the split kernel runs 7); two calls bitwise equal")
    return [fwd_row, row]


def check_rms_norm(torch, timer, k67):
    """K6 and K7 at the final norm's train shape: (B*S, 4096) bf16; K7
    two calls bitwise equal (its dw partials summed in a fixed order)."""
    n, hdim, eps = TB * TS, 4096, 1e-5
    g = torch.Generator(device="cuda").manual_seed(SEED + 21)
    x, gr = (torch.randn((n, hdim), generator=g, device="cuda",
                         dtype=torch.bfloat16) for _ in range(2))
    w = (torch.rand((hdim,), generator=g, device="cuda") + 0.5).to(
        torch.bfloat16)
    out, rstd = k67.rms_norm_fwd(x, w, eps)
    dx, dw = k67.rms_norm_bwd(x, w, rstd, gr)
    r_out, r_rstd = k67.rms_norm_fwd_reference(x, w, eps)
    r_dx, r_dw = k67.rms_norm_bwd_reference(x, w, r_rstd, gr)
    torch.cuda.synchronize()
    t_out, t_dx, t_dw = k67.tolerances(x, w, gr, r_out, r_dx, r_dw)
    worst = {"out": ((out.float() - r_out.float()).abs() / t_out).max().item(),
             "rstd": ((rstd - r_rstd).abs() / (1e-5 * r_rstd)).max().item(),
             "dx": ((dx.float() - r_dx.float()).abs() / t_dx).max().item(),
             "dw": ((dw - r_dw).abs() / t_dw).max().item()}
    log(f"K6/K7 worst err/tol {worst}")
    assert max(worst.values()) < 1.0, f"rms_norm worst err/tol {worst}"
    assert _same_bits(torch, lambda: k67.rms_norm_bwd(x, w, rstd, gr)), (
        "K7: two calls differ")
    err6 = (out.float() - r_out.float()).abs().max().item()
    err7 = (dx.float() - r_dx.float()).abs().max().item()
    rms_norm = torch.nn.functional.rms_norm
    xl = x.clone().requires_grad_(True)
    wl = w.clone().requires_grad_(True)
    yl = rms_norm(xl, (hdim,), wl, eps)
    rows = []
    for name, fn, plain_fn, lib_fn, nbytes, err, src in (
            ("rms_norm_fwd", lambda: k67.rms_norm_fwd(x, w, eps),
             lambda: k67.rms_norm_fwd_reference(x, w, eps),
             lambda: rms_norm(x, (hdim,), w, eps),
             2 * 2 * n * hdim + 2 * hdim + 4 * n, err6, ":77"),
            ("rms_norm_bwd", lambda: k67.rms_norm_bwd(x, w, rstd, gr),
             lambda: k67.rms_norm_bwd_reference(x, w, rstd, gr),
             lambda: torch.autograd.grad(yl, (xl, wl), gr,
                                         retain_graph=True),
             3 * 2 * n * hdim + 2 * hdim + 4 * n + 4 * hdim, err7, ":97")):
        ms, plain, lib = timer(fn), timer(plain_fn), timer(lib_fn)
        bms, by = bound(nbytes, 0, BF16_FLOPS)
        log(f"{name} N{n} H{hdim}: max_abs_err {err:.3e} kernel_ms "
            f"{ms:.4f} plain_ms {plain:.4f} library_ms {lib:.4f} "
            f"(F.rms_norm{' backward' if 'bwd' in name else ''}) bound_ms "
            f"{bms:.4f} ({by})")
        rows.append({"name": name, "route": "cuda",
                     "source": "paddle_tpu_torch/csrc/rms_norm.cu",
                     "replaces": "paddle_tpu/ops/pallas/fused_norm_rope.py"
                                 + src,
                     "max_abs_err": err, "worst_err_over_tol": worst,
                     "ms": ms, "plain_ms": plain, "bound_ms": bms,
                     "bound_by": by, "library_ms": lib,
                     "shape": f"N{n} H{hdim} bf16"})
    return rows


def check_adamw8bit(torch, timer, k8):
    """K8 on a gate_proj-shaped bf16 param with its f32 master (4096 x
    14336 = 58.7M elements) and on an odd size, 3 steps with weight decay:
    codes bit-identical to the plain version on the card, scales within
    3e-7 relative, master within step * 3e-7 (the JAX package's bars; the
    two compute the same IEEE ops, so they should agree exactly)."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 22)
    kw = dict(weight_decay=0.01, lr_scale=1.0, beta1=0.9, beta2=0.999,
              eps=1e-8)
    err, row = 0.0, None
    for shape in ((4096, 14336), (ODD_NUMEL,)):
        p = (torch.randn(shape, generator=g, device="cuda") * 0.02).to(
            torch.bfloat16)
        st = k8.init_state(p, master=True)
        p_ref, st_ref = p.clone(), {k: v.clone() for k, v in st.items()}
        for step in range(1, 4):
            gr = (torch.randn(shape, generator=g, device="cuda")
                  * 10.0 ** -step).to(torch.bfloat16)
            k8.adamw8bit_update(p, gr, st, 1e-4, step, **kw)
            k8.adamw8bit_update(p_ref, gr, st_ref, 1e-4, step, plain=True,
                                **kw)
            torch.cuda.synchronize()
            for key in ("m_q", "v_q"):
                diff = (st[key].view(torch.uint8)
                        != st_ref[key].view(torch.uint8)).sum().item()
                assert diff == 0, f"K8 {shape} step {step}: {diff} {key} " \
                                  f"codes differ"
            for key in ("m_s", "v_s"):
                rel = ((st[key] - st_ref[key]).abs()
                       / st_ref[key].abs().clamp(min=1e-30)).max().item()
                assert rel <= 3e-7, f"K8 {key} rel err {rel}"
            merr = (st["master"] - st_ref["master"]).abs().max().item()
            assert merr <= step * 3e-7, f"K8 master err {merr}"
            err = max(err, merr,
                      (p.float() - p_ref.float()).abs().max().item())
        log(f"K8 adamw8bit {shape}: 3 steps, codes bit-identical, master "
            f"max_abs_err {merr:.3e}")
        if row is None:                     # time the gate_proj shape
            n = p.numel()
            nb = st["m_s"].numel()
            ms = timer(lambda: k8.adamw8bit_update(p, gr, st, 1e-4, 4, **kw))
            plain = timer(lambda: k8.adamw8bit_update(
                p_ref, gr, st_ref, 1e-4, 4, plain=True, **kw), iters=5)
            # grad 2 B read, master 4 read + 4 written, param 2 written,
            # codes 2 read + 2 written, scales 2 x 4 read + written
            nbytes = 16 * n + 16 * nb
            bms, by = bound(nbytes, 0, BF16_FLOPS)
            row = {"name": "adamw8bit", "route": "cuda",
                   "source": "paddle_tpu_torch/csrc/adamw8bit.cu",
                   "replaces":
                       "paddle_tpu/ops/pallas/fused_optimizer_update.py:173",
                   "ms": ms, "plain_ms": plain, "bound_ms": bms,
                   "bound_by": by, "library_ms": None,
                   "shape": f"{shape[0]}x{shape[1]} bf16 + f32 master"}
            log(f"K8 adamw8bit {n} elements: kernel_ms {ms:.4f} plain_ms "
                f"{plain:.4f} library_ms none bound_ms {bms:.4f} ({by})")
        del p, st, p_ref, st_ref
    row["max_abs_err"] = err
    return row


def train_config(layers, **kw):
    from paddle_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig.llama3_8b(
        dtype="bfloat16", num_hidden_layers=layers, recompute=True,
        recompute_granularity="core_attn", fused_head_loss=True,
        loss_chunk_size=4096, **kw)


def _loss_and_grads(torch, model, ids, plain=False):
    """(per-token losses over an f32 head, the loss, {name: grad}) of one
    forward/backward."""
    hidden = model(ids, plain=plain)
    loss = model.loss(hidden, ids)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    with torch.no_grad():
        logits = hidden[0, :-1].float() @ model.lm_head.weight.float()
        tok = torch.logsumexp(logits, -1) - logits.gather(
            1, ids[0, 1:, None])[:, 0]
        del logits
    return tok, loss.detach().float(), dict(zip(names, grads))


def train_grad_check(torch, k1):
    """Step-1 loss and every parameter's gradient of a 2-layer full-width
    model (B=1, S=2048), three ways: the kernel path in bf16, the plain
    path in bf16 (``plain=True``: unfused plans, the kernels' plain
    versions), a plain f32 forward/backward. The serving phases' logits
    rule on the relative L2 errors against f32: kernel <= 2 x plain bf16,
    for the per-token losses and for each gradient. A fault control (K5 with Delta
    left at zero) must fail it."""
    from paddle_tpu_torch.models.llama import LlamaForCausalLM

    cfg = train_config(2)
    model = LlamaForCausalLM(cfg, seed=SEED).train()
    g = torch.Generator(device="cuda").manual_seed(SEED + 23)
    ids = torch.randint(0, cfg.vocab_size, (1, TS), generator=g,
                        device="cuda")
    kern = _loss_and_grads(torch, model, ids)
    plain = _loss_and_grads(torch, model, ids, plain=True)
    fault_delta, k1._bwd_delta = (
        k1._bwd_delta, lambda out, do: torch.zeros(
            (out.shape[0], out.shape[2], out.shape[1]), dtype=torch.float32,
            device=out.device))
    try:
        fault = _loss_and_grads(torch, model, ids)
    finally:
        k1._bwd_delta = fault_delta
    m32 = LlamaForCausalLM(dataclasses.replace(cfg, dtype="float32"),
                           seed=SEED).train()
    with torch.no_grad():
        for (_, p32), (_, p) in zip(m32.named_parameters(),
                                    model.named_parameters()):
            p32.copy_(p.float())
    del model
    torch.cuda.empty_cache()
    ref = _loss_and_grads(torch, m32, ids, plain=True)
    del m32
    torch.cuda.empty_cache()

    def rel(a, b):
        return ((a.float() - b).norm() / b.norm()).item()

    rows, worst, fault_worst = {}, 0.0, 0.0
    items = [("per-token loss", kern[0], plain[0], fault[0], ref[0])] + [
        (n, kern[2][n], plain[2][n], fault[2][n], ref[2][n])
        for n in ref[2]]
    for name, a, b, c, r in items:
        ek, ep, ef = rel(a, r), rel(b, r), rel(c, r)
        rows[name] = {"kernel": ek, "plain_bf16": ep, "fault": ef,
                      "kernel_over_plain": ek / ep,
                      "fault_over_plain": ef / ep}
        worst = max(worst, ek / ep)
        fault_worst = max(fault_worst, ef / ep)
    for name, r in rows.items():
        log(f"  grad check {name}: rel L2 err vs f32 kernel "
            f"{r['kernel']:.3e} plain bf16 {r['plain_bf16']:.3e} "
            f"ratio {r['kernel_over_plain']:.3f}; Delta=0 control "
            f"{r['fault_over_plain']:.3f}")
    losses = {"kernel": kern[1].item(), "plain_bf16": plain[1].item(),
              "f32": ref[1].item(), "fault": fault[1].item()}
    log(f"train grad check (2 layers, B1 S{TS}): step-1 loss {losses}; "
        f"worst kernel/plain ratio {worst:.3f}, Delta=0 control "
        f"{fault_worst:.3f}")
    assert all(math.isfinite(v) for v in losses.values()), losses
    assert worst <= 2, f"kernel/plain bf16 error ratio {worst}"
    assert fault_worst > 2, (
        f"the Delta=0 control passed the rule ({fault_worst:.3f}): the "
        f"check cannot see a broken backward")
    return {"losses": losses, "worst_ratio": worst,
            "fault_worst_ratio": fault_worst, "per_tensor": rows}


def time_loss(torch, cfg, timer):
    """The chunked loss's forward + backward alone at the train step's
    shape (B*(S-1) tokens, the lm_head weight), device ms."""
    from paddle_tpu_torch.ops.loss_ops import linear_cross_entropy

    g = torch.Generator(device="cuda").manual_seed(SEED + 24)
    h = torch.randn((TB * (TS - 1), cfg.hidden_size), generator=g,
                    device="cuda", dtype=torch.bfloat16).requires_grad_(True)
    w = (torch.randn((cfg.hidden_size, cfg.vocab_size), generator=g,
                     device="cuda") * 0.02).to(torch.bfloat16)
    w.requires_grad_(True)
    lbl = torch.randint(0, cfg.vocab_size, (TB * (TS - 1),), generator=g,
                        device="cuda")

    def run():
        loss = linear_cross_entropy(h, w, lbl, chunk_size=cfg.loss_chunk_size)
        torch.autograd.grad(loss, (h, w))

    return timer(run, iters=3, warmup=1)


def train(torch, kernels, profile=False):
    """The timed train run: Llama-3-8B widths, 8 layers, bf16, core_attn
    recompute, chunked loss, AdamW8bit(1e-4), B=4 x S=2048 random tokens
    (the same batch every step): one warm-up step, then TRAIN_STEPS timed
    steps whose launch counts must equal the plan's."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    from paddle_tpu_torch.ops.kernels import fusion
    from paddle_tpu_torch.optimizer import AdamW8bit

    assert fusion.enabled_train_fusions() == fusion.TRAIN_FUSIONS, (
        f"train fusion flags not at their defaults: "
        f"{fusion.enabled_train_fusions()}")
    cfg = train_config(TRAIN_LAYERS)
    L = cfg.num_hidden_layers
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, seed=SEED)
    torch.cuda.synchronize()
    n_tensors = sum(1 for _ in model.parameters())
    n_params = sum(p.numel() for p in model.parameters())
    opt = AdamW8bit(learning_rate=1e-4, parameters=model.parameters())
    step = TrainStep(model, lambda out, lb: model.loss(out, lb), opt)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    ids = torch.randint(0, cfg.vocab_size, (TB, TS), generator=g,
                        device="cuda")
    plan = fusion.train_kernel_launches_per_step(
        L, n_tensors, recompute=cfg.recompute,
        granularity=cfg.recompute_granularity,
        fused_head_loss=cfg.fused_head_loss)
    assert n_tensors == 9 * L + 3 and plan["adamw8bit"] == n_tensors, plan
    log(f"train: Llama-3-8B widths, {L} layers, {n_params / 1e9:.3f}B "
        f"params bf16 ({n_tensors} tensors), init "
        f"{time.perf_counter() - t0:.1f}s; plan per step {plan}")

    def timed_step():
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = step(ids, ids)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3, loss.item()

    torch.cuda.reset_peak_memory_stats()
    warm_ms, first_loss = timed_step()                     # warm-up
    kernels.reset_launch_counts()
    runs = [timed_step() for _ in range(TRAIN_STEPS)]      # THE counted run
    counts = kernels.launch_counts()
    expected = dict.fromkeys(counts, 0)
    expected.update({k: v * TRAIN_STEPS for k, v in plan.items()})
    log(f"train: launches over {TRAIN_STEPS} steps {counts} expected "
        f"{expected}")
    assert counts == expected, f"launch counts {counts} != plan {expected}"
    losses = [first_loss] + [l for _, l in runs]
    assert all(math.isfinite(l) for l in losses), losses
    assert losses[-1] < losses[0], f"loss did not fall: {losses}"
    step_ms = statistics.median(t for t, _ in runs)
    tokens = TB * TS
    fpt = LlamaForCausalLM.flops_per_token(cfg, TS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    stats = {"step_ms": step_ms, "step_ms_runs": [t for t, _ in runs],
             "warmup_step_ms": warm_ms, "tokens_per_s": tokens / step_ms * 1e3,
             "mfu_6n_attn": fpt * tokens / (step_ms / 1e3) / BF16_FLOPS,
             "losses": losses, "max_memory_allocated_gib": peak,
             "params": n_params, "launches": counts}
    log(f"train: B{TB} S{TS}, step_ms {[round(t, 1) for t, _ in runs]} "
        f"(median {step_ms:.1f}, warm-up {warm_ms:.1f}), "
        f"{stats['tokens_per_s']:.1f} tok/s, mfu_6n_attn "
        f"{stats['mfu_6n_attn']:.4f}, losses {losses}, "
        f"max_memory_allocated {peak:.2f} GiB")
    if profile:
        stats["profile"] = profile_window(torch, lambda: step(ids, ids),
                                          "train step")
    del step, opt, model
    torch.cuda.empty_cache()
    timer = ColdTimer(torch)
    stats["loss_fwd_bwd_ms"] = time_loss(torch, cfg, timer)
    log(f"train: chunked loss forward + backward alone "
        f"{stats['loss_fwd_bwd_ms']:.2f} ms")
    return counts, stats


# ---------------------------------------------------------------------------
# Fine-tuning (phases 7-9, extended, and 9b): K1/K5 with a key bias, K9 (the
# one-pass flash backward) and K12 (rope) at the train step's shapes, the
# masked gradient check under both backwards, and the timed cell
# llama3-8b-8L-sft
# ---------------------------------------------------------------------------

SFT_LENGTHS = (2048, 1792, 1280, 768)    # real tokens per row, left-padded
SFT_CLIP = 1.0
GRAD_PAD_REAL = 1100                      # the masked grad check's short row


def left_pad_mask(torch, lengths, s):
    """(B, S) bool: True on each row's last lengths[i] positions."""
    pos = torch.arange(s, device="cuda")[None, :]
    return pos >= s - torch.tensor(lengths, device="cuda")[:, None]


def sft_scheduler():
    """The cell's schedule: 2 linear warm-up steps from 1e-5 to 1e-4, then
    a cosine decay over 1000 steps."""
    from paddle_tpu_torch.optimizer import lr

    return lr.LinearWarmup(lr.CosineAnnealingDecay(1e-4, T_max=1000),
                           warmup_steps=2, start_lr=1e-5, end_lr=1e-4)


def _masked_inputs(torch, k1, b, s, h, hk, d, seed):
    """q, k, v, dO at the train shape with the cell's left-padded key bias
    (dO random on every row, those that see no key included)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn((b, s, n, d), generator=g, device="cuda",
                               dtype=torch.bfloat16) for n in (h, hk, hk, h))
    keep = left_pad_mask(torch, SFT_LENGTHS, s)
    bias = k1._key_bias_from_mask(keep, b, s)[0]
    return q, k, v, do, bias, keep


def _sdpa_mask(torch, keep):
    """The bool (B, 1, S, S) mask SDPA takes for causal + key padding."""
    s = keep.shape[1]
    causal = torch.ones((s, s), dtype=torch.bool, device="cuda").tril()
    return causal[None, None] & keep[:, None, None, :]


def _live_pairs(lengths, s):
    """(query, key) pairs a causal, left-padded batch needs: each row's
    real queries over its real keys up to the diagonal."""
    return sum(n * (n + 1) // 2 for n in lengths if n <= s)


def _k9_extras(torch, timer, k1, row, fn, bias, args):
    """K9's row beside its with-bias time: the key tiles it skips (the
    device liveness against the pure-Python model of the left pads, which
    must agree and be > 0), its dS partials' bytes and their time at the
    HBM rate, and K9 and K5 without the bias (in turns, the same shape;
    K9's time there with its rate and bound share)."""
    q, k, v, out, lse, do = args
    b, s, h, d = q.shape
    hk = k.shape[2]
    nk = -(-s // 64)
    # a key tile is live iff it holds one of the row's last n (real) keys
    model = [[int(kt * 64 + 64 > s - n) for kt in range(nk)]
             for n in SFT_LENGTHS]
    walks = k1._dkv_walks(b, s, s, h, hk, True, model)
    skipped_model = sum(1 for *_, walk in walks if not walk)
    live = k1._key_tile_live(bias, s)
    skipped = int((live == 0).sum().item()) * hk
    assert live.tolist() == model, "tile liveness differs from the model"
    assert skipped == skipped_model > 0, (skipped, skipped_model)
    row["key_tile_blocks_skipped"] = skipped
    row["key_tile_blocks"] = len(walks)
    pairs = k1.fused_partial_pairs(s, s, True)
    row["ds_partials_gib"] = b * h * pairs * 64 * 64 * 2 / 2**30
    part_ms = 2 * b * h * pairs * 64 * 64 * 2 / HBM_BYTES_S * 1e3
    row["bound_ms_with_partials"] = row["bound_ms"] + part_ms
    free = timer(lambda: fn(q, k, v, out, lse, do, True))
    row["k5_ms_without_bias"] = timer(
        lambda: k1.flash_attention_bwd(q, k, v, out, lse, do, True))
    free_flops = 5 * 2 * d * (s * (s + 1) // 2) * b * h
    free_bound = bound(2 * (2 * q.numel() + 2 * k.numel() + 2 * v.numel()
                            + out.numel() + do.numel()) + 4 * lse.numel(),
                       free_flops, BF16_FLOPS)[0]
    row["ms_without_bias"] = free
    row["tflops_without_bias"] = free_flops / free / 1e9
    row["bound_share_without_bias"] = free_bound / free
    return (f"key-tile blocks skipped {skipped} of {len(walks)} (model "
            f"{skipped_model}); dS partials {row['ds_partials_gib']:.3f} GiB "
            f"written and read, {part_ms:.4f} ms at the HBM rate (bound with "
            f"them {row['bound_ms_with_partials']:.4f} ms); without the "
            f"bias K9 {free:.4f} ms ({row['tflops_without_bias']:.1f} "
            f"TFLOP/s, bound share {row['bound_share_without_bias']:.3f}), "
            f"K5 {row['k5_ms_without_bias']:.4f} ms")


def _k1_skips(k1, row, bias, b, s, h):
    """K1's skipped key tiles under the cell's left pads: counted from the
    device liveness over K1's causal walks, against the pure-Python model
    of the pads (``_fwd_walks``); they must agree and be > 0."""
    nk = -(-s // 64)
    model = [[int(kt * 64 + 64 > s - n) for kt in range(nk)]
             for n in SFT_LENGTHS]
    walks = k1._fwd_walks(b, s, s, h, True, model)
    skipped_model = sum(k1._fwd_key_tiles(qt, s, s, True) - len(walk)
                        for _, _, qt, walk in walks)
    live = k1._key_tile_live(bias, s).tolist()
    assert live == model, "tile liveness differs from the model"
    skipped = h * sum(1 for bi in range(b) for qt in range(-(-s // 128))
                      for kt in range(k1._fwd_key_tiles(qt, s, s, True))
                      if not live[bi][kt])
    assert skipped == skipped_model > 0, (skipped, skipped_model)
    row["key_tiles_skipped"] = skipped
    row["key_tiles_walked"] = sum(len(walk) for *_, walk in walks)
    return (f"key tiles skipped {skipped} of "
            f"{skipped + row['key_tiles_walked']} (model {skipped_model})")


def check_flash_masked(torch, timer, k1):
    """K1 and K5 with the cell's key bias, and K9 with and without it, at
    the train step's attention shape (B=4, S=2048, 32/8 heads, D=128,
    causal), rows left-padded to SFT_LENGTHS: K1 within
    ``k1.fwd_tolerance`` and K5 and K9 within ``k1.bwd_tolerance`` on every
    row, those that see no key included (dO random there too).
    Library yardsticks: SDPA forward and backward under the same mask."""
    b, s, h, hk, d = TB, TS, 32, 8, 128
    q, k, v, do, bias, keep = _masked_inputs(torch, k1, b, s, h, hk, d,
                                             SEED + 25)
    out, lse = k1.flash_attention_fwd(q, k, v, True, None, bias)
    ref, ref_lse = k1.flash_attention_fwd_reference(q, k, v, True, None,
                                                    bias)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out.float()).all()), "K1 bias: non-finite"
    tol = k1.fwd_tolerance(q, k, v, ref, causal=True, bias=bias)
    worst1 = ((out.float() - ref.float()).abs() / tol).max().item()
    err1 = (out.float() - ref.float()).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    del tol, ref_lse
    log(f"K1 with key bias: worst err/tol {worst1:.3f}, lse_err "
        f"{lse_err:.3e}")
    assert worst1 < 1.0 and lse_err <= 1e-3, (worst1, lse_err)
    rows = []
    ms_fwd = timer(lambda: k1.flash_attention_fwd(q, k, v, True, None, bias))
    ms_fwd_free = timer(lambda: k1.flash_attention_fwd(q, k, v, True))
    plain_fwd = timer(lambda: k1.flash_attention_fwd_reference(
        q, k, v, True, None, bias), iters=5)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    amask = _sdpa_mask(torch, keep)
    lib_fwd = timer(lambda: sdpa(qt, kt, vt, attn_mask=amask,
                                 enable_gqa=True))
    pairs = _live_pairs(SFT_LENGTHS, s)
    fbytes = 2 * (q.numel() + k.numel() + v.numel() + out.numel()) \
        + 4 * (lse.numel() + bias.numel())
    bms, by = bound(fbytes, 4 * d * pairs * h, BF16_FLOPS)
    row = {"name": "flash_attention_fwd_bias", "route": "cuda",
           "source": "paddle_tpu_torch/csrc/flash_attention.cu",
           "replaces": "paddle_tpu/ops/pallas/flash_attention.py:481",
           "max_abs_err": err1, "worst_err_over_tol": worst1,
           "ms": ms_fwd, "ms_without_bias": ms_fwd_free,
           "plain_ms": plain_fwd, "bound_ms": bms, "bound_by": by,
           "library_ms": lib_fwd,
           "shape": f"B{b} S{s} H{h} Hk{hk} D{d} causal, key bias "
                    f"lengths {SFT_LENGTHS}"}
    skips = _k1_skips(k1, row, bias, b, s, h)
    assert _same_bits(torch, lambda: k1.flash_attention_fwd(
        q, k, v, True, None, bias)), "K1 with the bias: two calls differ"
    log(f"K1 flash_attention_fwd with key bias B{b} S{s} H{h}/{hk}: "
        f"max_abs_err {err1:.3e} kernel_ms {ms_fwd:.4f} (without the bias "
        f"{ms_fwd_free:.4f}) plain_ms {plain_fwd:.4f} library_ms "
        f"{lib_fwd:.4f} (SDPA, bool mask) bound_ms {bms:.4f} ({by}); "
        f"{_rate(row, 4 * d * pairs * h)} over the live pairs; {skips}; "
        f"two calls bitwise equal")
    rows.append(row)
    del ref
    torch.cuda.empty_cache()
    ref = k1.flash_attention_bwd_reference(q, k, v, out, lse, do, True,
                                           None, bias)
    tols = k1.bwd_tolerance(q, k, v, do, *ref, causal=True, bias=bias)
    bbytes = 2 * (2 * q.numel() + 2 * k.numel() + 2 * v.numel()
                  + out.numel() + do.numel()) + 4 * (lse.numel()
                                                     + bias.numel())
    bflops = 5 * 2 * d * pairs * h
    qg, kg, vg = (x.detach().clone().requires_grad_(True)
                  for x in (qt, kt, vt))
    o = sdpa(qg, kg, vg, attn_mask=amask, enable_gqa=True)
    dot = do.transpose(1, 2).contiguous()
    lib_bwd = timer(lambda: torch.autograd.grad(o, (qg, kg, vg), dot,
                                                retain_graph=True))
    for name, fn, src, line in (
            ("flash_attention_bwd_bias", k1.flash_attention_bwd,
             "flash_attention_bwd.cu", ":533"),
            ("flash_attention_bwd_fused", k1.flash_attention_bwd_fused,
             "flash_attention_bwd_fused.cu", ":610")):
        got = fn(q, k, v, out, lse, do, True, None, bias)
        torch.cuda.synchronize()
        worst, err = {}, 0.0
        for gname, a, r, t in zip(("dq", "dk", "dv"), got, ref, tols):
            assert bool(torch.isfinite(a.float()).all()), (name, gname)
            diff = (a.float() - r.float()).abs()
            worst[gname] = (diff / t).max().item()
            err = max(err, diff.max().item())
            del diff
        del got
        log(f"{name} worst err/tol {worst}")
        assert max(worst.values()) < 1.0, (name, worst)
        assert _same_bits(torch, lambda: fn(q, k, v, out, lse, do, True, None,
                                            bias)), f"{name}: two calls differ"
        ms = timer(lambda: fn(q, k, v, out, lse, do, True, None, bias))
        plain = timer(lambda: k1.flash_attention_bwd_reference(
            q, k, v, out, lse, do, True, None, bias), iters=5)
        bms, by = bound(bbytes, bflops, BF16_FLOPS)
        row = {"name": name, "route": "cuda",
               "source": f"paddle_tpu_torch/csrc/{src}",
               "replaces": f"paddle_tpu/ops/pallas/flash_attention.py{line}",
               "max_abs_err": err, "worst_err_over_tol": worst, "ms": ms,
               "plain_ms": plain, "bound_ms": bms, "bound_by": by,
               "library_ms": lib_bwd, "deterministic": True,
               "shape": f"B{b} S{s} H{h} Hk{hk} D{d} causal, key bias "
                        f"lengths {SFT_LENGTHS}"}
        rate = _rate(row, bflops)
        extra = ""
        if name == "flash_attention_bwd_fused":
            extra = "; " + _k9_extras(torch, timer, k1, row, fn, bias,
                                      (q, k, v, out, lse, do))
        log(f"{name} B{b} S{s} H{h}/{hk} with key bias: max_abs_err "
            f"{err:.3e} kernel_ms {ms:.4f} plain_ms {plain:.4f} library_ms "
            f"{lib_bwd:.4f} (SDPA backward, bool mask) bound_ms {bms:.4f} "
            f"({by}); {rate}{extra}")
        rows.append(row)
    del ref, tols, o, qg, kg, vg
    torch.cuda.empty_cache()
    return rows


ROPE_SHAPES = ((TB, TS, 32, 128), (TB, TS, 8, 128))


def _rope_inputs(torch, shape, seed):
    from paddle_tpu_torch.models.llama import _rope_tables

    g = torch.Generator(device="cuda").manual_seed(seed)
    x, gr = (torch.randn(shape, generator=g, device="cuda",
                         dtype=torch.bfloat16) for _ in range(2))
    cos, sin = _rope_tables(shape[1], shape[3], 500000.0, device="cuda")
    return x, gr, cos.contiguous(), sin.contiguous()


def chain_rope(x, cos, sin, plain=False):
    """The f32 rotate-half chain that K12's sites must match bit for bit,
    in ``fused_rope``'s signature: ``apply_rotary_pos_emb`` on an f32
    copy, cast back."""
    from paddle_tpu_torch.models.llama import apply_rotary_pos_emb

    x32 = x.float()
    return apply_rotary_pos_emb(x32, x32, cos, sin)[0].to(x.dtype)


def rope_ptxas():
    """{K12 instance: {registers, spill_stores, spill_loads}} of every
    ``rope_kernel<T, VEC, TRANSPOSE>`` in the build log, keyed like
    "bf16 x8 forward"."""
    def name_of(mangled):
        m = re.search(r"rope_kernelI(13__nv_bfloat16|f)Li(\d+)ELb([01])E",
                      mangled)
        return m and (f"{'f32' if m.group(1) == 'f' else 'bf16'} "
                      f"x{m.group(2)} "
                      f"{'transposed' if m.group(3) == '1' else 'forward'}")

    return _ptxas(name_of)


def check_rope(torch, timer, k67):
    """K12's forward and transposed instances (the backward: the rope with
    sin' = -swap_halves(sin), read from sin swapped and negated) at the q
    and k shapes of the train step: bit-equal to the plain versions (the
    same separately rounded f32 ops; the plain backward builds
    ``rope_bwd_table``), two calls bitwise equal; the registers and spills
    of all eight instances (bf16 x8 / x1, f32 x4 / x1, each forward and
    transposed), none spilling. Beside each time, ``copy_ms``: a
    ``Tensor.copy_`` of the same input, the same bytes through the same
    cold-L2 timer (no yardstick of the function: PyTorch has no rope)."""
    ptxas = rope_ptxas()
    log(f"K12 ptxas: {ptxas}")
    assert len(ptxas) == 8, f"K12 instances in the build log: {ptxas}"
    spilled = {k: v for k, v in ptxas.items()
               if v.get("spill_stores", 0) or v.get("spill_loads", 0)}
    assert not spilled, f"K12 instances spill: {spilled}"
    rows = []
    for i, shape in enumerate(ROPE_SHAPES):
        x, gr, cos, sin = _rope_inputs(torch, shape, SEED + 26 + i)
        plan = k67.rope_plan(*shape, x.element_size())
        for name, inp, tr in (("fused_rope", x, False),
                              ("fused_rope_bwd", gr, True)):
            got = k67.rope_fwd(inp, cos, sin, transpose=tr)
            ref = k67.rope_reference(inp, cos, k67.rope_bwd_table(sin)
                                     if tr else sin)
            again = k67.rope_fwd(inp, cos, sin, transpose=tr)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            assert torch.equal(got, ref), f"{name} {shape}: max_abs_err {err}"
            assert torch.equal(got, again), f"{name} {shape}: two calls"
            ms = timer(lambda: k67.rope_fwd(inp, cos, sin, transpose=tr))
            plain = timer(lambda: k67.rope_reference(
                inp, cos, k67.rope_bwd_table(sin) if tr else sin))
            copy = timer(lambda: got.copy_(inp))
            nbytes = 2 * 2 * inp.numel() + 2 * 4 * cos.numel()
            bms, by = bound(nbytes, 0, BF16_FLOPS)
            inst = f"bf16 x{plan[0]} {'transposed' if tr else 'forward'}"
            log(f"K12 {name} {shape}: bit-equal to plain, two calls equal, "
                f"kernel_ms {ms:.4f} plain_ms {plain:.4f} library_ms none "
                f"copy_ms {copy:.4f} bound_ms {bms:.4f} ({by}, share "
                f"{bms / ms:.2f}; copy_ {bms / copy:.2f}); plan "
                f"(vec, tpr, rpt, chunks, ppc, items) {plan}; {inst} "
                f"{ptxas[inst]}")
            rows.append({"name": f"{name}_h{shape[2]}", "route": "cuda",
                         "source": "paddle_tpu_torch/csrc/rope.cu",
                         "replaces":
                             "paddle_tpu/ops/pallas/fused_norm_rope.py:211",
                         "max_abs_err": err, "ms": ms, "plain_ms": plain,
                         "bound_ms": bms, "bound_by": by, "library_ms": None,
                         "copy_ms": copy,
                         "shape": f"{shape} bf16, (S, D) f32 tables",
                         "plan": plan, "ptxas": {inst: ptxas[inst]}})
    return rows


def check_rope_seam(torch, k1, k67):
    """The training attend seam at the train step's shapes (B=4 x S=2048,
    Llama-3-8B's 32 q and 8 kv heads): one layer's ``_train_attend`` run
    with K12 and again with ``chain_rope`` in ``fused_rope``'s place (the
    f32 chain): the attention's inputs q2 and k2, its output and the
    q, k and v gradients bitwise equal; 4 K12 launches (q and k, forward
    and backward) in the first run, none in the second."""
    from paddle_tpu_torch.models import llama

    cfg = llama.LlamaConfig.llama3_8b(dtype="bfloat16")
    g = torch.Generator(device="cuda").manual_seed(SEED + 28)
    q, k, v, dout = (torch.randn((TB, TS, n * cfg.head_dim), generator=g,
                                 device="cuda").to(torch.bfloat16)
                     for n in (32, 8, 8, 32))
    attention, fused = k1.flash_attention_train, k67.fused_rope
    runs = []
    for rope in (fused, chain_rope):
        seen = []

        def recording(q2, k2, *a, **kw):
            seen.extend((q2.detach(), k2.detach()))
            return attention(q2, k2, *a, **kw)

        k1.flash_attention_train, k67.fused_rope = recording, rope
        try:
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            n = k67.rope_launches
            out = llama._train_attend(cfg, *leaves, False, None)
            out.backward(dout)
            torch.cuda.synchronize()
            runs.append((seen + [out.detach()] + [t.grad for t in leaves],
                         k67.rope_launches - n))
        finally:
            k1.flash_attention_train, k67.fused_rope = attention, fused
    (got, n_k12), (want, n_chain) = runs
    names = ("q2", "k2", "out", "dq", "dk", "dv")
    same = {nm: torch.equal(a, b) for nm, a, b in zip(names, got, want)}
    log(f"rope seam (B{TB} S{TS}, 32/8 heads): K12 against the f32 chain, "
        f"bitwise equal {same}; K12 launches {n_k12} / {n_chain}")
    assert all(same.values()) and (n_k12, n_chain) == (4, 0), (same, n_k12)
    return {"bitwise_equal": same, "k12_launches": n_k12}


def check_prefill_rope(torch, k67, L, sites, label):
    """The solo prefill and the prompt-logits forward rope q and k in K12:
    every call's output bitwise equal to ``chain_rope`` on its input, and
    2 K12 launches a layer. ``sites``: {name: a function running it}."""
    fused = k67.fused_rope
    equal = []

    def recording(x, cos, sin, plain=False):
        out = fused(x, cos, sin, plain=plain)
        equal.append(torch.equal(out, chain_rope(x, cos, sin)))
        return out

    got = {}
    k67.fused_rope = recording
    try:
        for name, run in sites.items():
            equal.clear()
            n = k67.rope_launches
            with torch.inference_mode():
                run()
            torch.cuda.synchronize()
            got[name] = {"k12_launches": k67.rope_launches - n,
                         "bitwise_equal": sum(equal), "calls": len(equal)}
    finally:
        k67.fused_rope = fused
    log(f"{label}: K12 at the rope sites against the f32 chain {got}")
    assert all(r == {"k12_launches": 2 * L, "bitwise_equal": 2 * L,
                     "calls": 2 * L} for r in got.values()), got
    return got


def _masked_loss_and_grads(torch, model, ids, mask, labels, plain=False):
    """(per-token losses of the real labelled tokens over an f32 head, the
    loss, {name: grad}) of one masked forward/backward."""
    hidden = model(ids, mask, plain=plain)
    loss = model.loss(hidden, labels)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    with torch.no_grad():
        lb = labels[:, 1:]
        sel = lb != -100
        h = hidden[:, :-1][sel].float()
        logits = h @ model.lm_head.weight.float()
        tok = torch.logsumexp(logits, -1) - logits.gather(
            1, lb[sel][:, None])[:, 0]
        del logits, h
    return tok, loss.detach().float(), dict(zip(names, grads))


def train_grad_check_masked(torch, k1, kernels):
    """The gradient check on a left-padded batch: 2 full-width layers,
    B=2 x S=2048, row 0 full and row 1 left-padded to GRAD_PAD_REAL real
    tokens (labels -100 on its pads), the key-padding mask through every
    block. The kernel path under ``flash_bwd_impl="split"`` (K1 and K5 with
    the key bias) and under ``"fused"`` (K1 and K9), the plain bf16 path
    and a plain f32 run: per-token losses of the real tokens and every
    gradient, kernel-vs-f32 relative L2 <= 2 x plain-bf16-vs-f32. Two
    controls under "fused" must fail it: the bias dropped inside K1 and K9
    (the kernels get a null bias pointer), and K9 with Delta at zero.
    Returns the readings and the split run's launch counts (the K5-with-
    bias path)."""
    from paddle_tpu_torch.framework import flags
    from paddle_tpu_torch.models.llama import LlamaForCausalLM

    cfg = train_config(2)
    model = LlamaForCausalLM(cfg, seed=SEED).train()
    g = torch.Generator(device="cuda").manual_seed(SEED + 27)
    ids = torch.randint(0, cfg.vocab_size, (2, TS), generator=g,
                        device="cuda")
    mask = left_pad_mask(torch, (TS, GRAD_PAD_REAL), TS)
    ids = ids.masked_fill(~mask, 0)
    labels = ids.masked_fill(~mask, -100)
    old = flags.get_flag("flash_bwd_impl")
    runs = {}
    try:
        for impl in ("split", "fused"):
            flags.set_flags({"flash_bwd_impl": impl})
            kernels.reset_launch_counts()
            runs[impl] = _masked_loss_and_grads(torch, model, ids, mask,
                                                labels)
            torch.cuda.synchronize()
            runs[impl + " counts"] = (kernels.launch_counts(),
                                      kernels.route_counts())
        flags.set_flags({"flash_bwd_impl": "fused"})
        bias_arg, k1._bias_arg = k1._bias_arg, lambda bias: 0
        try:
            runs["bias dropped"] = _masked_loss_and_grads(
                torch, model, ids, mask, labels)
        finally:
            k1._bias_arg = bias_arg
        fault_delta, k1._bwd_delta = (
            k1._bwd_delta, lambda out, do: torch.zeros(
                (out.shape[0], out.shape[2], out.shape[1]),
                dtype=torch.float32, device=out.device))
        try:
            runs["delta 0"] = _masked_loss_and_grads(torch, model, ids, mask,
                                                     labels)
        finally:
            k1._bwd_delta = fault_delta
    finally:
        flags.set_flags({"flash_bwd_impl": old})
    split_counts, split_routes = runs["split counts"]
    fused_counts, _ = runs["fused counts"]
    L = cfg.num_hidden_layers
    assert (split_counts["flash_attention_bwd"],
            split_counts["flash_attention_bwd_fused"]) == (L, 0), split_counts
    assert (fused_counts["flash_attention_bwd"],
            fused_counts["flash_attention_bwd_fused"]) == (0, L), fused_counts
    assert split_routes["plain_attention_route"] == 0, split_routes
    plain = _masked_loss_and_grads(torch, model, ids, mask, labels,
                                   plain=True)
    m32 = LlamaForCausalLM(dataclasses.replace(cfg, dtype="float32"),
                           seed=SEED).train()
    with torch.no_grad():
        for (_, p32), (_, p) in zip(m32.named_parameters(),
                                    model.named_parameters()):
            p32.copy_(p.float())
    del model
    torch.cuda.empty_cache()
    ref = _masked_loss_and_grads(torch, m32, ids, mask, labels, plain=True)
    del m32
    torch.cuda.empty_cache()

    def rel(a, b):
        return ((a.float() - b).norm() / b.norm()).item()

    names = ["per-token loss"] + list(ref[2])

    def pick(run, n):
        return run[0] if n == "per-token loss" else run[2][n]

    out = {}
    for label in ("split", "fused", "bias dropped", "delta 0"):
        ratios = {n: rel(pick(runs[label], n), pick(ref, n))
                  / rel(pick(plain, n), pick(ref, n)) for n in names}
        out[label] = {"worst_ratio": max(ratios.values()),
                      "loss": runs[label][1].item(),
                      "per_tensor": ratios}
        log(f"masked grad check, {label}: worst kernel/plain ratio "
            f"{out[label]['worst_ratio']:.3f} (per-token loss "
            f"{ratios['per-token loss']:.3f}), loss {out[label]['loss']:.5f}")
    out["losses"] = {"plain_bf16": plain[1].item(), "f32": ref[1].item()}
    log(f"masked grad check (2 layers, B2 S{TS}, row 1 "
        f"{GRAD_PAD_REAL} real tokens): plain bf16 loss "
        f"{out['losses']['plain_bf16']:.5f}, f32 {out['losses']['f32']:.5f}")
    for label in ("split", "fused"):
        assert math.isfinite(out[label]["loss"]), out[label]
        assert out[label]["worst_ratio"] <= 2, (label, out[label])
    for label in ("bias dropped", "delta 0"):
        assert out[label]["worst_ratio"] > 2, (
            f"the {label} control passed the rule: the check cannot see it")
    return out, split_counts


def sft_train(torch, kernels, profile=False):
    """Cell llama3-8b-8L-sft: ``jit.TrainStep`` over Llama-3-8B widths cut
    to 8 layers (phase 9's recipe) with ``flash_bwd_impl="fused"`` and
    ``AdamW8bit(LinearWarmup(CosineAnnealingDecay(1e-4, 1000), 2, 1e-5,
    1e-4), grad_clip=ClipGradByGlobalNorm(1.0))``, on B=4 x S=2048 random
    tokens left-padded to SFT_LENGTHS with a bool (B, S) mask, labels -100
    on the pads and on each row's first quarter of real tokens: one
    warm-up step, then TRAIN_STEPS timed steps whose launches must equal
    the plan (K9 in place of K5, no plain-attention route); the loss must
    fall, each step's lr follow the schedule, and the clipped global norm
    be <= 1.0."""
    from paddle_tpu_torch.framework import flags
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.ops.kernels import fusion
    from paddle_tpu_torch.optimizer import AdamW8bit

    assert fusion.enabled_train_fusions() == fusion.TRAIN_FUSIONS
    old = flags.get_flag("flash_bwd_impl")
    flags.set_flags({"flash_bwd_impl": "fused"})
    try:
        return _sft_train(torch, kernels, profile, TrainStep,
                          LlamaForCausalLM, ClipGradByGlobalNorm, fusion,
                          AdamW8bit)
    finally:
        flags.set_flags({"flash_bwd_impl": old})


def _sft_train(torch, kernels, profile, TrainStep, LlamaForCausalLM,
               ClipGradByGlobalNorm, fusion, AdamW8bit):
    cfg = train_config(TRAIN_LAYERS)
    L = cfg.num_hidden_layers
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, seed=SEED)
    torch.cuda.synchronize()
    n_tensors = sum(1 for _ in model.parameters())
    clip = ClipGradByGlobalNorm(SFT_CLIP)
    opt = AdamW8bit(learning_rate=sft_scheduler(),
                    parameters=model.parameters(), grad_clip=clip)
    step = TrainStep(model, lambda out, lb: model.loss(out, lb), opt)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    ids = torch.randint(0, cfg.vocab_size, (TB, TS), generator=g,
                        device="cuda")
    mask = left_pad_mask(torch, SFT_LENGTHS, TS)
    ids = ids.masked_fill(~mask, 0)
    pos = torch.arange(TS, device="cuda")[None, :]
    prompt_end = TS - torch.tensor(SFT_LENGTHS, device="cuda")[:, None] \
        + torch.tensor([n // 4 for n in SFT_LENGTHS], device="cuda")[:, None]
    labels = ids.masked_fill(pos < prompt_end, -100)
    plan = fusion.train_kernel_launches_per_step(
        L, n_tensors, recompute=cfg.recompute,
        granularity=cfg.recompute_granularity,
        fused_head_loss=cfg.fused_head_loss,
        attn_shape=(TB, TS, cfg.num_attention_heads, cfg.head_dim))
    assert (plan["flash_attention_bwd_fused"], plan["flash_attention_bwd"]) \
        == (L, 0), plan
    log(f"sft: Llama-3-8B widths, {L} layers, init "
        f"{time.perf_counter() - t0:.1f}s, lengths {SFT_LENGTHS}, "
        f"flash_bwd_impl fused; plan per step {plan}")

    def timed_step():
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = step((ids, mask), labels)
        torch.cuda.synchronize()
        return ((time.perf_counter() - t) * 1e3, loss.item(), step.last_lr,
                clip.last_global_norm.item())

    torch.cuda.reset_peak_memory_stats()
    warm = timed_step()                                    # warm-up
    kernels.reset_launch_counts()
    runs = [timed_step() for _ in range(TRAIN_STEPS)]      # THE counted run
    counts, routes = kernels.launch_counts(), kernels.route_counts()
    expected = dict.fromkeys(counts, 0)
    expected.update({k: v * TRAIN_STEPS for k, v in plan.items()})
    log(f"sft: launches over {TRAIN_STEPS} steps {counts} expected "
        f"{expected}; routes {routes}")
    assert counts == expected, f"launch counts {counts} != plan {expected}"
    assert routes == {"plain_attention_route": 0}, routes
    peak = torch.cuda.max_memory_allocated() / 2**30
    all_runs = [warm] + runs
    losses = [r[1] for r in all_runs]
    assert all(math.isfinite(x) for x in losses), losses
    assert losses[-1] < losses[0], f"loss did not fall: {losses}"
    sched = sft_scheduler()
    want_lrs = []
    for _ in all_runs:
        want_lrs.append(sched())
        sched.step()
    lrs = [r[2] for r in all_runs]
    assert lrs == want_lrs, f"lrs {lrs} != schedule {want_lrs}"
    norms = [r[3] for r in all_runs]
    # the last step's gradients (p.grad) clipped again: their global norm
    pairs = [(p, p.grad) for _, p in sorted(model.named_parameters())]
    torch.cuda.synchronize()
    t_clip = time.perf_counter()
    out = clip(pairs)                   # the step's clip alone, timed
    torch.cuda.synchronize()
    clip_ms = (time.perf_counter() - t_clip) * 1e3
    clipped = clip.global_norm(out).item()
    del pairs, out
    assert clip.last_global_norm.item() == norms[-1]
    assert clipped <= SFT_CLIP * (1 + 1e-3), clipped
    step_ms = statistics.median(r[0] for r in runs)
    real = sum(SFT_LENGTHS)
    fpt = LlamaForCausalLM.flops_per_token(cfg, TS)
    stats = {"step_ms": step_ms, "step_ms_runs": [r[0] for r in runs],
             "warmup_step_ms": warm[0],
             "tokens_per_s_real": real / step_ms * 1e3,
             "tokens_per_s_all": TB * TS / step_ms * 1e3,
             "mfu_6n_attn": fpt * TB * TS / (step_ms / 1e3) / BF16_FLOPS,
             "losses": losses, "lrs": lrs, "preclip_global_norms": norms,
             "clipped_global_norm": clipped, "clip_ms": clip_ms,
             "max_memory_allocated_gib": peak, "launches": counts}
    log(f"sft: B{TB} S{TS} ({real} real tokens), step_ms "
        f"{[round(r[0], 1) for r in runs]} (median {step_ms:.1f}, warm-up "
        f"{warm[0]:.1f}), {stats['tokens_per_s_real']:.1f} real tok/s "
        f"({stats['tokens_per_s_all']:.1f} over all positions), mfu_6n_attn "
        f"{stats['mfu_6n_attn']:.4f}, losses {losses}, lrs {lrs}, "
        f"pre-clip global norms {norms}, clipped {clipped:.6f} (the clip "
        f"alone {clip_ms:.1f} ms), "
        f"max_memory_allocated {peak:.2f} GiB")
    if profile:
        stats["profile"] = profile_window(
            torch, lambda: step((ids, mask), labels), "sft step")
    del step, opt, model, clip
    torch.cuda.empty_cache()
    return counts, stats


# ---------------------------------------------------------------------------
# MoE training (phases 10-12): K13 and K14 at the Mixtral-8x7B train
# shapes, the full-width MoE gradient check, the timed 3-layer train run
# ---------------------------------------------------------------------------

MOE_LAYERS = 3            # of Mixtral-8x7B's 32: 4.62B params, ~46 GB of
                          # AdamW8bit state (all 32 would need ~470 GB)
MOE_T = TB * TS * 2       # routed rows of one train step: B*S tokens, top-2
# the kernels phase's routing: rows per expert (one empty, one with 30%,
# boundaries off the 128-row tile), 16,384 in all
MOE_COUNTS = (1843, 0, 4915, 2011, 1777, 2049, 1901, 1888)
DW_SLICE = 64             # the rows K14 takes per slice (wgmma_tiles.cuh BK)
MOVE = 64                 # rows the moved-boundary control shifts


def mixtral_config(layers, **kw):
    """Mixtral-8x7B's published widths (mistralai/Mixtral-8x7B-v0.1
    config.json), cut to ``layers`` layers, bf16."""
    from paddle_tpu_torch.models.moe import MoEConfig

    return MoEConfig(**{**dict(
        vocab_size=32000, hidden_size=4096, intermediate_size=14336,
        num_hidden_layers=layers, num_attention_heads=32,
        num_key_value_heads=8, max_position_embeddings=32768,
        rms_norm_eps=1e-5, rope_theta=1e6, num_experts=8, top_k=2,
        moe_aux_loss_coef=0.02, dtype="bfloat16"), **kw})


def _library(torch, fn, want, tol, label):
    """(``fn``, None) when the library call ``fn`` runs on this torch and
    agrees with the plain version ``want`` within ``tol``, else (None, why
    not). A yardstick only: the port never calls it."""
    try:
        out = fn()
        torch.cuda.synchronize()
    except (AttributeError, RuntimeError, TypeError, ValueError) as e:
        why = f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"
    else:
        if tuple(out.shape) == tuple(want.shape) and bool(
                ((out.float() - want.float()).abs() <= tol).all()):
            return fn, None
        why = "disagrees with the plain version"
    log(f"  no library yardstick for {label}: {why}")
    return None, why


def _ptxas(name_of):
    """{key: {registers, spill_stores, spill_loads}} of the build log's
    entry functions, keyed by ``name_of(mangled name)`` (None: skipped)."""
    from paddle_tpu_torch.ops.kernels import _build

    log = (_build.library_path().parent / "build.log").read_text()
    rep, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = name_of(m.group(1))
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            rep.setdefault(cur, {}).update(spill_stores=int(m.group(1)),
                                           spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rep.setdefault(cur, {})["registers"] = int(m.group(1))
    return rep


def ptxas_report(*kernels):
    """{kernel<template args>: {registers, spill_stores, spill_loads}}
    for the build log's entry functions whose name holds one of
    ``kernels``."""
    def name_of(mangled):  # ...<name>ILb0E... is <name><false>
        return next((f"{k}<{'true' if b.group(1) == '1' else 'false'}>"
                     for k in kernels
                     for b in [re.search(k + r"ILb([01])E", mangled)] if b),
                    None)

    return _ptxas(name_of)


def aligned_counts(counts):
    """``counts`` rounded down to multiples of 8, the rows lost added to
    the largest group: the same T, a routing the library's grouped-K
    form takes."""
    out = [c // 8 * 8 for c in counts]
    out[counts.index(max(counts))] += sum(counts) - sum(out)
    assert sum(out) == sum(counts) and all(c % 8 == 0 for c in out)
    return tuple(out)


def check_grouped_matmul(torch, timer, gm):
    """K13 (forward at gate/up 4096 -> 14336 and down 14336 -> 4096, and
    its transposed dX form at 14336 -> 4096) and K14 (dW at both weight
    shapes, bf16 out) at the Mixtral train shapes, T = 16,384 routed rows
    split by MOE_COUNTS; each element within ``gm.tolerance`` /
    ``gm.dw_tolerance`` of the plain version, K14's empty group all
    zeros, two calls of each form bitwise equal. Library:
    ``torch._grouped_mm`` where this torch has it; for K14 its grouped-K
    form, and K14 again, on ``aligned_counts(MOE_COUNTS)``."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 30)
    off = torch.tensor([0, *itertools.accumulate(MOE_COUNTS)],
                       dtype=torch.int32, device="cuda")
    t, e = MOE_T, len(MOE_COUNTS)
    assert int(off[-1]) == t
    h, m = 4096, 14336
    rows = []
    ptxas = ptxas_report("grouped_matmul_kernel", "segment_dw_kernel")
    log(f"K13/K14 ptxas: {ptxas}")

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda")
                * scale).to(torch.bfloat16)

    cases = [("grouped_matmul", h, m, False), ("grouped_matmul_down", m, h,
                                                False),
             ("grouped_matmul_dx", m, h, True)]
    for name, kdim, n, trans in cases:
        x = rnd(t, kdim)
        w = rnd(e, n, kdim, scale=0.02) if trans else rnd(e, kdim, n,
                                                          scale=0.02)
        got = gm.gmm(x, off, w, trans_w=trans)
        ref = gm.grouped_matmul_reference(x, off, w, trans_w=trans)
        torch.cuda.synchronize()
        tol = gm.tolerance(x, off, w, ref, trans_w=trans)
        diff = (got.float() - ref.float()).abs()
        worst = (diff / tol).max().item()
        err = diff.max().item()
        del got, diff
        log(f"K13 {name}: worst err/tol {worst:.3f}")
        assert worst < 1.0, f"{name} worst err/tol {worst}"
        assert _same_bits(torch, lambda: (gm.gmm(x, off, w, trans_w=trans),)
                          ), f"K13 {name}: two calls differ"
        # torch._grouped_mm (group ends as offs) wants B column-major:
        # w^T (E, N, K) lies so for the dX form; else a column-major copy,
        # made outside the timing
        ends = off[1:].contiguous()
        wl = (w.transpose(1, 2) if trans
              else w.transpose(1, 2).contiguous().transpose(1, 2))
        lib_fn, why = _library(torch, lambda: torch._grouped_mm(
            x, wl, offs=ends), ref, tol, name)
        lib_note = "torch._grouped_mm" if lib_fn else f"none: {why}"
        del ref, tol
        ms = timer(lambda: gm.gmm(x, off, w, trans_w=trans))
        plain = timer(lambda: gm.grouped_matmul_reference(
            x, off, w, trans_w=trans), iters=5)
        lib = timer(lib_fn) if lib_fn else None
        del wl
        flops = 2 * t * kdim * n
        nbytes = 2 * (x.numel() + w.numel() + t * n) + 4 * off.numel()
        bms, by = bound(nbytes, flops, BF16_FLOPS)
        log(f"K13 {name} T{t} K{kdim} N{n}: max_abs_err {err:.3e} kernel_ms "
            f"{ms:.4f} ({flops / ms / 1e9:.1f} TFLOP/s, bound share "
            f"{bms / ms:.3f}) plain_ms {plain:.4f} library_ms "
            f"{lib if lib is None else round(lib, 4)} ({lib_note}) "
            f"bound_ms {bms:.4f} ({by}); two calls bitwise equal")
        rows.append({"name": name, "route": "cuda",
                     "source": "paddle_tpu_torch/csrc/grouped_matmul.cu",
                     "replaces": "paddle_tpu/ops/pallas/grouped_matmul.py:200",
                     "max_abs_err": err, "worst_err_over_tol": worst,
                     "ms": ms, "plain_ms": plain, "bound_ms": bms,
                     "bound_by": by, "library_ms": lib,
                     "library_note": lib_note, "bitwise_repeat": True,
                     "ptxas": ptxas.get(f"grouped_matmul_kernel<{str(trans).lower()}>"),
                     "shape": f"T{t} K{kdim} N{n} E{e} rows {MOE_COUNTS}"
                              + (" w^T (dX form)" if trans else "")})
        del x, w
        torch.cuda.empty_cache()

    for name, kdim, n in (("segment_dw", h, m), ("segment_dw_down", m, h)):
        x, dy = rnd(t, kdim), rnd(t, n)
        got = gm.segment_dw(x, dy, off, e, out_dtype=torch.bfloat16)
        ep = (("cast", torch.bfloat16),)
        ref = gm.segment_dw_reference(x, dy, off, e, ep)
        torch.cuda.synchronize()
        tol = gm.dw_tolerance(x, dy, off, e, ref)
        diff = (got.float() - ref.float()).abs()
        worst = (diff / tol).max().item()
        err = diff.max().item()
        empty = [i for i, c in enumerate(MOE_COUNTS) if not c]
        assert all(not got[i].any() for i in empty), "K14: empty group"
        del got, diff
        log(f"K14 {name}: worst err/tol {worst:.3f}, empty group {empty} "
            f"all zeros")
        assert worst < 1.0, f"{name} worst err/tol {worst}"
        assert _same_bits(torch, lambda: (gm.segment_dw(
            x, dy, off, e, out_dtype=torch.bfloat16),)), (
            f"K14 {name}: two calls differ")
        # torch._grouped_mm's grouped-K form (x^T @ dy, group ends on T)
        # asserts on the device, poisoning the context, unless every
        # group's rows are a multiple of 8 (16 bytes): these are not, so
        # there is no one-call yardstick on this routing; the plain
        # version is the per-expert cuBLAS loop
        assert any(c % 8 for c in MOE_COUNTS)
        lib, lib_note = None, ("none: torch._grouped_mm's grouped-K form "
                               "needs each group's rows % 8 == 0")
        del ref, tol
        ms = timer(lambda: gm.segment_dw(x, dy, off, e,
                                         out_dtype=torch.bfloat16))
        plain = timer(lambda: gm.segment_dw_reference(x, dy, off, e, ep),
                      iters=5)
        # the library on the aligned routing: the same T, K14 beside it
        counts_a = aligned_counts(MOE_COUNTS)
        off_a = torch.tensor([0, *itertools.accumulate(counts_a)],
                             dtype=torch.int32, device="cuda")
        got_a = gm.segment_dw(x, dy, off_a, e, out_dtype=torch.bfloat16)
        ref_a = gm.segment_dw_reference(x, dy, off_a, e, ep)
        tol_a = gm.dw_tolerance(x, dy, off_a, e, ref_a)
        worst_a = ((got_a.float() - ref_a.float()).abs() / tol_a).max().item()
        assert worst_a < 1.0, f"{name} aligned worst err/tol {worst_a}"
        ends_a, xt = off_a[1:].contiguous(), x.t()
        lib_a_fn, why_a = _library(torch, lambda: torch._grouped_mm(
            xt, dy, offs=ends_a), ref_a, tol_a, f"{name} aligned")
        del got_a, ref_a, tol_a
        ms_a = timer(lambda: gm.segment_dw(x, dy, off_a, e,
                                           out_dtype=torch.bfloat16))
        lib_a = timer(lib_a_fn) if lib_a_fn else None
        flops = 2 * t * kdim * n
        nbytes = 2 * (x.numel() + dy.numel() + e * kdim * n) + 4 * off.numel()
        bms, by = bound(nbytes, flops, BF16_FLOPS)
        log(f"K14 {name} T{t} K{kdim} N{n}: max_abs_err {err:.3e} kernel_ms "
            f"{ms:.4f} ({flops / ms / 1e9:.1f} TFLOP/s, bound share "
            f"{bms / ms:.3f}) plain_ms {plain:.4f} library_ms "
            f"{lib if lib is None else round(lib, 4)} ({lib_note}) "
            f"bound_ms {bms:.4f} ({by}); two calls bitwise equal; on the "
            f"aligned routing {counts_a}: kernel_ms {ms_a:.4f} (worst "
            f"err/tol {worst_a:.3f}) library_ms "
            f"{lib_a if lib_a is None else round(lib_a, 4)}"
            + ("" if lib_a_fn else f" ({why_a})"))
        rows.append({"name": name, "route": "cuda",
                     "source": "paddle_tpu_torch/csrc/segment_dw.cu",
                     "replaces": "paddle_tpu/ops/pallas/grouped_matmul.py:469",
                     "max_abs_err": err, "worst_err_over_tol": worst,
                     "ms": ms, "plain_ms": plain, "bound_ms": bms,
                     "bound_by": by, "library_ms": lib,
                     "library_note": lib_note, "bitwise_repeat": True,
                     "aligned_counts": counts_a, "aligned_ms": ms_a,
                     "library_aligned_ms": lib_a,
                     "library_aligned_note": (
                         "torch._grouped_mm grouped-K form" if lib_a_fn
                         else f"none: {why_a}"),
                     "ptxas": ptxas.get("segment_dw_kernel<false>"),
                     "shape": f"T{t} K{kdim} N{n} E{e} rows {MOE_COUNTS} "
                              f"bf16 out"})
        del x, dy
        torch.cuda.empty_cache()
    return rows


def _moe_expert_run(torch, moe, gm, x, dy, ws, routing, dtype, plain,
                    offsets=None, drop_chunk=None):
    """y, dx and the three dWs of the expert half of one MoE layer
    (dispatch -> grouped SwiGLU -> combine) under a FIXED routing, in
    ``dtype``; ``offsets`` overrides the routing's (a control);
    ``drop_chunk`` = (lo, hi): rows [lo, hi) of dy are zeroed in every dW
    outer product (a control: a group's last row slice left out)."""
    _, wcomb, order, off = routing
    off = off if offsets is None else offsets
    xr = x.to(dtype).detach().requires_grad_(True)
    wr = [w.detach().to(dtype).requires_grad_(True) for w in ws]
    real_dw = gm.segment_dw_pure
    if drop_chunk is not None:
        def dropped(x2, dy2, o, e, epilogue=None, plain=False):
            dy2 = dy2.clone()
            dy2[drop_chunk[0]:drop_chunk[1]] = 0
            return real_dw(x2, dy2, o, e, epilogue, plain)
        gm.segment_dw_pure = dropped
    try:
        xs = moe._dispatch(xr, order, 2)
        ys = moe._grouped_swiglu(xs, off, *wr, plain=plain)
        y = moe._combine(ys, order, wcomb, dtype)
        y.backward(dy.to(dtype))
    finally:
        gm.segment_dw_pure = real_dw
    return [y.detach(), xr.grad] + [w.grad for w in wr]


def moe_grad_check(torch, gm):
    """One full-width Mixtral layer's experts at B=1 x S=2048: the routing
    (ids, order, offsets, combine weights) is computed ONCE in f32 from the
    router and shared by three runs of dispatch -> grouped SwiGLU ->
    combine and its backward: the kernel path (K13, K14) in bf16, the plain
    path in bf16 and the plain path in f32. For y, dx, dW_gate, dW_up and
    dW_down: kernel-vs-f32 relative L2 <= 2 x plain-bf16-vs-f32 (phase 8's
    rule). Two controls must fail it: K13 fed offsets with one group
    boundary moved by MOVE rows, and dW with one group's last 64-row slice
    of dy left out. Then a 1-layer full-width MoEForCausalLM: the
    per-token losses of the kernel path against the plain f32 forward,
    and the count of token copies routed to another expert."""
    from paddle_tpu_torch.models import moe

    cfg = mixtral_config(1)
    h, s = cfg.hidden_size, TS
    mlp = moe.MoEMLP(cfg, torch.bfloat16, torch.device("cuda"),
                     torch.Generator(device="cuda").manual_seed(SEED + 31))
    g = torch.Generator(device="cuda").manual_seed(SEED + 32)
    x = torch.randn((s, h), generator=g, device="cuda").to(torch.bfloat16)
    dy = torch.randn((s, h), generator=g, device="cuda").to(torch.bfloat16)
    ws = (mlp.w_gate, mlp.w_up, mlp.w_down)
    with torch.no_grad():
        routing = moe._dropless_routing(
            (x.float() @ mlp.gate.weight.float())[None], cfg.top_k)
    off = routing[3].tolist()
    sizes = [b - a for a, b in zip(off, off[1:])]
    log(f"moe grad check: routed rows per expert {sizes}")
    kern = _moe_expert_run(torch, moe, gm, x, dy, ws, routing,
                           torch.bfloat16, False)
    plain = _moe_expert_run(torch, moe, gm, x, dy, ws, routing,
                            torch.bfloat16, True)
    ref = _moe_expert_run(torch, moe, gm, x, dy, ws, routing,
                          torch.float32, True)
    # control (a): the first boundary after a non-empty group whose next
    # group holds at least MOVE rows moves down MOVE rows (those rows
    # compute with their neighbour's expert)
    j = next(i for i in range(1, len(off) - 1)
             if off[i] > off[i - 1] and off[i + 1] - off[i] >= MOVE)
    moved = routing[3].clone()
    moved[j] += MOVE
    ctl_a = _moe_expert_run(torch, moe, gm, x, dy, ws, routing,
                            torch.bfloat16, False, offsets=moved)
    # control (b): the largest group's last K14 row slice left out of dW
    big = max(range(len(sizes)), key=lambda i: sizes[i])
    hi = off[big + 1]
    chunk = (hi - ((sizes[big] - 1) % DW_SLICE + 1), hi)
    ctl_b = _moe_expert_run(torch, moe, gm, x, dy, ws, routing,
                            torch.bfloat16, False, drop_chunk=chunk)

    def rel(a, r):
        return ((a.float() - r).norm() / r.norm()).item()

    names = ("y", "dx", "dW_gate", "dW_up", "dW_down")
    rows, worst, ctl = {}, 0.0, {"a": 0.0, "b": 0.0}
    for i, name in enumerate(names):
        ek, ep = rel(kern[i], ref[i]), rel(plain[i], ref[i])
        ea, eb = rel(ctl_a[i], ref[i]), rel(ctl_b[i], ref[i])
        rows[name] = {"kernel": ek, "plain_bf16": ep,
                      "kernel_over_plain": ek / ep,
                      "moved_boundary_over_plain": ea / ep,
                      "dropped_slice_over_plain": eb / ep}
        worst = max(worst, ek / ep)
        ctl["a"], ctl["b"] = max(ctl["a"], ea / ep), max(ctl["b"], eb / ep)
        log(f"  moe grad check {name}: rel L2 err vs f32 kernel {ek:.3e} "
            f"plain bf16 {ep:.3e} ratio {ek / ep:.3f}; controls: moved "
            f"boundary {ea / ep:.3f}, dropped dW slice {eb / ep:.3f}")
    del kern, plain, ref, ctl_a, ctl_b, mlp
    torch.cuda.empty_cache()
    assert worst <= 2, f"MoE kernel/plain bf16 error ratio {worst}"
    assert ctl["a"] > 2 and ctl["b"] > 2, (
        f"a control passed the rule {ctl}: the check cannot see a fault")

    # the 1-layer model: per-token losses and routing flips, kernel path
    # (bf16) against the plain f32 forward of the same weights
    model = moe.MoEForCausalLM(cfg, seed=SEED)
    ids = torch.randint(0, cfg.vocab_size, (1, s), generator=g,
                        device="cuda")
    m32 = moe.MoEForCausalLM(dataclasses.replace(cfg, dtype="float32"),
                             seed=SEED)
    probes, tok = {}, {}
    with torch.no_grad():
        for p32, p in zip(m32.parameters(), model.parameters()):
            p32.copy_(p.float())
        for label, mdl, plain_ in (("kernel", model, False),
                                   ("f32", m32, True)):
            probes[label] = []
            logits, _ = mdl(ids, router_probe=probes[label], plain=plain_)
            lg = logits[0, :-1].float()
            tok[label] = torch.logsumexp(lg, -1) - lg.gather(
                1, ids[0, 1:, None])[:, 0]
            del logits, lg
    del model, m32
    torch.cuda.empty_cache()
    sel = {k: moe._topk_select(torch.softmax(v[0].float(), -1), 2)[0]
           for k, v in probes.items()}
    flips = int((sel["kernel"] != sel["f32"]).sum())
    loss_rel = rel(tok["kernel"], tok["f32"])
    log(f"moe 1-layer model (B1 S{s}): per-token loss rel L2 err vs f32 "
        f"{loss_rel:.3e}, mean loss kernel {tok['kernel'].mean():.5f} f32 "
        f"{tok['f32'].mean():.5f}; token copies routed to another expert "
        f"than in f32: {flips} of {2 * s}")
    assert all(torch.isfinite(v).all() for v in tok.values())
    return {"routed_rows": sizes, "per_tensor": rows, "worst_ratio": worst,
            "control_worst_ratio": ctl, "one_layer_loss_rel_err": loss_rel,
            "one_layer_routing_flips": flips}


# ---------------------------------------------------------------------------
# Quantized experts (phases 10b and 11b): K13's int8/int4 forms at the
# Mixtral-8x7B train shapes, the full-width quantized expert check, the
# 1-layer model after ``quantize_experts`` and its forward + backward wall
# ---------------------------------------------------------------------------

#: (weight type, group size) of phase 10b's forms; the first of each type
#: is the one phase 11b drives (its row in the kernels line)
MOE_QUANT_FORMS = (("int8", -1), ("int8", 128), ("int4", 128), ("int4", -1))
#: phase 11b's forms and the paths their counted runs name
MOE_QUANT_PATHS = (("int8", -1, "moe quant int8"),
                   ("int4", 128, "moe quant int4 g128"))


def _form(wd, gs):
    return wd if gs == -1 else f"{wd} g{gs}"


def dequant_stack_bf16(torch, codes, scales, wd, gs):
    """The library yardstick's dequantization: the whole (E, K, N) stack
    in bf16 by the dequant rule (bf16(code) * bf16(scale)), vectorized,
    laid out column-major as ``torch._grouped_mm`` takes B. A yardstick
    only: the port never calls it."""
    if wd == "int4":
        p = codes.to(torch.int32)
        low, high = ((p & 0xF) ^ 8) - 8, p >> 4
        codes = torch.stack([low, high], dim=2).reshape(
            codes.shape[0], -1, codes.shape[-1])
    s = scales.to(torch.bfloat16)
    s = s[:, None, :] if gs == -1 else s.repeat_interleave(gs, dim=1)
    w = codes.to(torch.bfloat16) * s
    return w.transpose(1, 2).contiguous().transpose(1, 2)


def _ptxas_key(wd, group_wise, bn):
    return f"{wd} {'kGroup' if group_wise else 'kEnd'} BN{bn}"


def ptxas_quant_report():
    """{form: {registers, spill_stores, spill_loads}} of K13's int8/int4
    instantiations (``quant_wgmma_kernel<false, WT, SM, GroupWalk<BN>>``)
    and of K4's group-wise ones (``... TileWalk<128>`` with kGroup, keys
    led by "K4 ") from the build log."""
    def name_of(mangled):
        g = re.search(r"quant_wgmma_kernelILb0ELi(\d)ELi(\d)ENS\d_"
                      r"(9Group|8Tile)WalkILi(\d+)", mangled)
        k4 = g is not None and g.group(3) == "8Tile"
        if not g or (k4 and g.group(2) != "2"):
            return None
        return ("K4 " if k4 else "") + _ptxas_key(
            "int8" if g.group(1) == "1" else "int4", g.group(2) == "2",
            int(g.group(4)))

    return _ptxas(name_of)


def check_group_wise_spills(ptxas):
    """Every kGroup instance (K13's and K4's int8/int4 group-wise forms)
    built without spills: its partial sum and total (2 x 64 f32) fit the
    consumers' registers beside the conversion."""
    group_wise = {k: v for k, v in ptxas.items() if "kGroup" in k}
    assert len(group_wise) == 4, f"kGroup instances in the build log: {ptxas}"
    spilled = {k: v for k, v in group_wise.items()
               if v.get("spill_stores", 0) or v.get("spill_loads", 0)}
    assert not spilled, f"kGroup instances spill: {spilled}"


def check_grouped_matmul_quant(torch, timer, gm):
    """Phase 10b: K13's int8/int4 forms (int8 and int4, per channel and
    group 128) at 4096 -> 14336 and 14336 -> 4096 on phase 10's routing
    (T = 16,384 rows by MOE_COUNTS), the experts quantized on the card
    (``quantize_grouped_weight``). Each case: every element within
    ``gm.quant_tolerance`` of the plain version (K13's summation bound plus
    one bf16 rounding of each dequantized weight in the plain version:
    (K/4 * 2^-24 + 2^-8) * (|x| @ |W|) + 1e-2 * |ref|, W dequantized in
    f32), two calls bitwise equal, the items the card decodes equal to
    ``gm.gmm_items`` at the form's tile width, the scales shifted by SHIFT
    columns failing the rule; kernel, plain and library times (dequant
    into a column-major bf16 stack + ``torch._grouped_mm``), TFLOP/s,
    bound share, registers and spills. One row a weight type, headed by
    the form phase 11b drives."""
    from paddle_tpu_torch.ops.kernels import _build

    g = torch.Generator(device="cuda").manual_seed(SEED + 33)
    off = torch.tensor([0, *itertools.accumulate(MOE_COUNTS)],
                       dtype=torch.int32, device="cuda")
    t, e = MOE_T, len(MOE_COUNTS)
    ends = off[1:].contiguous()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ptxas = ptxas_quant_report()
    log(f"K13 / K4 int8/int4 ptxas: {ptxas}")
    check_group_wise_spills(ptxas)
    cases = {}
    for wd, gs in MOE_QUANT_FORMS:
        for kdim, n in ((4096, 14336), (14336, 4096)):
            x = torch.randn((t, kdim), generator=g, device="cuda").to(
                torch.bfloat16)
            w = torch.randn((e, kdim, n), generator=g,
                            device="cuda") / math.sqrt(kdim)
            codes, scales = gm.quantize_grouped_weight(w, f"weight_only_{wd}",
                                                       gs)
            del w
            args = (codes, scales, wd, gs)
            got = gm.gmm_quant(x, off, *args)
            ref = gm.grouped_matmul_reference(x, off, *args)
            torch.cuda.synchronize()
            tol = gm.quant_tolerance(x, off, *args, ref)
            diff = (got.float() - ref.float()).abs()
            worst, err = (diff / tol).max().item(), diff.max().item()
            del got, diff
            label = f"K13 {_form(wd, gs)} T{t} K{kdim} N{n}"
            assert worst < 1.0, f"{label}: worst err/tol {worst}"
            assert _same_bits(torch, lambda: (gm.gmm_quant(x, off, *args),)
                              ), f"{label}: two calls differ"
            bad = gm.gmm_quant(x, off, codes, scales.roll(SHIFT, -1)
                               .contiguous(), wd, gs)
            ctl = ((bad.float() - ref.float()).abs() / tol).max().item()
            del bad
            assert ctl > 1, f"{label}: the shifted-scale control passed"
            bn = gm.quant_tile_n(gs)
            want = gm.gmm_items(off.tolist(), t, kdim, n, bn)
            items = torch.full((len(want), 6), -1, dtype=torch.int32,
                               device="cuda")
            _build.launch("pt_grouped_matmul_items", off.data_ptr(), t, kdim,
                          n, e, bn, items.data_ptr(), _build.stream_of(off))
            assert items.cpu().tolist() == [list(it) for it in want], (
                f"{label}: the items decoded on the card differ from "
                f"gmm_items at {bn} columns")
            lib_fn, why = _library(torch, lambda: torch._grouped_mm(
                x, dequant_stack_bf16(torch, *args), offs=ends), ref, tol,
                label)
            del ref, tol
            ms = timer(lambda: gm.gmm_quant(x, off, *args))
            plain = timer(lambda: gm.grouped_matmul_reference(x, off, *args),
                          iters=5)
            lib = timer(lib_fn) if lib_fn else None
            if lib_fn:  # the grouped GEMM alone, on a stack dequantized once
                dense = dequant_stack_bf16(torch, *args)
                gemm = timer(lambda: torch._grouped_mm(x, dense, offs=ends))
                del dense
            else:
                gemm = None
            flops = 2 * t * kdim * n
            nbytes = (2 * x.numel() + codes.numel() + 4 * scales.numel()
                      + 2 * t * n + 4 * off.numel())
            bms, by = bound(nbytes, flops, BF16_FLOPS)
            row = {"shape": f"T{t} K{kdim} N{n} E{e} {_form(wd, gs)} rows "
                            f"{MOE_COUNTS}",
                   "max_abs_err": err, "worst_err_over_tol": worst,
                   "control_worst_err_over_tol": ctl, "ms": ms,
                   "plain_ms": plain, "bound_ms": bms, "bound_by": by,
                   "library_ms": lib, "library_gemm_only_ms": gemm,
                   "library_note": ("dequant (bf16, column-major) + "
                                    "torch._grouped_mm" if lib_fn
                                    else f"none: {why}"),
                   "bitwise_repeat": True, "block_n": bn,
                   "items": len(want), "grid": min(len(want), sms),
                   "ptxas": ptxas.get(_ptxas_key(wd, gs > 0, bn))}
            log(f"{label}: max_abs_err {err:.3e} (worst err/tol "
                f"{worst:.3f}) kernel_ms {ms:.4f} ({_rate(row, flops)}) "
                f"plain_ms {plain:.4f} library_ms "
                f"{lib if lib is None else round(lib, 4)} "
                f"({row['library_note']}; the GEMM alone "
                f"{gemm if gemm is None else round(gemm, 4)}) bound_ms "
                f"{bms:.4f} ({by}); two "
                f"calls bitwise equal; {len(want)} items of 128 x {bn} as "
                f"gmm_items walks them; shifted-scale control worst err/tol "
                f"{ctl:.3f} (fails, as it must); ptxas {row['ptxas']}")
            cases.setdefault(wd, []).append(row)
            del x, codes, scales, items
            torch.cuda.empty_cache()
    rows = []
    for wd, gs, _ in MOE_QUANT_PATHS:
        shapes = cases[wd]
        head = next(r for r in shapes if r["shape"].endswith(
            f"{_form(wd, gs)} rows {MOE_COUNTS}"))
        rows.append({"name": f"grouped_matmul_{wd}", "route": "cuda",
                     "source": "paddle_tpu_torch/csrc/grouped_matmul_quant.cu",
                     "replaces": "paddle_tpu/ops/pallas/grouped_matmul.py:200",
                     "max_abs_err": max(r["max_abs_err"] for r in shapes),
                     **{k: head[k] for k in ("ms", "plain_ms", "bound_ms",
                                             "bound_by", "library_ms",
                                             "shape")},
                     "shapes": shapes})
    return rows


def _moe_quant_expert_run(torch, moe, x, dy, quant, routing, dtype, plain,
                          offsets=None, scales=None):
    """y and dx of the expert half of one MoE layer (dispatch -> grouped
    SwiGLU -> combine) with quantized experts ``quant`` (an
    ``_expert_quant`` dict) under a FIXED routing, in ``dtype``;
    ``offsets`` / ``scales`` override the routing's offsets and the
    experts' scales (the controls)."""
    _, wcomb, order, off = routing
    off = off if offsets is None else offsets
    names = ("w_gate", "w_up", "w_down")
    codes = [quant[n][0] for n in names]
    scales = [quant[n][1] for n in names] if scales is None else scales
    xr = x.to(dtype).detach().requires_grad_(True)
    xs = moe._dispatch(xr, order, 2)
    ys = moe._grouped_swiglu(xs, off, *codes, quant["weight_dtype"],
                             quant["group_size"], scales, plain=plain)
    y = moe._combine(ys, order, wcomb, dtype)
    y.backward(dy.to(dtype))
    return [y.detach(), xr.grad]


def _fwd_bwd_wall(torch, model, ids, label, profile):
    """Median wall ms of 3 forward + backward passes of ``model`` on ids
    (after one warm-up), the peak memory of those passes in GiB, and with
    ``profile`` a traced fourth pass (``profile_window``)."""
    def step():
        model.loss(model(ids), ids).backward()
        model.zero_grad(set_to_none=True)

    def once():
        torch.cuda.synchronize()
        t = time.perf_counter()
        step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    once()
    torch.cuda.reset_peak_memory_stats()
    walls = [once() for _ in range(3)]
    peak = torch.cuda.max_memory_allocated() / 2**30
    return (statistics.median(walls), walls, peak,
            profile_window(torch, step, label) if profile else None)


def moe_quant(torch, kernels, gm, profile=False):
    """Phase 11b (cell mixtral-8x7b-1L-int8-experts): for int8 per channel
    and int4 group 128 (MOE_QUANT_PATHS), with the experts quantized on
    the card (``MoEMLP.quantize_experts``):

    - one full-width Mixtral layer's experts at B=1 x S=2048 under phase
      11's routing, computed once in f32: y and dx of the kernel path (K13
      int8/int4 forward; dx through the bf16 dequantized stack and K13's
      transposed form), the plain path in bf16 and the plain path in f32
      (the quantized function, codes dequantized in f32); kernel-vs-f32
      relative L2 <= 2 x plain-bf16-vs-f32 (phase 8's rule), which two
      controls must fail: K13 fed offsets with one boundary moved by MOVE
      rows, and every scale stack shifted by SHIFT columns;
    - a 1-layer full-width ``MoEForCausalLM`` after ``quantize_experts``:
      per-token losses of the kernel path against its plain f32 forward
      (the same codes and scales); one forward + backward whose launches
      (counts set to 0 just before, read just after) must equal
      ``fusion.moe_train_kernel_launches_per_step(1, 0,
      quantized_experts=True)``: 3 K13 int8/int4, 3 K13 dX, no K14;
    - B=4 x S=2048 forward + backward wall (median of 3 after a warm-up)
      and peak memory against the same layer in bf16, in this call (the
      fp expert stacks freed, as phase 5 frees the bf16 weights).

    Returns ({path: counts}, stats)."""
    from paddle_tpu_torch.models import moe
    from paddle_tpu_torch.ops.kernels import fusion

    cfg = mixtral_config(1)
    h, s = cfg.hidden_size, TS
    mlp = moe.MoEMLP(cfg, torch.bfloat16, torch.device("cuda"),
                     torch.Generator(device="cuda").manual_seed(SEED + 31))
    g = torch.Generator(device="cuda").manual_seed(SEED + 32)
    x = torch.randn((s, h), generator=g, device="cuda").to(torch.bfloat16)
    dy = torch.randn((s, h), generator=g, device="cuda").to(torch.bfloat16)
    with torch.no_grad():
        routing = moe._dropless_routing(
            (x.float() @ mlp.gate.weight.float())[None], cfg.top_k)
    off = routing[3].tolist()
    j = next(i for i in range(1, len(off) - 1)
             if off[i] > off[i - 1] and off[i + 1] - off[i] >= MOVE)
    moved = routing[3].clone()
    moved[j] += MOVE

    def rel(a, r):
        return ((a.float() - r).norm() / r.norm()).item()

    counts, stats = {}, {"routed_rows": [b - a for a, b in zip(off, off[1:])]}
    model = moe.MoEForCausalLM(cfg, seed=SEED)
    ids = torch.randint(0, cfg.vocab_size, (1, s), generator=g,
                        device="cuda")
    m32 = moe.MoEForCausalLM(dataclasses.replace(cfg, dtype="float32"),
                             seed=SEED)
    with torch.no_grad():
        for p32, p in zip(m32.parameters(), model.parameters()):
            p32.copy_(p.float())
    quants = {}
    for wd, gs, path in MOE_QUANT_PATHS:
        algo, form = f"weight_only_{wd}", _form(wd, gs)
        quant = mlp.quantize_experts(algo, gs)._expert_quant
        run = lambda dtype, plain, **kw: _moe_quant_expert_run(  # noqa: E731
            torch, moe, x, dy, quant, routing, dtype, plain, **kw)
        kern, plain, ref = (run(torch.bfloat16, False),
                            run(torch.bfloat16, True),
                            run(torch.float32, True))
        ctl_a = run(torch.bfloat16, False, offsets=moved)
        ctl_b = run(torch.bfloat16, False, scales=[
            quant[n][1].roll(SHIFT, -1).contiguous()
            for n in ("w_gate", "w_up", "w_down")])
        per, worst, ctl = {}, 0.0, {"a": 0.0, "b": 0.0}
        for i, name in enumerate(("y", "dx")):
            ek, ep = rel(kern[i], ref[i]), rel(plain[i], ref[i])
            ea, eb = rel(ctl_a[i], ref[i]), rel(ctl_b[i], ref[i])
            per[name] = {"kernel": ek, "plain_bf16": ep,
                         "kernel_over_plain": ek / ep,
                         "moved_boundary_over_plain": ea / ep,
                         "shifted_scales_over_plain": eb / ep}
            worst = max(worst, ek / ep)
            ctl["a"], ctl["b"] = max(ctl["a"], ea / ep), max(ctl["b"],
                                                             eb / ep)
            log(f"  moe {form} expert check {name}: rel L2 err vs f32 "
                f"(quantized function) kernel {ek:.3e} plain bf16 {ep:.3e} "
                f"ratio {ek / ep:.3f}; controls: moved boundary "
                f"{ea / ep:.3f}, shifted scales {eb / ep:.3f}")
        del kern, plain, ref, ctl_a, ctl_b
        assert worst <= 2, f"MoE {form} kernel/plain bf16 ratio {worst}"
        assert ctl["a"] > 2 and ctl["b"] > 2, (
            f"a {form} control passed the rule {ctl}: the check cannot see "
            f"a fault")

        # the 1-layer model: the same codes in bf16 (kernel path) and f32
        # (plain), per-token losses, then the counted forward + backward
        model.quantize_experts(algo, gs)
        quants[path] = model.layers[0].mlp._expert_quant
        m32.layers[0].mlp._expert_quant = quants[path]
        tok = {}
        with torch.no_grad():
            for label, mdl, plain_ in (("kernel", model, False),
                                       ("f32", m32, True)):
                logits, _ = mdl(ids, plain=plain_)
                lg = logits[0, :-1].float()
                tok[label] = torch.logsumexp(lg, -1) - lg.gather(
                    1, ids[0, 1:, None])[:, 0]
                del logits, lg
        assert all(torch.isfinite(v).all() for v in tok.values())
        loss_rel = rel(tok["kernel"], tok["f32"])
        model.train()
        kernels.reset_launch_counts()
        model.loss(model(ids), ids).backward()                 # counted
        torch.cuda.synchronize()
        counts[path] = kernels.launch_counts()
        model.zero_grad(set_to_none=True)
        model.eval()
        plan = fusion.moe_train_kernel_launches_per_step(
            1, 0, quantized_experts=True)
        expected = dict.fromkeys(counts[path], 0)
        expected.update(plan)
        log(f"moe {form} 1-layer model (B1 S{s}): per-token loss rel L2 err "
            f"vs f32 {loss_rel:.3e}, mean loss kernel "
            f"{tok['kernel'].mean():.5f} f32 {tok['f32'].mean():.5f}; "
            f"forward + backward launches {counts[path]} expected "
            f"{expected}")
        assert counts[path] == expected, (
            f"{form} launch counts {counts[path]} != plan {expected}")
        stats[form] = {"per_tensor": per, "worst_ratio": worst,
                       "control_worst_ratio": ctl,
                       "one_layer_loss_rel_err": loss_rel,
                       "launches": counts[path]}
    del m32, mlp, x, dy
    torch.cuda.empty_cache()

    # B=4 x S=2048 forward + backward: bf16, then each quantized form with
    # the fp expert stacks freed
    ids4 = torch.randint(0, cfg.vocab_size, (TB, TS), generator=g,
                         device="cuda")
    mlp0 = model.layers[0].mlp
    model.train()
    mlp0._expert_quant = None
    bf16 = _fwd_bwd_wall(torch, model, ids4, "moe 1-layer fwd+bwd bf16",
                         profile)
    for name in ("w_gate", "w_up", "w_down"):
        getattr(mlp0, name).data = torch.empty(0, dtype=torch.bfloat16,
                                               device="cuda")
    torch.cuda.empty_cache()
    walls = {"bf16": bf16}
    for wd, gs, path in MOE_QUANT_PATHS:
        mlp0._expert_quant = quants[path]
        walls[_form(wd, gs)] = _fwd_bwd_wall(
            torch, model, ids4, f"moe 1-layer fwd+bwd {_form(wd, gs)}",
            profile)
    for form, (ms, runs, peak, prof) in walls.items():
        log(f"moe 1-layer B{TB} S{TS} forward + backward, {form} experts: "
            f"{ms:.2f} ms (runs {[round(r, 2) for r in runs]}), peak "
            f"{peak:.2f} GiB")
        stats.setdefault(form, {}).update(fwd_bwd_ms=ms, fwd_bwd_runs=runs,
                                          max_memory_allocated_gib=peak,
                                          profile=prof)
    del model, quants
    torch.cuda.empty_cache()
    return counts, stats


def moe_train(torch, kernels, profile=False):
    """The timed MoE train run (cell mixtral-8x7b-3L-train): Mixtral-8x7B
    widths, 3 layers, bf16, AdamW8bit(1e-4) with f32 masters, B=4 x S=2048
    random tokens (the same batch every step): one warm-up step, then
    TRAIN_STEPS timed steps whose launch counts must equal the plan."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import moe
    from paddle_tpu_torch.ops.kernels import fusion
    from paddle_tpu_torch.optimizer import AdamW8bit

    assert fusion.enabled_train_fusions() == fusion.TRAIN_FUSIONS
    cfg = mixtral_config(MOE_LAYERS)
    L = cfg.num_hidden_layers
    t0 = time.perf_counter()
    model = moe.MoEForCausalLM(cfg, seed=SEED)
    torch.cuda.synchronize()
    n_tensors = sum(1 for _ in model.parameters())
    n_params = sum(p.numel() for p in model.parameters())
    opt = AdamW8bit(learning_rate=1e-4, parameters=model.parameters())
    step = TrainStep(model, lambda out, lb: model.loss(out, lb), opt)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    ids = torch.randint(0, cfg.vocab_size, (TB, TS), generator=g,
                        device="cuda")
    plan = fusion.moe_train_kernel_launches_per_step(L, n_tensors)
    assert n_tensors == 10 * L + 3 and plan["adamw8bit"] == n_tensors, plan
    log(f"moe train: Mixtral-8x7B widths, {L} layers, {n_params / 1e9:.3f}B "
        f"params bf16 ({n_tensors} tensors), init "
        f"{time.perf_counter() - t0:.1f}s; plan per step {plan}")

    def timed_step():
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = step(ids, ids)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3, loss.item()

    torch.cuda.reset_peak_memory_stats()
    warm_ms, first_loss = timed_step()                     # warm-up
    kernels.reset_launch_counts()
    runs = [timed_step() for _ in range(TRAIN_STEPS)]      # THE counted run
    counts = kernels.launch_counts()
    expected = dict.fromkeys(counts, 0)
    expected.update({k: v * TRAIN_STEPS for k, v in plan.items()})
    log(f"moe train: launches over {TRAIN_STEPS} steps {counts} expected "
        f"{expected}")
    assert counts == expected, f"launch counts {counts} != plan {expected}"
    losses = [first_loss] + [l for _, l in runs]
    assert all(math.isfinite(l) for l in losses), losses
    assert losses[-1] < losses[0], f"loss did not fall: {losses}"
    step_ms = statistics.median(t for t, _ in runs)
    tokens = TB * TS
    fpt = moe.MoEForCausalLM.flops_per_token(cfg, TS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    stats = {"step_ms": step_ms, "step_ms_runs": [t for t, _ in runs],
             "warmup_step_ms": warm_ms, "tokens_per_s": tokens / step_ms * 1e3,
             "mfu_6n_attn": fpt * tokens / (step_ms / 1e3) / BF16_FLOPS,
             "losses": losses, "max_memory_allocated_gib": peak,
             "params": n_params, "launches": counts}
    if profile:
        stats["profile"] = profile_window(torch, lambda: step(ids, ids),
                                          "moe train step")
    # each layer's aux loss and routed rows per expert on the batch, after
    # the timed steps (the probe's forward is not counted)
    probe = []
    with torch.no_grad():
        model.eval()
        model(ids, router_probe=probe)
    stats["aux_per_layer"], stats["routed_rows_per_layer"] = [], []
    for lg in probe:
        aux, _, _, off = moe._dropless_routing(lg, cfg.top_k)
        stats["aux_per_layer"].append(aux.item())
        off = off.tolist()
        stats["routed_rows_per_layer"].append(
            [b - a for a, b in zip(off, off[1:])])
    log(f"moe train: B{TB} S{TS}, step_ms {[round(t, 1) for t, _ in runs]} "
        f"(median {step_ms:.1f}, warm-up {warm_ms:.1f}), "
        f"{stats['tokens_per_s']:.1f} tok/s, mfu_6n_attn "
        f"{stats['mfu_6n_attn']:.4f}, losses {losses}, "
        f"max_memory_allocated {peak:.2f} GiB, aux per layer "
        f"{stats['aux_per_layer']}, routed rows per expert "
        f"{stats['routed_rows_per_layer']}")
    del step, opt, model, probe
    torch.cuda.empty_cache()
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
    from paddle_tpu_torch.ops.kernels import fused_norm_rope as k67
    from paddle_tpu_torch.ops.kernels import fused_optimizer_update as k8
    from paddle_tpu_torch.ops.kernels import fused_rope_attend as k3
    from paddle_tpu_torch.ops.kernels import grouped_matmul as k1314
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
                                     _rope_tables), "batcher fused"),
           (check_ragged_attention(torch, timer, k11, kv_cache, _rope_tables,
                                   int8=True),
            "batcher int8 unfused attention"),
           (check_rope_attend_ragged(torch, timer, k3, kv_cache,
                                     _rope_tables, int8=True),
            "batcher int8 fused"),
           (check_paged_attention(torch, timer, k10, kv_cache, _rope_tables,
                                  int8=True),
            "batcher int8 unfused attention"),
           (check_rope_attend_masked(torch, timer, k3, kv_cache,
                                     _rope_tables, int8=True),
            "batcher int8 fused")]
    own += [(check(torch, timer, mod, kv_cache, _rope_tables, int8=int8),
             f"batcher {'int8 ' if int8 else ''}spec {plan}")
            for int8 in (False, True)
            for check, mod, plan in (
                (check_ragged_attention_verify, k11, "unfused attention"),
                (check_rope_attend_ragged_verify, k3, "fused"))]
    del timer
    torch.cuda.empty_cache()

    # ---- 4. serving (bf16), 5. int8w+int8kv, 6. continuous batching,
    # 6b. the int8w+int8kv batcher; each path's counts are set to 0 just
    # before its counted run and read just after
    profile = "--profile" in sys.argv
    counts, counts_spec, stats = serve(torch, kernels, profile=profile)
    torch.cuda.empty_cache()
    counts_int8, counts_int8_spec, stats_int8 = serve_int8(
        torch, kernels, profile=profile)
    torch.cuda.empty_cache()
    stats_batcher = serve_batcher(torch, kernels, profile=profile)
    torch.cuda.empty_cache()
    stats_batcher_int8 = serve_batcher(torch, kernels, profile=profile,
                                       int8=True)
    torch.cuda.empty_cache()

    # ---- 7. training kernels vs plain at the train step's shapes, 8. the
    # full-width gradient check, 9. the timed train run (its counts set to
    # 0 just before its counted steps and read just after)
    timer = ColdTimer(torch)
    own += [(row, "train") for row in check_flash_bwd(torch, timer, k1)]
    own += [(row, "train") for row in check_rms_norm(torch, timer, k67)]
    own += [(check_adamw8bit(torch, timer, k8), "train")]
    own += [(row, {"flash_attention_fwd_bias": "sft",
                   "flash_attention_bwd_bias": "grad check split, mask",
                   "flash_attention_bwd_fused": "sft"}[row["name"]])
            for row in check_flash_masked(torch, timer, k1)]
    own += [(row, "train") for row in check_rope(torch, timer, k67)]
    del timer
    torch.cuda.empty_cache()
    rope_seam = check_rope_seam(torch, k1, k67)
    torch.cuda.empty_cache()
    grad_check = train_grad_check(torch, k1)
    torch.cuda.empty_cache()
    masked_check, counts_grad_split = train_grad_check_masked(torch, k1,
                                                              kernels)
    torch.cuda.empty_cache()
    counts_train, stats_train = train(torch, kernels, profile=profile)
    stats_train["grad_check"] = grad_check
    stats_train["rope_seam_check"] = rope_seam
    torch.cuda.empty_cache()

    # ---- 9b. the fine-tuning cell (its counts set to 0 just before its
    # counted steps and read just after)
    counts_sft, stats_sft = sft_train(torch, kernels, profile=profile)
    stats_sft["grad_check_masked"] = masked_check
    log(f"sft step (K9, key bias) {stats_sft['step_ms']:.1f} ms against "
        f"the train step (K5, no mask) {stats_train['step_ms']:.1f} ms; "
        f"peak {stats_sft['max_memory_allocated_gib']:.2f} against "
        f"{stats_train['max_memory_allocated_gib']:.2f} GiB")
    torch.cuda.empty_cache()

    # ---- 10. the MoE kernels vs plain at the Mixtral train shapes, 11. the
    # MoE gradient check, 12. the timed MoE train run (its counts set to 0
    # just before its counted steps and read just after)
    timer = ColdTimer(torch)
    own += [(row, "moe train") for row in check_grouped_matmul(torch, timer,
                                                                k1314)]
    del timer
    torch.cuda.empty_cache()
    moe_check = moe_grad_check(torch, k1314)
    torch.cuda.empty_cache()

    # ---- 10b. K13's int8/int4 forms vs plain at the Mixtral train shapes,
    # 11b. the quantized experts: the full-width check, the 1-layer model's
    # counted forward + backward (counts set to 0 just before it and read
    # just after) and its wall against bf16
    timer = ColdTimer(torch)
    own += [(row, path) for row, (_, _, path) in zip(
        check_grouped_matmul_quant(torch, timer, k1314), MOE_QUANT_PATHS)]
    del timer
    torch.cuda.empty_cache()
    counts_quant, stats_quant = moe_quant(torch, kernels, k1314,
                                          profile=profile)
    torch.cuda.empty_cache()
    counts_moe, stats_moe = moe_train(torch, kernels, profile=profile)
    stats_moe["grad_check"] = moe_check
    paths = {"generate_paged bf16": counts,
             "generate_paged int8": counts_int8,
             "generate_paged spec bf16": counts_spec,
             "generate_paged spec int8": counts_int8_spec,
             **{f"batcher {label}": stats_batcher[label]["launches"]
                for label, _ in BATCHER_PLANS},
             **{f"batcher int8 {label}": stats_batcher_int8[label]["launches"]
                for label, _ in BATCHER_PLANS},
             **{f"batcher spec {label}":
                stats_batcher[label]["spec"]["launches"]
                for label, _ in BATCHER_PLANS},
             **{f"batcher int8 spec {label}":
                stats_batcher_int8[label]["spec"]["launches"]
                for label, _ in BATCHER_PLANS},
             "train": counts_train, "moe train": counts_moe,
             **counts_quant,
             "grad check split, mask": counts_grad_split, "sft": counts_sft}
    counter = {"flash_attention_fwd": "flash_attention",
               "flash_attention_fwd_train": "flash_attention",
               "norm_matmul": "fused_norm_matmul",
               "norm_matmul_int8": "fused_norm_matmul",
               "rope_append_attend_decode": "fused_rope_attend",
               "rope_append_attend_decode_int8": "fused_rope_attend",
               "quant_matmul": "quant_matmul",
               "ragged_paged_attention": "ragged_paged_attention",
               "rope_append_attend_ragged": "fused_rope_attend_ragged",
               "paged_attention": "paged_attention",
               "rope_append_attend_masked": "fused_rope_attend",
               "ragged_paged_attention_int8": "ragged_paged_attention",
               "rope_append_attend_ragged_int8": "fused_rope_attend_ragged",
               "paged_attention_int8": "paged_attention",
               "rope_append_attend_masked_int8": "fused_rope_attend",
               "ragged_paged_attention_verify": "ragged_paged_attention",
               "ragged_paged_attention_int8_verify": "ragged_paged_attention",
               "rope_append_attend_ragged_verify": "fused_rope_attend_ragged",
               "rope_append_attend_ragged_int8_verify":
                   "fused_rope_attend_ragged",
               "flash_attention_bwd": "flash_attention_bwd",
               "rms_norm_fwd": "rms_norm_fwd",
               "rms_norm_bwd": "rms_norm_bwd",
               "adamw8bit": "adamw8bit",
               "grouped_matmul": "grouped_matmul",
               "grouped_matmul_down": "grouped_matmul",
               "grouped_matmul_dx": "grouped_matmul",
               "grouped_matmul_int8": "grouped_matmul_quant",
               "grouped_matmul_int4": "grouped_matmul_quant",
               "segment_dw": "segment_dw", "segment_dw_down": "segment_dw",
               "flash_attention_fwd_bias": "flash_attention",
               "flash_attention_bwd_bias": "flash_attention_bwd",
               "flash_attention_bwd_fused": "flash_attention_bwd_fused",
               **{f"{n}_h{hh}": "fused_rope" for n in ("fused_rope",
                                                        "fused_rope_bwd")
                  for hh in (32, 8)}}
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
                    for k, v in stats_batcher.items())
        + ", int8w+int8kv batcher "
        + ", ".join(f"{k} {v['max_memory_allocated_gib']:.2f} GiB"
                    for k, v in stats_batcher_int8.items()))
    for label, _ in BATCHER_PLANS:
        a, b_ = stats_batcher[label], stats_batcher_int8[label]
        log(f"batcher {label}, int8w+int8kv against bf16 (this run): wall "
            f"{b_['wall_s']:.3f} against {a['wall_s']:.3f} s, "
            f"{b_['generated_tok_s']:.1f} against {a['generated_tok_s']:.1f} "
            f"generated tok/s, peak {b_['max_memory_allocated_gib']:.2f} "
            f"against {a['max_memory_allocated_gib']:.2f} GiB")
        for kind, st in (("bf16", a), ("int8w+int8kv", b_)):
            sp = st["spec"]
            log(f"batcher {label} {kind}, spec (replay draft) against plain "
                f"(this run): wall {sp['wall_s']:.3f} against "
                f"{st['wall_s']:.3f} s, {sp['ragged_steps']} waves against "
                f"{st['ragged_steps']} waves + {st['decode_steps']} segment "
                f"steps, tokens_per_target_step "
                f"{sp['tokens_per_target_step']:.3f} (NGramDraft "
                f"{sp['ngram']['tokens_per_target_step']:.3f})")

    log(f"max_memory_allocated while training: Llama "
        f"{stats_train['max_memory_allocated_gib']:.2f} GiB, fine-tuning "
        f"{stats_sft['max_memory_allocated_gib']:.2f} GiB, MoE "
        f"{stats_moe['max_memory_allocated_gib']:.2f} GiB")

    # ---- 13. result
    log(json.dumps({"serving": stats, "serving_int8w_int8kv": stats_int8,
                    "serving_batcher": stats_batcher,
                    "serving_batcher_int8w_int8kv": stats_batcher_int8,
                    "train": stats_train, "sft": stats_sft,
                    "moe_train": stats_moe,
                    "moe_quantized_experts": stats_quant}))
    log(json.dumps({"kernels": rows}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
