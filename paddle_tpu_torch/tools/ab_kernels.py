#!/usr/bin/env python3
"""Time K2, K3, K4, K7, K10, K11, K12, K13 and K14 of two checkouts of the
port on one card, in turns.

    python3 paddle_tpu_torch/tools/ab_kernels.py OLD_TREE NEW_TREE [--rounds R]
    python3 paddle_tpu_torch/tools/ab_kernels.py OLD_TREE NEW_TREE --walk [--rounds R]
    python3 paddle_tpu_torch/tools/ab_kernels.py OLD_TREE NEW_TREE --ragged [--rounds R]
    python3 paddle_tpu_torch/tools/ab_kernels.py OLD_TREE NEW_TREE --batcher [--rounds R]
    python3 paddle_tpu_torch/tools/ab_kernels.py OLD_TREE NEW_TREE --decode [--rounds R]
    python3 paddle_tpu_torch/tools/ab_kernels.py OLD_TREE NEW_TREE --quant [--rounds R]
    python3 paddle_tpu_torch/tools/ab_kernels.py OLD_TREE NEW_TREE --rope [--rounds R]

Each tree is the root of a checkout (the directory that holds
``paddle_tpu_torch/``), e.g. the parent commit unpacked with ``git
archive`` into a git-ignored directory, and ``.``. One child process runs
per (tree, turn), in the order old, new, new, old for each round: the
child puts its tree first on ``sys.path``, builds that tree's kernels
into the tree's own ``build/`` and times, on the same seeded inputs,

  * K2's dense path (``fused_norm_matmul_pure``) at ``chip_smoke.py``'s
    phase-3 shapes: M = 8 (the decode body) at N = 1024 (k/v), 4096 (q),
    14336 (gate/up) and 128256 (the LM head), and the tiled path at M =
    264 (a batcher wave), 1024 (a solo prefill) and 8192 (a train step)
    against N = 1024, 4096 and 14336, K = 4096; and the host time of one
    K2 call at M = 264 and at M = 8 (N = 1024 and 14336), and of one K4
    call at M = 8 (down_proj) (``host_us``: the wrapper, the tensor-map
    encodes and the launches, enqueued behind a spin kernel: the median
    of 5 means of 100 calls);
  * the weight-only forms of decode (M = 8): K2 int8 at the four K2
    widths, K4 int8 at o_proj and down_proj and int4 group 128 at
    down_proj; and the int8 (per channel) forms at the int8 prefill's
    shapes, M = 1024: K4 (``quant_matmul_qw``) for o_proj and down_proj,
    K2 (``fused_norm_matmul_pure`` on a ``QuantizedWeight``) for gate/up,
    q and k/v; and K4's group-wise forms, int8 and int4 group 128, at
    down_proj, M = 1024;
  * K13 (forward 4096 -> 14336 and 14336 -> 4096, and the dX form), its
    int8/int4 forms (``gmm_quant``, per channel and group 128, both
    weight shapes, the experts quantized on the card) and K14 (both
    weight shapes, bf16 out) at phase 10's: T = 16,384 rows split over 8
    experts as ``MOE_COUNTS`` below;
  * K7 (``rms_norm_bwd``) at the train step's final norm, 8192 x 4096;
  * K12 (rope) at the train step's q and k, (4, 2048, 32, 128) and (4,
    2048, 8, 128) bf16: the forward (``rope_fwd``), the backward as
    ``fused_rope``'s autograd runs it (a tree whose backward builds the
    swapped table in plain ops pays for them here), and the backward's
    kernel alone (the transposed instance; in a tree without one, K12 on
    a table built beforehand);
  * the page-walk kernels at phase 3's shapes (B = 8, 32/8 heads): K3's
    decode form at the first decode step (bf16 cache, page 16, lengths
    128) and on the int8 cache (page 32, lengths 120-159), K3's masked form
    and K10 at a batcher segment step (page 16, 40 pages a slot, lengths
    ``chip_smoke.WAVE_SEQ`` (+ 1), one slot idle), and the host time of
    one K3 decode call and one K10 call (``host_us``); ``--walk`` times
    these alone;
  * the ragged forms, K11 and K3's ragged form, on ``chip_smoke.py``'s two
    ragged waves (``RAGGED_WAVES``: T = 264, B = 8, 32/8 heads, page 16;
    the mixed wave, and a 256-row chunk on 256 cells of context with
    seven decode rows) and on the same waves over an int8 cache (page
    32), built by this tool's own checkout's ``chip_smoke.batcher_wave``
    so that both trees get the same waves, and the host time of one call
    of each on the first bf16 wave;
    ``--ragged`` times these alone;

each the median device ms of 20 calls with the L2 flushed before each and
a spin kernel holding the stream while the host enqueues (as
``chip_smoke.py``'s ColdTimer). With ``--batcher`` each turn instead
serves ``chip_smoke.py``'s phase-6 requests through the continuous batcher
(Llama-3-8B, random bf16 weights, fused and unfused attention) and reads
the untraced wall seconds of each plan (median of 3 runs after a
warm-up). With ``--quant`` each turn times only what the tiled
quantized body and K7 touch: K2's dense tiled path (M = 264, 1024, 8192),
the weight-only forms above, K13's int8/int4 forms and K7. With
``--decode`` each turn runs phases 4 and 5's solo serving
(Llama-3-8B, B = 8, prompt 128, 32 new tokens; bf16, then the model
quantized to int8 weights with an int8 cache at page 32) and reads the
untraced decode ms per step: the median of 3 full rollouts less the
median of 3 prefills, over the 31 steps. With ``--rope`` each turn times
K12 as above, then the paths that rope q and k: ``chip_smoke.py``'s
phase-9 Llama train step (8 layers, B = 4, S = 2048; the median of 3
steps after a warm-up) and phase 4's bf16 prefill (32 layers, B = 8,
prompt 128: ``generate_paged(max_new_tokens=1)``, the median of 5 after a
warm-up), with each one's kernel launches by counter and the device
kernels and their device ms in one torch.profiler trace of it. It prints
one JSON line per turn, then a summary line: each key's median over the
turns of each tree, and new over old. Needs one CUDA card and the CUDA toolkit.
"""

from __future__ import annotations

import itertools
import json
import os
import statistics
import subprocess
import sys
import time

#: rows per expert of chip_smoke.py's phase 10 (one empty, one with 30%)
MOE_COUNTS = (1843, 0, 4915, 2011, 1777, 2049, 1901, 1888)
K2_SHAPES = [(8, 4096, n) for n in (1024, 4096, 14336, 128256)] + [
    (m, 4096, n) for m in (264, 1024, 8192) for n in (1024, 4096, 14336)]
#: (M, N) of the K2 calls whose host time is read (K = 4096)
K2_HOST = [(264, 14336), (264, 1024), (8, 14336), (8, 1024)]
GMM_FORMS = [("grouped_matmul", 4096, 14336, False),
             ("grouped_matmul_down", 14336, 4096, False),
             ("grouped_matmul_dx", 14336, 4096, True)]
SDW_FORMS = [("segment_dw", 4096, 14336), ("segment_dw_down", 14336, 4096)]
#: (kernel, M, K, N, weight type, group size) of the weight-only products
#: of decode (M = 8) and of the int8 prefill (M = 1024)
QUANT_SHAPES = [("K2", 8, 4096, n, "int8", -1) for n in (1024, 4096, 14336,
                                                          128256)] + [
    ("K4", 8, 4096, 4096, "int8", -1), ("K4", 8, 14336, 4096, "int8", -1),
    ("K4", 8, 14336, 4096, "int4", 128),
    ("K4", 1024, 4096, 4096, "int8", -1), ("K4", 1024, 14336, 4096, "int8", -1),
    ("K2", 1024, 4096, 14336, "int8", -1), ("K2", 1024, 4096, 4096, "int8", -1),
    ("K2", 1024, 4096, 1024, "int8", -1),
    ("K4", 1024, 14336, 4096, "int8", 128),
    ("K4", 1024, 14336, 4096, "int4", 128)]
#: K13's int8/int4 forms (weight type, group size) at both weight shapes
GMM_QUANT_FORMS = [(wd, gs) for wd in ("int8", "int4") for gs in (-1, 128)]
#: K7's shape: the train step's final norm (B * S rows of the hidden size)
K7_SHAPE = (8192, 4096)
#: the K4 call whose host time is read: decode's down_proj
K4_HOST = (8, 14336, 4096)
#: K12's shapes: the train step's q and k (B, S, heads, head_dim)
K12_SHAPES = [(4, 2048, 32, 128), (4, 2048, 8, 128)]


def _cold_ms(torch, flush, fn, iters=20, warmup=2):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def _host_us(torch, fn, calls=100, reps=5):
    """Host microseconds a call takes to enqueue: the median over ``reps``
    runs of the mean of ``calls`` calls, each run behind a spin kernel
    long enough that the card never drains the queue."""
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        torch.cuda._sleep(50_000_000)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        runs.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(runs)


def child_batcher() -> None:
    import chip_smoke as cs
    import torch
    from paddle_tpu_torch.framework import flags
    from paddle_tpu_torch.inference import ContinuousBatcher
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops.kernels import _build

    _build.build()
    cfg = LlamaConfig.llama3_8b(dtype="bfloat16")
    model = LlamaForCausalLM(cfg, seed=cs.SEED)
    reqs = cs.batcher_requests(cfg.vocab_size)
    out = {}
    for label, fusions in cs.BATCHER_PLANS:
        flags.set_flags({"fused_decode_fusions": fusions})
        walls = []
        for _ in range(4):
            eng = ContinuousBatcher(model, max_batch=cs.BB, max_seq=cs.BSEQ,
                                    page_size=cs.PAGE, segment=16,
                                    prefill_chunk=cs.BCHUNK,
                                    prefix_caching=False)
            for prompt, n_new, t in reqs:
                eng.submit(prompt, max_new_tokens=n_new, arrival_segment=t)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.run()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        out[f"batcher {label} wall_s"] = statistics.median(walls[1:])
    print(json.dumps(out), flush=True)


def child_decode() -> None:
    import chip_smoke as cs
    import torch
    from paddle_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                               quantize_for_inference)
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels.quant_matmul import QuantizedWeight

    _build.build()
    cfg = LlamaConfig.llama3_8b(dtype="bfloat16")
    model = LlamaForCausalLM(cfg, seed=cs.SEED)
    ids = cs.prompt_ids(torch, cfg)

    def step_ms(**kw):
        def run(n_new):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.generate_paged(ids, max_new_tokens=n_new, **kw)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3

        run(cs.NEW)  # warm-up at the full length
        total = statistics.median(run(cs.NEW) for _ in range(cs.ROLLOUTS))
        prefill = statistics.median(run(1) for _ in range(cs.ROLLOUTS))
        return (total - prefill) / (cs.NEW - 1)

    out = {"decode bf16 ms/step": step_ms(page_size=cs.PAGE)}
    qparams = quantize_for_inference(model)   # as phase 5: codes only
    for name, p in model.named_parameters():
        if isinstance(qparams[name], QuantizedWeight):
            p.data = p.data.new_empty(0)
    torch.cuda.empty_cache()
    out["decode int8w+int8kv ms/step"] = step_ms(
        page_size=cs.PAGE_INT8, params=qparams, cache_dtype="int8")
    print(json.dumps(out), flush=True)


def _walk_times(torch, flush):
    """Cold ms of K3's decode forms and K10 at chip_smoke.py's shapes."""
    import chip_smoke as cs
    from paddle_tpu_torch.models import kv_cache
    from paddle_tpu_torch.models.llama import _rope_tables
    from paddle_tpu_torch.ops.kernels import fused_rope_attend as k3
    from paddle_tpu_torch.ops.kernels import paged_attention as k10

    g = torch.Generator(device="cuda").manual_seed(1)
    b, h, hk, d, cap = cs.B, 32, 8, 128, cs.PROMPT + cs.NEW
    out = {}
    for label, page, lens in (
            ("K3 decode bf16 page16", cs.PAGE, [cs.PROMPT] * b),
            ("K3 decode int8 page32", cs.PAGE_INT8,
             [159, 151, 144, 136, 129, 128, 127, 120])):
        int8 = page == cs.PAGE_INT8
        cache = kv_cache.create_paged_cache(
            2, b, cap, hk, d, page, device="cuda",
            dtype=torch.int8 if int8 else torch.bfloat16)
        for pool in (cache.k_pages, cache.v_pages):
            pool.copy_(torch.randint(-127, 128, pool.shape, generator=g,
                                     device="cuda") if int8 else
                       torch.randn(pool.shape, generator=g, device="cuda"))
        if int8:
            for pool in (cache.k_scales, cache.v_scales):
                pool.copy_(torch.rand(pool.shape, generator=g,
                                      device="cuda") * 0.03)
        lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
        cache = cache._replace(seq_lens=lens_t)
        q = torch.randn((b, h, d), generator=g, device="cuda").to(
            torch.bfloat16)
        k, v = (torch.randn((b, hk, d), generator=g, device="cuda").to(
            torch.bfloat16) for _ in "kv")
        cos_t, sin_t = _rope_tables(cap, d, 500000.0, device="cuda")
        cos, sin = cos_t[lens_t.long()], sin_t[lens_t.long()]
        fn = (lambda: k3.fused_rope_append_attend_decode(q, k, v, cos, sin,
                                                          cache, 1))
        out[label] = _cold_ms(torch, flush, fn)
        out[f"{label} host_us"] = _host_us(torch, fn)
    cache, rows, active = cs._segment_step_inputs(torch, kv_cache,
                                                  _rope_tables, cs.SEED + 11)
    out["K3 masked segment step"] = _cold_ms(torch, flush, lambda: (
        k3.fused_rope_append_attend_decode(*rows, cache, 1, active)))
    lens = torch.where(active, cache.seq_lens + 1, 0).to(torch.int32)
    args = (rows[0], cache.k_pages[1], cache.v_pages[1], cache.block_tables,
            lens)
    out["K10 segment step"] = _cold_ms(
        torch, flush, lambda: k10.paged_attention_pure(*args))
    out["K10 segment step host_us"] = _host_us(
        torch, lambda: k10.paged_attention_pure(*args))
    return out


def _ragged_times(torch, flush):
    """Cold ms of K11 and K3's ragged form on chip_smoke.py's ragged
    waves (this tool's checkout's waves, the tree's kernels)."""
    import importlib.util

    from paddle_tpu_torch.models import kv_cache
    from paddle_tpu_torch.models.llama import _rope_tables
    from paddle_tpu_torch.ops.kernels import fused_rope_attend as k3
    from paddle_tpu_torch.ops.kernels import ragged_paged_attention as k11

    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_waves", os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    out = {}
    for int8, (w, wave_spec) in itertools.product(
            (False, True), enumerate(cs.RAGGED_WAVES, 1)):
        cache, rows, wave = cs.batcher_wave(torch, kv_cache, _rope_tables,
                                            cs.SEED + 8, *wave_spec,
                                            int8=int8)
        args = (rows[0], cache.k_pages[1], cache.v_pages[1],
                cache.block_tables, *wave[3:], rows[1], rows[2])
        kw = ({"k_scales": cache.k_scales[1], "v_scales": cache.v_scales[1]}
              if int8 else {})
        forms = (("K11", lambda: k11.ragged_paged_attention_pure(*args,
                                                                 **kw)),
                 ("K3 ragged", lambda: k3.fused_rope_append_attend(
                     *rows, cache, 1, *wave)))
        for label, fn in forms:
            label = f"{label}{' int8' if int8 else ''}"
            out[f"{label} wave{w}"] = _cold_ms(torch, flush, fn)
            if w == 1 and not int8:
                out[f"{label} wave1 host_us"] = _host_us(torch, fn)
    return out


def child_ragged() -> None:
    import torch
    from paddle_tpu_torch.ops.kernels import _build

    _build.build()
    flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    with torch.no_grad():
        print(json.dumps(_ragged_times(torch, flush)), flush=True)


def child_walk() -> None:
    import torch
    from paddle_tpu_torch.ops.kernels import _build

    _build.build()
    flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    with torch.no_grad():
        print(json.dumps(_walk_times(torch, flush)), flush=True)


def _k2_times(torch, flush, rnd, g, shapes):
    from paddle_tpu_torch.ops.kernels import fused_norm_matmul as k2

    out = {}
    for m, kdim, n in shapes:
        x, w = rnd(m, kdim), rnd(kdim, n, scale=kdim ** -0.5)
        nw = (torch.rand((kdim,), generator=g, device="cuda")
              + 0.5).to(torch.bfloat16)
        out[f"K2 M{m} K{kdim} N{n}"] = _cold_ms(
            torch, flush, lambda: k2.fused_norm_matmul_pure(x, nw, 1e-5, w))
        if (m, n) in K2_HOST:
            out[f"K2 host_us M{m} K{kdim} N{n}"] = _host_us(
                torch, lambda: k2.fused_norm_matmul_pure(x, nw, 1e-5, w))
        del x, w
    return out


def _quant_times(torch, flush, rnd, g):
    from paddle_tpu_torch.ops.extra_vision import _weight_quantize_pure
    from paddle_tpu_torch.ops.kernels import fused_norm_matmul as k2
    from paddle_tpu_torch.ops.kernels import quant_matmul as k4

    out = {}
    for kind, m, kdim, n, wd, gs in QUANT_SHAPES:
        x = rnd(m, kdim)
        codes, scales = _weight_quantize_pure(
            rnd(kdim, n, scale=kdim ** -0.5).float(),
            f"weight_only_{wd}", gs)
        qw = k4.QuantizedWeight(codes, scales, wd, gs, (kdim, n))
        nw = (torch.rand((kdim,), generator=g, device="cuda")
              + 0.5).to(torch.bfloat16)
        fn = ((lambda: k4.quant_matmul_qw(x, qw)) if kind == "K4" else
              (lambda: k2.fused_norm_matmul_pure(x, nw, 1e-5, qw)))
        form = wd if gs < 0 else f"{wd} g{gs}"
        out[f"{kind} {form} M{m} K{kdim} N{n}"] = _cold_ms(torch, flush, fn)
        if kind == "K4" and (m, kdim, n) == K4_HOST and gs < 0:
            out[f"K4 host_us M{m} K{kdim} N{n}"] = _host_us(torch, fn)
        del x, qw
    return out


def _grouped_times(torch, flush, rnd, quant_only=False):
    from paddle_tpu_torch.ops.kernels import grouped_matmul as gm

    out = {}
    off = torch.tensor([0, *itertools.accumulate(MOE_COUNTS)],
                       dtype=torch.int32, device="cuda")
    t, e = sum(MOE_COUNTS), len(MOE_COUNTS)
    for name, kdim, n, trans in [] if quant_only else GMM_FORMS:
        x = rnd(t, kdim)
        w = rnd(e, *((n, kdim) if trans else (kdim, n)), scale=0.02)
        out[f"K13 {name}"] = _cold_ms(
            torch, flush, lambda: gm.gmm(x, off, w, trans_w=trans))
        del x, w
    for name, kdim, n, trans in GMM_FORMS:
        if trans:
            continue
        x = rnd(t, kdim)
        for wd, gs in GMM_QUANT_FORMS:
            codes, scales = gm.quantize_grouped_weight(
                rnd(e, kdim, n, scale=kdim ** -0.5).float(),
                f"weight_only_{wd}", gs)
            form = wd if gs < 0 else f"{wd} g{gs}"
            out[f"K13 {name} {form}"] = _cold_ms(
                torch, flush, lambda: gm.gmm_quant(x, off, codes, scales,
                                                   wd, gs))
            del codes, scales
        del x
    for name, kdim, n in [] if quant_only else SDW_FORMS:
        x, dy = rnd(t, kdim), rnd(t, n)
        out[f"K14 {name}"] = _cold_ms(
            torch, flush, lambda: gm.segment_dw(
                x, dy, off, e, out_dtype=torch.bfloat16))
        del x, dy
    return out


def _k7_times(torch, flush, rnd, g):
    from paddle_tpu_torch.ops.kernels import fused_norm_rope as k67

    n, h = K7_SHAPE
    x, dy = rnd(n, h), rnd(n, h)
    w = (torch.rand((h,), generator=g, device="cuda") + 0.5).to(
        torch.bfloat16)
    _, rstd = k67.rms_norm_fwd(x, w, 1e-5)
    return {f"K7 N{n} H{h}": _cold_ms(
        torch, flush, lambda: k67.rms_norm_bwd(x, w, rstd, dy))}


def _k12_times(torch, flush, rnd):
    import inspect

    from paddle_tpu_torch.models.llama import _rope_tables
    from paddle_tpu_torch.ops.kernels import fused_norm_rope as k67

    transposed = "transpose" in inspect.signature(k67.rope_fwd).parameters
    out = {}
    for shape in K12_SHAPES:
        x, g = rnd(*shape), rnd(*shape)
        cos, sin = _rope_tables(shape[1], shape[3], 500000.0, device="cuda")
        out[f"K12 fwd {shape}"] = _cold_ms(
            torch, flush, lambda: k67.rope_fwd(x, cos, sin))
        with torch.enable_grad():
            xg = x.clone().requires_grad_(True)
            y = k67.fused_rope(xg, cos, sin)
            out[f"K12 bwd (autograd) {shape}"] = _cold_ms(
                torch, flush, lambda: torch.autograd.grad(y, xg, g,
                                                          retain_graph=True))
        if transposed:
            fn = (lambda: k67.rope_fwd(g, cos, sin, transpose=True))
        else:
            table = k67.rope_bwd_table(sin).contiguous()
            fn = (lambda: k67.rope_fwd(g, cos, table))
        out[f"K12 bwd kernel {shape}"] = _cold_ms(torch, flush, fn)
        del x, g, xg, y
    return out


def _device_kernels(torch, fn):
    """(device events, their device ms) in a torch.profiler trace of
    ``fn()``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return len(ev), sum(e.time_range.end - e.time_range.start
                        for e in ev) / 1e3


def child_rope() -> None:
    import chip_smoke as cs
    import torch
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.optimizer import AdamW8bit

    _build.build()
    flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(
            torch.bfloat16)

    with torch.no_grad():
        out = _k12_times(torch, flush, rnd)
    del flush

    def walls(label, fn, n):
        fn()                                     # warm-up
        times = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        kernels.reset_launch_counts()
        fn()
        out.update({f"{label} launches {k}": v
                    for k, v in kernels.launch_counts().items()})
        n_dev, dev_ms = _device_kernels(torch, fn)
        out.update({f"{label} ms": statistics.median(times),
                    f"{label} device kernels": n_dev,
                    f"{label} device ms": dev_ms})

    cfg = cs.train_config(cs.TRAIN_LAYERS)
    model = LlamaForCausalLM(cfg, seed=cs.SEED)
    step = TrainStep(model, lambda o, lb: model.loss(o, lb),
                     AdamW8bit(learning_rate=1e-4,
                               parameters=model.parameters()))
    ids = torch.randint(0, cfg.vocab_size, (cs.TB, cs.TS), generator=g,
                        device="cuda")
    walls("train step", lambda: step(ids, ids), 3)
    del step, model
    torch.cuda.empty_cache()
    model = LlamaForCausalLM(LlamaConfig.llama3_8b(dtype="bfloat16"),
                             seed=cs.SEED)
    pids = cs.prompt_ids(torch, model.config)
    walls("prefill bf16", lambda: model.generate_paged(
        pids, max_new_tokens=1, page_size=cs.PAGE), 5)
    print(json.dumps(out), flush=True)


def child(quant_only=False) -> None:
    import torch
    from paddle_tpu_torch.ops.kernels import _build

    _build.build()
    flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda")
                * scale).to(torch.bfloat16)

    out = {}
    with torch.no_grad():
        out.update(_k2_times(torch, flush, rnd, g, [
            s for s in K2_SHAPES if not quant_only or s[0] > 16]))
        out.update(_quant_times(torch, flush, rnd, g))
        out.update(_grouped_times(torch, flush, rnd, quant_only))
        out.update(_k7_times(torch, flush, rnd, g))
        if not quant_only:
            out.update(_k12_times(torch, flush, rnd))
            out.update(_walk_times(torch, flush))
            out.update(_ragged_times(torch, flush))
    print(json.dumps(out), flush=True)


def main() -> int:
    args = sys.argv[1:]
    if args[:1] == ["--child"]:
        if "--batcher" in args:
            child_batcher()
        elif "--walk" in args:
            child_walk()
        elif "--ragged" in args:
            child_ragged()
        elif "--decode" in args:
            child_decode()
        elif "--rope" in args:
            child_rope()
        else:
            child(quant_only="--quant" in args)
        return 0
    rounds = 1
    if "--rounds" in args:
        i = args.index("--rounds")
        rounds = int(args[i + 1])
        del args[i:i + 2]
    modes = ("--batcher", "--decode", "--walk", "--ragged", "--quant",
             "--rope")
    mode = [a for a in args if a in modes]
    args = [a for a in args if a not in modes]
    old, new = (os.path.abspath(a) for a in args)
    runs = {old: [], new: []}
    for _ in range(rounds):
        for tree in (old, new, new, old):
            env = {**os.environ, "PYTHONPATH": tree}
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child", *mode],
                cwd=tree, env=env, capture_output=True, text=True,
                check=True)
            got = json.loads(res.stdout.strip().splitlines()[-1])
            runs[tree].append(got)
            print(json.dumps({"tree": tree, "ms": got}), flush=True)
    summary = {}
    for key in runs[old][0]:
        a = statistics.median(r[key] for r in runs[old])
        b = statistics.median(r[key] for r in runs[new])
        summary[key] = {"old_ms": a, "new_ms": b,
                        "new_over_old": b / a if a else None}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
