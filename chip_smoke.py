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
               Last, the "batcher prefix" rows: K11, K3's ragged form
               (the mixed wave), K10 and K3's masked form (the segment
               step), bf16 and int8, on the prefix cache's table-routed
               pool (``route_table``: a seeded permutation of B * pps +
               pps + 1 pages, two slots sharing their first 224 tokens of
               pages, the idle slot's row all park page, each row's tail
               its own last page, an unreferenced page full of NaN), with
               every check above plus: outputs finite, the park page and
               the shared pages bitwise unchanged. Then K13 at the LoRA
               delta's shapes (``check_grouped_matmul_lora``: the shrink
               (T, 4096 | 14336) x (9, ·, 16) and the expand (T, 16) x
               (9, 16, 1024 | 4096 | 14336), T 264 and 8, three adapters'
               rows + the base group's): within the tolerance of the plain
               version, two calls bitwise equal, a moved-row control that
               must fail, host us a call, ``torch._grouped_mm`` timed.
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
4d. sampling, solo (after phase 4, on its model and prompts) —
               ``generate_paged(temperature=0.8, top_k=50, top_p=0.95)``:
               ``top_p=0`` bitwise phase 4's tokens, ``top_k=1`` too up to
               each row's first position whose bf16 logits tie at the
               maximum; the counted sampled run's launches equal phase 4's
               plan; every drawn token in the kept set of its own returned
               logits; the same seed twice the same tokens; the medians of
               3 sampled rollouts and prefills beside phase 4's, and one
               step's filter and draw timed alone.
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
6e. serving, sampled continuous batching — after phase 6's checks, in
               each plan, the same 24 requests at the sampling of 4d: the
               counted run's waves, segment steps, launches and
               ``host_sync_count`` equal to the greedy run's, every
               request "ok" with its tokens; fused: a second run with the
               same seed gives the same tokens; walls.
6f. serving, multi-LoRA continuous batching — after 6 and 6b, fused: the
               same 24 requests through four seeded adapters (ranks 16,
               8, 16, 4; 6 base requests) on ``lora=True,
               lora_max_rank=16, lora_hbm_adapters=2``: launches equal to
               the plan + 448 K13 a wave and a step, every request "ok",
               adapter loads, hits, evictions and deferrals > 0, every
               emitted token held to phase 6's rule against its adapter's
               f32 forward (``merge_lora``'s weights; int8 the quantized
               function with the delta in f32), whose two controls (the
               request routed to the base group, the adapter's B halved)
               must fail; the wall beside phase 6's.
6d. serving with the reference's defaults — the phase-6 model (a new
               instance) through ``ContinuousBatcher(max_batch=8,
               max_seq=640, page_size=16, segment=16, prefill_chunk=256,
               page_pool_pages=120)`` and nothing else set: the prefix
               cache, the host KV tier and the unified arena on; 24
               requests sharing a 256-token system prompt, repeating
               whole prompts, or unrelated (``prefix_requests``); the
               counted run parks a decoding request from ``_on_tick``
               and resumes it in a second ``run()``: launches equal to
               the batcher's plan over both runs' waves and steps, every
               request "ok" with its max_new_tokens, prefix hits, pages
               saved, COW clones, demotions, promotions, recompute
               avoided, parks and resumes all > 0, the resume admitting
               one token, both allocators' ``check()``, every emitted
               token held to phase 6's rule (int8: ``chunk_map`` knows a
               matched prefix and a resumed token). bf16 in both plans,
               int8w+int8kv (page 32, 60 pages) fused. Printed: walls and
               tok/s with the cache on and with ``prefix_caching=False``
               on the same requests, in turns (3 each for bf16 fused,
               once otherwise), the stall ms, peak memory, pinned bytes.
6g. the serving fleet — the phase-6 model (a new instance), bf16 fused:
               two ``ContinuousBatcher`` replicas over one copy of the
               weights (``make_fleet``, phase 6d's settings, a MemoryStore
               registry at the reference's 0.5 s heartbeat and 2.0 s
               lease TTL, ``FleetRouter(affinity=True)``), their serve
               threads launching on the card at once, on phase 6d's 24
               requests. Failover: replica 1 killed once one of its
               requests streamed 3 tokens; all 24 "ok", one failover, at
               least one request recovered, every token held to phase
               6's rule, the survivor's allocators' ``check()``.
               Disaggregated: roles prefill/decode,
               ``KVMigrator("chunked")``: every request prefills on
               replica 0 and decodes on replica 1, bytes moved = pages x
               page bytes, one admitted token a resume, every token held
               to the rule. Controls (a third run of 3 requests): a K
               page zeroed in transit must fail the rule; ``kv.migrate``
               armed once leaves its request decoding at the source, "ok"
               within the rule. Each run's K2/K3 launches equal the plan
               over every replica's own waves and segment steps (the
               killed one's up to the kill). Printed: both walls and
               tok/s, phase 6d's single engine on the same requests in
               turns, kill -> first recovered token ms, migration ms and
               MB a request, lease expiries, peak memory, pinned bytes.
6h. the autoscaled fleet — 6g's model, bf16 fused, phase 6d's settings,
               a MemoryStore registry, ``FleetRouter(affinity=True)`` and
               ``FleetAutoscaler(min_replicas=1, max_replicas=2)`` (cooldown
               0.5 s, streak 3). The single engine serves the trace's 48
               requests at once: its requests/s R sets the base rate to
               0.4 R. ``loadgen.run_trace`` replays a ``TraceSpec`` at
               Llama-3-8B widths (vocab 128256; prompts lognormal mean 96,
               16-384; 8-64 new tokens, mean 24; 8 tenants, Zipf 1.2, a
               64-token tenant prefix; three deadline tiers; a 5x burst at
               0.3-0.6 of a 15 s horizon) against one replica; then two
               192-token tail streams, one a replica, and the floor comes
               down. Asserts a scale-up, a brownout level entered and the
               ladder back at 0, a scale-down whose evacuated streams all
               resumed (survivor resumes = evacuations >= 1, one admitted
               token each), no ``replica_lost``, no lease expiry, sheds in
               the lowest tier only, every "ok" request's tokens within
               phase 6's rule, K2/K3 launches equal to the plan over every
               replica's waves and segment steps (spawned and retired
               included), the surviving allocators' ``check()``. Printed:
               wall and tok/s, per-tier p50/p99 TTFT and inter-token ms,
               the scale and brownout events with their times, replicas
               over time, peak memory, pinned bytes, the single engine's
               wall in turns.
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
7b. quantized weights under autograd — one Llama-3-8B decoder layer +
               the final norm and LM head in ``quantize_for_inference``
               form (int8 per channel, int4 group 128) at B=4 x S=2048:
               forward + backward of a seeded cotangent on the logits
               through ``run_train_decoder_layer`` / ``run_train_lm_head``
               (K6 + K4s for the q/k/v and gate/up groups, K4 for the o-
               and down-proj, K2's quantized form for the head; the
               weight-only rule backward). dh, the logits and the norm
               weights' gradients against a plain f32 chain over the
               dequantized weights within phase 8's rule; a backward that
               reads every scale 16 columns on must fail it; the forward
               bitwise the no-grad call's; launches equal
               ``fusion.quantized_train_launches(1)``. Times K2's int8 and
               int4 g128 forms at M 8192 for N 4096 / 14336 / 128256
               beside dense K2 and the bound, K4 at M 8192, the backward's
               dequant + matmul; each quantized form beside its plain
               version and the library's dequant + ``torch.matmul``.
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
9c. data parallelism and ZeRO — K8's shard form at gate_proj (2 and 4
               ranks' block cuts, and a 2-block norm weight over 4
               ranks: bitwise the whole-tensor launch, a moved shard map
               must differ; timed), then the 2-layer full-width model of
               phase 8 (phase 9's recipe) in children started through
               ``paddle_tpu_torch.distributed.launch`` (``chip_smoke.py
               --dp-child a|b <dir>``): 9c-a, one rank over NCCL, the
               plain ``TrainStep`` then ``DataParallel``, ``os``,
               ``os_g``, ``p_g_os``, each step-1 loss, parameters,
               masters and codes bitwise the plain step's and launches =
               the plan (one K8 a non-empty shard); 9c-b, two ranks on the
               card over gloo (``--devices 0,0``), phase 8's masked B=2
               batch a row a rank: the reduced gradients within phase 8's
               rule against rank 0's plain f32 run of the global batch
               (a local-means and a dropped-bucket reducer must fail it),
               the sharded steps' gathered parameters, codes and scales
               bitwise rank 0's unsharded K8 step (a moved shard map must
               fail it), ``os_g``'s optimizer state <= 0.55 x
               ``DataParallel``'s; each rank's step ms, exposed flush ms,
               peak memory and state bytes printed.
9d. tensor and sequence parallelism — K1 and K5 at mp 2's per-rank
               shape (B=1, S=2048, 16/4 heads, D=128) against their plain
               versions, SDPA and its backward timed beside them; then
               phase 8's 2-layer full-width model (phase 9's recipe, the
               train fusions off as the JAX package turns them off under
               TP) in children of ``paddle_tpu_torch.distributed.launch``
               (``chip_smoke.py --tp-child a|b <dir>``): 9d-a, one rank
               over NCCL, ``apply_llama_tensor_parallel`` at mp 1: the
               step-1 loss, gradients and parameters (AdamW) bitwise the
               plain ``TrainStep`` of the unfused plan, launches = that
               plan; 9d-b, two ranks on the card over gloo (``--devices
               0,0``, ``collective_matmul`` off: gloo carries no CUDA
               point-to-point transfer, and the ring is shown to refuse),
               mp 2 with SP off and on on phase 8's B=1 batch: the
               per-token losses and every gathered gradient within phase
               8's rule against rank 0's plain f32 run of the unsharded
               model, which two controls (layer 0's o_proj all-reduce
               skipped; SP's norm-gradient all-reduce hooks removed) must
               fail; launches = the plan at 16/4 heads; then an AdamW8bit
               step (K8 on every local shard, loss finite) and a timed
               one: step ms, exposed collective ms, peak memory and
               parameter bytes (about half a DataParallel rank's) each
               rank.
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
import gc
import itertools
import json
import math
import re
import statistics
import subprocess
import sys
import time
from types import SimpleNamespace

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
# the "batcher prefix" rows of phase 3 (the batcher's table-routed pool):
# the mixed wave on a pool of B * pps + pps + 1 pages whose table is a
# seeded permutation, slots ROUTED_SHARE reading the same first
# ROUTED_SHARED_TOKENS of pages, the idle slot's row all park page (the
# pool's last), each row's tail repeating its own last page, and the page
# before the park page, referenced by no row, full of NaN (a scrubbed
# neighbour that must not leak)
ROUTED_SHARE = (4, 6)
ROUTED_SHARED_TOKENS = 224
# sampling (phases 4d and 6e): temperature, top_k, top_p
SAMPLING = (0.8, 50, 0.95)
# multi-LoRA (phases 3 and 6f): the pool's rank and, for phase 3, its
# default 8 slots + the base group; phase 6f's four adapters' ranks, its
# device slots, and the adapter of each of phase 6's 24 requests (6 base,
# 18 over the four; interleaved so that admission loads, evicts, defers
# and reorders)
LORA_RANK = 16
LORA_G = 9
LORA_RANKS = (16, 8, 16, 4)
LORA_SLOTS = 2
LORA_OF_REQUEST = (0, 1, None, 2, 0, 3, 1, None, 2, 3, 0, None, 1, 2, None,
                   3, 0, 1, None, 2, 3, None, 0, 1)


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
                 chunks=WAVE_CHUNK, idle=WAVE_IDLE, int8=False,
                 routed=False):
    """The kernels phase's mixed wave at the batcher's shapes: a 2-layer
    bf16 cache (B=8, Hk=8, page 16, 40 pages per slot) of random K/V at
    the old lengths ``seqs`` (``int8``: an int8 cache at page 32, 20 pages
    per slot, every cell random K/V quantized on write); the wave's rows
    (q (T, 32, 128), k, v (T, 8, 128), cos/sin (T, 128) at each row's
    position) and its layout (row_slot, row_pos, valid, page_lens, q_start,
    q_lens, fresh_lens) as ContinuousBatcher._build_ragged_step lays a wave
    out: slot i prefills ``chunks[i]`` rows, or decodes one row unless it
    is ``idle``. ``routed``: the prefix cache's table-routed pool
    (``route_table``)."""
    b, h, hk, d = BB, 32, 8, 128
    g = torch.Generator(device="cuda").manual_seed(seed)
    page = PAGE_INT8 if int8 else PAGE
    cache = kv_cache.create_paged_cache(
        2, b, BSEQ, hk, d, page,
        dtype=torch.int8 if int8 else torch.bfloat16,
        extra_pages=-(-BSEQ // page) + 1 if routed else 0, device="cuda")
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
    if routed:
        cache = route_table(torch, cache, seqs, chunks, idle, seed)
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


def route_table(torch, cache, seqs, chunks, idle, seed):
    """The batcher's table-routed layout over ``cache``'s pool of B * pps
    + pps + 1 pages: every slot's pages drawn from a seeded permutation of
    the allocator's pages, slots ROUTED_SHARE reading the same pages for
    their first ROUTED_SHARED_TOKENS, each row's entries past the slot's
    pages repeating its own last page, the ``idle`` slot's row (an empty
    slot) all park page, and the NaN page (``routed_pages``), which no row
    references, full of NaN (int8: its scales)."""
    import numpy as np

    b, pps = cache.block_tables.shape
    page = cache.k_pages.shape[3]
    park, nan_page, _ = routed_pages(cache)
    free = list(np.random.default_rng(seed).permutation(nan_page))
    n_shared = ROUTED_SHARED_TOKENS // page
    shared = [free.pop() for _ in range(n_shared)]
    bt = np.full((b, pps), park, np.int32)
    for i, (seq, chunk) in enumerate(zip(seqs, chunks)):
        if i == idle:
            continue
        n = min(pps, -(-(seq + chunk + 1) // page) + 1)
        own = [free.pop() for _ in range(n)]
        if i in ROUTED_SHARE:
            assert seq >= n_shared * page, (i, seq)
            own[:n_shared] = shared
        bt[i, :n] = own
        bt[i, n:] = own[-1]
    cache.block_tables.copy_(torch.from_numpy(bt))
    poison = cache.k_scales if cache.quantized else cache.k_pages
    poison[:, :, nan_page] = float("nan")
    return cache


def routed_pages(cache):
    """(park page, NaN page, the pages slots ROUTED_SHARE share) of a
    routed cache."""
    p_total, page = cache.k_pages.shape[2], cache.k_pages.shape[3]
    n_shared = ROUTED_SHARED_TOKENS // page
    shared = cache.block_tables[ROUTED_SHARE[0], :n_shared].tolist()
    return p_total - 1, p_total - 2, shared


def _routed_checks(torch, label, out, before, after):
    """The routed pool's checks: the output finite (the NaN page leaks
    nowhere), and the park page and the shared pages bitwise as they were
    (no write reaches them)."""
    park, _, shared = routed_pages(before)
    assert bool(torch.isfinite(out.float()).all()), \
        f"{label}: a non-finite output (the NaN page leaked)"
    names = ("k_pages", "v_pages") + (("k_scales", "v_scales")
                                      if before.quantized else ())
    for name in names:
        a, o = getattr(after, name), getattr(before, name)
        for pg in [park] + shared:
            assert torch.equal(a[:, :, pg], o[:, :, pg]), \
                f"{label}: {name} page {pg} (park or shared) changed"
    return (f"routed: park page {park} and shared pages {shared} bitwise "
            f"unchanged, NaN page unread")


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
    bits = {torch.bfloat16: torch.int16, torch.float32: torch.int32,
            torch.int8: torch.int8}
    for name in names:
        # bit patterns: a NaN page compares equal to itself
        a, b_, o = (getattr(c, name).view(bits[getattr(c, name).dtype])
                    for c in (new, ref, old))
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


def _k11_wave(torch, timer, k11, kv_cache, rope_tables, seed, spec, int8,
              routed=False):
    """K11 on one wave (layer 1's pools; q, fresh K/V random): checks,
    plan and times; ``routed``: on the table-routed pool."""
    cache, (q, kf, vf, _, _), wave = batcher_wave(
        torch, kv_cache, rope_tables, seed, *spec, int8=int8, routed=routed)
    before = _pool_copy(cache) if routed else None
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
    form = ("K11 int8" if int8 else "K11") + (" routed" if routed else "")
    assert worst <= 1, f"{form} ({name}) worst err/tol {worst:.3f}"
    assert not out[wave[0] < 0].any(), \
        f"{form} ({name}): a padding row is not zero"
    if routed:
        name += "; " + _routed_checks(torch, form, out, before, cache)
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
                    int8, routed=False):
    """K3's ragged form on one wave: output, the written cells against the
    plain chain (bf16: bit for bit; int8: codes within 1, scales bit for
    bit), every other cell untouched; plan and times."""
    from paddle_tpu_torch.models.llama import apply_rotary_rows
    from paddle_tpu_torch.ops.kernels import ragged_paged_attention as k11

    cache, rows, wave = batcher_wave(torch, kv_cache, rope_tables, seed,
                                     *spec, int8=int8, routed=routed)
    layer = 1
    ck, cp = _pool_copy(cache), _pool_copy(cache)
    out, ck = k3.fused_rope_append_attend(*rows, ck, layer, *wave)
    routed_note = (_routed_checks(torch, "K3 ragged routed", out, cache, ck)
                   if routed else None)
    ref, cp = k3.ragged_reference(*rows, cp, layer, *wave, plain=True)
    q, k, v, cos, sin = rows
    ca = _pool_copy(cache, v=cache.v_pages.abs())
    abs_ref, _ = k3.ragged_reference(q, k, v.abs(), cos, sin, ca, layer,
                                     *wave, plain=True)
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    worst = (diff / attention_tolerance(ref, abs_ref)).max().item()
    name = _wave_name(*spec)
    form = ("K3 ragged int8" if int8 else "K3 ragged") + (
        " routed" if routed else "")
    if routed:
        name += "; " + routed_note
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


def check_ragged_prefix(torch, timer, mod, kv_cache, rope_tables, int8):
    """Phase 3's "batcher prefix" row of K11 (``mod`` the ragged attention
    module) or K3's ragged form (the fused rope-attend module): the mixed
    wave on the table-routed pool (``route_table``)."""
    k11_form = hasattr(mod, "ragged_paged_attention_pure")
    wave = (_k11_wave if k11_form else _k3_ragged_wave)
    res = wave(torch, timer, mod, kv_cache, rope_tables,
               SEED + 30 + 100 * int8 + 10 * k11_form, RAGGED_WAVES[0], int8,
               routed=True)
    name, src, tpu = (
        ("ragged_paged_attention", "ragged_paged_attention.cu",
         "ragged_paged_attention.py:244") if k11_form else
        ("rope_append_attend_ragged", "rope_append_attend.cu",
         "fused_rope_attend.py:441"))
    return {"name": name + ("_int8" if int8 else "") + "_prefix",
            "route": "cuda", "source": f"paddle_tpu_torch/csrc/{src}",
            "replaces": f"paddle_tpu/ops/pallas/{tpu}", **res}


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


def _segment_step_inputs(torch, kv_cache, rope_tables, seed, int8=False,
                         routed=False):
    """A segment step's decode rows at the batcher's shapes: the mixed
    wave's cache (``int8``: its int8 form) at old lengths WAVE_SEQ, q (8,
    32, 128), k/v (8, 8, 128), cos/sin at each slot's position, every slot
    active but WAVE_IDLE."""
    cache, _, _ = batcher_wave(torch, kv_cache, rope_tables, seed,
                               int8=int8, routed=routed)
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
                          int8=False, routed=False):
    """K10 at a segment step's shape: lengths WAVE_SEQ + 1, 0 for the idle
    slot; ``int8``: on an int8 cache at page 32; ``routed``: on the
    table-routed pool (the idle slot's row the park page)."""
    cache, (q, _, _, _, _), active = _segment_step_inputs(
        torch, kv_cache, rope_tables, SEED + 10 + 100 * int8 + 50 * routed,
        int8=int8, routed=routed)
    before = _pool_copy(cache) if routed else None
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
    note = (_routed_checks(torch, form + " routed", out, before, cache)
            + "; " if routed else "")
    row = {"name": "paged_attention" + ("_int8" if int8 else "")
           + ("_prefix" if routed else "")}
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
    log(f"K10 {form}{' routed' if routed else ''} B{BB} H32/8 page{page} "
        f"lens {lens.tolist()}: max_abs_err {diff.max().item():.3e} (worst "
        f"err/tol {worst:.3f}) kernel_ms {ms:.4f} plain_ms {plain:.4f} "
        f"bound_ms {bms:.4f} ({by}); {note}{walk}")
    return {**row, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/paged_attention.cu",
            "replaces": "paddle_tpu/ops/pallas/paged_attention.py:142",
            "max_abs_err": diff.max().item(), "err_over_tol": worst,
            "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
            "library_ms": None,
            "shape": f"B{BB} H32 Hk8 D128 page{page}"
                     f"{' int8' if int8 else ''}"
                     f"{' routed' if routed else ''} lens {lens.tolist()}"}


def check_rope_attend_masked(torch, timer, k3, kv_cache, rope_tables,
                             int8=False, routed=False):
    """K3's decode form with an active mask at a segment step's shape: the
    idle slot writes nothing and returns zeros; ``int8``: on an int8 cache
    at page 32 (the int8 batcher's segment step; codes within 1 of the
    plain chain's, scales bit-identical); ``routed``: on the table-routed
    pool (the idle slot's row the park page)."""
    cache, rows, active = _segment_step_inputs(
        torch, kv_cache, rope_tables, SEED + 11 + 100 * int8 + 50 * routed,
        int8=int8, routed=routed)
    layer = 1
    form = "rope_append_attend masked" + (" int8" if int8 else "")
    ck, cp = _pool_copy(cache), _pool_copy(cache)
    out, ck = k3.fused_rope_append_attend_decode(*rows, ck, layer, active)
    note = (_routed_checks(torch, form + " routed", out, cache, ck) + "; "
            if routed else "")
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
    row = {"name": "rope_append_attend_masked" + ("_int8" if int8 else "")
           + ("_prefix" if routed else "")}
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
    log(f"K3 {form}{' routed' if routed else ''} B{BB} H32/8 page{page} "
        f"lens {cache.seq_lens.tolist()} idle slot {WAVE_IDLE}: max_abs_err "
        f"{diff.max().item():.3e} (worst err/tol {worst:.3f}) pool values "
        f"differing 0" + (f" but {codes} codes by 1" if int8 else "")
        + f", kernel_ms {ms:.4f} plain_ms {plain:.4f} bound_ms "
        f"{bms:.4f} ({by}); {note}{walk}")
    return {**row, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/rope_append_attend.cu",
            "replaces": "paddle_tpu/ops/pallas/fused_rope_attend.py:441",
            "max_abs_err": diff.max().item(), "err_over_tol": worst,
            **({"codes_differing": codes} if int8 else {}),
            "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
            "library_ms": None,
            "shape": f"B{BB} H32 Hk8 D128 page{page}"
                     f"{' int8' if int8 else ''}"
                     f"{' routed' if routed else ''} seq_lens "
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


def serve_sampled(torch, kernels, model, ids, greedy, greedy_logits,
                  expected, plain, label, **kw):
    """Phase 4d: ``generate_paged`` sampled at SAMPLING on phase 4's model
    and prompts. ``top_k=1`` keeps every logit equal to the maximum (the
    reference's filter), and bf16 logits tie at the maximum at some
    positions: its tokens must be bitwise ``greedy`` (phase 4's) in every
    row up to the row's first tied position of ``greedy_logits``, and
    ``top_p=0`` (the first maximum alone) bitwise in full. THE counted
    sampled run's launches equal ``expected`` (the draw is plain ops) and
    every drawn token lies in the kept set of its own returned logits; the
    same seed again gives the same tokens; 2 x ROLLOUTS sampled and greedy
    rollouts and prefills in turns, their medians beside phase 4's
    (``plain``)."""
    from paddle_tpu_torch.models.llama import _filter_logits

    t, k, p = SAMPLING
    skw = dict(temperature=t, top_k=k, top_p=p, **kw)
    top_p0 = model.generate_paged(ids, NEW, temperature=t, top_p=0.0,
                                  seed=SEED + 50, **kw)
    assert torch.equal(top_p0, greedy), f"{label}: top_p=0 is not greedy"
    top1 = model.generate_paged(ids, NEW, temperature=t, top_k=1,
                                seed=SEED + 50, **kw)
    tied = (greedy_logits == greedy_logits.amax(-1, keepdim=True)).sum(
        -1) > 1                                               # (B, NEW)
    n_same = 0
    for r in range(B):
        first = (tied[r].nonzero()[:1, 0].tolist() or [NEW])[0]
        assert torch.equal(top1[r, PROMPT:PROMPT + first],
                           greedy[r, PROMPT:PROMPT + first]), (
            f"{label}: top_k=1 row {r} differs before its first tie")
        n_same += first
    log(f"{label}: top_p=0 bitwise greedy; top_k=1 equal to greedy on "
        f"{n_same}/{B * NEW} positions before each row's first tied "
        f"maximum ({int(tied.sum())} positions tie at the maximum), "
        f"{'bitwise in full' if torch.equal(top1, greedy) else 'not past'}")
    kernels.reset_launch_counts()
    out, logits = model.generate_paged(ids, NEW, seed=SEED + 51,
                                       return_logits=True, **skw)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts == expected, f"{label}: {counts} != plan {expected}"
    again = model.generate_paged(ids, NEW, seed=SEED + 51, **skw)
    assert torch.equal(out, again), f"{label}: the same seed differs"
    toks = out[:, PROMPT:].long()
    filt = _filter_logits(logits, t, k, p)
    kept = filt > -1e29
    assert bool(kept.gather(-1, toks[..., None]).all()), (
        f"{label}: a drawn token outside its kept set")
    n_kept = kept.sum(-1).float()
    argmax_share = (toks == logits.argmax(-1)).float().mean().item()
    assert not torch.equal(out, greedy), f"{label}: sampling drew greedy"
    # one step's filter and draw alone, on a step's (B, V) logits
    from paddle_tpu_torch.models.llama import _gumbel_argmax

    row = logits[:, 0].contiguous()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 53)
    parts = {"filter": lambda: _filter_logits(row, t, k, p),
             "draw": lambda: _gumbel_argmax(filt[:, 0], gen)}
    part_ms = {}
    for name, fn in parts.items():
        s0, s1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        fn()
        s0.record()
        for _ in range(20):
            fn()
        s1.record()
        s1.synchronize()
        part_ms[name] = (s0.elapsed_time(s1) / 20,
                         host_call_us(torch, fn, 20))
    del logits, filt, kept

    def timed(n_new, sampled):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if sampled:
            model.generate_paged(ids, n_new, seed=SEED + 52, **skw)
        else:
            model.generate_paged(ids, n_new, **kw)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    # greedy and sampled in turns (g s s g g s ...): the step is host-bound
    # and the host's speed drifts within a call
    runs = {False: {NEW: [], 1: []}, True: {NEW: [], 1: []}}
    for i in range(2 * ROLLOUTS):
        for n_new in (NEW, 1):
            for sampled in ((False, True) if i % 2 == 0 else (True, False)):
                runs[sampled][n_new].append(timed(n_new, sampled))
    med = {sm: {n: statistics.median(v) for n, v in r.items()}
           for sm, r in runs.items()}
    step = {sm: (m[NEW] - m[1]) / (NEW - 1) for sm, m in med.items()}
    wins = sum(a < b for a, b in zip(runs[True][NEW], runs[False][NEW]))
    log(f"{label} sampled (T {t}, top_k {k}, top_p {p}): launches = plan, "
        f"same seed same tokens, every token in "
        f"its kept set (kept columns a position {n_kept.min():.0f}-"
        f"{n_kept.max():.0f}, mean {n_kept.mean():.1f}; {argmax_share:.3f} "
        f"of the tokens the argmax); in turns with greedy, {2 * ROLLOUTS} "
        f"each: total_ms sampled {[round(x, 1) for x in runs[True][NEW]]} "
        f"(median {med[True][NEW]:.1f}) greedy "
        f"{[round(x, 1) for x in runs[False][NEW]]} (median "
        f"{med[False][NEW]:.1f}), sampled faster in {wins}/{2 * ROLLOUTS}; "
        f"prefill_ms median {med[True][1]:.1f} / {med[False][1]:.1f}; "
        f"decode {step[True]:.2f} against {step[False]:.2f} ms/step (phase "
        f"4's greedy {(plain['total_ms'] - plain['prefill_ms']) / (NEW - 1):.2f}"
        f"); a step's filter / draw alone "
        + ", ".join(f"{n} {d:.3f} ms back to back ({h:.1f} us of host a "
                    f"call)" for n, (d, h) in part_ms.items()))
    return {"total_ms": med[True][NEW], "total_ms_runs": runs[True][NEW],
            "prefill_ms": med[True][1], "prefill_ms_runs": runs[True][1],
            "decode_step_ms": step[True],
            "greedy_in_turns_total_ms_runs": runs[False][NEW],
            "greedy_in_turns_decode_step_ms": step[False],
            "sampled_faster_turns": wins,
            "kept_columns_mean": n_kept.mean().item(),
            "argmax_share": argmax_share, "launches": counts,
            "filter_draw_ms_host_us": part_ms}


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
    # ---- 4d. sampling on the same model and prompts
    stats["sampled"] = serve_sampled(torch, kernels, model, ids, out,
                                     logits, expected, stats, "serving",
                                     page_size=PAGE)
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
    from the cache, its own included. ``chunk_starts``: the wave-source
    offsets at which the batcher admitted each chunk
    (``GenRequest.chunk_starts``).

    With the prefix cache the first chunk may start past 0: every cell
    before it was matched, read from the pool, and written by an earlier
    request, whose rows are taken here to have been one chunk from 0. A
    full-prompt match's one chunk is the last prompt token, recomputed
    over the cached (cloned) cells. A chunk that starts at or past
    ``prompt_len`` is a resumed stream's one recomputed token: that row
    reads the cells before it from the pool and its own key fresh."""
    starts = sorted(chunk_starts)
    assert starts and starts[0] < prompt_len, starts
    out = []
    for i in range(length):
        if i >= prompt_len:
            out.append(i if i in starts else i + 1)
        elif i < starts[0]:
            out.append(0)
        else:
            out.append(max(c for c in starts if c <= i))
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


def single_adapter_routing(torch, adapter, n_rows, *, dtype, device,
                           scale_b=None):
    """A routing context (``fusion._run_plan``'s ``lora``) that sends
    ``n_rows`` rows through one adapter: its (A, B) pairs as one-slot
    stacks in ``dtype`` on ``device`` (``scale_b`` multiplies every B, in
    f32), the identity sort and offsets [0, n_rows] (the plain forward of
    a request served with that adapter)."""
    import numpy as np

    params = {}
    for name, (a, b) in adapter.items():
        b = torch.as_tensor(np.asarray(b, np.float32))
        if scale_b is not None:
            b = b * scale_b
        params[name] = (torch.as_tensor(np.asarray(a, np.float32))[None]
                        .to(device=device, dtype=dtype),
                        b[None].to(device=device, dtype=dtype))
    idx = torch.arange(n_rows, dtype=torch.int32, device=device)
    return {"sort": idx, "inv": idx,
            "offsets": torch.tensor([0, n_rows], dtype=torch.int32,
                                    device=device),
            "params": params}


class MergedParams(dict):
    """A params dict with one LoRA adapter folded in by ``merge_lora``, one
    weight at a time as the forward reads it (a merged f32 copy of every
    adapted weight at once would not fit beside the model)."""

    def __init__(self, prms, adapter):
        super().__init__(prms)
        self.adapter = adapter

    def __getitem__(self, name):
        from paddle_tpu_torch.models.lora import merge_lora

        w = super().__getitem__(name)
        if name not in self.adapter:
            return w
        return merge_lora({name: w}, {name: self.adapter[name]})[name]


def check_batcher_tokens(torch, cfg, prms, reqs, done, label, int8=False,
                         adapters=None):
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
    from the batcher's admission record (``chunk_starts``).

    ``adapters`` (phase 6f): {rid: the LoRA adapter its request was served
    with}; those requests' f32 forward runs ``merge_lora``'s weights
    (``MergedParams``; int8: the quantized function with the delta beside
    it in f32, the codes cannot be merged) and their bf16 forward the
    serving math in plain ops (the delta beside each projection,
    ``single_adapter_routing``). Their two controls replace the
    attention ones: tokens of the bf16 forward without the delta (the
    request routed to the base group) and with the adapter's B halved."""
    from paddle_tpu_torch.models.llama import prompt_logits_pure
    from paddle_tpu_torch.ops.kernels import flash_attention as k1
    from paddle_tpu_torch.ops.kernels.quant_matmul import QuantizedWeight

    plain_attention = k1._reference_attention
    prms32 = {n: p if isinstance(p, QuantizedWeight) else p.float()
              for n, p in prms.items()}
    worst, n_pos, n_argmax = 0.0, 0, 0
    ctl = ({"routed to the base group": [0, 0.0],
            "adapter B halved": [0, 0.0]} if adapters else
           {"missing own cell": [0, 0.0], "fresh source dropped": [0, 0.0]})
    n_ctl = 0
    with torch.inference_mode():
        for rid, (prompt, n_new, _) in enumerate(reqs):
            adapter = (adapters or {}).get(rid)
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

            def logits(params, attention, lora=None):
                k1._reference_attention = attention
                try:
                    return prompt_logits_pure(params, seq, cfg, plain=True,
                                              lora=lora)[0, n0 - 1:].float()
                finally:
                    k1._reference_attention = plain_attention

            def routing(dtype, **kw):
                return single_adapter_routing(torch, adapter, seq.numel(),
                                              dtype=dtype, device="cuda",
                                              **kw)

            lora16 = None if adapter is None else routing(torch.bfloat16)
            if adapter is None:
                f32 = logits(prms32, attention_with())
            elif int8:
                f32 = logits(prms32, attention_with(),
                             routing(torch.float32))
            else:
                f32 = logits(MergedParams(prms32, adapter), attention_with())
            err = (logits(prms, attention_with(), lora16)
                   - f32).abs().amax(-1)
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
            if adapters is not None:
                # the LoRA controls, on the adapter requests
                faults = {} if adapter is None else {
                    "routed to the base group": lambda: logits(
                        prms, attention_with()),
                    "adapter B halved": lambda: logits(
                        prms, attention_with(), routing(torch.bfloat16,
                                                        scale_b=0.5))}
            else:
                faults = {
                    "missing own cell": lambda: logits(prms, attention_with(
                        lambda i, j: ~((i >= n0) & (j == i)))),
                    "fresh source dropped": lambda: logits(
                        prms, attention_with(fresh_dropped))}
            n_ctl += bool(faults) * len(toks)
            for name, fault in faults.items():
                rc = ratio(fault().argmax(-1))
                ctl[name][0] += int((rc > 2).sum())
                ctl[name][1] = max(ctl[name][1], rc.max().item())
            del f32, err
    del prms32
    torch.cuda.empty_cache()
    log(f"{label}: teacher-forced rule over {n_pos} emitted tokens: worst "
        f"(f32 max - f32 logit of the token) / E {worst:.3f} (bound 2), "
        f"tokens equal to the f32 argmax {n_argmax}/{n_pos}; controls "
        + ", ".join(f"{k}: {v[0]}/{n_ctl} positions fail, worst {v[1]:.2f}"
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

    def run_once(lora=None, **spec_kw):
        """One engine over ``reqs``; ``lora`` (phase 6f): (adapters by id,
        the adapter id of each request) on a ``lora=True`` engine."""
        if lora is not None:
            spec_kw.update(lora=True, lora_max_rank=LORA_RANK,
                           lora_hbm_adapters=LORA_SLOTS)
        eng = ContinuousBatcher(model, max_batch=BB, max_seq=BSEQ,
                                segment=16, prefill_chunk=BCHUNK,
                                prefix_caching=False, **serve_kw, **spec_kw)
        for aid, weights in (lora[0] if lora else {}).items():
            eng.register_adapter(aid, weights)
        for rid, (prompt, n_new, t) in enumerate(reqs):
            eng.submit(prompt, max_new_tokens=n_new, arrival_segment=t,
                       adapter_id=lora[1][rid] if lora else None)
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
            expected = batcher_plan(counts, plan, st, L, int8)
            log(f"{label_}: launches {counts} expected {expected}")
            assert counts == expected, f"{counts} != plan {expected}"
            check_batcher_requests(reqs, done, st, cfg)
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
            if not int8:
                # ---- 6e. the same requests sampled
                res["sampled"] = serve_batcher_sampled(
                    torch, kernels, run_once, plan, L, cfg, reqs, done, st,
                    label_, repeat=label == "fused")
            out[label] = res
        # ---- 6f. the same requests through LoRA adapters, fused plan
        flags.set_flags({"fused_decode_fusions": BATCHER_PLANS[0][1]})
        out["fused"]["lora"] = serve_batcher_lora(
            torch, kernels, fusion, cfg, prms, reqs, run_once,
            f"batcher {'int8 ' if int8 else ''}lora fused", int8,
            out["fused"])
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


def batcher_plan(counts, plan, st, L, int8, lora=False):
    """The launches a batcher run of ``st``'s waves and segment steps must
    count under the per-token ``plan`` (``planned_kernel_launches``):
    161 K2 and one attention kernel a layer each (K3 ragged or K11 a wave,
    K3 masked or K10 a step), + 64 K4 (int8), + 448 K13 (``lora``)."""
    waves, steps = st["ragged_steps"], st["decode_steps"]
    fused = plan["rope_append_attend"] > 0
    per = plan["rope_append_attend"] + plan["paged_attention"]
    assert plan["norm_matmul"] == 5 * L + 1 and per == L, plan
    expected = dict.fromkeys(counts, 0)
    expected["fused_norm_matmul"] = plan["norm_matmul"] * (waves + steps)
    expected["fused_rope_attend_ragged" if fused
             else "ragged_paged_attention"] = per * waves
    expected["fused_rope_attend" if fused
             else "paged_attention"] = per * steps
    if int8:
        assert plan["quant_matmul"] == 2 * L, plan
        expected["quant_matmul"] = plan["quant_matmul"] * (waves + steps)
    if lora:
        assert plan["grouped_matmul"] == 2 * 7 * L, plan
        expected["grouped_matmul"] = plan["grouped_matmul"] * (waves + steps)
    return expected


def check_batcher_requests(reqs, done, st, cfg):
    """Every request "ok" with exactly its max_new_tokens of valid ids, no
    slot step wasted, no bucket padding."""
    for rid, (prompt, n_new, _) in enumerate(reqs):
        req = done[rid]
        assert req.status == "ok", (rid, req.status)
        assert len(req.tokens) == n_new, (rid, len(req.tokens))
        assert all(0 <= t < cfg.vocab_size for t in req.tokens)
    assert st["wasted_slot_steps"] == 0, st
    assert st["bucket_pad_tokens"] == 0, st


def serve_batcher_sampled(torch, kernels, run_once, plan, L, cfg, reqs,
                          greedy_done, greedy, label, repeat):
    """Phase 6e in one plan: the phase-6 requests sampled at SAMPLING from
    one seed. No EOS, so the schedule is the greedy run's: THE counted
    run's waves, segment steps, launches and ``host_sync_count`` equal the
    greedy run's (the draw is plain ops on the device and adds no sync);
    every request "ok" with its tokens, not the greedy ones; with
    ``repeat`` the same seed again gives the same tokens. The walls."""
    t, k, p = SAMPLING
    kw = dict(temperature=t, top_k=k, top_p=p, seed=SEED + 60)
    kernels.reset_launch_counts()
    done, st, wall = run_once(**kw)
    counts = kernels.launch_counts()
    keys = ("ragged_steps", "decode_steps", "segments", "host_sync_count")
    assert all(st[x] == greedy[x] for x in keys), (
        {x: (st[x], greedy[x]) for x in keys})
    expected = batcher_plan(counts, plan, st, L, False)
    assert counts == expected, f"{label} sampled: {counts} != {expected}"
    check_batcher_requests(reqs, done, st, cfg)
    toks = [done[r].tokens for r in range(len(reqs))]
    walls = [wall]
    if repeat:
        again, _, wall2 = run_once(**kw)
        walls.append(wall2)
        assert toks == [again[r].tokens for r in range(len(reqs))], (
            f"{label} sampled: the same seed differs")
    same = sum(a == b for r in range(len(reqs))
               for a, b in zip(toks[r], greedy_done[r].tokens))
    n_tok = sum(len(x) for x in toks)
    assert same < n_tok, f"{label} sampled: every token greedy"
    log(f"{label} sampled (T {t}, top_k {k}, top_p {p}): launches = plan, "
        f"{st['ragged_steps']} waves + {st['decode_steps']} segment steps "
        f"and host_sync_count {st['host_sync_count']} as the greedy run's, "
        f"{'same seed same tokens, ' if repeat else ''}{same}/{n_tok} tokens "
        f"equal to the greedy run's; walls "
        f"{[round(x, 3) for x in walls]} s")
    return {"wall_s_runs": walls, "launches": counts,
            "greedy_token_share": same / n_tok,
            **{x: st[x] for x in keys}}


def serve_batcher_lora(torch, kernels, fusion, cfg, prms, reqs, run_once,
                       label, int8, plain):
    """Phase 6f: the phase-6 requests served through four seeded adapters
    (ranks LORA_RANKS, each request's adapter LORA_OF_REQUEST) on a
    ``lora=True`` engine with LORA_SLOTS device slots and rank LORA_RANK:
    THE counted run's launches equal the batcher's plan + 448 K13 a wave
    and a segment step; every request "ok" with its tokens; adapter loads,
    hits, evictions and deferrals all > 0; every emitted token held to
    phase 6's teacher-forced rule against its adapter's f32 forward (its
    two LoRA controls failing); its wall beside phase 6's (``plain``)."""
    from paddle_tpu_torch.models.lora import make_lora_adapter

    L = cfg.num_hidden_layers
    t0 = time.perf_counter()
    adapters = {f"adapter{i}": make_lora_adapter(cfg, r, seed=SEED + 70 + i)
                for i, r in enumerate(LORA_RANKS)}
    aid_of = [None if a is None else f"adapter{a}" for a in LORA_OF_REQUEST]
    assert len(aid_of) == len(reqs)
    log(f"{label}: {len(adapters)} adapters of ranks {LORA_RANKS} made in "
        f"{time.perf_counter() - t0:.1f} s; requests by adapter "
        f"{[aid_of.count(a) for a in (None, *adapters)]} (base first)")
    plan = fusion.planned_kernel_launches(L, quantized=int8, lora=True)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    done, st, wall = run_once(lora=(adapters, aid_of))   # THE counted run
    counts = kernels.launch_counts()
    expected = batcher_plan(counts, plan, st, L, int8, lora=True)
    log(f"{label}: launches {counts} expected {expected}")
    assert counts == expected, f"{counts} != plan {expected}"
    check_batcher_requests(reqs, done, st, cfg)
    akeys = ("adapter_loads", "adapter_hits", "adapter_evictions",
             "adapter_deferrals", "adapter_batched", "adapter_swap_stalls")
    for x in akeys[:4]:
        assert st[x] > 0, (x, {y: st[y] for y in akeys})
    peak = torch.cuda.max_memory_allocated() / 2**30
    keys = ("ragged_steps", "decode_steps", "host_sync_count")
    log(f"{label}: wall {wall:.3f} s against phase 6's "
        f"{plain['wall_s']:.3f} (this run); " + ", ".join(
            f"{x} {st[x]}" for x in keys + akeys)
        + f"; max_memory_allocated {peak:.2f} GiB")
    res = {"wall_s": wall, "launches": counts,
           "max_memory_allocated_gib": peak,
           **{x: st[x] for x in keys + akeys}}
    res["tokens_check"] = check_batcher_tokens(
        torch, cfg, prms, reqs, done, label, int8=int8,
        adapters={rid: adapters[a] for rid, a in enumerate(aid_of) if a})
    return res


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


PREFIX_PARK_TICK = 12     # the tick phase 6d's _on_tick asks for its park


def prefix_requests(vocab):
    """The 24 seeded requests of phase 6d (SEED + 13), in submission
    order: 4 that share a 256-token system prompt and add 32-256 tokens of
    their own (a multiple of 32, so a repeat matches the whole prompt) and
    16-24 new tokens (they retire early), 4 that repeat those prompts
    whole (full-prompt matches: a copy-on-write clone each; queued ahead
    of the rest, arriving at 3), 12 more on the system prompt with 32-256
    tokens of their own and 4 unrelated prompts of 32-512 tokens, 16-64 new
    tokens each. Arrivals in 0-6: the first request alone at 0 (the system
    prompt's first writer)."""
    import numpy as np

    rng = np.random.default_rng(SEED + 13)
    system = rng.integers(0, vocab, size=256)

    def on_system(n):
        return np.concatenate([system, rng.integers(0, vocab, size=n)]
                              ).astype(np.int32)

    first = [(on_system(32 * int(rng.integers(1, 9))),
              int(rng.integers(16, 25)), 2 * min(i, 1)) for i in range(4)]
    repeats = [(p.copy(), int(rng.integers(16, 65)), 6) for p, _, _ in first]
    more = [(on_system(int(rng.integers(32, 257))), int(rng.integers(16, 65)),
             int(rng.integers(2, 6))) for _ in range(12)]
    unrelated = [(rng.integers(0, vocab, size=int(rng.integers(32, 513)))
                  .astype(np.int32), int(rng.integers(16, 65)),
                  int(rng.integers(2, 7))) for _ in range(4)]
    return first + more + unrelated + repeats


def serve_batcher_prefix(torch, kernels, profile=False, int8=False):
    """Phase 6d: Llama-3-8B at full width through ``ContinuousBatcher``
    with the reference's defaults (prefix caching, the host KV tier, the
    unified arena) on ``prefix_requests``, the pool at 3 x pps pages
    (``page_pool_pages``), so admission defers, the tree evicts and the
    host tier demotes and promotes. bf16 in both plans (BATCHER_PLANS),
    or ``int8`` (int8w+int8kv, page 32) in the fused plan. The counted
    run: a first ``run()`` whose ``_on_tick`` parks one decoding request,
    then ``resume`` and a second ``run()``; its launches must equal the
    plan over both runs' waves and segment steps, every request "ok" with
    its max_new_tokens, the prefix and tier stats positive, the resumed
    request admitting one token, the allocator's ``check()`` holding and
    every emitted token passing ``check_batcher_tokens``' rule. Walls with
    the cache on (no park) and with ``prefix_caching=False`` on the same
    requests, printed: the median of 3 for bf16 fused, once otherwise."""
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
    page = PAGE_INT8 if int8 else PAGE
    pps = -(-BSEQ // page)
    serve_kw = dict(page_size=page)
    prms = model.param_dict()
    if int8:
        prms = quantize_for_inference(model)
        for name, p in model.named_parameters():
            if isinstance(prms[name], QuantizedWeight):
                p.data = p.data.new_empty(0)   # the int8 model keeps codes
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        serve_kw.update(quantized_params=prms, cache_dtype="int8")
    reqs = prefix_requests(cfg.vocab_size)
    n_tokens = sum(n for _, n, _ in reqs)
    target = max(range(4, 16), key=lambda r: (reqs[r][1], -r))
    log(f"serving, continuous batching with the prefix cache ({kind}): "
        f"{len(reqs)} requests, prompts {sum(len(p) for p, _, _ in reqs)} "
        f"tokens, {n_tokens} new tokens, page {page}, page_pool_pages "
        f"{3 * pps}, park rid {target} at tick {PREFIX_PARK_TICK}")

    def engine(**kw):
        eng = ContinuousBatcher(model, max_batch=BB, max_seq=BSEQ,
                                segment=16, prefill_chunk=BCHUNK, **kw,
                                **serve_kw)
        for prompt, n_new, t in reqs:
            eng.submit(prompt, max_new_tokens=n_new, arrival_segment=t)
        return eng

    def timed(eng):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = eng.run()
        torch.cuda.synchronize()
        return done, time.perf_counter() - t0

    def on_engine():
        eng = engine(page_pool_pages=3 * pps)
        eng._ensure_host_arena()      # its pinned allocation is set-up
        return eng

    def counted():
        """The park-and-resume run: (done, stats, wall, park record)."""
        eng = on_engine()

        def hook(tick):
            if tick >= PREFIX_PARK_TICK and not asked:
                eng.park(target)
                asked.append(tick)

        asked = []
        eng._on_tick = hook
        done, wall = timed(eng)
        eng._on_tick = None
        assert eng.parked == [target], (eng.parked, eng.stats["parks"])
        first = dict(eng.stats)
        eng.resume(target)
        done2, wall2 = timed(eng)
        assert list(done2) == [target], sorted(done2)
        done.update(done2)
        eng._pager.check()
        eng._host_pager.check()
        return done, eng, wall + wall2, first

    out = {}
    old = flags.get_flag("fused_decode_fusions")
    plans = BATCHER_PLANS[:1] if int8 else BATCHER_PLANS
    try:
        for label, fusions in plans:
            label_ = f"batcher prefix {'int8 ' if int8 else ''}{label}"
            flags.set_flags({"fused_decode_fusions": fusions})
            plan = fusion.planned_kernel_launches(L, quantized=int8)
            timed(on_engine())                           # warm-up
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launch_counts()
            done, eng, wall, first = counted()          # THE counted run
            counts = kernels.launch_counts()
            st = eng.stats
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
                expected["quant_matmul"] = plan["quant_matmul"] * (waves
                                                                   + steps)
            log(f"{label_}: launches {counts} expected {expected}")
            assert plan["norm_matmul"] == 5 * L + 1 and per == L, plan
            assert counts == expected, f"{counts} != plan {expected}"
            for rid, (prompt, n_new, _) in enumerate(reqs):
                req = done[rid]
                assert req.status == "ok", (rid, req.status)
                assert len(req.tokens) == n_new, (rid, len(req.tokens))
            positive = ("prefix_hits", "pages_saved", "prefix_cow_clones",
                        "host_tier_pages_demoted",
                        "host_tier_pages_promoted",
                        "recompute_avoided_tokens", "resumes", "parks")
            for key in positive:
                # the tree's own counters (demotions) are mirrored from
                # each run's tree: the first run's are the park run's
                assert max(first[key], st[key]) > 0, (label_, key, st[key])
            resumed = (st["prefill_tokens_admitted"]
                       - first["prefill_tokens_admitted"])
            assert resumed == 1, (label_, "resume admitted", resumed)
            assert st["bucket_pad_tokens"] == 0, st
            peak = torch.cuda.max_memory_allocated() / 2**30
            pinned = eng._host_arena.nbytes()
            keys = ("ragged_steps", "segments", "decode_steps",
                    "host_sync_count", "prefill_tokens_admitted",
                    "prefix_hits", "prefix_misses", "prefix_tokens_matched",
                    "pages_saved", "prefix_cow_clones", "prefix_evictions",
                    "cache_full_deferrals", "host_tier_pages_demoted",
                    "host_tier_pages_promoted", "recompute_avoided_tokens",
                    "prefetch_stall_ms", "offload_stall_ms", "parks",
                    "resumes", "wasted_slot_steps")
            res = {"counted_wall_s": wall, "launches": counts,
                   "first_run": {k: first[k] for k in keys},
                   "max_memory_allocated_gib": peak,
                   "host_arena_pinned_bytes": pinned,
                   "host_arena_pinned": eng._host_arena.pinned,
                   **{k: st[k] for k in keys}}
            log(f"{label_}: counted run (park rid {target} asked at tick "
                f"{PREFIX_PARK_TICK}, resumed with 1 token admitted) wall "
                f"{wall:.3f} s, "
                + ", ".join(f"{k} {st[k]}" for k in keys)
                + f", max_memory_allocated {peak:.2f} GiB, host arena "
                f"{pinned} bytes pinned={eng._host_arena.pinned}; the park "
                f"run's tree: host_tier_pages_demoted "
                f"{first['host_tier_pages_demoted']}, prefix_evictions "
                f"{first['prefix_evictions']}, prefix_inserts "
                f"{first['prefix_inserts']}")
            res["tokens_check"] = check_batcher_tokens(
                torch, cfg, prms, reqs, done, label_, int8=int8)
            n_runs = 3 if (label == "fused" and not int8) else 1
            walls = {True: [], False: []}
            for i in range(n_runs):
                # in turns (on, off, off, on, ...): the walls are host-bound
                # and drift within a call
                for on in ((True, False) if i % 2 == 0 else (False, True)):
                    walls[on].append(timed(
                        on_engine() if on
                        else engine(prefix_caching=False))[1])
            for on in (True, False):
                wall_s = statistics.median(walls[on])
                res["on" if on else "off"] = {
                    "wall_s": wall_s, "wall_s_runs": walls[on],
                    "generated_tok_s": n_tokens / wall_s}
                log(f"{label_}: prefix_caching={on} wall "
                    f"{[round(w, 3) for w in walls[on]]} s (median "
                    f"{wall_s:.3f}), {n_tokens / wall_s:.1f} generated "
                    f"tok/s")
            if profile:
                with torch.inference_mode():
                    res["profile"] = profile_window(
                        torch, lambda: timed(on_engine()), label_)
            out[label] = res
    finally:
        flags.set_flags({"fused_decode_fusions": old})
    return out


FLEET_KILL_TOKENS = 3     # phase 6g kills replica 1 once one of its
                          # requests has streamed this many tokens


def fleet_run(torch, kernels, model, reqs, engine_kw, *, roles=None,
              kill=False, migrator=None, on_card=True, timeout=600.0):
    """Serve ``reqs`` ((prompt, max_new, arrival) each; the arrivals are an
    engine's, the router submits all at once) on a two-replica fleet:
    ``make_fleet`` over ``model`` with a MemoryStore registry at the
    reference's heartbeat (0.5 s) and lease TTL (2.0 s), and
    ``FleetRouter(affinity=True)`` (``disagg`` with ``roles``). ``kill``:
    SIGKILL replica 1 once one of its requests has streamed
    FLEET_KILL_TOKENS tokens. The launch counts are set to 0 just before
    the workers start and read once both have stopped."""
    from paddle_tpu_torch.distributed.store import MemoryStore
    from paddle_tpu_torch.inference.fleet import FleetRegistry, make_fleet
    from paddle_tpu_torch.inference.router import FleetRouter

    registry = FleetRegistry(store=MemoryStore(), job_id="chip")
    _, workers = make_fleet(model, 2, registry=registry, roles=roles,
                            **engine_kw)
    for w in workers:
        w.engine._ensure_host_arena()      # its pinned allocation: set-up
    router = FleetRouter(workers, registry, affinity=True,
                         disagg=True if roles else None, migrator=migrator)
    if on_card:
        torch.cuda.synchronize()
    kernels.reset_launch_counts()
    for w in workers:
        w.start()
    t0 = time.perf_counter()
    rids = [router.submit(p, n) for p, n, _ in reqs]
    t_kill = t_rec = None
    deadline = time.monotonic() + timeout
    try:
        while True:
            router.poll()
            frs = [router.request(r) for r in rids]
            if kill and t_kill is None and any(
                    fr.replica == workers[1].name
                    and fr.status == "dispatched"
                    and len(fr._journal) >= FLEET_KILL_TOKENS
                    for fr in frs):
                workers[1].kill()
                t_kill = time.perf_counter()
            if t_kill is not None and t_rec is None and any(
                    fr.failovers and (fr.done or getattr(
                        fr._gen_req, "tokens", None)) for fr in frs):
                t_rec = time.perf_counter()
            if all(fr.done for fr in frs):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"fleet run outstanding after {timeout} s: "
                    f"{[fr.rid for fr in frs if not fr.done][:8]}")
            time.sleep(0.002)
        wall = time.perf_counter() - t0
    finally:
        for w in workers:
            if w.alive():
                w.terminate()
        for w in workers:
            w.join(60)
    if on_card:
        torch.cuda.synchronize()
    assert not any(w._serve_t.is_alive() for w in workers), "a serve thread"
    counts = kernels.launch_counts()
    return SimpleNamespace(router=router, workers=workers, registry=registry,
                           done={r: router.request(r) for r in rids},
                           wall=wall, counts=counts, t_kill=t_kill,
                           t_rec=t_rec, dead=sorted(router._dead))


def fleet_plan_counts(counts, workers, L):
    """The fused plan's launches over every replica's own waves and
    segment steps (a killed replica's up to its kill)."""
    from paddle_tpu_torch.ops.kernels import fusion

    plan = fusion.planned_kernel_launches(L)
    waves = sum(w.engine.stats["ragged_steps"] for w in workers)
    steps = sum(w.engine.stats["decode_steps"] for w in workers)
    expected = dict.fromkeys(counts, 0)
    expected["fused_norm_matmul"] = plan["norm_matmul"] * (waves + steps)
    expected["fused_rope_attend_ragged"] = plan["rope_append_attend"] * waves
    expected["fused_rope_attend"] = plan["rope_append_attend"] * steps
    assert plan["norm_matmul"] == 5 * L + 1, plan
    assert plan["rope_append_attend"] == L and not plan["paged_attention"]
    return expected, waves, steps


def serve_fleet(torch, kernels, cfg=None, device="cuda", check_tokens=True,
                model=None):
    """Phase 6g: the serving fleet on phase 6's Llama-3-8B model (random
    bf16 weights, 32 layers), the fused plan, two ``ContinuousBatcher``
    replicas over ONE copy of the weights with phase 6d's settings (prefix
    cache, host tier, arena, ``page_pool_pages = 3 x pps``) on phase 6d's
    24 requests, both serve threads launching on the card at once.

    Failover: replica 1 is killed once one of its requests has streamed 3
    tokens; all 24 end "ok" with their max_new_tokens, one failover, at
    least one request recovered, every emitted token within phase 6's rule
    (``check_batcher_tokens``), the survivor's allocators bijective.
    Disaggregated: roles prefill/decode, ``KVMigrator("chunked")``; every
    request prefills on replica 0 and decodes on replica 1 (one migration
    each), the bytes moved equal the pages moved x the page's bytes, the
    decode replica admits one token a resume, every token within the rule.
    Controls, on a third run of three requests: (a) one request's last full
    page has its K block zeroed in transit: its tokens must fail the rule;
    (b)
    ``kv.migrate`` armed once for another: it decodes on at the source,
    "ok", within the rule. Each run's K2 and K3 launches equal the plan
    over every replica's own waves and segment steps. Phase 6d's single
    engine serves the same requests in turns with the two fleets (its
    wall, once before and once after).

    ``model`` (phase 6h shares it) defaults to a new one at ``cfg``;
    ``cfg`` / ``device="cpu"`` / ``check_tokens=False`` rehearse the
    schedule on the CPU at a tiny width (no kernels: the launch check is
    skipped)."""
    from paddle_tpu_torch.framework import flags
    from paddle_tpu_torch.inference import ContinuousBatcher
    from paddle_tpu_torch.inference.migration import KVMigrator
    from paddle_tpu_torch.models.kv_cache import kv_page_nbytes
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.reliability import faults

    on_card = device == "cuda"
    if model is None:
        model = LlamaForCausalLM(
            cfg or LlamaConfig.llama3_8b(dtype="bfloat16"), seed=SEED,
            device=device)
    cfg = model.config
    L = cfg.num_hidden_layers
    prms = model.param_dict()
    reqs = prefix_requests(cfg.vocab_size)
    n_tokens = sum(n for _, n, _ in reqs)
    pps = -(-BSEQ // PAGE)
    engine_kw = dict(max_batch=BB, max_seq=BSEQ, segment=16,
                     prefill_chunk=BCHUNK, page_size=PAGE,
                     page_pool_pages=3 * pps)
    # the disaggregated fleet queues every request at the prefill replica
    # (soft capacity max_batch + max_pending), so none lands on the decode
    # replica for lack of room
    disagg_kw = dict(engine_kw, max_pending=len(reqs))
    page_bytes = kv_page_nbytes(L, cfg.num_key_value_heads, PAGE,
                                cfg.head_dim,
                                prms["model.embed_tokens.weight"].dtype)
    log(f"serving fleet (bf16, fused): 2 replicas, {len(reqs)} requests, "
        f"{n_tokens} new tokens, page {PAGE}, page_pool_pages {3 * pps}, "
        f"heartbeat 0.5 s, lease TTL 2.0 s, kill after "
        f"{FLEET_KILL_TOKENS} streamed tokens")

    def single():
        eng = ContinuousBatcher(model, **engine_kw)
        eng._ensure_host_arena()
        for prompt, n_new, t in reqs:
            eng.submit(prompt, max_new_tokens=n_new, arrival_segment=t)
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = eng.run()
        if on_card:
            torch.cuda.synchronize()
        assert all(done[r].status == "ok" for r in range(len(reqs)))
        return time.perf_counter() - t0

    def check_launches(run, label):
        expected, waves, steps = fleet_plan_counts(run.counts, run.workers,
                                                   L)
        log(f"{label}: launches {run.counts} expected {expected} "
            f"({waves} waves + {steps} segment steps over both replicas)")
        if on_card:
            assert run.counts == expected, f"{run.counts} != {expected}"
        return waves, steps

    def check_served(run, label, sub=None):
        sub = reqs if sub is None else sub
        for rid, (_, n_new, _) in enumerate(sub):
            fr = run.done[rid]
            assert fr.status == "ok", (label, rid, fr.status, fr.error)
            assert len(fr.tokens) == n_new, (label, rid, len(fr.tokens))

    class _Corrupting(KVMigrator):
        """The chunked wire, with the K block of one request's last full
        page (16 keys before the frontier, every layer) zeroed after it
        crossed (control a)."""
        target = None

        def transfer(self, blob, rid=None):
            out = super().transfer(blob, rid=rid)
            if rid == self.target:
                pages = list(out["pages"])
                j = blob["seq_len"] // PAGE - 1
                pages[j] = dict(pages[j], k=torch.zeros_like(pages[j]["k"]))
                out = {**out, "pages": pages}
            return out

    class _Recording(KVMigrator):
        """The chunked wire, recording each delivered blob's pages."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.pages = []

        def transfer(self, blob, rid=None):
            out = super().transfer(blob, rid=rid)
            self.pages.append((rid, len(blob["pages"]),
                               int(blob["nbytes"])))
            return out

    old = flags.get_flag("fused_decode_fusions")
    flags.set_flags({"fused_decode_fusions": BATCHER_PLANS[0][1]})
    out = {}
    try:
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        single_walls = [single()]

        # ---- failover
        fo = fleet_run(torch, kernels, model, reqs, engine_kw, kill=True,
                       on_card=on_card)
        waves, steps = check_launches(fo, "fleet failover")
        check_served(fo, "fleet failover")
        st = fo.router.stats
        assert fo.t_kill is not None, "no request streamed on replica 1"
        assert st["failovers"] == 1, ("lease expiries", fo.dead, st)
        assert fo.dead == [fo.workers[1].name], fo.dead
        assert st["requests_recovered"] >= 1, st
        survivor = fo.workers[0].engine
        survivor._pager.check()
        survivor._host_pager.check()
        if survivor._prefix is not None:
            survivor._prefix.allocator.check()
        kill_ms = (None if fo.t_rec is None
                   else (fo.t_rec - fo.t_kill) * 1e3)
        out["failover"] = {
            "wall_s": fo.wall, "generated_tok_s": n_tokens / fo.wall,
            "launches": fo.counts, "waves": waves, "segment_steps": steps,
            "failovers": st["failovers"], "lease_expiries": len(fo.dead),
            "requests_recovered": st["requests_recovered"],
            "redispatched": st["redispatched"],
            "kill_to_first_recovered_token_ms": kill_ms,
            "per_replica": {w.name: {k: w.engine.stats[k] for k in (
                "ragged_steps", "decode_steps", "tokens_emitted",
                "prefix_hits", "prefill_tokens_admitted")}
                for w in fo.workers}}
        log(f"fleet failover: wall {fo.wall:.3f} s, "
            f"{n_tokens / fo.wall:.1f} generated tok/s, failovers "
            f"{st['failovers']} (lease expiries {fo.dead}), recovered "
            f"{st['requests_recovered']}, redispatched "
            f"{st['redispatched']}, kill -> first recovered token "
            f"{kill_ms} ms, per replica {out['failover']['per_replica']}")

        # ---- disaggregated
        mig = _Recording("chunked")
        dg = fleet_run(torch, kernels, model, reqs, disagg_kw,
                       roles=["prefill", "decode"], migrator=mig,
                       on_card=on_card)
        dwaves, dsteps = check_launches(dg, "fleet disagg")
        check_served(dg, "fleet disagg")
        st = dg.router.stats
        pre, dec = dg.workers
        for rid, fr in dg.done.items():
            assert (fr.migrated, fr.replica) == (1, dec.name), (
                rid, fr.migrated, fr.replica, dg.dead)
        assert st["migrations"] == len(reqs) and not st["migrations_failed"]
        assert not dg.dead and not st["failovers"], ("lease expiries",
                                                     dg.dead)
        n_pages = sum(n for _, n, _ in mig.pages)
        assert mig.stats["bytes_moved"] == n_pages * page_bytes, (
            mig.stats["bytes_moved"], n_pages, page_bytes)
        assert all(nb == n * page_bytes for _, n, nb in mig.pages)
        assert dec.engine.stats["prefill_tokens_admitted"] == \
            dec.engine.stats["resumes"] == len(reqs), dec.engine.stats
        for w in dg.workers:
            w.engine._pager.check()
            w.engine._host_pager.check()
        mb = mig.stats["bytes_moved"] / 2**20
        out["disagg"] = {
            "wall_s": dg.wall, "generated_tok_s": n_tokens / dg.wall,
            "launches": dg.counts, "waves": dwaves, "segment_steps": dsteps,
            "migrations": st["migrations"], "lease_expiries": len(dg.dead),
            "pages_moved": n_pages, "bytes_moved": mig.stats["bytes_moved"],
            "chunks": mig.stats["chunks"],
            "migration_ms_per_request": st["migration_stall_ms"]
            / st["migrations"],
            "mb_per_request": mb / st["migrations"],
            "prefill_replica": {k: pre.engine.stats[k] for k in (
                "ragged_steps", "decode_steps", "parks")},
            "decode_replica": {k: dec.engine.stats[k] for k in (
                "ragged_steps", "decode_steps", "resumes",
                "prefill_tokens_admitted")}}
        log(f"fleet disagg: wall {dg.wall:.3f} s, "
            f"{n_tokens / dg.wall:.1f} generated tok/s, {st['migrations']} "
            f"migrations, {n_pages} pages = {mb:.1f} MB over "
            f"{mig.stats['chunks']} chunks, "
            f"{out['disagg']['migration_ms_per_request']:.2f} ms and "
            f"{out['disagg']['mb_per_request']:.2f} MB a request (park -> "
            f"resume bound), lease expiries {dg.dead}, prefill replica "
            f"{out['disagg']['prefill_replica']}, decode replica "
            f"{out['disagg']['decode_replica']}")
        single_walls.append(single())
        if on_card:
            peak = torch.cuda.max_memory_allocated() / 2**30
        else:
            peak = 0.0
        pinned = sum(w.engine._host_arena.nbytes() for w in fo.workers)
        out.update(single_engine_wall_s=single_walls,
                   single_engine_tok_s=[n_tokens / w for w in single_walls],
                   max_memory_allocated_gib=peak,
                   host_arena_pinned_bytes_per_fleet=pinned)
        log(f"phase 6d's single engine on the same requests, in turns "
            f"(before, after): wall {[round(w, 3) for w in single_walls]} "
            f"s, {[round(n_tokens / w, 1) for w in single_walls]} "
            f"generated tok/s; fleet walls failover {fo.wall:.3f} s, "
            f"disagg {dg.wall:.3f} s; max_memory_allocated {peak:.2f} GiB, "
            f"host arenas {pinned} bytes pinned a fleet")

        # ---- controls
        ctl_reqs = [reqs[0], reqs[4], reqs[5]]
        ctl_mig = _Corrupting("chunked")
        ctl_mig.target = 0
        faults.inject("kv.migrate", nth=1,
                      when=lambda ctx: ctx.get("rid") == 1)
        try:
            ct = fleet_run(torch, kernels, model, ctl_reqs, disagg_kw,
                           roles=["prefill", "decode"], migrator=ctl_mig,
                           on_card=on_card)
        finally:
            faults.clear("kv.migrate")
        check_served(ct, "fleet controls", ctl_reqs)
        check_launches(ct, "fleet controls")
        b = ct.done[1]
        assert (b.migrated, b.replica) == (0, ct.workers[0].name), (
            b.migrated, b.replica)
        assert ct.router.stats["migrations_failed"] == 1
        assert (ct.done[0].migrated, ct.done[2].migrated) == (1, 1)
        out["controls"] = {"kv_migrate_request": {
            "status": b.status, "migrated": b.migrated,
            "replica": b.replica}}

        if check_tokens:
            out["failover"]["tokens_check"] = check_batcher_tokens(
                torch, cfg, prms, reqs, fo.done, "fleet failover")
            out["disagg"]["tokens_check"] = check_batcher_tokens(
                torch, cfg, prms, reqs, dg.done, "fleet disagg")
            out["controls"]["kv_migrate_tokens_check"] = \
                check_batcher_tokens(torch, cfg, prms, ctl_reqs[1:],
                                     {0: ct.done[1], 1: ct.done[2]},
                                     "fleet control (b) kv.migrate")
            try:
                check_batcher_tokens(torch, cfg, prms, ctl_reqs[:1],
                                     {0: ct.done[0]},
                                     "fleet control (a) zeroed K page")
            except AssertionError as e:
                assert "fails the rule" in str(e), e
                out["controls"]["zeroed_k_page"] = "fails the rule"
            else:
                raise AssertionError("control (a): a request decoded over "
                                     "a zeroed K page passes the rule")
        log(f"fleet: {json.dumps(out, default=str)}")
    finally:
        flags.set_flags({"fused_decode_fusions": old})
        faults.clear()
    return out


#: phase 6h: three deadline tiers (router edges 10 s and 60 s: interactive,
#: standard, batch), the ladder's cooldown and the autoscaler's streak
AUTOSCALE_TIERS = ((10.0, 0.25), (60.0, 0.5), (None, 0.25))
AUTOSCALE_TIER_EDGES = "10.0,60.0"
AUTOSCALE_COOLDOWN_S = 0.5
AUTOSCALE_STREAK = 3
AUTOSCALE_TAIL_NEW = 192    # new tokens of each of the two tail streams


def autoscale_spec_kw(base_rate, vocab=128256):
    """Phase 6h's ``TraceSpec`` fields at Llama-3-8B widths: 48 requests
    over a 15 s horizon at ``base_rate`` requests/s (no diurnal swing) with
    one 5x burst at 0.3-0.6 of the horizon; lognormal prompts (mean 96,
    16-384 tokens) and new tokens (mean 24, 8-64); 8 tenants under Zipf
    1.2, each owning a 64-token prefix (four pages at page 16); three
    deadline tiers; no adapters. The requests themselves do not depend on
    the rate (each arrival is one exponential draw, scaled)."""
    return dict(seed=SEED + 24, n_requests=48, horizon_s=15.0,
                base_rate=float(base_rate), diurnal_amp=0.0,
                bursts=((0.3, 0.6, 5.0),), prompt_mean=96.0,
                prompt_sigma=0.6, prompt_min=16, prompt_cap=384,
                new_mean=24.0, new_sigma=0.5, new_min=8, new_cap=64,
                n_tenants=8, zipf_alpha=1.2, tenant_prefix_len=64,
                n_adapters=0, tiers=AUTOSCALE_TIERS, vocab=int(vocab))


def serve_autoscale(torch, kernels, model=None, cfg=None, device="cuda",
                    check_tokens=True):
    """Phase 6h: the autoscaled fleet on phase 6g's model (Llama-3-8B,
    random bf16 weights), the fused plan, phase 6d's engine settings, a
    MemoryStore registry (heartbeat 0.5 s, lease TTL 2.0 s),
    ``FleetRouter(affinity=True)`` and ``FleetAutoscaler(min_replicas=1,
    max_replicas=2)`` (cooldown 0.5 s, streak 3).

    The single engine first serves the trace's 48 requests all at once: its
    sustained requests/s R sets the trace's base rate to 0.4 R (a 5x burst
    at 0.3-0.6 of the horizon). ``run_trace`` replays the trace against one
    replica while the autoscaler scales up, climbs the brownout ladder and
    comes back down; the floor is held at 2 replicas until two long tail
    streams stream on distinct replicas, then lowered to 1, so the
    scale-down has live streams to evacuate. The single engine serves the
    trace again after the fleet (its walls in turns).

    Asserts: a scale-up, a brownout level entered and the ladder back at 0,
    a scale-down that completed with every evacuated stream resumed
    (survivor resumes = ``router.stats["evacuations"]`` >= 1, each resume
    admitting one token), no ``replica_lost`` and no failover (0 lease
    expiries), sheds only in the lowest tier, every "ok" request's tokens
    within phase 6's rule (``check_batcher_tokens``), K2 and K3 launches
    equal to the plan over every replica's own waves and segment steps
    (spawned and retired included), every surviving allocator's check.

    ``cfg`` / ``device="cpu"`` / ``check_tokens=False`` rehearse the
    schedule on the CPU at a tiny width (no kernels: the launch check is
    logged, not asserted)."""
    import numpy as np

    from paddle_tpu_torch.distributed.store import MemoryStore
    from paddle_tpu_torch.framework import flags
    from paddle_tpu_torch.inference import ContinuousBatcher
    from paddle_tpu_torch.inference.autoscaler import FleetAutoscaler
    from paddle_tpu_torch.inference.fleet import FleetRegistry, make_fleet
    from paddle_tpu_torch.inference.loadgen import (TraceSpec,
                                                    generate_trace,
                                                    run_trace)
    from paddle_tpu_torch.inference.router import FleetRouter
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    on_card = device == "cuda"
    if model is None:
        model = LlamaForCausalLM(
            cfg or LlamaConfig.llama3_8b(dtype="bfloat16"), seed=SEED,
            device=device)
    cfg = model.config
    L = cfg.num_hidden_layers
    prms = model.param_dict()
    pps = -(-BSEQ // PAGE)
    engine_kw = dict(max_batch=BB, max_seq=BSEQ, segment=16,
                     prefill_chunk=BCHUNK, page_size=PAGE,
                     page_pool_pages=3 * pps)
    probe = generate_trace(TraceSpec(**autoscale_spec_kw(1.0,
                                                         cfg.vocab_size)))

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def single():
        eng = ContinuousBatcher(model, **engine_kw)
        eng._ensure_host_arena()
        for r in probe:
            eng.submit(np.asarray(r.prompt, np.int32),
                       max_new_tokens=r.max_new)
        sync()
        t0 = time.perf_counter()
        done = eng.run()
        sync()
        assert all(d.status == "ok" for d in done.values())
        return time.perf_counter() - t0

    old = {k: flags.get_flag(k) for k in ("fused_decode_fusions",
                                          "fleet_tier_edges")}
    flags.set_flags({"fused_decode_fusions": BATCHER_PLANS[0][1],
                     "fleet_tier_edges": AUTOSCALE_TIER_EDGES})
    workers, auto, out = [], None, {}
    try:
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        single_walls = [single()]
        rate = len(probe) / single_walls[0]
        spec = TraceSpec(**autoscale_spec_kw(0.4 * rate, cfg.vocab_size))
        trace = generate_trace(spec)
        assert [r.prompt for r in trace] == [r.prompt for r in probe]
        log(f"autoscaled fleet (bf16, fused): the single engine serves the "
            f"trace's {len(trace)} requests at once in "
            f"{single_walls[0]:.3f} s = {rate:.3f} requests/s; base rate "
            f"{spec.base_rate:.3f}/s, burst x5 at 0.3-0.6 of "
            f"{spec.horizon_s} s, last arrival {trace[-1].t:.3f} s")

        registry = FleetRegistry(store=MemoryStore(), job_id="chip-auto")
        _, workers = make_fleet(model, 1, registry=registry,
                                heartbeat_interval=0.5, **engine_kw)
        workers[0].engine._ensure_host_arena()
        router = FleetRouter(workers, registry, affinity=True)
        # each request's last engine binding, kept as the router finishes
        # it (the one-token resume check reads its admission record)
        final_gr = {}
        finish = router._finish

        def keep_binding(fr, status, tokens=None, error=None):
            final_gr[fr.rid] = fr._gen_req
            finish(fr, status, tokens=tokens, error=error)

        router._finish = keep_binding
        auto = FleetAutoscaler(router, model, engine_kw=engine_kw,
                               min_replicas=1, max_replicas=2,
                               cooldown_s=AUTOSCALE_COOLDOWN_S,
                               streak=AUTOSCALE_STREAK,
                               heartbeat_interval=0.5)
        # the floor holds the grown fleet until the tail streams are live
        auto.min_replicas = 2
        timeline = []
        t_mono = time.monotonic()

        class Tracked:
            """The autoscaler, with the live replica count recorded on
            each change."""

            def step(self):
                auto.step()
                n = len(auto._live_workers())
                if not timeline or timeline[-1][1] != n:
                    timeline.append((round(time.monotonic() - t_mono, 3),
                                     n))

        tracked = Tracked()

        def pump(cond, timeout, with_auto=True):
            deadline = time.monotonic() + timeout
            while not cond():
                if time.monotonic() > deadline:
                    raise TimeoutError(f"6h: not reached in {timeout} s: "
                                       f"{auto.events}")
                router.poll()
                if with_auto:
                    tracked.step()
                time.sleep(0.002)

        sync()
        kernels.reset_launch_counts()
        workers[0].start()
        pump(lambda: (router._state.get(workers[0].name) or {}).get(
            "fresh"), 30, with_auto=False)
        t_mono = time.monotonic()
        report = run_trace(router, trace, autoscaler=tracked,
                           settle_timeout_s=300.0)
        assert auto.stats["scale_ups"] >= 1, auto.events
        assert auto.stats["brownout"]["enters"][0] >= 1, auto.events
        pump(lambda: auto.stats["brownout"]["level"] == 0, 60)
        assert len(auto._live_workers()) == 2, auto.events

        # the tail: two long streams, one on each replica, then the floor
        # comes down and the autoscaler drains one replica out
        if not on_card:
            # the tiny CPU model outruns the card's schedule: stall its
            # serve loops so the tail streams are still live when the
            # drain begins
            for w in auto._live_workers():
                w.stall_s = 0.02
        rng = np.random.default_rng(SEED + 25)
        tail_p = [rng.integers(0, cfg.vocab_size, size=128).astype(np.int32)
                  for _ in range(2)]
        tail = []
        for p in tail_p:
            tail.append(router.submit(p, AUTOSCALE_TAIL_NEW,
                                      deadline_s=30.0))
            pump(lambda: len({router.request(r).replica for r in tail
                              if router.request(r).status == "dispatched"
                              and len(router.request(r)._journal) >= 2})
                 == len(tail), 60, with_auto=False)
        auto.min_replicas = 1
        pump(lambda: auto.stats["scale_downs"] >= 1 and all(
            router.request(r).done for r in tail)
            and len(auto._live_workers()) == 1, 90)
        wall = time.monotonic() - t_mono
        for w in workers + auto.spawned:
            if w.alive():
                w.terminate()
        for w in workers + auto.spawned:
            w.join(60)
        sync()
        everyone = workers + auto.spawned
        assert not any(w._serve_t.is_alive() for w in everyone), \
            "a serve thread"
        counts = kernels.launch_counts()
        single_walls.append(single())
    finally:
        for w in workers + (auto.spawned if auto is not None else []):
            if w.alive():
                w.kill()
        flags.set_flags(old)

    # ---- checks
    st = router.stats
    trace_rids = sorted(rid for rid in router._reqs if rid not in tail)
    assert len(trace_rids) == len(trace)
    frs = {r.idx: router.request(rid) for r, rid in zip(trace, trace_rids)}
    statuses = [fr.status for fr in router._reqs.values()]
    assert not router._dead and not st["failovers"], (router._dead, st)
    assert set(statuses) <= {"ok", "shed", "timeout"}, statuses
    last = router.n_tiers - 1
    shed = [fr for fr in router._reqs.values() if fr.status == "shed"]
    assert all(fr.tier == last for fr in shed), [fr.tier for fr in shed]
    assert not any(st["shed_by_tier"][t] for t in range(last)), \
        st["shed_by_tier"]
    assert auto.stats["brownout"]["level"] == 0
    assert router.brownout_shed_tiers == 0
    for r in tail:
        fr = router.request(r)
        assert fr.status == "ok" and len(fr.tokens) == AUTOSCALE_TAIL_NEW
    evac = st["evacuations"]
    resumes = sum(w.engine.stats["resumes"] for w in everyone)
    assert evac >= 1 and resumes == evac, (evac, resumes)
    assert auto.stats["evacuations_started"] == evac
    moved = [fr for fr in router._reqs.values() if fr.migrated]
    assert len(moved) == evac, (len(moved), evac)
    for fr in moved:
        gr = final_gr[fr.rid]
        assert gr.resume_src is not None and gr.chunk_starts == [
            len(gr.resume_src) - 1], (fr.rid, gr.chunk_starts)
    expected, waves, steps = fleet_plan_counts(counts, everyone, L)
    log(f"autoscaled fleet: launches {counts} expected {expected} ({waves} "
        f"waves + {steps} segment steps over {len(everyone)} replicas)")
    if on_card:
        assert counts == expected, f"{counts} != {expected}"
    for w in everyone:
        if w in auto.retired:
            continue
        w.engine._pager.check()
        w.engine._host_pager.check()
        if w.engine._prefix is not None:
            w.engine._prefix.allocator.check()
    ok = [(fr, r) for r, fr in ((r, frs[r.idx]) for r in trace)
          if fr.status == "ok"]
    for fr, r in ok:
        assert len(fr.tokens) == r.max_new, (r.idx, len(fr.tokens))
    n_ok_tokens = sum(len(fr.tokens) for fr, _ in ok) + 2 * AUTOSCALE_TAIL_NEW
    t0 = t_mono
    events = [{**e, "t": round(e["t"] - t0, 3)} for e in auto.events]
    peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else 0.0
    pinned = sum(w.engine._host_arena.nbytes() for w in everyone
                 if w.engine._host_arena is not None)
    tiers = {str(k): v for k, v in report["tiers"].items()}
    out.update(
        trace_spec=spec.to_json(), single_engine_requests_per_s=rate,
        trace_wall_s=report["wall_s"], wall_s=wall,
        generated_tok_s=n_ok_tokens / wall, tokens_ok=n_ok_tokens,
        tiers=tiers, statuses={s: statuses.count(s) for s in set(statuses)},
        scale_ups=auto.stats["scale_ups"],
        scale_downs=auto.stats["scale_downs"],
        brownout=auto.stats["brownout"],
        flap_suppressed=auto.stats["flap_suppressed"],
        evacuations=evac, resumes=resumes, events=events,
        replicas_over_time=timeline, launches=counts, waves=waves,
        segment_steps=steps, lease_expiries=len(router._dead),
        max_queue=max((q for _, q, _ in report["queue_curve"]), default=0),
        max_memory_allocated_gib=peak, host_arena_pinned_bytes=pinned,
        single_engine_wall_s=single_walls,
        per_replica={w.name: {k: w.engine.stats[k] for k in (
            "ragged_steps", "decode_steps", "tokens_emitted", "resumes",
            "parks", "prefix_hits")} for w in everyone})
    log(f"autoscaled fleet: wall {wall:.3f} s (trace replay "
        f"{report['wall_s']:.3f} s), {n_ok_tokens / wall:.1f} tok/s of "
        f"'ok' requests, statuses {out['statuses']}, scale-ups "
        f"{out['scale_ups']}, scale-downs {out['scale_downs']}, brownout "
        f"{out['brownout']}, flap_suppressed {out['flap_suppressed']}, "
        f"evacuations {evac} = resumes {resumes}, replicas over time "
        f"{timeline}, peak {peak:.2f} GiB, host arenas {pinned} bytes "
        f"pinned")
    for k, rec in tiers.items():
        log(f"autoscaled fleet tier {k}: n {rec['n']} ok {rec['ok']} shed "
            f"{rec['shed']} timeout {rec['timeout']} replica_lost "
            f"{rec['replica_lost']}; TTFT p50/p99 {rec['ttft_p50_ms']} / "
            f"{rec['ttft_p99_ms']} ms, inter-token p50/p99 "
            f"{rec['itl_p50_ms']} / {rec['itl_p99_ms']} ms")
    log(f"autoscaled fleet events (s from the trace's start): {events}")
    log(f"the single engine on the trace's requests at once, in turns "
        f"(before, after): {[round(w, 3) for w in single_walls]} s; the "
        f"fleet's trace replay {report['wall_s']:.3f} s")
    if check_tokens:
        reqs = [(np.asarray(r.prompt, np.int32), r.max_new, 0)
                for _, r in ok] + [(p, AUTOSCALE_TAIL_NEW, 0)
                                   for p in tail_p]
        done = {i: fr for i, fr in enumerate(
            [fr for fr, _ in ok] + [router.request(r) for r in tail])}
        out["tokens_check"] = check_batcher_tokens(
            torch, cfg, prms, reqs, done, "autoscaled fleet")
    return out


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


def check_flash_train_fwd(torch, timer, k1, q, k, v, suffix=""):
    """K1 at the train step's attention shape without a mask (B=4,
    S=2048, 32/8 heads, causal; or the shape of ``q``, ``k``: ``suffix``
    names the row) against its plain version, with SDPA causal
    (``is_causal=True, enable_gqa=True``) as the library."""
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
    row = {"name": "flash_attention_fwd_train" + suffix, "route": "cuda",
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


def check_flash_bwd(torch, timer, k1, shape=(TB, TS, 32, 8, 128),
                    suffix=""):
    """K5 at the train step's attention shape: B=4, S=2048, 32/8 heads,
    D=128 (or ``shape`` = (B, S, H, Hk, D), its rows named with
    ``suffix``), causal, dO random; against its plain version from K1's
    own (out, lse), each gradient element within ``k1.bwd_tolerance``; two
    calls bitwise equal. Also K1 there without a mask
    (``check_flash_train_fwd``). Returns both rows."""
    b, s, h, hk, d = shape
    g = torch.Generator(device="cuda").manual_seed(SEED + 20)
    q, k, v, do = (torch.randn((b, s, n, d), generator=g, device="cuda",
                               dtype=torch.bfloat16) for n in (h, hk, hk, h))
    fwd_row = check_flash_train_fwd(torch, timer, k1, q, k, v, suffix)
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
    row = {"name": "flash_attention_bwd" + suffix, "route": "cuda",
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


#: phase 7b's weight-only forms: (name, quantize_for_inference algo, group)
QUANT_TRAIN_FORMS = (("int8", "weight_only_int8", -1),
                     ("int4 g128", "weight_only_int4", 128))
#: phase 7b's layer-local weight names and the head's
QUANT_TRAIN_NORMS = ("input_layernorm.weight",
                     "post_attention_layernorm.weight", "model.norm.weight")


def _quant_train_run(torch, fusion, cfg, prms, h0, cot, plain=False,
                     grad=True):
    """One forward (+ backward of ``cot`` on the logits) of a decoder layer
    and the final norm + LM head in ``prms`` (layer-local names and the
    head's) through ``run_train_decoder_layer`` / ``run_train_lm_head``:
    the fused plan on the kernels, or with ``plain`` the unfused plan on
    the plain versions. Returns (logits, dh, {norm: grad}) (grads None
    under ``grad=False``)."""
    from paddle_tpu_torch.models.llama import _train_attend

    h = h0.detach().clone().requires_grad_(grad)
    norms = {n: prms[n].detach().clone().requires_grad_(grad)
             for n in QUANT_TRAIN_NORMS}
    p = {**prms, **norms}
    enabled = () if plain else None

    def attend(q, k, v, residual=None, o_w=None):
        return _train_attend(cfg, q, k, v, plain, None, residual, o_w)

    out = fusion.run_train_decoder_layer(
        {n: v for n, v in p.items() if not n.startswith(("model.", "lm_"))},
        h, cfg.rms_norm_eps, attend, enabled=enabled, plain=plain)
    logits = fusion.run_train_lm_head(
        {n: p[n] for n in ("model.norm.weight", "lm_head.weight")}, out,
        cfg.rms_norm_eps, enabled=enabled, plain=plain)
    if not grad:
        return logits, None, None
    logits.backward(cot.to(logits.dtype))
    return logits.detach(), h.grad, {n: t.grad for n, t in norms.items()}


def train_quant(torch, kernels, k2, k4):
    """Phase 7b: quantized weights under autograd. One Llama-3-8B decoder
    layer + the final norm and LM head in ``quantize_for_inference`` form
    (int8 per channel, then int4 group 128), random N(0, 0.02^2) weights,
    at the train step's shape (B=4 x S=2048, M 8192): forward + backward of
    a seeded random cotangent on the logits through the train executors
    (the fused plan: the q/k/v and gate/up groups in K6 + K4 each, the
    o-proj inside the attention epilogue and the down-proj in K4, the head
    in K2's quantized form; backward K7, K5, K12 and the weight-only rule
    in plain ops). dh, the logits and the three norm weights' gradients
    against a plain f32 chain over the dequantized weights: kernel rel L2
    <= 2 x the plain bf16 chain's (phase 8's rule); a control whose
    backward reads every scale 16 columns on must fail it; the forward is
    bitwise the ``torch.no_grad()`` call's; the launches equal
    ``fusion.quantized_train_launches(1)``. Then times K2's int8 and int4
    g128 forms at M 8192 for N 4096 / 14336 / 128256 beside dense K2 and
    the bound, K4 at M 8192, and the backward's dequant + matmul."""
    from paddle_tpu_torch.models.llama import quantize_for_inference
    from paddle_tpu_torch.ops.kernels import fusion

    cfg = train_config(1)
    hdim, inter, vocab = cfg.hidden_size, cfg.intermediate_size, \
        cfg.vocab_size
    kv = cfg.num_key_value_heads * cfg.head_dim
    shapes = {"input_layernorm.weight": (hdim,),
              "self_attn.q_proj.weight": (hdim, hdim),
              "self_attn.k_proj.weight": (hdim, kv),
              "self_attn.v_proj.weight": (hdim, kv),
              "self_attn.o_proj.weight": (hdim, hdim),
              "post_attention_layernorm.weight": (hdim,),
              "mlp.gate_proj.weight": (hdim, inter),
              "mlp.up_proj.weight": (hdim, inter),
              "mlp.down_proj.weight": (inter, hdim),
              "model.norm.weight": (hdim,),
              "lm_head.weight": (hdim, vocab)}
    g = torch.Generator(device="cuda").manual_seed(SEED + 26)
    raw = {}
    for name, shape in shapes.items():
        if len(shape) == 1:
            raw[name] = (1.0 + 0.05 * torch.randn(
                shape, generator=g, device="cuda")).to(torch.bfloat16)
        else:
            raw[name] = (0.02 * torch.randn(
                shape, generator=g, device="cuda")).to(torch.bfloat16)
    h = torch.randn((TB, TS, hdim), generator=g, device="cuda").to(
        torch.bfloat16)
    cot = torch.randn((TB, TS, vocab), generator=g, device="cuda").to(
        torch.bfloat16)
    plan = fusion.quantized_train_launches(1)
    names = ["logits", "dh", *QUANT_TRAIN_NORMS]
    out = {"plan": plan}

    def rel(a, b):
        return ((a.float() - b).norm() / b.norm()).item()

    def errs(run, ref):
        tensors = [run[0], run[1], *(run[2][n] for n in QUANT_TRAIN_NORMS)]
        refs = [ref[0], ref[1], *(ref[2][n] for n in QUANT_TRAIN_NORMS)]
        return [rel(a, b) for a, b in zip(tensors, refs)]

    for label, algo, gs in QUANT_TRAIN_FORMS:
        qp = quantize_for_inference(raw, algo, gs)
        _quant_train_run(torch, fusion, cfg, qp, h, cot)   # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        kern = _quant_train_run(torch, fusion, cfg, qp, h, cot)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        want = dict.fromkeys(counts, 0)
        want.update(plan)
        assert counts == want, f"7b {label}: launches {counts} != {want}"
        with torch.no_grad():
            nograd = _quant_train_run(torch, fusion, cfg, qp, h, cot,
                                      grad=False)[0]
        assert torch.equal(kern[0], nograd), f"7b {label}: forward bits"
        del nograd
        rule = k4.quant_matmul_dx
        k4.quant_matmul_dx = lambda gg, codes, scales, *a: rule(
            gg, codes, scales.roll(SHIFT, -1), *a)
        try:
            ctl = _quant_train_run(torch, fusion, cfg, qp, h, cot)
        finally:
            k4.quant_matmul_dx = rule
        plain = _quant_train_run(torch, fusion, cfg, qp, h, cot, plain=True)
        p32 = {n: (k4.dequant_weight(v.codes, v.scales, v.weight_dtype,
                                     v.group_size, k=v.shape[0],
                                     dtype=torch.float32)
                   if isinstance(v, k4.QuantizedWeight) else v.float())
               for n, v in qp.items()}
        ref = _quant_train_run(torch, fusion, cfg, p32, h.float(),
                               cot.float(), plain=True)
        del p32
        ek, ep, ec = errs(kern, ref), errs(plain, ref), errs(ctl, ref)
        rows = {n: {"kernel": a, "plain_bf16": b, "control": c,
                    "kernel_over_plain": a / b, "control_over_plain": c / b}
                for n, a, b, c in zip(names, ek, ep, ec)}
        worst = max(r["kernel_over_plain"] for r in rows.values())
        ctl_worst = max(r["control_over_plain"] for r in rows.values())
        for n, r in rows.items():
            log(f"  7b {label} {n}: rel L2 err vs f32 kernel "
                f"{r['kernel']:.3e} plain bf16 {r['plain_bf16']:.3e} "
                f"ratio {r['kernel_over_plain']:.3f}; shifted-scale "
                f"backward control {r['control_over_plain']:.3f}")
        log(f"7b {label}: forward + backward (1 layer + head, B{TB} "
            f"S{TS}, after one warm-up) {wall * 1e3:.1f} ms wall, launches "
            f"{counts} = plan, "
            f"forward bitwise the no-grad call's, worst kernel/plain "
            f"{worst:.3f}, control {ctl_worst:.3f}, peak {peak:.2f} GiB")
        assert worst <= 2, f"7b {label}: kernel/plain error ratio {worst}"
        assert ctl_worst > 2, (f"7b {label}: the shifted-scale control "
                               f"passed the rule ({ctl_worst:.3f})")
        out[label] = {"launches": counts, "worst_ratio": worst,
                      "control_worst_ratio": ctl_worst, "per_tensor": rows,
                      "wall_ms": wall * 1e3,
                      "max_memory_allocated_gib": peak}
        del kern, ctl, plain, ref, qp
        torch.cuda.empty_cache()
    del cot, raw
    torch.cuda.empty_cache()
    out["times"] = quant_train_times(torch, k2, k4)
    return out


def quant_train_times(torch, k2, k4):
    """K2's int8 and int4 g128 forms at M 8192 (K 4096; N 4096, 14336,
    128256) beside dense K2 and the bound; K4 at M 8192 (the o-proj and
    down-proj, int8 and int4 g128); the backward's dequant + matmul
    (``quant_matmul_dx``) at the head's and the down-proj's shapes. Each
    quantized form also beside its plain version and the library's
    dequant (``dequant_weight`` into bf16) + ``torch.matmul`` (K2: after
    ``F.rms_norm``). Cold L2, median device ms (5 calls at N 128256, else
    20)."""
    from paddle_tpu_torch.ops.kernels.quant_matmul import dequant_weight

    rms_norm = torch.nn.functional.rms_norm
    timer = ColdTimer(torch)
    g = torch.Generator(device="cuda").manual_seed(SEED + 27)
    m, eps, times = TB * TS, 1e-5, {}
    x = torch.randn((m, 4096), generator=g, device="cuda").to(torch.bfloat16)
    nw = (torch.rand((4096,), generator=g, device="cuda") + 0.5).to(
        torch.bfloat16)
    for n in (4096, 14336, 128256):
        iters = 5 if n > 20000 else 20
        w = (torch.randn((4096, n), generator=g, device="cuda")
             / 64.0).to(torch.bfloat16)
        flops = 2 * m * n * 4096
        dense = timer(lambda: k2.fused_norm_matmul_pure(x, nw, eps, w),
                      iters=iters)
        dbound = bound(2 * (m * 4096 + 4096 + m * n + 4096 * n), flops,
                       BF16_FLOPS)
        row = {"dense_ms": dense, "dense_bound_ms": dbound[0]}
        for label, algo, gs in QUANT_TRAIN_FORMS:
            qw, _ = _quantize(torch, g, 4096, n, algo.split("_")[-1], gs)
            ms = timer(lambda: k2.fused_norm_matmul_pure(x, nw, eps, qw),
                       iters=iters)
            plain = timer(lambda: k2._reference(x, nw, eps, qw),
                          iters=iters)
            lib = timer(lambda: torch.matmul(
                rms_norm(x, (4096,), nw, eps), dequant_weight(
                    qw.codes, qw.scales, qw.weight_dtype, gs, k=4096,
                    dtype=torch.bfloat16)), iters=iters)
            b = bound(2 * (m * 4096 + 4096 + m * n) + qw.codes.numel()
                      + 4 * qw.scales.numel(), flops, BF16_FLOPS)
            row[label] = {"ms": ms, "bound_ms": b[0], "bound_by": b[1],
                          "plain_ms": plain, "library_ms": lib}
            if n == 128256:
                gy = torch.randn((m, n), generator=g, device="cuda").to(
                    torch.bfloat16)
                row[label]["backward_dequant_matmul_ms"] = timer(
                    lambda: k4.quant_matmul_dx(
                        gy, qw.codes, qw.scales, qw.weight_dtype, gs, 4096,
                        torch.bfloat16), iters=iters)
                del gy
            del qw
        times[f"K2 M{m} K4096 N{n}"] = row
        log(f"7b K2 M{m} K4096 N{n}: dense {dense:.4f} ms (bound "
            f"{dbound[0]:.4f}, {dbound[1]}); "
            + "; ".join(f"{lb} {row[lb]['ms']:.4f} ms (bound "
                        f"{row[lb]['bound_ms']:.4f}, {row[lb]['bound_by']}; "
                        f"plain {row[lb]['plain_ms']:.4f}, library dequant "
                        f"+ matmul {row[lb]['library_ms']:.4f})"
                        + (f", backward dequant + matmul "
                           f"{row[lb]['backward_dequant_matmul_ms']:.4f} ms"
                           if "backward_dequant_matmul_ms" in row[lb]
                           else "")
                        for lb, _, _ in QUANT_TRAIN_FORMS))
        del w
    for kdim in (4096, 14336):
        xk = torch.randn((m, kdim), generator=g, device="cuda").to(
            torch.bfloat16)
        row = {}
        for label, algo, gs in QUANT_TRAIN_FORMS:
            qw, _ = _quantize(torch, g, kdim, 4096, algo.split("_")[-1], gs)
            ms = timer(lambda: k4.quant_matmul_qw(xk, qw))
            plain = timer(lambda: k4.quant_matmul_reference(
                xk, qw.codes, qw.scales, qw.weight_dtype, gs))
            lib = timer(lambda: xk @ dequant_weight(
                qw.codes, qw.scales, qw.weight_dtype, gs, k=kdim,
                dtype=torch.bfloat16))
            b = bound(2 * (m * kdim + m * 4096) + qw.codes.numel()
                      + 4 * qw.scales.numel(), 2 * m * 4096 * kdim,
                      BF16_FLOPS)
            gy = torch.randn((m, 4096), generator=g, device="cuda").to(
                torch.bfloat16)
            dx = timer(lambda: k4.quant_matmul_dx(
                gy, qw.codes, qw.scales, qw.weight_dtype, gs, kdim,
                torch.bfloat16))
            row[label] = {"ms": ms, "bound_ms": b[0], "bound_by": b[1],
                          "plain_ms": plain, "library_ms": lib,
                          "backward_dequant_matmul_ms": dx}
            del qw, gy
        times[f"K4 M{m} K{kdim} N4096"] = row
        log(f"7b K4 M{m} K{kdim} N4096: " + "; ".join(
            f"{lb} {r['ms']:.4f} ms (bound {r['bound_ms']:.4f}, "
            f"{r['bound_by']}; plain {r['plain_ms']:.4f}, library dequant + "
            f"matmul {r['library_ms']:.4f}), backward dequant + matmul "
            f"{r['backward_dequant_matmul_ms']:.4f} ms"
            for lb, r in row.items()))
        del xk
    del timer, x
    torch.cuda.empty_cache()
    return times


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
# Data parallelism and ZeRO (phase 9c): K8's shard form in this process,
# then the 2-layer full-width train step in child processes started through
# the port's launcher: one rank over NCCL (9c-a), two ranks on the one card
# over gloo with CUDA tensors (9c-b). A child runs ``chip_smoke.py
# --dp-child <a|b> <dir>`` and writes ``<dir>/rank<r>.json``.
# ---------------------------------------------------------------------------
DP_PLACEMENTS = ("dp", "os", "os_g", "p_g_os")
DP_LR = 1e-4                      # AdamW8bit(1e-4), phase 9's recipe
DP_OPT_KW = dict(weight_decay=0.01, lr_scale=1.0, beta1=0.9, beta2=0.999,
                 eps=1e-8)        # AdamW8bit's defaults, for the K8 replays


def k8_shards(k8, p, cuts, shift=0):
    """The shards of ``p`` over the block ranges [cuts[i], cuts[i + 1])
    as a ZeRO rank's optimizer holds them: (lo, hi, the shard's own fresh
    state, ``init_state`` of the flat range) for each non-empty range.
    ``shift`` > 0 is the moved shard map of the control: every range after
    the first lies ``shift`` blocks later."""
    from paddle_tpu_torch.distributed.sharding import Q8_BLOCK

    pf, out = p.view(-1), []
    for i, (b0, b1) in enumerate(zip(cuts, cuts[1:])):
        d = shift if i else 0
        lo, hi = (min((b + d) * Q8_BLOCK, pf.numel()) for b in (b0, b1))
        if hi > lo:
            out.append((lo, hi, k8.init_state(pf[lo:hi], master=True)))
    return out


def k8_by_shards(k8, p, g, shards, plain=False):
    """K8 on each shard of ``k8_shards`` (flat views of ``p`` and ``g``),
    one launch a shard, as ZeRO ranks run it."""
    pf, gf = p.view(-1), g.reshape(-1)
    for lo, hi, st in shards:
        k8.adamw8bit_update(pf[lo:hi], gf[lo:hi], st, DP_LR, 1,
                            plain=plain, **DP_OPT_KW)


def k8_gathered(torch, shards):
    """The shards' states end to end, as a gather onto one rank lays them:
    the whole tensor's flat state layout."""
    return {k: torch.cat([st[k].reshape(-1) for _, _, st in shards])
            for k in shards[0][2]}


def _k8_state_equal(torch, a, b):
    return all(torch.equal(_as_bytes(torch, a[k]).reshape(-1),
                           _as_bytes(torch, b[k]).reshape(-1)) for k in a)


def _k8_err(torch, p, st, p_ref, st_ref, step):
    """K8's error against its plain version: codes bit-identical, scales
    within 3e-7 relative, master within step * 3e-7 (``check_adamw8bit``'s
    bars); returns the max abs error of the parameter and the master."""
    for key in ("m_q", "v_q"):
        diff = (_as_bytes(torch, st[key]).reshape(-1)
                != _as_bytes(torch, st_ref[key]).reshape(-1)).sum().item()
        assert diff == 0, f"K8 shards: {diff} {key} codes differ from plain"
    for key in ("m_s", "v_s"):
        rel = ((st[key] - st_ref[key]).abs()
               / st_ref[key].abs().clamp(min=1e-30)).max().item()
        assert rel <= 3e-7, f"K8 shards: {key} rel err {rel} against plain"
    merr = (st["master"].reshape(-1)
            - st_ref["master"].reshape(-1)).abs().max().item()
    assert merr <= step * 3e-7, f"K8 shards: master err {merr} against plain"
    return max(merr, (p.float() - p_ref.float()).abs().max().item())


def check_adamw8bit_shards(torch, timer, k8):
    """K8's shard form at the train step's shapes: a gate_proj-shaped bf16
    param with its f32 master (28,672 blocks) cut as 2 and 4 ZeRO ranks
    cut it, and a 4096-element norm weight (2 blocks) cut for 4 ranks (two
    own none and launch nothing), each shard with its own state as the
    optimizer makes it: parameter, master, codes and scales (the shards'
    states gathered) bitwise equal to the whole-tensor launch, and held to
    the plain version with ``check_adamw8bit``'s bars (the row's
    ``max_abs_err``); the moved-shard control must differ. Times the
    2-rank cut's two launches (plain: the same two ranges)."""
    from paddle_tpu_torch.distributed.sharding import block_shard

    g = torch.Generator(device="cuda").manual_seed(SEED + 31)
    row, launched, err = None, 0, 0.0
    for shape in ((4096, 14336), (4096,)):
        p0 = (torch.randn(shape, generator=g, device="cuda") * 0.02).to(
            torch.bfloat16)
        gr = (torch.randn(shape, generator=g, device="cuda") * 1e-3).to(
            torch.bfloat16)
        whole, st_whole = p0.clone(), k8.init_state(p0, master=True)
        k8.adamw8bit_update(whole, gr, st_whole, DP_LR, 1, **DP_OPT_KW)
        plain, st_plain = p0.clone(), k8.init_state(p0, master=True)
        k8.adamw8bit_update(plain, gr, st_plain, DP_LR, 1, plain=True,
                            **DP_OPT_KW)
        for world in ((2, 4) if len(shape) == 2 else (4,)):
            cuts = [block_shard(p0.numel(), world, r)[0] // 2048
                    for r in range(world)] + [-(-p0.numel() // 2048)]
            p = p0.clone()
            shards = k8_shards(k8, p, cuts)
            before = k8.launches
            k8_by_shards(k8, p, gr, shards)
            launched = k8.launches - before
            assert launched == sum(1 for a, b in zip(cuts, cuts[1:])
                                   if b > a), (shape, world, launched)
            torch.cuda.synchronize()
            st = k8_gathered(torch, shards)
            assert torch.equal(p, whole) and _k8_state_equal(
                torch, st, st_whole), f"K8 shards {shape} x{world} differ"
            err = max(err, _k8_err(torch, p, st, plain, st_plain, 1))
            moved = p0.clone()
            k8_by_shards(k8, moved, gr, k8_shards(k8, moved, cuts, shift=1))
            assert not torch.equal(moved, whole), "moved shards passed"
            log(f"K8 shard form {shape} over {world} ranks (block cuts "
                f"{cuts}): {launched} launches, bitwise the whole-tensor "
                f"launch, max_abs_err {err:.3e} against plain; moved-shard "
                f"control differs")
            del shards, st, moved
        if len(shape) == 2:
            cuts = [0, p0.numel() // 2048 // 2, p0.numel() // 2048]
            p = p0.clone()
            shards = k8_shards(k8, p, cuts)
            ms = timer(lambda: k8_by_shards(k8, p, gr, shards))
            pp = p0.clone()
            shards_p = k8_shards(k8, pp, cuts)
            plain_ms = timer(lambda: k8_by_shards(k8, pp, gr, shards_p,
                                                  plain=True), iters=5)
            n, nb = p0.numel(), p0.numel() // 2048
            bms, by = bound(16 * n + 16 * nb, 0, BF16_FLOPS)
            row = {"name": "adamw8bit_shard", "route": "cuda",
                   "source": "paddle_tpu_torch/csrc/adamw8bit.cu",
                   "replaces":
                       "paddle_tpu/ops/pallas/fused_optimizer_update.py:173",
                   "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                   "bound_by": by, "library_ms": None,
                   "shape": f"{shape[0]}x{shape[1]} bf16 + f32 master, two "
                            f"ZeRO shards of {nb // 2} blocks"}
            log(f"K8 shard form, 2 shards of {shape}: kernel_ms {ms:.4f} "
                f"plain_ms {plain_ms:.4f} bound_ms {bms:.4f} ({by})")
            del p, pp, shards, shards_p
        del p0, gr, whole, st_whole, plain, st_plain
    torch.cuda.empty_cache()
    row["max_abs_err"] = err
    return row


def dp_launch(mode, nproc, devices, out_dir, timeout, child="--dp-child",
              tag="9c"):
    """Run ``child mode`` (``--dp-child``: phase 9c, ``--tp-child``: 9d) on
    ``nproc`` ranks through the port's launcher; returns each rank's JSON.
    Raises with the logs' tails when a rank fails (the launcher stops the
    others)."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(out_dir, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=root)
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node", str(nproc), "--devices", devices,
           "--log_dir", out_dir, os.path.abspath(__file__), child,
           mode, out_dir]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                          text=True, timeout=timeout)
    tails = "".join(
        f"\n-- rank {r}:\n" + open(f"{out_dir}/workerlog.{r}").read()[-4000:]
        for r in range(nproc) if os.path.exists(f"{out_dir}/workerlog.{r}"))
    if proc.returncode != 0:
        raise RuntimeError(f"{tag}-{mode} failed ({proc.returncode}): "
                           f"{proc.stderr[-4000:]}{tails}")
    for r in range(nproc):
        for line in open(f"{out_dir}/workerlog.{r}").read().splitlines():
            if line.startswith(tag):
                log(line)
    log(f"{tag}-{mode}: {nproc} ranks in {time.perf_counter() - t0:.1f}s "
        f"(launcher, process start and build load included)")
    return [json.load(open(f"{out_dir}/rank{r}.json"))
            for r in range(nproc)]


def _dp_model(torch, cfg, place, opt_cls, device):
    """The seed's 2-layer model, its AdamW8bit and the placement's
    wrapping: (model to step, the inner model, the optimizer, the plan)."""
    from paddle_tpu_torch.distributed import (DataParallel,
                                              group_sharded_parallel)
    from paddle_tpu_torch.models.llama import LlamaForCausalLM

    m = LlamaForCausalLM(cfg, seed=SEED, device=device)
    opt = opt_cls(learning_rate=DP_LR, parameters=m.parameters())
    model = m
    if place == "dp":
        model = DataParallel(m)
    elif place != "single":
        model, opt, _ = group_sharded_parallel(m, opt, place)
    return model, m, opt, getattr(model, "_zero_plan", None)


def _dp_step(torch, kernels, cfg, place, inputs, labels, *, control=None,
             device="cuda"):
    """One ``TrainStep`` of the 2-layer model at ``place``: its loss, the
    reduced gradients the optimizer took, launches, step ms, the exposed
    flush ms (``finish``: from backward's end until every flush landed),
    peak memory, optimizer-state bytes. ``control``: "local means" (the
    loss divides by this rank's own count: ``count_group`` dropped), "drop
    last bucket". On the CPU (a rehearsal) no kernel launches and nothing
    is timed."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.ops.kernels import fusion
    from paddle_tpu_torch.optimizer import AdamW8bit

    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    model, m, opt, plan = _dp_model(torch, cfg, place, AdamW8bit, device)
    loss_fn = m.loss
    if control == "local means":
        def loss_fn(o, lb, count_group=None):
            return m.loss(o, lb)
    step = TrainStep(model, loss_fn, opt)
    red = getattr(model, "_grad_reducer", None)
    seen, flush_ms = {}, []
    inner_step = opt.step

    def recording_step(*, grads=None):
        seen.update(grads if grads is not None else
                    {n: p.grad for n, p in m.named_parameters()})
        inner_step(grads=grads)

    opt.step = recording_step
    if red is not None:
        finish = red.finish

        def timed_finish():
            sync()
            t = time.perf_counter()
            out = finish()
            sync()
            flush_ms.append((time.perf_counter() - t) * 1e3)
            return out

        red.finish = timed_finish
    if control == "drop last bucket":
        flush = red._flush

        def dropping(b, grads=None):
            if b is red._buckets[-1]:
                b.flushed = True
                return
            flush(b, grads)

        red._flush = dropping
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t = time.perf_counter()
    loss = step(inputs, labels)
    sync()
    step_ms = (time.perf_counter() - t) * 1e3
    counts = kernels.launch_counts()
    names = [n for n, _ in m.named_parameters()]
    if control == "drop last bucket":
        for n, p in m.named_parameters():   # its local gradients stay
            seen.setdefault(n, p.grad)
    owned = (len(names) if plan is None else
             sum(1 for n in names if plan.layouts[n].hi > plan.layouts[n].lo))
    want = fusion.train_kernel_launches_per_step(
        cfg.num_hidden_layers, len(names), recompute=cfg.recompute,
        granularity=cfg.recompute_granularity,
        fused_head_loss=cfg.fused_head_loss)
    want["adamw8bit"] = owned
    expected = dict.fromkeys(counts, 0)
    expected.update(want if cuda else {})
    state_bytes = sum(t.numel() * t.element_size()
                      for st in opt._state.values() for t in st.values())
    return {"loss": loss.item(), "loss_bits": loss.float().view(
                torch.int32).item(), "grads": seen, "counts": counts,
            "expected": expected, "step_ms": step_ms,
            "flush_ms": flush_ms[0] if flush_ms else None,
            "max_memory_allocated_gib":
                torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0,
            "state_bytes": state_bytes, "model": m, "opt": opt,
            "plan": plan}


def _gather0(torch, plan, name, t, per_block):
    """Every rank's shard ``t`` of ``name`` (``per_block`` elements a
    quantization block) onto rank 0, in the full flat layout (padded to
    whole segments; gloo moves float8 as bytes); None elsewhere."""
    import torch.distributed as dist

    lay = plan.layouts[name]
    seg = lay.seg // 2048 * per_block
    dtype = t.dtype
    t = t.view(torch.uint8) if dtype == torch.float8_e4m3fn else t
    buf = torch.zeros(seg, dtype=t.dtype, device=t.device)
    buf[:t.numel()] = t.reshape(-1)
    root = plan.group.rank == 0
    parts = [torch.empty_like(buf) for _ in range(plan.group.nranks)] \
        if root else None
    dist.gather(buf, parts, dst=plan.group.ranks[0],
                group=plan.group.process_group)
    return torch.cat(parts).view(dtype) if root else None


def _as_bytes(torch, t):
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def dp_checks(torch, k8, cfg, run, refs, rank, device, bitwise):
    """Tensor by tensor (the card holds two ranks): each reduced gradient
    (shards gathered onto rank 0) against phase 8's references, and, with
    ``bitwise``, the sharded step's parameters, codes and scales (gathered
    onto rank 0) against rank 0's unsharded K8 step of the seed's
    parameters on the same gradient, plus the moved-shard control on the
    first tensor of 3 to 2048 blocks (a k_proj at full width). Returns
    (the worst kernel/plain
    ratio, the tensors that differ, whether the control differed) on rank
    0, Nones elsewhere."""
    from paddle_tpu_torch.models.llama import LlamaForCausalLM

    plan, opt = run["plan"], run["opt"]
    fresh = (dict(LlamaForCausalLM(cfg, seed=SEED, device=device)
                  .named_parameters()) if bitwise and rank == 0 else None)
    worst, bad, control = 0.0, [], None

    def rel(a, b):
        return ((a.float() - b).norm() / b.norm()).item()

    for n, p in run["model"].named_parameters():
        g = run["grads"][n]
        if plan is not None and plan.stage >= 2:
            g = _gather0(torch, plan, n, g, 2048)
        if rank == 0:
            g = g.reshape(-1)[:plan.layouts[n].numel if plan else g.numel()]
            plain, f32 = refs[0][n], refs[1][n]
            worst = max(worst, rel(g.view(f32.shape), f32)
                        / max(rel(plain, f32), 1e-30))
        if not bitwise:
            continue
        st = opt._state.get(n)
        got = {"param": _gather0(torch, plan, n, plan.param_shard(n, p), 2048)}
        for k, per in (("m_q", 2048), ("v_q", 2048), ("m_s", 1),
                       ("v_s", 1)):
            t = st[k] if st is not None else torch.zeros(
                0, dtype=torch.float8_e4m3fn if per == 2048 else
                torch.float32, device=device)
            got[k] = _gather0(torch, plan, n, t, per)
        if rank != 0:
            continue
        p0 = fresh[n].detach()
        ref_st = k8.init_state(p0, master=True)
        nb = ref_st["m_s"].numel()
        # the control on the first tensor of 3 to 2048 blocks (k_proj)
        moved = (p0.clone() if control is None and 3 <= nb <= 2048
                 else None)
        ref_p = p0.clone()
        k8.adamw8bit_update(ref_p, g.view(p0.shape), ref_st, DP_LR, 1,
                            **DP_OPT_KW)
        same = torch.equal(got["param"][:p0.numel()], ref_p.view(-1)) and \
            all(torch.equal(_as_bytes(torch, got[k][:ref_st[k].numel()]),
                            _as_bytes(torch, ref_st[k]))
                for k in ("m_q", "v_q", "m_s", "v_s"))
        if not same:
            bad.append(n)
        if moved is not None:
            shards = k8_shards(k8, moved, [0, nb // 2, nb], shift=1)
            k8_by_shards(k8, moved, g, shards)
            control = not (torch.equal(moved.view(-1), ref_p.view(-1))
                           and _k8_state_equal(
                               torch, {"m_q": k8_gathered(torch, shards)[
                                   "m_q"]}, ref_st))
            del shards
        fresh[n].data = torch.empty(0, dtype=p0.dtype, device=device)
        del p0, ref_p, ref_st, moved, got
    if rank != 0:
        return None, None, None
    return worst, bad, control


def dp_child(mode, out_dir, rehearse=False) -> int:
    """One rank of phase 9c (``--dp-child``): 9c-a (one rank, NCCL) runs
    the plain ``TrainStep`` and every placement on phase 8's B=1 batch
    and holds the placements to it bitwise; 9c-b (two ranks on one card,
    gloo) runs phase 8's masked B=2 batch, row r on rank r, holds the
    reduced gradients to the f32 reference with phase 8's rule (two
    controls must fail it) and the sharded steps to rank 0's unsharded K8
    step bitwise. ``rehearse``: the same on the CPU at tiny widths (S 32,
    f32, ``--rehearse``), where the plain versions run, nothing is counted
    and the error rule is printed, not asserted."""
    import torch
    import torch.distributed as dist

    from paddle_tpu_torch.distributed import init_parallel_env
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.kernels import fused_optimizer_update as k8

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    t_child = time.perf_counter()
    device = "cpu" if rehearse else "cuda"
    init_parallel_env(backend="gloo" if mode == "b" else None,
                      device="cpu" if rehearse else None)
    rank, world = dist.get_rank(), dist.get_world_size()
    cfg, ts = train_config(2), TS
    if rehearse:
        from paddle_tpu_torch.models.llama import LlamaConfig

        cfg, ts = LlamaConfig.tiny(
            recompute=True, recompute_granularity="core_attn",
            fused_head_loss=True, loss_chunk_size=24), 32
    result = {"rank": rank, "world": world,
              "backend": dist.get_backend()}
    if mode == "a":
        g = torch.Generator(device=device).manual_seed(SEED + 23)
        ids = torch.randint(0, cfg.vocab_size, (1, ts), generator=g,
                            device=device)
        ref = _dp_step(torch, kernels, cfg, "single", ids, ids,
                       device=device)
        want = {n: p.detach().clone()
                for n, p in ref["model"].named_parameters()}
        want_st = {n: {k: v.clone() for k, v in st.items()}
                   for n, st in ref["opt"]._state.items()}
        assert ref["counts"] == ref["expected"], (ref["counts"],
                                                  ref["expected"])
        del ref["model"], ref["opt"], ref["grads"]
        gc.collect()
        result["single"] = {k: v for k, v in ref.items() if k != "plan"}
        for place in DP_PLACEMENTS:
            run = _dp_step(torch, kernels, cfg, place, ids, ids,
                           device=device)
            plan = run["plan"]
            diff = []
            for n, p in run["model"].named_parameters():
                full = plan.full_param(n) if plan is not None else p.detach()
                if not torch.equal(full.view(-1), want[n].view(-1)):
                    diff.append(n + ".param")
                for k, v in run["opt"]._state[n].items():
                    a, b = v, want_st[n][k].view(-1)
                    if a.dtype == torch.float8_e4m3fn:
                        a, b = a.view(torch.uint8), b.view(torch.uint8)
                    if not torch.equal(a.view(-1), b.view(-1)):
                        diff.append(f"{n}.{k}")
            same_loss = run["loss_bits"] == ref["loss_bits"]
            print(f"9c-a {place} (at {time.perf_counter() - t_child:.1f}s): "
                  f"step-1 loss {run['loss']:.6f} "
                  f"{'bitwise' if same_loss else 'DIFFERS'}, tensors "
                  f"differing {len(diff)} {diff[:4]}, launches "
                  f"{run['counts']} (plan {run['counts'] == run['expected']}"
                  f"), step_ms {run['step_ms']:.1f}, flush_ms "
                  f"{run['flush_ms']}", flush=True)
            assert same_loss and not diff, (place, run["loss"],
                                            ref["loss"], diff)
            assert run["counts"] == run["expected"], (place, run["counts"],
                                                      run["expected"])
            result[place] = {k: v for k, v in run.items() if k not in (
                "model", "opt", "grads", "plan")}
            del run
            gc.collect()
            torch.cuda.empty_cache()
    else:
        result.update(_dp_child_b(torch, kernels, k8, cfg, rank, ts,
                                  device, t_child))
    with open(f"{out_dir}/rank{rank}.json", "w") as f:
        json.dump(result, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _dp_child_b(torch, kernels, k8, cfg, rank, ts, device, t_child):
    """9c-b on one rank (see ``dp_child``)."""
    import dataclasses as dc

    import torch.distributed as dist

    from paddle_tpu_torch.models.llama import LlamaForCausalLM

    g = torch.Generator(device=device).manual_seed(SEED + 27)
    ids = torch.randint(0, cfg.vocab_size, (2, ts), generator=g,
                        device=device)
    real = GRAD_PAD_REAL * ts // TS
    mask = torch.arange(ts, device=device)[None, :] >= torch.tensor(
        [0, ts - real], device=device)[:, None]
    ids = ids.masked_fill(~mask, 0)
    labels = ids.masked_fill(~mask, -100)
    mine = slice(rank, rank + 1)
    out, refs = {}, None
    if rank == 0:
        # phase 8's references of the global batch: plain bf16 and plain f32
        model = LlamaForCausalLM(cfg, seed=SEED, device=device).train()
        plain = _masked_loss_and_grads(torch, model, ids, mask, labels,
                                       plain=True)[2]
        m32 = LlamaForCausalLM(dc.replace(cfg, dtype="float32"),
                               seed=SEED, device=device).train()
        with torch.no_grad():
            for (_, p32), (_, p) in zip(m32.named_parameters(),
                                        model.named_parameters()):
                p32.copy_(p.float())
        del model
        gc.collect()
        torch.cuda.empty_cache()
        f32 = _masked_loss_and_grads(torch, m32, ids, mask, labels,
                                     plain=True)[2]
        del m32
        torch.cuda.empty_cache()
        refs = (plain, f32)
        print(f"9c-b rank 0: phase 8's references of the global batch at "
              f"{time.perf_counter() - t_child:.1f}s", flush=True)
    dist.barrier()

    inputs = ((ids[mine], mask[mine]), labels[mine])
    runs = [(p, None) for p in DP_PLACEMENTS] + [
        ("dp", "local means"), ("dp", "drop last bucket")]
    for place, control in runs:
        label = place if control is None else f"{place} {control}"
        run = _dp_step(torch, kernels, cfg, place, *inputs, control=control,
                       device=device)
        rec = {k: run[k] for k in ("loss", "counts", "expected", "step_ms",
                                   "flush_ms", "max_memory_allocated_gib",
                                   "state_bytes")}
        assert control is not None or run["counts"] == run["expected"], (
            label, run["counts"], run["expected"])
        bitwise = place != "dp" and control is None
        worst, bad, moved = dp_checks(torch, k8, cfg, run, refs, rank,
                                      device, bitwise)
        if rank == 0:
            rec["worst_ratio"] = worst
            if bitwise:
                rec["bitwise_differs"] = bad
                rec["moved_control_differs"] = moved
                assert not bad and moved, (label, bad, moved)
        print(f"9c-b rank {rank} {label} (at "
              f"{time.perf_counter() - t_child:.1f}s): loss "
              f"{rec['loss']:.6f}, "
              f"worst kernel/plain ratio {rec.get('worst_ratio')}, "
              f"bitwise {rec.get('bitwise_differs', 'n/a')}, moved "
              f"control {rec.get('moved_control_differs', 'n/a')}, "
              f"launches {run['counts']}, step_ms {rec['step_ms']:.1f}, "
              f"exposed flush ms {rec['flush_ms']}, max_memory_allocated "
              f"{rec['max_memory_allocated_gib']:.2f} GiB, optimizer "
              f"state {rec['state_bytes']} bytes", flush=True)
        out[label] = rec
        del run
        gc.collect()        # the reducer's hooks and stage 3's units hold
        torch.cuda.empty_cache()    # the model in reference cycles
        dist.barrier()
    if rank == 0 and device == "cuda":
        for place in ("dp", "os", "os_g"):
            assert out[place]["worst_ratio"] <= 2, (place, out[place])
        for ctl in ("dp local means", "dp drop last bucket"):
            assert out[ctl]["worst_ratio"] > 2, (
                f"the {ctl} control passed the rule: {out[ctl]}")
    assert device != "cuda" or out["os_g"]["state_bytes"] <= 0.55 * out[
        "dp"]["state_bytes"], (out["os_g"]["state_bytes"],
                               out["dp"]["state_bytes"])
    return out


def dp_zero(torch, kernels, k8):
    """Phase 9c: K8's shard form here, then 9c-a and 9c-b in children.
    Returns (the K8 shard row, rank 0's 9c-b os_g launches, the stats)."""
    timer = ColdTimer(torch)
    row = check_adamw8bit_shards(torch, timer, k8)
    del timer
    torch.cuda.empty_cache()
    a = dp_launch("a", 1, "0", "build/dp9c_a", 300)
    b = dp_launch("b", 2, "0,0", "build/dp9c_b", 600)
    for r in b:
        log(f"9c-b rank {r['rank']} ({r['backend']}): optimizer state "
            + ", ".join(f"{p} {r[p]['state_bytes']}" for p in DP_PLACEMENTS)
            + " bytes; max_memory_allocated "
            + ", ".join(f"{p} {r[p]['max_memory_allocated_gib']:.2f}"
                        for p in DP_PLACEMENTS) + " GiB; step ms "
            + ", ".join(f"{p} {r[p]['step_ms']:.1f}" for p in DP_PLACEMENTS)
            + "; exposed flush ms "
            + ", ".join(f"{p} {r[p]['flush_ms']}" for p in DP_PLACEMENTS))
    return row, b[0]["os_g"]["counts"], {"a": a, "b": b}


# ---------------------------------------------------------------------------
# Tensor and sequence parallelism (phase 9d): K1 and K5 at the per-rank
# shape of mp 2, then the 2-layer full-width train step in child processes
# started through the port's launcher: one rank over NCCL at mp 1 (9d-a),
# two ranks on the one card over gloo at mp 2, SP off and on (9d-b). A
# child runs ``chip_smoke.py --tp-child <a|b> <dir>`` and writes
# ``<dir>/rank<r>.json``.
# ---------------------------------------------------------------------------
TP_SHAPE = (1, TS, 16, 4, 128)    # K1/K5 per rank at mp 2: B, S, H, Hk, D
#: gloo's point-to-point path takes no CUDA tensor, so the ring products
#: cannot run on two ranks of one card; 9d-b runs the monolithic forms
TP_RING_NOTE = ("collective_matmul off: the rings' hops are point-to-point "
                "transfers, which gloo does not carry on CUDA tensors (NCCL "
                "refuses two ranks on one card)")


class _CollectiveTimer:
    """Seconds the step spends in the tensor-parallel collectives: each
    call of the port's collective helpers (``overlap._all_reduce``,
    ``_gather_dim``, ``_scatter_dim``, ``collective.all_reduce``) timed
    from a synchronize before it to one after it. gloo stages CUDA tensors
    through the host, so the device waits for each; the time is exposed."""

    def __init__(self, torch, device):
        from paddle_tpu_torch.distributed import collective, overlap

        self.sync = (torch.cuda.synchronize if device == "cuda"
                     else (lambda: None))
        self.ms = 0.0
        self.calls = 0
        self._saved = []
        for mod, name in ((overlap, "_all_reduce"), (overlap, "_gather_dim"),
                          (overlap, "_scatter_dim"),
                          (collective, "all_reduce")):
            fn = getattr(mod, name)
            self._saved.append((mod, name, fn))
            setattr(mod, name, self._timed(fn))

    def _timed(self, fn):
        def run(*a, **k):
            self.sync()
            t = time.perf_counter()
            out = fn(*a, **k)
            self.sync()
            self.ms += (time.perf_counter() - t) * 1e3
            self.calls += 1
            return out
        return run

    def restore(self):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


def _tp_model(torch, cfg, device, mp, sp=False):
    """The seed's model (train mode) cut for this rank at ``mp`` (a hybrid
    group of mp ranks)."""
    from paddle_tpu_torch.distributed import create_hybrid_group
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               apply_llama_tensor_parallel)

    m = LlamaForCausalLM(cfg, seed=SEED, device=device)
    hcg = create_hybrid_group(mp=mp)
    apply_llama_tensor_parallel(m, hcg.mesh, sequence_parallel=sp)
    return m.train(), hcg


def _tp_plan(kernels, cfg, counts, device, n_k8=0):
    """The launches of one forward + backward (+ ``n_k8`` K8 launches) of
    the unfused TRAIN plan, the plan a TP block runs, on this device's
    counters."""
    from paddle_tpu_torch.ops.kernels import fusion

    want = fusion.train_kernel_launches_per_step(
        cfg.num_hidden_layers, 0, recompute=cfg.recompute,
        granularity=cfg.recompute_granularity,
        fused_head_loss=cfg.fused_head_loss, enabled=(),
        attn_shape=TP_SHAPE[:3] + TP_SHAPE[4:])
    want["adamw8bit"] = n_k8
    expected = dict.fromkeys(counts, 0)
    expected.update(want if device == "cuda" else {})
    return expected


def _tp_adamw_step(torch, kernels, cfg, ids, device, tp):
    """One ``TrainStep`` with ``AdamW`` of the seed's 2-layer model: the
    plain step with the train fusions off (the unfused plan, the one a TP
    block runs), or ``apply_llama_tensor_parallel`` at mp 1 with the flags
    at their defaults. Returns its loss bits, gradients, parameters and
    launches."""
    from paddle_tpu_torch.framework import flags
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    if tp:
        m, _ = _tp_model(torch, cfg, device, 1)
    else:
        m = LlamaForCausalLM(cfg, seed=SEED, device=device)
    opt = AdamW(learning_rate=DP_LR, parameters=m.parameters())
    step = TrainStep(m, m.loss, opt)
    seen = {}
    inner = opt.step

    def recording_step(*, grads=None):
        seen.update({n: p.grad.detach().clone()
                     for n, p in m.named_parameters()})
        inner(grads=grads)

    opt.step = recording_step
    old = flags.get_flag("fused_train")
    flags.set_flags({"fused_train": bool(tp)})
    try:
        sync()
        kernels.reset_launch_counts()
        t = time.perf_counter()
        loss = step(ids, ids)
        sync()
        ms = (time.perf_counter() - t) * 1e3
        counts = kernels.launch_counts()
    finally:
        flags.set_flags({"fused_train": old})
    out = {"loss": loss.item(),
           "loss_bits": loss.float().view(torch.int32).item(),
           "grads": seen, "counts": counts, "step_ms": ms,
           "expected": _tp_plan(kernels, cfg, counts, device),
           "params": {n: p.detach().clone() for n, p in m.named_parameters()}}
    del m, opt, step
    gc.collect()
    return out


def _tp_child_a(torch, kernels, cfg, ids, device, t_child):
    """9d-a on one rank: ``apply_llama_tensor_parallel`` at mp 1 bitwise
    the plain step of the unfused plan; launches = that plan."""
    ref = _tp_adamw_step(torch, kernels, cfg, ids, device, tp=False)
    run = _tp_adamw_step(torch, kernels, cfg, ids, device, tp=True)
    diff = [n + ".grad" for n in ref["grads"]
            if not torch.equal(run["grads"][n], ref["grads"][n])]
    diff += [n + ".param" for n in ref["params"]
             if not torch.equal(run["params"][n], ref["params"][n])]
    same_loss = run["loss_bits"] == ref["loss_bits"]
    print(f"9d-a mp 1 (at {time.perf_counter() - t_child:.1f}s): step-1 "
          f"loss {run['loss']:.6f} {'bitwise' if same_loss else 'DIFFERS'} "
          f"the plain unfused step's, tensors differing {len(diff)} "
          f"{diff[:4]}, launches {run['counts']} (plan "
          f"{run['counts'] == run['expected']}; plain step "
          f"{ref['counts'] == ref['expected']}), step_ms {run['step_ms']:.1f}"
          f" against {ref['step_ms']:.1f}", flush=True)
    assert same_loss and not diff, (run["loss"], ref["loss"], diff)
    assert run["counts"] == run["expected"], (run["counts"],
                                              run["expected"])
    assert ref["counts"] == ref["expected"], (ref["counts"],
                                              ref["expected"])
    return {"loss": run["loss"], "bitwise": True, "counts": run["counts"],
            "step_ms": run["step_ms"], "plain_step_ms": ref["step_ms"]}


def _tp_grads(torch, kernels, cfg, ids, device, sp, control=None):
    """One forward + backward of the mp-2 model: this rank's per-token
    losses (the vocab-parallel head in f32), the loss, {name: gradient
    shard} and the launches. ``control``: "skip row all-reduce" (layer
    0's o_proj output never all-reduced), "skip sp hooks" (the norm
    weights' sequence-parallel all-reduce removed)."""
    from paddle_tpu_torch.distributed import overlap
    from paddle_tpu_torch.ops.loss_ops import cross_entropy

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    m, hcg = _tp_model(torch, cfg, device, 2, sp)
    real = overlap.matmul_ar
    if control == "skip row all-reduce":
        o_proj = m.model.layers[0].self_attn.o_proj.weight
        overlap.matmul_ar = (lambda x, w, *a, **k: x @ w if w is o_proj
                             else real(x, w, *a, **k))
    if control == "skip sp hooks":
        for h in m._sp_hooks:
            h.remove()
    try:
        sync()
        kernels.reset_launch_counts()
        t = time.perf_counter()
        hidden = m(ids)
        loss = m.loss(hidden, ids)
        loss.backward()
        sync()
        ms = (time.perf_counter() - t) * 1e3
        counts = kernels.launch_counts()
    finally:
        overlap.matmul_ar = real
    with torch.no_grad():
        logits = hidden[0, :-1].float() @ m.lm_head.weight.float()
        tok = cross_entropy(logits, ids[0, 1:], reduction="none",
                            vocab_group=hcg.get_model_parallel_group())
        del logits, hidden
    grads = {n: p.grad for n, p in m.named_parameters()}
    return {"tok": tok, "loss": loss.item(), "grads": grads, "model": m,
            "counts": counts, "ms": ms,
            "expected": _tp_plan(kernels, cfg, counts, device)}


def _tp_worst(torch, run, refs, rank):
    """Phase 8's rule on every gathered gradient and the per-token losses
    (kernel-vs-f32 relative L2 over plain-bf16-vs-f32, per tensor): the
    worst ratio on rank 0, None elsewhere."""
    from paddle_tpu_torch.models.bridge import gather_tp_params

    def rel(a, b):
        return ((a.float() - b).norm() / b.norm()).item()

    worst = 0.0
    if rank == 0:
        worst = rel(run["tok"], refs[1][0]) / max(
            rel(refs[0][0], refs[1][0]), 1e-30)
    for n, g in run["grads"].items():       # one tensor at a time
        full = gather_tp_params(run["model"], {n: g})[n]
        if rank == 0:
            worst = max(worst, rel(full, refs[1][2][n])
                        / max(rel(refs[0][2][n], refs[1][2][n]), 1e-30))
        del full
    return worst if rank == 0 else None


def _param_bytes(m):
    return sum(p.numel() * p.element_size() for p in m.parameters())


def _tp_child_b(torch, kernels, cfg, ids, rank, device, t_child):
    """9d-b on one rank (see ``tp_child``)."""
    import dataclasses as dc

    import torch.distributed as dist

    from paddle_tpu_torch.distributed import create_hybrid_group, overlap
    from paddle_tpu_torch.framework import flags
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW8bit

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    out, refs = {}, None
    if rank == 0:
        # phase 8's references of the unsharded model: plain bf16, plain f32
        model = LlamaForCausalLM(cfg, seed=SEED, device=device).train()
        plain = _loss_and_grads(torch, model, ids, plain=True)
        full_bytes = _param_bytes(model)
        m32 = LlamaForCausalLM(dc.replace(cfg, dtype="float32"),
                               seed=SEED, device=device).train()
        with torch.no_grad():
            for (_, p32), (_, p) in zip(m32.named_parameters(),
                                        model.named_parameters()):
                p32.copy_(p.float())
        del model
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        refs = (plain, _loss_and_grads(torch, m32, ids, plain=True))
        del m32
        if device == "cuda":
            torch.cuda.empty_cache()
        out["full_param_bytes"] = full_bytes
        print(f"9d-b rank 0: phase 8's references of the unsharded model at "
              f"{time.perf_counter() - t_child:.1f}s", flush=True)
    dist.barrier()
    # the ring on this group refuses, naming gloo, before any transfer
    hcg = create_hybrid_group(mp=2)
    x = torch.ones((1, 4, 8), device=device)
    try:
        overlap.matmul_ar(x, torch.ones((8, 8), device=device), hcg.mesh,
                          "mp")
        refused = "no" if device == "cuda" else "(CPU rehearsal: ran)"
    except NotImplementedError as e:
        refused = str(e)
    print(f"9d-b rank {rank}: the ring with collective_matmul on: "
          f"{refused}; {TP_RING_NOTE}", flush=True)
    assert device != "cuda" or "gloo" in refused, refused
    flags.set_flags({"collective_matmul": False})
    for label, sp, control in (("tp", False, None), ("sp", True, None),
                               ("tp skip row all-reduce", False,
                                "skip row all-reduce"),
                               ("sp skip sp hooks", True, "skip sp hooks")):
        run = _tp_grads(torch, kernels, cfg, ids, device, sp, control)
        worst = _tp_worst(torch, run, refs, rank)
        rec = {"loss": run["loss"], "counts": run["counts"],
               "expected": run["expected"], "fwd_bwd_ms": run["ms"],
               "worst_ratio": worst}
        if control is None:
            assert run["counts"] == run["expected"], (label, run["counts"],
                                                      run["expected"])
        print(f"9d-b rank {rank} {label} (at "
              f"{time.perf_counter() - t_child:.1f}s): loss "
              f"{run['loss']:.6f}, worst kernel/plain ratio {worst}, "
              f"launches {run['counts']} (plan "
              f"{run['counts'] == run['expected']}), forward + backward ms "
              f"{run['ms']:.1f}", flush=True)
        out[label] = rec
        del run
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        dist.barrier()
    if rank == 0 and device == "cuda":
        for label in ("tp", "sp"):
            assert out[label]["worst_ratio"] <= 2, (label, out[label])
        for label in ("tp skip row all-reduce", "sp skip sp hooks"):
            assert out[label]["worst_ratio"] > 2, (
                f"the {label} control passed the rule: {out[label]}")
    # one AdamW8bit step (K8 on each local shard), then one timed step
    m, hcg = _tp_model(torch, cfg, device, 2)
    step = TrainStep(m, m.loss, AdamW8bit(learning_rate=DP_LR,
                                          parameters=m.parameters()))
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    timer = _CollectiveTimer(torch, device)
    try:
        kernels.reset_launch_counts()
        loss = step(ids, ids).item()
        counts = kernels.launch_counts()
    finally:
        timer.restore()
    n_params = sum(1 for _ in m.parameters())
    expected = _tp_plan(kernels, cfg, counts, device, n_k8=n_params)
    sync()
    t = time.perf_counter()
    loss2 = step(ids, ids).item()
    sync()
    step_ms = (time.perf_counter() - t) * 1e3
    rec = {"loss": loss, "loss_2": loss2, "counts": counts,
           "expected": expected, "step_ms": step_ms,
           "collective_ms": timer.ms, "collective_calls": timer.calls,
           "max_memory_allocated_gib":
               torch.cuda.max_memory_allocated() / 2**30
               if device == "cuda" else 0.0,
           "param_bytes": _param_bytes(m)}
    assert math.isfinite(loss) and math.isfinite(loss2), (loss, loss2)
    assert counts == expected, ("adamw8bit", counts, expected)
    print(f"9d-b rank {rank} AdamW8bit (at "
          f"{time.perf_counter() - t_child:.1f}s): loss {loss:.6f} then "
          f"{loss2:.6f}, launches {counts} (plan {counts == expected}), "
          f"step_ms {step_ms:.1f} (second step), exposed collective ms "
          f"{timer.ms:.1f} over {timer.calls} calls (first step, "
          f"synchronized), max_memory_allocated "
          f"{rec['max_memory_allocated_gib']:.2f} GiB, parameter bytes "
          f"{rec['param_bytes']}", flush=True)
    out["adamw8bit"] = rec
    del m, step
    gc.collect()
    return out


def tp_child(mode, out_dir, rehearse=False) -> int:
    """One rank of phase 9d (``--tp-child``). 9d-a (one rank, NCCL):
    ``apply_llama_tensor_parallel`` at mp 1 against the plain step of the
    unfused TRAIN plan, on phase 8's B=1 batch: loss, gradients and
    parameters bitwise, launches = the plan. 9d-b (two ranks on one card,
    gloo, ``collective_matmul`` off): mp 2 with SP off and on, the
    per-token losses and every gathered gradient against rank 0's plain
    f32 run of the unsharded model on phase 8's rule, which the two
    controls must fail; launches = the plan at 16 / 4 heads; then one
    AdamW8bit step (K8 on every local shard) and a timed one.
    ``rehearse``: the same on the CPU at tiny widths (S 32, f32), where
    the plain versions run, nothing is counted and the rule is printed,
    not asserted."""
    import torch
    import torch.distributed as dist

    from paddle_tpu_torch.distributed import init_parallel_env
    from paddle_tpu_torch.ops import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    t_child = time.perf_counter()
    device = "cpu" if rehearse else "cuda"
    init_parallel_env(backend="gloo" if mode == "b" else None,
                      device="cpu" if rehearse else None)
    rank = dist.get_rank()
    cfg, ts = train_config(2), TS
    if rehearse:
        from paddle_tpu_torch.models.llama import LlamaConfig

        cfg, ts = LlamaConfig.tiny(
            recompute=True, recompute_granularity="core_attn",
            fused_head_loss=True, loss_chunk_size=24), 32
    g = torch.Generator(device=device).manual_seed(SEED + 23)
    ids = torch.randint(0, cfg.vocab_size, (1, ts), generator=g,
                        device=device)
    result = {"rank": rank, "world": dist.get_world_size(),
              "backend": dist.get_backend()}
    if mode == "a":
        result.update(_tp_child_a(torch, kernels, cfg, ids, device, t_child))
    else:
        result.update(_tp_child_b(torch, kernels, cfg, ids, rank, device,
                                  t_child))
    result["child_s"] = time.perf_counter() - t_child
    with open(f"{out_dir}/rank{rank}.json", "w") as f:
        json.dump(result, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def tp_sp(torch, kernels, k1):
    """Phase 9d: K1 and K5 at mp 2's per-rank shape here (SDPA beside
    them), then 9d-a and 9d-b in children. Returns (the K1 and K5 rows,
    rank 0's 9d-b launches with SP off, the stats)."""
    t0 = time.perf_counter()
    timer = ColdTimer(torch)
    rows = check_flash_bwd(torch, timer, k1, shape=TP_SHAPE, suffix="_tp")
    del timer
    torch.cuda.empty_cache()
    log(f"9d: {TP_RING_NOTE}")
    a = dp_launch("a", 1, "0", "build/tp9d_a", 300, child="--tp-child",
                  tag="9d")
    b = dp_launch("b", 2, "0,0", "build/tp9d_b", 600, child="--tp-child",
                  tag="9d")
    full = b[0]["full_param_bytes"]
    for r in b:
        st = r["adamw8bit"]
        log(f"9d-b rank {r['rank']} ({r['backend']}): step_ms "
            f"{st['step_ms']:.1f}, exposed collective ms "
            f"{st['collective_ms']:.1f}, max_memory_allocated "
            f"{st['max_memory_allocated_gib']:.2f} GiB, parameter bytes "
            f"{st['param_bytes']} = {st['param_bytes'] / full:.3f} x the "
            f"unsharded model's {full} (a DataParallel rank holds all of "
            f"them)")
    seconds = time.perf_counter() - t0
    log(f"9d: {seconds:.1f}s (kernel rows, 9d-a and 9d-b)")
    return rows, b[0]["tp"]["counts"], {"a": a, "b": b, "seconds": seconds}


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


#: the LoRA delta's K13 shapes (phase 3): the shrink x (T, K) @ A (G, K,
#: 16) at K 4096 (q, k, v, gate, up, o) and 14336 (down), the expand u (T,
#: 16) @ B (G, 16, N) at N 1024 (k, v), 4096 (q, o, down), 14336 (gate,
#: up); T 264 (a wave) and 8 (a segment step)
LORA_KN = ((4096, LORA_RANK), (14336, LORA_RANK), (LORA_RANK, 1024),
           (LORA_RANK, 4096), (LORA_RANK, 14336))
#: rows per group of the two routings: a wave's three adapters, the base
#: group (the last) with the rest and the padding rows, five slots empty;
#: a segment step's one row a slot
LORA_ROWS = {264: (61, 0, 0, 47, 0, 0, 33, 0, 123),
             8: (2, 0, 0, 2, 0, 0, 1, 0, 3)}


def host_call_us(torch, fn, n=100):
    """The host's time a call of ``fn`` in a loop of ``n`` (the device
    idle at the start): where the device is faster, the enqueue rate."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return host


def check_grouped_matmul_lora(torch, timer, gm):
    """K13 at the LoRA delta's shapes (LORA_KN, G = LORA_G, T 264 and 8,
    LORA_ROWS): each element within ``gm.tolerance`` of the plain
    version, two calls bitwise equal, and a fault control that must fail
    the tolerance: the plain version with one row moved into the next
    group. Bound: the bytes of x, the output and the weights of the groups
    with rows; library: ``torch._grouped_mm``."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 40)
    rows = []
    for t, counts in LORA_ROWS.items():
        assert sum(counts) == t and len(counts) == LORA_G
        off = torch.tensor([0, *itertools.accumulate(counts)],
                           dtype=torch.int32, device="cuda")
        bad = off.clone()
        bad[1] -= 1                   # group 0's last row into group 1
        live = sum(1 for c in counts if c)
        for kdim, n in LORA_KN:
            x = (torch.randn((t, kdim), generator=g, device="cuda")
                 ).to(torch.bfloat16)
            w = (torch.randn((LORA_G, kdim, n), generator=g, device="cuda")
                 * kdim ** -0.5).to(torch.bfloat16)
            got = gm.gmm(x, off, w)
            ref = gm.grouped_matmul_reference(x, off, w)
            torch.cuda.synchronize()
            tol = gm.tolerance(x, off, w, ref)
            diff = (got.float() - ref.float()).abs()
            worst, err = (diff / tol).max().item(), diff.max().item()
            ctl = ((gm.grouped_matmul_reference(x, bad, w).float()
                    - ref.float()).abs() / tol).max().item()
            assert worst < 1.0, f"K13 LoRA T{t} K{kdim} N{n}: {worst}"
            assert ctl > 1.0, f"K13 LoRA T{t}: the moved-row control {ctl}"
            assert _same_bits(torch, lambda: (gm.gmm(x, off, w),)), (
                f"K13 LoRA T{t} K{kdim} N{n}: two calls differ")
            ends = off[1:].contiguous()
            wl = w.transpose(1, 2).contiguous().transpose(1, 2)
            lib_fn, why = _library(torch, lambda: torch._grouped_mm(
                x, wl, offs=ends), ref, tol, f"LoRA T{t} K{kdim} N{n}")
            ms = timer(lambda: gm.gmm(x, off, w))
            plain = timer(lambda: gm.grouped_matmul_reference(x, off, w),
                          iters=5)
            lib = timer(lib_fn) if lib_fn else None
            host_us = host_call_us(torch, lambda: gm.gmm(x, off, w))
            flops = 2 * t * kdim * n
            nbytes = 2 * (x.numel() + live * kdim * n + t * n) + 4 * (
                LORA_G + 1)
            bms, by = bound(nbytes, flops, BF16_FLOPS)
            name = f"grouped_matmul_lora_t{t}_k{kdim}_n{n}"
            log(f"K13 LoRA T{t} K{kdim} N{n} G{LORA_G} rows {counts}: "
                f"max_abs_err {err:.3e} worst err/tol {worst:.3f} "
                f"(moved-row control {ctl:.1f}) kernel_ms {ms:.4f} (bound "
                f"share {bms / ms:.3f}) plain_ms {plain:.4f} library_ms "
                f"{lib if lib is None else round(lib, 4)} "
                f"({'torch._grouped_mm' if lib_fn else why}) bound_ms "
                f"{bms:.4f} ({by}); host {host_us:.1f} us a call; two calls "
                f"bitwise equal")
            rows.append({"name": name, "route": "cuda",
                         "source": "paddle_tpu_torch/csrc/grouped_matmul.cu",
                         "replaces":
                             "paddle_tpu/ops/pallas/grouped_matmul.py:200",
                         "max_abs_err": err, "worst_err_over_tol": worst,
                         "control_err_over_tol": ctl, "ms": ms,
                         "plain_ms": plain, "bound_ms": bms, "bound_by": by,
                         "library_ms": lib,
                         "library_note": ("torch._grouped_mm" if lib_fn
                                          else f"none: {why}"),
                         "bitwise_repeat": True, "host_us": host_us,
                         "shape": f"T{t} K{kdim} N{n} G{LORA_G} rows "
                                  f"{counts}"})
            del x, w, got, ref, tol, diff, wl
        torch.cuda.empty_cache()
    return rows


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
    mlp = moe.MoEMLP(cfg, dtype=torch.bfloat16, device=torch.device("cuda"),
                     gen=torch.Generator(device="cuda").manual_seed(SEED + 31))
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
    mlp = moe.MoEMLP(cfg, dtype=torch.bfloat16, device=torch.device("cuda"),
                     gen=torch.Generator(device="cuda").manual_seed(SEED + 31))
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

    t_start = time.perf_counter()
    phase_s = {}

    def mark(name):
        """Seconds since the start at the end of each phase group."""
        phase_s[name] = round(time.perf_counter() - t_start, 1)

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
    # the "batcher prefix" rows: each form on the table-routed pool; the
    # int8 unfused forms' launches come from phase 6b (phase 6d serves
    # int8 in the fused plan only)
    for int8 in (False, True):
        pre = "batcher prefix int8" if int8 else "batcher prefix"
        unfused = ("batcher int8 unfused attention" if int8
                   else "batcher prefix unfused attention")
        own += [(check_ragged_prefix(torch, timer, k11, kv_cache,
                                     _rope_tables, int8), unfused),
                (check_ragged_prefix(torch, timer, k3, kv_cache,
                                     _rope_tables, int8), f"{pre} fused"),
                (check_paged_attention(torch, timer, k10, kv_cache,
                                       _rope_tables, int8=int8,
                                       routed=True), unfused),
                (check_rope_attend_masked(torch, timer, k3, kv_cache,
                                          _rope_tables, int8=int8,
                                          routed=True), f"{pre} fused")]
    # K13 at the LoRA delta's shapes: its launches come from phase 6f
    own += [(row, "batcher lora fused")
            for row in check_grouped_matmul_lora(torch, timer, k1314)]
    del timer
    torch.cuda.empty_cache()
    mark("1-3 build and kernels")

    # ---- 4. serving (bf16), 5. int8w+int8kv, 6. continuous batching,
    # 6b. the int8w+int8kv batcher; each path's counts are set to 0 just
    # before its counted run and read just after
    profile = "--profile" in sys.argv
    counts, counts_spec, stats = serve(torch, kernels, profile=profile)
    torch.cuda.empty_cache()
    mark("4, 4c, 4d solo bf16")
    counts_int8, counts_int8_spec, stats_int8 = serve_int8(
        torch, kernels, profile=profile)
    torch.cuda.empty_cache()
    mark("5 solo int8")
    stats_batcher = serve_batcher(torch, kernels, profile=profile)
    torch.cuda.empty_cache()
    mark("6, 6c, 6e, 6f batcher bf16")
    stats_batcher_int8 = serve_batcher(torch, kernels, profile=profile,
                                       int8=True)
    torch.cuda.empty_cache()
    mark("6b, 6c, 6f batcher int8")
    # ---- 6d. the batcher with the reference's defaults: prefix cache,
    # host tier, unified arena (bf16 in both plans, int8w+int8kv fused)
    stats_prefix = serve_batcher_prefix(torch, kernels, profile=profile)
    torch.cuda.empty_cache()
    stats_prefix_int8 = serve_batcher_prefix(torch, kernels,
                                             profile=profile, int8=True)
    torch.cuda.empty_cache()
    mark("6d batcher defaults")
    # ---- 6g. the serving fleet: two replicas on one card, failover and
    # disaggregated prefill/decode with live KV migration
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    fleet_model = LlamaForCausalLM(LlamaConfig.llama3_8b(dtype="bfloat16"),
                                   seed=SEED, device="cuda")
    stats_fleet = serve_fleet(torch, kernels, model=fleet_model)
    torch.cuda.empty_cache()
    mark("6g fleet")
    # ---- 6h. the autoscaled fleet under trace-driven load on 6g's model
    stats_autoscale = serve_autoscale(torch, kernels, model=fleet_model)
    del fleet_model
    torch.cuda.empty_cache()
    mark("6h autoscaled fleet")

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
    # ---- 7b. quantized weights under autograd (its counts set to 0 just
    # before each form's counted forward + backward and read just after)
    stats_quant_train = train_quant(torch, kernels, k2, k4)
    torch.cuda.empty_cache()
    mark("7b quantized train")
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
    mark("7-9 train")

    # ---- 9b. the fine-tuning cell (its counts set to 0 just before its
    # counted steps and read just after)
    counts_sft, stats_sft = sft_train(torch, kernels, profile=profile)
    stats_sft["grad_check_masked"] = masked_check
    log(f"sft step (K9, key bias) {stats_sft['step_ms']:.1f} ms against "
        f"the train step (K5, no mask) {stats_train['step_ms']:.1f} ms; "
        f"peak {stats_sft['max_memory_allocated_gib']:.2f} against "
        f"{stats_train['max_memory_allocated_gib']:.2f} GiB")
    torch.cuda.empty_cache()
    mark("9b fine-tuning")

    # ---- 9c. data parallelism and ZeRO: K8's shard form here, then the
    # 2-layer step on one rank (NCCL) and on two ranks of this card (gloo),
    # children of the port's launcher (each child's counts set to 0 just
    # before its counted step and read just after)
    row_k8_shard, counts_dp, stats_dp = dp_zero(torch, kernels, k8)
    own.append((row_k8_shard, "dp zero os_g rank 0"))
    torch.cuda.empty_cache()
    mark("9c data parallel and ZeRO")

    # ---- 9d. tensor and sequence parallelism: K1 and K5 at mp 2's per-rank
    # shape here, then the 2-layer step at mp 1 (NCCL) and at mp 2 on two
    # ranks of this card (gloo), children of the port's launcher (each
    # child's counts set to 0 just before its counted run and read just
    # after)
    rows_tp, counts_tp, stats_tp = tp_sp(torch, kernels, k1)
    own += [(row, "tp 9d-b rank 0") for row in rows_tp]
    torch.cuda.empty_cache()
    mark("9d tensor and sequence parallel")

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
             **{f"batcher prefix {label}": stats_prefix[label]["launches"]
                for label, _ in BATCHER_PLANS},
             "batcher prefix int8 fused":
                 stats_prefix_int8["fused"]["launches"],
             "batcher lora fused": stats_batcher["fused"]["lora"]["launches"],
             "batcher fleet failover fused":
                 stats_fleet["failover"]["launches"],
             "batcher fleet disagg fused": stats_fleet["disagg"]["launches"],
             "batcher fleet autoscaled fused": stats_autoscale["launches"],
             **{f"train quantized {label}":
                stats_quant_train[label]["launches"]
                for label, _, _ in QUANT_TRAIN_FORMS},
             "batcher int8 lora fused":
                 stats_batcher_int8["fused"]["lora"]["launches"],
             "train": counts_train, "moe train": counts_moe,
             **counts_quant,
             "grad check split, mask": counts_grad_split, "sft": counts_sft,
             "dp zero os_g rank 0": counts_dp, "tp 9d-b rank 0": counts_tp}
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
               **{f"{n}{q}_prefix": c for q in ("", "_int8")
                  for n, c in (
                      ("ragged_paged_attention", "ragged_paged_attention"),
                      ("rope_append_attend_ragged",
                       "fused_rope_attend_ragged"),
                      ("paged_attention", "paged_attention"),
                      ("rope_append_attend_masked", "fused_rope_attend"))},
               "flash_attention_bwd": "flash_attention_bwd",
               "flash_attention_fwd_train_tp": "flash_attention",
               "flash_attention_bwd_tp": "flash_attention_bwd",
               "rms_norm_fwd": "rms_norm_fwd",
               "rms_norm_bwd": "rms_norm_bwd",
               "adamw8bit": "adamw8bit", "adamw8bit_shard": "adamw8bit",
               "grouped_matmul": "grouped_matmul",
               "grouped_matmul_down": "grouped_matmul",
               "grouped_matmul_dx": "grouped_matmul",
               "grouped_matmul_int8": "grouped_matmul_quant",
               "grouped_matmul_int4": "grouped_matmul_quant",
               **{f"grouped_matmul_lora_t{t}_k{kd}_n{n}": "grouped_matmul"
                  for t in LORA_ROWS for kd, n in LORA_KN},
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

    for label, st in (*((f"bf16 {k}", v) for k, v in stats_prefix.items()),
                      *((f"int8w+int8kv {k}", v)
                        for k, v in stats_prefix_int8.items())):
        log(f"batcher prefix {label}, prefix_caching on against off (this "
            f"run, phase 6d's requests): wall {st['on']['wall_s']:.3f} "
            f"against {st['off']['wall_s']:.3f} s, "
            f"{st['on']['generated_tok_s']:.1f} against "
            f"{st['off']['generated_tok_s']:.1f} generated tok/s; "
            f"prefill_tokens_admitted (counted run) "
            f"{st['prefill_tokens_admitted']}, prefetch_stall_ms "
            f"{st['prefetch_stall_ms']:.3f}, offload_stall_ms "
            f"{st['offload_stall_ms']:.3f}, max_memory_allocated "
            f"{st['max_memory_allocated_gib']:.2f} GiB, host arena "
            f"{st['host_arena_pinned_bytes']} bytes pinned")

    mark("10-12 MoE")
    log(f"seconds since the start at the end of each phase group: "
        f"{phase_s}")
    log(f"max_memory_allocated while training: Llama "
        f"{stats_train['max_memory_allocated_gib']:.2f} GiB, fine-tuning "
        f"{stats_sft['max_memory_allocated_gib']:.2f} GiB, MoE "
        f"{stats_moe['max_memory_allocated_gib']:.2f} GiB")

    # ---- 13. result
    log(json.dumps({"serving": stats, "serving_int8w_int8kv": stats_int8,
                    "serving_batcher": stats_batcher,
                    "serving_batcher_int8w_int8kv": stats_batcher_int8,
                    "serving_batcher_prefix": stats_prefix,
                    "serving_batcher_prefix_int8w_int8kv": stats_prefix_int8,
                    "serving_fleet": stats_fleet,
                    "serving_fleet_autoscaled": stats_autoscale,
                    "train_quantized": stats_quant_train,
                    "train": stats_train, "sft": stats_sft,
                    "moe_train": stats_moe, "data_parallel_zero": stats_dp,
                    "tensor_sequence_parallel": stats_tp,
                    "moe_quantized_experts": stats_quant}))
    log(json.dumps({"kernels": rows}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 3 and sys.argv[1] == "--dp-child":
        sys.exit(dp_child(sys.argv[2], sys.argv[3],
                          rehearse="--rehearse" in sys.argv))
    if len(sys.argv) > 3 and sys.argv[1] == "--tp-child":
        sys.exit(tp_child(sys.argv[2], sys.argv[3],
                          rehearse="--rehearse" in sys.argv))
    sys.exit(main())
