"""Runtime flags — the port's own copy of ``paddle_tpu/framework/flags.py``.

Same surface: every flag is overridable through a ``FLAGS_<name>``
environment variable and through :func:`set_flags`. Only the flags this
package reads are registered.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict

_lock = threading.Lock()
_registry: Dict[str, "_Flag"] = {}


class _Flag:
    __slots__ = ("name", "default", "value", "help", "type")

    def __init__(self, name: str, default: Any, help_str: str):
        self.name = name
        self.default = default
        self.help = help_str
        self.type = type(default)
        env = os.environ.get("FLAGS_" + name)
        self.value = self._parse(env) if env is not None else default

    def _parse(self, text: str) -> Any:
        if self.type is bool:
            return text.lower() in ("1", "true", "yes", "on")
        if self.type is int:
            return int(text)
        if self.type is float:
            return float(text)
        return text


def define_flag(name: str, default: Any, help_str: str = "") -> None:
    with _lock:
        if name not in _registry:
            _registry[name] = _Flag(name, default, help_str)


def _key(name: str) -> str:
    key = name[6:] if name.startswith("FLAGS_") else name
    if key not in _registry:
        raise ValueError(f"Unknown flag: {name}")
    return key


def get_flag(name: str) -> Any:
    return _registry[_key(name)].value


def set_flags(flags: Dict[str, Any]) -> None:
    for n, v in flags.items():
        f = _registry[_key(n)]
        f.value = (f._parse(v) if isinstance(v, str) and f.type is not str
                   else f.type(v))


define_flag("fused_decode", True,
            "Decode-step op chains route through the fusion pass "
            "(ops/kernels/fusion.py): rms_norm folds into the following "
            "matmul and rope+KV-append+paged-attention collapse into one "
            "kernel. Off = the unfused op-by-op chain.")
define_flag("fused_decode_fusions", "norm_matmul,rope_append_attend",
            "Comma-separated subset of the fusion pass's patterns to "
            "enable (under fused_decode): 'norm_matmul' and/or "
            "'rope_append_attend'.")
define_flag("ragged_batching", True,
            "ContinuousBatcher admission uses token-budget scheduling: one "
            "ragged dispatch per step mixes up to prefill_chunk new prompt "
            "tokens with every active decode slot (no bucket padding, no "
            "separate prefill phase). Off = the power-of-two bucketed "
            "prefill pipeline (not ported yet: the batcher raises).")
define_flag("prefix_caching", True,
            "ContinuousBatcher admission shares already-computed prompt "
            "pages through a radix-tree prefix index over page-granular "
            "token chunks (inference/prefix_cache.py): matched pages attach "
            "to the new slot by reference (refcounted, copy-on-write on "
            "divergence) and only the unmatched suffix is prefilled. Active "
            "only with ragged_batching.")
define_flag("spec_decode", False,
            "Self-speculative decoding in the ContinuousBatcher (ragged "
            "path, greedy only): each wave verifies every decoding slot's "
            "current token plus up to spec_k drafted tokens "
            "(inference/speculative.py) and keeps the longest matching "
            "prefix plus a bonus token; tokens equal spec-off decoding.")
define_flag("spec_k", 4,
            "Draft tokens proposed per slot per speculative step (the "
            "verify segment is spec_k + 1 rows).")
define_flag("lora_serving", False,
            "Batched multi-LoRA serving in the ContinuousBatcher (ragged "
            "path, not with spec_decode): requests carry an adapter_id, "
            "every wave's rows are stably sorted by adapter slot and each "
            "adapted projection adds its low-rank delta as two grouped "
            "matmuls (K13), no per-adapter padding. Adapters live in a "
            "host-resident AdapterPool (models/lora.py) with refcounted "
            "device slots and LRU eviction.")
define_flag("lora_max_rank", 16,
            "Rank ceiling of the AdapterPool's stacked device buffers "
            "(models/lora.py): adapters register at any rank <= this and "
            "are zero-padded to it, so the grouped matmuls run at one "
            "shape.")
define_flag("lora_hbm_adapters", 8,
            "Device-resident adapter slots in the AdapterPool: a request "
            "whose adapter is not resident loads it into a free slot or "
            "over the least-recently-used unreferenced one, and admission "
            "defers (never fails) while every slot is pinned by a live "
            "request.")
define_flag("kv_host_tier", True,
            "Second KV page arena in host RAM behind the prefix cache "
            "(models/kv_cache.HostPageArena): leaf-LRU eviction demotes "
            "pages to host instead of freeing them, a match on a "
            "host-resident prefix prefetches them back, and park()/resume() "
            "move a live sequence's pages to host and back. Active only "
            "with prefix_caching.")
define_flag("kv_host_tier_pages", 0,
            "Host arena size in pages for the KV host tier; 0 = auto (4x "
            "the device page pool). Parked sequences and demoted prefix "
            "pages share this arena.")
define_flag("kv_prefetch_depth", 8,
            "Pages per host->device prefetch chunk (HostPageArena.load).")
define_flag("unified_arena", True,
            "One typed, refcounted page economy across KV pages and "
            "(reserved) draft-weight shards (models/arena.py): every class "
            "allocates against one global byte budget and a deficit "
            "steals cross-class, never below arena_class_floors. Active "
            "only with prefix_caching.")
define_flag("arena_hbm_pages", 0,
            "Unified-arena global budget, in KV-page units; 0 = auto (the "
            "KV page pool).")
define_flag("arena_class_floors", "kv=1,adapter=1,weight=0",
            "Per-class residency floors for the unified arena's steal loop "
            "('kv=1,adapter=1,weight=0').")
define_flag("arena_cost_model", False,
            "Unified-arena steal-victim scoring: ON ranks victim classes by "
            "restore cost (unit bytes) per unit of staleness, OFF by "
            "recency alone.")
define_flag("fused_train", True,
            "Training forward/backward/update routes through the fusion "
            "pass's training twin (ops/kernels/fusion.py TRAIN_CHAIN): "
            "rms_norm folds into the following matmuls (K2 per consumer, "
            "one gradient for the norm weight), the o-proj + residual add "
            "ride the attention output as epilogue ops, and the AdamW8bit "
            "update runs as one sweep (K8). Off = the unfused train plan "
            "(norms through K6/K7).")
define_flag("fused_train_fusions",
            "norm_matmul,attn_epilogue,optimizer_update,moe_grouped_bwd",
            "Comma-separated subset of the train fusion pass's families to "
            "enable (under fused_train): 'norm_matmul', 'attn_epilogue', "
            "'optimizer_update' and/or 'moe_grouped_bwd' (the MoE "
            "backward's per-expert dW through the segment-dW kernel K14, "
            "its cast riding as an epilogue op).")
define_flag("flash_bwd_impl", "split",
            "Flash-attention backward: 'split' = the dq + dkv kernels (K5); "
            "'fused' = the one-pass kernel (K9) wherever the JAX package "
            "takes its fused backward (its dQ partials within 512 MiB, "
            "flash_attention.bwd_uses_fused), K5 elsewhere.")
define_flag("flash_save_residuals", False,
            "core_attn recompute keeps the attention's (out, lse) from the "
            "first forward, so the recompute in backward skips the K1 "
            "re-run. Off (the JAX package's default) = the recompute runs "
            "the flash forward again.")
define_flag("grouped_matmul_kernel", True,
            "Grouped (segmented) matmul over expert-sorted token rows runs "
            "the grouped kernel (ops/kernels/grouped_matmul.py, K13): one "
            "grid walks per-expert contiguous row blocks described by a "
            "group_offsets vector, group boundaries handled in-kernel (no "
            "per-expert padding). Off = the plain per-expert slices, on "
            "CPU tensors only: a CUDA tensor raises.")
define_flag("moe_dropless", True,
            "MoE routing uses the sort-based dropless fast path: top-k "
            "gating -> argsort by expert id -> grouped SwiGLU through the "
            "grouped matmul -> combine by weight. Every routed token is "
            "computed (dropped_token_rate == 0 by construction); FLOPs "
            "scale with tokens actually routed. Off = the GShard "
            "dense-einsum dispatch with capacity padding and overflow "
            "drops.")
define_flag("fleet_prefix_affinity", True,
            "FleetRouter steers requests to the replica whose gossiped "
            "radix-tree page-hash digest matches the longest prefix of the "
            "request's prompt (inference/router.py), turning the per-"
            "process prefix_hit_rate into a fleet-wide one. Off = pure "
            "least-loaded routing (queue depth + active slots from the "
            "heartbeat lease).")
define_flag("fleet_tier_edges", "2.0,30.0",
            "Deadline-tier boundaries (seconds, comma-separated, "
            "ascending) for the FleetRouter's admission queues: a request "
            "whose deadline_s is <= edge k lands in tier k, everything "
            "slower (or deadline-free) in the last tier. Dispatch drains "
            "tiers in order and load shedding under fleet-wide "
            "backpressure evicts from the lowest-priority tier first.")
define_flag("fleet_digest_top_k", 32,
            "How many radix-tree page-hash entries each replica gossips "
            "in its heartbeat lease (hottest nodes first). Bounds the "
            "lease payload; 0 disables the digest (prefix-affinity "
            "routing then degrades to least-loaded).")
define_flag("fleet_disagg", False,
            "Disaggregated prefill/decode serving (inference/router.py): "
            "the FleetRouter admits new requests to prefill-specialist "
            "replicas and, once a request's prompt KV is built and it "
            "has emitted its first token, live-migrates the sequence (KV pages + scale cells + "
            "streamed-token record) to a decode specialist, which resumes "
            "it recomputing exactly one token — no re-prefill. Activates "
            "only when the fleet actually has prefill AND decode-capable "
            "roles; an explicit disagg=True on a role-less or untiered "
            "fleet raises.")
define_flag("fleet_role", "both",
            "Default replica role for FleetWorker (prefill | decode | "
            "both), gossiped on the heartbeat lease so the router can "
            "steer admission and migration without a direct engine read. "
            "'prefill' replicas take new prompts and hand streams off; "
            "'decode' replicas only receive migrated live sequences (and "
            "failover re-dispatches); 'both' serves end-to-end — the "
            "monolithic default, byte-identical to the pre-disagg fleet.")
define_flag("gray_detect_factor", 4.0,
            "Gray-failure detection sensitivity (inference/router.py): "
            "a replica is flagged as a straggler when its gossiped "
            "latency telemetry "
            "(worst of inter-token EWMA and tick-duration EWMA) exceeds "
            "this factor times the MEDIAN of its same-role healthy peers "
            "— always fleet-relative, never an absolute threshold, so the "
            "same knob works on any device. Needs >= 2 "
            "healthy same-role peers with telemetry (a 2-replica fleet "
            "has no quorum to outvote a straggler); <= 0 disables "
            "detection entirely.")
define_flag("fleet_retry_budget", 64,
            "Router-level retry budget (token bucket, inference/"
            "router.py): failover re-dispatches and quarantine "
            "evacuations each spend one token; the bucket holds this many "
            "and refills at capacity/60 per second. Exhaustion degrades "
            "honestly — failovers finish as 'replica_lost', evacuations "
            "are skipped (the stream decodes on at the slow source) — so "
            "a correlated brown-out can never amplify into a retry "
            "storm. < 0 = unlimited; 0 = no re-dispatch ever.")
define_flag("fleet_worker_stall_s", 0.0,
            "Per-tick stall injected into FleetWorker._tick (seconds; "
            "mutable live via worker.stall_s). A chaos knob: makes a "
            "replica slow-but-alive — heartbeats keep flowing, tokens "
            "crawl — which is exactly the gray failure the router's "
            "quarantine machinery must catch. 0 = off (production "
            "default).")
define_flag("fleet_min_replicas", 1,
            "Elastic-fleet floor (inference/autoscaler.py): the "
            "FleetAutoscaler never drains the fleet below this many "
            "live replicas, whatever demand says.")
define_flag("fleet_max_replicas", 4,
            "Elastic-fleet ceiling (inference/autoscaler.py): the "
            "FleetAutoscaler never spawns past this many live replicas; "
            "sustained saturation AT the ceiling is what escalates the "
            "brownout ladder instead.")
define_flag("autoscale_cooldown_s", 2.0,
            "Minimum wall time between FleetAutoscaler scale/brownout "
            "decisions (inference/autoscaler.py): a decision inside the "
            "window is counted as flap_suppressed and NOT taken, which "
            "is what makes the non-flapping property checkable — the "
            "chaos gate asserts no two scale events land closer than "
            "this.")
define_flag("brownout_ladder", True,
            "Brownout degradation ladder when the fleet is saturated at "
            "fleet_max_replicas (inference/autoscaler.py): ordered, "
            "reversible, host-side-only steps — L1 shrinks speculative-"
            "decode k toward plain decode, L2 shrinks the prefill-chunk "
            "admission budget, L3 sheds the lowest deadline tier at "
            "admission — each entered/exited on the same hysteresis "
            "that gates scaling and counted per step in health. Off = "
            "saturation at max replicas degrades the old way (queue "
            "growth, then queue-pressure shedding).")
define_flag("kv_migration_chunk_pages", 8,
            "Pages per wire chunk for KVMigrator's chunked transport "
            "(inference/migration.py): a migrating sequence's host-tier "
            "page blocks serialize to bytes and stream in chunks of this "
            "many pages — the prefetch-depth idiom applied to the "
            "cross-replica seam, bounding peak wire buffering. The "
            "in-process MemoryStore fleet uses the zero-copy handoff "
            "transport and never chunks.")
define_flag("collective_matmul", True,
            "Decompose all-gather->matmul / matmul->reduce-scatter chains "
            "into rings of point-to-point hops over the model-parallel "
            "group (distributed/overlap.py): each hop's transfer is in "
            "flight while the previous chunk's partial matmul runs. Active "
            "only on groups of size > 1 with divisible shapes; off = one "
            "monolithic collective.")
define_flag("zero_prefetch", True,
            "ZeRO stage 3: start the all-gather of decoder layer k+1's "
            "parameter shards asynchronously before layer k's forward "
            "runs (requires collective_matmul; off = gather on use).")
