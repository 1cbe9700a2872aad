"""Continuous (in-flight) batching over the paged KV cache
(``paddle_tpu/inference/continuous_batching.py``, the ragged path).

Requests are admitted into free cache slots while other sequences keep
decoding, and a finished sequence frees its slot for the next one. The
scheduler state (current token, per-slot active mask, per-slot remaining
token budget) lives on the device, so the host touches it only at the
readbacks:

  * admission — TOKEN-BUDGET RAGGED SCHEDULING: each admission step
    assigns up to ``prefill_chunk`` prompt tokens across arrivals and
    slots still mid-prefill and runs them TOGETHER with one decode row per
    active slot as ONE flat wave of T = B + prefill_chunk rows (padded to
    a multiple of 8). The per-layer attention tail of the wave is
    ``fusion.ragged_attend``: K3's ragged form, or with the
    ``rope_append_attend`` fusion off rope + ragged append + K11. No
    bucket padding, no separate prefill phase: decode slots keep emitting
    while a long prompt chunk-prefills across steps. One host readback per
    step.
  * decode segment: a Python loop of ``seg`` steps over the full slot
    batch (the JAX package's ``lax.scan``), whose attention tail is
    ``fusion.decode_attend(active=)``: K3's masked decode form, or K10.
    A slot deactivates ON THE DEVICE the step its budget runs out or it
    emits EOS; from then on it neither writes pages, advances, nor emits.
    Nothing inside a segment waits for the device; its compact record
    (tokens, emitted mask, sticky all-finite mask, active mask) is copied
    to pinned host memory behind the segment's work.
  * lookahead: while no queued request can become admissible by the next
    tick, segment k+1 is enqueued before the host waits for segment k's
    record, so the host's bookkeeping and launches overlap the device.
  * speculative decoding (``spec_decode=True``): one wave loop replaces
    both admission and the segments. Every wave mixes prompt chunks with a
    (1 + k_eff)-row VERIFY segment per decoding slot: its current token
    and up to ``spec_k`` tokens drafted on the host from its own history
    (``draft``, default ``speculative.NGramDraft``). The longest draft
    prefix matching the target argmax plus a bonus token are emitted and
    seq_lens rewinds past the rest (``kv_cache.advance_by``), on the
    device; one host readback a wave. Tokens equal spec-off decoding.

PREFIX CACHING (``flags.prefix_caching``, default on): the pool is
table-routed. Admission runs a longest-prefix match against a radix tree
of page-granular token chunks (``inference/prefix_cache.py``); matched
pages attach to the new slot by reference (refcounted by
``kv_cache.PageAllocator``) and only the unmatched suffix enters the
wave. The slot's private pages (suffix + decode horizon) are reserved up
front; a full-prompt match recomputes the last prompt token on a cloned
page (copy-on-write, ``kv_cache.clone_pages``). A slot whose prompt is
prefilled registers its full pages with the tree. Under pool pressure
leaf-LRU eviction runs, and admission DEFERS
(``stats["cache_full_deferrals"]``) instead of raising. The pool's last
page is the park page: every empty row points there, and a row's entries
past the slot's pages repeat its own last page, so no read reaches a
foreign page. With the HOST TIER (``flags.kv_host_tier``) eviction
demotes pages into a pinned ``kv_cache.HostPageArena`` (a blocking
store), a match on a host-resident prefix promotes it back (copies
enqueued before the next wave), and ``park``/``resume`` move a live
stream's pages to host and back without re-prefill (resume recomputes
one token). With the UNIFIED ARENA (``flags.unified_arena``,
``models/arena.py``) the pool's pages are the ``kv`` class of one
budgeted page economy. Tokens are the same with each feature on or off.

SAMPLING (``temperature > 0``, engine-level ``top_k``/``top_p``): every
wave and every segment step draws its tokens after the JAX package's
filter (``llama._sample_from_logits``) from one engine generator seeded by
``seed``, on the device: no host sync, the poison check before the draw.
Reproducible per seed; a request's tokens then depend on the schedule
(``top_k=1`` gives the greedy ones). Not with ``spec_decode``.

MULTI-LORA SERVING (``lora=True`` or ``flags.lora_serving``; ragged, not
with ``spec_decode``): requests carry an ``adapter_id`` registered with
``register_adapter``; admission pins the adapter on the device through
the ``models/lora.AdapterPool`` (refcounted slots, LRU eviction, a
deferral when every slot is pinned, an adapter-affinity reorder within
the first 8 arrivals), and every wave and segment step sorts its rows by
adapter slot so that each adapted projection adds its delta as two
grouped matmuls (K13). The routing goes up from a pinned staging buffer,
once a wave and once a segment. The prefix cache keys its tree by
adapter: a prefix's pages hold K/V computed with one adapter's
projections, so only requests of that adapter (or of the base model)
share them.

RELIABILITY (``paddle_tpu_torch/reliability``): per-request ``deadline_s``
is enforced at admission and at every segment boundary; ``max_pending``
bounds the queue; non-finite logits fail only the offending request;
``drain()`` stops admission but finishes in-flight slots. The JAX
package's fault sites sit at the same seams: ``engine.prefill`` (the
ragged wave) and ``engine.dispatch`` (the spec wave and the segments)
behind ``_gated_dispatch``, whose optional ``retry_policy`` retries the
gate only; ``engine.admit_chunk``, ``engine.draft`` and
``engine.readback`` fail one request alone; ``engine.park`` drops a park
intent; ``prefix.match`` fails one request, ``prefix.evict`` aborts the
run, ``prefix.prefetch`` falls back to a cold recompute; the arena's and
the adapter pool's sites fail the acquiring request. ``health_digest()``
is the fleet heartbeat's load record, and ``export_parked`` /
``import_parked`` / ``discard_parked`` move a parked stream between
engines (``inference/migration.py``, ``inference/fleet.py``).

PyTorch runs eagerly, so the JAX package's compiled-program caches have
no counterpart. ``stats`` keeps the JAX package's ragged-path keys with
the same meaning (docs/SERVING.md).

Not ported yet, and refused rather than served without (ROADMAP.md,
Queue 1): the bucketed admission pipeline (``ragged=False``), which
raises ``NotImplementedError``.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..framework import flags
from ..framework.random import make_generator
from ..reliability import faults
from ..models.kv_cache import (HostPageArena, PageAllocator,
                               PagedCacheState, advance_by, advance_masked,
                               clone_pages, create_paged_cache,
                               kv_page_nbytes, scrub_pages)
from ..models.llama import (_logits_ok, _normalize_sampling, _pick,
                            _pow2_bucket, _pure_decoder_layer,
                            _pure_lm_head_logits, _rope_tables)
from .prefix_cache import PrefixCache


class Backpressure(RuntimeError):
    """The engine's bounded pending queue is full — shed or retry later."""


@dataclass
class GenRequest:
    rid: int
    prompt: np.ndarray                 # (S,) int32
    max_new_tokens: int
    arrival_segment: int = 0           # admitted no earlier than this tick
    tokens: List[int] = field(default_factory=list)  # generated only
    done: bool = False
    prefilled: int = 0                 # prompt tokens already in the cache
    # prompt tokens served from shared pages at admission (their prefill
    # skipped)
    prefix_len: int = 0
    started: bool = False              # first chunk has entered a wave
    # speculative decoding: drafts proposed for and accepted from this
    # request (their ratio is its acceptance rate)
    draft_proposed: int = 0
    draft_accepted: int = 0
    # a resumed (un-parked) request's wave source: prompt + generated so
    # far; None for a request that was never parked
    resume_src: Optional[np.ndarray] = None
    # multi-LoRA serving: the registered adapter this request is served
    # through (None: the base model), and the device slot it pins while
    # placed
    adapter_id: Optional[object] = None
    _adapter_slot: Optional[int] = None
    # "ok" | "timeout" | "poisoned" | "error"
    status: str = "ok"
    deadline_s: Optional[float] = None  # wall budget from submit time
    submit_t: float = 0.0               # engine clock at submit
    error: Optional[str] = None         # repr of a per-request failure
    # the wave-source offset at which each of its prefill chunks began, in
    # admission order: a chunk's rows read the cells before its start from
    # the cache and its own rows fresh (what an int8 cache's rounding
    # depends on)
    chunk_starts: List[int] = field(default_factory=list, kw_only=True)

    @property
    def output_ids(self):
        return list(map(int, self.prompt)) + self.tokens


def _wave_src(req: GenRequest) -> np.ndarray:
    """The token stream admission waves prefill from: the prompt, or for a
    resumed request its prompt + history."""
    return req.prompt if req.resume_src is None else req.resume_src


@dataclass
class _Parked:
    """A live sequence parked in the host tier: its request (frozen at
    park time), the host arena slots holding its pages [0, ceil(seq_len /
    page)) (one reference each, owned by this record), and the consumed
    tokens its cells cover."""
    req: GenRequest
    host_pages: List[int]
    seq_len: int


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported to paddle_tpu_torch yet (ROADMAP.md, Queue "
        f"1); the ContinuousBatcher refuses rather than serving without it")


class _Record:
    """A device record copied to the host behind the work that made it:
    ``get()`` waits for the copy alone, not for work enqueued later."""

    def __init__(self, *tensors):
        packed = torch.cat([t.reshape(-1).to(torch.int32) for t in tensors])
        self._event = None
        if packed.is_cuda:
            self._host = torch.empty(packed.shape, dtype=torch.int32,
                                     pin_memory=True)
            self._host.copy_(packed, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = packed

    def get(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


class ContinuousBatcher:
    """Continuous-batching engine for ``LlamaForCausalLM``.

    Greedy by default: each request's tokens equal its solo
    ``model.generate_paged`` greedy rollout up to the summation order of
    the two paths (same kernels and math per row; exact on the CPU tests'
    margins). ``temperature > 0`` samples (one engine generator from
    ``seed``, drawn once a wave and once a segment step). ``lora=True``
    serves registered LoRA adapters per request. ``quantized_params``
    (``quantize_for_inference``) and ``cache_dtype="int8"`` serve the
    weight-only / int8-KV stack (page_size a multiple of 4 on the card,
    where the attention kernels copy a page's scales in 16-byte pieces).
    """

    def __init__(self, model, max_batch: int = 4, max_seq: int = 128,
                 page_size: int = 16, segment: int = 16,
                 eos_token_id: Optional[int] = None,
                 temperature: float = 0.0, top_k: Optional[int] = None,
                 top_p: Optional[float] = None, seed: int = 0,
                 max_pending: Optional[int] = None, retry_policy=None,
                 quantized_params=None, cache_dtype=None,
                 prefill_chunk: Optional[int] = None,
                 ragged: Optional[bool] = None,
                 prefix_caching: Optional[bool] = None,
                 prefix_pages: Optional[int] = None,
                 page_pool_pages: Optional[int] = None,
                 spec_decode: Optional[bool] = None,
                 spec_k: Optional[int] = None, draft=None,
                 host_tier: Optional[bool] = None,
                 host_tier_pages: Optional[int] = None,
                 prefetch_depth: Optional[int] = None,
                 lora: Optional[bool] = None,
                 lora_max_rank: Optional[int] = None,
                 lora_hbm_adapters: Optional[int] = None,
                 adapter_pool=None,
                 unified_arena: Optional[bool] = None,
                 arena_hbm_pages: Optional[int] = None,
                 arena_class_floors: Optional[str] = None):
        self.model = model
        self.cfg = model.config
        self.B = max_batch
        self.cap = max_seq
        self.page_size = page_size
        self.segment = segment
        self.eos = eos_token_id
        # engine-level sampling (None: greedy), one generator for every
        # draw, seeded by ``seed``
        self.sampling = _normalize_sampling(temperature, top_k, top_p)
        self.params = (quantized_params if quantized_params is not None
                       else model.param_dict())
        if cache_dtype is not None and cache_dtype not in ("int8",
                                                           torch.int8):
            raise ValueError(f"cache_dtype must be None or 'int8', "
                             f"got {cache_dtype!r}")
        # KV pages live in the model's compute dtype, or int8 codes
        self._cache_dtype = (torch.int8 if cache_dtype is not None else
                             self.params["model.embed_tokens.weight"].dtype)
        self.device = self.params["model.embed_tokens.weight"].device
        self._gen = (None if self.sampling is None
                     else make_generator(seed, self.device))
        # page-padded capacity: rope tables cover the full page pool
        self._pps = -(-max_seq // page_size)
        self._cap_pad = self._pps * page_size
        self.cos, self.sin = _rope_tables(self._cap_pad, self.cfg.head_dim,
                                          self.cfg.rope_theta,
                                          device=self.device)
        self._ragged = (bool(flags.get_flag("ragged_batching"))
                        if ragged is None else bool(ragged))
        if prefill_chunk is None:
            prefill_chunk = min(2 * page_size, self._cap_pad)
        if prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, "
                             f"got {prefill_chunk}")
        self.prefill_chunk = int(prefill_chunk)
        # flat wave width: every decode slot + the chunk budget, padded to
        # a multiple of 8
        self._ragged_T = -(-(self.B + self.prefill_chunk) // 8) * 8
        # the feature switches resolve as in the JAX package (a flag-driven
        # default activates only where legal; an explicit True on an
        # illegal configuration raises ValueError) ...
        if prefix_caching is None:
            prefix = bool(flags.get_flag("prefix_caching")) and self._ragged
        else:
            prefix = bool(prefix_caching)
            if prefix and not self._ragged:
                raise ValueError("prefix_caching requires ragged "
                                 "(token-budget) admission")
        if spec_decode is None:
            spec = (bool(flags.get_flag("spec_decode")) and self._ragged
                    and self.sampling is None)
        else:
            spec = bool(spec_decode)
            if spec and not self._ragged:
                raise ValueError("spec_decode requires ragged admission")
            if spec and self.sampling is not None:
                raise ValueError(
                    "spec_decode requires greedy decoding "
                    "(temperature=0): the acceptance rule compares "
                    "drafts against the target argmax — sampled "
                    "verification is a future extension "
                    "(docs/SERVING.md 'Speculative decoding')")
        if lora is None:
            lora = (bool(flags.get_flag("lora_serving")) and self._ragged
                    and not spec)
        elif lora and not self._ragged:
            raise ValueError(
                "lora requires ragged (token-budget) admission: the "
                "adapter-sorted grouped delta rides the ragged wave and "
                "the segment steps")
        elif lora and spec:
            raise ValueError(
                "lora and spec_decode are mutually exclusive for now: the "
                "speculative verify wave has no adapter routing (and the "
                "solo spec oracle knows no adapters)")
        self._lora = bool(lora)
        if unified_arena is None:
            unified_arena = bool(flags.get_flag("unified_arena")) and prefix
        elif unified_arena and not prefix:
            raise ValueError("unified_arena requires prefix_caching")
        if host_tier is None:
            host_tier = bool(flags.get_flag("kv_host_tier")) and prefix
        elif host_tier and not prefix:
            raise ValueError("kv_host_tier requires prefix_caching")
        # ... and whatever resolves on that the port has not got, raises
        if not self._ragged:
            raise _not_ported("bucketed admission (ragged=False)")
        self._prefix_caching = prefix
        # pages beyond the identity batch * pps pool: retained prefixes
        # live there while every slot is busy (one sequence's worth by
        # default)
        self._prefix_pages = ((self._pps if prefix_pages is None
                               else int(prefix_pages)) if prefix else 0)
        if self._prefix_pages < 0:
            raise ValueError(f"prefix_pages must be >= 0, "
                             f"got {prefix_pages}")
        # an absolute pool size, which may under-provision the pool; >= pps
        # so one request can always be placed after a full eviction
        if page_pool_pages is not None:
            if not prefix:
                raise ValueError("page_pool_pages needs prefix_caching: "
                                 "only the table-routed pool can be sized "
                                 "away from the identity layout")
            if page_pool_pages < self._pps:
                raise ValueError(
                    f"page_pool_pages must be >= pages_per_seq "
                    f"({self._pps}) so one request can always be placed, "
                    f"got {page_pool_pages}")
        self._pool_pages = page_pool_pages
        self._spec = spec
        self._spec_k = int(flags.get_flag("spec_k") if spec_k is None
                           else spec_k)
        if spec and self._spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {self._spec_k}")
        if spec and draft is None:
            from .speculative import NGramDraft

            draft = NGramDraft()
        self._draft = draft
        # brownout levers, live caps the serving loops read each wave: the
        # draft rows a verify segment may take (0: the plain decode row)
        # and the prompt tokens a wave admits. Neither changes a shape: the
        # wave stays keyed on (T, spec_k)
        self._spec_k_cap: Optional[int] = None
        self._admit_budget_cap: Optional[int] = None
        # the unified arena: the kv class at a physical ceiling, residency
        # gated by one byte budget (auto: the legacy pool's bytes); the
        # reserved weight class holds no pages
        self._arena_on = unified_arena
        self._arena = None
        self._arena_kv_pages = 0
        if unified_arena:
            from ..models.arena import UnifiedArena, parse_class_floors

            kv_unit = kv_page_nbytes(
                self.cfg.num_hidden_layers, self.cfg.num_key_value_heads,
                self.page_size, self.cfg.head_dim, self._cache_dtype)
            pool = self._legacy_pool_pages()
            floors = parse_class_floors(
                flags.get_flag("arena_class_floors")
                if arena_class_floors is None else arena_class_floors)
            budget_pages = int(flags.get_flag("arena_hbm_pages")
                               if arena_hbm_pages is None
                               else arena_hbm_pages)
            if budget_pages < 0:
                raise ValueError(f"arena_hbm_pages must be >= 0 "
                                 f"(0 = auto), got {budget_pages}")
            # an injected (shared) AdapterPool keeps its own slots: its
            # residency is not this engine's budget to steal
            lora_owned = self._lora and adapter_pool is None
            a_unit = a_slots = 0
            if lora_owned:
                from ..models.lora import adapter_slot_nbytes

                a_rank = int(flags.get_flag("lora_max_rank")
                             if lora_max_rank is None else lora_max_rank)
                a_slots = int(flags.get_flag("lora_hbm_adapters")
                              if lora_hbm_adapters is None
                              else lora_hbm_adapters)
                a_unit = adapter_slot_nbytes(
                    self.cfg, a_rank,
                    model.param_dict()["model.embed_tokens.weight"].dtype)
            # auto budget: the legacy pools' bytes summed
            budget = (budget_pages * kv_unit if budget_pages > 0
                      else pool * kv_unit + a_slots * a_unit)
            kv_ceiling = min(max(pool, budget // kv_unit), 4 * pool)
            classes = {"kv": (kv_unit, kv_ceiling)}
            if lora_owned:
                # adapters may grow past the legacy slot count by stealing
                # kv budget, up to 8 more slots
                classes["adapter"] = (a_unit, int(min(
                    a_slots + 8, max(a_slots, (budget - floors.get("kv", 0)
                                               * kv_unit) // a_unit))))
            classes["weight"] = (kv_unit, 0)
            self._arena = UnifiedArena(budget, classes, floors)
            self._arena_kv_pages = kv_ceiling
        if self._lora:
            from ..models.lora import AdapterPool

            # an injected (shared) pool is not this engine's to re-scope
            self._adapter_pool_owned = adapter_pool is None
            self._adapters = (adapter_pool if adapter_pool is not None
                              else AdapterPool(model, lora_max_rank,
                                               lora_hbm_adapters,
                                               arena=self._arena))
        else:
            if adapter_pool is not None:
                raise ValueError("adapter_pool needs lora serving enabled "
                                 "(lora=True or FLAGS_lora_serving)")
            self._adapters = None
        # the prefix tree's namespace of each adapter id (0: the base
        # model), assigned at first use
        self._adapter_ns: Dict[object, int] = {}
        # the host tier: its arena and pager persist across runs (parked
        # streams keep their slots), sized on first use
        self._host_tier = host_tier
        self._host_tier_pages = int(
            flags.get_flag("kv_host_tier_pages")
            if host_tier_pages is None else host_tier_pages)
        if self._host_tier_pages < 0:
            raise ValueError(f"host_tier_pages must be >= 0 (0 = auto), "
                             f"got {self._host_tier_pages}")
        self._prefetch_depth = int(
            flags.get_flag("kv_prefetch_depth")
            if prefetch_depth is None else prefetch_depth)
        if self._prefetch_depth < 1:
            raise ValueError(f"prefetch_depth must be >= 1, "
                             f"got {self._prefetch_depth}")
        self._host_arena: Optional[HostPageArena] = None
        self._host_pager: Optional[PageAllocator] = None
        self._parked: Dict[int, _Parked] = {}
        self._resuming: Dict[int, _Parked] = {}
        self._park_req: set = set()
        self._prefix: Optional[PrefixCache] = None   # per run
        self._pager = None                           # per run
        self._queue: deque = deque()
        self._next_rid = 0
        self.max_pending = max_pending
        # retries the fault gate of a dispatch (``_gated_dispatch``)
        self.retry_policy = retry_policy
        self._clock = time.monotonic
        self._draining = False
        # optional callable(tick), run at every scheduler boundary (the
        # outer tick, each ragged wave, each pipelined segment); park
        # intents are serviced right after it
        self._on_tick = None
        # live slots as of the last scheduler boundary
        self.active_slots = 0
        self.reset_stats()
        from ..reliability import register_engine
        register_engine(self)

    def _prefix_key(self, req: GenRequest, tokens) -> np.ndarray:
        """The tokens the prefix tree matches and inserts for ``req``: its
        own tokens for a base request, else the tokens moved into the
        adapter's namespace (each adapter id its own 2^32 range), so a
        prefix's pages are shared only by requests of one adapter."""
        if req.adapter_id is None:
            return tokens
        ns = self._adapter_ns.setdefault(req.adapter_id,
                                         len(self._adapter_ns) + 1)
        return np.asarray(tokens, np.int64) + (ns << 32)

    def _legacy_pool_pages(self) -> int:
        """The allocator's pool without the park page: the identity pool
        plus ``prefix_pages``, or ``page_pool_pages``."""
        return (self.B * self._pps + self._prefix_pages
                if self._pool_pages is None else self._pool_pages)

    def reset_stats(self):
        """Zero the observability counters — e.g. to scope stats to a
        measured run after a warm-up."""
        self._tbu_used = 0      # wave rows carrying real tokens
        self._tbu_cap = 0       # wave rows dispatched (ragged_steps * T)
        self._spec_tok = 0      # tokens emitted by verify segments
        self._spec_segs = 0     # verify segments dispatched
        self.stats = {
            "prefills": 0, "segments": 0, "prefill_dispatches": 0,
            "decode_steps": 0, "tokens_emitted": 0,
            "wasted_slot_steps": 0, "host_sync_count": 0,
            "ragged_steps": 0,
            "prefill_tokens_admitted": 0,
            "token_budget_util": 0.0,
            "bucket_pad_tokens": 0,
            "cache_full_deferrals": 0,
            "prefill_s": 0.0, "decode_s": 0.0,
            "timeouts": 0, "rejected": 0, "poisoned": 0, "retries": 0,
            "request_errors": 0,
            "quarantined": [],   # rids of poisoned requests, last 64
        }
        if self._spec:
            # tokens_per_target_step: tokens emitted per verify segment (1.0
            # is plain decode)
            self.stats.update({
                "spec_steps": 0, "draft_tokens_proposed": 0,
                "draft_tokens_accepted": 0, "acceptance_rate": 0.0,
                "tokens_per_target_step": 0.0,
            })
        if self._prefix_caching:
            # hit rate is token-weighted: matched / (matched + admitted)
            self.stats.update({
                "prefix_hits": 0, "prefix_misses": 0,
                "prefix_tokens_matched": 0, "prefix_hit_rate": 0.0,
                "pages_saved": 0, "prefix_cow_clones": 0,
                "prefix_inserts": 0, "prefix_evictions": 0,
            })
        if self._host_tier:
            # recompute_avoided_tokens: prompt tokens served from the host
            # tier instead of prefilled again; prefetch_stall_ms the host
            # time of the promote uploads, offload_stall_ms the blocking
            # stores (demotion and park)
            self.stats.update({
                "host_tier_hits": 0, "host_tier_pages_promoted": 0,
                "host_tier_pages_demoted": 0, "host_tier_discards": 0,
                "recompute_avoided_tokens": 0,
                "prefetch_stall_ms": 0.0, "offload_stall_ms": 0.0,
                "prefetch_faults": 0,
                "parks": 0, "resumes": 0, "park_faults": 0,
                "parked_slots": len(self._parked),
            })
        if self._lora:
            # mirrored from AdapterPool.stats after every wave; an engine-
            # owned pool is re-scoped with the engine's stats, an injected
            # one keeps its pool-wide counters. adapter_deferrals counts
            # admissions deferred with every slot pinned, adapter_batched
            # the ones the affinity reorder pulled ahead of FIFO order
            if self._adapter_pool_owned:
                for k in self._adapters.stats:
                    self._adapters.stats[k] = 0
            self.stats.update({
                "adapters_resident": len(self._adapters.resident),
                "adapter_hits": 0, "adapter_swap_stalls": 0,
                "adapter_loads": 0, "adapter_evictions": 0,
                "adapter_deferrals": 0, "adapter_batched": 0,
            })
        if self._arena is not None:
            # mirrored from UnifiedArena.stats after every wave; the engine
            # owns its arena, so a reset re-scopes the arena's counters
            for k in ("demotions", "budget_deferrals"):
                self._arena.stats[k] = 0
            self._arena.stats["steals"] = {}
            self.stats.update({
                "arena_steals": {}, "arena_demotions": 0,
                "arena_budget_deferrals": 0,
            })

    # ------------------------------------------------------- reliability

    def drain(self):
        """Stop admission; a running ``run()`` finishes in-flight slots and
        returns, leaving queued requests pending (see ``pending``)."""
        self._draining = True

    def reopen(self):
        """Re-enable admission after a ``drain()``."""
        self._draining = False

    def _admit_budget(self) -> int:
        """Prompt tokens a wave may admit: ``prefill_chunk``, unless
        ``_admit_budget_cap`` lowers it; never below 1 (admission always
        progresses) and never above the wave's compiled chunk width."""
        cap = self._admit_budget_cap
        if cap is None:
            return self.prefill_chunk
        return max(1, min(self.prefill_chunk, int(cap)))

    def _spec_k_eff(self) -> int:
        """Draft rows a verify segment may take: ``spec_k``, unless
        ``_spec_k_cap`` lowers it (0: the plain decode row)."""
        cap = self._spec_k_cap
        if cap is None:
            return self._spec_k
        return max(0, min(self._spec_k, int(cap)))

    @property
    def pending(self) -> int:
        return len(self._queue)

    @property
    def draining(self) -> bool:
        return self._draining

    def health_digest(self) -> dict:
        """One load/health record for fleet gossip, the JAX package's
        keys: queue depth, live slots, drain state, the prefix hit rate
        prefix-affinity routing maximizes, tokens emitted, the resident
        adapters (adapter-affinity routing) and the arena's pressure
        (resident / budget bytes, 0.0 with the arena off). Cheap enough
        for a heartbeat thread."""
        return {
            "queue_depth": len(self._queue),
            "active_slots": int(self.active_slots),
            "draining": bool(self._draining),
            "prefix_hit_rate": float(
                self.stats.get("prefix_hit_rate", 0.0)),
            "tokens_emitted": int(self.stats.get("tokens_emitted", 0)),
            "adapters_resident": (
                [str(a) for a in self._adapters.resident]
                if self._adapters is not None else []),
            "arena_pressure": (
                float(self._arena.used_bytes())
                / float(self._arena.budget_bytes)
                if self._arena is not None else 0.0),
        }

    # ---------------------------------------------------- multi-LoRA pool

    def register_adapter(self, adapter_id, weights) -> None:
        """Register a LoRA adapter on the host (``models/lora.py``'s format:
        ``{full_param_name: (A, B)}``); requests may then submit with
        ``adapter_id``. Requires lora serving on this engine."""
        if self._adapters is None:
            raise ValueError(
                "register_adapter requires lora serving (lora=True or "
                "FLAGS_lora_serving on a ragged engine)")
        self._adapters.register(adapter_id, weights)

    def adapter_snapshot(self) -> Optional[dict]:
        """The pool's residency, swap traffic and per-adapter refcounts;
        None with lora off."""
        if self._adapters is None:
            return None
        return self._adapters.snapshot()

    def arena_snapshot(self) -> Optional[dict]:
        """The unified arena's per-class residency (with each class's
        host-resident units: demoted and parked kv pages in the host
        tier, every registered adapter), the steal matrix keyed
        "victim->winner", the demotion and deferral totals and the floors;
        None with the arena off."""
        if self._arena is None:
            return None
        snap = self._arena.snapshot()
        hp = self._host_pager
        host = {"kv": int(hp.n_pages - hp.available()) if hp else 0}
        if self._adapters is not None:
            host["adapter"] = len(self._adapters.registered)
        for cls, rec in snap["classes"].items():
            rec["host_resident"] = int(host.get(cls, 0))
        return snap

    # ---------------------------------------------------- tiered KV: park

    def park(self, rid: int) -> None:
        """Ask the engine to PARK request ``rid``'s live stream: at the
        next scheduler boundary its KV pages move to the host tier (codes
        and int8 scale cells together), its device pages free and its slot
        opens for another request. The stream waits in ``parked`` until
        ``resume``. An intent for an unknown, finished or still-prefilling
        rid is held until it can apply and dropped at the end of
        ``run()``. Callable from the ``_on_tick`` hook or between runs."""
        if not self._host_tier:
            raise ValueError(
                "park requires kv_host_tier (and prefix_caching): only "
                "the tiered, table-routed pool can move a live slot's "
                "pages to host RAM")
        self._park_req.add(int(rid))

    def resume(self, rid: int) -> None:
        """Move a parked request back to the head of the queue. Its
        placement uploads the host-resident pages into fresh device pages
        and the next wave recomputes exactly ONE token, the unconsumed
        tail of its history, so decode continues without re-prefill.
        Raises KeyError when ``rid`` is not parked."""
        rec = self._parked.pop(int(rid))
        req = rec.req
        req.resume_src = np.asarray(req.output_ids, np.int32)
        req.prefilled = rec.seq_len
        req.started = False
        req.arrival_segment = 0
        self._resuming[req.rid] = rec
        self._queue.appendleft(req)
        self.stats["parked_slots"] = len(self._parked)

    @property
    def parked(self) -> List[int]:
        """rids currently parked in the host tier, ascending."""
        return sorted(self._parked)

    def kv_tier_snapshot(self) -> Optional[dict]:
        """Residency and traffic of both tiers; None with the tier off.
        The device pager is per run (the last run's is reported); the host
        pager persists."""
        if not self._host_tier:
            return None
        pager, hp = self._pager, self._host_pager
        return {
            "hbm_pages": int(pager.n_pages) if pager else 0,
            "hbm_pages_free": int(pager.available()) if pager else 0,
            "host_pages": int(hp.n_pages) if hp else 0,
            "host_pages_free": int(hp.available()) if hp else 0,
            "host_tier_hits": int(self.stats.get("host_tier_hits", 0)),
            "prefetch_stall_ms": float(
                self.stats.get("prefetch_stall_ms", 0.0)),
            "parked_slots": len(self._parked),
        }

    def _ensure_host_arena(self) -> None:
        """Create the persistent host arena and its pager if this engine
        has none yet: auto-sized to 4x the device pool, pinned when the
        engine serves on the card."""
        if self._host_pager is not None:
            return
        # normal tensors, even when a run() creates the arena: a migration
        # imports into it between runs
        with torch.inference_mode(False):
            n_host = (self._host_tier_pages
                      or 4 * self._legacy_pool_pages())
            shape = (self.cfg.num_hidden_layers,
                     self.cfg.num_key_value_heads, 1, self.page_size,
                     self.cfg.head_dim)
            quantized = self._cache_dtype == torch.int8

            def empty(sh, dt):
                return torch.empty(sh, dtype=dt, device=self.device)

            s_shape = shape[:-1] + (1,)
            template = PagedCacheState(
                k_pages=empty(shape, self._cache_dtype),
                v_pages=empty(shape, self._cache_dtype),
                block_tables=empty((1, 1), torch.int32),
                seq_lens=empty((1,), torch.int32),
                k_scales=(empty(s_shape, torch.float32) if quantized
                          else None),
                v_scales=(empty(s_shape, torch.float32) if quantized
                          else None))
            self._host_arena = HostPageArena(n_host, template)
        self._host_pager = PageAllocator(n_host)

    def export_parked(self, rid: int) -> dict:
        """Serialize a PARKED stream into a self-contained migration blob:
        the request record (prompt, emitted tokens, budget, the remaining
        deadline, adapter, prefix length) and its host-tier page blocks,
        each ``(layers, kv_heads, page, head_dim)`` K and V codes plus, on
        an int8 cache, their scale blocks (``HostPageArena.export_pages``,
        CPU tensors). A PEEK: the parked record and its host slots stay
        this engine's until ``discard_parked`` (delivery confirmed) or
        ``resume`` (a failed migration decodes on here). Raises KeyError
        when ``rid`` is not parked."""
        rec = self._parked[int(rid)]
        req = rec.req
        pages = self._host_arena.export_pages(rec.host_pages)
        per_page = sum(int(t.numel() * t.element_size())
                       for t in pages[0].values()) if pages else 0
        return {
            "spec": self._host_arena.page_spec(),
            # typed-page tag (models/arena.py's vocabulary): a receiver
            # lands only kv pages in its KV host tier
            "arena_class": "kv",
            "seq_len": int(rec.seq_len),
            "nbytes": per_page * len(pages),
            "pages": pages,
            "req": {
                "prompt": np.asarray(req.prompt, np.int32),
                "tokens": [int(t) for t in req.tokens],
                "max_new_tokens": int(req.max_new_tokens),
                # the remaining wall budget: the destination restarts the
                # clock at import
                "deadline_s": (None if req.deadline_s is None
                               else req.deadline_s
                               - (self._clock() - req.submit_t)),
                "adapter_id": req.adapter_id,
                "prefix_len": int(req.prefix_len),
            },
        }

    def discard_parked(self, rid: int) -> None:
        """Drop a parked stream after its migration was confirmed
        delivered: the record dies and its host slots free."""
        rec = self._parked.pop(int(rid))
        self._host_pager.release(rec.host_pages)
        self.stats["parked_slots"] = len(self._parked)

    def import_parked(self, blob: dict) -> int:
        """Adopt a migrated stream as a PARKED record of this engine: the
        arena class and the page spec are checked against the local arena
        before any byte lands, host slots are allocated (discarding the
        coldest demoted prefixes under pressure), the page blocks written
        in, and the request rebuilt under a fresh local rid, which the
        caller ``resume``s: the next wave recomputes one token."""
        if not self._host_tier:
            raise ValueError(
                "import_parked requires kv_host_tier (and "
                "prefix_caching): migration lands in the host arena")
        self._ensure_host_arena()
        cls = blob.get("arena_class", "kv")
        if cls != "kv":
            raise ValueError(
                f"migration blob carries arena class {cls!r}; only "
                f"'kv' pages land in the KV host tier")
        spec = self._host_arena.page_spec()
        if blob["spec"] != spec:
            raise ValueError(
                f"migration spec mismatch: blob {blob['spec']} vs "
                f"local arena {spec}")
        n = len(blob["pages"])
        hps = self._host_pager.alloc(n)
        if hps is None and self._prefix is not None:
            self._prefix.free_host_slots(n - self._host_pager.available())
            hps = self._host_pager.alloc(n)
        if hps is None:
            raise RuntimeError(
                f"host arena exhausted importing migration ({n} pages)")
        try:
            self._host_arena.import_pages(hps, blob["pages"])
        except Exception:
            self._host_pager.release(hps)
            raise
        r = blob["req"]
        req = GenRequest(self._next_rid, np.asarray(r["prompt"], np.int32),
                         int(r["max_new_tokens"]),
                         deadline_s=r.get("deadline_s"),
                         submit_t=self._clock(),
                         adapter_id=r.get("adapter_id"))
        self._next_rid += 1
        req.tokens = [int(t) for t in r["tokens"]]
        req.prefix_len = int(r.get("prefix_len", 0))
        self._parked[req.rid] = _Parked(req, hps, int(blob["seq_len"]))
        self.stats["parked_slots"] = len(self._parked)
        return req.rid

    def _gated_dispatch(self, site: str, ctx: dict, thunk):
        """Run a dispatch behind its fault gate. The retry policy covers
        the GATE only: once the dispatch starts, its cache may already be
        written in place, so a failure inside it is never retried — it
        propagates. Gate retries count into ``stats["retries"]``, on
        exhaustion too."""
        if self.retry_policy is not None:
            attempts = [0]

            def gate():
                attempts[0] += 1
                faults.maybe_fail(site, **ctx)

            try:
                self.retry_policy.call(gate)
            finally:
                self.stats["retries"] += max(0, attempts[0] - 1)
        else:
            faults.maybe_fail(site, **ctx)
        return thunk()

    # ------------------------------------------------------------ steps

    def _seg_bucket(self, budget: int) -> int:
        """Smallest power-of-two segment length covering ``budget``,
        capped at the engine's configured segment."""
        return _pow2_bucket(budget, self.segment)

    def _build_segment(self, seg: int):
        """Decode segment of ``seg`` steps with the scheduler state
        threaded through: a slot deactivates the step its budget hits zero
        or it emits EOS; a slot whose logits go non-finite deactivates that
        step, its token is not emitted, and the sticky ok mask names it.
        Each step picks greedily or draws from the engine generator.
        Returns segment_fn(prms, tokens, cache, active, remaining,
        cos_full, sin_full, lora=None) -> (toks (seg, B), emitted (seg, B),
        ok (B,), tokens, active, remaining, cache); ``lora`` is the
        segment's adapter routing, one row a slot, fixed for the segment
        (placement changes only at admission)."""
        from ..ops.kernels import fusion

        cfg = self.cfg
        L, eps = cfg.num_hidden_layers, cfg.rms_norm_eps
        nh, hk, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                      cfg.head_dim)
        B, eos = self.B, self.eos
        tied = self.model.lm_head is None
        sampling, gen = self.sampling, self._gen

        def step(prms, token, cache, active, cos_full, sin_full, lora):
            pos = torch.clamp(cache.seq_lens.long(),
                              max=cos_full.shape[0] - 1)
            hidden = prms["model.embed_tokens.weight"][token.long()]
            cos, sin = cos_full[pos], sin_full[pos]
            for i in range(L):
                def attend(q, k, v, i=i):
                    nonlocal cache
                    # inactive slots keep their cells and read as zeros
                    out, cache = fusion.decode_attend(
                        q.reshape(B, nh, hd), k.reshape(B, hk, hd),
                        v.reshape(B, hk, hd), cos, sin, cache, i,
                        active=active)
                    return out.reshape(B, nh * hd)

                hidden = _pure_decoder_layer(prms, i, hidden, eps, attend,
                                             lora)
            cache = advance_masked(cache, active)
            logits = _pure_lm_head_logits(prms, hidden, eps, tied)
            ok = _logits_ok(logits) | ~active
            nxt = _pick(logits, sampling, gen)
            return torch.where(active, nxt, token), cache, ok

        def segment_fn(prms, tokens, cache, active, remaining, cos_full,
                       sin_full, lora=None):
            okm = torch.ones_like(active)
            toks, emitted = [], []
            for _ in range(seg):
                nxt, cache, ok = step(prms, tokens, cache, active, cos_full,
                                      sin_full, lora)
                # budget decrement + EOS after the step emitted nxt: the
                # final/EOS token is itself emitted
                remaining = remaining - active.to(torch.int32)
                finished = remaining <= 0
                if eos is not None:
                    finished = finished | (nxt == eos)
                toks.append(nxt)
                emitted.append(active & ok)
                tokens, active, okm = nxt, active & ~finished & ok, okm & ok
            return (torch.stack(toks), torch.stack(emitted), okm, tokens,
                    active, remaining, cache)

        return segment_fn

    def _build_ragged_step(self):
        """Token-budget admission step: ONE wave of T rows. Rows [0, B)
        are the decode rows (slot b's current token at row b); rows
        [B, T) hold this step's prompt-chunk tokens, each tagged with its
        owning slot and offset. Per slot the step decodes (1 row),
        prefills (chunk_len rows at positions seq_lens..), or sits out. A
        slot whose prompt completes emits its first token and joins the
        scheduler state; decode rows advance exactly like one segment
        step; its tokens are picked greedily or drawn from the engine
        generator. Returns rstep(prms, chunk_ids, row_slot_pf, row_off_pf,
        q_start, chunk_len, decode_mask, chunk_done, budgets, new_slot,
        start_len, tokens, active, remaining, cache, cos_full, sin_full,
        lora=None) -> (toks, emit, ok, tokens, active, remaining, cache);
        ``lora`` is the wave's adapter routing over its T rows."""
        from ..ops.kernels import fusion

        cfg = self.cfg
        L, eps = cfg.num_hidden_layers, cfg.rms_norm_eps
        nh, hk, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                      cfg.head_dim)
        B, T, eos = self.B, self._ragged_T, self.eos
        tied = self.model.lm_head is None
        sampling, gen = self.sampling, self._gen
        i32 = torch.int32

        def rstep(prms, chunk_ids, row_slot_pf, row_off_pf, q_start,
                  chunk_len, decode_mask, chunk_done, budgets, new_slot,
                  start_len, tokens, active, remaining, cache, cos_full,
                  sin_full, lora=None):
            dev = tokens.device
            # slots being (re)admitted restart at start_len (0 here: stale
            # bytes of the slot's pages stay masked by seq_lens)
            seq = torch.where(new_slot, start_len, cache.seq_lens)
            cache = cache._replace(seq_lens=seq)
            dec_eff = decode_mask & active
            ids = torch.cat([tokens, chunk_ids])                     # (T,)
            row_slot = torch.cat([torch.arange(B, dtype=i32, device=dev),
                                  row_slot_pf])
            row_off = torch.cat([torch.zeros((B,), dtype=i32, device=dev),
                                 row_off_pf])
            slot_c = torch.clamp(row_slot, 0, B - 1).long()
            is_dec_row = torch.arange(T, device=dev) < B
            valid = torch.where(is_dec_row, dec_eff[slot_c], row_slot >= 0)
            pos = (seq[slot_c] + row_off).to(i32)                    # (T,)
            pos_c = torch.clamp(pos.long(), max=cos_full.shape[0] - 1)
            cos, sin = cos_full[pos_c], sin_full[pos_c]              # (T, D)
            hidden = prms["model.embed_tokens.weight"][ids.long()]
            q_len_eff = torch.where(dec_eff, 1, chunk_len).to(i32)
            # page-visible extent: a decode row reads its own just-written
            # cell back; prefill rows see old context only and take their
            # chunk from the fresh source
            page_lens = torch.where(
                dec_eff, seq + 1,
                torch.where(chunk_len > 0, seq, 0)).to(i32)
            for i in range(L):
                def attend(q, k, v, i=i):
                    nonlocal cache
                    out, cache = fusion.ragged_attend(
                        q.reshape(T, nh, hd), k.reshape(T, hk, hd),
                        v.reshape(T, hk, hd), cos, sin, cache, i, row_slot,
                        pos, valid, page_lens, q_start, q_len_eff, chunk_len)
                    return out.reshape(T, nh * hd)

                hidden = _pure_decoder_layer(prms, i, hidden, eps, attend,
                                             lora)
            cache = cache._replace(seq_lens=(
                seq + torch.where(dec_eff, 1, chunk_len)).to(i32))
            # logits at each slot's LAST wave row: the next token of a
            # decode row, the first token of a completing prefill, a
            # poison probe for a mid-prefill chunk
            idx = torch.clamp(q_start + q_len_eff - 1, 0, T - 1).long()
            logits = _pure_lm_head_logits(prms, hidden[idx], eps, tied)
            participating = dec_eff | (chunk_len > 0)
            ok = _logits_ok(logits) | ~participating
            toks = _pick(logits, sampling, gen)
            fin0 = budgets <= 1
            rem_dec = remaining - 1
            fin_dec = rem_dec <= 0
            if eos is not None:
                fin0 = fin0 | (toks == eos)
                fin_dec = fin_dec | (toks == eos)
            emit = (chunk_done | dec_eff) & ok
            tokens = torch.where(emit, toks, tokens)
            active = torch.where(chunk_done, ~fin0 & ok,
                                 torch.where(dec_eff,
                                             active & ~fin_dec & ok, active))
            remaining = torch.where(chunk_done, budgets - 1,
                                    torch.where(dec_eff, rem_dec, remaining))
            return toks, emit, ok, tokens, active, remaining, cache

        return rstep

    def _build_spec_wave_step(self):
        """The speculative wave: ONE ragged dispatch over a flat wave in
        which every participating slot is a fresh-source segment, either a
        (1 + k_eff)-row VERIFY segment of a decoding slot (row 0 its
        current token, rows 1.. its drafts, written provisionally) or a
        prompt chunk as in ``_build_ragged_step``. Verify segments are
        marked ``fresh_pool_read``, so their rows read one another as the
        plain decode step reads them back from the pool.

        On the device: per verify segment ``greedy_accept`` (with EOS, the
        budget and the finite-logits barrier) emits the accepted drafts
        plus the bonus token and seq_lens advances by that many
        (``advance_by``: the rejected cells stay as stale bytes past it); a
        verify segment's poison point is row 0. Prefill segments merge
        exactly as in ``_build_ragged_step``. Returns sstep(prms, ids,
        row_slot, row_off, q_start, q_len, spec_mask, drafts, k_eff,
        chunk_done, budgets, new_slot, start_len, tokens, active,
        remaining, cache, cos_full, sin_full) -> (cand (B, K+1), emit (B,
        K+1) bool, ok (B,), tokens, active, remaining, cache)."""
        from ..ops.kernels import fusion
        from .speculative import greedy_accept, segment_row_index

        cfg = self.cfg
        L, eps = cfg.num_hidden_layers, cfg.rms_norm_eps
        nh, hk, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                      cfg.head_dim)
        B, T, eos = self.B, self._ragged_T, self.eos
        K1 = self._spec_k + 1
        tied = self.model.lm_head is None
        i32 = torch.int32

        def sstep(prms, ids, row_slot, row_off, q_start, q_len, spec_mask,
                  drafts, k_eff, chunk_done, budgets, new_slot, start_len,
                  tokens, active, remaining, cache, cos_full, sin_full):
            seq = torch.where(new_slot, start_len, cache.seq_lens).to(i32)
            cache = cache._replace(seq_lens=seq)
            slot_c = torch.clamp(row_slot, 0, B - 1).long()
            valid = (row_slot >= 0) & (row_off < q_len[slot_c])
            pos = (seq[slot_c] + row_off).to(i32)                    # (T,)
            pos_c = torch.clamp(pos.long(), max=cos_full.shape[0] - 1)
            cos, sin = cos_full[pos_c], sin_full[pos_c]
            hidden = prms["model.embed_tokens.weight"][ids.long()]
            # every segment reads its old context from the pages and its
            # own rows through the fresh source (a verify segment's row 0
            # included: read as the pool holds it, it equals the plain
            # decode row's read-back of its just-written cell)
            participating = q_len > 0
            page_lens = torch.where(participating, seq, 0).to(i32)
            for i in range(L):
                def attend(q, k, v, i=i):
                    nonlocal cache
                    out, cache = fusion.ragged_attend(
                        q.reshape(T, nh, hd), k.reshape(T, hk, hd),
                        v.reshape(T, hk, hd), cos, sin, cache, i, row_slot,
                        pos, valid, page_lens, q_start, q_len, q_len,
                        fresh_pool_read=spec_mask)
                    return out.reshape(T, nh * hd)

                hidden = _pure_decoder_layer(prms, i, hidden, eps, attend)
            # logits at every verify row; a prefill segment reads its one
            # row from the pinned last column
            idx = segment_row_index(q_start, q_len, K1, T)          # (B, K1)
            logits = _pure_lm_head_logits(prms, hidden[idx.reshape(-1)], eps,
                                          tied)
            cand = torch.argmax(logits, dim=-1).to(i32).reshape(B, K1)
            fin = _logits_ok(logits).reshape(B, K1)
            # prefill segments, as in _build_ragged_step
            toks_pf, ok_pf = cand[:, -1], fin[:, -1]
            fin0 = budgets <= 1
            if eos is not None:
                fin0 = fin0 | (toks_pf == eos)
            emit_pf = chunk_done & ok_pf
            # verify segments: accept on the device, rewind
            gate = spec_mask & active
            emit_sp, n_emit = greedy_accept(cand, drafts, k_eff, remaining,
                                            eos=eos, fin_ok=fin, gate=gate)
            ok_sp = fin[:, 0]
            last = torch.clamp(n_emit - 1, min=0).long()
            tok_sp = torch.gather(cand, 1, last[:, None])[:, 0]
            rem_sp = remaining - n_emit
            fin_sp = rem_sp <= 0
            if eos is not None:
                fin_sp = fin_sp | (emit_sp & (cand == eos)).any(dim=1)
            col_last = torch.arange(K1, device=cand.device) == K1 - 1
            emit = torch.where(spec_mask[:, None], emit_sp,
                               col_last[None, :] & emit_pf[:, None])
            tokens = torch.where(spec_mask & (n_emit > 0), tok_sp,
                                 torch.where(emit_pf, toks_pf, tokens))
            active = torch.where(spec_mask, gate & ~fin_sp & ok_sp,
                                 torch.where(chunk_done, ~fin0 & ok_pf,
                                             active))
            remaining = torch.where(spec_mask, rem_sp,
                                    torch.where(chunk_done, budgets - 1,
                                                remaining)).to(i32)
            ok = torch.where(spec_mask, ok_sp, ok_pf) | ~participating
            delta = torch.where(spec_mask, n_emit,
                                torch.where(participating, q_len, 0))
            cache = advance_by(cache, delta)
            return cand, emit, ok, tokens, active, remaining, cache

        return sstep

    # --------------------------------------------------------------- host

    def submit(self, prompt_ids, max_new_tokens: int = 16,
               arrival_segment: int = 0,
               deadline_s: Optional[float] = None,
               adapter_id: Optional[object] = None) -> int:
        """Queue a request. Raises Backpressure when the bounded pending
        queue (``max_pending``) is full. ``deadline_s`` is a wall budget
        from now: an expired request finishes with status "timeout" at the
        next admission or segment boundary. ``adapter_id`` serves the
        request through that registered LoRA adapter (lora serving only;
        None: the base model)."""
        if adapter_id is not None:
            if self._adapters is None:
                raise ValueError(
                    "adapter_id needs lora serving (lora=True or "
                    "FLAGS_lora_serving on a ragged engine)")
            if adapter_id not in self._adapters:
                raise ValueError(
                    f"adapter {adapter_id!r} is not registered "
                    f"(register_adapter first)")
        if (self.max_pending is not None
                and len(self._queue) >= self.max_pending):
            self.stats["rejected"] += 1
            raise Backpressure(
                f"pending queue full ({len(self._queue)}/"
                f"{self.max_pending}); retry later or raise max_pending")
        if isinstance(prompt_ids, torch.Tensor):
            prompt_ids = prompt_ids.cpu().numpy()
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        if len(prompt) == 0:
            raise ValueError("empty prompt: submit at least one token")
        if len(prompt) + max_new_tokens > self.cap:
            raise ValueError(
                f"prompt {len(prompt)} + max_new {max_new_tokens} exceeds "
                f"cache capacity {self.cap}")
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(GenRequest(rid, prompt, max_new_tokens,
                                      arrival_segment, deadline_s=deadline_s,
                                      submit_t=self._clock(),
                                      adapter_id=adapter_id))
        return rid

    def try_submit(self, prompt_ids, max_new_tokens: int = 16,
                   arrival_segment: int = 0,
                   deadline_s: Optional[float] = None,
                   adapter_id: Optional[object] = None) -> Optional[int]:
        """Non-raising submit: rid, or None when the queue is full."""
        try:
            return self.submit(prompt_ids, max_new_tokens, arrival_segment,
                               deadline_s, adapter_id=adapter_id)
        except Backpressure:
            return None

    def _expired(self, req: GenRequest, now: float) -> bool:
        return (req.deadline_s is not None
                and now - req.submit_t > req.deadline_s)

    def _finish_timeout(self, req: GenRequest, done: Dict):
        req.status = "timeout"
        req.done = True
        done[req.rid] = req
        self.stats["timeouts"] += 1

    def _finish_poisoned(self, req: GenRequest, done: Dict):
        req.status = "poisoned"
        req.done = True
        done[req.rid] = req
        self.stats["poisoned"] += 1
        q = self.stats["quarantined"]
        q.append(req.rid)
        del q[:-64]  # keep the last 64 only

    def run(self) -> Dict[int, GenRequest]:
        """Drain the queue; returns {rid: finished GenRequest}. A finished
        request's ``.status`` is "ok", "timeout" (deadline_s blown) or
        "poisoned" (non-finite logits — quarantined); after ``drain()`` the
        loop finishes in-flight slots and leaves queued requests pending.

        Host loop: admission steps wait for the device once each (the
        wave's tokens feed the host-side slot table); decode segments keep
        the scheduler state on the device and — whenever no queued request
        can become admissible by the next tick — enqueue segment k+1
        before waiting for segment k's record."""
        with torch.inference_mode():
            return self._run()

    def _run(self) -> Dict[int, GenRequest]:
        B, T, P = self.B, self._ragged_T, self.page_size
        cfg = self.cfg
        dev = self.device
        if self._host_tier and self._prefix is not None:
            # the previous run's tree dies with it, the host pager does
            # not: release the slots it held, and its binding to the old
            # pool
            self._prefix.drop_host_nodes()
            self._prefix._offload = None
        # the table-routed pool carves its last page as the park page,
        # which the allocator never hands out: every empty row points
        # there. (The port's kernels write nothing for an empty slot; the
        # page keeps the JAX package's pool layout and page ids.)
        park = 1 if self._prefix_caching else 0
        if self._arena is not None:
            pool_total = self._arena_kv_pages + park
        else:
            pool_total = (None if self._pool_pages is None
                          else self._pool_pages + park)
        cache = create_paged_cache(
            cfg.num_hidden_layers, B, self.cap, cfg.num_key_value_heads,
            cfg.head_dim, page_size=self.page_size, dtype=self._cache_dtype,
            extra_pages=self._prefix_pages + park, total_pages=pool_total,
            device=dev)
        # device-resident scheduler state
        dev_tokens = torch.zeros((B,), dtype=torch.int32, device=dev)
        dev_active = torch.zeros((B,), dtype=torch.bool, device=dev)
        dev_remaining = torch.zeros((B,), dtype=torch.int32, device=dev)
        slots: List[Optional[GenRequest]] = [None] * B
        # prefix-cache host state, per run: the radix tree and the
        # refcounted allocator over this run's pool; the block table is
        # mirrored on the host and uploaded in place when a row changes.
        # prefix None <=> caching off: the identity table stays.
        prefix: Optional[PrefixCache] = None
        pager = None
        bt_host = None
        park_page = None
        n_pages = [0] * B           # valid entries per block-table row
        pending_clones: List[tuple] = []    # (src, dst) COW copies due
        bt_dirty = [False]
        if self._prefix_caching:
            park_page = cache.k_pages.shape[2] - 1
            if self._arena is not None:
                # the kv class is this run's pool: forget last run's pages
                self._arena.reset_class("kv")
                pager = self._arena.view("kv")
            else:
                pager = PageAllocator(park_page)
            if self._host_tier:
                self._ensure_host_arena()

                def offload(device_pages, host_slots):
                    # reads the pool at call time: the store waits for
                    # every write enqueued before it
                    t0 = time.perf_counter()
                    self._host_arena.store(cache, device_pages, host_slots)
                    self.stats["offload_stall_ms"] += (
                        time.perf_counter() - t0) * 1e3

                prefix = PrefixCache(self.page_size, pager,
                                     host_pager=self._host_pager,
                                     offload=offload)
            else:
                prefix = PrefixCache(self.page_size, pager)
            self._prefix = prefix
            self._pager = pager
            if self._arena is not None:
                # another class's deficit reclaims kv pages through this
                # run's tree
                self._arena.set_reclaimer("kv", prefix.reclaim)
            bt_host = np.full((B, self._pps), park_page, np.int32)
            bt_dirty[0] = True
        # host-side upper bound on each slot's remaining budget (exact when
        # no EOS fires) — drives segment length and lookahead without a sync
        bound = [0] * B
        done: Dict[int, GenRequest] = {}
        tick = 0
        rstep = self._build_ragged_step()

        def release_slot_pages(i, scrub=False):
            """Drop slot i's page references: pages the tree retains
            survive for future matches, the rest return to the free list,
            and the row re-parks. ``scrub`` (a poisoned request) zeroes the
            pages that actually free: they may hold non-finite K/V."""
            if prefix is None or n_pages[i] == 0:
                return
            freed = pager.release([int(p) for p in bt_host[i, :n_pages[i]]])
            n_pages[i] = 0
            bt_host[i, :] = park_page
            bt_dirty[0] = True
            if scrub and freed:
                scrub_pages(cache, freed)

        def flush_block_table():
            """Upload the host table, in place, before any dispatch that
            could see a rewired or re-parked row. The upload copies from a
            pinned snapshot, so the host may edit its table at once."""
            if bt_dirty[0]:
                src = torch.from_numpy(bt_host.copy())
                if cache.block_tables.is_cuda:
                    src = src.pin_memory()
                cache.block_tables.copy_(src, non_blocking=True)
                bt_dirty[0] = False

        def arrived():
            if self._draining:
                return []
            return [r for r in self._queue if r.arrival_segment <= tick]

        def pump(t):
            """Scheduler boundary: refresh the live-slot gauge, run the
            ``_on_tick`` hook, then service park intents."""
            self.active_slots = sum(s is not None for s in slots)
            if self._on_tick is not None:
                self._on_tick(t)
            if self._host_tier:
                service_parks()

        def finished_host(req, tok):
            if self.eos is not None and tok == self.eos:
                return True
            return len(req.tokens) >= req.max_new_tokens

        # the adapter-affinity reorder: how far past the FIFO head
        # admission may look for a request whose adapter is resident, and
        # how often a head may be passed over before it is served FIFO
        REORDER_W = 8
        bypassed: Dict[int, int] = {}

        def resident(req):
            return (req._adapter_slot is not None
                    or self._adapters.slot_of(req.adapter_id) is not None)

        def affinity_pick(cands):
            """The FIFO head, unless its adapter would have to be loaded:
            then the first of the next REORDER_W - 1 arrivals whose adapter
            is resident (one load per tenant, not one per request). A head
            passed over REORDER_W times is served next."""
            head = cands[0]
            if (self._adapters is None or head.adapter_id is None
                    or bypassed.get(head.rid, 0) >= REORDER_W
                    or resident(head)):
                return head
            for r in cands[1:REORDER_W]:
                if r.adapter_id is not None and resident(r):
                    bypassed[head.rid] = bypassed.get(head.rid, 0) + 1
                    self.stats["adapter_batched"] += 1
                    return r
            return head

        def pop_admissible():
            """Next arrived request that has not blown its deadline
            (expired ones finish with status "timeout" here); with lora,
            in adapter-affinity order."""
            while True:
                cands = arrived()
                if not cands:
                    return None
                req = affinity_pick(cands)
                self._queue.remove(req)
                bypassed.pop(req.rid, None)
                if self._expired(req, self._clock()):
                    rec = self._resuming.pop(req.rid, None)
                    if rec is not None:
                        self._host_pager.release(rec.host_pages)
                    # a request deferred while pinned drops its pin
                    release_adapter(req)
                    self._finish_timeout(req, done)
                    continue
                return req

        def release_adapter(req):
            """Drop a request's adapter pin (finish, poison, timeout, park):
            an unreferenced adapter becomes evictable."""
            if self._adapters is not None \
                    and req._adapter_slot is not None:
                self._adapters.release(req.adapter_id)
                req._adapter_slot = None

        def fail_request(req, e):
            """A per-request fault: the request finishes with status
            "error", alone."""
            req.status = "error"
            req.error = repr(e)
            req.done = True
            done[req.rid] = req
            self.stats["request_errors"] += 1

        def acquire_adapter(req):
            """Pin the request's adapter on the device before placement:
            "ok" (base requests trivially), "defer" (every slot pinned by
            live requests: the request goes back to the queue's head,
            adapter_deferrals counts it) or "failed" (an ``adapter.load``
            / ``adapter.evict`` fault fails this request alone)."""
            if (self._adapters is None or req.adapter_id is None
                    or req._adapter_slot is not None):
                return "ok"
            try:
                slot = self._adapters.acquire(req.adapter_id)
            except Exception as e:
                fail_request(req, e)
                return "failed"
            if slot is None:
                self.stats["adapter_deferrals"] += 1
                self._queue.appendleft(req)
                return "defer"
            req._adapter_slot = slot
            return "ok"

        def note_adapter_stats():
            """Mirror the pool's counters into the engine's stats."""
            for k, v in self._adapters.stats.items():
                self.stats[k] = v
            self.stats["adapters_resident"] = len(self._adapters.resident)

        def slot_groups():
            """(B,) int32 device slot of each batch slot's adapter
            (``hbm_slots``, the all-zeros group: empty slots and base
            requests)."""
            g = np.full((B,), self._adapters.hbm_slots, np.int32)
            for i in range(B):
                req = slots[i]
                if req is not None and req._adapter_slot is not None:
                    g[i] = req._adapter_slot
            return g

        def routing(row_group):
            """The lora context of a wave or segment over ``row_group``."""
            srt, inv, offs = self._adapters.route_rows(row_group)
            return {"sort": srt, "inv": inv, "offsets": offs,
                    "params": self._adapters.stacks}

        def free(i, scrub=False):
            if slots[i] is not None:
                release_adapter(slots[i])
            release_slot_pages(i, scrub=scrub)
            slots[i] = None
            bound[i] = 0

        def deactivate(idx):
            nonlocal dev_active
            keep = np.ones((B,), bool)
            keep[idx] = False
            dev_active = dev_active & torch.as_tensor(keep, device=dev)

        def kv_alloc(n):
            """pager.alloc under the arena's fault contract: a faulted
            cross-class steal (``arena.steal`` / ``arena.demote``) fails
            only the acquiring request, so on the kv side it reads as "no
            pages" and the evict/defer ladder goes on."""
            try:
                return pager.alloc(n)
            except faults.FaultError:
                return None

        def alloc_under_pressure(n):
            """alloc, else leaf-LRU evict and alloc again: None means a
            deferral, never a raise (a ``prefix.evict`` fault aside, which
            aborts the run)."""
            pages = kv_alloc(n)
            if pages is None:
                prefix.evict(n - pager.available())
                pages = kv_alloc(n)
            return pages

        def place(i, req):
            """Prefix-cache placement of slot i: the longest-prefix match
            and the slot's whole page reservation (matched pages by
            reference, private suffix and decode pages from the free
            list). A match that ends in host-resident pages promotes them
            into fresh device pages (uploads enqueued before the next
            wave). Returns "ok", "defer" (pool exhausted even after
            eviction: the request goes back to the queue's head) or
            "failed" (a ``prefix.match`` fault fails this request
            alone)."""
            if req.rid in self._resuming:
                return place_resumed(i, req)
            try:
                m_len, path = prefix.match_tiered(
                    self._prefix_key(req, req.prompt))
            except Exception as e:
                fail_request(req, e)
                return "failed"
            # path order is hbm* host*: the device prefix attaches by
            # reference, the host suffix by promotion
            n_hbm = sum(1 for n in path if n.tier == "hbm")
            m_pages = [n.page for n in path[:n_hbm]]
            host_sfx = path[n_hbm:]
            # a full-prompt match still admits ONE token to emit the
            # first output: the last prompt token, recomputed inside the
            # last attached page (the copy-on-write case)
            start = min(m_len, len(req.prompt) - 1)
            n_total = min(self._pps, -(-(len(req.prompt)
                                         + req.max_new_tokens) // P))
            cow = start < m_len
            need = n_total - n_hbm + (1 if cow else 0)
            # hold the match before eviction can run: eviction may remove
            # the matched nodes, whose pages must not be handed back as
            # this slot's private pages
            pager.retain(m_pages)
            host_hold = [n.page for n in host_sfx]
            if host_hold:
                self._host_pager.retain(host_hold)

            def drop_match():
                nonlocal m_len, path, m_pages, host_sfx, host_hold
                nonlocal start, cow
                pager.release(m_pages)
                if host_hold:
                    self._host_pager.release(host_hold)
                m_len, path, m_pages, host_sfx, host_hold = 0, [], [], [], []
                start, cow = 0, False

            try:
                priv = alloc_under_pressure(need)
            except Exception:
                # a prefix.evict fault aborts the run, but the persistent
                # host pager must not keep this placement's holds
                drop_match()
                raise
            if priv is None and not any(s is not None for s in slots):
                # no live slot will free pages by decoding: reset the
                # tree, and if the held match itself does not fit, drop
                # it (an empty pool always fits one slot)
                prefix.evict_all()
                priv = kv_alloc(need)
                if priv is None:
                    drop_match()
                    priv = kv_alloc(n_total)
            if priv is None:
                drop_match()
                self.stats["cache_full_deferrals"] += 1
                self._queue.appendleft(req)
                return "defer"
            if host_sfx:
                try:
                    # a faulted promotion falls back to a cold recompute
                    # for this request alone: the match drops, the nodes
                    # stay host-resident for the next request
                    faults.maybe_fail("prefix.prefetch", rid=req.rid,
                                      pages=len(host_sfx))
                except Exception:
                    self.stats["prefetch_faults"] += 1
                    pager.release(priv)
                    drop_match()
                    priv = alloc_under_pressure(n_total)
                    if priv is None:
                        self.stats["cache_full_deferrals"] += 1
                        self._queue.appendleft(req)
                        return "defer"
            if host_sfx:
                dst = [priv.pop(0) for _ in host_sfx]
                flush_pending_clones()      # before any eager page write
                t0 = time.perf_counter()
                self._host_arena.load(cache, [n.page for n in host_sfx],
                                      dst, self._prefetch_depth)
                self.stats["prefetch_stall_ms"] += (
                    time.perf_counter() - t0) * 1e3
                for n, d in zip(host_sfx, dst):
                    if n.parent is not None and n.tier == "host":
                        # the tree takes over the fresh page's reference;
                        # the slot takes its own on top
                        prefix.promote(n, d)
                        pager.retain([d])
                self._host_pager.release(host_hold)
                host_hold = []
                m_pages = m_pages + dst
                self.stats["host_tier_hits"] += 1
                self.stats["host_tier_pages_promoted"] += len(dst)
                self.stats["recompute_avoided_tokens"] += max(
                    0, start - n_hbm * P)
            row = bt_host[i]
            row[:len(m_pages)] = m_pages
            if cow:
                # the slot's reference moves to a clone (the tree keeps
                # the source); copied before the next dispatch
                dst = priv.pop(0)
                pending_clones.append((int(m_pages[-1]), dst))
                pager.release([int(m_pages[-1])])
                row[len(m_pages) - 1] = dst
                self.stats["prefix_cow_clones"] += 1
            row[len(m_pages):n_total] = priv
            # entries past the slot's pages repeat its own last page: a
            # reader that gathers the whole row never reaches a foreign
            # page (a quarantined neighbour's NaN times weight 0 is NaN)
            row[n_total:] = row[n_total - 1]
            n_pages[i] = n_total
            bt_dirty[0] = True
            req.prefilled = req.prefix_len = start
            req.started = False
            req.chunk_starts.clear()
            if m_len > 0:
                self.stats["prefix_hits"] += 1
                self.stats["prefix_tokens_matched"] += start
                self.stats["pages_saved"] += len(m_pages)
            else:
                self.stats["prefix_misses"] += 1
            return "ok"

        def place_resumed(i, req):
            """Un-park placement: the slot's whole reservation, the parked
            pages uploaded into its head, and a one-token chunk (the
            unconsumed tail of the history) for the next wave. Every full
            history page below the write frontier joins the tree."""
            rec = self._resuming[req.rid]
            n_total = min(self._pps, -(-(len(req.prompt)
                                         + req.max_new_tokens) // P))
            n_used = len(rec.host_pages)
            priv = alloc_under_pressure(n_total)
            if priv is None and not any(s is not None for s in slots):
                prefix.evict_all()
                priv = kv_alloc(n_total)
            if priv is None:
                self.stats["cache_full_deferrals"] += 1
                self._queue.appendleft(req)     # still in _resuming
                return "defer"
            try:
                # a faulted resume prefetch falls back to a cold recompute
                # of the whole history (resume_src): slower, same tokens
                faults.maybe_fail("prefix.prefetch", rid=req.rid,
                                  pages=n_used, resume=True)
            except Exception:
                self.stats["prefetch_faults"] += 1
                req.prefilled = 0
            else:
                flush_pending_clones()      # before any eager page write
                t0 = time.perf_counter()
                self._host_arena.load(cache, rec.host_pages, priv[:n_used],
                                      self._prefetch_depth)
                self.stats["prefetch_stall_ms"] += (
                    time.perf_counter() - t0) * 1e3
                self.stats["host_tier_hits"] += 1
                self.stats["host_tier_pages_promoted"] += n_used
                self.stats["recompute_avoided_tokens"] += rec.seq_len
                n_full = rec.seq_len // P
                if n_full:
                    prefix.insert(
                        self._prefix_key(req, req.resume_src[:n_full * P]),
                        [int(p) for p in priv[:n_full]])
                    self.stats["prefix_inserts"] = prefix.stats["inserts"]
            del self._resuming[req.rid]
            self._host_pager.release(rec.host_pages)
            row = bt_host[i]
            row[:n_total] = priv
            row[n_total:] = row[n_total - 1]
            n_pages[i] = n_total
            bt_dirty[0] = True
            req.started = False
            self.stats["resumes"] += 1
            return "ok"

        def service_parks():
            """Apply park intents at a scheduler boundary: store the
            slot's used pages into host slots (blocking), release its
            device pages, free the slot and deactivate it on the device. A
            segment already in flight may still emit for it; those tokens
            are discarded (wasted_slot_steps) and greedy decoding emits
            them again on resume. A park that cannot find host slots, even
            after discarding the coldest demoted prefixes (or a fault at
            ``engine.park``), drops the intent and the stream keeps
            decoding."""
            if not self._park_req or prefix is None:
                return
            parked_now: List[int] = []
            for i in range(B):
                req = slots[i]
                if req is None or req.rid not in self._park_req:
                    continue
                if req.prefilled < len(_wave_src(req)) or not req.tokens:
                    continue    # mid-prefill: park once decoding
                self._park_req.discard(req.rid)
                seq_len = len(req.prompt) + len(req.tokens) - 1
                n_used = -(-seq_len // P)
                hps = None
                try:
                    faults.maybe_fail("engine.park", rid=req.rid, slot=i)
                    hps = self._host_pager.alloc(n_used)
                    if hps is None:
                        prefix.free_host_slots(
                            n_used - self._host_pager.available())
                        hps = self._host_pager.alloc(n_used)
                    if hps is None:
                        raise RuntimeError(
                            f"host arena exhausted parking rid {req.rid} "
                            f"({n_used} pages)")
                    t0 = time.perf_counter()
                    self._host_arena.store(
                        cache, [int(p) for p in bt_host[i, :n_used]], hps)
                    self.stats["offload_stall_ms"] += (
                        time.perf_counter() - t0) * 1e3
                except Exception:
                    if hps is not None:
                        # the persistent host pager keeps no stranded slot
                        self._host_pager.release(hps)
                    self.stats["park_faults"] += 1
                    continue    # intent dropped; the stream decodes on
                free(i)
                self._parked[req.rid] = _Parked(req, hps, seq_len)
                self.stats["parks"] += 1
                parked_now.append(i)
            self.stats["parked_slots"] = len(self._parked)
            if parked_now:
                deactivate(parked_now)

        def flush_pending_clones():
            """Copy the due COW clones now: before any host upload, whose
            destination may be a clone's freed source page."""
            if pending_clones:
                clone_pages(cache, [s for s, _ in pending_clones],
                            [d for _, d in pending_clones])
                pending_clones.clear()

        def cow_guard_and_flush(write_ranges):
            """Every logical page a wave writes (a chunk's prompt pages, a
            verify segment's draft cells) must be private (refcount 1);
            then the due clones and the table go to the device.
            ``write_ranges``: (slot, lo, hi) logical-page spans."""
            for i, lo, hi in write_ranges:
                for logical in range(lo, hi + 1):
                    pg = int(bt_host[i, logical])
                    if int(pager.refcount[pg]) != 1:
                        raise RuntimeError(
                            f"COW invariant violated: slot {i} writing "
                            f"logical page {logical} -> physical {pg} with "
                            f"refcount {int(pager.refcount[pg])}")
            flush_pending_clones()
            flush_block_table()

        def place_arrivals():
            """Place arrivals into free slots; a prefix placement may
            defer under pool pressure (retried next tick)."""
            for i in range(B):
                if slots[i] is None and arrived():
                    req = pop_admissible()
                    if req is None:
                        break
                    # the adapter pin first: the wave routes the slot's
                    # rows to its group; a deferred request keeps it, so
                    # the retry is a hit
                    verdict = acquire_adapter(req)
                    if verdict == "defer":
                        break
                    if verdict == "failed":
                        continue
                    if prefix is not None:
                        verdict = place(i, req)
                        if verdict == "defer":
                            # with no live slot left to free pages, the
                            # request's own pin may be the residency the kv
                            # side cannot steal: drop it
                            if self._arena is not None and \
                                    not any(s is not None for s in slots):
                                release_adapter(req)
                            break
                        if verdict == "failed":
                            release_adapter(req)
                            continue
                    else:
                        req.prefilled = 0
                        req.started = False
                        req.chunk_starts.clear()
                    slots[i] = req

        def note_prefix_stats():
            """The derived prefix stats after a wave: the token-weighted
            hit rate, the tree's counters and the arena's."""
            m = self.stats["prefix_tokens_matched"]
            tot = m + self.stats["prefill_tokens_admitted"]
            self.stats["prefix_hit_rate"] = (m / tot) if tot else 0.0
            self.stats["prefix_inserts"] = prefix.stats["inserts"]
            self.stats["prefix_evictions"] = prefix.stats["evictions"]
            if self._host_tier:
                self.stats["host_tier_pages_demoted"] = \
                    prefix.stats["demotions"]
                self.stats["host_tier_discards"] = \
                    prefix.stats["host_discards"]
            if self._arena is not None:
                a = self._arena.stats
                self.stats["arena_steals"] = {
                    k: int(v) for k, v in a["steals"].items()}
                self.stats["arena_demotions"] = int(a["demotions"])
                self.stats["arena_budget_deferrals"] = int(
                    a["budget_deferrals"])

        def assign_chunk(i, req, take, ids_buf, rs_buf, ro_buf, pos, base,
                         q_start, q_len, chunk_done, budgets, new_slot,
                         start_len):
            """Assign ``take`` wave-source tokens of slot i's request into
            the wave's chunk buffers at row ``pos`` (wave row ``base +
            pos``). Returns 1 on the request's first chunk, 0 on a later
            one, -1 when the ``engine.admit_chunk`` fault failed the
            request (its slot freed; the wave goes on without it)."""
            try:
                faults.maybe_fail("engine.admit_chunk", rid=req.rid, slot=i,
                                  tokens=take)
            except Exception as e:
                fail_request(req, e)
                free(i)
                return -1
            first = 0
            if not req.started:
                new_slot[i] = True
                start_len[i] = req.prefilled
                req.started = True
                first = 1
            src = _wave_src(req)
            ids_buf[pos:pos + take] = src[req.prefilled:req.prefilled + take]
            rs_buf[pos:pos + take] = i
            ro_buf[pos:pos + take] = np.arange(take)
            req.chunk_starts.append(req.prefilled)
            q_start[i] = base + pos
            q_len[i] = take
            # the remaining budget: a resumed request's earlier tokens
            # count against it
            budgets[i] = req.max_new_tokens - len(req.tokens)
            req.prefilled += take
            chunk_done[i] = req.prefilled == len(src)
            return first

        def register_prompt_pages(req, i):
            """Prompt prefilled: its FULL pages join the tree now, so later
            admissions hit while this slot still decodes."""
            n_full = len(req.prompt) // P
            if n_full:
                prefix.insert(self._prefix_key(req, req.prompt[:n_full * P]),
                              [int(p) for p in bt_host[i, :n_full]])
                self.stats["prefix_inserts"] = prefix.stats["inserts"]

        def chunk_ranges(q_len):
            """(slot, lo, hi) logical pages each prompt chunk writes."""
            return [(i, (slots[i].prefilled - int(q_len[i])) // P,
                     (slots[i].prefilled - 1) // P)
                    for i in range(B)
                    if slots[i] is not None and q_len[i] > 0]

        def admit_ragged():
            """Token-budget admission: each step assigns up to
            ``prefill_chunk`` prompt tokens and runs them together with
            every active decode slot as one ragged wave; loops until no
            prompt tokens are pending (the segments take over the
            pure-decode stretch). One host readback per step."""
            nonlocal cache, dev_tokens, dev_active, dev_remaining, tick
            pw = T - B
            while True:
                pump(tick)
                place_arrivals()
                if not any(s is not None and s.prefilled < len(_wave_src(s))
                           for s in slots):
                    return
                chunk_ids = np.zeros((pw,), np.int32)
                row_slot_pf = np.full((pw,), -1, np.int32)
                row_off_pf = np.zeros((pw,), np.int32)
                q_start = np.zeros((B,), np.int32)
                chunk_len = np.zeros((B,), np.int32)
                decode_mask = np.zeros((B,), bool)
                chunk_done = np.zeros((B,), bool)
                budgets = np.zeros((B,), np.int32)
                new_slot = np.zeros((B,), bool)
                start_len = np.zeros((B,), np.int32)
                off = 0
                budget_left = self._admit_budget()
                n_started = 0
                for i in range(B):
                    req = slots[i]
                    if req is None:
                        continue
                    if req.prefilled >= len(_wave_src(req)):
                        decode_mask[i] = True     # decodes alongside
                        q_start[i] = i
                        continue
                    take = min(len(_wave_src(req)) - req.prefilled,
                               budget_left)
                    if take <= 0:
                        continue                  # budget spent this step
                    first = assign_chunk(
                        i, req, take, chunk_ids, row_slot_pf, row_off_pf, off,
                        B, q_start, chunk_len, chunk_done, budgets, new_slot,
                        start_len)
                    if first < 0:
                        continue    # the fault site failed this request
                    n_started += first
                    off += take
                    budget_left -= take
                if off == 0:
                    # every pending prefill failed out of the wave: freed
                    # slots may admit queued arrivals
                    continue
                if prefix is not None:
                    # decode rows append past the prompt region, private by
                    # construction
                    cow_guard_and_flush(chunk_ranges(chunk_len))
                wave = [torch.as_tensor(a, device=dev) for a in (
                    chunk_ids, row_slot_pf, row_off_pf, q_start, chunk_len,
                    decode_mask, chunk_done, budgets, new_slot, start_len)]
                lora = None
                if self._lora:
                    # decode rows carry their slot's group, chunk rows
                    # their owner's, padding rows the base group
                    sg = slot_groups()
                    row_group = np.full((T,), self._adapters.hbm_slots,
                                        np.int32)
                    row_group[:B] = sg
                    own = row_slot_pf >= 0
                    row_group[B:][own] = sg[row_slot_pf[own]]
                    lora = routing(row_group)
                (toks, emit, okm, dev_tokens, dev_active, dev_remaining,
                 cache) = self._gated_dispatch(
                    "engine.prefill", {"tick": tick, "tokens": int(off)},
                    lambda: rstep(self.params, *wave, dev_tokens, dev_active,
                                  dev_remaining, cache, self.cos, self.sin,
                                  lora))
                self.stats["prefill_dispatches"] += 1
                self.stats["ragged_steps"] += 1
                self.stats["prefills"] += n_started
                self.stats["prefill_tokens_admitted"] += int(off)
                self._tbu_used += int(off) + int(decode_mask.sum())
                self._tbu_cap += T
                self.stats["token_budget_util"] = (self._tbu_used
                                                   / self._tbu_cap)
                if prefix is not None:
                    note_prefix_stats()
                if self._lora:
                    note_adapter_stats()
                tick += 1
                toks_np, em_np, ok_np, act_np = _Record(
                    toks, emit, okm, dev_active).get().reshape(4, B)
                self.stats["host_sync_count"] += 1
                now = self._clock()
                force_free: List[int] = []
                for i in range(B):
                    req = slots[i]
                    if req is None:
                        # orphan emission — the canary, 0 by construction
                        self.stats["wasted_slot_steps"] += int(em_np[i])
                        continue
                    if decode_mask[i]:
                        bound[i] = max(0, bound[i] - 1)
                    if not ok_np[i]:
                        # poison (prompt chunk or decode step): the slot
                        # never emitted the garbage token; fails alone,
                        # its freed pages scrubbed
                        self._finish_poisoned(req, done)
                        free(i, scrub=True)
                        force_free.append(i)
                        continue
                    if em_np[i]:
                        t = int(toks_np[i])
                        req.tokens.append(t)
                        self.stats["tokens_emitted"] += 1
                        if decode_mask[i]:
                            if not act_np[i]:
                                req.done = True
                                done[req.rid] = req
                                free(i)
                        elif chunk_done[i]:
                            if prefix is not None:
                                register_prompt_pages(req, i)
                            if finished_host(req, t):
                                req.done = True
                                done[req.rid] = req
                                free(i)
                            else:
                                bound[i] = (req.max_new_tokens
                                            - len(req.tokens))
                    if slots[i] is not None and self._expired(req, now):
                        self._finish_timeout(req, done)
                        free(i)
                        force_free.append(i)
                if force_free:
                    deactivate(force_free)

        def spec_ragged_loop():
            """The speculative serving loop: replaces both admission and
            the segments. Every tick is ONE ragged wave: pass 1 assigns
            prompt chunks under the ``prefill_chunk`` budget, pass 2 a
            verify segment to every decoding slot (its current token plus
            up to ``spec_k`` drafts from its own history while wave rows
            remain, each later slot's base row reserved out of the draft
            space). One host readback a wave. A proposer that raises fails
            its own request only. Returns when no slot holds work."""
            nonlocal cache, dev_tokens, dev_active, dev_remaining, tick
            K = self._spec_k
            K1 = K + 1
            sstep = self._build_spec_wave_step()
            while True:
                pump(tick)
                place_arrivals()
                if not any(s is not None for s in slots):
                    return
                ids = np.zeros((T,), np.int32)
                row_slot = np.full((T,), -1, np.int32)
                row_off = np.zeros((T,), np.int32)
                q_start = np.zeros((B,), np.int32)
                q_len = np.zeros((B,), np.int32)
                spec_mask = np.zeros((B,), bool)
                drafts = np.full((B, K), -1, np.int32)
                k_eff = np.zeros((B,), np.int32)
                chunk_done = np.zeros((B,), bool)
                budgets = np.zeros((B,), np.int32)
                new_slot = np.zeros((B,), bool)
                start_len = np.zeros((B,), np.int32)
                off = 0
                budget_left = self._admit_budget()
                n_started = 0
                n_chunk_tokens = 0
                pre_dead: List[int] = []
                # pass 1: prompt chunks, the admission wave's assignment
                for i in range(B):
                    req = slots[i]
                    if req is None or req.prefilled >= len(_wave_src(req)):
                        continue
                    take = min(len(_wave_src(req)) - req.prefilled,
                               budget_left)
                    if take <= 0:
                        continue                  # budget spent this step
                    first = assign_chunk(
                        i, req, take, ids, row_slot, row_off, off, 0,
                        q_start, q_len, chunk_done, budgets, new_slot,
                        start_len)
                    if first < 0:
                        continue    # the fault site failed this request
                    n_started += first
                    off += take
                    budget_left -= take
                    n_chunk_tokens += take
                # pass 2: verify segments; later slots' base rows are
                # reserved out of the draft space
                dec = [i for i in range(B)
                       if slots[i] is not None and q_len[i] == 0
                       and slots[i].prefilled >= len(_wave_src(slots[i]))]
                n_spec = 0
                for di, i in enumerate(dec):
                    req = slots[i]
                    rem_host = req.max_new_tokens - len(req.tokens)
                    space = T - off - 1 - (len(dec) - di - 1)
                    # drafting past remaining - 1 is useless, and the cap
                    # keeps every provisional write inside the slot's
                    # reserved (private) decode horizon
                    cap_k = max(0, min(self._spec_k_eff(), rem_host - 1,
                                       space))
                    dr = np.zeros((0,), np.int32)
                    if cap_k > 0:
                        try:
                            # a failing proposer fails this request alone
                            faults.maybe_fail("engine.draft", rid=req.rid,
                                              slot=i)
                            dr = np.asarray(self._draft.propose(
                                np.asarray(req.output_ids, np.int32),
                                cap_k), np.int32).reshape(-1)[:cap_k]
                        except Exception as e:
                            fail_request(req, e)
                            free(i)
                            pre_dead.append(i)
                            continue
                    seg = 1 + len(dr)
                    k_eff[i] = len(dr)
                    drafts[i, :len(dr)] = dr
                    ids[off] = req.tokens[-1]
                    ids[off + 1:off + seg] = dr
                    row_slot[off:off + seg] = i
                    row_off[off:off + seg] = np.arange(seg)
                    q_start[i] = off
                    q_len[i] = seg
                    spec_mask[i] = True
                    off += seg
                    n_spec += 1
                    req.draft_proposed += len(dr)
                    self.stats["draft_tokens_proposed"] += len(dr)
                if pre_dead:
                    deactivate(pre_dead)
                if off == 0:
                    continue      # every pending slot failed its draft
                if prefix is not None:
                    ranges = chunk_ranges(np.where(spec_mask, 0, q_len))
                    for i in range(B):
                        if spec_mask[i]:
                            # the verify rows' provisional cells
                            req = slots[i]
                            seq0 = len(req.prompt) + len(req.tokens) - 1
                            ranges.append((i, seq0 // P,
                                           (seq0 + int(q_len[i]) - 1) // P))
                    cow_guard_and_flush(ranges)
                wave = [torch.as_tensor(a, device=dev) for a in (
                    ids, row_slot, row_off, q_start, q_len, spec_mask,
                    drafts, k_eff, chunk_done, budgets, new_slot,
                    start_len)]
                (cand, emitm, okm, dev_tokens, dev_active, dev_remaining,
                 cache) = self._gated_dispatch(
                    "engine.dispatch",
                    {"tick": tick, "tokens": int(off), "spec": True},
                    lambda: sstep(self.params, *wave, dev_tokens, dev_active,
                                  dev_remaining, cache, self.cos, self.sin))
                self.stats["ragged_steps"] += 1
                if n_chunk_tokens:
                    self.stats["prefill_dispatches"] += 1
                self.stats["prefills"] += n_started
                self.stats["prefill_tokens_admitted"] += n_chunk_tokens
                self._tbu_used += off
                self._tbu_cap += T
                self.stats["token_budget_util"] = (self._tbu_used
                                                   / self._tbu_cap)
                if prefix is not None:
                    note_prefix_stats()
                if n_spec:
                    self.stats["spec_steps"] += 1
                    self._spec_segs += n_spec
                tick += 1
                flat = _Record(cand, emitm, okm, dev_active).get()
                cand_np = flat[:B * K1].reshape(B, K1)
                em_np = flat[B * K1:2 * B * K1].reshape(B, K1).astype(bool)
                ok_np = flat[2 * B * K1:2 * B * K1 + B]
                act_np = flat[2 * B * K1 + B:]
                self.stats["host_sync_count"] += 1
                now = self._clock()
                force_free: List[int] = []
                for i in range(B):
                    req = slots[i]
                    if req is None:
                        # orphan emission — the canary, 0 by construction
                        self.stats["wasted_slot_steps"] += int(
                            em_np[i].sum())
                        continue
                    if q_len[i] == 0:
                        continue      # sat out this wave (budget spent)
                    if not ok_np[i]:
                        # poison (a prompt chunk, or a verify segment's row
                        # 0): nothing emitted or advanced; fails alone
                        self._finish_poisoned(req, done)
                        free(i, scrub=True)
                        force_free.append(i)
                        continue
                    n_emit_i = int(em_np[i].sum())
                    if spec_mask[i]:
                        acc = max(0, n_emit_i - 1)
                        req.draft_accepted += acc
                        self.stats["draft_tokens_accepted"] += acc
                        self._spec_tok += n_emit_i
                        bound[i] = max(0, bound[i] - n_emit_i)
                    for j in range(K1):
                        if em_np[i, j]:
                            req.tokens.append(int(cand_np[i, j]))
                            self.stats["tokens_emitted"] += 1
                    if spec_mask[i]:
                        if not act_np[i]:
                            req.done = True
                            done[req.rid] = req
                            free(i)
                    elif chunk_done[i] and n_emit_i:
                        if prefix is not None:
                            register_prompt_pages(req, i)
                        if finished_host(req, req.tokens[-1]):
                            req.done = True
                            done[req.rid] = req
                            free(i)
                        else:
                            bound[i] = (req.max_new_tokens
                                        - len(req.tokens))
                    if slots[i] is not None and self._expired(req, now):
                        self._finish_timeout(req, done)
                        free(i)
                        force_free.append(i)
                prop = self.stats["draft_tokens_proposed"]
                self.stats["acceptance_rate"] = (
                    self.stats["draft_tokens_accepted"] / prop
                    if prop else 0.0)
                if self._spec_segs:
                    self.stats["tokens_per_target_step"] = (
                        self._spec_tok / self._spec_segs)
                if force_free:
                    deactivate(force_free)

        def dispatch_segment():
            """Pick the segment length covering the largest remaining
            budget, enqueue the segment, start its record's copy to the
            host, and decrement the host-side bounds."""
            nonlocal cache, dev_tokens, dev_active, dev_remaining, tick
            seg = self._seg_bucket(max(bound[i] for i in range(B)
                                       if slots[i] is not None))
            if prefix is not None:
                flush_block_table()
            # one routing for the whole segment: a row a slot
            lora = routing(slot_groups()) if self._lora else None
            (toks, emitted, okm, dev_tokens, dev_active, dev_remaining,
             cache) = self._gated_dispatch(
                "engine.dispatch", {"tick": tick, "seg": seg},
                lambda: self._build_segment(seg)(
                    self.params, dev_tokens, cache, dev_active,
                    dev_remaining, self.cos, self.sin, lora))
            self.stats["segments"] += 1
            self.stats["decode_steps"] += seg
            tick += 1
            for i in range(B):
                if slots[i] is not None:
                    bound[i] = max(0, bound[i] - seg)
            return _Record(toks, emitted, okm, dev_active), seg

        def process_segment(rec) -> bool:
            """Wait for one segment's record and fold it into the host
            request table; enforce deadlines and quarantine poisoned slots
            at this boundary. Returns whether any slot is live."""
            record, seg = rec
            flat = record.get()
            toks_np = flat[:seg * B].reshape(seg, B)
            em_np = flat[seg * B:2 * seg * B].reshape(seg, B)
            ok_np = flat[2 * seg * B:2 * seg * B + B]
            act_np = flat[2 * seg * B + B:]
            self.stats["host_sync_count"] += 1
            now = self._clock()
            force_free: List[int] = []
            for i in range(B):
                req = slots[i]
                if req is None:
                    # device-emitted tokens with no owning request: 0 by
                    # construction (a force-freed or parked slot racing a
                    # segment in flight is the one legitimate source)
                    self.stats["wasted_slot_steps"] += int(em_np[:, i].sum())
                    continue
                try:
                    # the readback fault site fails this request, never the
                    # batch (Exception: a Ctrl-C here stops the loop)
                    faults.maybe_fail("engine.readback", rid=req.rid, slot=i)
                except Exception as e:
                    fail_request(req, e)
                    free(i)
                    force_free.append(i)
                    continue
                bad_token = False
                for s in range(seg):
                    if em_np[s, i]:
                        t = int(toks_np[s, i])
                        if not 0 <= t < self.cfg.vocab_size:
                            bad_token = True   # corrupt readback
                            break
                        req.tokens.append(t)
                        self.stats["tokens_emitted"] += 1
                if bad_token or not ok_np[i]:
                    self._finish_poisoned(req, done)
                    free(i, scrub=True)
                    force_free.append(i)
                    continue
                if not act_np[i]:
                    req.done = True
                    done[req.rid] = req
                    free(i)
                elif self._expired(req, now):
                    self._finish_timeout(req, done)
                    free(i)
                    force_free.append(i)
            if force_free:
                # a segment already in flight ran with the old mask; its
                # orphan tokens land in wasted_slot_steps above
                deactivate(force_free)
            return any(s is not None for s in slots)

        def admissible_soon():
            # could the admission after the next segment (at tick + 1)
            # admit anything? If not, lookahead past it is legal
            if self._draining:
                return False
            return any(r.arrival_segment <= tick + 1 for r in self._queue)

        # speculative serving drafts on the host, so its decode stretch
        # waits for every wave anyway: one wave loop, which returns with
        # every slot drained, replaces admission and the segments
        admit = spec_ragged_loop if self._spec else admit_ragged
        while ((self._queue and not self._draining)
               or any(s is not None for s in slots)):
            pump(tick)
            t0 = time.perf_counter()
            admit()
            self.stats["prefill_s"] += time.perf_counter() - t0
            if not any(s is not None for s in slots):
                if self._queue and not self._draining:
                    tick += 1   # nothing admitted yet, arrivals pending
                    continue
                break   # drained: queued requests stay in the queue
            t0 = time.perf_counter()
            if admissible_soon():
                # an admission decision follows this segment: no lookahead
                process_segment(dispatch_segment())
            else:
                # keep one segment in flight ahead of the readback; an
                # EOS-early drain wastes at most one no-op segment
                rec = dispatch_segment()
                while True:
                    pump(tick)
                    more = any(slots[i] is not None and bound[i] > 0
                               for i in range(B))
                    nxt = (dispatch_segment()
                           if more and not admissible_soon() else None)
                    if not process_segment(rec):
                        if nxt is not None:
                            process_segment(nxt)
                        break
                    if nxt is None:
                        break
                    rec = nxt
            self.stats["decode_s"] += time.perf_counter() - t0
        self.active_slots = 0
        if self._host_tier:
            # this run's tree dies with it, the host pager does not: drop
            # the tree's host slots so only parked streams keep residency,
            # and the binding to this run's pool
            prefix._offload = None
            prefix.drop_host_nodes()
            self._park_req.clear()
            self.stats["parked_slots"] = len(self._parked)
        return done
