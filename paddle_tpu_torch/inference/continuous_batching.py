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

The page layout is the identity one (slot b owns pages [b*pps,
(b+1)*pps)); PyTorch runs eagerly, so the JAX package's compiled-program
caches have no counterpart. ``stats`` keeps the JAX package's ragged-path
keys with the same meaning (docs/SERVING.md).

Not ported yet, and refused rather than served without (ROADMAP.md,
Queue 1): prefix caching, the host KV tier and the unified arena (the
``prefix_caching``/``kv_host_tier``/``unified_arena`` flags default on, so
pass ``prefix_caching=False``), multi-LoRA serving, sampling
(``temperature > 0``), dispatch retries (``retry_policy``), the bucketed
admission pipeline (``ragged=False``), and the fault-injection sites. A
resolved-on feature raises ``NotImplementedError``.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..framework import flags
from ..models.kv_cache import advance_by, advance_masked, create_paged_cache
from ..models.llama import (_logits_ok, _normalize_sampling, _pow2_bucket,
                            _pure_decoder_layer, _pure_lm_head_logits,
                            _rope_tables)


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
    started: bool = False              # first chunk has entered a wave
    # the prompt offset at which each of its prefill chunks began, in
    # admission order: a chunk's rows read the cells before its start from
    # the cache and its own rows fresh (what an int8 cache's rounding
    # depends on)
    chunk_starts: List[int] = field(default_factory=list)
    # speculative decoding: drafts proposed for and accepted from this
    # request (their ratio is its acceptance rate)
    draft_proposed: int = 0
    draft_accepted: int = 0
    # "ok" | "timeout" | "poisoned" | "error"
    status: str = "ok"
    error: Optional[str] = None         # repr of a per-request failure
    deadline_s: Optional[float] = None  # wall budget from submit time
    submit_t: float = 0.0               # engine clock at submit

    @property
    def output_ids(self):
        return list(map(int, self.prompt)) + self.tokens


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported to paddle_tpu_torch yet (ROADMAP.md, Queue "
        f"1, item 4); the ContinuousBatcher refuses rather than serving "
        f"without it")


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
    """Continuous-batching engine for ``LlamaForCausalLM``, greedy decode.

    Each request's tokens equal its solo ``model.generate_paged`` greedy
    rollout up to the summation order of the two paths (same kernels and
    math per row; exact on the CPU tests' margins). ``quantized_params``
    (``quantize_for_inference``) and ``cache_dtype="int8"`` serve the
    weight-only / int8-KV stack (page_size a multiple of 4 on the card,
    where the attention kernels copy a page's scales in 16-byte pieces).
    """

    def __init__(self, model, max_batch: int = 4, max_seq: int = 128,
                 page_size: int = 16, segment: int = 16,
                 eos_token_id: Optional[int] = None,
                 temperature: float = 0.0, top_k: Optional[int] = None,
                 top_p: Optional[float] = None,
                 max_pending: Optional[int] = None, retry_policy=None,
                 quantized_params=None, cache_dtype=None,
                 prefill_chunk: Optional[int] = None,
                 ragged: Optional[bool] = None,
                 prefix_caching: Optional[bool] = None,
                 spec_decode: Optional[bool] = None,
                 spec_k: Optional[int] = None, draft=None,
                 host_tier: Optional[bool] = None,
                 lora: Optional[bool] = None,
                 unified_arena: Optional[bool] = None):
        self.model = model
        self.cfg = model.config
        self.B = max_batch
        self.cap = max_seq
        self.page_size = page_size
        self.segment = segment
        self.eos = eos_token_id
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
            if spec and (not self._ragged or self.sampling is not None):
                raise ValueError("spec_decode requires ragged admission "
                                 "and greedy decoding")
        if lora is None:
            lora = (bool(flags.get_flag("lora_serving")) and self._ragged
                    and not spec)
        elif lora and (not self._ragged or spec):
            raise ValueError("lora requires ragged admission and excludes "
                             "spec_decode")
        if unified_arena is None:
            unified_arena = bool(flags.get_flag("unified_arena")) and prefix
        elif unified_arena and not prefix:
            raise ValueError("unified_arena requires prefix_caching")
        if host_tier is None:
            host_tier = bool(flags.get_flag("kv_host_tier")) and prefix
        elif host_tier and not prefix:
            raise ValueError("kv_host_tier requires prefix_caching")
        # ... and whatever resolves on that the port has not got, raises
        for on, what in ((not self._ragged, "bucketed admission "
                          "(ragged=False)"),
                         (prefix, "prefix caching (pass "
                          "prefix_caching=False)"),
                         (host_tier, "the host KV tier"),
                         (unified_arena, "the unified HBM arena"),
                         (lora, "multi-LoRA serving"),
                         (self.sampling is not None,
                          "sampling (temperature > 0)"),
                         (retry_policy is not None,
                          "the dispatch retry policy")):
            if on:
                raise _not_ported(what)
        self._spec = spec
        self._spec_k = int(flags.get_flag("spec_k") if spec_k is None
                           else spec_k)
        if spec and self._spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {self._spec_k}")
        if spec and draft is None:
            from .speculative import NGramDraft

            draft = NGramDraft()
        self._draft = draft
        # a live cap on the draft rows a verify segment may take (0: the
        # plain decode row); the wave's shape stays keyed on spec_k
        self._spec_k_cap: Optional[int] = None
        self._queue: deque = deque()
        self._next_rid = 0
        self.max_pending = max_pending
        self._clock = time.monotonic
        self._draining = False
        self.reset_stats()

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

    # ------------------------------------------------------- reliability

    def drain(self):
        """Stop admission; a running ``run()`` finishes in-flight slots and
        returns, leaving queued requests pending (see ``pending``)."""
        self._draining = True

    def reopen(self):
        """Re-enable admission after a ``drain()``."""
        self._draining = False

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
        Returns segment_fn(prms, tokens, cache, active, remaining,
        cos_full, sin_full) -> (toks (seg, B), emitted (seg, B), ok (B,),
        tokens, active, remaining, cache)."""
        from ..ops.kernels import fusion

        cfg = self.cfg
        L, eps = cfg.num_hidden_layers, cfg.rms_norm_eps
        nh, hk, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                      cfg.head_dim)
        B, eos = self.B, self.eos
        tied = self.model.lm_head is None

        def step(prms, token, cache, active, cos_full, sin_full):
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

                hidden = _pure_decoder_layer(prms, i, hidden, eps, attend)
            cache = advance_masked(cache, active)
            logits = _pure_lm_head_logits(prms, hidden, eps, tied)
            ok = _logits_ok(logits) | ~active
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            return torch.where(active, nxt, token), cache, ok

        def segment_fn(prms, tokens, cache, active, remaining, cos_full,
                       sin_full):
            okm = torch.ones_like(active)
            toks, emitted = [], []
            for _ in range(seg):
                nxt, cache, ok = step(prms, tokens, cache, active, cos_full,
                                      sin_full)
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
        step. Returns rstep(prms, chunk_ids, row_slot_pf, row_off_pf,
        q_start, chunk_len, decode_mask, chunk_done, budgets, new_slot,
        start_len, tokens, active, remaining, cache, cos_full, sin_full)
        -> (toks, emit, ok, tokens, active, remaining, cache)."""
        from ..ops.kernels import fusion

        cfg = self.cfg
        L, eps = cfg.num_hidden_layers, cfg.rms_norm_eps
        nh, hk, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                      cfg.head_dim)
        B, T, eos = self.B, self._ragged_T, self.eos
        tied = self.model.lm_head is None
        i32 = torch.int32

        def rstep(prms, chunk_ids, row_slot_pf, row_off_pf, q_start,
                  chunk_len, decode_mask, chunk_done, budgets, new_slot,
                  start_len, tokens, active, remaining, cache, cos_full,
                  sin_full):
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

                hidden = _pure_decoder_layer(prms, i, hidden, eps, attend)
            cache = cache._replace(seq_lens=(
                seq + torch.where(dec_eff, 1, chunk_len)).to(i32))
            # logits at each slot's LAST wave row: the next token of a
            # decode row, the first token of a completing prefill, a
            # poison probe for a mid-prefill chunk
            idx = torch.clamp(q_start + q_len_eff - 1, 0, T - 1).long()
            logits = _pure_lm_head_logits(prms, hidden[idx], eps, tied)
            participating = dec_eff | (chunk_len > 0)
            ok = _logits_ok(logits) | ~participating
            toks = torch.argmax(logits, dim=-1).to(i32)
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
               deadline_s: Optional[float] = None) -> int:
        """Queue a request. Raises Backpressure when the bounded pending
        queue (``max_pending``) is full. ``deadline_s`` is a wall budget
        from now: an expired request finishes with status "timeout" at the
        next admission or segment boundary."""
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
                                      submit_t=self._clock()))
        return rid

    def try_submit(self, prompt_ids, max_new_tokens: int = 16,
                   arrival_segment: int = 0,
                   deadline_s: Optional[float] = None) -> Optional[int]:
        """Non-raising submit: rid, or None when the queue is full."""
        try:
            return self.submit(prompt_ids, max_new_tokens, arrival_segment,
                               deadline_s)
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
        B, T = self.B, self._ragged_T
        cfg = self.cfg
        dev = self.device
        cache = create_paged_cache(
            cfg.num_hidden_layers, B, self.cap, cfg.num_key_value_heads,
            cfg.head_dim, page_size=self.page_size, dtype=self._cache_dtype,
            device=dev)
        # device-resident scheduler state
        dev_tokens = torch.zeros((B,), dtype=torch.int32, device=dev)
        dev_active = torch.zeros((B,), dtype=torch.bool, device=dev)
        dev_remaining = torch.zeros((B,), dtype=torch.int32, device=dev)
        slots: List[Optional[GenRequest]] = [None] * B
        # host-side upper bound on each slot's remaining budget (exact when
        # no EOS fires) — drives segment length and lookahead without a sync
        bound = [0] * B
        done: Dict[int, GenRequest] = {}
        tick = 0
        rstep = self._build_ragged_step()

        def arrived():
            if self._draining:
                return []
            return [r for r in self._queue if r.arrival_segment <= tick]

        def finished_host(req, tok):
            if self.eos is not None and tok == self.eos:
                return True
            return len(req.tokens) >= req.max_new_tokens

        def pop_admissible():
            """Next arrived request that has not blown its deadline
            (expired ones finish with status "timeout" here)."""
            while True:
                cands = arrived()
                if not cands:
                    return None
                req = cands[0]
                self._queue.remove(req)
                if self._expired(req, self._clock()):
                    self._finish_timeout(req, done)
                    continue
                return req

        def free(i):
            slots[i] = None
            bound[i] = 0

        def deactivate(idx):
            nonlocal dev_active
            keep = np.ones((B,), bool)
            keep[idx] = False
            dev_active = dev_active & torch.as_tensor(keep, device=dev)

        def place_arrivals():
            for i in range(B):
                if slots[i] is None and arrived():
                    req = pop_admissible()
                    if req is None:
                        break
                    req.prefilled = 0
                    req.started = False
                    req.chunk_starts.clear()
                    slots[i] = req

        def assign_chunk(i, req, take, ids_buf, rs_buf, ro_buf, pos, base,
                         q_start, q_len, chunk_done, budgets, new_slot,
                         start_len):
            """Assign ``take`` prompt tokens of slot i's request into the
            wave's chunk buffers at row ``pos`` (wave row ``base + pos``).
            Returns 1 on the request's first chunk, else 0."""
            first = 0
            if not req.started:
                new_slot[i] = True
                start_len[i] = req.prefilled
                req.started = True
                first = 1
            ids_buf[pos:pos + take] = req.prompt[req.prefilled:
                                                 req.prefilled + take]
            rs_buf[pos:pos + take] = i
            ro_buf[pos:pos + take] = np.arange(take)
            req.chunk_starts.append(req.prefilled)
            q_start[i] = base + pos
            q_len[i] = take
            budgets[i] = req.max_new_tokens - len(req.tokens)
            req.prefilled += take
            chunk_done[i] = req.prefilled == len(req.prompt)
            return first

        def admit_ragged():
            """Token-budget admission: each step assigns up to
            ``prefill_chunk`` prompt tokens and runs them together with
            every active decode slot as one ragged wave; loops until no
            prompt tokens are pending (the segments take over the
            pure-decode stretch). One host readback per step."""
            nonlocal cache, dev_tokens, dev_active, dev_remaining, tick
            pw = T - B
            while True:
                place_arrivals()
                if not any(s is not None and s.prefilled < len(s.prompt)
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
                budget_left = self.prefill_chunk
                n_started = 0
                for i in range(B):
                    req = slots[i]
                    if req is None:
                        continue
                    if req.prefilled >= len(req.prompt):
                        decode_mask[i] = True     # decodes alongside
                        q_start[i] = i
                        continue
                    take = min(len(req.prompt) - req.prefilled, budget_left)
                    if take <= 0:
                        continue                  # budget spent this step
                    n_started += assign_chunk(
                        i, req, take, chunk_ids, row_slot_pf, row_off_pf, off,
                        B, q_start, chunk_len, chunk_done, budgets, new_slot,
                        start_len)
                    off += take
                    budget_left -= take
                wave = [torch.as_tensor(a, device=dev) for a in (
                    chunk_ids, row_slot_pf, row_off_pf, q_start, chunk_len,
                    decode_mask, chunk_done, budgets, new_slot, start_len)]
                (toks, emit, okm, dev_tokens, dev_active, dev_remaining,
                 cache) = rstep(self.params, *wave, dev_tokens, dev_active,
                                dev_remaining, cache, self.cos, self.sin)
                self.stats["prefill_dispatches"] += 1
                self.stats["ragged_steps"] += 1
                self.stats["prefills"] += n_started
                self.stats["prefill_tokens_admitted"] += int(off)
                self._tbu_used += int(off) + int(decode_mask.sum())
                self._tbu_cap += T
                self.stats["token_budget_util"] = (self._tbu_used
                                                   / self._tbu_cap)
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
                        # never emitted the garbage token; fails alone
                        self._finish_poisoned(req, done)
                        free(i)
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
                budget_left = self.prefill_chunk
                n_started = 0
                n_chunk_tokens = 0
                pre_dead: List[int] = []
                # pass 1: prompt chunks, the admission wave's assignment
                for i in range(B):
                    req = slots[i]
                    if req is None or req.prefilled >= len(req.prompt):
                        continue
                    take = min(len(req.prompt) - req.prefilled, budget_left)
                    if take <= 0:
                        continue                  # budget spent this step
                    n_started += assign_chunk(
                        i, req, take, ids, row_slot, row_off, off, 0,
                        q_start, q_len, chunk_done, budgets, new_slot,
                        start_len)
                    off += take
                    budget_left -= take
                    n_chunk_tokens += take
                # pass 2: verify segments; later slots' base rows are
                # reserved out of the draft space
                dec = [i for i in range(B)
                       if slots[i] is not None and q_len[i] == 0
                       and slots[i].prefilled >= len(slots[i].prompt)]
                n_spec = 0
                for di, i in enumerate(dec):
                    req = slots[i]
                    rem_host = req.max_new_tokens - len(req.tokens)
                    space = T - off - 1 - (len(dec) - di - 1)
                    # drafting past remaining - 1 is useless, and the cap
                    # keeps every provisional write inside the capacity
                    cap_k = max(0, min(self._spec_k_eff(), rem_host - 1,
                                       space))
                    dr = np.zeros((0,), np.int32)
                    if cap_k > 0:
                        try:
                            dr = np.asarray(self._draft.propose(
                                np.asarray(req.output_ids, np.int32),
                                cap_k), np.int32).reshape(-1)[:cap_k]
                        except Exception as e:
                            req.status = "error"
                            req.error = repr(e)
                            req.done = True
                            done[req.rid] = req
                            self.stats["request_errors"] += 1
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
                wave = [torch.as_tensor(a, device=dev) for a in (
                    ids, row_slot, row_off, q_start, q_len, spec_mask,
                    drafts, k_eff, chunk_done, budgets, new_slot,
                    start_len)]
                (cand, emitm, okm, dev_tokens, dev_active, dev_remaining,
                 cache) = sstep(self.params, *wave, dev_tokens, dev_active,
                                dev_remaining, cache, self.cos, self.sin)
                self.stats["ragged_steps"] += 1
                if n_chunk_tokens:
                    self.stats["prefill_dispatches"] += 1
                self.stats["prefills"] += n_started
                self.stats["prefill_tokens_admitted"] += n_chunk_tokens
                self._tbu_used += off
                self._tbu_cap += T
                self.stats["token_budget_util"] = (self._tbu_used
                                                   / self._tbu_cap)
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
                        free(i)
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
            (toks, emitted, okm, dev_tokens, dev_active, dev_remaining,
             cache) = self._build_segment(seg)(
                self.params, dev_tokens, cache, dev_active, dev_remaining,
                self.cos, self.sin)
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
                    # construction (a force-freed slot racing a segment in
                    # flight is the one legitimate source)
                    self.stats["wasted_slot_steps"] += int(em_np[:, i].sum())
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
                    free(i)
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
        return done
