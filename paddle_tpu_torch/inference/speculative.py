"""Self-speculative decoding: draft proposers and the greedy acceptance rule
(``paddle_tpu/inference/speculative.py``).

A decode step emits one token per target-model dispatch. Speculative
decoding breaks that ceiling without a second model: a cheap DRAFT proposes
up to k continuation tokens per slot, the target model verifies all k + 1
positions (the current token and the drafts) in ONE ragged wave, and the
longest draft prefix matching the target argmax is accepted, plus the
"bonus" target token at the first mismatch. Greedy output is lossless:
every accepted token is the token the plain decode path would have emitted.

Two consumers: ``ContinuousBatcher(spec_decode=True)`` (verify segments ride
the ragged waves beside neighbours' prompt chunks) and
``LlamaForCausalLM.generate_paged(spec_decode=True)``, the parity oracle
(one host sync a verify step).

``NGramDraft`` is prompt-lookup decoding: host numpy over tokens the
scheduler already holds. ``greedy_accept`` and ``segment_row_index`` run on
the device and never wait for it.

Exactness on an int8 cache: a verify row reads its own segment's keys and
values through the wave's fresh source, where the plain decode step reads
the same positions back from the page pool. The serving seams therefore
mark verify segments ``fresh_pool_read`` (``ops/kernels/fusion.py``
``ragged_attend``): their fresh K/V pass through the pool representation
(quantize, then codes * scale, on an int8 cache; the pool-dtype cast on a
float cache) before the score and value products.
"""

from __future__ import annotations

import numpy as np
import torch


class DraftProposer:
    """Interface for speculative draft sources.

    ``propose(history, k)`` returns up to ``k`` int32 draft tokens
    continuing ``history`` (the slot's prompt and generated tokens so far,
    on the host). Fewer than k, or none, is normal: that slot then
    verifies a plain decode row, the exact non-speculative math."""

    def propose(self, history: np.ndarray, k: int) -> np.ndarray:
        raise NotImplementedError


class NGramDraft(DraftProposer):
    """Prompt-lookup decoding: match the last ``n`` tokens of the history
    against every earlier position of the same history, longest n first,
    most recent occurrence preferred, and propose the k tokens that
    followed the match. No match: no drafts."""

    def __init__(self, n: int = 3, min_n: int = 1):
        if n < 1 or min_n < 1 or min_n > n:
            raise ValueError(f"need 1 <= min_n <= n, got n={n} "
                             f"min_n={min_n}")
        self.n = int(n)
        self.min_n = int(min_n)

    def propose(self, history: np.ndarray, k: int) -> np.ndarray:
        hist = np.asarray(history, np.int32).reshape(-1)
        empty = np.zeros((0,), np.int32)
        if k <= 0 or len(hist) < self.min_n + 1:
            return empty
        for size in range(min(self.n, len(hist) - 1), self.min_n - 1, -1):
            pattern = hist[-size:]
            # every window of `size` tokens that ends before the tail (a
            # match at the tail itself would propose tokens we have)
            n_win = len(hist) - size
            windows = (np.lib.stride_tricks.sliding_window_view(
                hist[:-1], size) if n_win > 0
                else hist[:0].reshape(0, size))
            hits = np.flatnonzero((windows == pattern).all(axis=1))
            hits = hits[hits + size < len(hist)]
            if len(hits) == 0:
                continue
            start = int(hits[-1]) + size     # the most recent occurrence
            return hist[start:start + k].astype(np.int32)
        return empty


def greedy_accept(cand, drafts, k_eff, remaining, eos=None, fin_ok=None,
                  gate=None):
    """The greedy acceptance rule, on the device (no host sync).

    cand (B, K+1) int32: the target argmax at each verify row; drafts (B,
    K) int32 (pad -1, which never matches); k_eff (B,) drafts proposed;
    remaining (B,) the slot's token budget; ``eos`` stops emission after
    the first eos token (which is emitted); ``fin_ok`` (B, K+1) bool: a
    non-finite row is an acceptance barrier; ``gate`` (B,) bool: slots
    that take part.

    Returns (emit (B, K+1) bool, n_emit (B,) int32): draft j is accepted
    while it equals cand[:, j]; the first mismatch row adds its target
    token as the bonus. The caller advances seq_lens by n_emit
    (``kv_cache.advance_by``): rejected cells stay as stale bytes past it."""
    b, k1 = cand.shape
    k = k1 - 1
    dev = cand.device
    i32 = torch.int32
    jd = torch.arange(k, dtype=i32, device=dev)[None, :]
    match = (drafts == cand[:, :k]) & (jd < k_eff[:, None])
    if fin_ok is not None:
        match = match & fin_ok[:, :k]
    n_acc = torch.cumprod(match.to(i32), dim=1).sum(dim=1)
    j = torch.arange(k1, dtype=i32, device=dev)[None, :]
    emit = (j <= n_acc[:, None]) & (j < remaining[:, None])
    if fin_ok is not None:
        emit = emit & (torch.cumprod(fin_ok.to(i32), dim=1) > 0)
    if eos is not None:
        is_eos = (cand == eos).to(i32)
        emit = emit & ((torch.cumsum(is_eos, dim=1) - is_eos) == 0)
    if gate is not None:
        emit = emit & gate[:, None]
    return emit, emit.to(i32).sum(dim=1).to(i32)


def segment_row_index(q_start, q_len, k1: int, t_total: int):
    """(B, k1) wave-row indices: row j of each slot's segment, clamped to
    its last live row and to the wave; column k1 - 1 is pinned to the
    segment's LAST row (also for a prefill chunk longer than k1), which is
    where a single-token consumer reads its logits."""
    last = torch.clamp(q_len, min=1)[:, None].long() - 1
    j = torch.arange(k1, device=q_start.device)[None, :]
    row = torch.where(j == k1 - 1, last, torch.minimum(j, last))
    return torch.clamp(q_start[:, None].long() + row, 0, t_total - 1)
