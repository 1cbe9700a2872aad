"""Paged KV cache for incremental decode (``paddle_tpu/models/kv_cache.py``).

Float cache only; the int8 cache (per-cell scales) is a later slice, so
``k_scales``/``v_scales`` stay ``None`` here and ``layer_scales`` returns
``(None, None)``.

Page pool layout: ``(L, Hk, P, page, D)`` with ``P = batch *
pages_per_seq``; sequence b owns the contiguous physical pages
``[b*pps, (b+1)*pps)`` and every access routes through ``block_tables``.

Unlike the JAX package's pure updates, the writers here update the page
pools IN PLACE (a decode step would otherwise copy the whole pool per
layer) and return the state with any new ``seq_lens``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class PagedCacheState(NamedTuple):
    k_pages: torch.Tensor       # (L, Hk, P, page, D)
    v_pages: torch.Tensor       # (L, Hk, P, page, D)
    block_tables: torch.Tensor  # (B, pages_per_seq) int32
    seq_lens: torch.Tensor      # (B,) int32
    k_scales: Optional[torch.Tensor] = None
    v_scales: Optional[torch.Tensor] = None

    @property
    def page_size(self):
        return self.k_pages.shape[3]


def layer_scales(state: PagedCacheState, layer: int):
    """(k_scales, v_scales) for ``layer`` — (None, None) on a float cache."""
    if state.k_scales is None:
        return None, None
    return state.k_scales[layer], state.v_scales[layer]


def create_paged_cache(num_layers: int, batch: int, max_len: int,
                       num_kv_heads: int, head_dim: int, page_size: int = 16,
                       dtype=torch.float32, device=None) -> PagedCacheState:
    if not dtype.is_floating_point:
        raise ValueError(f"only a float KV cache is supported, got {dtype}")
    pages_per_seq = -(-max_len // page_size)
    p_total = batch * pages_per_seq
    shape = (num_layers, num_kv_heads, p_total, page_size, head_dim)
    bt = (torch.arange(batch, device=device)[:, None] * pages_per_seq
          + torch.arange(pages_per_seq, device=device)[None, :])
    return PagedCacheState(
        k_pages=torch.zeros(shape, dtype=dtype, device=device),
        v_pages=torch.zeros(shape, dtype=dtype, device=device),
        block_tables=bt.to(torch.int32),
        seq_lens=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def _to_identity_pool(x, pps: int, page: int):
    """(B, S_cap, Hk, D) -> (Hk, B*pps, page, D): the identity page layout."""
    b, s_cap, hk, d = x.shape
    x = x.reshape(b, pps, page, hk, d)
    return x.permute(3, 0, 1, 2, 4).reshape(hk, b * pps, page, d)


def prefill_paged_cache(state: PagedCacheState, layer: int, k, v,
                        lens) -> PagedCacheState:
    """Write a full prompt's K/V (B, S, Hk, D) into the pages of ``layer``
    from position 0; ``lens`` (B,) becomes ``seq_lens``."""
    b, s, hk, d = k.shape
    page = state.page_size
    pages_per_seq = state.block_tables.shape[1]
    if state.k_pages.shape[2] != b * pages_per_seq:
        raise ValueError("identity-layout prompt write needs a "
                         f"{b * pages_per_seq}-page pool")
    pad = pages_per_seq * page - s
    if pad < 0:
        raise ValueError(f"prompt length {s} exceeds cache capacity "
                         f"{pages_per_seq * page}")

    def to_pool(x):
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        return _to_identity_pool(x, pages_per_seq, page)

    state.k_pages[layer] = to_pool(k).to(state.k_pages.dtype)
    state.v_pages[layer] = to_pool(v).to(state.v_pages.dtype)
    return state._replace(seq_lens=torch.as_tensor(
        lens, dtype=torch.int32, device=state.seq_lens.device))


def append_token_masked(state: PagedCacheState, layer: int, k_new, v_new,
                        active) -> PagedCacheState:
    """Write one token's K/V (B, Hk, D) at each active slot's current
    length; inactive slots keep their cells. Does not advance
    ``seq_lens``."""
    page = state.page_size
    pos = state.seq_lens.long()
    logical = torch.clamp(pos // page, max=state.block_tables.shape[1] - 1)
    off = pos % page
    rows = torch.arange(pos.shape[0], device=pos.device)
    phys = state.block_tables[rows, logical].long()
    m = active[None, :, None]
    for pool, new in ((state.k_pages[layer], k_new),
                      (state.v_pages[layer], v_new)):
        # pool view (Hk, P, page, D); [:, (B,), (B,), :] is (Hk, B, D)
        pool[:, phys, off, :] = torch.where(
            m, new.transpose(0, 1).to(pool.dtype), pool[:, phys, off, :])
    return state


def append_token(state: PagedCacheState, layer: int, k_new,
                 v_new) -> PagedCacheState:
    """``append_token_masked`` with every slot active."""
    active = torch.ones((k_new.shape[0],), dtype=torch.bool,
                        device=k_new.device)
    return append_token_masked(state, layer, k_new, v_new, active)


def advance(state: PagedCacheState) -> PagedCacheState:
    return state._replace(seq_lens=state.seq_lens + 1)
