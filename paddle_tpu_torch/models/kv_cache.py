"""Paged KV cache for incremental decode (``paddle_tpu/models/kv_cache.py``).

A float cache holds K/V verbatim. An int8 cache (``create_paged_cache(
dtype=torch.int8)``) holds symmetric-absmax codes, with one f32 scale per
written (head, token) cell in the scale pools ``k_scales``/``v_scales``
(L, Hk, P, page, 1); every writer quantizes on write through
``_quantize_cells``, and ``layer_scales`` gives the readers the scales
(``(None, None)`` on a float cache).

Page pool layout: ``(L, Hk, P, page, D)`` with ``P = batch *
pages_per_seq``; sequence b owns the contiguous physical pages
``[b*pps, (b+1)*pps)`` and every access routes through ``block_tables``.

Unlike the JAX package's pure updates, the writers here update the page
pools IN PLACE (a decode step would otherwise copy the whole pool per
layer) and return the state with any new ``seq_lens``. The writers are
``prefill_paged_cache`` (a whole prompt, identity layout),
``append_token_masked`` (one token per slot) and ``append_tokens_ragged``
(a ragged wave of rows, each at its own slot and position).
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

    @property
    def quantized(self):
        return self.k_scales is not None


def _quantize_cells(x):
    """Symmetric absmax int8 over the last (head_dim) axis: one scale per
    cell. Returns (codes int8, scales f32 (..., 1)): scale = max(max|x| /
    127, 1e-12), code = clip(round-half-even(x / scale), -127, 127) — THE
    quantize-on-write rule (K3 repeats it in-kernel). The divisor is a
    tensor: CUDA turns a division by a Python scalar into a multiplication
    by its reciprocal, which can miss the IEEE quotient by an ulp."""
    xf = x.float()
    scale = torch.clamp(
        xf.abs().amax(dim=-1, keepdim=True) / xf.new_tensor(127.0),
        min=1e-12)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


#: public name of the write rule
quantize_cells = _quantize_cells


def layer_scales(state: PagedCacheState, layer: int):
    """(k_scales, v_scales) for ``layer`` — (None, None) on a float cache."""
    if state.k_scales is None:
        return None, None
    return state.k_scales[layer], state.v_scales[layer]


def create_paged_cache(num_layers: int, batch: int, max_len: int,
                       num_kv_heads: int, head_dim: int, page_size: int = 16,
                       dtype=torch.float32, device=None) -> PagedCacheState:
    """``dtype`` a float dtype (pages hold K/V verbatim) or ``torch.int8``
    (code pools plus f32 scale pools (L, Hk, P, page, 1))."""
    quantized = dtype == torch.int8
    if not (dtype.is_floating_point or quantized):
        raise ValueError(f"KV cache dtype must be a float dtype or int8, "
                         f"got {dtype}")
    pages_per_seq = -(-max_len // page_size)
    p_total = batch * pages_per_seq
    shape = (num_layers, num_kv_heads, p_total, page_size, head_dim)
    s_shape = shape[:-1] + (1,)
    bt = (torch.arange(batch, device=device)[:, None] * pages_per_seq
          + torch.arange(pages_per_seq, device=device)[None, :])

    def scales():
        return (torch.zeros(s_shape, dtype=torch.float32, device=device)
                if quantized else None)

    return PagedCacheState(
        k_pages=torch.zeros(shape, dtype=dtype, device=device),
        v_pages=torch.zeros(shape, dtype=dtype, device=device),
        block_tables=bt.to(torch.int32),
        seq_lens=torch.zeros((batch,), dtype=torch.int32, device=device),
        k_scales=scales(), v_scales=scales(),
    )


def kv_page_nbytes(num_layers: int, num_kv_heads: int, page_size: int,
                   head_dim: int, dtype=torch.float32) -> int:
    """Bytes one KV page takes across every layer's K and V pools; an int8
    cache adds 4 bytes of f32 scale per cell."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    cell = page_size * head_dim * itemsize
    if dtype == torch.int8:
        cell += page_size * 4
    return 2 * num_layers * num_kv_heads * cell


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

    if state.quantized:
        (k, ks), (v, vs) = _quantize_cells(k), _quantize_cells(v)
        state.k_scales[layer] = to_pool(ks)
        state.v_scales[layer] = to_pool(vs)
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
    pairs = [(state.k_pages[layer], k_new), (state.v_pages[layer], v_new)]
    if state.quantized:
        # quantize-on-write: per-cell scales keep the append local
        (kq, ks), (vq, vs) = _quantize_cells(k_new), _quantize_cells(v_new)
        pairs = [(state.k_pages[layer], kq), (state.v_pages[layer], vq),
                 (state.k_scales[layer], ks), (state.v_scales[layer], vs)]
    for pool, new in pairs:
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


def append_tokens_ragged(state: PagedCacheState, layer: int, k_new, v_new,
                         row_slot, row_pos, valid) -> PagedCacheState:
    """Write a ragged wave's K/V (T, Hk, D): row r lands at (slot
    ``row_slot[r]``, position ``row_pos[r]``); invalid rows write nothing.
    Does not advance ``seq_lens``; quantizes on write on an int8 cache.

    Valid rows target distinct cells, but an invalid row's clamped cell
    may be one of them, and a scatter with repeated indices leaves the
    winner undefined. So every invalid row is routed to the first valid
    row's cell with that row's value (any winner writes the same bytes),
    or, when no row is valid, writes that cell's old bytes back. No
    boolean-mask indexing: nothing here waits for the device."""
    page = state.page_size
    n_slots, pps = state.block_tables.shape
    dev = state.seq_lens.device
    valid = torch.as_tensor(valid, device=dev).bool()
    pos = torch.clamp(torch.as_tensor(row_pos, device=dev).long(), min=0)
    slot = torch.clamp(torch.as_tensor(row_slot, device=dev).long(), 0,
                       n_slots - 1)
    phys = state.block_tables[slot, torch.clamp(pos // page, max=pps - 1)]
    off = pos % page
    r0 = torch.argmax(valid.int())                 # first valid row, or 0
    any_valid = valid.any()
    phys = torch.where(valid, phys.long(), phys[r0].long())
    off = torch.where(valid, off, off[r0])
    pairs = [(state.k_pages[layer], k_new), (state.v_pages[layer], v_new)]
    if state.quantized:
        (kq, ks), (vq, vs) = _quantize_cells(k_new), _quantize_cells(v_new)
        pairs = [(state.k_pages[layer], kq), (state.v_pages[layer], vq),
                 (state.k_scales[layer], ks), (state.v_scales[layer], vs)]
    m = valid[:, None, None]
    for pool, new in pairs:
        # pool (Hk, P, page, X); new (T, Hk, X)
        new = new.to(pool.dtype)
        first = torch.where(any_valid, new[r0],
                            pool[:, phys[r0], off[r0], :])       # (Hk, X)
        rows = torch.where(m, new, first[None])
        pool[:, phys, off, :] = rows.transpose(0, 1)
    return state


def advance_masked(state: PagedCacheState, active) -> PagedCacheState:
    return state._replace(seq_lens=state.seq_lens + active.to(torch.int32))


def advance(state: PagedCacheState) -> PagedCacheState:
    return state._replace(seq_lens=state.seq_lens + 1)


def advance_by(state: PagedCacheState, delta) -> PagedCacheState:
    """Advance each slot's seq_len by ``delta`` (B,): the speculative
    rewind. A verify step writes k + 1 cells a slot and advances by the
    accepted length only; the rejected cells stay as stale bytes past
    seq_len (int8: with their scales), which every reader masks and the
    next append overwrites."""
    return state._replace(
        seq_lens=(state.seq_lens + torch.as_tensor(
            delta, device=state.seq_lens.device)).to(torch.int32))
