"""Paged KV cache for incremental decode (``paddle_tpu/models/kv_cache.py``).

A float cache holds K/V verbatim. An int8 cache (``create_paged_cache(
dtype=torch.int8)``) holds symmetric-absmax codes, with one f32 scale per
written (head, token) cell in the scale pools ``k_scales``/``v_scales``
(L, Hk, P, page, 1); every writer quantizes on write through
``_quantize_cells``, and ``layer_scales`` gives the readers the scales
(``(None, None)`` on a float cache).

Page pool layout: ``(L, Hk, P, page, D)``. By default ``P = batch *
pages_per_seq`` and sequence b owns the contiguous physical pages
``[b*pps, (b+1)*pps)`` (the identity layout); every access routes through
``block_tables``. A pool with ``extra_pages`` or a ``total_pages`` size is
table-routed only: a ``PageAllocator`` hands its pages out, the prefix
cache shares them between rows (``clone_pages`` is the copy-on-write
move), and ``HostPageArena`` is the host tier pages demote to and park in.

Unlike the JAX package's pure updates, the writers here update the page
pools IN PLACE (a decode step would otherwise copy the whole pool per
layer) and return the state with any new ``seq_lens``. The writers are
``prefill_paged_cache`` (a whole prompt, identity layout),
``append_token_masked`` (one token per slot) and ``append_tokens_ragged``
(a ragged wave of rows, each at its own slot and position).
"""

from __future__ import annotations

from collections import deque
from typing import List, NamedTuple, Optional

import numpy as np
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
                       dtype=torch.float32, extra_pages: int = 0,
                       total_pages: Optional[int] = None, *,
                       device=None) -> PagedCacheState:
    """``dtype`` a float dtype (pages hold K/V verbatim) or ``torch.int8``
    (code pools plus f32 scale pools (L, Hk, P, page, 1)).

    ``extra_pages`` appends physical pages beyond the identity
    ``batch * pages_per_seq``; ``total_pages`` instead sets the pool size
    outright and may under-provision it. Either way the pool is
    table-routed only (the identity-layout prompt write refuses it), and
    every block-table entry starts clamped into range."""
    quantized = dtype == torch.int8
    if not (dtype.is_floating_point or quantized):
        raise ValueError(f"KV cache dtype must be a float dtype or int8, "
                         f"got {dtype}")
    pages_per_seq = -(-max_len // page_size)
    if extra_pages < 0:
        raise ValueError(f"extra_pages must be >= 0, got {extra_pages}")
    if total_pages is None:
        p_total = batch * pages_per_seq + extra_pages
    else:
        if total_pages < 1:
            raise ValueError(f"total_pages must be >= 1, "
                             f"got {total_pages}")
        p_total = int(total_pages)
    shape = (num_layers, num_kv_heads, p_total, page_size, head_dim)
    s_shape = shape[:-1] + (1,)
    bt = torch.clamp(
        torch.arange(batch, device=device)[:, None] * pages_per_seq
        + torch.arange(pages_per_seq, device=device)[None, :],
        max=p_total - 1)

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


# ---------------------------------------------------------------------------
# Page sharing and the host tier: the copy-on-write clone, the host page
# arena, and the refcounted free list that owns which row points where.
# ---------------------------------------------------------------------------


def _pools(state: PagedCacheState):
    """The state's page pools: K and V, and the scale pools on int8."""
    if state.quantized:
        return (state.k_pages, state.v_pages, state.k_scales,
                state.v_scales)
    return state.k_pages, state.v_pages


def clone_pages(state: PagedCacheState, src, dst) -> PagedCacheState:
    """Copy whole physical pages ``src[i] -> dst[i]`` across every layer,
    in place: K and V and, on an int8 cache, the scale cells in the same
    move (a cloned page keeps its scales). The copy-on-write move: a slot
    about to write into a page another reference can see gets a private
    clone first. One gather and one scatter a pool."""
    dev = state.k_pages.device
    src = torch.as_tensor(np.asarray(src, np.int64), device=dev)
    dst = torch.as_tensor(np.asarray(dst, np.int64), device=dev)
    for pool in _pools(state):
        pool[:, :, dst] = pool[:, :, src]
    return state


def scrub_pages(state: PagedCacheState, pages) -> PagedCacheState:
    """Zero whole physical pages (and their scale cells), in place: a
    quarantined slot's freed pages may hold non-finite K/V, which a masked
    read would turn into NaN (0 x NaN)."""
    idx = torch.as_tensor(np.asarray(pages, np.int64),
                          device=state.k_pages.device)
    for pool in _pools(state):
        pool[:, :, idx] = 0
    return state


class HostPageArena:
    """Host-RAM page tier: one host slot holds one physical page's K and V
    across every layer and, on an int8 cache, its scale cells (the
    ``clone_pages`` unit, so a demoted int8 page is never re-scaled).

    Storage is ONE host buffer, pinned when the pool lives on the card,
    laid out slot-major (``k[slot]`` is one page's (L, Hk, page, D)
    block, contiguous), so every page moves as one contiguous copy:

      * ``store`` (device -> host) blocks until the pages' bytes are on the
        host: one gather on the device, a copy a slot into its pinned
        block, one wait. It reads what every write enqueued before it left.
      * ``load`` (host -> device) is enqueued on the current stream, in
        chunks of ``depth`` pages (a copy a slot into a device buffer, one
        scatter into the pool a chunk), so the next wave reads the pages
        after them. A later ``store`` into the same host slots waits for
        the stream, so the caller may free the slots once ``load``
        returns.

    Which slots are live is the caller's ``PageAllocator``'s business."""

    def __init__(self, n_pages: int, template: PagedCacheState):
        if n_pages < 1:
            raise ValueError(f"n_pages must be >= 1, got {n_pages}")
        self.n_pages = int(n_pages)
        layers, hk, _, page, d = template.k_pages.shape
        self.quantized = template.quantized
        dt = template.k_pages.dtype
        blk = (self.n_pages, layers, hk, page, d)
        parts = [(dt, blk), (dt, blk)]
        if self.quantized:
            parts += [(torch.float32, blk[:-1] + (1,))] * 2
        sizes = [int(np.prod(sh)) * torch.empty((), dtype=t).element_size()
                 for t, sh in parts]
        pin = template.k_pages.is_cuda
        self._buf = torch.zeros((sum(sizes),), dtype=torch.uint8,
                                pin_memory=pin)
        views, off = [], 0
        for (t, sh), n in zip(parts, sizes):
            views.append(self._buf[off:off + n].view(t).view(sh))
            off += n
        self.k, self.v = views[0], views[1]
        if self.quantized:
            self.k_scales, self.v_scales = views[2], views[3]
        else:
            self.k_scales = self.v_scales = None

    def _host(self):
        if self.quantized:
            return self.k, self.v, self.k_scales, self.v_scales
        return self.k, self.v

    def nbytes(self) -> int:
        return int(self._buf.numel())

    @property
    def pinned(self) -> bool:
        return bool(self._buf.is_pinned())

    def page_spec(self) -> dict:
        """Shape and dtype of one page block."""
        _, layers, hk, page, d = self.k.shape
        return {"layers": int(layers), "kv_heads": int(hk),
                "page_size": int(page), "head_dim": int(d),
                "dtype": str(self.k.dtype).replace("torch.", ""),
                "quantized": bool(self.quantized)}

    def export_pages(self, host_pages) -> List[dict]:
        """Host slots -> self-contained page blocks, the JAX package's
        unit: ``k``/``v`` of shape ``(layers, kv_heads, page, head_dim)``
        and, on a quantized arena, ``k_scales``/``v_scales`` of shape
        ``(layers, kv_heads, page, 1)``. The blocks are COPIES (CPU
        tensors): the slots may be freed or overwritten independently, so
        a migration that fails in flight leaves the source intact."""
        names = ("k", "v", "k_scales", "v_scales")
        return [{n: t[int(p)].clone() for n, t in zip(names, self._host())}
                for p in host_pages]

    def import_pages(self, host_pages, blocks) -> None:
        """Write exported page blocks into this arena's slots. Every block
        is checked against the local page shape, dtype and quantization
        before any byte lands."""
        host_pages = [int(p) for p in host_pages]
        if len(host_pages) != len(blocks):
            raise ValueError(f"import of {len(blocks)} page blocks "
                             f"into {len(host_pages)} host slots")
        want = tuple(self.k.shape[1:])
        for blk in blocks:
            k, v = blk["k"], blk["v"]
            if (tuple(k.shape) != want or tuple(v.shape) != want
                    or k.dtype != self.k.dtype or v.dtype != self.k.dtype):
                raise ValueError(
                    f"incompatible page block: got {tuple(k.shape)}/"
                    f"{k.dtype}, arena holds {want}/{self.k.dtype}")
            if bool(self.quantized) != ("k_scales" in blk):
                raise ValueError(
                    "quantization mismatch: page block and arena "
                    "disagree about scale cells")
        names = ("k", "v", "k_scales", "v_scales")
        for p, blk in zip(host_pages, blocks):
            for n, t in zip(names, self._host()):
                t[p].copy_(blk[n])

    def store(self, state: PagedCacheState, device_pages,
              host_pages) -> None:
        """Offload: device pages -> host slots, blocking."""
        src = np.asarray(device_pages, np.int64).reshape(-1)
        dst = np.asarray(host_pages, np.int64).reshape(-1)
        if len(src) != len(dst):
            raise ValueError(f"store of {len(src)} pages into "
                             f"{len(dst)} host slots")
        if len(src) == 0:
            return
        dev = state.k_pages.device
        idx = torch.as_tensor(src, device=dev)
        for pool, host in zip(_pools(state), self._host()):
            # (n, L, Hk, page, X) contiguous on the device
            tmp = pool[:, :, idx].movedim(2, 0).contiguous()
            for j, slot in enumerate(dst):
                host[int(slot)].copy_(tmp[j], non_blocking=True)
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()

    def load(self, state: PagedCacheState, host_pages, device_pages,
             depth: int = 8) -> PagedCacheState:
        """Prefetch: host slots -> device pages, ``depth`` pages a chunk,
        enqueued on the current stream; returns the state (updated in
        place)."""
        src = np.asarray(host_pages, np.int64).reshape(-1)
        dst = np.asarray(device_pages, np.int64).reshape(-1)
        if len(src) != len(dst):
            raise ValueError(f"load of {len(src)} host slots into "
                             f"{len(dst)} pages")
        depth = max(1, int(depth))
        dev = state.k_pages.device
        for lo in range(0, len(src), depth):
            s, d = src[lo:lo + depth], dst[lo:lo + depth]
            idx = torch.as_tensor(d, device=dev)
            for pool, host in zip(_pools(state), self._host()):
                tmp = torch.empty((len(s),) + tuple(host.shape[1:]),
                                  dtype=host.dtype, device=dev)
                for j, slot in enumerate(s):
                    tmp[j].copy_(host[int(slot)], non_blocking=True)
                pool[:, :, idx] = tmp.movedim(0, 2)
        return state


class PageAllocator:
    """Host-side refcounted free list over a pool's physical pages.

    ``alloc`` hands out free pages at refcount 1, ``retain``/``release``
    move the count for every further reference (a sharing slot, a radix
    tree node), and a page returns to the free list exactly when its count
    hits zero. A refcount never goes negative (``release`` raises), a page
    is free iff its count is 0, and ``alloc`` is all-or-nothing."""

    def __init__(self, n_pages: int):
        if n_pages < 1:
            raise ValueError(f"n_pages must be >= 1, got {n_pages}")
        self.n_pages = int(n_pages)
        self.refcount = np.zeros((self.n_pages,), np.int32)
        self._free: deque = deque(range(self.n_pages))

    def available(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """n free pages at refcount 1, or None (all-or-nothing)."""
        if n < 0:
            raise ValueError(f"alloc(n) needs n >= 0, got {n}")
        if len(self._free) < n:
            return None
        pages = [self._free.popleft() for _ in range(n)]
        for p in pages:
            self.refcount[p] = 1
        return pages

    def retain(self, pages) -> None:
        """+1 ref per page; every page must already be live."""
        for p in pages:
            if self.refcount[p] <= 0:
                raise ValueError(
                    f"retain of page {p} with refcount "
                    f"{int(self.refcount[p])}: only live pages are "
                    f"shareable")
            self.refcount[p] += 1

    def release(self, pages) -> List[int]:
        """-1 ref per page; returns the pages that hit 0 (now free)."""
        freed: List[int] = []
        for p in pages:
            if self.refcount[p] <= 0:
                raise ValueError(
                    f"release of page {p} with refcount "
                    f"{int(self.refcount[p])}: double free")
            self.refcount[p] -= 1
            if self.refcount[p] == 0:
                self._free.append(p)
                freed.append(p)
        return freed

    def check(self) -> None:
        """Assert the free-list/refcount bijection."""
        free = set(self._free)
        if len(free) != len(self._free):
            raise AssertionError("free list holds a duplicate page")
        for p in range(self.n_pages):
            rc = int(self.refcount[p])
            if rc < 0:
                raise AssertionError(f"page {p} refcount {rc} < 0")
            if (rc == 0) != (p in free):
                raise AssertionError(
                    f"page {p}: refcount {rc} but "
                    f"{'in' if p in free else 'not in'} free list")
