"""Batched multi-LoRA serving (``paddle_tpu/models/lora.py``): the adapter
format, the pool, and the grouped delta. The port's own copy, with the
fault sites ``adapter.load`` / ``adapter.evict`` (the batcher fails the
acquiring request alone).

  * the ADAPTER FORMAT — per-projection low-rank (A, B) pairs for q/k/v/o
    and gate/up/down, keyed by the full parameter name
    (``model.layers.{i}.self_attn.q_proj.weight`` ...), any rank up to
    ``lora_max_rank``, any subset of projections (a missing one is a zero
    delta). ``make_lora_adapter`` builds a random one (numpy, the JAX
    package's draws), ``merge_lora`` folds one into dense weights.

  * ``AdapterPool`` — every registered adapter stays on the host (padded
    to ``max_rank``, in the model's compute dtype, pinned when the model
    serves on the card); ``hbm_slots`` device slots hold the stacked
    per-slot (A, B) buffers a wave reads, refcounted by the requests using
    them. A miss copies the host rows into a free slot, or into the
    least-recently-used unreferenced one, on the current stream (the wave
    that reads them is enqueued after); with every slot pinned ``acquire``
    returns None and admission defers. Slot ``hbm_slots`` is all zeros
    forever: base-model rows ride it and get a delta of exactly 0. With
    the unified arena the slots are the arena's ``adapter`` pages.

  * ``lora_delta_pure`` — one projection's delta: the rows gathered into
    adapter order, ``(x_sorted @ A_g) @ B_g`` as TWO grouped matmuls (K13,
    ``ops/kernels/grouped_matmul.gmm``, on CUDA tensors; no per-adapter
    padding and two launches whatever the number of adapters), scattered
    back. A row's delta depends only on its x and its own adapter.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional

import numpy as np
import torch

from ..framework import flags
from ..reliability import faults

#: the adapted projections, layer-local names (every matmul of the decoder
#: block; the LM head and the embedding are not adapted)
LORA_PROJS = (
    "self_attn.q_proj.weight", "self_attn.k_proj.weight",
    "self_attn.v_proj.weight", "self_attn.o_proj.weight",
    "mlp.gate_proj.weight", "mlp.up_proj.weight", "mlp.down_proj.weight",
)


def lora_param_names(num_layers: int) -> List[str]:
    """Full parameter names of every adaptable projection."""
    return [f"model.layers.{i}.{p}" for i in range(num_layers)
            for p in LORA_PROJS]


def lora_delta_pure(x, a_stack, b_stack, sort_idx, inv_idx, group_offsets,
                    *, plain=False):
    """The batched LoRA delta of one projection: ``(x_s @ A_g) @ B_g`` over
    adapter-sorted rows, unsorted back to x's row order.

    x (..., K) (its leading dims flattened into the T rows); a_stack
    (G, K, R) / b_stack (G, R, N) stacked per slot (group G-1 the all-zeros
    base adapter); sort_idx / inv_idx (T,) the stable sort of the rows by
    group and its inverse; group_offsets (G+1,) int32, ``offsets[G] ==
    T``. Both products are K13 on CUDA tensors (it launches or raises),
    its plain version on CPU tensors or with ``plain``."""
    from ..ops.kernels.grouped_matmul import gmm, grouped_matmul_reference

    mm = grouped_matmul_reference if plain else gmm
    lead = x.shape[:-1]
    xs = x.reshape(-1, x.shape[-1])[sort_idx.long()]
    d = mm(mm(xs, group_offsets, a_stack), group_offsets, b_stack)
    return d[inv_idx.long()].reshape(*lead, d.shape[-1])


def make_lora_adapter(config, rank: int, seed: int = 0, scale: float = 0.25,
                      projs=LORA_PROJS) -> Dict[str, tuple]:
    """A random adapter over every layer's ``projs`` at ``rank``:
    ``{full_param_name: (A (K, r), B (r, N))}`` of f32 numpy arrays, the
    JAX package's draws for the same seed. ``scale`` sizes the delta so
    that adapted outputs diverge from the base model's."""
    dims = _proj_dims(config)
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(config.num_hidden_layers):
        for p in projs:
            k, n = dims[p]
            a = rng.normal(size=(k, rank)).astype(np.float32)
            a *= scale / np.sqrt(k)
            b = rng.normal(size=(rank, n)).astype(np.float32)
            b *= scale / np.sqrt(rank)
            out[f"model.layers.{i}.{p}"] = (a, b)
    return out


def merge_lora(params: Dict[str, object], adapter: Dict[str, tuple],
               ) -> Dict[str, object]:
    """Dense params with the adapter folded in: ``W + A @ B`` per adapted
    projection, the product in f32 on W's device, cast to W's dtype
    (dense weights only: the serving path keeps the delta separate)."""
    out = dict(params)
    for name, (a, b) in adapter.items():
        w = out[name]
        delta = (torch.as_tensor(a, dtype=torch.float32, device=w.device)
                 @ torch.as_tensor(b, dtype=torch.float32, device=w.device))
        out[name] = (w + delta.to(w.dtype)).to(w.dtype)
    return out


def _proj_dims(config) -> Dict[str, tuple]:
    """(in, out) dims of each adaptable projection (the x @ w layout)."""
    h = config.hidden_size
    q = config.num_attention_heads * config.head_dim
    kv = config.num_key_value_heads * config.head_dim
    inter = config.intermediate_size
    return {
        "self_attn.q_proj.weight": (h, q),
        "self_attn.k_proj.weight": (h, kv),
        "self_attn.v_proj.weight": (h, kv),
        "self_attn.o_proj.weight": (q, h),
        "mlp.gate_proj.weight": (h, inter),
        "mlp.up_proj.weight": (h, inter),
        "mlp.down_proj.weight": (inter, h),
    }


def adapter_slot_nbytes(config, max_rank: int, dtype) -> int:
    """Bytes one pool slot occupies across every layer's stacked (A, B)
    buffers: the unified arena's ``adapter`` unit."""
    from ..framework.dtype import to_torch_dtype

    item = torch.empty((), dtype=to_torch_dtype(dtype)).element_size()
    per_layer = sum(k * max_rank + max_rank * n
                    for k, n in _proj_dims(config).values())
    return config.num_hidden_layers * per_layer * item


class AdapterPool:
    """Host-resident adapter store with refcounted, LRU-evicted device
    residency.

    The device side is ``hbm_slots`` slots plus one all-zeros slot (index
    ``hbm_slots``) that base-model rows route through: per adapted
    projection one stacked pair ``A (S+1, K, R)`` / ``B (S+1, R, N)`` in
    the model's compute dtype on its device, the operands
    ``lora_delta_pure`` takes. A load writes one slot of every stack in
    place.

    Lifecycle: ``register`` validates and pads an adapter to ``max_rank``
    and keeps it on the host for good; ``acquire`` pins it on the device
    for one request (a hit bumps the refcount; a miss loads it into a free
    slot or over the least-recently-used unreferenced one; with every slot
    pinned it returns None and the caller defers); ``release`` unpins."""

    def __init__(self, model, max_rank: Optional[int] = None,
                 hbm_slots: Optional[int] = None, arena=None):
        cfg = model.config
        self.config = cfg
        self.max_rank = int(flags.get_flag("lora_max_rank")
                            if max_rank is None else max_rank)
        self.hbm_slots = int(flags.get_flag("lora_hbm_adapters")
                             if hbm_slots is None else hbm_slots)
        if self.max_rank < 1:
            raise ValueError(f"lora_max_rank must be >= 1, "
                             f"got {self.max_rank}")
        if self.hbm_slots < 1:
            raise ValueError(f"lora_hbm_adapters must be >= 1, "
                             f"got {self.hbm_slots}")
        # arena backing: slots are the arena's `adapter` pages (slot index
        # == class-local page id), the stacks sized to the class ceiling;
        # residency holds one arena ref, each live request one more
        self._view = None
        if arena is not None:
            self._view = arena.view("adapter")
            self.hbm_slots = self._view.n_pages
            arena.set_reclaimer("adapter", self._arena_reclaim)
        self._dims = _proj_dims(cfg)
        self._names = lora_param_names(cfg.num_hidden_layers)
        embed = model.param_dict()["model.embed_tokens.weight"]
        self.dtype, self.device = embed.dtype, embed.device
        s1 = self.hbm_slots + 1
        self._stacks: Dict[str, tuple] = {}
        for name in self._names:
            k, n = self._dims[name.split(".", 3)[-1]]
            self._stacks[name] = (
                torch.zeros((s1, k, self.max_rank), dtype=self.dtype,
                            device=self.device),
                torch.zeros((s1, self.max_rank, n), dtype=self.dtype,
                            device=self.device))
        self._host: Dict[object, Dict[str, tuple]] = {}
        self._slot_of: Dict[object, int] = {}
        self._slots: List[Optional[object]] = [None] * self.hbm_slots
        self._refcount = [0] * self.hbm_slots
        self._last_used = [0] * self.hbm_slots
        self._clock = itertools.count(1)
        self.stats = {
            "adapter_hits": 0,         # acquire found the adapter resident
            "adapter_swap_stalls": 0,  # acquire had to load it
            "adapter_loads": 0,        # loads (== swap stalls)
            "adapter_evictions": 0,    # residents displaced for a load
        }

    # ---------------------------------------------------------- host side

    def register(self, adapter_id, weights: Dict[str, tuple]) -> None:
        """Validate and keep an adapter on the host: ``weights``
        ``{full_param_name: (A (K, r), B (r, N))}`` (numpy or tensors),
        any subset of the adaptable projections, any rank ``r <=
        max_rank``. The host copy is padded to ``max_rank`` (the padded
        rows and columns are zeros: the delta is unchanged) and cast to
        the compute dtype."""
        if adapter_id in self._host:
            raise ValueError(f"adapter {adapter_id!r} already registered")
        padded: Dict[str, tuple] = {}
        for name, (a, b) in weights.items():
            if name not in self._stacks:
                raise ValueError(
                    f"adapter {adapter_id!r}: {name!r} is not an "
                    f"adaptable projection (see lora.LORA_PROJS)")
            a = torch.as_tensor(np.asarray(a, np.float32))
            b = torch.as_tensor(np.asarray(b, np.float32))
            sa, sb = self._stacks[name]
            k, n = sa.shape[1], sb.shape[2]
            r = a.shape[1]
            if a.shape[0] != k or b.shape[1] != n or b.shape[0] != r:
                raise ValueError(
                    f"adapter {adapter_id!r}: {name!r} wants A ({k}, r) "
                    f"/ B (r, {n}), got {tuple(a.shape)} / "
                    f"{tuple(b.shape)}")
            if r > self.max_rank:
                raise ValueError(
                    f"adapter {adapter_id!r}: rank {r} exceeds "
                    f"lora_max_rank {self.max_rank}")
            a = torch.nn.functional.pad(a, (0, self.max_rank - r))
            b = torch.nn.functional.pad(b, (0, 0, 0, self.max_rank - r))
            padded[name] = tuple(self._host_copy(t) for t in (a, b))
        self._host[adapter_id] = padded

    def _host_copy(self, t):
        t = t.to(self.dtype).contiguous()
        return t.pin_memory() if self.device.type == "cuda" else t

    def __contains__(self, adapter_id) -> bool:
        return adapter_id in self._host

    @property
    def registered(self) -> List[object]:
        return list(self._host)

    @property
    def resident(self) -> List[object]:
        """Adapter ids resident on the device, sorted by str."""
        return sorted((a for a in self._slots if a is not None), key=str)

    def slot_of(self, adapter_id) -> Optional[int]:
        return self._slot_of.get(adapter_id)

    def refcounts(self) -> Dict[object, int]:
        """Live-request references of each resident adapter."""
        return {a: self._refcount[s] for a, s in self._slot_of.items()}

    # -------------------------------------------------- device residency

    def acquire(self, adapter_id) -> Optional[int]:
        """Pin ``adapter_id`` on the device for one request: its slot, or
        None when every slot is pinned by live requests (the caller
        defers). Raises KeyError for an unregistered adapter and
        propagates ``adapter.load`` / ``adapter.evict`` faults."""
        if adapter_id not in self._host:
            raise KeyError(f"adapter {adapter_id!r} is not registered")
        slot = self._slot_of.get(adapter_id)
        if slot is not None:
            self.stats["adapter_hits"] += 1
            self._refcount[slot] += 1
            self._last_used[slot] = next(self._clock)
            if self._view is not None:
                self._view.retain([slot])
            return slot
        if self._view is not None:
            return self._acquire_arena(adapter_id)
        slot = self._pick_slot()
        if slot is None:
            return None
        victim = self._slots[slot]
        if victim is not None:
            # the host copy is the system of record: eviction only drops
            # the device residency
            faults.maybe_fail("adapter.evict", adapter=str(victim),
                              slot=slot)
            del self._slot_of[victim]
            self._slots[slot] = None
            self.stats["adapter_evictions"] += 1
        faults.maybe_fail("adapter.load", adapter=str(adapter_id),
                          slot=slot)
        self._load(adapter_id, slot)
        self._slots[slot] = adapter_id
        self._slot_of[adapter_id] = slot
        self._refcount[slot] = 1
        self._last_used[slot] = next(self._clock)
        self.stats["adapter_swap_stalls"] += 1
        self.stats["adapter_loads"] += 1
        return slot

    def _acquire_arena(self, adapter_id) -> Optional[int]:
        """The arena-backed miss: grow residency by an arena page (the
        budget may steal from another class), else swap out the LRU
        unreferenced resident (budget-neutral), else None."""
        pages = self._view.alloc(1)
        if pages is None:
            evictable = [s for s in range(self.hbm_slots)
                         if self._slots[s] is not None
                         and self._refcount[s] == 0]
            if not evictable:
                return None
            vslot = min(evictable, key=lambda s: self._last_used[s])
            faults.maybe_fail("adapter.evict",
                              adapter=str(self._slots[vslot]), slot=vslot)
            del self._slot_of[self._slots[vslot]]
            self._slots[vslot] = None
            self.stats["adapter_evictions"] += 1
            self._view.release([vslot])
            pages = self._view.alloc(1)
            assert pages is not None
        slot = pages[0]
        try:
            faults.maybe_fail("adapter.load", adapter=str(adapter_id),
                              slot=slot)
            self._load(adapter_id, slot)
        except Exception:
            self._view.release(pages)  # no residency leak on a fault
            raise
        self._slots[slot] = adapter_id
        self._slot_of[adapter_id] = slot
        self._refcount[slot] = 1
        self._last_used[slot] = next(self._clock)
        self._view.retain([slot])  # the request pin atop the residency ref
        self.stats["adapter_swap_stalls"] += 1
        self.stats["adapter_loads"] += 1
        return slot

    def _arena_reclaim(self, n_units: int) -> int:
        """The arena's ``adapter`` reclaimer: drop the device residency of
        up to ``n_units`` least-recently-used unreferenced adapters."""
        freed = 0
        while freed < n_units:
            evictable = [s for s in range(self.hbm_slots)
                         if self._slots[s] is not None
                         and self._refcount[s] == 0]
            if not evictable:
                break
            vslot = min(evictable, key=lambda s: self._last_used[s])
            del self._slot_of[self._slots[vslot]]
            self._slots[vslot] = None
            self.stats["adapter_evictions"] += 1
            self._view.release([vslot])
            freed += 1
        return freed

    def release(self, adapter_id) -> None:
        slot = self._slot_of.get(adapter_id)
        if slot is None or self._refcount[slot] <= 0:
            raise ValueError(
                f"release of adapter {adapter_id!r} that holds no "
                f"reference (double release?)")
        self._refcount[slot] -= 1
        if self._view is not None:
            self._view.release([slot])

    def _pick_slot(self) -> Optional[int]:
        for s in range(self.hbm_slots):
            if self._slots[s] is None:
                return s
        evictable = [s for s in range(self.hbm_slots)
                     if self._refcount[s] == 0]
        if not evictable:
            return None
        return min(evictable, key=lambda s: self._last_used[s])

    def _load(self, adapter_id, slot: int) -> None:
        """Write the adapter into ``slot`` of every stack, in place, on the
        current stream (from the pinned host copies, which live as long as
        the registration); projections it does not adapt are zeroed, so a
        previous occupant's rows cannot leak into its delta."""
        weights = self._host[adapter_id]
        for name, (sa, sb) in self._stacks.items():
            ab = weights.get(name)
            if ab is None:
                sa[slot].zero_()
                sb[slot].zero_()
            else:
                sa[slot].copy_(ab[0], non_blocking=True)
                sb[slot].copy_(ab[1], non_blocking=True)

    # -------------------------------------------------------- wave inputs

    @property
    def stacks(self) -> Dict[str, tuple]:
        """The stacked per-slot (A, B) device buffers by full parameter
        name (group ``hbm_slots`` the all-zeros base adapter)."""
        return dict(self._stacks)

    def route_rows(self, row_group: np.ndarray) -> tuple:
        """One wave's routing from ``row_group`` (T,) int32 of per-row
        slots (``hbm_slots`` = base): ``(sort_idx, inv_idx,
        group_offsets)`` on the device, the stable argsort by group, its
        inverse and the per-group row offsets (``hbm_slots + 2``
        entries, the last T), uploaded together from one pinned staging
        buffer."""
        row_group = np.asarray(row_group, np.int32)
        t = len(row_group)
        sort_idx = np.argsort(row_group, kind="stable").astype(np.int32)
        inv_idx = np.empty_like(sort_idx)
        inv_idx[sort_idx] = np.arange(t, dtype=np.int32)
        counts = np.bincount(row_group, minlength=self.hbm_slots + 1)
        offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
        # each piece at a 16-byte boundary (K13 takes the offsets' address
        # as TMA-aligned)
        pieces = (sort_idx, inv_idx, offsets)
        starts = np.cumsum([0] + [-(-len(v) // 4) * 4 for v in pieces])
        packed = np.zeros((int(starts[-1]),), np.int32)
        for v, at in zip(pieces, starts):
            packed[at:at + len(v)] = v
        dev = torch.from_numpy(packed)
        if self.device.type == "cuda":
            dev = dev.pin_memory().to(self.device, non_blocking=True)
        return tuple(dev[at:at + len(v)] for v, at in zip(pieces, starts))

    # ------------------------------------------------------ observability

    def snapshot(self) -> dict:
        """Residency, traffic and per-adapter refcounts (string keys)."""
        return {
            "hbm_slots": self.hbm_slots,
            "arena_backed": self._view is not None,
            "adapters_registered": len(self._host),
            "adapters_resident": len(self._slot_of),
            "resident_ids": [str(a) for a in self.resident],
            "adapter_hits": int(self.stats["adapter_hits"]),
            "adapter_swap_stalls": int(self.stats["adapter_swap_stalls"]),
            "adapter_evictions": int(self.stats["adapter_evictions"]),
            "refcounts": {str(a): int(c)
                          for a, c in self.refcounts().items()},
        }
