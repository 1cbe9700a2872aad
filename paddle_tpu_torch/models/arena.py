"""UnifiedArena — one typed, refcounted HBM page economy; the port's own
copy of ``paddle_tpu/models/arena.py`` (host Python over numpy).

Pages carry a class tag (``kv`` / ``adapter`` / ``weight``); each class
keeps its own physical backing (the paged K/V pools) sized to a fixed
physical ceiling, while residency is gated by ONE global byte budget:
``alloc(cls, n)`` admits pages only when budget headroom exists, and a
deficit runs the cross-class STEAL loop — victim classes ranked
least-recently-active first (or, with ``flags.arena_cost_model``, by
restore cost per unit of staleness), each demoting its coldest
unreferenced residents through a registered reclaimer, never below the
class floor (``arena_class_floors``). Residency decides where bytes live,
never what a wave computes. One refcount array spans every class and one
``check()`` asserts the free-list/refcount bijection across all of them.

The batcher registers ``kv`` and the reserved ``weight`` class, and with
multi-LoRA serving the ``adapter`` class: the ``AdapterPool``'s device
slots (``models/lora.py``), one unit an adapter's stacked (A, B) buffers
over every layer, its ceiling the legacy slot count + 8, reclaimed by
dropping unreferenced adapters' residency. Fault sites
``arena.steal`` (the cross-class transfer decision) and ``arena.demote``
(the victim's demotion) fire before any victim is touched, failing
exactly the acquiring request.
"""

from __future__ import annotations

import itertools
from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np

from ..reliability import faults

#: the page-class vocabulary: ``kv`` = paged-KV cache pages, ``adapter``
#: = stacked LoRA (A, B) slot shards, ``weight`` = draft-model weight
#: shards (reserved — registered and property-tested so the vocabulary
#: is load-bearing, but without a live producer until the DraftProposer
#: grows model-based drafting).
ARENA_CLASSES = ("kv", "adapter", "weight")


def parse_class_floors(spec: str) -> Dict[str, int]:
    """Parse ``flags.arena_class_floors`` (``"kv=1,adapter=1,weight=0"``)
    into ``{class: min_resident_units}``: the steal loop never demotes a
    victim class below its floor, so no class can be starved to zero by
    another class's burst."""
    floors: Dict[str, int] = {}
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"arena_class_floors entry {part!r} wants class=units")
        name, val = part.split("=", 1)
        name = name.strip()
        if name not in ARENA_CLASSES:
            raise ValueError(f"unknown arena class {name!r} "
                             f"(classes: {ARENA_CLASSES})")
        units = int(val)
        if units < 0:
            raise ValueError(
                f"arena_class_floors: {name}={units} must be >= 0")
        floors[name] = units
    return floors


class UnifiedArena:
    """Typed, refcounted HBM page arena with one global byte budget.

    ``classes`` maps class name -> ``(unit_bytes, n_pages)`` in
    declaration order: the typed id space is the concatenation of the
    classes' page ranges and ``refcount`` is ONE array across all of
    them (page ids handed to callers stay class-local). ``n_pages`` is
    the class's PHYSICAL ceiling — how many units its backing buffers
    were sized for — while the byte budget decides how many are usable
    at any moment; a class may hold fewer units than its ceiling
    because another class's residency is paying for the difference."""

    def __init__(self, budget_bytes: int, classes: Dict[str, tuple],
                 floors: Optional[Dict[str, int]] = None,
                 cost_model: Optional[bool] = None):
        from ..framework import flags

        # demotion cost model (flags.arena_cost_model, default off):
        # rank steal victims by restore cost per unit of staleness
        # instead of recency alone — see _steal. Ctor arg overrides the
        # flag (tests flip it without touching global flag state).
        self._cost_model = (bool(flags.get_flag("arena_cost_model"))
                            if cost_model is None else bool(cost_model))
        if budget_bytes < 1:
            raise ValueError(
                f"budget_bytes must be >= 1, got {budget_bytes}")
        self.budget_bytes = int(budget_bytes)
        self._unit: Dict[str, int] = {}
        self._base: Dict[str, int] = {}
        self._n: Dict[str, int] = {}
        self._free: Dict[str, deque] = {}
        self._used: Dict[str, int] = {}
        base = 0
        for name, (unit, n) in classes.items():
            if name not in ARENA_CLASSES:
                raise ValueError(f"unknown arena class {name!r} "
                                 f"(classes: {ARENA_CLASSES})")
            if int(unit) < 1:
                raise ValueError(
                    f"class {name!r}: unit_bytes must be >= 1, got {unit}")
            if int(n) < 0:
                raise ValueError(
                    f"class {name!r}: n_pages must be >= 0, got {n}")
            self._unit[name] = int(unit)
            self._base[name] = base
            self._n[name] = int(n)
            self._free[name] = deque(range(int(n)))
            self._used[name] = 0
            base += int(n)
        self.refcount = np.zeros((base,), np.int32)
        # floors clamp to the physical ceiling: a floor above it could
        # never be reached, and slack math would go permanently negative
        self._floors: Dict[str, int] = {}
        for name, f in (floors or {}).items():
            if name in self._n:
                self._floors[name] = min(int(f), self._n[name])
        self._reclaim: Dict[str, Callable[[int], int]] = {}
        self._activity = {name: 0 for name in self._unit}
        self._clock = itertools.count(1)
        self.stats = {
            # units reclaimed cross-class, keyed "victim->winner"
            "steals": {},
            # total units any steal demoted out of HBM
            "demotions": 0,
            # allocs denied on budget even after the steal loop
            "budget_deferrals": 0,
        }

    # ------------------------------------------------------------ queries

    def classes(self) -> List[str]:
        return list(self._unit)

    def floor(self, cls: str) -> int:
        return self._floors.get(cls, 0)

    def unit_bytes(self, cls: str) -> int:
        return self._unit[cls]

    def n_pages(self, cls: str) -> int:
        return self._n[cls]

    def resident(self, cls: str) -> int:
        """Units of ``cls`` currently allocated (HBM-resident)."""
        return self._used[cls]

    def used_bytes(self) -> int:
        return sum(self._used[c] * self._unit[c] for c in self._unit)

    def headroom_bytes(self) -> int:
        return self.budget_bytes - self.used_bytes()

    def available(self, cls: str) -> int:
        """Units of ``cls`` allocatable WITHOUT stealing: free physical
        pages, capped by budget headroom."""
        return min(len(self._free[cls]),
                   max(0, self.headroom_bytes() // self._unit[cls]))

    def view(self, cls: str) -> "ArenaView":
        return ArenaView(self, cls)

    def set_reclaimer(self, cls: str,
                      fn: Optional[Callable[[int], int]]) -> None:
        """Register ``fn(n_units) -> units_freed`` as ``cls``'s demotion
        hook: the steal loop calls it to move up to ``n_units`` of the
        class's coldest UNREFERENCED residents out of HBM (the hook must
        release the pages through this arena so the freed budget is
        observable). None unregisters — the class then cannot be a
        steal victim."""
        if cls not in self._unit:
            raise ValueError(f"unknown arena class {cls!r}")
        if fn is None:
            self._reclaim.pop(cls, None)
        else:
            self._reclaim[cls] = fn

    # --------------------------------------------------------- lifecycle

    def alloc(self, cls: str, n: int) -> Optional[List[int]]:
        """``n`` free pages of ``cls`` at refcount 1, or None
        (all-or-nothing — the PageAllocator contract). Denies on the
        class's physical ceiling outright; a BUDGET deficit first runs
        the cross-class steal loop and only then denies."""
        if n < 0:
            raise ValueError(f"alloc(n) needs n >= 0, got {n}")
        if n == 0:
            return []
        if len(self._free[cls]) < n:
            return None
        want = n * self._unit[cls]
        if want > self.headroom_bytes():
            self._steal(cls, want)
            if want > self.headroom_bytes():
                self.stats["budget_deferrals"] += 1
                return None
        base = self._base[cls]
        pages = [self._free[cls].popleft() for _ in range(n)]
        for p in pages:
            self.refcount[base + p] = 1
        self._used[cls] += n
        self._activity[cls] = next(self._clock)
        return pages

    def retain(self, cls: str, pages) -> None:
        """+1 ref per page; every page must already be live."""
        base = self._base[cls]
        for p in pages:
            if self.refcount[base + p] <= 0:
                raise ValueError(
                    f"retain of {cls} page {p} with refcount "
                    f"{int(self.refcount[base + p])}: only live pages "
                    f"are shareable")
            self.refcount[base + p] += 1
        self._activity[cls] = next(self._clock)

    def release(self, cls: str, pages) -> List[int]:
        """-1 ref per page; returns the pages that hit 0 (now free —
        their units return to the global budget)."""
        base = self._base[cls]
        freed: List[int] = []
        for p in pages:
            if self.refcount[base + p] <= 0:
                raise ValueError(
                    f"release of {cls} page {p} with refcount "
                    f"{int(self.refcount[base + p])}: double free")
            self.refcount[base + p] -= 1
            if self.refcount[base + p] == 0:
                self._free[cls].append(p)
                freed.append(p)
        self._used[cls] -= len(freed)
        return freed

    def reset_class(self, cls: str) -> None:
        """Forget every page of ``cls``: refcounts cleared, free list
        rebuilt, residency 0. The per-run KV teardown — the engine's
        page pool dies with each run() while the arena (and the adapter
        class's residency) persists across runs."""
        base, n = self._base[cls], self._n[cls]
        self.refcount[base:base + n] = 0
        self._free[cls] = deque(range(n))
        self._used[cls] = 0

    # ------------------------------------------------------ steal policy

    def _steal(self, winner: str, want_bytes: int) -> None:
        """Free budget until ``want_bytes`` of headroom exists (or no
        victim can yield more): victim classes ranked coldest
        (least-recently-active) first, each demoting unreferenced
        residents through its reclaimer, never below its floor. The
        winner class never self-steals here — same-class pressure stays
        at the call sites (prefix eviction, adapter LRU), where it was
        before the arena."""
        cands = [c for c in self._unit
                 if c != winner and c in self._reclaim]
        if self._cost_model:
            # scored policy (flags.arena_cost_model): bytes-to-restore
            # per unit of staleness. A demoted unit is not free — it
            # costs its unit_bytes again when a later hit promotes it
            # back — so between two candidates of similar coldness the
            # one whose units are cheaper to restore should yield first.
            # staleness is measured in activity-clock ticks against the
            # newest stamp (monotonic, no wall clock); the old recency
            # key is the deterministic tiebreak.
            newest = max(self._activity.values(), default=0)
            victims = sorted(cands, key=lambda c: (
                self._unit[c] / float(newest - self._activity[c] + 1),
                self._activity[c]))
        else:
            victims = sorted(cands, key=lambda c: self._activity[c])
        for victim in victims:
            deficit = want_bytes - self.headroom_bytes()
            if deficit <= 0:
                return
            slack = self._used[victim] - self.floor(victim)
            if slack <= 0:
                continue
            units = min(slack, -(-deficit // self._unit[victim]))
            # a fault aborts the allocation before any victim is touched
            faults.maybe_fail("arena.steal", winner=winner, victim=victim,
                              units=units)
            faults.maybe_fail("arena.demote", cls=victim, units=units)
            got = int(self._reclaim[victim](units))
            if got > 0:
                key = f"{victim}->{winner}"
                self.stats["steals"][key] = \
                    self.stats["steals"].get(key, 0) + got
                self.stats["demotions"] += got

    # ---------------------------------------------------------- invariant

    def check(self) -> None:
        """Assert the cross-class free-list/refcount bijection plus the
        budget accounting (the property tests call this after every
        operation): per class, a page is free iff its refcount is 0 and
        the live count equals the residency counter; globally, resident
        bytes never exceed the budget."""
        for cls in self._unit:
            base, n = self._base[cls], self._n[cls]
            free = set(self._free[cls])
            if len(free) != len(self._free[cls]):
                raise AssertionError(
                    f"class {cls}: free list holds a duplicate page")
            live = 0
            for p in range(n):
                rc = int(self.refcount[base + p])
                if rc < 0:
                    raise AssertionError(
                        f"class {cls}: page {p} refcount {rc} < 0")
                if (rc == 0) != (p in free):
                    raise AssertionError(
                        f"class {cls}: page {p} refcount {rc} but "
                        f"{'in' if p in free else 'not in'} free list")
                live += rc > 0
            if live != self._used[cls]:
                raise AssertionError(
                    f"class {cls}: {live} live pages but residency "
                    f"counter says {self._used[cls]}")
        if self.used_bytes() > self.budget_bytes:
            raise AssertionError(
                f"arena over budget: {self.used_bytes()} resident bytes "
                f"> {self.budget_bytes} budget")

    # ------------------------------------------------------ observability

    def snapshot(self) -> dict:
        """One record for ``health_snapshot()["arena"]`` — per-class
        residency against ceiling and floor, the cross-class steal
        matrix, and the budget gauge (string keys: JSON-bound)."""
        return {
            "budget_bytes": int(self.budget_bytes),
            "used_bytes": int(self.used_bytes()),
            "classes": {
                cls: {
                    "unit_bytes": int(self._unit[cls]),
                    "hbm_pages": int(self._n[cls]),
                    "hbm_resident": int(self._used[cls]),
                    "hbm_free": len(self._free[cls]),
                    "floor": int(self.floor(cls)),
                } for cls in self._unit},
            "steals": {k: int(v)
                       for k, v in self.stats["steals"].items()},
            "demotions": int(self.stats["demotions"]),
            "budget_deferrals": int(self.stats["budget_deferrals"]),
        }


class ArenaView:
    """PageAllocator-compatible window onto ONE class of a UnifiedArena.

    Same contract as :class:`~.kv_cache.PageAllocator` (the property
    suite runs against both): page ids are class-local, ``refcount`` is
    a live numpy view of the arena's global array, and ``check()``
    asserts the WHOLE arena's bijection. The one behavioral addition:
    ``alloc`` routes through the arena's budget gate, so an allocation
    under cross-class pressure can demote another class's pages."""

    def __init__(self, arena: UnifiedArena, cls: str):
        if cls not in arena._unit:
            raise ValueError(f"unknown arena class {cls!r}")
        self.arena = arena
        self.cls = cls

    @property
    def n_pages(self) -> int:
        return self.arena._n[self.cls]

    @property
    def refcount(self) -> np.ndarray:
        base = self.arena._base[self.cls]
        return self.arena.refcount[base:base + self.n_pages]

    def available(self) -> int:
        return self.arena.available(self.cls)

    def alloc(self, n: int) -> Optional[List[int]]:
        return self.arena.alloc(self.cls, n)

    def retain(self, pages) -> None:
        self.arena.retain(self.cls, pages)

    def release(self, pages) -> List[int]:
        return self.arena.release(self.cls, pages)

    def check(self) -> None:
        self.arena.check()
