"""health_snapshot — one bundle of every reliability signal in the process
(the port's own copy of ``paddle_tpu/reliability/health.py``, every key of
its snapshot).

Ties together the serving engines' stats, their tier/adapter/arena
residency, the retry counters, the fault-injection registry, the fleet
routers, the disaggregation workers, the elastic view and the
autoscalers, so an operator (or a post-mortem) reads ONE structure:

    from paddle_tpu_torch.reliability import health_snapshot
    snap = health_snapshot()
    snap["engines"]             # live ContinuousBatcher stats
    snap["fleet"]               # one fleet_health() per live router
    snap["retry_counters"]      # where the system is absorbing faults

``flight_record_tail`` reads the collective watchdog's flight record; the
port has no watchdog module yet, so the tail is ``[]`` (the reference's
own fallback). The autoscaler and elastic registries are plain registries
that stay empty until their modules come.

Engines, routers and workers register themselves at construction through
weakref sets — a garbage-collected one drops out automatically.
"""

from __future__ import annotations

import threading
import time
import weakref
from collections import deque
from typing import List

from . import faults
from .retry import retry_counters

_lock = threading.Lock()
_engines: "weakref.WeakSet" = weakref.WeakSet()
_fleets: "weakref.WeakSet" = weakref.WeakSet()
_disagg: "weakref.WeakSet" = weakref.WeakSet()
_autoscalers: "weakref.WeakSet" = weakref.WeakSet()
_watchdog_timeouts: deque = deque(maxlen=64)
_elastic = {"generation": 0, "restart_count": 0, "alive_host_count": None,
            "world": None, "rank": None}
_elastic_events: deque = deque(maxlen=64)


def register_engine(engine) -> None:
    """Track a serving engine (anything with a `.stats` dict)."""
    with _lock:
        _engines.add(engine)


def register_fleet(router) -> None:
    """Track a fleet router (anything with a `fleet_health()` dict) —
    FleetRouter registers itself at construction, and a garbage-collected
    fleet drops out of the snapshot automatically (the engine idiom)."""
    with _lock:
        _fleets.add(router)


def fleet_state() -> list:
    """One fleet_health() record per live router: generation, replica
    count, per-replica lease/digest ages, failover and shed counters. A
    router whose poll thread is mid-mutation must degrade to a marker,
    never crash the monitor."""
    with _lock:
        routers = list(_fleets)
    out = []
    for r in routers:
        try:
            out.append(r.fleet_health())
        except Exception as e:
            out.append({"snapshot_error": f"{type(e).__name__}: {e}"})
    return out


def register_autoscaler(autoscaler) -> None:
    """Track a fleet autoscaler (anything with an
    `autoscaler_snapshot()` dict) — FleetAutoscaler registers itself at
    construction; a garbage-collected one drops out automatically."""
    with _lock:
        _autoscalers.add(autoscaler)


def autoscaler_state() -> list:
    """One autoscaler_snapshot() record per live FleetAutoscaler:
    current/min/max replicas, scale and fault counters, brownout ladder
    state, flap-suppressed decisions and the recent event trail. Same
    degrade-to-marker rule as every other surface: a loop racing its
    pump thread must never crash the monitor."""
    with _lock:
        scalers = list(_autoscalers)
    out = []
    for a in scalers:
        try:
            out.append(a.autoscaler_snapshot())
        except Exception as e:
            out.append({"snapshot_error": f"{type(e).__name__}: {e}"})
    return out


def register_disagg(worker) -> None:
    """Track a fleet worker's disaggregation surface (anything with a
    `disagg_snapshot()` method) — FleetWorker registers itself at
    construction; a garbage-collected worker drops out automatically."""
    with _lock:
        _disagg.add(worker)


def disagg_state() -> list:
    """One disagg_snapshot() record per worker that has one: role,
    migrations_in/out, migration_stall_ms, bytes_migrated,
    resumes_recovered. Workers outside a disagg fleet return None and are
    skipped; a
    worker racing its serve thread degrades to a marker, never crashes
    the monitor."""
    with _lock:
        workers = list(_disagg)
    out = []
    for w in workers:
        try:
            snap = w.disagg_snapshot()
        except Exception as e:
            snap = {"snapshot_error": f"{type(e).__name__}: {e}"}
        if snap is not None:
            out.append(snap)
    return out


def note_watchdog_timeout(site: str) -> None:
    """Called by CommWatchdog._on_timeout with the stuck site's name."""
    with _lock:
        _watchdog_timeouts.append({"t": time.time(), "site": site})


def watchdog_timeouts() -> List[dict]:
    with _lock:
        return list(_watchdog_timeouts)


def note_elastic_event(kind: str, *, generation=None, world=None, rank=None,
                       alive_hosts=None, detail: str = "") -> None:
    """Record an elastic-training lifecycle event (rendezvous / rescale /
    restart / resume — elastic_run.py and the launcher call this). Keeps
    the latest topology view plus a bounded event trail so
    health_snapshot()["elastic"] answers "what generation are we on, how
    many hosts are alive, how many times did we restart" after the fact."""
    with _lock:
        if generation is not None:
            _elastic["generation"] = int(generation)
        if world is not None:
            _elastic["world"] = int(world)
        if rank is not None:
            _elastic["rank"] = int(rank)
        if alive_hosts is not None:
            _elastic["alive_host_count"] = int(alive_hosts)
        if kind in ("restart", "rescale"):
            _elastic["restart_count"] += 1
        _elastic_events.append({
            "t": time.time(), "kind": kind, "detail": detail,
            "generation": _elastic["generation"]})


def elastic_state() -> dict:
    """Current elastic view: generation, restart_count, alive_host_count,
    world, rank, and the recent event trail (newest last)."""
    with _lock:
        return {**_elastic, "events": list(_elastic_events)}


def _retries_surface() -> dict:
    """health_snapshot()["retries"]: per-policy retry counters plus the
    totals an alert actually thresholds on — a rising `retries` total
    with flat `gave_up` is a system absorbing faults; rising `gave_up`
    is one losing."""
    counters = retry_counters()
    totals = {k: 0 for k in ("attempts", "retries", "failures",
                             "gave_up")}
    for rec in counters.values():
        for k in totals:
            totals[k] += int(rec.get(k, 0))
    return {"counters": counters, "totals": totals}


def health_snapshot(flight_tail: int = 32) -> dict:
    """Bundle flight-record tail + engine stats + retry/fault counters."""
    try:
        from ..distributed.watchdog import flight_record

        tail = flight_record()[-flight_tail:]
    except Exception:       # watchdog import must never break a snapshot
        tail = []
    import copy

    def copy_stats(e):
        # deepcopy: stats hold nested mutables (prefill_bucket_hist,
        # quarantined) that the serving thread mutates mid-run. The copy
        # itself can race a dict resize (engines don't lock their stats —
        # that's the serving hot path), so retry a few times and degrade
        # to a marker instead of ever crashing the monitoring thread.
        for _ in range(4):
            try:
                return copy.deepcopy(dict(getattr(e, "stats", {})))
            except RuntimeError:
                continue
        return {"snapshot_error": "engine stats mutating too fast"}

    def tier_snap(e):
        # tiered-KV residency: engines with the host tier on expose
        # kv_tier_snapshot() —
        # hbm/host pages resident, host_tier_hits, prefetch_stall_ms,
        # parked_slots. Same degrade-to-marker rule as copy_stats: the
        # monitor thread must never crash on a racing engine.
        fn = getattr(e, "kv_tier_snapshot", None)
        if fn is None:
            return None
        try:
            return fn()
        except Exception as exc:
            return {"snapshot_error": f"{type(exc).__name__}: {exc}"}

    def adapter_snap(e):
        # multi-LoRA residency: lora engines expose adapter_snapshot()
        # — adapters_resident,
        # swap stalls/hits, per-adapter refcounts. Same degrade-to-
        # marker rule: the monitor thread never crashes on a racing
        # engine.
        fn = getattr(e, "adapter_snapshot", None)
        if fn is None:
            return None
        try:
            return fn()
        except Exception as exc:
            return {"snapshot_error": f"{type(exc).__name__}: {exc}"}

    def arena_snap(e):
        # unified-arena residency: arena engines expose
        # arena_snapshot() — per-class HBM/host residency against
        # ceiling and floor, the cross-class steal matrix
        # ("victim->winner" unit counts), demotion and budget-deferral
        # totals. Same degrade-to-marker rule: the
        # monitor thread never crashes on a racing engine.
        fn = getattr(e, "arena_snapshot", None)
        if fn is None:
            return None
        try:
            return fn()
        except Exception as exc:
            return {"snapshot_error": f"{type(exc).__name__}: {exc}"}

    with _lock:
        engines = [copy_stats(e) for e in _engines]
        tiers = [s for s in (tier_snap(e) for e in _engines)
                 if s is not None]
        adapters = [s for s in (adapter_snap(e) for e in _engines)
                    if s is not None]
        arenas = [s for s in (arena_snap(e) for e in _engines)
                  if s is not None]
        timeouts = list(_watchdog_timeouts)
    return {
        "time": time.time(),
        "flight_record_tail": tail,
        "watchdog_timeouts": timeouts,
        "engines": engines,
        "kv_tiers": tiers,
        "adapters": adapters,
        "arena": arenas,
        "retry_counters": retry_counters(),
        # the same counters with a fleet-wide rollup on top: "is the
        # system absorbing faults, and how hard" in one read, without
        # walking every policy.
        # "retry_counters" above stays as-is for existing readers.
        "retries": _retries_surface(),
        "faults": faults.stats(),
        "elastic": elastic_state(),
        "fleet": fleet_state(),
        "disagg": disagg_state(),
        "autoscaler": autoscaler_state(),
    }
