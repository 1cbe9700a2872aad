"""FleetAutoscaler: elastic capacity and brownout over the lease board
(``paddle_tpu/inference/autoscaler.py``).

The control half of the load loop (``inference/loadgen.py`` is the
traffic half). It reads the telemetry the fleet already gossips on its
heartbeats (per-replica queue depth and age, inter-token and tick EWMAs)
plus the router's own queue, and answers load three ways, in order of
preference:

1. **Scale up** (below ``fleet_max_replicas``): a new
   ``ContinuousBatcher`` over the same model and the same weights, its
   ``FleetWorker`` started (and warmed when ``warm_prompt`` is given), the
   wait for its fresh lease, then ``router.add_worker``. In a
   disaggregated fleet the new replica takes the hotter role (prefill
   admission backlog against decode occupancy).
2. **Scale down** (above ``fleet_min_replicas``, demand low), lossless by
   construction: the victim stops receiving admissions
   (``router.begin_drain``), the router's evacuation sweep moves each of
   its live streams (park -> ``KVMigrator`` -> resume on a survivor,
   exactly one recomputed token each, so ``sum(survivor resumes) ==
   router.stats["evacuations"]``), and only a provably empty victim is
   ``terminate()``d and removed. A victim killed mid-evacuation falls to
   the journaled failover; the drain is abandoned, never half-applied.
3. **Brownout** (at max replicas and still saturated, under
   ``brownout_ladder``): a reversible ladder of host-side caps the serving
   loops read each wave, never a shape change: L1 ``_spec_k_cap = 0``
   (speculative decoding down to the plain decode row), L2
   ``_admit_budget_cap = prefill_chunk // 4``, L3 the router sheds the
   lowest deadline tier at admission (``brownout_shed_tiers = 1``, plus
   what that tier already has queued).

Decisions are hysteretic (``streak`` consecutive high or low reads) and
rate-limited (``autoscale_cooldown_s``); a decision the cooldown suppresses
is counted (``flap_suppressed``). The fault sites ``autoscale.decide``,
``autoscale.scale_up`` and ``autoscale.scale_down`` each abort exactly one
decision; a faulted scale-down leaves the victim serving. ``clock=`` is
the decisions' clock (the tests inject one).

``step()`` is synchronous and meant to be pumped from the loop that pumps
``router.poll()`` (``loadgen.run_trace`` does both): the autoscaler never
touches an engine from a thread of its own.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional

from ..framework import flags
from ..reliability import faults

__all__ = ["FleetAutoscaler"]

#: brownout ladder depth: L1 spec-k, L2 admission budget, L3 tier shed
_BROWNOUT_STEPS = 3


class FleetAutoscaler:
    """Control loop over a :class:`~.router.FleetRouter`'s lease board.

    ``model`` + ``engine_kw`` are what scale-up builds new replicas from:
    pass the existing fleet's settings (and its ``quantized_params``, so
    every replica reads one copy of the weights). ``model=None`` disables
    scale-up (scale-down and brownout still work)."""

    def __init__(self, router, model=None, *,
                 engine_kw: Optional[dict] = None,
                 min_replicas: Optional[int] = None,
                 max_replicas: Optional[int] = None,
                 cooldown_s: Optional[float] = None,
                 brownout: Optional[bool] = None,
                 high_util: float = 0.85, low_util: float = 0.35,
                 queue_age_high_s: float = 0.25,
                 streak: int = 3, drain_timeout_s: float = 30.0,
                 heartbeat_interval: float = 0.1,
                 lease_wait_s: float = 5.0,
                 warm_prompt=None, name_prefix: str = "auto",
                 clock=time.monotonic):
        self.router = router
        self.model = model
        self.engine_kw = dict(engine_kw or {})
        self.min_replicas = int(flags.get_flag("fleet_min_replicas")
                                if min_replicas is None else min_replicas)
        self.max_replicas = int(flags.get_flag("fleet_max_replicas")
                                if max_replicas is None else max_replicas)
        if not (1 <= self.min_replicas <= self.max_replicas):
            raise ValueError(
                f"need 1 <= min <= max, got min={self.min_replicas} "
                f"max={self.max_replicas}")
        self.cooldown_s = float(flags.get_flag("autoscale_cooldown_s")
                                if cooldown_s is None else cooldown_s)
        self.brownout_enabled = bool(flags.get_flag("brownout_ladder")
                                     if brownout is None else brownout)
        self.high_util = float(high_util)
        self.low_util = float(low_util)
        self.queue_age_high_s = float(queue_age_high_s)
        self.streak = int(streak)
        self.drain_timeout_s = float(drain_timeout_s)
        self.hb_interval = float(heartbeat_interval)
        self.lease_wait_s = float(lease_wait_s)
        self.warm_prompt = warm_prompt
        self.name_prefix = name_prefix
        self._clock = clock
        self._hi = 0                    # consecutive high-pressure reads
        self._lo = 0                    # consecutive low-pressure reads
        self._last_scale_t = float("-inf")
        self._down: Optional[dict] = None   # in-flight scale-down record
        self._bo_level = 0
        self._spawn_i = 0
        #: workers this loop spawned or retired — callers join/stop them
        #: at teardown (the autoscaler never blocks step() on a join)
        self.spawned: List[object] = []
        self.retired: List[object] = []
        self.events: deque = deque(maxlen=256)
        self.stats: Dict[str, object] = {
            "scale_ups": 0, "scale_downs": 0,
            "scale_downs_aborted": 0,       # victim died mid-drain
            "evacuations_started": 0,       # scale-down streams moved
            "flap_suppressed": 0,           # decisions the cooldown ate
            "decide_faults": 0, "scale_up_faults": 0,
            "scale_down_faults": 0,
            "brownout": {"level": 0,
                         "enters": [0] * _BROWNOUT_STEPS,
                         "exits": [0] * _BROWNOUT_STEPS,
                         "shed_tiers": 0},
        }
        from ..reliability.health import register_autoscaler

        register_autoscaler(self)

    # ------------------------------------------------------------- events
    def _note(self, kind: str, t: Optional[float] = None,
              **detail) -> None:
        # scale events carry their DECISION time: the cooldown gates
        # decisions, so the non-flapping proof must measure gaps between
        # them, not between completions (a scale-up's lease wait would
        # otherwise skew its stamp hundreds of ms late)
        self.events.append({"t": self._clock() if t is None else t,
                            "kind": kind, **detail})

    def scale_events(self) -> List[dict]:
        """The scale_up / scale_down_begin events — what the non-flapping
        proof checks: no two closer than ``cooldown_s``."""
        return [e for e in self.events
                if e["kind"] in ("scale_up", "scale_down_begin")]

    # ----------------------------------------------------------- pressure
    def _live_workers(self) -> List[object]:
        r = self.router
        return [w for name, w in r.workers.items()
                if name not in r._dead and name not in r._retired
                and w.alive()]

    def _pressure(self) -> dict:
        """One demand read: fleet-wide outstanding work (router queue +
        per-replica load) against live capacity, plus the worst gossiped
        queue age. All inputs are things the fleet already publishes —
        the loop adds no new observation channel."""
        r = self.router
        live = self._live_workers()
        cap = sum(w.capacity for w in live) or 1
        outstanding = r._queued() + sum(w.load() for w in live)
        demand = outstanding / cap
        q_age = 0.0
        for name in r.workers:
            tel = ((r._state.get(name) or {}).get("lease")
                   or {}).get("telemetry") or {}
            age = tel.get("queue_age_s")
            if age:
                q_age = max(q_age, float(age))
        # router-side queue age: requests no replica has room for yet
        now = self._clock()
        for q in r._tiers:
            if q:
                q_age = max(q_age, now - q[0].submit_t)
        high = demand >= self.high_util or q_age >= self.queue_age_high_s
        low = demand <= self.low_util and q_age == 0.0
        return {"demand": demand, "queue_age_s": q_age,
                "high": high, "low": low, "n_live": len(live)}

    def _hot_role(self) -> str:
        """Disagg-aware scale-up role: grow the tier that is hotter —
        prefill when the admission side (router queue + prefill-capable
        load) dominates, decode when decode occupancy does."""
        r = self.router
        if not r._disagg:
            return "both"
        pre_load = r._queued()
        dec_load = 0
        for name, w in r.workers.items():
            role = r._role(name)
            if role in ("prefill", "both"):
                pre_load += w.load()
            if role in ("decode", "both"):
                dec_load += w.load()
        return "prefill" if pre_load >= dec_load else "decode"

    # ----------------------------------------------------------- the loop
    def step(self) -> None:
        """One decision pump. Never raises on a fault-site hit; never
        blocks on a drain (the scale-down state machine advances across
        steps)."""
        now = self._clock()
        try:
            faults.maybe_fail("autoscale.decide")
        except Exception:
            # a faulted decision round observes nothing and acts on
            # nothing — the next round re-reads the world from scratch
            self.stats["decide_faults"] += 1
            return
        self._advance_down(now)
        press = self._pressure()
        if press["high"]:
            self._hi += 1
            self._lo = 0
        elif press["low"]:
            self._lo += 1
            self._hi = 0
        else:
            self._hi = self._lo = 0     # hysteresis dead band
        n = press["n_live"]
        if self._hi >= self.streak and self._down is None:
            if n < self.max_replicas and self.model is not None:
                if now - self._last_scale_t < self.cooldown_s:
                    self.stats["flap_suppressed"] += 1
                else:
                    self._scale_up(now)
            elif self.brownout_enabled \
                    and self._bo_level < _BROWNOUT_STEPS:
                if now - self._last_scale_t < self.cooldown_s:
                    self.stats["flap_suppressed"] += 1
                else:
                    self._set_brownout(now, self._bo_level + 1)
        elif self._lo >= self.streak:
            if self._bo_level > 0:
                if now - self._last_scale_t < self.cooldown_s:
                    self.stats["flap_suppressed"] += 1
                else:
                    self._set_brownout(now, self._bo_level - 1)
            elif n > self.min_replicas and self._down is None:
                if now - self._last_scale_t < self.cooldown_s:
                    self.stats["flap_suppressed"] += 1
                else:
                    self._begin_scale_down(now)

    # ----------------------------------------------------------- scale up
    def _scale_up(self, now: float) -> None:
        from .continuous_batching import ContinuousBatcher
        from .fleet import FleetWorker

        role = self._hot_role()
        name = f"{self.name_prefix}{self._spawn_i}"
        try:
            faults.maybe_fail("autoscale.scale_up", replica=name,
                              role=role)
        except Exception:
            # the fault aborts BEFORE any worker exists: no half-started
            # replica, no registry entry — the next streak retries
            self.stats["scale_up_faults"] += 1
            self._note("scale_up_fault", replica=name)
            return
        self._spawn_i += 1
        eng = ContinuousBatcher(self.model, **self.engine_kw)
        w = FleetWorker(name, eng, self.router.registry,
                        heartbeat_interval=self.hb_interval, role=role)
        if self.warm_prompt is not None:
            w.warm(self.warm_prompt)
        w.start()
        self.spawned.append(w)
        self.router.add_worker(w)
        self._apply_brownout_to(eng)    # a mid-brownout spawn joins it
        # wait for the warm lease: the router only targets fresh leases,
        # so capacity exists the moment the store sees the first beat
        deadline = time.monotonic() + self.lease_wait_s
        while time.monotonic() < deadline:
            st = self.router.registry.state().get(name)
            if st is not None and st["fresh"]:
                break
            time.sleep(0.005)
        self.stats["scale_ups"] += 1
        self._last_scale_t = now
        self._hi = self._lo = 0
        self._note("scale_up", t=now, replica=name, role=role)

    # --------------------------------------------------------- scale down
    def _pick_victim(self) -> Optional[object]:
        """Least-loaded live replica whose removal keeps the fleet legal:
        never below min, never the last prefill-capable or decode-capable
        replica of a disagg fleet, never one already quarantined (the
        gray machinery owns those)."""
        r = self.router
        live = [w for w in self._live_workers()
                if w.name not in r._drain_evac
                and r._gray_state(w.name) == "ok"]
        if len(live) <= self.min_replicas:
            return None

        def legal(w) -> bool:
            if not r._disagg:
                return True
            rest = [x for x in live if x is not w]
            return (any(r._role(x.name) in ("prefill", "both")
                        for x in rest)
                    and any(r._role(x.name) in ("decode", "both")
                            for x in rest))

        cands = [w for w in live if legal(w)]
        return min(cands, key=lambda w: w.load()) if cands else None

    def _begin_scale_down(self, now: float) -> None:
        victim = self._pick_victim()
        if victim is None:
            return
        try:
            faults.maybe_fail("autoscale.scale_down",
                              replica=victim.name)
        except Exception:
            # the fault fires BEFORE the drain mark: the victim keeps
            # serving, keeps its lease, keeps every stream — degraded
            # capacity headroom, never a lossy teardown
            self.stats["scale_down_faults"] += 1
            self._note("scale_down_fault", replica=victim.name)
            return
        evac0 = self.router.stats["evacuations"]
        self.router.begin_drain(victim.name)
        self._down = {"name": victim.name, "t0": now, "evac0": evac0}
        self._last_scale_t = now
        self._hi = self._lo = 0
        self._note("scale_down_begin", t=now, replica=victim.name)

    def _advance_down(self, now: float) -> None:
        """Advance the in-flight scale-down: the router's evacuation
        sweep moves the victim's streams; this only watches for the
        provably-empty (or provably-dead) terminal states."""
        d = self._down
        if d is None:
            return
        r = self.router
        name = d["name"]
        w = r.workers.get(name)
        if w is None:
            self._down = None
            return
        if name in r._dead or not w.alive():
            # SIGKILLed (or crashed) mid-evacuation: journaled failover
            # owns every stream now — abandon the drain; the dead worker
            # stays in the membership record like any other dead replica
            r.end_drain(name)
            self.stats["scale_downs_aborted"] += 1
            self._down = None
            self._note("scale_down_aborted", replica=name)
            return
        busy = any((not fr.done) and fr.replica == name
                   for fr in r._reqs.values())
        if busy:
            if now - d["t0"] > self.drain_timeout_s:
                # evacuation is not converging (no destination, budget
                # dry): give the victim back — degradation, never loss
                r.end_drain(name)
                self.stats["scale_downs_aborted"] += 1
                self._down = None
                self._note("scale_down_aborted", replica=name,
                           reason="drain timeout")
            return
        # empty victim: retire it for real
        self.stats["evacuations_started"] += (
            r.stats["evacuations"] - d["evac0"])
        w.terminate()
        r.remove_worker(name)
        r.end_drain(name)
        self.retired.append(w)
        self.stats["scale_downs"] += 1
        self._down = None
        self._note("scale_down", replica=name)

    # ----------------------------------------------------------- brownout
    def _apply_brownout_to(self, eng) -> None:
        """Apply the CURRENT ladder level to one engine — every lever is
        a host-side cap the serving loop reads per wave, so entering or
        exiting a level never changes a wave's shape or launch plan."""
        lvl = self._bo_level
        eng._spec_k_cap = 0 if lvl >= 1 else None
        eng._admit_budget_cap = (max(1, eng.prefill_chunk // 4)
                                 if lvl >= 2 else None)

    def _set_brownout(self, now: float, level: int) -> None:
        level = max(0, min(_BROWNOUT_STEPS, level))
        old = self._bo_level
        if level == old:
            return
        bo = self.stats["brownout"]
        if level > old:
            bo["enters"][level - 1] += 1
        else:
            bo["exits"][old - 1] += 1
        self._bo_level = level
        bo["level"] = level
        for w in self._live_workers():
            self._apply_brownout_to(w.engine)
        r = self.router
        if level >= 3 and r.brownout_shed_tiers == 0:
            r.brownout_shed_tiers = 1
            # entering L3 also sheds what is ALREADY queued in the
            # lowest tier — holding doomed work would defeat the point
            bo["shed_tiers"] += r.shed_queued_tier(r.n_tiers - 1)
        elif level < 3:
            r.brownout_shed_tiers = 0
        self._last_scale_t = now
        self._hi = self._lo = 0
        self._note("brownout", t=now, level=level, prev=old)

    # ------------------------------------------------------------- health
    def autoscaler_snapshot(self) -> dict:
        """The health_snapshot()["autoscaler"] record (reliability/
        health.py): current/min/max replicas, scale and fault counters,
        the brownout ladder state, and the recent event trail."""
        press = None
        try:
            press = self._pressure()
        except Exception:
            pass        # a racing membership mutation degrades to None
        return {
            "replicas": len(self._live_workers()),
            "min_replicas": self.min_replicas,
            "max_replicas": self.max_replicas,
            "cooldown_s": self.cooldown_s,
            "scale_ups": self.stats["scale_ups"],
            "scale_downs": self.stats["scale_downs"],
            "scale_downs_aborted": self.stats["scale_downs_aborted"],
            "evacuations": self.stats["evacuations_started"],
            "flap_suppressed": self.stats["flap_suppressed"],
            "decide_faults": self.stats["decide_faults"],
            "scale_up_faults": self.stats["scale_up_faults"],
            "scale_down_faults": self.stats["scale_down_faults"],
            "brownout": {
                "enabled": self.brownout_enabled,
                "level": self.stats["brownout"]["level"],
                "enters": list(self.stats["brownout"]["enters"]),
                "exits": list(self.stats["brownout"]["exits"]),
                "shed_tiers": self.stats["brownout"]["shed_tiers"],
            },
            "draining": None if self._down is None else self._down["name"],
            "pressure": press,
            "events": list(self.events)[-16:],
        }
