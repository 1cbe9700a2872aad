"""Gray-failure defense: the port against the JAX package, on the CPU.

Restates ``tests/test_gray_failure.py`` as port against reference: the
telemetry rides the lease, the stall knob shows in it, a slow-but-alive
replica is detected fleet-relatively, quarantined, evacuated over park ->
KVMigrator -> resume and retired by canaries (or reinstated once its
condition clears), the retry budget caps failovers and evacuations, and
the quarantine / evacuate fault sites degrade as the reference's. Every
drill runs on both packages' fleets: the port's tokens equal the JAX solo
rollout, its statuses and verdict counters equal the JAX fleet's.

Gray verdicts read gossiped latency, so the reference's drills depend on
the host's speed; ``test_canary_reinstates_recovered_replica`` is flaky
there. Here the fleet module's clock is a ``TickClock`` on both packages:
a replica's telemetry advances 1 ms a tick, plus the stall it is given
(the stall also sleeps for real, so the straggler's streams outlive its
detection), so every verdict is a function of the ticks alone.
"""

from __future__ import annotations

import numpy as np
import pytest

from torch_fleet_pairs import (ENGINE_KW, TickClock, both, check_allocators,
                               clear_faults, make_namespaces, solo, stop,
                               wait, wait_fresh)
from torch_fleet_pairs import warm as warm_jax

VERDICTS = ("quarantines", "evacuations_failed", "failovers", "reinstated",
            "gray_retired")


@pytest.fixture(autouse=True)
def _clean_registry():
    clear_faults()
    yield
    clear_faults()


@pytest.fixture(scope="module")
def ns():
    jax_ns, port_ns = make_namespaces()
    warm_jax(jax_ns)
    return jax_ns, port_ns


@pytest.fixture
def clock(ns, monkeypatch):
    """One TickClock installed as both fleet modules' ``time``."""
    c = TickClock()
    for n in ns:
        monkeypatch.setattr(n.fleet_mod, "time", c)
    return c


def _fleet(n, k, ttl=2.0, hb=0.02, **kw):
    registry, workers = n.make_fleet(n.model, k, heartbeat_interval=hb,
                                     lease_ttl=ttl, **dict(ENGINE_KW, **kw))
    for w in workers:
        w.start()
    return registry, workers


def _prompts(seed, k, lo=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 96, size=lo + i).astype(np.int32)
            for i in range(k)]


def _mid_stream_victim(router, rids):
    victim = [None]

    def streaming():
        for r in rids:
            fr = router.request(r)
            if fr.status == "dispatched" and len(fr._journal) >= 2:
                victim[0] = fr.replica
                return True
        return False

    wait(streaming, router=router)
    return victim[0]


def _stall(n, clock, victim, ms):
    """Stall every tick of ``victim``: a real ``fleet.tick`` delay and the
    same time on its telemetry clock."""
    clock.extra_ms[victim] = ms
    n.faults.inject("fleet.tick", delay_s=ms / 1e3,
                    when=lambda ctx: ctx["replica"] == victim)


def _tuned(router, **kw):
    router.GRAY_STREAK = 2
    router.GRAY_CANARY_LIMIT = 2
    router.GRAY_PROBE_GAP_S = 0.01
    for k, v in kw.items():
        setattr(router, k, v)
    return router


# --------------------------------------------------------------- telemetry


def test_telemetry_rides_the_lease(ns):
    """The heartbeat gossips per-replica latency telemetry with the
    reference's keys."""
    def drill(n):
        registry, workers = _fleet(n, 1)
        try:
            router = n.FleetRouter(workers, registry)
            rid = router.submit(_prompts(3, 1)[0], 16)
            done = router.join(timeout=60)

            def gossiped():
                lease = (router._state.get("replica0") or {}).get(
                    "lease") or {}
                tel = lease.get("telemetry") or {}
                return (tel.get("samples", 0) > 0
                        and tel.get("tick_ms_ewma") is not None)

            wait(gossiped, router=router)
            tel = router._state["replica0"]["lease"]["telemetry"]
            return dict(status=done[rid].status, keys=set(tel),
                        ordered=tel["itl_p50_ms"] <= tel["itl_p99_ms"])
        finally:
            stop(workers)

    jr, tr = both(*ns, drill)
    assert tr == jr
    assert tr["status"] == "ok" and tr["ordered"]
    assert tr["keys"] >= {"itl_ewma_ms", "itl_p50_ms", "itl_p99_ms",
                          "tick_ms_ewma", "queue_age_s", "samples"}


def test_stall_knob_shows_in_telemetry(ns):
    """The stall knob makes a replica slow-but-alive, visible in its
    tick-duration EWMA (wall clock: the knob sleeps)."""
    def drill(n):
        registry, workers = _fleet(n, 1)
        try:
            workers[0].stall_s = 0.05
            router = n.FleetRouter(workers, registry)
            rid = router.submit(_prompts(4, 1)[0], 8)
            done = router.join(timeout=60)
            return (done[rid].status,
                    workers[0]._telemetry()["tick_ms_ewma"] >= 40.0)
        finally:
            stop(workers)

    assert both(*ns, drill) == (("ok", True), ("ok", True))


# ------------------------------------------------- the chaos gate (tier 1)


@pytest.mark.chaos
def test_gray_straggler_quarantined_and_evacuated(ns, clock):
    """One of three replicas stalls mid-stream: detected fleet-relatively,
    quarantined (its lease still fresh), its live streams evacuated with
    one recomputed token each, every request exact, the still-slow
    replica retired by canaries."""
    ps = _prompts(7, 6)
    NEW = 32

    def drill(n):
        registry, workers = _fleet(n, 3, host_tier=True)
        try:
            router = _tuned(n.FleetRouter(workers, registry,
                                          gray_factor=3.0))
            wait_fresh(router, workers)
            rids = [router.submit(p, NEW) for p in ps]
            victim = _mid_stream_victim(router, rids)
            _stall(n, clock, victim, 40.0)
            wait(lambda: router._gray_state(victim) in
                 ("quarantined", "retired"), router=router, timeout=60)
            gated = (victim not in [w.name for w in router._targets()]
                     and victim not in router._dead)
            done = router.join(timeout=120)
            peers = [w for w in workers if w.name != victim]
            mid = dict(
                ids=[done[r].output_ids for r in rids],
                status=[done[r].status for r in rids], gated=gated,
                migrated=sum(done[r].migrated for r in rids),
                resumes=sum(w.engine.stats["resumes"] for w in peers),
                recovered=sum(w.mig_stats["resumes_recovered"]
                              for w in peers))
            wait(lambda: router.stats["gray_retired"] == 1,
                 router=router, timeout=60)
            fh = router.fleet_health()
            snap = n.health.health_snapshot()["fleet"]
            check_allocators(workers)
            return dict(
                mid, verdicts={k: router.stats[k] for k in VERDICTS},
                evacuations=router.stats["evacuations"],
                probes=router.stats["canary_probes"],
                health=(fh["quarantined_now"], fh["gray"]["retired"],
                        fh["gray"]["per_replica"][victim]["state"]),
                in_snapshot=any(rec.get("gray", {}).get("retired") == 1
                                for rec in snap if isinstance(rec, dict)))
        finally:
            stop(workers)
            clock.extra_ms.clear()

    jr, tr = both(*ns, drill)
    for p, ids in zip(ps, tr["ids"]):
        assert ids == solo(ns[0], p, NEW)
    assert tr["status"] == ["ok"] * 6 == jr["status"]
    assert tr["gated"] and jr["gated"]
    assert tr["verdicts"] == jr["verdicts"] == dict(
        quarantines=1, evacuations_failed=0, failovers=0, reinstated=0,
        gray_retired=1)
    assert tr["evacuations"] >= 1
    assert tr["migrated"] == tr["resumes"] == tr["recovered"] \
        == tr["evacuations"]
    assert tr["probes"] >= 2
    assert tr["health"] == jr["health"] == (0, 1, "retired")
    assert tr["in_snapshot"]


@pytest.mark.chaos
def test_canary_reinstates_recovered_replica(ns, clock):
    """A replica gray for a transient reason (its stall cleared once it is
    quarantined) passes consecutive canaries and is reinstated, back in
    the dispatch targets."""
    ps = _prompts(9, 6)
    NEW = 24

    def drill(n):
        registry, workers = _fleet(n, 3)
        try:
            router = _tuned(n.FleetRouter(workers, registry,
                                          gray_factor=3.0),
                            GRAY_CANARY_PASSES=2, GRAY_CANARY_LIMIT=100,
                            GRAY_COOLDOWN_S=0.05)
            wait_fresh(router, workers)
            rids = [router.submit(p, NEW) for p in ps]
            victim = _mid_stream_victim(router, rids)
            _stall(n, clock, victim, 50.0)
            wait(lambda: router._gray_state(victim) == "quarantined",
                 router=router, timeout=60)
            n.faults.clear("fleet.tick")        # the condition clears
            clock.extra_ms.clear()
            done = router.join(timeout=120)
            wait(lambda: router.stats["reinstated"] == 1, router=router,
                 timeout=60)
            wait(lambda: victim in [w.name for w in router._targets()],
                 router=router)
            check_allocators(workers)
            return dict(ids=[done[r].output_ids for r in rids],
                        status=[done[r].status for r in rids],
                        state=router._gray_state(victim),
                        probes=router.stats["canary_probes"],
                        verdicts={k: router.stats[k] for k in VERDICTS})
        finally:
            stop(workers)
            clock.extra_ms.clear()

    jr, tr = both(*ns, drill)
    for p, ids in zip(ps, tr["ids"]):
        assert ids == solo(ns[0], p, NEW)
    assert tr["status"] == ["ok"] * 6 == jr["status"]
    assert tr["state"] == jr["state"] == "ok"
    assert tr["probes"] >= 2
    assert tr["verdicts"] == jr["verdicts"] == dict(
        quarantines=1, evacuations_failed=0, failovers=0, reinstated=1,
        gray_retired=0)


# ---------------------------------------------------------- retry budget


@pytest.mark.chaos
def test_retry_budget_exhaustion_degrades_to_replica_lost(ns):
    """An empty retry budget turns failover re-dispatches into
    `replica_lost`; a 2-replica fleet is exempt from gray detection."""
    ps = _prompts(11, 4)
    NEW = 24

    def drill(n):
        registry, workers = _fleet(n, 2, ttl=1.0, hb=0.05)
        try:
            router = n.FleetRouter(workers, registry, retry_budget=0)
            wait_fresh(router, workers)
            rids = [router.submit(p, NEW) for p in ps]
            wait(lambda: len(router.request(rids[0])._journal) >= 2,
                 router=router)
            victim = router.request(rids[0]).replica
            router.workers[victim].kill()
            done = router.join(timeout=120)
            lost = [r for r in rids if done[r].status == "replica_lost"]
            check_allocators(workers, skip=(victim,))
            return dict(
                lost=lost,
                budget=all("budget" in (done[r].error or "") for r in lost),
                ids={r: done[r].output_ids for r in rids if r not in lost},
                status=[done[r].status for r in rids],
                denials=router.stats["budget_denials"],
                redispatched=router.stats["redispatched"],
                quarantines=router.stats["quarantines"])
        finally:
            stop(workers)

    jr, tr = both(*ns, drill)
    assert tr["lost"] and tr["budget"]
    for r, ids in tr["ids"].items():     # rids count from 0
        assert ids == solo(ns[0], ps[r], NEW)
    assert tr["denials"] == len(tr["lost"])
    assert tr["redispatched"] == tr["quarantines"] == 0
    for k in ("lost", "status", "denials", "redispatched", "quarantines"):
        assert tr[k] == jr[k], k


@pytest.mark.chaos
def test_retry_budget_caps_evacuations(ns, clock):
    """With the bucket empty the straggler is still quarantined, but its
    streams decode on at the slow source: exact, never migrated."""
    ps = _prompts(13, 6)
    NEW = 24

    def drill(n):
        registry, workers = _fleet(n, 3, host_tier=True)
        try:
            router = _tuned(n.FleetRouter(workers, registry,
                                          gray_factor=3.0, retry_budget=0))
            wait_fresh(router, workers)
            rids = [router.submit(p, NEW) for p in ps]
            victim = _mid_stream_victim(router, rids)
            _stall(n, clock, victim, 40.0)
            wait(lambda: router._gray_state(victim) in
                 ("quarantined", "retired"), router=router, timeout=60)
            done = router.join(timeout=120)
            check_allocators(workers)
            return dict(ids=[done[r].output_ids for r in rids],
                        status=[done[r].status for r in rids],
                        quarantines=router.stats["quarantines"],
                        evacuations=router.stats["evacuations"],
                        denied=router.stats["budget_denials"] >= 1,
                        migrated=[done[r].migrated for r in rids])
        finally:
            stop(workers)
            clock.extra_ms.clear()

    jr, tr = both(*ns, drill)
    for p, ids in zip(ps, tr["ids"]):
        assert ids == solo(ns[0], p, NEW)
    assert tr["status"] == ["ok"] * 6
    assert tr["quarantines"] == 1 and tr["evacuations"] == 0
    assert tr["denied"] and tr["migrated"] == [0] * 6
    for k in ("status", "quarantines", "evacuations", "denied", "migrated"):
        assert tr[k] == jr[k], k


# ----------------------------------------------------- fault-site drills


@pytest.mark.chaos
def test_quarantine_fault_skips_verdict_not_replica(ns, clock):
    """A faulted router.quarantine drops that verdict; the replica keeps
    serving and the next streak of evidence re-flags it."""
    ps = _prompts(17, 6)

    def drill(n):
        registry, workers = _fleet(n, 3)
        try:
            router = _tuned(n.FleetRouter(workers, registry,
                                          gray_factor=3.0))
            wait_fresh(router, workers)
            rids = [router.submit(p, 24) for p in ps]
            victim = _mid_stream_victim(router, rids)
            n.faults.inject("router.quarantine", nth=1)
            _stall(n, clock, victim, 50.0)
            wait(lambda: router.stats["quarantine_faults"] == 1,
                 router=router, timeout=60)
            skipped = router._gray_state(victim)
            wait(lambda: router._gray_state(victim) == "quarantined",
                 router=router, timeout=60)
            quarantines = router.stats["quarantines"]
            n.faults.clear("fleet.tick")
            clock.extra_ms.clear()
            done = router.join(timeout=120)
            return dict(skipped=skipped, quarantines=quarantines,
                        ids=[done[r].output_ids for r in rids],
                        status=[done[r].status for r in rids])
        finally:
            stop(workers)
            clock.extra_ms.clear()

    jr, tr = both(*ns, drill)
    for p, ids in zip(ps, tr["ids"]):
        assert ids == solo(ns[0], p, 24)
    assert tr["status"] == ["ok"] * 6 == jr["status"]
    assert (tr["skipped"], tr["quarantines"]) == (jr["skipped"],
                                                  jr["quarantines"])
    assert tr["skipped"] in ("ok", "suspect") and tr["quarantines"] == 1


@pytest.mark.chaos
def test_evacuate_fault_pins_stream_to_source(ns, clock):
    """A faulted router.evacuate pins only that stream to its slow
    source: exact, just late; never an error, never migrated."""
    ps = _prompts(19, 6)
    NEW = 24

    def drill(n):
        registry, workers = _fleet(n, 3, host_tier=True)
        try:
            router = _tuned(n.FleetRouter(workers, registry,
                                          gray_factor=3.0))
            wait_fresh(router, workers)
            rids = [router.submit(p, NEW) for p in ps]
            victim = _mid_stream_victim(router, rids)
            n.faults.inject("router.evacuate", times=None)
            _stall(n, clock, victim, 40.0)
            wait(lambda: router._gray_state(victim) in
                 ("quarantined", "retired"), router=router, timeout=60)
            done = router.join(timeout=120)
            check_allocators(workers)
            return dict(ids=[done[r].output_ids for r in rids],
                        status=[done[r].status for r in rids],
                        faulted=router.stats["evacuate_faults"] >= 1,
                        evacuations=router.stats["evacuations"],
                        migrated=[done[r].migrated for r in rids])
        finally:
            stop(workers)
            clock.extra_ms.clear()

    jr, tr = both(*ns, drill)
    for p, ids in zip(ps, tr["ids"]):
        assert ids == solo(ns[0], p, NEW)
    assert tr["status"] == ["ok"] * 6 and tr["faulted"]
    assert tr["evacuations"] == 0 and tr["migrated"] == [0] * 6
    for k in ("status", "faulted", "evacuations", "migrated"):
        assert tr[k] == jr[k], k
