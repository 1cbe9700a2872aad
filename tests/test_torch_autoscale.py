"""Elastic autoscaling under trace-driven load: the port against the JAX
package, on the CPU.

Restates ``tests/test_autoscale.py`` on the tiny fleet model of
``tests/torch_fleet_pairs.py``:

  * ``loadgen``: the same ``TraceSpec`` gives the port and the JAX package
    byte-identical ``trace_bytes`` (and JSON); replay determinism; the
    trace's shapes and skew;
  * the batcher's brownout levers: ``_admit_budget_cap`` shrinks the
    admission waves without changing a token, the wave's width or any
    stat but the wave counts the JAX engine shows too (fp and int8);
    ``_spec_k_cap`` clamps on the host;
  * ``FleetAutoscaler``: the ladder escalating and reversing (the port's
    ladder counters, shed counts and statuses equal the JAX fleet's on the
    same drill, fp and int8); a lossless scale-down (``resumes ==
    evacuations``); a faulted scale-down leaving the victim serving; the
    decide and scale-up faults aborting one decision each; the autoscale
    cycle chaos gate over a replayed trace; the victim killed
    mid-evacuation; the health snapshot's autoscaler record (its keys the
    JAX package's).

Every token the port emits is held to the JAX package's solo
``generate_paged`` (the chaos gate's 36-odd trace requests to the JAX
package's ``ContinuousBatcher`` on the same requests, whose tokens equal its
solo rollout by the JAX package's own contract, plus a solo spot check).
Evacuating drills run fp only: an int8 stream that is parked and resumed
recomputes its last token as a prefill row and may leave the solo rollout
(ROADMAP Queue 3 caveat), in the reference and the port alike.

The autoscaler's decisions read an injected clock (``PumpClock``) that
advances a fixed step every time a drill pumps it, so streaks and
cooldowns count pumps, whatever the host's load; the drills' own waits
have timeouts, and every worker is joined in ``finally``. The reference's
``test_scale_down_lossless_evacuation`` fails in some runs (ROADMAP Queue 3
caveats): its port here admits the two streams one after the other on
distinct replicas and stalls their serve loops, so both are still
streaming when the drain begins.
"""

from __future__ import annotations

import time

import numpy as np
import pytest

from paddle_tpu.inference import autoscaler as jautoscaler
from paddle_tpu.inference import loadgen as jloadgen
from paddle_tpu.inference.continuous_batching import \
    ContinuousBatcher as JaxBatcher

from paddle_tpu_torch.inference import autoscaler as tautoscaler
from paddle_tpu_torch.inference import loadgen as tloadgen

from torch_batcher_pairs import comparable
from torch_fleet_pairs import (ENGINE_KW, check_allocators, clear_faults,
                               fleet, make_namespaces, prompts, solo, stop,
                               wait, wait_fresh)
from torch_fleet_pairs import warm as warm_jax


@pytest.fixture(autouse=True)
def _clean_registry():
    clear_faults()
    yield
    clear_faults()


@pytest.fixture(scope="module")
def ns():
    jax_ns, port_ns = make_namespaces()
    warm_jax(jax_ns)
    jax_ns.Autoscaler, jax_ns.loadgen = (jautoscaler.FleetAutoscaler,
                                         jloadgen)
    port_ns.Autoscaler, port_ns.loadgen = (tautoscaler.FleetAutoscaler,
                                           tloadgen)
    return jax_ns, port_ns


class PumpClock:
    """The autoscaler's clock: seconds that advance by ``dt`` each time a
    drill pumps the autoscaler, from the wall clock's reading at creation
    (the router's queue ages are wall-clock ages)."""

    def __init__(self, dt=0.01):
        self.t = time.monotonic()
        self.dt = dt

    def __call__(self):
        return self.t

    def tick(self):
        self.t += self.dt


def _autoscaler(ns, router, model=None, dt=0.01, **kw):
    clock = PumpClock(dt)
    auto = ns.Autoscaler(router, model, clock=clock, **kw)
    step = auto.step

    def pumped_step():
        clock.tick()
        step()

    auto.step = pumped_step
    return auto


def _pump(router, auto, cond, timeout=60.0, interval=0.002):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        router.poll()
        if auto is not None:
            auto.step()
        if cond():
            return
        time.sleep(interval)
    raise AssertionError(f"condition not reached within {timeout}s")


def _stop_all(workers, auto, timeout=5.0):
    stop(list(workers) + list(auto.spawned), timeout)
    for w in auto.retired:
        w.join(timeout)


def _total_resumes(workers, auto):
    return sum(int(w.engine.stats.get("resumes", 0))
               for w in list(workers) + list(auto.spawned))


def _tail(jax_ns, prompt, max_new, stack="fp"):
    return solo(jax_ns, prompt, max_new, stack)[len(prompt):]


def _mid_stream(router, rids):
    """Both requests dispatched to distinct replicas with >= 2 journaled
    tokens each."""
    return len({router.request(r).replica for r in rids
                if router.request(r).status == "dispatched"
                and len(router.request(r)._journal) >= 2}) == len(rids)


# ------------------------------------------------------ trace generator

SPECS = {
    "default": dict(),
    "adapters": dict(seed=7, n_requests=48, n_adapters=3),
    "bursty": dict(seed=20, n_requests=36, horizon_s=2.0, base_rate=18.0,
                   bursts=((0.2, 0.9, 4.0),), prompt_mean=10.0,
                   prompt_cap=20, new_mean=8.0, new_cap=12, n_tenants=4,
                   tiers=((10.0, 0.5), (None, 0.5))),
}


@pytest.mark.parametrize("name", list(SPECS) + ["chip_smoke_6h"])
def test_trace_bytes_equal_the_jax_package(name):
    """The same TraceSpec gives the same request stream in both packages:
    byte for byte, and the same canonical JSON."""
    if name == "chip_smoke_6h":
        import chip_smoke

        kw = chip_smoke.autoscale_spec_kw(base_rate=3.7)
    else:
        kw = SPECS[name]
    tspec, jspec = tloadgen.TraceSpec(**kw), jloadgen.TraceSpec(**kw)
    assert tspec.to_json() == jspec.to_json()
    tb = tloadgen.trace_bytes(tloadgen.generate_trace(tspec))
    assert tb == jloadgen.trace_bytes(jloadgen.generate_trace(jspec))
    assert len(tloadgen.generate_trace(tspec)) == tspec.n_requests


def test_trace_replay_determinism():
    """Same seed => byte-identical stream, across two generator instances
    and a serialize/deserialize round trip; a different seed diverges."""
    spec = tloadgen.TraceSpec(seed=7, n_requests=48, n_adapters=3)
    a = tloadgen.trace_bytes(tloadgen.generate_trace(spec))
    assert tloadgen.trace_bytes(tloadgen.generate_trace(spec)) == a
    rt = tloadgen.TraceSpec.from_json(spec.to_json())
    assert rt == spec
    assert tloadgen.trace_bytes(tloadgen.generate_trace(rt)) == a
    assert tloadgen.trace_bytes(tloadgen.generate_trace(
        tloadgen.TraceSpec(seed=8, n_requests=48, n_adapters=3))) != a


def test_trace_shapes_and_skew():
    """Lengths within the spec's bounds, arrivals strictly increasing, every
    deadline tier present, low-rank tenants dominating, and each tenant's
    requests sharing its prefix."""
    spec = tloadgen.TraceSpec(seed=1, n_requests=200, n_tenants=8,
                              zipf_alpha=1.3)
    trace = tloadgen.generate_trace(spec)
    ts = [r.t for r in trace]
    assert all(t1 > t0 for t0, t1 in zip(ts, ts[1:]))
    for r in trace:
        assert spec.prompt_min <= len(r.prompt) <= spec.prompt_cap
        assert spec.new_min <= r.max_new <= spec.new_cap
        assert all(0 <= x < spec.vocab for x in r.prompt)
    deadlines = {r.deadline_s for r in trace}
    assert None in deadlines and len(deadlines) >= 2
    counts = np.bincount([r.tenant for r in trace],
                         minlength=spec.n_tenants)
    assert counts[0] > counts[spec.n_tenants - 1]
    t0 = [r for r in trace if r.tenant == 0]
    assert len({r.prompt[:spec.tenant_prefix_len] for r in t0}) == 1


# ------------------------------------------------------ brownout levers


@pytest.mark.parametrize("stack", ["fp", "int8"])
def test_admit_budget_cap_shrinks_waves_token_identically(ns, stack):
    """Brownout L2's lever: a capped admission budget takes more waves to
    prefill and changes no token, no wave width (T) and no stat but the
    wave counts, which equal the JAX engine's under the same cap."""
    jax_ns, port_ns = ns
    ps = prompts(11, 3, lo=9, hi=14)
    runs = {}
    for label, make, kw in (
            ("port", port_ns.Batcher, port_ns.stack_kw(stack)),
            ("jax", JaxBatcher, jax_ns.stack_kw(stack))):
        for cap in (None, 2):
            eng = make(port_ns.model if label == "port" else jax_ns.model,
                       **ENGINE_KW, **kw)
            eng._admit_budget_cap = cap
            rids = [eng.submit(p, 6) for p in ps]
            done = eng.run()
            runs[label, cap] = ([list(done[r].tokens) for r in rids],
                                comparable(eng.stats),
                                getattr(eng, "_ragged_T", None))
    (full_toks, full_st, full_t), (cap_toks, cap_st, cap_t) = (
        runs["port", None], runs["port", 2])
    assert cap_toks == full_toks
    assert cap_t == full_t
    assert cap_st["prefill_dispatches"] > full_st["prefill_dispatches"]
    for p, toks in zip(ps, full_toks):
        assert toks == _tail(jax_ns, p, 6, stack)
    for cap in (None, 2):
        assert runs["port", cap][0] == runs["jax", cap][0]
        assert runs["port", cap][1] == runs["jax", cap][1], cap


def test_spec_k_cap_clamps_host_side(ns):
    """Brownout L1's lever is a host-side clamp that never exceeds the
    wave's spec_k; the admission cap never drops below 1."""
    _, port_ns = ns
    eng = port_ns.Batcher(port_ns.model, **ENGINE_KW)
    k = eng._spec_k
    assert eng._spec_k_eff() == k
    eng._spec_k_cap = 0
    assert eng._spec_k_eff() == 0
    eng._spec_k_cap = k + 5
    assert eng._spec_k_eff() == k
    eng._spec_k_cap = None
    assert eng._spec_k_eff() == k
    eng._admit_budget_cap = 10 ** 9
    assert eng._admit_budget() == eng.prefill_chunk
    eng._admit_budget_cap = 0
    assert eng._admit_budget() == 1


# ----------------------------------------------------------- the ladder


def _ladder_drill(ns, stack):
    registry, workers = fleet(ns, 1, **ns.stack_kw(stack))
    router = ns.FleetRouter(workers, registry, gray_factor=0)
    auto = _autoscaler(ns, router, min_replicas=1, max_replicas=1,
                       cooldown_s=0.0, streak=1, brownout=True)
    out = {}
    try:
        wait_fresh(router, workers)
        keep_p = prompts(3, 6)
        keep = [router.submit(p, 4, deadline_s=10.0) for p in keep_p]
        batch = [router.submit(p, 4) for p in prompts(4, 5)]
        levels = []
        for _ in range(3):
            auto.step()
            levels.append(auto.stats["brownout"]["level"])
        eng = workers[0].engine
        out["levers"] = (eng._spec_k_cap,
                         eng._admit_budget_cap == max(
                             1, eng.prefill_chunk // 4))
        r_new = router.submit(np.arange(5, dtype=np.int32), 4)
        out["shed_new"] = router.request(r_new).status
        out["batch"] = [router.request(r).status for r in batch]
        done = router.join(timeout=60)
        out["keep"] = [(done[r].status, list(done[r].tokens)) for r in keep]
        # calm: the replica's gossiped queue age is back to 0
        wait(lambda: not ((router._state.get(workers[0].name) or {})
                          .get("lease") or {}).get("telemetry", {})
             .get("queue_age_s"), router=router, timeout=30)
        for _ in range(3):
            auto.step()
            levels.append(auto.stats["brownout"]["level"])
        out["levels"] = levels
        out["levers_after"] = (eng._spec_k_cap, eng._admit_budget_cap,
                               router.brownout_shed_tiers)
        out["brownout"] = auto.stats["brownout"]
        out["shed_by_tier"] = list(router.stats["shed_by_tier"])
        r_ok = router.submit(np.arange(5, dtype=np.int32), 4)
        out["after"] = router.join(timeout=60)[r_ok].status
        out["keep_p"] = keep_p
        check_allocators(workers)
    finally:
        _stop_all(workers, auto)
    return out


@pytest.mark.parametrize("stack", ["fp", "int8"])
def test_brownout_ladder_escalates_and_reverses(ns, stack):
    """Saturation at max replicas walks L1 -> L2 -> L3 (spec-k cap,
    admission-budget cap, the lowest tier shed, queued and new), calm walks
    it back to 0 with every lever cleared; the port's ladder equals the
    JAX fleet's on the same drill."""
    jax_ns, port_ns = ns
    j = _ladder_drill(jax_ns, stack)
    p = _ladder_drill(port_ns, stack)
    assert p["levels"] == [1, 2, 3, 2, 1, 0]
    assert p["levers"] == (0, True)
    assert p["levers_after"] == (None, None, 0)
    assert p["brownout"]["enters"] == [1, 1, 1]
    assert p["brownout"]["exits"] == [1, 1, 1]
    assert p["brownout"]["shed_tiers"] == 5
    assert p["batch"] == ["shed"] * 5 and p["shed_new"] == "shed"
    assert p["after"] == "ok"
    for key in ("levels", "levers", "levers_after", "brownout",
                "shed_by_tier", "batch", "shed_new", "after"):
        assert p[key] == j[key], key
    for prompt, (status, toks) in zip(p["keep_p"], p["keep"]):
        assert status == "ok"
        assert toks == _tail(jax_ns, prompt, 4, stack)


# ----------------------------------------------------------- scaling


def test_scale_down_lossless_evacuation(ns):
    """A scale-down victim's live stream is evacuated (park -> KVMigrator
    -> resume, one recomputed token: ``resumes == evacuations``) before
    the victim terminates; both streams finish equal to the JAX package's
    solo rollout; the survivor's allocators stay bijective."""
    jax_ns, port_ns = ns
    registry, workers = fleet(port_ns, 2, host_tier=True)
    router = port_ns.FleetRouter(workers, registry, gray_factor=0)
    auto = _autoscaler(port_ns, router, min_replicas=1, max_replicas=2,
                       cooldown_s=0.1, streak=2, low_util=0.9)
    try:
        wait_fresh(router, workers)
        for w in workers:
            w.stall_s = 0.03        # the streams outlive the drain's start
        ps = prompts(5, 2, lo=6)
        rids = [router.submit(ps[0], 20)]
        _pump(router, None, lambda: _mid_stream(router, rids))
        rids.append(router.submit(ps[1], 20))
        _pump(router, None, lambda: _mid_stream(router, rids))
        _pump(router, auto, lambda: auto.stats["scale_downs"] == 1,
              timeout=90)
        assert len(router.workers) == 1
        survivor = next(iter(router.workers.values()))
        survivor.stall_s = 0.0
        _pump(router, auto, lambda: all(
            router.request(r).done for r in rids), timeout=90)
        for r, p in zip(rids, ps):
            fr = router.request(r)
            assert fr.status == "ok"
            assert list(fr.tokens) == _tail(jax_ns, p, 20)
        assert router.stats["evacuations"] >= 1
        assert _total_resumes(workers, auto) == \
            router.stats["evacuations"]
        assert auto.stats["evacuations_started"] == \
            router.stats["evacuations"]
        assert not router._drain_evac and not router._no_admit
        check_allocators([survivor])
    finally:
        _stop_all(workers, auto)


@pytest.mark.parametrize("stack", ["fp", "int8"])
def test_faulted_scale_down_leaves_victim_serving(ns, stack):
    """``autoscale.scale_down`` fires before the drain mark: the victim
    keeps its lease and its streams; the next low streak retries and
    succeeds."""
    jax_ns, port_ns = ns
    registry, workers = fleet(port_ns, 2, **port_ns.stack_kw(stack))
    router = port_ns.FleetRouter(workers, registry, gray_factor=0)
    auto = _autoscaler(port_ns, router, min_replicas=1, max_replicas=2,
                       cooldown_s=0.0, streak=1, low_util=0.9)
    port_ns.faults.inject("autoscale.scale_down", times=1)
    try:
        wait_fresh(router, workers)
        ps = prompts(9, 2, lo=6)
        rids = [router.submit(p, 8) for p in ps]
        _pump(router, auto, lambda: auto.stats["scale_down_faults"] == 1)
        assert len(router.workers) == 2
        assert not router._drain_evac and not router._no_admit
        assert auto.stats["scale_downs"] == 0
        done = router.join(timeout=60)
        for r, p in zip(rids, ps):
            assert done[r].status == "ok"
            assert list(done[r].tokens) == _tail(jax_ns, p, 8, stack)
        _pump(router, auto, lambda: auto.stats["scale_downs"] == 1,
              timeout=90)
        assert len(router.workers) == 1
        assert auto.stats["scale_down_faults"] == 1
        check_allocators(router.workers.values())
    finally:
        _stop_all(workers, auto)


@pytest.mark.parametrize("stack", ["fp", "int8"])
def test_decide_and_scale_up_faults_abort_cleanly(ns, stack):
    """``autoscale.decide`` skips whole rounds; ``autoscale.scale_up``
    aborts before any worker exists (no registry entry) and the next
    streak spawns a replica over the same model and weights."""
    jax_ns, port_ns = ns
    kw = port_ns.stack_kw(stack)
    registry, workers = fleet(port_ns, 1, **kw)
    router = port_ns.FleetRouter(workers, registry, gray_factor=0)
    auto = _autoscaler(port_ns, router, port_ns.model,
                       engine_kw=dict(ENGINE_KW, **kw), min_replicas=1,
                       max_replicas=2, cooldown_s=0.0, streak=1,
                       brownout=False, heartbeat_interval=0.05)
    port_ns.faults.inject("autoscale.decide", times=2)
    port_ns.faults.inject("autoscale.scale_up", times=1)
    try:
        wait_fresh(router, workers)
        ps = prompts(13, 10)
        rids = [router.submit(p, 6) for p in ps]
        _pump(router, auto, lambda: auto.stats["scale_ups"] == 1,
              timeout=90)
        assert auto.stats["decide_faults"] == 2
        assert auto.stats["scale_up_faults"] == 1
        assert len(router.workers) == 2
        assert len(registry.replicas()) == 2
        # the spawned replica reads the same weights (one copy)
        spawned, first = auto.spawned[0].engine, workers[0].engine
        assert spawned.model is first.model
        for name, p in first.params.items():
            q = spawned.params[name]
            if hasattr(p, "codes"):
                p, q = p.codes, q.codes
            assert q.data_ptr() == p.data_ptr(), name
        done = router.join(timeout=90)
        for r, p in zip(rids, ps):
            assert done[r].status == "ok"
            assert list(done[r].tokens) == _tail(jax_ns, p, 6, stack)
        check_allocators(router.workers.values())
    finally:
        _stop_all(workers, auto)


# -------------------------------------------------------- chaos drills


@pytest.mark.chaos
def test_autoscale_cycle_chaos_gate(ns):
    """One replayed trace drives grow -> burst -> brownout -> shrink. Every
    completed request equals an undisturbed run's tokens; evacuations
    recompute one token each (``resumes == evacuations``); no two
    scale/brownout events closer than the cooldown; the ladder back at 0
    and the fleet back at one replica; allocators bijective."""
    jax_ns, port_ns = ns
    spec = tloadgen.TraceSpec(**SPECS["bursty"])
    trace = tloadgen.generate_trace(spec)
    registry, workers = fleet(port_ns, 1, host_tier=True)
    router = port_ns.FleetRouter(workers, registry, gray_factor=0)
    cooldown = 0.4
    auto = _autoscaler(port_ns, router, port_ns.model,
                       engine_kw=dict(ENGINE_KW, host_tier=True),
                       min_replicas=1, max_replicas=2, cooldown_s=cooldown,
                       streak=2, low_util=0.3, queue_age_high_s=0.05,
                       heartbeat_interval=0.05)
    try:
        wait_fresh(router, workers)
        # every replica's serve loop slowed alike, or the tiny model
        # outruns the trace and nothing saturates the two-replica ceiling
        port_ns.faults.inject("fleet.tick", delay_s=0.02)
        report = tloadgen.run_trace(router, trace, autoscaler=auto,
                                    settle_timeout_s=120.0)
        assert auto.stats["scale_ups"] >= 1, auto.events
        assert auto.stats["brownout"]["enters"][0] >= 1, auto.events
        tail_p = prompts(21, 2, lo=6)
        tail = [router.submit(p, 16, deadline_s=10.0) for p in tail_p]
        _pump(router, auto, lambda: auto.stats["scale_downs"] >= 1,
              timeout=60)
        _pump(router, auto,
              lambda: all(router.request(r).done for r in tail), timeout=60)
        _pump(router, auto,
              lambda: auto.stats["brownout"]["level"] == 0
              and len(router.workers) == 1, timeout=60)
        port_ns.faults.clear("fleet.tick")
        ok = [r for r in trace if report["completed"][r.idx][0] == "ok"]
        assert len(ok) >= len(trace) // 3, report["tiers"]
        for r in trace:
            assert report["completed"][r.idx][0] in ("ok", "shed",
                                                     "timeout"), r.idx
        # the oracle: the JAX package's engine on the same requests
        eng = JaxBatcher(jax_ns.model, **ENGINE_KW)
        jr = {r.idx: eng.submit(np.asarray(r.prompt, np.int32), r.max_new)
              for r in ok}
        jdone = eng.run()
        for r in ok:
            assert report["completed"][r.idx][1] == list(
                jdone[jr[r.idx]].tokens), f"trace request {r.idx} diverged"
        for r in ok[:2]:
            assert report["completed"][r.idx][1] == _tail(
                jax_ns, np.asarray(r.prompt, np.int32), r.max_new)
        for r, p in zip(tail, tail_p):
            fr = router.request(r)
            assert fr.status == "ok"
            assert list(fr.tokens) == _tail(jax_ns, p, 16)
        assert _total_resumes(workers, auto) == \
            router.stats["evacuations"]
        ev = [e["t"] for e in auto.events
              if e["kind"] in ("scale_up", "scale_down_begin",
                               "brownout")]
        gaps = [t1 - t0 for t0, t1 in zip(ev, ev[1:])]
        assert all(g >= cooldown * 0.99 for g in gaps), gaps
        assert auto.stats["brownout"]["level"] == 0
        assert len(router.workers) == 1
        check_allocators(router.workers.values())
        assert report["queue_curve"]
        assert all(rec["n"] > 0 for rec in report["tiers"].values())
        assert sum(rec["n"] for rec in report["tiers"].values()) == \
            len(trace)
    finally:
        port_ns.faults.clear()
        _stop_all(workers, auto)


@pytest.mark.chaos
def test_sigkill_victim_mid_evacuation(ns):
    """The scale-down victim killed mid-evacuation: the journaled failover
    owns every stream (the solo tokens, or an honest ``replica_lost``),
    the drain is abandoned, the survivor's allocators stay bijective."""
    jax_ns, port_ns = ns
    registry, workers = fleet(port_ns, 2, ttl=0.6, hb=0.02, host_tier=True)
    router = port_ns.FleetRouter(workers, registry, gray_factor=0)
    auto = _autoscaler(port_ns, router, min_replicas=1, max_replicas=2,
                       cooldown_s=0.1, streak=2, low_util=0.9,
                       drain_timeout_s=60.0)
    try:
        wait_fresh(router, workers)
        port_ns.faults.inject("fleet.tick", delay_s=0.03)
        ps = prompts(31, 2, lo=6)
        rids = [router.submit(ps[0], 48)]
        _pump(router, None, lambda: _mid_stream(router, rids))
        rids.append(router.submit(ps[1], 48))
        _pump(router, None, lambda: _mid_stream(router, rids), timeout=90)
        port_ns.faults.inject("kv.migrate", delay_s=0.15)
        _pump(router, auto, lambda: len(router._migrating) > 0,
              timeout=90)
        victim = auto._down["name"]
        router.workers[victim].kill()
        _pump(router, auto,
              lambda: auto.stats["scale_downs_aborted"] == 1, timeout=90)
        _pump(router, auto,
              lambda: all(router.request(r).done for r in rids),
              timeout=120)
        for r, p in zip(rids, ps):
            fr = router.request(r)
            assert fr.status in ("ok", "replica_lost"), fr.status
            if fr.status == "ok":
                assert list(fr.tokens) == _tail(jax_ns, p, 48)
        assert auto.stats["scale_downs"] == 0
        assert not router._drain_evac and not router._no_admit
        assert victim in router._dead
        check_allocators(router.workers.values(), skip=(victim,))
    finally:
        port_ns.faults.clear()
        _stop_all([w for w in workers if w.alive()], auto)


def _snapshot_keys(d):
    return {k: (_snapshot_keys(v) if isinstance(v, dict) else None)
            for k, v in d.items()}


def test_health_snapshot_roundtrip_with_autoscaler(ns):
    """``fleet_health()`` carries the elastic view and
    ``health_snapshot()["autoscaler"]`` the autoscaler's record, whose keys
    (nested) are the JAX package's."""
    jax_ns, port_ns = ns
    recs = {}
    for each in (jax_ns, port_ns):
        registry, workers = fleet(each, 1)
        router = each.FleetRouter(workers, registry, gray_factor=0)
        # cooldown 7.25 s marks this test's autoscaler among any earlier
        # ones the registry's WeakSet still holds
        auto = _autoscaler(each, router, min_replicas=1, max_replicas=2,
                           cooldown_s=7.25)
        try:
            wait_fresh(router, workers)
            auto.step()
            fh = router.fleet_health()
            assert fh["draining_out"] == []
            assert fh["brownout_shed_tiers"] == 0
            recs[each.name] = [a for a in each.health.health_snapshot()
                               ["autoscaler"]
                               if a.get("cooldown_s") == 7.25]
        finally:
            _stop_all(workers, auto)
    rec = recs["port"]
    assert rec and rec[0]["replicas"] == 1
    assert (rec[0]["min_replicas"], rec[0]["max_replicas"]) == (1, 2)
    assert _snapshot_keys(rec[0]) == _snapshot_keys(recs["jax"][0])
    assert rec[0]["pressure"].keys() == recs["jax"][0]["pressure"].keys()
