"""The serving fleet: the port against the JAX package, on the CPU.

Restates ``tests/test_fleet.py`` as port against reference. The stores
(``MemoryStore`` and the port's ``TCPStore`` on
``torch.distributed.TCPStore``) serve the same surface; the registry's
leases, generations, retirement and fault site hold on both. Every fleet
drill runs on the JAX package's fleet and on the port's with the same
inputs: the port's tokens equal the JAX package's solo ``generate_paged``
for every request (journal-spliced recoveries after a SIGKILL included),
and its statuses and non-timing router stats equal the JAX fleet's.

The reference's ``test_prefix_affinity_beats_least_loaded`` races the
seeds' runs against the followers' admission (a replica's radix tree
lives for one run); its port here stalls every tick by 20 ms (the
workers' ``stall_s``), so the seeds are still decoding when the followers
are admitted, whatever the host's load.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import pytest

from torch_fleet_pairs import (CAP, PAGE, FrozenClock, both,
                               check_allocators, clear_faults, fleet,
                               make_namespaces, pick, prompts, solo, stop,
                               wait)
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
    return jax_ns, port_ns


def _store(kind, port_ns):
    if kind == "memory":
        return port_ns.MemoryStore()
    return port_ns.TCPStore(is_master=True, timeout=10.0)


# ------------------------------------------------------ store + registry


@pytest.mark.parametrize("kind", ["memory", "tcp"])
def test_store_surface_matches_the_reference(ns, kind):
    """The duck-type contract on both port stores, result for result
    against the JAX package's MemoryStore."""
    jax_ns, port_ns = ns

    def drive(s):
        s.set("k", "v")
        out = [s.get("k"), s.try_get("absent"), s.add("c", 2), s.add("c"),
               s.add("c", 0), s.ticket_append("lst", "a"),
               s.ticket_append("lst", b"b"), s.ticket_list("lst")]
        s.wait("k")
        s.barrier("solo")           # world_size 1: passes alone
        return out

    assert drive(_store(kind, port_ns)) == drive(jax_ns.MemoryStore())
    slow = (port_ns.MemoryStore(timeout=0.05) if kind == "memory"
            else port_ns.TCPStore(is_master=True, timeout=0.3))
    with pytest.raises(TimeoutError):
        slow.get("never")
    with pytest.raises(TimeoutError):
        slow.wait("never", timeout=0.05)


@pytest.mark.parametrize("kind", ["memory", "tcp"])
def test_store_fault_sites(ns, kind):
    """store.set/get/add/wait fire on the port's stores; the store
    recovers once the site is clear."""
    _, port_ns = ns
    s = _store(kind, port_ns)
    for site, call in (("store.set", lambda: s.set("x", "1")),
                       ("store.add", lambda: s.add("n")),
                       ("store.get", lambda: s.get("x")),
                       ("store.wait", lambda: s.wait("x"))):
        s.set("x", "1")
        with port_ns.faults.injected(site, exc=ValueError):
            with pytest.raises(ValueError):
                call()
        call()


def test_tcpstore_connect_retries_under_policy(ns):
    """store.connect retries under the store's policy: a transient fault
    is absorbed (counted), a persistent one is a TimeoutError."""
    _, port_ns = ns
    master = port_ns.TCPStore(is_master=True, timeout=5.0)
    master.set("k", "v")
    policy = port_ns.retry.RetryPolicy(max_attempts=3, base_delay_s=0.0,
                                       jitter=0.0, name="t.connect")
    with port_ns.faults.injected("store.connect", nth=1):
        client = port_ns.TCPStore(port=master.port, timeout=5.0,
                                  retry_policy=policy)
    assert client.get("k") == b"v"
    assert port_ns.retry.retry_counters()["t.connect"]["retries"] == 1
    with port_ns.faults.injected("store.connect"):
        with pytest.raises(TimeoutError):
            port_ns.TCPStore(port=master.port, timeout=5.0,
                             retry_policy=policy)


@pytest.mark.parametrize("kind", ["memory", "tcp"])
def test_registry_lease_liveness_and_retirement(ns, kind):
    _, port_ns = ns
    reg = port_ns.FleetRegistry(store=_store(kind, port_ns),
                                job_id="liveness", lease_ttl=0.15)
    reg.register("a")
    reg.register("b")
    reg.register("a")           # duplicate registration dedupes at read
    assert reg.replicas() == ["a", "b"]
    reg.beat("a", {"queue_depth": 1, "digest": ["x"]})
    reg.beat("b", {"queue_depth": 0})
    assert sorted(reg.alive()) == ["a", "b"]
    lease = reg.lease("a")
    assert lease["queue_depth"] == 1 and lease["digest"] == ["x"]
    assert lease["gen"] == reg.generation
    time.sleep(0.2)             # b stops beating and drops out
    reg.beat("a", {"queue_depth": 1})
    assert reg.alive() == ["a"]
    reg.beat("b", {"queue_depth": 0})
    reg.retire("b")             # retirement excludes even a fresh lease
    assert reg.alive() == ["a"]
    st = reg.state()
    assert st["b"]["retired"] and st["b"]["fresh"]
    assert not st["a"]["retired"]


@pytest.mark.parametrize("kind", ["memory", "tcp"])
def test_registry_generation_scoping(ns, kind):
    _, port_ns = ns
    store = _store(kind, port_ns)
    reg1 = port_ns.FleetRegistry(store=store, job_id="gen")
    reg1.register("old")
    store.add("fleet/gen/gen", 1)       # the fleet restarts at generation 1
    reg2 = port_ns.FleetRegistry(store=store, job_id="gen")
    assert reg2.generation == reg1.generation + 1
    assert reg2.replicas() == []
    reg2.register("new")
    assert reg1.replicas() == ["old"]


@pytest.mark.parametrize("kind", ["memory", "tcp"])
def test_register_fault_site_fails_cleanly(ns, kind):
    _, port_ns = ns
    reg = port_ns.FleetRegistry(store=_store(kind, port_ns), job_id="fault")
    with port_ns.faults.injected("fleet.register", nth=1):
        with pytest.raises(port_ns.faults.FaultError):
            reg.register("r0")
    assert reg.replicas() == []
    reg.register("r0")
    assert reg.replicas() == ["r0"]


def test_lease_payload_keys_match_the_reference(ns):
    """One worker of each package, started: the gossiped lease carries
    the same keys (health digest, role, digest, telemetry)."""
    keys = []
    for n in ns:
        registry, workers = fleet(n, 1, ttl=2.0)
        try:
            wait(lambda: registry.lease(workers[0].name) is not None)
            lease = registry.lease(workers[0].name)
            keys.append((set(lease), set(lease["telemetry"])))
        finally:
            stop(workers)
    assert keys[0] == keys[1]


# ------------------------------------------------------------ tier queues


def _tiers(n):
    registry, workers = fleet(n, 1)
    router_mod = sys.modules[n.FleetRouter.__module__]
    clock = FrozenClock()
    saved = (router_mod.time, n.fleet_mod.time,
             [w.engine._clock for w in workers])
    router_mod.time = n.fleet_mod.time = clock
    for w in workers:
        w.engine._clock = clock.monotonic
    try:
        router = n.FleetRouter(workers, registry, max_queue=2)
        tiers = [router.tier_for(x) for x in (10.0, 100.0, 1000.0, None)]
        p = np.arange(4, dtype=np.int32)
        r_batch = router.submit(p, 4)
        r_std = router.submit(p, 4, deadline_s=100.0)
        r_int = router.submit(p, 4, deadline_s=10.0)
        early = [router.request(r).status for r in (r_batch, r_int)]
        r_b2 = router.submit(p, 4)
        early.append(router.request(r_b2).status)
        rids = (r_batch, r_std, r_int, r_b2)
        wait(lambda: all(router.request(r).done for r in rids), timeout=60,
             router=router)
        done = router.join(timeout=0.0)
        return dict(tiers=tiers, early=early,
                    status={r: done[r].status for r in done},
                    tokens={r: done[r].output_ids for r in done
                            if done[r].status == "ok"},
                    stats=pick(router.stats))
    finally:
        stop(workers)
        router_mod.time, n.fleet_mod.time = saved[:2]
        for w, c in zip(workers, saved[2]):
            w.engine._clock = c


def test_deadline_tiers_and_shedding(ns):
    """Tiers follow fleet_tier_edges; under fleet-wide backpressure the
    lowest-priority tier sheds first ("shed", per-tier counters). The
    edges are 20 s and 300 s here (the reference's are 2 s and 30 s, with
    a 1 s deadline that a loaded host can blow), on both packages. The
    router, the fleet and the engines read a ``FrozenClock``: a request's
    deadline budget stays what its submission gave it, so a loaded host
    cannot time out the 10 s request (the JAX fleet's did once under the
    full suite's load); the drill waits for the requests on the wall
    clock (60 s, as its join did)."""
    from paddle_tpu.framework import flags as jflags

    from paddle_tpu_torch.framework import flags as tflags

    old = (jflags.get_flag("fleet_tier_edges"),
           tflags.get_flag("fleet_tier_edges"))
    jflags.set_flags({"fleet_tier_edges": "20.0,300.0"})
    tflags.set_flags({"fleet_tier_edges": "20.0,300.0"})
    try:
        jr, tr = both(*ns, _tiers)
    finally:
        jflags.set_flags({"fleet_tier_edges": old[0]})
        tflags.set_flags({"fleet_tier_edges": old[1]})
    assert tr["tiers"] == [0, 1, 2, 2]
    assert tr["early"] == ["shed", "queued", "shed"]
    assert tr["stats"]["shed_by_tier"] == {0: 0, 1: 0, 2: 2}
    for k in ("tiers", "early", "status", "stats"):
        assert tr[k] == jr[k], k
    for r, ids in tr["tokens"].items():
        assert ids == solo(ns[0], np.arange(4, dtype=np.int32), 4)


# ----------------------------------------------------- serving + parity


@pytest.mark.parametrize("stack", ["fp", "int8"])
def test_fleet_serves_token_identical_to_solo(ns, stack):
    """3 replicas, mixed workload, no faults: every request ok, tokens
    equal to the JAX solo rollout, the health surface carries the fleet,
    every lease retires."""
    ps = prompts(3, 7)

    def drill(n):
        registry, workers = fleet(n, 3, **n.stack_kw(stack))
        try:
            router = n.FleetRouter(workers, registry)
            rids = [router.submit(p, 10) for p in ps]
            done = router.join(timeout=120)
            fleets = [f for f in n.health.health_snapshot()["fleet"]
                      if f.get("job") == registry.job_id
                      and f.get("generation") == registry.generation]
            out = dict(ids=[done[r].output_ids for r in rids],
                       status=[done[r].status for r in rids],
                       stats=pick(router.stats),
                       replicas=fleets[0]["replica_count"] if fleets
                       else None)
        finally:
            stop(workers)
        out["retired"] = all(registry.retired(w.name) for w in workers)
        return out

    jr, tr = both(*ns, drill)
    for p, ids in zip(ps, tr["ids"]):
        assert ids == solo(ns[0], p, 10, stack)
    assert tr["status"] == jr["status"] == ["ok"] * len(ps)
    assert tr["stats"] == jr["stats"]
    assert tr["replicas"] == 3 and tr["retired"]


def test_prefix_affinity_beats_least_loaded(ns):
    """On a staggered shared-prefix workload the affinity router's
    fleet-wide prefix hit rate beats least-loaded, and routing never
    changes tokens. Every tick stalls 20 ms, so the seeds (whose radix
    trees the followers hit) are still decoding when the followers land."""
    rng = np.random.default_rng(7)
    pres = [rng.integers(0, 128, size=2 * PAGE).astype(np.int32)
            for _ in range(2)]
    followers = [[np.concatenate([pres[g], rng.integers(0, 128, size=3)
                                  .astype(np.int32)]) for _ in range(4)]
                 for g in range(2)]

    def run(n, affinity):
        registry, workers = fleet(n, 2, ttl=2.0, hb=0.02, start=False)
        for w in workers:
            w.stall_s = 0.02
            w.start()
        try:
            router = n.FleetRouter(workers, registry, affinity=affinity)
            s_rids = [router.submit(s, 24) for s in pres]
            wait(lambda: len(router._state) == 2 and all(
                (st.get("lease") or {}).get("digest")
                for st in router._state.values()), router=router)
            f_rids = [(g, i, router.submit(followers[g][i], 6))
                      for g in range(2) for i in range(4)]
            done = router.join(timeout=120)
            toks = {(g, i): done[r].output_ids for g, i, r in f_rids}
            toks.update({("seed", g): done[r].output_ids
                         for g, r in enumerate(s_rids)})
            return dict(hr=router.prefix_hit_rate(), toks=toks,
                        status=sorted(r.status for r in done.values()),
                        affinity_routed=router.stats["affinity_routed"])
        finally:
            stop(workers)

    def drill(n):
        return run(n, True), run(n, False)

    (j_on, j_off), (t_on, t_off) = both(*ns, drill)
    for res in (t_on, t_off):
        assert res["status"] == ["ok"] * 10
        for (g, i), ids in res["toks"].items():
            p = pres[i] if g == "seed" else followers[g][i]
            assert ids == solo(ns[0], p, 24 if g == "seed" else 6)
    assert t_on["affinity_routed"] > 0 and t_off["affinity_routed"] == 0
    assert t_on["hr"] > t_off["hr"], (t_on["hr"], t_off["hr"])
    assert j_on["status"] == t_on["status"]
    assert j_off["status"] == t_off["status"]


def test_adapter_affinity_prefers_resident_replica(ns):
    """Each replica gossips adapters_resident; an adapter'd follower is
    steered to a replica already holding its adapter (one load per tenant
    fleet-wide), and its tokens equal a solo lora engine's."""
    from paddle_tpu.models.lora import make_lora_adapter as jax_adapter

    from paddle_tpu_torch.models.lora import make_lora_adapter

    jax_ns, port_ns = ns
    lora_kw = dict(lora=True, lora_max_rank=2, lora_hbm_adapters=2)
    rng = np.random.default_rng(9)
    ps = {aid: rng.integers(0, 128, size=7 + i).astype(np.int32)
          for i, aid in enumerate(("tA", "tB"))}
    base_p = rng.integers(0, 128, size=6).astype(np.int32)

    def drill(n):
        mk = jax_adapter if n.name == "jax" else make_lora_adapter
        adapters = {"tA": mk(n.model.config, rank=2, seed=50),
                    "tB": mk(n.model.config, rank=2, seed=51)}

        def solo_lora(prompt, aid, max_new):
            eng = n.Batcher(n.model, max_batch=2, max_seq=CAP,
                            page_size=PAGE, segment=2, **lora_kw)
            for a, w in adapters.items():
                eng.register_adapter(a, w)
            rid = eng.submit(prompt, max_new, adapter_id=aid)
            return eng.run()[rid].tokens

        solo_lora(ps["tA"], "tA", 6)        # the engine's first use
        registry, workers = fleet(n, 2, ttl=2.0, hb=0.02, start=False,
                                  **lora_kw)
        for w in workers:
            for aid, ws in adapters.items():
                w.engine.register_adapter(aid, ws)
            w.start()
        try:
            router = n.FleetRouter(workers, registry)
            seeds = [router.submit(ps["tA"], 4, adapter_id="tA"),
                     router.submit(ps["tB"], 4, adapter_id="tB")]
            wait(lambda: all(router._reqs[r].done for r in seeds),
                 router=router)
            wait(lambda: len(router._state) == 2 and sorted(
                a for st in router._state.values()
                for a in (st.get("lease") or {}).get(
                    "adapters_resident", ())) == ["tA", "tB"],
                router=router)
            f_rids = [(aid, router.submit(ps[aid], 6, adapter_id=aid))
                      for aid in ("tA", "tB") for _ in range(3)]
            b_rid = router.submit(base_p, 6)
            done = router.join(timeout=120)
            stalls = sum(w.engine.stats["adapter_swap_stalls"]
                         for w in workers)
            return dict(
                status=sorted(r.status for r in done.values()),
                adapter_routed=router.stats["adapter_routed"],
                stalls=stalls,
                follow_ok=all(done[r].tokens == solo_lora(ps[a], a, 6)
                              for a, r in f_rids),
                base=done[b_rid].output_ids)
        finally:
            stop(workers)

    jr, tr = both(*ns, drill)
    assert tr["status"] == ["ok"] * 9 == jr["status"]
    assert tr["adapter_routed"] >= 6 and jr["adapter_routed"] >= 6
    assert tr["stalls"] == jr["stalls"] == 2
    assert tr["follow_ok"]
    assert tr["base"] == solo(jax_ns, base_p, 6)


# ------------------------------------------------------------ chaos drills


def _victim_once_streamed(router, rid, n_tokens):
    wait(lambda: router.request(rid).status == "dispatched"
         and len(router.request(rid)._journal) >= n_tokens, router=router)
    return router.request(rid).replica


@pytest.mark.chaos
def test_sigkill_mid_stream_failover_token_identical(ns):
    """3 replicas, one SIGKILLed once a request has streamed >= 3 tokens:
    every request completes on a survivor with the JAX solo tokens
    (journal prefix + greedy re-prefill), one failover, the dead
    replica's lease stale, the survivors' allocators bijective."""
    ps = prompts(11, 6, lo=6, hi=7)
    NEW = 24

    def drill(n):
        registry, workers = fleet(n, 3, ttl=1.0)
        try:
            router = n.FleetRouter(workers, registry)
            rids = [router.submit(p, NEW) for p in ps]
            victim = _victim_once_streamed(router, rids[0], 3)
            router.workers[victim].kill()
            done = router.join(timeout=120)
            wait(lambda: victim not in registry.alive())
            fh = router.fleet_health()
            check_allocators(workers, skip=(victim,))
            return dict(ids=[done[r].output_ids for r in rids],
                        status=[done[r].status for r in rids],
                        stats=pick(router.stats), dead=fh["dead"],
                        alive=len(fh["alive"]), victim=victim,
                        outstanding=fh["outstanding"],
                        retired=registry.retired(victim))
        finally:
            stop(workers)

    jr, tr = both(*ns, drill)
    for p, ids in zip(ps, tr["ids"]):
        assert ids == solo(ns[0], p, NEW)
    assert tr["status"] == ["ok"] * len(ps) == jr["status"]
    assert tr["stats"]["failovers"] == 1
    assert tr["stats"]["requests_recovered"] >= 1
    assert tr["stats"] == jr["stats"]
    assert tr["dead"] == [tr["victim"]] and tr["alive"] == 2
    assert tr["outstanding"] == 0 and not tr["retired"]


@pytest.mark.chaos
def test_replica_lost_when_deadline_cannot_survive_reprefill(ns):
    """A request whose deadline cannot pay the re-prefill fails alone with
    "replica_lost" (its streamed prefix still exact); its deadline-free
    neighbor recovers with the JAX solo tokens."""
    rng = np.random.default_rng(13)
    p_dead = rng.integers(0, 128, size=6).astype(np.int32)
    p_free = rng.integers(0, 128, size=6).astype(np.int32)
    NEW = 24

    def drill(n):
        registry, workers = fleet(n, 2, ttl=1.0)
        try:
            router = n.FleetRouter(workers, registry,
                                   reprefill_headroom_s=1e9)
            r_dead = router.submit(p_dead, NEW, deadline_s=600.0)
            r_free = router.submit(p_free, NEW)
            victim = _victim_once_streamed(router, r_dead, 2)
            router.workers[victim].kill()
            done = router.join(timeout=120)
            return dict(dead=(done[r_dead].status, done[r_dead].tokens,
                              done[r_dead].error),
                        free=(done[r_free].status, done[r_free].tokens),
                        stats=pick(router.stats))
        finally:
            stop(workers)

    jr, tr = both(*ns, drill)
    status, prefix, err = tr["dead"]
    assert status == "replica_lost" and "lost" in (err or "")
    assert prefix == solo(ns[0], p_dead, NEW)[6:][:len(prefix)]
    assert tr["free"] == ("ok", solo(ns[0], p_free, NEW)[6:])
    assert tr["stats"]["replica_lost"] == 1
    assert tr["stats"] == jr["stats"]
    assert jr["dead"][0] == status and jr["free"][0] == "ok"


@pytest.mark.chaos
def test_sigterm_drain_retires_and_hands_back_queued(ns):
    """terminate() closes admission, finishes in-flight slots, hands
    queued requests back, writes the retirement marker, and is not a
    failover."""
    ps = prompts(17, 6, lo=6, hi=7)

    def drill(n):
        registry, workers = fleet(n, 2)
        try:
            router = n.FleetRouter(workers, registry)
            rids = [router.submit(p, 16) for p in ps]
            victim = _victim_once_streamed(router, rids[0], 1)
            router.workers[victim].terminate()
            done = router.join(timeout=120)
            wait(lambda: registry.retired(victim))
            lease = registry.lease(victim)
            return dict(ids=[done[r].output_ids for r in rids],
                        status=[done[r].status for r in rids],
                        failovers=router.stats["failovers"],
                        draining=bool(lease and lease["draining"]))
        finally:
            stop(workers)

    jr, tr = both(*ns, drill)
    for p, ids in zip(ps, tr["ids"]):
        assert ids == solo(ns[0], p, 16)
    assert tr["status"] == jr["status"] == ["ok"] * len(ps)
    assert tr["failovers"] == jr["failovers"] == 0
    assert tr["draining"] and jr["draining"]


@pytest.mark.chaos
def test_router_dispatch_fault_retried_then_fails_alone(ns):
    """router.dispatch: a transient fault is absorbed by the bounded retry
    (counted); a persistent one fails only the affected request."""
    p = np.arange(5, dtype=np.int32)

    def drill(n):
        registry, workers = fleet(n, 1)
        try:
            router = n.FleetRouter(workers, registry)
            before = n.retry.retry_counters().get(
                "fleet.router", {}).get("retries", 0)
            with n.faults.injected("router.dispatch", nth=1):
                rid = router.submit(p, 6)
                first = router.join(timeout=60)[rid].status
            retried = n.retry.retry_counters()["fleet.router"][
                "retries"] - before
            ok_rid = router.submit(p, 6)
            router.join(timeout=60)
            nxt = router._next_rid
            with n.faults.injected("router.dispatch",
                                   when=lambda ctx: ctx["rid"] == nxt):
                bad = router.submit(p, 6)
                good = router.submit(np.arange(6, dtype=np.int32), 6)
                done = router.join(timeout=60)
            return dict(first=first, retried=retried, bad=bad == nxt,
                        status=[done[r].status for r in (bad, good, ok_rid)],
                        ids=done[good].output_ids)
        finally:
            stop(workers)

    jr, tr = both(*ns, drill)
    assert tr["first"] == "ok" and tr["retried"] >= 1 and tr["bad"]
    assert tr["status"] == ["error", "ok", "ok"] == jr["status"]
    assert tr["ids"] == solo(ns[0], np.arange(6, dtype=np.int32), 6)


def test_oversized_request_fails_alone_not_the_replica(ns):
    """A request the engine refuses at submit is a per-request "error";
    the serve thread, the lease and every other request are untouched."""
    def drill(n):
        registry, workers = fleet(n, 1)
        try:
            router = n.FleetRouter(workers, registry)
            big = router.submit(np.arange(CAP, dtype=np.int32), 32)
            ok = router.submit(np.arange(5, dtype=np.int32), 4)
            done = router.join(timeout=60)
            return dict(status=[done[big].status, done[ok].status],
                        capacity="capacity" in (done[big].error or ""),
                        alive=workers[0].alive(),
                        failovers=router.stats["failovers"])
        finally:
            stop(workers)

    jr, tr = both(*ns, drill)
    assert tr == jr
    assert tr["status"] == ["error", "ok"] and tr["capacity"]
    assert tr["alive"] and tr["failovers"] == 0


@pytest.mark.chaos
def test_heartbeat_fault_degrades_to_counters(ns):
    """A heartbeat failure lands in retry_counters["fleet.heartbeat"] and
    the lease recovers within the TTL."""
    _, port_ns = ns
    registry, workers = fleet(port_ns, 1, ttl=1.0, hb=0.03)
    try:
        before = port_ns.retry.retry_counters().get(
            "fleet.heartbeat", {}).get("failures", 0)
        with port_ns.faults.injected("fleet.heartbeat", nth=1):
            wait(lambda: port_ns.retry.retry_counters().get(
                "fleet.heartbeat", {}).get("failures", 0) > before)
        wait(lambda: registry.alive() == [workers[0].name])
    finally:
        stop(workers)


@pytest.mark.chaos
def test_failover_fault_fails_only_affected_request(ns):
    """router.failover: a fault during recovery fails exactly the request
    being recovered; the other request still completes exact."""
    ps = prompts(19, 2, lo=6, hi=7)

    def drill(n):
        registry, workers = fleet(n, 2, ttl=1.0)
        try:
            router = n.FleetRouter(workers, registry)
            rids = [router.submit(p, 40) for p in ps]
            victim = _victim_once_streamed(router, rids[0], 2)
            with n.faults.injected("router.failover",
                                   when=lambda ctx: ctx["rid"] == rids[0]):
                router.workers[victim].kill()
                done = router.join(timeout=120)
            return dict(status=[done[r].status for r in rids],
                        ids=done[rids[1]].output_ids)
        finally:
            stop(workers)

    jr, tr = both(*ns, drill)
    assert tr["status"] == ["error", "ok"] == jr["status"]
    assert tr["ids"] == solo(ns[0], ps[1], 40)
