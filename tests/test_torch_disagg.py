"""Disaggregated prefill/decode serving with live KV migration: the port
against the JAX package, on the CPU.

Restates ``tests/test_disagg.py`` as port against reference. The
migration unit: a parked stream exported by the port's engine has the
JAX engine's blob structure (spec, arena class, seq_len, request record,
``(layers, kv_heads, page, head_dim)`` blocks and their dtype names) and
its page values (within 1e-5 on f32 pages; int8 codes within one step,
scales within 1e-5), the chunked wire round trip is byte-identical, and
the stream resumes on a second engine with one admitted token and the JAX
solo tokens. The fleet drills (parity, the kv.migrate and router.handoff
faults, SIGKILL on either side, the free drain) run on both packages'
fleets: the port's tokens equal the JAX solo rollout (int8 migrations:
the JAX fleet's tokens, see the parity test), its statuses and
non-timing stats equal the JAX fleet's. A blob the destination cannot
import hands its request back (the JAX package's worker dies there:
ROADMAP.md, Queue 3).

The reference's ``test_disagg_fleet_token_parity_vs_monolithic[fp]``
races the router against the prefill specialist (a stream that finishes
before its park applies never migrates); its port here stalls the
specialist's ticks by 30 ms (``stall_s``), so every stream is still
decoding when its migration starts, whatever the host's load, and holds
the leases at a 2 s TTL where no replica is killed.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

from torch_fleet_pairs import (ENGINE_KW, both, check_allocators,
                               clear_faults, make_namespaces, pick, solo,
                               stop, wait)
from torch_fleet_pairs import warm as warm_jax

TIERED = dict(ENGINE_KW, host_tier=True)
STALL = 0.03


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


def _fleet(n, roles, ttl=2.0, hb=0.05, stall=STALL, **kw):
    registry, workers = n.make_fleet(
        n.model, len(roles), heartbeat_interval=hb, lease_ttl=ttl,
        roles=roles, **dict(TIERED, **kw))
    for w in workers:
        if w.role == "prefill":
            w.stall_s = stall
        w.start()
    return registry, workers


def _parked_blob(n, stack, p, new):
    """Park a mid-generation stream at the first boundary and export it."""
    a = n.Batcher(n.model, **TIERED, **n.stack_kw(stack))
    rid = a.submit(p, new)
    fired = {"done": False}

    def hook(t):
        if not fired["done"]:
            a.park(rid)
            fired["done"] = True

    a._on_tick = hook
    a.run()
    assert a.parked == [rid]
    return a, rid, a.export_parked(rid)


# --------------------------------------------- engine-level wire round trip


@pytest.mark.parametrize("stack", ["fp", "int8"])
def test_park_export_wire_import_resume_exact(ns, stack):
    """Park on engine A, export, chunked wire (raw bytes), import into a
    fresh engine B, resume: the JAX solo tokens with ONE admitted token;
    the wire is byte-exact; the blob matches the JAX engine's export of
    the same park."""
    jax_ns, port_ns = ns
    rng = np.random.default_rng(31)
    p = rng.integers(0, 128, size=20).astype(np.int32)
    NEW = 12
    _, _, jblob = _parked_blob(jax_ns, stack, p, NEW)
    a, rid, blob = _parked_blob(port_ns, stack, p, NEW)

    # the reference's structure and values
    assert blob["spec"] == jblob["spec"]
    assert blob["arena_class"] == jblob["arena_class"] == "kv"
    assert blob["seq_len"] == jblob["seq_len"]
    assert blob["nbytes"] == jblob["nbytes"]
    for k in ("tokens", "max_new_tokens", "deadline_s", "adapter_id",
              "prefix_len"):
        assert blob["req"][k] == jblob["req"][k], k
    np.testing.assert_array_equal(blob["req"]["prompt"],
                                  jblob["req"]["prompt"])
    emitted = len(blob["req"]["tokens"])
    assert 1 <= emitted < NEW
    assert len(blob["pages"]) == len(jblob["pages"])
    for tb, jb in zip(blob["pages"], jblob["pages"]):
        assert sorted(tb) == sorted(jb)
        for name in jb:
            want = np.asarray(jb[name])
            got = tb[name]
            assert tuple(got.shape) == want.shape, name
            assert str(got.dtype).replace("torch.", "") == str(want.dtype)
            if got.dtype == torch.int8:
                assert np.abs(got.numpy().astype(np.int32)
                              - want.astype(np.int32)).max() <= 1, name
            else:
                np.testing.assert_allclose(got.float().numpy(),
                                           want.astype(np.float32),
                                           rtol=1e-5, atol=1e-5)

    wired = port_ns.KVMigrator(mode="chunked", chunk_pages=1).transfer(
        blob, rid=rid)
    for orig, back in zip(blob["pages"], wired["pages"]):
        assert sorted(orig) == sorted(back)
        for name in orig:
            assert orig[name].dtype == back[name].dtype
            assert torch.equal(orig[name].view(torch.uint8),
                               back[name].view(torch.uint8))
    b = port_ns.Batcher(port_ns.model, **TIERED, **port_ns.stack_kw(stack))
    rid_b = b.import_parked(wired)
    a.discard_parked(rid)
    b.resume(rid_b)
    done = b.run()
    assert done[rid_b].status == "ok"
    assert done[rid_b].output_ids == solo(jax_ns, p, NEW, stack)
    assert b.stats["resumes"] == 1
    assert b.stats["prefill_tokens_admitted"] == 1
    a._host_pager.check()
    b._host_pager.check()


def test_import_rejects_foreign_spec(ns):
    """An int8 blob must not land in an fp arena: the page-spec gate raises
    before any slot is written, and the source decodes on."""
    _, port_ns = ns
    rng = np.random.default_rng(37)
    p = rng.integers(0, 128, size=18).astype(np.int32)
    a, rid, blob = _parked_blob(port_ns, "int8", p, 8)
    b = port_ns.Batcher(port_ns.model, **TIERED)
    b._ensure_host_arena()
    free_before = b._host_pager.available()
    with pytest.raises(ValueError, match="spec mismatch"):
        b.import_parked(blob)
    with pytest.raises(ValueError, match="arena class"):
        b.import_parked(dict(blob, arena_class="adapter"))
    assert b._host_pager.available() == free_before
    a.resume(rid)
    done = a.run()
    assert done[rid].status == "ok"


@pytest.mark.chaos
def test_import_failure_hands_the_request_back(ns, monkeypatch):
    """A delivered blob the destination cannot import (an int8 blob at an
    fp replica) hands its request back to the router untouched, and the
    destination serves on. The JAX package's worker counts the failure
    under a key its ``bump_counter`` refuses ("import_failures"), so its
    serve loop dies instead (ROADMAP.md, Queue 3)."""
    rng = np.random.default_rng(67)
    p = rng.integers(0, 128, size=18).astype(np.int32)
    died = []
    monkeypatch.setattr(threading, "excepthook",
                        lambda args: died.append(args.exc_type))
    out = {}
    for n in ns:
        _, _, blob = _parked_blob(n, "int8", p, 8)
        registry, workers = _fleet(n, ["decode"])
        w = workers[0]
        try:
            fr = n.FleetRequest(0, p, 8, None, 2, time.monotonic())
            assert w.deliver_migration(fr, blob)
            back = []
            wait(lambda: back.extend(w.drain_returns()) or back
                 or not w.alive())
            out[n.name] = (back == [fr], w.alive())
        finally:
            stop(workers)
    assert out["port"] == (True, True)
    assert out["jax"] == (False, False) and ValueError in died


# -------------------------------------------------- fleet parity (fp, int8)


@pytest.mark.parametrize("stack", ["fp", "int8"])
@pytest.mark.parametrize("transport", ["handoff", "chunked"])
def test_disagg_fleet_token_parity_vs_monolithic(ns, stack, transport):
    """Every request admitted to the prefill specialist migrates live to
    the decode specialist and completes with the JAX solo tokens; the
    decode tier admits one token per resume and nothing else."""
    rng = np.random.default_rng(41)
    ps = [rng.integers(0, 128, size=int(k)).astype(np.int32)
          for k in rng.integers(4, 12, size=4)]

    def drill(n):
        registry, workers = _fleet(n, ["prefill", "decode"],
                                   **n.stack_kw(stack))
        try:
            router = n.FleetRouter(workers, registry, disagg=True,
                                   migrator=n.KVMigrator(transport))
            rids = [router.submit(p, 16) for p in ps]
            done = router.join(timeout=120)
            pre, dec = workers
            check_allocators(workers)
            return dict(
                ids=[done[r].output_ids for r in rids],
                status=[done[r].status for r in rids],
                migrated=[done[r].migrated for r in rids],
                stats=pick(router.stats),
                out=pre.mig_stats["migrations_out"],
                into=dec.mig_stats["migrations_in"],
                rec=dec.mig_stats["resumes_recovered"],
                nbytes=dec.mig_stats["bytes_migrated"],
                resumes=dec.engine.stats["resumes"],
                admitted=dec.engine.stats["prefill_tokens_admitted"])
        finally:
            stop(workers)

    jr, tr = both(*ns, drill)
    if stack == "fp":
        for p, ids in zip(ps, tr["ids"]):
            assert ids == solo(ns[0], p, 16)
    else:
        # on an int8 cache the resumed token is recomputed as a prefill row
        # (its own K/V read fresh, where decode reads them back quantized),
        # so a migrated stream may leave the solo rollout, in the JAX fleet
        # as in the port's (ROADMAP.md, Queue 3): the port's tokens are the
        # JAX fleet's, request for request
        assert tr["ids"] == jr["ids"]
    assert tr["status"] == ["ok"] * 4 and tr["migrated"] == [1] * 4
    assert tr["stats"]["migrations"] == 4
    assert tr["stats"]["migrations_failed"] == 0
    assert tr["out"] == tr["into"] == tr["rec"] == tr["resumes"] == 4
    assert tr["admitted"] == tr["resumes"] and tr["nbytes"] > 0
    for k in ("status", "migrated", "stats", "out", "into", "rec",
              "resumes", "admitted", "nbytes"):
        assert tr[k] == jr[k], k


def test_roles_gossiped_on_lease_and_health(ns):
    def drill(n):
        registry, workers = _fleet(n, ["prefill", "decode"])
        try:
            router = n.FleetRouter(workers, registry, disagg=True)
            wait(lambda: len(router._state) == 2 and all(
                (st.get("lease") or {}).get("role")
                for st in router._state.values()), router=router)
            fh = router.fleet_health()
            return dict(roles=[registry.lease(f"replica{i}")["role"]
                               for i in range(2)],
                        disagg=fh["disagg"],
                        lease_roles={r["role"]
                                     for r in fh["leases"].values()},
                        mig=(fh["migrations"], fh["migrations_failed"]),
                        keys=set(fh), gray=set(fh["gray"]))
        finally:
            stop(workers)

    jr, tr = both(*ns, drill)
    assert tr == jr
    assert tr["roles"] == ["prefill", "decode"] and tr["disagg"] is True
    assert tr["mig"] == (0, 0)


def test_disagg_ctor_legality(ns):
    """Explicit disagg=True on an illegal fleet raises; the flag-driven
    default activates only where legal."""
    _, port_ns = ns
    registry, workers = _fleet(port_ns, ["both", "both"])
    try:
        with pytest.raises(ValueError, match="prefill specialist"):
            port_ns.FleetRouter(workers, registry, disagg=True)
        assert port_ns.FleetRouter(workers, registry)._disagg is False
    finally:
        stop(workers)
    registry2, workers2 = _fleet(port_ns, ["prefill", "decode"],
                                 host_tier=False)
    try:
        with pytest.raises(ValueError, match="host_tier"):
            port_ns.FleetRouter(workers2, registry2, disagg=True)
    finally:
        stop(workers2)
    with pytest.raises(ValueError, match="roles must name every"):
        port_ns.make_fleet(port_ns.model, 2, roles=["prefill"], **TIERED)
    with pytest.raises(ValueError, match="role must be"):
        port_ns.make_fleet(port_ns.model, 1, roles=["bogus"], **TIERED)


# ------------------------------------------------------------ chaos drills


@pytest.mark.chaos
def test_kv_migrate_fault_decodes_on_at_source(ns):
    """Transport loss at kv.migrate fails ONLY that request's migration:
    it decodes on at the source, exact, and the seam recovers."""
    rng = np.random.default_rng(43)
    p = rng.integers(0, 128, size=8).astype(np.int32)
    p2 = rng.integers(0, 128, size=8).astype(np.int32)

    def drill(n):
        registry, workers = _fleet(n, ["prefill", "decode"])
        try:
            router = n.FleetRouter(workers, registry, disagg=True)
            with n.faults.injected("kv.migrate", nth=1):
                rid = router.submit(p, 16)
                done = router.join(timeout=120)
            first = dict(ids=done[rid].output_ids,
                         status=done[rid].status,
                         migrated=done[rid].migrated,
                         replica=done[rid].replica,
                         stats=pick(router.stats),
                         out=workers[0].mig_stats["migrations_out"],
                         faults=router._migrator.stats["transfer_faults"])
            rid2 = router.submit(p2, 16)
            done = router.join(timeout=120)
            check_allocators(workers)
            return dict(first, ids2=done[rid2].output_ids,
                        migrated2=done[rid2].migrated)
        finally:
            stop(workers)

    jr, tr = both(*ns, drill)
    assert tr["ids"] == solo(ns[0], p, 16)
    assert tr["ids2"] == solo(ns[0], p2, 16)
    assert (tr["status"], tr["migrated"], tr["replica"]) == (
        "ok", 0, "replica0")
    assert tr["stats"]["migrations_failed"] == 1
    assert tr["faults"] == 1 and tr["out"] == 0 and tr["migrated2"] == 1
    for k in ("status", "migrated", "replica", "stats", "out", "faults",
              "migrated2"):
        assert tr[k] == jr[k], k


@pytest.mark.chaos
def test_router_handoff_fault_pins_only_that_request(ns):
    rng = np.random.default_rng(47)
    p0 = rng.integers(0, 128, size=8).astype(np.int32)
    p1 = rng.integers(0, 128, size=8).astype(np.int32)

    def drill(n):
        registry, workers = _fleet(n, ["prefill", "decode"])
        try:
            router = n.FleetRouter(workers, registry, disagg=True)
            with n.faults.injected("router.handoff",
                                   when=lambda ctx: ctx["rid"] == 0):
                r0 = router.submit(p0, 16)
                r1 = router.submit(p1, 16)
                done = router.join(timeout=120)
            check_allocators(workers)
            return dict(ids=[done[r0].output_ids, done[r1].output_ids],
                        where=[(done[r].migrated, done[r].replica,
                                done[r].status) for r in (r0, r1)],
                        stats=pick(router.stats))
        finally:
            stop(workers)

    jr, tr = both(*ns, drill)
    assert tr["ids"] == [solo(ns[0], p0, 16), solo(ns[0], p1, 16)]
    assert tr["where"] == [(0, "replica0", "ok"), (1, "replica1", "ok")]
    assert tr["stats"]["handoff_faults"] == 1
    assert tr["stats"]["migrations"] == 1
    assert tr["where"] == jr["where"] and tr["stats"] == jr["stats"]


@pytest.mark.chaos
def test_sigkill_prefill_mid_migration(ns):
    """SIGKILL the prefill specialist while its streams migrate: every
    request completes exact on the survivor; the survivor's refcounts
    hold."""
    rng = np.random.default_rng(53)
    ps = [rng.integers(0, 128, size=6).astype(np.int32) for _ in range(4)]
    NEW = 24

    def drill(n):
        registry, workers = _fleet(n, ["prefill", "decode"], ttl=1.0)
        try:
            router = n.FleetRouter(workers, registry, disagg=True)
            rids = [router.submit(p, NEW) for p in ps]

            def mid_migration():
                return any(fr._mig is not None or (
                    fr.status == "dispatched" and len(fr._journal) >= 1
                    and fr.replica == "replica0")
                    for fr in (router.request(r) for r in rids))

            wait(mid_migration, router=router)
            router.workers["replica0"].kill()
            done = router.join(timeout=120)
            fh = router.fleet_health()
            check_allocators(workers, skip=("replica0",))
            return dict(ids=[done[r].output_ids for r in rids],
                        status=[done[r].status for r in rids],
                        failovers=router.stats["failovers"],
                        outstanding=fh["outstanding"])
        finally:
            stop(workers)

    jr, tr = both(*ns, drill)
    for p, ids in zip(ps, tr["ids"]):
        assert ids == solo(ns[0], p, NEW)
    assert tr["status"] == ["ok"] * 4 == jr["status"]
    assert tr["failovers"] <= 1 and tr["outstanding"] == 0


@pytest.mark.chaos
def test_sigkill_decode_after_migration(ns):
    """SIGKILL the decode specialist after it adopted migrated streams:
    failover recovers every request on the prefill survivor from the
    journal spanning both replicas, exact. The decode specialist holds at
    its first scheduler boundary after it adopted a stream (``held_tick``)
    until the kill, so the drill reaches a migrated stream that is not done
    however fast the replica runs (under the full suite's load the
    stream could finish before the router's poll saw it)."""
    rng = np.random.default_rng(59)
    ps = [rng.integers(0, 128, size=6).astype(np.int32) for _ in range(3)]
    NEW = 24

    def drill(n):
        registry, workers = _fleet(n, ["prefill", "decode"], ttl=1.0)
        release, held = threading.Event(), threading.Event()
        dec = next(w for w in workers if w.name == "replica1")
        tick = dec.engine._on_tick

        def held_tick(t):
            tick(t)
            if dec._mig_rids and not release.is_set():
                held.set()
                release.wait(120)

        dec.engine._on_tick = held_tick
        try:
            router = n.FleetRouter(workers, registry, disagg=True)
            rids = [router.submit(p, NEW) for p in ps]
            wait(held.is_set, router=router)
            wait(lambda: any(router.request(r).migrated >= 1
                             and not router.request(r).done for r in rids),
                 router=router)
            router.workers["replica1"].kill()
            release.set()
            done = router.join(timeout=120)
            check_allocators(workers, skip=("replica1",))
            return dict(ids=[done[r].output_ids for r in rids],
                        status=[done[r].status for r in rids],
                        failovers=router.stats["failovers"],
                        recovered=router.stats["requests_recovered"])
        finally:
            release.set()
            stop(workers)

    jr, tr = both(*ns, drill)
    for p, ids in zip(ps, tr["ids"]):
        assert ids == solo(ns[0], p, NEW)
    assert tr["status"] == ["ok"] * 3 == jr["status"]
    assert tr["failovers"] == jr["failovers"] == 1
    assert tr["recovered"] >= 1 and jr["recovered"] >= 1


@pytest.mark.chaos
def test_drain_prefill_is_free(ns):
    """Draining the prefill specialist completes its in-flight
    migrations: no failover, no re-dispatch, the decode tier admits only
    resume tokens, the source retires."""
    rng = np.random.default_rng(61)
    ps = [rng.integers(0, 128, size=6).astype(np.int32) for _ in range(3)]
    NEW = 24

    def drill(n):
        registry, workers = _fleet(n, ["prefill", "decode"])
        try:
            router = n.FleetRouter(workers, registry, disagg=True)
            rids = [router.submit(p, NEW) for p in ps]
            wait(lambda: all(len(router.request(r)._journal) >= 1
                             or router.request(r).migrated >= 1
                             for r in rids), router=router)
            router.workers["replica0"].terminate()
            done = router.join(timeout=120)
            dec = next(w for w in workers if w.name == "replica1")
            wait(lambda: registry.retired("replica0"))
            check_allocators(workers, skip=("replica0",))
            return dict(ids=[done[r].output_ids for r in rids],
                        status=[done[r].status for r in rids],
                        failovers=router.stats["failovers"],
                        redispatched=router.stats["redispatched"],
                        resumes=dec.engine.stats["resumes"],
                        admitted=dec.engine.stats[
                            "prefill_tokens_admitted"])
        finally:
            stop(workers)

    jr, tr = both(*ns, drill)
    for p, ids in zip(ps, tr["ids"]):
        assert ids == solo(ns[0], p, NEW)
    assert tr["status"] == ["ok"] * 3 == jr["status"]
    assert tr["failovers"] == tr["redispatched"] == 0
    assert jr["failovers"] == jr["redispatched"] == 0
    assert tr["resumes"] >= 1 and tr["admitted"] == tr["resumes"]
