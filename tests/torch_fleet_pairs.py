"""The port's serving fleet against the JAX package's, on the CPU.

Shared by ``tests/test_torch_fleet.py``, ``tests/test_torch_disagg.py``,
``tests/test_torch_gray_failure.py`` and ``tests/test_torch_reliability.py``:
the JAX package's fleet tests' tiny model (``paddle.seed(0)``, bridged
into the port, fp and int8), one namespace per package (its fleet, router,
migrator, stores and reliability modules, its model and engine settings),
and the drill helpers. A drill is a function of a namespace; a test runs it
on both packages and holds the port's tokens to the JAX package's solo
``generate_paged`` and its statuses and stats to the JAX fleet's.

Every wait has a timeout and every worker is joined in ``finally``.
"""

from __future__ import annotations

import threading
import time
from types import SimpleNamespace

import numpy as np

import paddle_tpu as paddle
from paddle_tpu.distributed import store as jstore
from paddle_tpu.inference import fleet as jfleet
from paddle_tpu.inference import migration as jmig
from paddle_tpu.inference import router as jrouter
from paddle_tpu.inference.continuous_batching import \
    ContinuousBatcher as JaxBatcher
from paddle_tpu.reliability import faults as jfaults
from paddle_tpu.reliability import health as jhealth
from paddle_tpu.reliability import retry as jretry

from paddle_tpu_torch.distributed import store as tstore
from paddle_tpu_torch.inference import ContinuousBatcher
from paddle_tpu_torch.inference import fleet as tfleet
from paddle_tpu_torch.inference import migration as tmig
from paddle_tpu_torch.inference import router as trouter
from paddle_tpu_torch.reliability import faults as tfaults
from paddle_tpu_torch.reliability import health as thealth
from paddle_tpu_torch.reliability import retry as tretry

from torch_batcher_pairs import build_pair, int8_params

PAGE = 16
CAP = 64
#: the JAX package's fleet-test engine settings
ENGINE_KW = dict(max_batch=2, max_seq=CAP, page_size=PAGE, segment=2)


def clear_faults():
    jfaults.clear()
    tfaults.clear()


def make_namespaces():
    """(JAX namespace, port namespace) over the same weights, fp and int8
    (``ns.stack_kw(stack)`` gives a stack's engine kwargs)."""
    jmodel, tmodel = build_pair()
    jq, tq = int8_params(jmodel, tmodel)
    common = dict(PAGE=PAGE, CAP=CAP)
    jax_ns = SimpleNamespace(
        name="jax", model=jmodel, Batcher=JaxBatcher,
        make_fleet=jfleet.make_fleet, FleetRegistry=jfleet.FleetRegistry,
        FleetWorker=jfleet.FleetWorker, FleetRouter=jrouter.FleetRouter,
        FleetRequest=jrouter.FleetRequest,
        KVMigrator=jmig.KVMigrator, MemoryStore=jstore.MemoryStore,
        faults=jfaults, retry=jretry, health=jhealth, fleet_mod=jfleet,
        stack_kw=lambda s: ({} if s == "fp" else
                            dict(quantized_params=jq, cache_dtype="int8")),
        **common)
    port_ns = SimpleNamespace(
        name="port", model=tmodel, Batcher=ContinuousBatcher,
        make_fleet=tfleet.make_fleet, FleetRegistry=tfleet.FleetRegistry,
        FleetWorker=tfleet.FleetWorker, FleetRouter=trouter.FleetRouter,
        FleetRequest=trouter.FleetRequest,
        KVMigrator=tmig.KVMigrator, MemoryStore=tstore.MemoryStore,
        TCPStore=tstore.TCPStore, faults=tfaults, retry=tretry,
        health=thealth, fleet_mod=tfleet,
        stack_kw=lambda s: ({} if s == "fp" else
                            dict(quantized_params=tq, cache_dtype="int8")),
        **common)
    jax_ns.jq = port_ns.jq = jq
    return jax_ns, port_ns


_SOLO: dict = {}


def solo(jax_ns, prompt, max_new, stack="fp"):
    """The JAX package's solo greedy ``generate_paged`` rollout (prompt +
    generated ids), the token oracle of every fleet test."""
    key = (np.asarray(prompt, np.int32).tobytes(), int(max_new), stack)
    if key not in _SOLO:
        kw = ({} if stack == "fp"
              else dict(params=jax_ns.jq, cache_dtype="int8"))
        out = jax_ns.model.generate_paged(
            paddle.to_tensor(np.asarray(prompt, np.int32)[None]),
            max_new_tokens=int(max_new), **kw)
        _SOLO[key] = list(map(int, np.asarray(out._array)[0]))
    return list(_SOLO[key])


def warm(jax_ns):
    """Pay the JAX engine's compiles before a timing-sensitive drill (the
    port has none to pay)."""
    for stack in ("fp", "int8"):
        for host_tier in (False, True):
            eng = JaxBatcher(jax_ns.model, host_tier=host_tier,
                             **ENGINE_KW, **jax_ns.stack_kw(stack))
            eng.submit(np.arange(6, dtype=np.int32), 4)
            eng.run()
            solo(jax_ns, np.arange(6, dtype=np.int32), 4, stack)


def fleet(ns, n, ttl=2.0, hb=0.05, roles=None, start=True, **kw):
    """A started fleet of ``n`` replicas of ``ns`` at the module shape.
    The lease TTL is 2 s unless a drill kills a replica (1 s there): a
    loaded test host must not starve a heartbeat into a spurious
    failover."""
    registry, workers = ns.make_fleet(
        ns.model, n, heartbeat_interval=hb, lease_ttl=ttl, roles=roles,
        **dict(ENGINE_KW, **kw))
    if start:
        for w in workers:
            w.start()
    return registry, workers


def stop(workers, timeout=5.0):
    for w in workers:
        if w.alive():
            w.terminate()
    for w in workers:
        w.join(timeout)


def wait(cond, timeout=120.0, interval=0.002, router=None):
    """Poll ``cond`` (optionally pumping a router) until true; fail loudly
    on timeout."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if router is not None:
            router.poll()
        if cond():
            return
        time.sleep(interval)
    raise AssertionError(f"condition not reached within {timeout}s")


def wait_fresh(router, workers):
    """All leases fresh before submitting: dispatch spreads least-loaded
    over the full fleet instead of whoever beat first."""
    wait(lambda: all((router._state.get(w.name) or {}).get("fresh")
                     for w in workers), router=router)


def check_allocators(workers, skip=()):
    """Refcount bijection on every surviving replica's allocators."""
    for w in workers:
        if w.name in skip:
            continue
        if w.engine._prefix is not None:
            w.engine._prefix.allocator.check()
        if getattr(w.engine, "_host_pager", None) is not None:
            w.engine._host_pager.check()


def prompts(seed, n, lo=4, hi=12, vocab=128):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(k)).astype(np.int32)
            for k in rng.integers(lo, hi, size=n)]


#: router stats that do not depend on timing in the drills that compare
#: them
STATS = ("submitted", "failovers", "requests_recovered", "replica_lost",
         "migrations", "migrations_failed", "handoff_faults",
         "shed_by_tier")


def pick(stats, keys=STATS):
    return {k: stats[k] for k in keys}


def both(jax_ns, port_ns, drill, *args, **kw):
    """Run ``drill(ns, ...)`` on the JAX package and on the port, each
    with a clean fault registry. Returns (JAX result, port result)."""
    out = []
    for ns in (jax_ns, port_ns):
        clear_faults()
        try:
            out.append(drill(ns, *args, **kw))
        finally:
            clear_faults()
    return tuple(out)


class FrozenClock:
    """A ``time`` whose ``monotonic()`` stands still at its creation's
    reading (``sleep`` is the real one).
    Installed as the router and fleet modules' ``time`` and as every
    engine's ``_clock``, it keeps a request's deadline budget and queue
    age at what submission gave them however slow the host runs, so a
    drill's statuses do not depend on the load. Waits that must end are
    timed by the test's own wall clock (``wait``)."""

    def __init__(self):
        self.t = time.monotonic()
        self.sleep = time.sleep

    def monotonic(self):
        return self.t


class TickClock:
    """A per-replica virtual ``time.monotonic`` for the fleet module: on a
    replica's serve thread every call advances that replica's clock by
    ``base_ms`` + its ``extra_ms``; every other thread reads the wall
    clock. Installed as the fleet module's ``time``, it makes the gossiped
    tick and inter-token telemetry a function of the ticks alone, so gray
    verdicts do not depend on the host's load."""

    def __init__(self, base_ms=1.0):
        self.base_ms = base_ms
        self.extra_ms = {}
        self._t = {}
        self._lock = threading.Lock()
        self.time = time.time
        self.sleep = time.sleep

    def monotonic(self):
        name = threading.current_thread().name
        if name.startswith("fleet-") and not name.startswith("fleet-hb-"):
            rep = name[len("fleet-"):]
            with self._lock:
                t = self._t.get(rep, time.monotonic()) + 1e-3 * (
                    self.base_ms + self.extra_ms.get(rep, 0.0))
                self._t[rep] = t
                return t
        return time.monotonic()
