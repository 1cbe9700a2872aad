"""Serving fleet: replicated ContinuousBatcher engines behind leased
membership (``paddle_tpu/inference/fleet.py``).

Scale is horizontal. This module is the replica side of the serving
control plane (the router is inference/router.py): N engines register in
a generation-scoped registry on the rendezvous store — the ticket/lease
idiom, carrying a serving payload — and a `FleetWorker` runs each engine
on its own thread,
heartbeating a lease that gossips the replica's load/health digest
(`ContinuousBatcher.health_digest()`: queue depth, active slots, drain
state, prefix hit rate) plus a top-k page-hash digest of its radix prefix
tree (`PrefixCache.digest`), so the router can steer, shed, and fail over
from one key read per replica.

Key schema (store = TCPStore cross-host or MemoryStore in-process,
distributed/store.py):

    fleet/{job}/gen                     generation counter (store.add)
    fleet/{job}/{g}/replicas/...        ticketed append-only replica list
    fleet/{job}/{g}/lease/{name}        heartbeat lease {"t", "gen",
                                        queue_depth, active_slots,
                                        draining, prefix_hit_rate,
                                        tokens_emitted, role,
                                        digest: [...],
                                        telemetry: {itl_ewma_ms,
                                        itl_p50_ms, itl_p99_ms,
                                        tick_ms_ewma, queue_age_s,
                                        samples}}
    fleet/{job}/{g}/retired/{name}      graceful-retirement marker

Failure model:

  * SIGKILL — `FleetWorker.kill()` is the in-process equivalent: the
    heartbeat stops instantly and the serving loop aborts at the next
    scheduler boundary with NO cleanup, deregistration, or completion
    reporting. A survivor observes exactly what a killed subprocess would
    produce: an expired lease and orphaned in-flight requests (the router
    recovers them from its journal — router.py).
  * SIGTERM — `terminate()` drains: admission closes, in-flight slots
    finish and report, queued-but-unstarted requests hand back to the
    router for re-dispatch, and the replica writes a retirement marker so
    readers distinguish "drained" from "dead".

In-process workers keep the chaos drill deterministic and serve every
replica from ONE model: each engine takes the model's parameters by
reference (``model.param_dict()``, or one shared ``quantized_params``), so
N replicas cost one copy of the weights on the card. Their serve threads
launch on one device at once, each on its thread's current stream; the
kernels' launch counters are bumped under one lock
(``ops/kernels/_build.count``). The registry/lease code never touches
threads, so a subprocess/multi-host deployment reuses it unchanged over
the TCPStore.

Fault sites `fleet.register` / `fleet.heartbeat` (reliability/faults.py)
make both seams chaos-testable; registration and lease reads run under
bounded retry (reliability/retry.py) so store blips degrade into counters,
not crashes.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional

from ..distributed.gossip import LeaseBoard
from ..framework import flags
from ..reliability import faults
from ..reliability.retry import RetryPolicy, bump_counter


class ReplicaKilled(BaseException):
    """Hard-stop signal for a replica's serving loop (the SIGKILL-
    equivalent chaos path). BaseException, not Exception: the engine's
    per-request error handling must never absorb a kill into a request
    status — a killed replica reports nothing, like a dead process."""


class _FailedSubmit:
    """Completion shim for a request the engine refused at submit (e.g.
    prompt + budget over the replica's capacity): duck-types the
    GenRequest fields the router reads, so the refusal flows through the
    normal completion path as a clean per-request "error" instead of
    crashing the serve thread."""

    status = "error"

    def __init__(self, error: str):
        self.error = error
        self.tokens: list = []


class FleetRegistry:
    """Generation-scoped replica membership + heartbeat leases.

    The elastic manager's idiom (distributed/fleet/elastic.py) applied to
    serving: registration is a lost-update-free ticketed append, liveness
    is purely lease-based (a replica whose lease is older than
    `lease_ttl` drops out of `alive()`; nothing is ever rewritten), and
    every key is scoped by the job's generation counter so a fleet
    restart can never read a previous incarnation's stale members."""

    def __init__(self, store=None, job_id: str = "fleet",
                 lease_ttl: float = 2.0, retry_policy=None):
        if store is None:
            from ..distributed.store import MemoryStore

            store = MemoryStore()
        self.store = store
        self.job_id = job_id
        self.lease_ttl = lease_ttl
        self._retry = retry_policy if retry_policy is not None else \
            RetryPolicy(max_attempts=4, base_delay_s=0.02, max_delay_s=0.5,
                        name="fleet.store")
        self.generation = int(
            self._retry.call(self.store.add, f"fleet/{job_id}/gen", 0))
        self._board = LeaseBoard(self.store, self._key("lease"), lease_ttl)

    def _key(self, *parts: str) -> str:
        return "/".join(("fleet", self.job_id, str(self.generation))
                        + parts)

    # -- membership -------------------------------------------------------
    def register(self, name: str) -> None:
        """Append `name` to the generation's ticketed replica list.
        Fault site `fleet.register` fires before the store is touched, so
        an injected failure leaves the registry untouched; transient
        store failures retry under the bounded policy."""
        faults.maybe_fail("fleet.register", replica=name, job=self.job_id,
                          gen=self.generation)
        self._retry.call(self.store.ticket_append, self._key("replicas"),
                         name)

    def replicas(self) -> List[str]:
        """Every replica that ever registered this generation (append-
        only; dedup at read, like elastic.hosts())."""
        seen: List[str] = []
        for raw in self.store.ticket_list(self._key("replicas")):
            try:
                name = raw.decode()
            except Exception:
                continue
            if name not in seen:
                seen.append(name)
        return sorted(seen)

    # -- leases -----------------------------------------------------------
    def beat(self, name: str, payload: dict) -> None:
        """Refresh `name`'s lease, gossiping the serving payload with it
        (one store write — the digest rides the heartbeat). Fault site
        `fleet.heartbeat` makes a silently-dying lease injectable."""
        faults.maybe_fail("fleet.heartbeat", replica=name,
                          gen=self.generation)
        self._board.beat(name, gen=self.generation, **payload)

    def lease(self, name: str) -> Optional[dict]:
        return self._board.read(name)

    def leases(self) -> Dict[str, dict]:
        return self._board.read_all(self.replicas())

    def retire(self, name: str) -> None:
        """Graceful-retirement marker: a drained replica's lease may
        still look fresh for one TTL — the marker is what lets readers
        tell 'retired cleanly' from 'about to be declared dead'."""
        self.store.set(self._key("retired", name), b"1")

    def retired(self, name: str) -> bool:
        return self.store.try_get(self._key("retired", name)) is not None

    def alive(self) -> List[str]:
        """Replicas holding a fresh lease and no retirement marker."""
        return [name for name, lease in self.leases().items()
                if self._board.fresh(lease) and not self.retired(name)]

    def state(self) -> Dict[str, dict]:
        """One liveness/gossip record per registered replica: the lease
        payload (None if never seen / undecodable) plus `fresh` and
        `retired` verdicts — the router's per-poll view."""
        out: Dict[str, dict] = {}
        leases = self.leases()
        for name in self.replicas():
            lease = leases.get(name)
            out[name] = {"lease": lease,
                         "fresh": self._board.fresh(lease),
                         "retired": self.retired(name)}
        return out


class FleetWorker:
    """One in-process serving replica: a ContinuousBatcher on its own
    thread, registered in a FleetRegistry with a gossiping heartbeat.

    The router talks to a worker through four thread-safe calls:
    `offer(fr)` routes a request in (False = at soft capacity),
    `drain_completions()` / `drain_returns()` pop finished requests and
    drained-but-never-started hand-backs, `load()` is the live queue+slot
    depth. Everything engine-side happens on the worker's serve thread;
    the engine's `_on_tick` hook (pumped at every scheduler boundary) is
    where the worker admits newly routed requests mid-run, journals each
    live request's streamed tokens into its FleetRequest, snapshots the
    prefix-tree digest for the heartbeat, and honors a hard kill."""

    def __init__(self, name: str, engine, registry: FleetRegistry,
                 heartbeat_interval: float = 0.5,
                 digest_top_k: Optional[int] = None,
                 role: Optional[str] = None,
                 stall_s: Optional[float] = None):
        self.name = name
        self.engine = engine
        self.registry = registry
        self.hb_interval = heartbeat_interval
        self._top_k = int(flags.get_flag("fleet_digest_top_k")
                          if digest_top_k is None else digest_top_k)
        # gray-failure chaos knob: a per-tick stall, mutable live (tests
        # flip worker.stall_s mid-stream) — slow-but-alive, never dead: the
        # heartbeat thread is untouched, so the lease stays fresh while
        # every token crawls. The router must catch this from telemetry.
        self.stall_s = float(flags.get_flag("fleet_worker_stall_s")
                             if stall_s is None else stall_s)
        # latency telemetry, gossiped on every heartbeat: inter-token
        # gap EWMA + windowed p50/p99, tick-duration EWMA, oldest-inbox
        # queue age. Written on the serve thread (_tick), read on the
        # heartbeat thread (_beat) — the window is copied under _lock,
        # the scalar EWMAs are plain float fields (an atomic ref read;
        # one-beat staleness is within the gossip contract anyway).
        self._itl_ewma: Optional[float] = None      # ms / token
        self._tick_ewma: Optional[float] = None     # ms / tick
        self._itl_win: deque = deque(maxlen=128)    # recent gaps, ms
        self._itl_samples = 0
        self._last_tick_t: Optional[float] = None
        self._last_tok: tuple = (0, None)   # (tokens_emitted, t)
        # disaggregated serving: the replica's role rides every heartbeat
        # lease, so the router steers admission (prefill specialists take new
        # prompts) and migration (decode specialists receive live
        # sequences) from gossip alone — it never reads an engine
        # directly across the fleet seam
        self.role = str(flags.get_flag("fleet_role")
                        if role is None else role)
        if self.role not in ("prefill", "decode", "both"):
            raise ValueError(f"role must be 'prefill', 'decode' or "
                             f"'both', got {self.role!r}")
        self.mig_stats = {"migrations_in": 0, "migrations_out": 0,
                          "migration_stall_ms": 0.0,
                          "bytes_migrated": 0, "resumes_recovered": 0}
        # migration plumbing — commands cross from the router thread
        # to the serve thread through these locked queues; everything
        # that touches the engine happens in _pump_migrations on the
        # serve thread (the _admit_inbox contract)
        self._mig_cmds: deque = deque()     # ("export"|"commit"|"cancel", fr)
        self._mig_boxes: Dict[int, dict] = {}   # fr.rid -> export box
        self._mig_in: deque = deque()       # (fr, blob) deliveries
        self._mig_rids: set = set()         # engine rids migrated IN
        # fr.rid -> the SOURCE GenRequest binding, captured at
        # begin_migration: once the destination imports, fr._gen_req is
        # rebound to the destination's request, so a later commit/cancel
        # must NOT read it — it would discard nothing (leaking the
        # parked host slots) and pop a colliding destination rid out of
        # _live, silently dropping some other request's completion
        self._mig_out: Dict[int, object] = {}
        # soft admission capacity: decode slots + the engine's bounded
        # queue (or one extra batch when unbounded) — the router's
        # backpressure signal, mirroring try_submit's
        self.capacity = engine.B + (engine.max_pending
                                    if engine.max_pending is not None
                                    else engine.B)
        self._lock = threading.Lock()
        self._inbox: deque = deque()        # routed, not yet submitted
        self._live: Dict[int, object] = {}  # engine rid -> FleetRequest
        self._completions: deque = deque()  # (FleetRequest, GenRequest)
        self._returns: deque = deque()      # drained hand-backs
        self._digest: List[str] = []
        self._killed = False
        self._stopping = False
        self._wake = threading.Event()
        self._hb_stop = threading.Event()
        self._serve_t: Optional[threading.Thread] = None
        self._hb_t: Optional[threading.Thread] = None
        engine._on_tick = self._tick
        from ..reliability.health import register_disagg
        register_disagg(self)

    # -- router-facing (any thread) ---------------------------------------
    def load(self) -> int:
        """Outstanding requests on this replica: routed-but-unsubmitted
        (inbox) plus everything bound to the engine (_live covers both
        engine-queued and slot-active — engine.pending would double-
        count the queued ones, since every post-start submission goes
        through _admit_inbox and is therefore in _live)."""
        with self._lock:
            return len(self._inbox) + len(self._live)

    def alive(self) -> bool:
        return (not self._killed and self._serve_t is not None
                and self._serve_t.is_alive())

    def offer(self, fr) -> bool:
        """Accept a routed request. False = stopping/killed or at soft
        capacity (the router keeps it queued and retries next poll)."""
        if self._killed or self._stopping:
            return False
        with self._lock:
            if len(self._inbox) + len(self._live) >= self.capacity:
                return False
            fr._routed_t = time.monotonic()     # queue-age telemetry
            self._inbox.append(fr)
        self._wake.set()
        return True

    def drain_completions(self) -> List[tuple]:
        out = []
        with self._lock:
            while self._completions:
                out.append(self._completions.popleft())
        return out

    def drain_returns(self) -> List[object]:
        out = []
        with self._lock:
            while self._returns:
                out.append(self._returns.popleft())
        return out

    # -- router-facing: live KV migration. The router drives a migration
    # as a small state machine over these calls; every engine mutation they
    # imply happens later, on THIS worker's serve thread, via
    # _pump_migrations — the same single-owner rule _admit_inbox keeps.

    def migration_ready(self, fr) -> bool:
        """True once this replica has built the request's prompt KV and
        streamed at least one token — the point where a prefill
        specialist's work is done and the live sequence is worth
        moving. Reads the engine binding's monotonic fields only, so a
        stale read just delays readiness by one poll."""
        gr = getattr(fr, "_gen_req", None)
        if gr is None or getattr(gr, "done", True):
            return False
        prompt = getattr(gr, "prompt", None)
        if prompt is None:      # _FailedSubmit shim
            return False
        return (gr.prefilled >= len(prompt) and len(gr.tokens) >= 1
                and len(gr.tokens) < gr.max_new_tokens)

    def begin_migration(self, fr) -> bool:
        """Ask the serve thread to park `fr`'s stream and export it.
        The park intent applies at the next scheduler boundary; the
        export box appears once the blob is serialized (poll it with
        poll_migration). False when this replica can no longer own the
        request (killed/stopping)."""
        if self._killed or self._stopping:
            return False
        gr = fr._gen_req
        try:
            self.engine.park(gr.rid)    # thread-safe intent (set add)
        except Exception:
            return False
        with self._lock:
            self._mig_out[fr.rid] = gr  # pin the SOURCE binding now
            self._mig_cmds.append(("export", fr))
        self._wake.set()
        return True

    def poll_migration(self, fr) -> Optional[dict]:
        """Pop `fr`'s export box: {"blob": ...} once serialized,
        {"done": True} when the request finished before the park could
        apply (the router then abandons the migration), None while the
        serve thread is still working."""
        if self._killed:
            return None
        with self._lock:
            return self._mig_boxes.pop(fr.rid, None)

    def finish_migration(self, fr, ok: bool) -> None:
        """Resolve an exported migration: ok=True (delivered) discards
        the parked source record and frees its host slots; ok=False
        (transport or destination failure) resumes the stream HERE —
        the sequence decodes on at the source, degradation not loss."""
        with self._lock:
            self._mig_cmds.append(("commit" if ok else "cancel", fr))
        self._wake.set()

    def deliver_migration(self, fr, blob: dict) -> bool:
        """Destination side: accept a migrated stream. The serve
        thread imports the blob into the local host arena, resumes it,
        and binds it to `fr` so journaling/completion flow exactly as
        for a locally admitted request. False = this replica cannot
        take it (killed/stopping); an import failure after acceptance
        hands `fr` back to the router for re-dispatch (re-prefill)."""
        if self._killed or self._stopping:
            return False
        with self._lock:
            self._mig_in.append((fr, blob))
        self._wake.set()
        return True

    def disagg_snapshot(self) -> Optional[dict]:
        """One record for health_snapshot()["disagg"]: the replica's
        role plus migration traffic. None for a monolithic ('both')
        worker that never touched a migration — the surface lists
        disaggregation participants only (the kv_tiers idiom)."""
        if self.role == "both" and not any(
                v for v in self.mig_stats.values()):
            return None
        return {"name": self.name, "role": self.role,
                **{k: (float(v) if isinstance(v, float) else int(v))
                   for k, v in self.mig_stats.items()}}

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "FleetWorker":
        self.registry.register(self.name)
        self._beat()        # lease exists before the first request routes
        self._serve_t = threading.Thread(
            target=self._serve, daemon=True, name=f"fleet-{self.name}")
        self._hb_t = threading.Thread(
            target=self._hb_loop, daemon=True, name=f"fleet-hb-{self.name}")
        self._serve_t.start()
        self._hb_t.start()
        return self

    def warm(self, prompt, max_new_tokens: int = 2) -> None:
        """Pay the first-use costs before traffic (the kernel build and
        the allocator's first pool): run one throwaway request through
        the engine directly. Call before start()."""
        self.engine.submit(prompt, max_new_tokens)
        self.engine.run()
        self.engine.reset_stats()
        # the warm run's ticks straddle the first-use costs: flush them
        # from the latency telemetry, or this replica gossips warm-up
        # EWMAs as serving latency and the router's gray detection
        # flags the one replica that paid them
        with self._lock:
            self._itl_win.clear()
        self._itl_ewma = self._tick_ewma = None
        self._last_tick_t = None
        self._itl_samples = 0
        self._last_tok = (
            int(self.engine.stats.get("tokens_emitted", 0)), None)

    def terminate(self) -> None:
        """SIGTERM path: close admission, finish in-flight slots, hand
        queued requests back to the router, retire the lease."""
        self._stopping = True
        self.engine.drain()
        self._wake.set()

    def kill(self) -> None:
        """SIGKILL-equivalent: heartbeats stop NOW, the serving loop
        aborts at its next scheduler boundary, and nothing is cleaned
        up, reported, or deregistered — the lease simply expires."""
        self._killed = True
        self._wake.set()

    def join(self, timeout: Optional[float] = None) -> None:
        if self._serve_t is not None:
            self._serve_t.join(timeout)
        if self._hb_t is not None:
            self._hb_t.join(timeout)

    # -- serve thread -------------------------------------------------------
    def _serve(self) -> None:
        try:
            while True:
                if self._killed:
                    return          # no cleanup: SIGKILL semantics
                if self._stopping:
                    break
                self._admit_inbox()
                if self.engine.pending:
                    done = self.engine.run()
                    self._report(done)
                else:
                    # idle: re-anchor the telemetry clocks so the first
                    # tick of the NEXT serving bout doesn't record the
                    # idle gap as a multi-second "tick" / token gap —
                    # that contamination would make a reinstated-then-
                    # probed replica look gray forever
                    self._last_tick_t = None
                    self._last_tok = (self._last_tok[0], None)
                    self._wake.wait(0.002)
                    self._wake.clear()
        except ReplicaKilled:
            return                  # aborted mid-run, nothing reported
        except BaseException:
            # unexpected serving-loop death (an engine fault with no
            # retry policy, a poisoned runtime): to every peer this IS a
            # crash — stop the heartbeat so the lease expires and the
            # router fails the replica over, record the degradation, and
            # re-raise so the stack reaches the thread log. Reporting
            # partial state here would break exactly-once delivery.
            bump_counter("fleet.serve", "failures")
            self._hb_stop.set()
            raise
        # ---- graceful retirement (terminate() path) ----
        # in-flight migrations complete first (drain-is-free): exports
        # serialize and await their commit, deliveries import — only
        # then is the remaining work split into finished / hand-back
        self._drain_migrations()
        # a drain()ed run has already finished in-flight slots; anything
        # still queued in the engine or the inbox was never started and
        # goes back to the router untouched for re-dispatch elsewhere
        with self._lock:
            handback = list(self._inbox)
            self._inbox.clear()
            queued = {id(r) for r in self.engine._queue}
            for rid in list(self._live):
                fr = self._live[rid]
                if id(getattr(fr, "_gen_req", None)) in queued:
                    handback.append(self._live.pop(rid))
            for fr in handback:
                fr._gen_req = None
                fr._journal = []
                self._returns.append(fr)
        try:
            self._beat()            # final lease carries draining=True
            self.registry.retire(self.name)
        except Exception:
            bump_counter("fleet.heartbeat", "failures")
        self._hb_stop.set()

    def _pump_migrations(self) -> None:
        """Service migration commands and deliveries (serve thread
        only — rides _admit_inbox, so it runs between engine runs AND
        at every scheduler boundary via _tick).

        Source side: an "export" command waits until the park intent
        has applied (requeued until the rid shows up in the engine's
        parked set — or resolves as a done-box when the stream finished
        first), then serializes the blob into the request's box. A
        "commit" discards the parked record (delivery confirmed; the
        request now lives on the destination, so its _live binding
        drops too). A "cancel" resumes the stream locally.

        Destination side: a delivered blob imports into the local host
        arena under a fresh engine rid, resumes, and binds to its
        FleetRequest so journaling and completion are indistinguishable
        from a locally admitted request; an import failure hands the
        request back to the router untouched (re-dispatch elsewhere,
        re-prefill — degradation, not loss)."""
        requeue: List[tuple] = []
        while True:
            with self._lock:
                if not self._mig_cmds:
                    break
                op, fr = self._mig_cmds.popleft()
                gr = self._mig_out.get(fr.rid)  # SOURCE binding, never
            rid = getattr(gr, "rid", None)      # the rebound dst one
            if op == "export":
                if fr.done:
                    # router already finished it and stopped polling
                    # this migration; no box, just drop the pin
                    with self._lock:
                        self._mig_out.pop(fr.rid, None)
                elif gr is None or gr.done:
                    # finished (or failed over) before the park could
                    # apply: nothing to move — tell the router so
                    with self._lock:
                        self._mig_boxes[fr.rid] = {"done": True}
                        self._mig_out.pop(fr.rid, None)
                elif rid in self.engine._parked:
                    blob = self.engine.export_parked(rid)
                    with self._lock:
                        self._mig_boxes[fr.rid] = {"blob": blob}
                else:
                    requeue.append((op, fr))    # park still pending
            elif op == "commit":
                if rid in self.engine._parked:
                    self.engine.discard_parked(rid)
                with self._lock:
                    self._live.pop(rid, None)
                    self._mig_out.pop(fr.rid, None)
                self.mig_stats["migrations_out"] += 1
            else:                               # "cancel"
                if rid in self.engine._parked:
                    self.engine.resume(rid)
                with self._lock:
                    self._mig_out.pop(fr.rid, None)
        if requeue:
            with self._lock:
                self._mig_cmds.extend(requeue)
        while True:
            with self._lock:
                if not self._mig_in:
                    break
                fr, blob = self._mig_in.popleft()
            try:
                rid_new = self.engine.import_parked(blob)
                self.engine.resume(rid_new)
                req = self.engine._resuming[rid_new].req
            except Exception:
                # (the reference counts this under "import_failures", a
                # key bump_counter refuses: its serve loop dies instead)
                bump_counter("fleet.migrate", "failures")
                with self._lock:
                    fr._gen_req = None
                    fr._journal = []
                    self._returns.append(fr)
                continue
            with self._lock:
                fr._gen_req = req
                fr._journal = list(req.tokens)
                self._live[rid_new] = fr
                self._mig_rids.add(rid_new)
            self.mig_stats["migrations_in"] += 1
            self.mig_stats["bytes_migrated"] += int(
                blob.get("nbytes", 0))

    def _drain_migrations(self, grace_s: float = 5.0) -> None:
        """Drain-is-free: a terminating replica finishes its in-flight
        migrations — pending exports serialize, delivered blobs import,
        commits and cancels land — before handing anything back, so
        draining a prefill specialist never costs a re-prefill. Bounded by
        `grace_s` in case the router stopped polling mid-migration."""
        deadline = time.monotonic() + grace_s
        while time.monotonic() < deadline:
            self._pump_migrations()
            with self._lock:
                busy = bool(self._mig_cmds or self._mig_boxes
                            or self._mig_in)
            if not busy:
                return
            self._wake.wait(0.002)
            self._wake.clear()

    def _admit_inbox(self) -> None:
        """Move routed requests into the engine (serve thread only —
        called between runs and from the engine's own _on_tick, so the
        engine queue is never mutated from a foreign thread)."""
        self._pump_migrations()
        now = time.monotonic()
        while True:
            with self._lock:
                if not self._inbox:
                    return
                fr = self._inbox.popleft()
            try:
                rid = self.engine.try_submit(
                    fr.wire_prompt(), fr.wire_max_new(),
                    deadline_s=fr.wire_deadline(now),
                    adapter_id=getattr(fr, "adapter_id", None))
            except Exception as e:
                # the engine refused the request itself (e.g. over
                # capacity): a per-request error, never a dead replica
                shim = _FailedSubmit(repr(e))
                with self._lock:
                    fr._gen_req = shim
                    self._completions.append((fr, shim))
                continue
            if rid is None:         # engine backpressure: retry next pump
                with self._lock:
                    self._inbox.appendleft(fr)
                return
            with self._lock:
                fr._gen_req = self.engine._queue[-1]
                self._live[rid] = fr

    def _report(self, done: Dict[int, object]) -> None:
        with self._lock:
            for rid, gr in done.items():
                fr = self._live.pop(rid, None)
                if fr is not None:
                    self._completions.append((fr, gr))
                    if rid in self._mig_rids and gr.status == "ok":
                        # a migrated-in stream ran to a clean finish:
                        # the disagg pipeline's end-to-end success count
                        self.mig_stats["resumes_recovered"] += 1
                self._mig_rids.discard(rid)

    def _tick(self, tick: int) -> None:
        """Engine scheduler-boundary hook: the kill point, the mid-run
        admission point, and the journal point. Journaling copies each
        live request's emitted tokens into its FleetRequest so the
        router's failover journal is at most one scheduler boundary
        behind the stream — anything newer is regenerated token-
        identically by the greedy re-prefill contract (router.py).

        Also the gray-failure seat: fault site `fleet.tick` (arm it with
        `delay_s` to stall every scheduler boundary of one replica — a
        raising spec here is a crashed serve loop, i.e. plain failover),
        the `stall_s` knob, and the latency telemetry the heartbeat
        gossips for the router's straggler detection."""
        if self._killed:
            raise ReplicaKilled(self.name)
        faults.maybe_fail("fleet.tick", replica=self.name, tick=tick)
        if self.stall_s > 0:
            time.sleep(self.stall_s)
        now = time.monotonic()
        if self._last_tick_t is not None:
            dt = (now - self._last_tick_t) * 1e3
            self._tick_ewma = dt if self._tick_ewma is None else \
                0.3 * dt + 0.7 * self._tick_ewma
        self._last_tick_t = now
        tok = int(self.engine.stats.get("tokens_emitted", 0))
        last_n, last_t = self._last_tok
        if tok != last_n:
            if tok > last_n and last_t is not None:
                gap = (now - last_t) * 1e3 / (tok - last_n)
                self._itl_ewma = gap if self._itl_ewma is None else \
                    0.3 * gap + 0.7 * self._itl_ewma
                with self._lock:
                    self._itl_win.append(gap)
                self._itl_samples += tok - last_n
            self._last_tok = (tok, now)     # < covers reset_stats()
        self._admit_inbox()
        with self._lock:
            for fr in self._live.values():
                gr = fr._gen_req
                if gr is not None:
                    fr._journal = list(gr.tokens)
        pc = self.engine._prefix
        if pc is not None:
            try:
                self._digest = pc.digest(self._top_k)
            except Exception:
                pass        # a torn digest walk only staler gossip

    # -- heartbeat thread ---------------------------------------------------
    def _telemetry(self) -> dict:
        """Latency telemetry for the lease: inter-token EWMA + windowed
        p50/p99, tick-duration EWMA, oldest-routed queue age. All values are
        per-replica observations — the router turns them into verdicts
        fleet-RELATIVELY, so none of these numbers carries an absolute
        meaning on its own."""
        with self._lock:
            win = sorted(self._itl_win)
            oldest = (getattr(self._inbox[0], "_routed_t", None)
                      if self._inbox else None)

        def pct(q: float) -> Optional[float]:
            if not win:
                return None
            return win[min(len(win) - 1, int(round(q * (len(win) - 1))))]

        return {"itl_ewma_ms": self._itl_ewma,
                "itl_p50_ms": pct(0.5), "itl_p99_ms": pct(0.99),
                "tick_ms_ewma": self._tick_ewma,
                "queue_age_s": (None if oldest is None
                                else time.monotonic() - oldest),
                "samples": self._itl_samples}

    def _beat(self) -> None:
        payload = dict(self.engine.health_digest())
        payload["draining"] = bool(payload["draining"] or self._stopping)
        payload["digest"] = list(self._digest)
        payload["role"] = self.role    # disagg steering rides the lease
        payload["telemetry"] = self._telemetry()
        self.registry.beat(self.name, payload)

    def _hb_loop(self) -> None:
        while not self._hb_stop.wait(self.hb_interval):
            if self._killed:
                return              # lease left to expire, like a dead host
            try:
                self._beat()
            except Exception:
                # a silently-dying lease is indistinguishable from a dead
                # replica to the router — count the degradation where the
                # post-mortem looks and keep trying within the TTL
                bump_counter("fleet.heartbeat", "failures")


def make_fleet(model, n_replicas: int, registry: Optional[FleetRegistry]
               = None, heartbeat_interval: float = 0.5,
               lease_ttl: float = 2.0, warm_prompt=None,
               name_prefix: str = "replica",
               roles: Optional[List[str]] = None, **engine_kw) -> tuple:
    """Build `n_replicas` identically-shaped workers over one model (one
    shared copy of the weights — pass `quantized_params` in `engine_kw` to
    serve a shared quantized artifact) and one registry; `warm_prompt`
    (optional) pays the first-use costs on replica 0 before any worker
    starts. `roles` (optional, one per replica:
    "prefill" / "decode" / "both") builds a disaggregated fleet —
    e.g. ``roles=["prefill", "decode"]`` with a disagg FleetRouter.
    Returns (registry, [workers]); workers are NOT started — the caller
    starts them so tests can interleave."""
    from .continuous_batching import ContinuousBatcher

    if roles is not None and len(roles) != n_replicas:
        raise ValueError(f"roles must name every replica: got "
                         f"{len(roles)} roles for {n_replicas}")
    registry = (registry if registry is not None
                else FleetRegistry(lease_ttl=lease_ttl))
    workers = []
    for i in range(n_replicas):
        eng = ContinuousBatcher(model, **engine_kw)
        workers.append(FleetWorker(
            f"{name_prefix}{i}", eng, registry,
            heartbeat_interval=heartbeat_interval,
            role=None if roles is None else roles[i]))
    if warm_prompt is not None and workers:
        workers[0].warm(warm_prompt)
    return registry, workers
