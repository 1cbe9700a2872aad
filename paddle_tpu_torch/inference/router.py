"""FleetRouter — deadline-tier admission, prefix-affinity steering, and
journaled exactly-once failover over a fleet of leased replicas
(``paddle_tpu/inference/router.py``).

The robustness contract this module carries: **a replica dies and every
request either completes on a survivor token-identical to an undisturbed
run, or fails alone with a clean status — never a hang, never a double
emit.**

How the pieces compose:

  * admission — deadline-TIER queues on top of the engines' own
    `deadline_s` + `try_submit` backpressure: a request lands in the tier
    its deadline selects (`flags.fleet_tier_edges`), dispatch drains tiers
    strictly in priority order, and under fleet-wide backpressure
    (`max_queue`) the LOWEST-priority tier sheds first
    (`stats["shed_by_tier"]`, status `"shed"`).
  * steering — adapter affinity (the gossiped `adapters_resident`), then
    prefix affinity (`flags.fleet_prefix_affinity`): the request's
    cumulative page-hash chain (prefix_cache.page_hash_chain) is scored
    against each live replica's GOSSIPED radix digest (the heartbeat
    payload, not a direct engine read), deepest match wins, ties and
    misses fall to least-loaded.
  * failover — the router IS the journal: a FleetRequest owns the
    authoritative delivered-token record (`_committed` from prior
    attempts + `_journal` streamed by the owning worker at every
    scheduler boundary). When a replica's lease expires mid-stream, its
    orphaned requests commit their tokens and re-dispatch to a survivor
    with the already-streamed prefix appended to the prompt — the greedy
    re-prefill is token-identical to the lost decode, and tokens the
    journal missed are regenerated identically, never duplicated. A
    request whose remaining deadline cannot survive the re-prefill fails
    alone with status `"replica_lost"`; one that already finished in the
    journal completes without re-dispatch. Failover clears the request's
    engine binding, so a late completion from a falsely-declared-dead
    replica no longer matches and is dropped.
  * disaggregation (`flags.fleet_disagg`) — replicas carry a ROLE on
    their gossiped lease (`prefill` / `decode` / `both`): new requests
    land on prefill specialists, and once a request's prompt KV is built
    and it has streamed a first token the router live-migrates it to a
    decode specialist — park + export at the source, a KVMigrator
    transport (inference/migration.py), import + resume at the
    destination recomputing exactly ONE token, no re-prefill. Every
    migration failure resolves by resuming at the source; a replica
    death mid-migration is plain failover.
  * gray-failure defense — lease expiry only catches DEAD replicas; the
    router scores each replica's gossiped latency telemetry
    FLEET-RELATIVELY (worst of inter-token EWMA and tick-duration EWMA
    against `flags.gray_detect_factor` x the median of its same-role
    healthy peers) and walks a quarantine state machine: ok -> suspect ->
    quarantined (no new admissions; live sequences EVACUATED to healthy
    peers over the park -> KVMigrator -> resume path) -> canary probation
    (reinstate after consecutive healthy probes, retire after repeated
    failures). Failover re-dispatches and evacuations spend from a
    token-bucket retry budget (`flags.fleet_retry_budget`).
  * drains — `begin_drain`/`end_drain` move a replica's live streams off
    it by the same evacuation sweep (the elastic scale-down seam).

Fault sites `router.dispatch` / `router.failover` / `router.handoff` /
`router.quarantine` / `router.evacuate` / `kv.migrate`
(reliability/faults.py) fire at the seams; store reads and dispatch run
under bounded retry (reliability/retry.py). The router registers itself
with the reliability health surface — `health_snapshot()["fleet"]`.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..framework import flags
from ..reliability import faults
from ..reliability.retry import RetryPolicy
from .prefix_cache import page_hash_chain

#: statuses after which a request will never change again. "shed" and
#: "replica_lost" are the two router-level additions to the engine's
#: ok/timeout/poisoned/error surface.
TERMINAL = frozenset(
    {"ok", "timeout", "poisoned", "error", "replica_lost", "shed"})


@dataclass
class FleetRequest:
    """One request's fleet-level record — and its failover journal.

    `tokens` is the exactly-once delivery surface: it is written exactly
    once, at terminal transition, as `_committed + <final attempt's
    engine tokens>`. `_journal` is streamed by the owning worker at every
    scheduler boundary and only ever COMMITS (moves into `_committed`)
    when that worker is declared dead or hands the request back — so no
    token can be delivered twice, and a token lost between boundaries is
    regenerated identically by the greedy re-prefill."""

    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    deadline_s: Optional[float]
    tier: int
    submit_t: float
    # multi-LoRA: the adapter the
    # request rides, carried across failover re-dispatches; None = base
    adapter_id: Optional[object] = None
    status: str = "queued"          # queued|dispatched|<TERMINAL>
    tokens: List[int] = field(default_factory=list)
    replica: Optional[str] = None   # current / last owning worker
    failovers: int = 0
    # disagg: completed live
    # migrations this request rode (prefill specialist -> decode
    # specialist, KV pages + token record, no re-prefill)
    migrated: int = 0
    error: Optional[str] = None
    # journal state (router/worker internal)
    _committed: List[int] = field(default_factory=list)
    _journal: List[int] = field(default_factory=list)
    _gen_req: object = None         # owning engine's GenRequest binding
    # migration state machine (router internal): {"src", "dst", "t0",
    # "evac"?} while a migration is in flight; _no_migrate pins a
    # request to its source after a failed/faulted migration attempt
    # (decode-on-at-source is the degradation mode, never an error)
    _mig: Optional[dict] = None
    _no_migrate: bool = False
    # gray-failure machinery (router/worker internal): _probe names the
    # quarantined replica a canary probe targets (probes bypass tiers,
    # steering, migration, and failover re-dispatch); _routed_t is
    # stamped by the worker at offer() for queue-age telemetry; _done_t
    # at terminal transition (canary latency accounting)
    _probe: Optional[str] = None
    _routed_t: Optional[float] = None
    _done_t: Optional[float] = None

    @property
    def done(self) -> bool:
        return self.status in TERMINAL

    @property
    def output_ids(self) -> List[int]:
        return list(map(int, self.prompt)) + list(self.tokens)

    # -- wire view: what the CURRENT attempt submits to an engine --------
    def wire_prompt(self) -> np.ndarray:
        """Prompt plus every token already delivered by prior attempts:
        the re-prefill that makes a greedy continuation token-identical
        to the lost decode."""
        if not self._committed:
            return self.prompt
        return np.concatenate(
            [self.prompt, np.asarray(self._committed, np.int32)])

    def wire_max_new(self) -> int:
        return self.max_new_tokens - len(self._committed)

    def wire_deadline(self, now: float) -> Optional[float]:
        """Remaining wall budget at engine-submit time (the engine
        measures deadline_s from its own submit clock)."""
        if self.deadline_s is None:
            return None
        return self.deadline_s - (now - self.submit_t)


def _median(vals: List[float]) -> float:
    s = sorted(vals)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


class _TokenBucket:
    """The router's retry budget: failover re-dispatches and quarantine
    evacuations each spend one token, and the bucket refills
    continuously at `rate`/s up to `capacity` — so a denial is temporary
    back-off under a correlated brown-out, not a permanent verdict.
    capacity < 0 = unlimited. Single-pumper router: no lock."""

    def __init__(self, capacity: float, rate: float):
        self.capacity = float(capacity)
        self.rate = float(rate)
        self.tokens = max(0.0, self.capacity)
        self._t = time.monotonic()

    def take(self, n: float = 1.0) -> bool:
        if self.capacity < 0:
            return True
        now = time.monotonic()
        self.tokens = min(self.capacity,
                          self.tokens + (now - self._t) * self.rate)
        self._t = now
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False

    def left(self) -> float:
        if self.capacity < 0:
            return float("inf")
        self.take(0.0)      # refill to now
        return self.tokens


class FleetRouter:
    """Routes requests across FleetWorkers; owns tiers, journal, failover.

    Single-pumper design: `submit()` and `poll()`/`join()` are called
    from one serving thread (workers push completions through their own
    locked queues), which keeps every routing/failover decision
    deterministic under test — the same property the engine's host loop
    relies on."""

    #: gray-failure hysteresis knobs (instance-overridable in tests; the
    #: detection SENSITIVITY is flags.gray_detect_factor — these shape
    #: how much evidence a verdict needs, not what counts as an outlier)
    GRAY_STREAK = 3         # consecutive outlier sweeps -> quarantine
    GRAY_CANARY_PASSES = 2  # consecutive healthy probes -> reinstate
    GRAY_CANARY_LIMIT = 4   # cumulative failed probes -> retire
    GRAY_PROBE_GAP_S = 0.05     # spacing between canary probes
    GRAY_PROBE_TOKENS = 4       # canary prompt / budget length
    GRAY_COOLDOWN_S: Optional[float] = None     # None = 2 x lease_ttl

    def __init__(self, workers, registry, affinity: Optional[bool] = None,
                 max_queue: Optional[int] = None,
                 reprefill_headroom_s: float = 0.0,
                 retry_policy=None, disagg: Optional[bool] = None,
                 migrator=None, gray_factor: Optional[float] = None,
                 retry_budget: Optional[float] = None):
        self.workers = {w.name: w for w in workers}
        self.registry = registry
        self._affinity = (bool(flags.get_flag("fleet_prefix_affinity"))
                          if affinity is None else bool(affinity))
        # disaggregated prefill/decode serving: requires at least one
        # prefill
        # SPECIALIST, at least one decode-capable replica, and the host
        # tier on every engine (migration lands in the host arena). The
        # ctor contract mirrors the engine's: the flag-driven default
        # activates only where legal, an EXPLICIT disagg=True on an
        # illegal fleet raises.
        roles = {w.name: getattr(w, "role", "both") for w in workers}
        specialists = any(r == "prefill" for r in roles.values())
        decode_capable = any(r in ("decode", "both")
                             for r in roles.values())
        tiered = all(getattr(w.engine, "_host_tier", False)
                     for w in workers) if workers else False
        if disagg is None:
            self._disagg = (bool(flags.get_flag("fleet_disagg"))
                            and specialists and decode_capable
                            and tiered)
        else:
            self._disagg = bool(disagg)
            if self._disagg and not (specialists and decode_capable):
                raise ValueError(
                    f"disagg needs a prefill specialist AND a decode-"
                    f"capable replica, got roles {sorted(roles.items())}")
            if self._disagg and not tiered:
                raise ValueError(
                    "disagg needs kv_host_tier on every replica: live "
                    "KV migration serializes parked host-tier pages")
        any_tiered = any(getattr(w.engine, "_host_tier", False)
                         for w in workers)
        if migrator is None and (self._disagg or any_tiered):
            # a migrator whenever migration is POSSIBLE, not only under
            # disagg: quarantine evacuation rides the same park ->
            # transport -> resume path on any host-tiered fleet
            from ..distributed.store import MemoryStore
            from .migration import KVMigrator

            # in-process fleets hand the blob off by reference; a
            # cross-host (TCPStore) fleet streams it chunk by chunk
            migrator = KVMigrator(
                mode="handoff" if isinstance(registry.store, MemoryStore)
                else "chunked")
        self._migrator = migrator
        # gray-failure defense state: per-replica detection/probation records,
        # the in-flight migration index (evacuations + disagg share the advance
        # loop), and the retry budget
        self._gray_factor = float(flags.get_flag("gray_detect_factor")
                                  if gray_factor is None else gray_factor)
        budget = float(flags.get_flag("fleet_retry_budget")
                       if retry_budget is None else retry_budget)
        self._budget = _TokenBucket(budget, max(budget, 0.0) / 60.0)
        self._gray: Dict[str, dict] = {}
        self._gray_last_t = float("-inf")
        # elastic scale-down: replicas a FleetAutoscaler is draining out —
        # excluded from admission targets and evacuation destinations,
        # their live streams moved by the same evacuation sweep the
        # quarantine path uses. Brownout L3 refuses this many lowest-
        # priority tiers at admission (0 = off).
        self._no_admit: set = set()
        self._drain_evac: set = set()
        self.brownout_shed_tiers = 0
        self._migrating: set = set()    # rids with fr._mig in flight
        edges = [float(x) for x in
                 str(flags.get_flag("fleet_tier_edges")).split(",") if x]
        if edges != sorted(edges):
            raise ValueError(
                f"fleet_tier_edges must ascend, got {edges}")
        self._edges = edges
        self.n_tiers = len(edges) + 1
        self._tiers: List[deque] = [deque() for _ in range(self.n_tiers)]
        self.max_queue = max_queue
        # the failover gate: a request must have at least this much wall
        # budget left to be worth re-prefilling on a survivor; below it
        # the request fails alone with "replica_lost" instead of burning
        # a survivor's slot on a doomed re-prefill
        self.reprefill_headroom_s = reprefill_headroom_s
        self._retry = retry_policy if retry_policy is not None else \
            RetryPolicy(max_attempts=3, base_delay_s=0.01, max_delay_s=0.2,
                        name="fleet.router")
        self._reqs: Dict[int, FleetRequest] = {}
        self._done: Dict[int, FleetRequest] = {}
        self._next_rid = 0
        self._dead: set = set()
        self._retired: set = set()
        self._state: Dict[str, dict] = {}   # last lease poll
        # lease freshness only changes at TTL granularity, so the store
        # sweep (membership list + per-replica lease/retired reads) is
        # rate-limited well under the TTL instead of running at the
        # pump's cadence — on a TCPStore fleet each sweep is ~4N RPCs
        self._state_every = min(0.05, registry.lease_ttl / 5.0)
        self._state_t = float("-inf")
        eng = next(iter(self.workers.values())).engine if workers else None
        self.eos = getattr(eng, "eos", None)
        self.page_size = getattr(eng, "page_size", 16)
        self.stats = {
            "submitted": 0, "dispatched": 0, "completed": 0,
            "failovers": 0,             # dead-replica events handled
            "requests_recovered": 0,    # finished ok after a failover
            "replica_lost": 0,          # failed alone at the failover gate
            "redispatched": 0,          # re-routed (failover + drain)
            "affinity_routed": 0, "least_loaded_routed": 0,
            "adapter_routed": 0,    # steered to a resident-adapter holder
            "shed_by_tier": {t: 0 for t in range(self.n_tiers)},
            # disagg migration counters
            "migrations": 0,            # live sequences moved
            "migrations_failed": 0,     # transport/destination failures
            "handoff_faults": 0,        # router.handoff fault-site hits
            "migration_stall_ms": 0.0,  # park -> resume-bound wall time
            # gray-failure defense
            "quarantines": 0,           # straggler replicas quarantined
            "evacuations": 0,           # live sequences moved off them
            "evacuations_failed": 0,
            "canary_probes": 0,         # probation requests issued
            "reinstated": 0,            # quarantined replicas cleared
            "gray_retired": 0,          # quarantined replicas given up on
            "budget_denials": 0,        # re-dispatches the budget refused
            "quarantine_faults": 0,     # router.quarantine fault hits
            "evacuate_faults": 0,       # router.evacuate fault hits
        }
        from ..reliability.health import register_fleet

        register_fleet(self)

    # -- admission ----------------------------------------------------------
    def tier_for(self, deadline_s: Optional[float]) -> int:
        if deadline_s is None:
            return self.n_tiers - 1
        for k, edge in enumerate(self._edges):
            if deadline_s <= edge:
                return k
        return self.n_tiers - 1

    def _queued(self) -> int:
        return sum(len(q) for q in self._tiers)

    def submit(self, prompt_ids, max_new_tokens: int = 16,
               deadline_s: Optional[float] = None,
               adapter_id: Optional[object] = None) -> int:
        """Admit into the deadline tier; under fleet-wide backpressure
        the lowest-priority tier sheds (the incoming request itself when
        it IS lowest-priority) — status "shed", never an exception, so
        overload degrades batch traffic before interactive traffic.
        `adapter_id` rides every dispatch attempt (incl. failover) and
        steers adapter-affinity routing."""
        if isinstance(prompt_ids, torch.Tensor):
            prompt_ids = prompt_ids.cpu().numpy()
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        tier = self.tier_for(deadline_s)
        fr = FleetRequest(self._next_rid, prompt, int(max_new_tokens),
                          deadline_s, tier, time.monotonic(),
                          adapter_id=adapter_id)
        self._next_rid += 1
        self._reqs[fr.rid] = fr
        self.stats["submitted"] += 1
        if (self.brownout_shed_tiers
                and tier >= self.n_tiers - self.brownout_shed_tiers):
            # brownout L3: the lowest-priority tier(s) shed AT admission
            # while the ladder holds — same terminal status as queue-
            # pressure shedding, so callers need no new vocabulary
            self.stats["shed_by_tier"][tier] += 1
            fr.status = "shed"
            self._done[fr.rid] = fr
            return fr.rid
        if self.max_queue is not None and self._queued() >= self.max_queue:
            victim = fr
            for t in range(self.n_tiers - 1, tier, -1):
                if self._tiers[t]:
                    victim = self._tiers[t].pop()    # newest of the
                    break                            # lowest tier
            self.stats["shed_by_tier"][victim.tier] += 1
            victim.status = "shed"
            self._done[victim.rid] = victim
            if victim is fr:
                return fr.rid
        fr.status = "queued"
        self._tiers[tier].append(fr)
        return fr.rid

    def request(self, rid: int) -> FleetRequest:
        return self._reqs[rid]

    def shed_queued_tier(self, tier: int) -> int:
        """Shed everything queued (not yet dispatched) in ``tier`` —
        brownout L3's entry action: once the ladder refuses the tier at
        admission, holding its already-queued work would just age it
        into timeouts. Returns the count shed."""
        q = self._tiers[tier]
        n = 0
        while q:
            fr = q.pop()
            self.stats["shed_by_tier"][fr.tier] += 1
            fr.status = "shed"
            self._done[fr.rid] = fr
            n += 1
        return n

    # -- elastic membership: the FleetAutoscaler grows and shrinks the
    # fleet live — these are the only mutation points, so membership changes
    # stay on the pump thread
    # ------------------------------------------------------
    def add_worker(self, w) -> None:
        """Adopt a started FleetWorker (scale-up): it becomes a dispatch
        target the moment its first lease lands (the `_targets` fresh-
        lease gate — nothing routes to a replica the store hasn't
        seen)."""
        if w.name in self.workers:
            raise ValueError(f"worker {w.name!r} already in the fleet")
        self.workers[w.name] = w

    def remove_worker(self, name: str) -> None:
        """Forget a retired replica (scale-down endpoint): only ever
        called on a worker with no live streams — terminate() has
        drained it and retired its lease, so nothing can route to it
        between the drain and this removal."""
        self.workers.pop(name, None)
        self._no_admit.discard(name)
        self._drain_evac.discard(name)
        self._gray.pop(name, None)

    def begin_drain(self, name: str) -> None:
        """Mark ``name`` draining-for-scale-down: no new admissions, no
        evacuation/migration destinations, and the evacuation sweep
        starts moving its live streams to survivors (park -> KVMigrator
        -> resume, exactly ONE recomputed token each — the quarantine
        path's machinery, so `resumes == evacuations` still proves
        losslessness fleet-wide)."""
        if name not in self.workers:
            raise ValueError(f"unknown worker {name!r}")
        self._no_admit.add(name)
        self._drain_evac.add(name)

    def end_drain(self, name: str) -> None:
        """Abandon (or complete) a scale-down drain: the replica takes
        admissions again; streams already evacuated stay where they
        landed."""
        self._no_admit.discard(name)
        self._drain_evac.discard(name)

    # -- pump ----------------------------------------------------------------
    def poll(self) -> None:
        """One router pump: collect completions/hand-backs, detect dead
        replicas and fail over their journaled requests, sweep gossiped
        telemetry for gray stragglers (quarantine / canary / evacuate),
        advance live migrations (disagg + evacuations), dispatch."""
        self._collect()
        self._check_leases()
        self._gray_sweep()
        self._migrate()
        self._dispatch()

    def join(self, timeout: float = 60.0,
             poll_interval: float = 0.002) -> Dict[int, FleetRequest]:
        """Pump until every submitted request is terminal (the no-hang
        contract: a TimeoutError here is a failed chaos drill, not a
        wedge). Returns {rid: FleetRequest}."""
        deadline = time.monotonic() + timeout
        while True:
            self.poll()
            if all(r.done for r in self._reqs.values()):
                return dict(self._done)
            if time.monotonic() > deadline:
                stuck = sorted(r.rid for r in self._reqs.values()
                               if not r.done)
                raise TimeoutError(
                    f"fleet join timed out after {timeout}s with "
                    f"{len(stuck)} request(s) outstanding: {stuck[:8]}")
            time.sleep(poll_interval)

    # -- collection -----------------------------------------------------------
    def _finish(self, fr: FleetRequest, status: str,
                tokens: Optional[List[int]] = None,
                error: Optional[str] = None) -> None:
        fr.status = status
        fr.tokens = list(fr._committed) if tokens is None else tokens
        fr.error = error
        fr._gen_req = None
        fr._journal = []
        fr._done_t = time.monotonic()
        self._done[fr.rid] = fr
        self.stats["completed"] += 1

    def _collect(self) -> None:
        for w in self.workers.values():
            for fr, gr in w.drain_completions():
                if fr.done or fr._gen_req is not gr:
                    # late completion from a replica already declared
                    # dead and failed over: the binding was cleared, so
                    # this attempt no longer owns delivery — dropping it
                    # is what makes completion exactly-once
                    continue
                self._finish(fr, gr.status,
                             tokens=fr._committed + list(gr.tokens),
                             error=gr.error)
                if fr.failovers and gr.status == "ok":
                    self.stats["requests_recovered"] += 1
            for fr in w.drain_returns():
                if fr.done:
                    continue
                if fr._probe is not None:
                    # a canary handed back by a draining replica has
                    # nothing to measure anymore — never re-dispatch it
                    self._finish(fr, "error", error="canary probe "
                                 "returned undone")
                    continue
                # drained replica handed it back untouched: requeue at
                # the FRONT of its tier (it has been waiting longest)
                fr.status = "queued"
                fr.replica = None
                self.stats["redispatched"] += 1
                self._tiers[fr.tier].appendleft(fr)

    # -- liveness + failover -------------------------------------------
    def _check_leases(self) -> None:
        now = time.monotonic()
        if now - self._state_t < self._state_every:
            return
        try:
            self._state = self._retry.call(self.registry.state)
            self._state_t = now
        except Exception:
            return      # stale view this pump; retry counters carry it
        for name, st in self._state.items():
            if st["retired"]:
                self._retired.add(name)
                continue
            if name in self._dead or st["fresh"]:
                continue
            if st["lease"] is None:
                # registered but no lease seen yet (first beat still in
                # flight on the store): not dead — and provably holding
                # no requests, since dispatch targets require a fresh
                # lease. Declaring it dead here would be permanent.
                continue
            if name not in self.workers:
                continue
            self._dead.add(name)
            self.stats["failovers"] += 1
            self._failover(name)

    def _failover(self, name: str) -> None:
        """A replica's lease expired mid-stream: recover every request it
        owned from the journal — complete, re-dispatch, or fail ALONE
        with "replica_lost"; never touch another request."""
        orphans = [fr for fr in self._reqs.values()
                   if fr.replica == name and not fr.done]
        now = time.monotonic()
        for fr in orphans:
            if fr._probe is not None:
                # a canary on a replica that then DIED: the hard-failure
                # path owns the replica now; the probe just ends
                self._finish(fr, "error", error="canary probe lost")
                continue
            try:
                faults.maybe_fail("router.failover", rid=fr.rid,
                                  replica=name)
            except Exception as e:
                self._finish(fr, "error", error=repr(e))
                continue
            # commit the stream: read the dead attempt's emitted tokens
            # from its engine binding DIRECTLY (a monotonically-growing
            # list — one snapshot, no copy to race), not from the
            # worker-tick journal: a falsely-declared-dead worker's tick
            # could rewrite the journal after this clear and resurrect
            # already-committed tokens into a later failover (a double
            # emit). The binding also covers tokens emitted after the
            # last tick. An inbox orphan (never engine-submitted) has no
            # binding and commits nothing.
            gr = fr._gen_req
            if gr is not None:
                fr._committed = fr._committed + list(gr.tokens)
            fr._journal = []
            fr._gen_req = None
            self._set_mig(fr, None)     # failover owns recovery; the
            fr.failovers += 1   # migration machine must not touch fr again
            if (len(fr._committed) >= fr.max_new_tokens
                    or (self.eos is not None
                        and self.eos in fr._committed)):
                # finished in the journal — the replica died between
                # emitting the last token and reporting
                self._finish(fr, "ok")
                if fr.failovers:
                    self.stats["requests_recovered"] += 1
                continue
            remaining = fr.wire_deadline(now)
            if remaining is not None \
                    and remaining <= self.reprefill_headroom_s:
                # the deadline cannot survive a re-prefill: fail alone
                # with a status that names the real cause
                self._finish(fr, "replica_lost",
                             error=f"replica {name} lost; "
                                   f"{remaining:.3f}s left")
                self.stats["replica_lost"] += 1
                continue
            if not self._budget.take():
                # retry budget exhausted: a correlated brown-out must
                # degrade to an honest loss, never a retry storm
                self.stats["budget_denials"] += 1
                self._finish(fr, "replica_lost",
                             error=f"replica {name} lost; retry "
                                   f"budget exhausted")
                self.stats["replica_lost"] += 1
                continue
            fr.status = "queued"
            fr.replica = None
            self.stats["redispatched"] += 1
            self._tiers[fr.tier].appendleft(fr)

    # -- disagg: live KV migration -------------------------------------
    def _role(self, name: str) -> str:
        """A replica's role as GOSSIPED on its lease (the router only
        ever sees what the store saw); the worker attribute is the
        pre-first-beat fallback."""
        role = ((self._state.get(name) or {}).get("lease")
                or {}).get("role")
        if role is None:
            role = getattr(self.workers.get(name), "role", "both")
        return role

    def _decode_ok(self, w) -> bool:
        """May `w` receive a migrated sequence right now? Alive, fresh
        lease, not draining/retired/dead/quarantined, decode-capable,
        has room."""
        if w is None or w.name in self._dead or not w.alive():
            return False
        if self._gray_state(w.name) in ("quarantined", "retired"):
            return False
        st = self._state.get(w.name)
        if st is None or not st["fresh"] or st["retired"]:
            return False
        if (st["lease"] or {}).get("draining"):
            return False
        if self._role(w.name) not in ("decode", "both"):
            return False
        return w.load() < w.capacity

    def _pick_decode(self, fr: FleetRequest):
        """Destination for `fr`'s migration: decode SPECIALISTS first
        (removing prefill interference is the point), 'both' as
        fallback, least-loaded within the preferred set; None = no
        legal destination, the sequence decodes on at the source."""
        cands = [w for w in self.workers.values() if self._decode_ok(w)
                 and w.name not in self._no_admit]
        if not cands:
            return None
        pure = [w for w in cands if self._role(w.name) == "decode"]
        return min(pure or cands, key=lambda w: w.load())

    def _set_mig(self, fr: FleetRequest, mig: Optional[dict]) -> None:
        """The one writer of fr._mig: keeps the in-flight index
        (`_migrating`) exactly in sync, so the advance loop never scans
        the full request table on a non-disagg fleet."""
        fr._mig = mig
        if mig is None:
            self._migrating.discard(fr.rid)
        else:
            self._migrating.add(fr.rid)

    def _migrate(self) -> None:
        """Advance every in-flight migration one step, then start new
        disagg steady-state migrations (single-pumper: _set_mig is the
        only writer of fr._mig outside _failover). A request on a
        prefill specialist becomes migration-ready once its prompt KV
        is built and it has streamed >= 1 token; the source parks +
        exports (serve-thread side: fleet.py _pump_migrations), the
        KVMigrator moves the blob, the destination imports + resumes,
        and the source discards its parked record only after confirmed
        delivery. Quarantine EVACUATIONS (started in _gray_sweep) ride
        the same advance loop with `mig["evac"]` set. EVERY failure
        mode along the way — handoff fault, transport fault, no/dead
        destination, delivery refusal — resolves by resuming at the
        source: degradation, never loss. A source that dies
        mid-migration is ordinary failover territory (_failover clears
        fr._mig and recovers from the journal)."""
        if not self._disagg and not self._migrating:
            return
        now = time.monotonic()
        for rid in sorted(self._migrating):
            fr = self._reqs.get(rid)
            if fr is None or fr._mig is None:
                self._migrating.discard(rid)
                continue
            mig = fr._mig
            if fr.done:
                # completion won the race with the park
                w = self.workers.get(mig["src"])
                if w is not None:
                    w.poll_migration(fr)    # discard a stale box
                self._set_mig(fr, None)
                continue
            if mig["src"] in self._dead:
                self._set_mig(fr, None)     # _failover recovered it
                continue
            src = self.workers.get(mig["src"])
            box = src.poll_migration(fr) if src is not None else None
            if box is None:
                continue            # park/export still in flight
            if "blob" not in box:
                self._set_mig(fr, None)     # done before park applied
                continue
            evac = bool(mig.get("evac"))
            dst = self.workers.get(mig["dst"])
            if not self._decode_ok(dst) or (evac and (
                    dst.name == mig["src"] or not getattr(
                        dst.engine, "_host_tier", False))):
                dst = (self._pick_evac_dst(fr, mig["src"]) if evac
                       else self._pick_decode(fr))   # re-pick: dst moved
            delivered = False
            if dst is not None:
                try:
                    blob = self._migrator.transfer(box["blob"],
                                                   rid=fr.rid)
                    delivered = dst.deliver_migration(fr, blob)
                except Exception:
                    delivered = False
            src.finish_migration(fr, ok=delivered)
            if not delivered:
                self.stats["migrations_failed"] += 1
                if evac:
                    self.stats["evacuations_failed"] += 1
                fr._no_migrate = True
                self._set_mig(fr, None)
                continue
            stall_ms = (time.monotonic() - mig["t0"]) * 1e3
            fr.replica = dst.name
            fr.migrated += 1
            self._set_mig(fr, None)
            self.stats["migrations"] += 1
            if evac:
                self.stats["evacuations"] += 1
            self.stats["migration_stall_ms"] += stall_ms
            dst.mig_stats["migration_stall_ms"] += stall_ms
        if not self._disagg:
            return
        for fr in list(self._reqs.values()):
            if (fr.done or fr.status != "dispatched" or fr._no_migrate
                    or fr._mig is not None or fr._probe is not None):
                continue
            src_name = fr.replica
            if src_name in self._dead \
                    or self._role(src_name) != "prefill":
                continue
            src = self.workers.get(src_name)
            if src is None or not src.migration_ready(fr):
                continue
            dst = self._pick_decode(fr)
            if dst is None:
                continue    # no destination: decode at source
            try:
                faults.maybe_fail("router.handoff", rid=fr.rid,
                                  src=src_name, dst=dst.name)
            except Exception:
                # a faulted handoff fails ONLY this request's
                # migration; the stream decodes on at the source
                self.stats["handoff_faults"] += 1
                fr._no_migrate = True
                continue
            if src.begin_migration(fr):
                self._set_mig(fr, {"src": src_name, "dst": dst.name,
                                   "t0": now})

    # -- gray-failure defense ------------------------------------------
    def _gray_state(self, name: str) -> str:
        rec = self._gray.get(name)
        return rec["state"] if rec else "ok"

    def _gray_rec(self, name: str) -> dict:
        return self._gray.setdefault(name, {
            "state": "ok", "streak": 0, "quarantined_t": None,
            "reinstated_t": None, "canary_ok": 0, "canary_fail": 0,
            "probe": None, "probe_samples0": 0, "probe_t": 0.0})

    @staticmethod
    def _gray_metric(tel: dict) -> Optional[float]:
        """One straggler score per replica from its gossiped telemetry:
        the WORST of inter-token EWMA and tick-duration EWMA — a stall
        shows in tick duration even when no tokens flow, and in
        inter-token gaps even when ticks are cheap."""
        vals = [v for v in (tel.get("itl_ewma_ms"),
                            tel.get("tick_ms_ewma")) if v is not None]
        return max(vals) if vals else None

    def _gray_sweep(self) -> None:
        """Score every replica FLEET-RELATIVELY against the median of
        its same-role healthy peers and walk the quarantine state
        machine. Verdicts advance once per lease view (not per poll),
        so the streak hysteresis counts independent observations.
        Detection needs >= 2 healthy same-role peers with telemetry —
        a 2-replica fleet has no quorum to outvote a straggler, and
        cross-role comparison would flag every prefill specialist for
        having a prefill latency profile.

        Scale-down drains do NOT need the quorum: their evacuations are
        triggered by membership (the `_drain_evac` set), not by a
        verdict, so the sweep still runs for them when gray detection
        itself is off or under-quorum."""
        if self._gray_factor <= 0 or len(self.workers) < 3:
            if self._drain_evac:
                self._evacuate(time.monotonic())
            return
        if self._state_t == self._gray_last_t:
            if self._drain_evac:    # drain evac: every poll, no verdict
                self._evacuate(time.monotonic())
            return
        self._gray_last_t = self._state_t
        now = time.monotonic()
        mets: Dict[str, float] = {}
        for name in self.workers:
            st = self._state.get(name)
            if (st is None or not st["fresh"] or st["retired"]
                    or name in self._dead):
                continue
            if (st["lease"] or {}).get("draining"):
                continue
            m = self._gray_metric(
                (st["lease"] or {}).get("telemetry") or {})
            if m is not None:
                mets[name] = m
        cooldown = (2.0 * self.registry.lease_ttl
                    if self.GRAY_COOLDOWN_S is None
                    else self.GRAY_COOLDOWN_S)
        for name, w in self.workers.items():
            rec = self._gray_rec(name)
            if rec["state"] == "retired" or name in self._dead:
                continue
            peers = [v for n, v in mets.items()
                     if n != name and self._role(n) == self._role(name)
                     and self._gray_state(n) in ("ok", "suspect")]
            if rec["state"] == "quarantined":
                self._canary(name, w, rec, mets.get(name), peers, now)
                continue
            m = mets.get(name)
            if m is None or len(peers) < 2:
                rec["state"], rec["streak"] = "ok", 0
                continue
            if rec["reinstated_t"] is not None \
                    and now - rec["reinstated_t"] < cooldown:
                continue    # flap damping: fresh reinstatement holds
            thr = self._gray_factor * max(_median(peers), 0.1)
            if m <= thr:
                rec["state"], rec["streak"] = "ok", 0
                continue
            rec["state"] = "suspect"
            rec["streak"] += 1
            if rec["streak"] < self.GRAY_STREAK:
                continue
            try:
                faults.maybe_fail("router.quarantine", replica=name,
                                  metric=m, median=_median(peers))
            except Exception:
                # a faulted quarantine skips THIS verdict — the replica
                # keeps serving (pre-defense behavior), detection may
                # re-flag it on later evidence
                self.stats["quarantine_faults"] += 1
                rec["state"], rec["streak"] = "ok", 0
                continue
            rec.update(state="quarantined", quarantined_t=now,
                       canary_ok=0, canary_fail=0, probe=None,
                       probe_t=0.0)
            self.stats["quarantines"] += 1
        self._evacuate(now)

    def _canary(self, name: str, w, rec: dict, m: Optional[float],
                peers: List[float], now: float) -> None:
        """Quarantined-replica probation. Once the replica is empty of
        real work (evacuated or finished), tiny canary probes keep its
        telemetry alive; each completed probe is judged by the SAME
        fleet-relative rule that quarantined it (once the probe's
        tokens have reached the gossip). GRAY_CANARY_PASSES consecutive
        healthy verdicts reinstate — with a detection cooldown so a
        noisy neighbor can't flap — and GRAY_CANARY_LIMIT cumulative
        failures retire the replica for good (terminate(): drain +
        retirement marker)."""
        if not w.alive():
            return      # the hard-failure path owns it now
        tel = ((self._state.get(name) or {}).get("lease")
               or {}).get("telemetry") or {}
        if rec["probe"] is not None:
            fr = self._reqs.get(rec["probe"])
            if fr is None or not fr.done:
                return              # probe still streaming
            fresh = int(tel.get("samples") or 0) > rec["probe_samples0"]
            if not fresh and now - (fr._done_t or now) < 2.0:
                return  # wait for the probe's tokens to reach gossip
            rec["probe"] = None
            if m is None or len(peers) < 2:
                return  # no quorum to judge: stay quarantined
            thr = self._gray_factor * max(_median(peers), 0.1)
            if fr.status == "ok" and m <= thr:
                rec["canary_ok"] += 1
                if rec["canary_ok"] >= self.GRAY_CANARY_PASSES:
                    rec.update(state="ok", streak=0, reinstated_t=now,
                               quarantined_t=None)
                    self.stats["reinstated"] += 1
            else:
                rec["canary_fail"] += 1
                rec["canary_ok"] = 0
                if rec["canary_fail"] >= self.GRAY_CANARY_LIMIT:
                    rec["state"] = "retired"
                    self.stats["gray_retired"] += 1
                    try:
                        w.terminate()
                    except Exception:
                        pass
            return
        if now - rec["probe_t"] < self.GRAY_PROBE_GAP_S:
            return
        if any(not r.done and r.replica == name and r._probe is None
               for r in self._reqs.values()):
            return      # live sequences still evacuating / finishing
        fr = FleetRequest(self._next_rid,
                          np.zeros(self.GRAY_PROBE_TOKENS, np.int32),
                          self.GRAY_PROBE_TOKENS, None,
                          self.n_tiers - 1, now)
        fr._probe = name
        self._next_rid += 1
        self._reqs[fr.rid] = fr
        if w.offer(fr):     # direct offer: probes bypass admission
            fr.status = "dispatched"
            fr.replica = name
            rec.update(probe=fr.rid, probe_t=now,
                       probe_samples0=int(tel.get("samples") or 0))
            self.stats["canary_probes"] += 1
        else:
            self._finish(fr, "error", error="canary probe refused")

    def _pick_evac_dst(self, fr: FleetRequest, src_name: str):
        """Destination for an evacuation: healthy (not quarantined —
        _decode_ok checks), decode-capable, host-tiered (import_parked
        lands in the host arena), with room; least-loaded wins, never
        the source."""
        cands = [w for w in self.workers.values()
                 if w.name != src_name and self._decode_ok(w)
                 and w.name not in self._no_admit
                 and getattr(w.engine, "_host_tier", False)]
        return min(cands, key=lambda w: w.load()) if cands else None

    def _evacuate(self, now: float) -> None:
        """Proactively move every live sequence off quarantined
        replicas onto healthy peers via the migration path (park
        -> export -> KVMigrator -> import -> resume: exactly ONE
        recomputed token, `prefill_tokens_admitted == resumes` still
        holds on the destination). Each evacuation spends a retry-
        budget token; a denial leaves the stream decoding at the slow
        source (the bucket refills — it may go next sweep), and every
        hard failure pins it there via _no_migrate: degradation, never
        loss."""
        if not self._drain_evac and not any(
                r["state"] == "quarantined" for r in self._gray.values()):
            return
        for fr in list(self._reqs.values()):
            if (fr.done or fr.status != "dispatched" or fr._no_migrate
                    or fr._mig is not None or fr._probe is not None):
                continue
            # two evacuation triggers share this sweep: quarantined
            # stragglers (gray defense) and scale-down drains (elastic
            # autoscaling) — same machinery, same one-token proof
            if (self._gray_state(fr.replica) != "quarantined"
                    and fr.replica not in self._drain_evac):
                continue
            src = self.workers.get(fr.replica)
            if (src is None or not src.alive()
                    or not getattr(src.engine, "_host_tier", False)):
                continue    # no host tier: no evacuation primitive
            if not src.migration_ready(fr):
                continue    # not ready yet: next sweep
            dst = self._pick_evac_dst(fr, fr.replica)
            if dst is None:
                continue
            try:
                faults.maybe_fail("router.evacuate", rid=fr.rid,
                                  src=fr.replica, dst=dst.name)
            except Exception:
                # a faulted evacuation pins ONLY this stream to its
                # (slow) source — token-identical, just late
                self.stats["evacuate_faults"] += 1
                fr._no_migrate = True
                continue
            if not self._budget.take():
                self.stats["budget_denials"] += 1
                continue
            if src.begin_migration(fr):
                self._set_mig(fr, {"src": fr.replica, "dst": dst.name,
                                   "t0": now, "evac": True})

    # -- dispatch -------------------------------------------------------
    def _targets(self) -> List[object]:
        out = []
        for name, w in self.workers.items():
            if name in self._dead or not w.alive():
                continue
            if self._gray_state(name) in ("quarantined", "retired"):
                continue    # no new admissions while under quarantine
            if name in self._no_admit:
                continue    # draining out for scale-down
            st = self._state.get(name)
            if st is None or not st["fresh"] or st["retired"]:
                continue
            if (st["lease"] or {}).get("draining"):
                continue
            out.append(w)
        return out

    def _score(self, chains: List[str], lease: dict) -> int:
        digest = set((lease or {}).get("digest") or ())
        depth = 0
        for h in chains:
            if h not in digest:
                break
            depth += 1
        return depth

    def _pick(self, fr: FleetRequest, targets: List[object]):
        """(worker, route) — route names which steering arm chose it:
        "adapter" (the replica already holds the request's adapter —
        the gossiped ``adapters_resident`` list, so dispatching there
        skips a host->HBM swap stall), "affinity" (deepest gossiped
        prefix-digest match), or "least_loaded". Adapter affinity
        outranks prefix affinity for adapter'd requests: an adapter
        upload costs more than a re-prefilled prefix."""
        room = [w for w in targets if w.load() < w.capacity]
        if not room:
            return None, None
        if self._disagg:
            # new admissions land on prefill SPECIALISTS (the decode
            # tier stays interference-free — migration brings the
            # stream there once its prompt KV is built); 'both' is the
            # second choice, and a decode specialist takes fresh work
            # only when nothing else has room (availability beats
            # specialization: failover re-dispatches must land even
            # when only the decode tier survives)
            pre = [w for w in room if self._role(w.name) == "prefill"]
            both = [w for w in room if self._role(w.name) == "both"]
            room = pre or both or room
        if fr.adapter_id is not None:
            aid = str(fr.adapter_id)
            holders = [
                w for w in room
                if aid in (((self._state.get(w.name) or {}).get("lease")
                            or {}).get("adapters_resident") or ())]
            if holders:
                return min(holders, key=lambda w: w.load()), "adapter"
        if self._affinity:
            chains = page_hash_chain(fr.wire_prompt(), self.page_size)
            scored = [(self._score(
                chains, (self._state.get(w.name) or {}).get("lease")), w)
                for w in room]
            best = max(s for s, _ in scored)
            if best > 0:
                cands = [w for s, w in scored if s == best]
                return min(cands, key=lambda w: w.load()), "affinity"
        return min(room, key=lambda w: w.load()), "least_loaded"

    def _dispatch(self) -> None:
        """Drain tiers strictly in priority order until the fleet is out
        of room — an interactive request is never stuck behind batch
        traffic, and a full fleet is backpressure, not an error."""
        targets = self._targets()
        now = time.monotonic()
        for tier in range(self.n_tiers):
            q = self._tiers[tier]
            while q:
                fr = q[0]
                if fr.done:             # shed while queued
                    q.popleft()
                    continue
                rem = fr.wire_deadline(now)
                if rem is not None and rem <= 0:
                    # expired waiting in the tier queue: same verdict the
                    # engine's admission gives, without wasting a dispatch
                    q.popleft()
                    self._finish(fr, "timeout")
                    continue
                w, route = self._pick(fr, targets)
                if w is None:
                    return              # fleet-wide backpressure
                try:
                    ok = self._retry.call(self._offer, fr, w)
                except Exception as e:
                    q.popleft()
                    self._finish(fr, "error", error=repr(e))
                    continue
                if not ok:
                    return              # target filled between polls
                q.popleft()
                fr.status = "dispatched"
                fr.replica = w.name
                self.stats["dispatched"] += 1
                self.stats[{"adapter": "adapter_routed",
                            "affinity": "affinity_routed"}.get(
                    route, "least_loaded_routed")] += 1

    @staticmethod
    def _offer(fr: FleetRequest, w) -> bool:
        faults.maybe_fail("router.dispatch", rid=fr.rid, replica=w.name)
        return w.offer(fr)

    # -- observability --------------------------------------------------------
    def prefix_hit_rate(self) -> float:
        """Fleet-wide token-weighted prefix hit rate, aggregated over the
        live engines (the number prefix-affinity routing maximizes)."""
        matched = admitted = 0
        for w in self.workers.values():
            st = w.engine.stats
            matched += st.get("prefix_tokens_matched", 0)
            admitted += st.get("prefill_tokens_admitted", 0)
        tot = matched + admitted
        return matched / tot if tot else 0.0

    def fleet_health(self) -> dict:
        """The health_snapshot()["fleet"] record (reliability/health.py):
        generation, membership, per-replica lease/digest ages, failover
        and shed counters — what an operator needs to answer "is the
        fleet routing, who died, what got shed"."""
        leases = {}
        for name, st in self._state.items():
            lease = st.get("lease") or {}
            leases[name] = {
                "fresh": st["fresh"], "retired": st["retired"],
                "dead": name in self._dead,
                "role": self._role(name),
                "age_s": lease.get("age_s"),
                # the digest rides the lease, so its age IS the lease age
                "digest_age_s": (lease.get("age_s")
                                 if lease.get("digest") else None),
                "digest_entries": len(lease.get("digest") or ()),
                "queue_depth": lease.get("queue_depth"),
                "active_slots": lease.get("active_slots"),
                "draining": lease.get("draining"),
                "adapters_resident": list(
                    lease.get("adapters_resident") or ()),
            }
        return {
            "job": self.registry.job_id,
            "generation": self.registry.generation,
            "replica_count": len(self.workers),
            "alive": sorted(n for n, st in self._state.items()
                            if st["fresh"] and not st["retired"]
                            and n not in self._dead),
            "dead": sorted(self._dead),
            "retired": sorted(self._retired),
            "leases": leases,
            "outstanding": sum(not r.done for r in self._reqs.values()),
            "queued_by_tier": {t: len(q)
                               for t, q in enumerate(self._tiers)},
            "failovers": self.stats["failovers"],
            "requests_recovered": self.stats["requests_recovered"],
            "replica_lost": self.stats["replica_lost"],
            "shed_by_tier": dict(self.stats["shed_by_tier"]),
            # elastic autoscaling: which replicas are draining out
            # and whether brownout L3 is refusing the lowest tier(s)
            "draining_out": sorted(self._drain_evac),
            "brownout_shed_tiers": self.brownout_shed_tiers,
            "prefix_hit_rate": self.prefix_hit_rate(),
            "disagg": self._disagg,
            "migrations": self.stats["migrations"],
            "migrations_failed": self.stats["migrations_failed"],
            "migration_stall_ms": self.stats["migration_stall_ms"],
            # gray-failure defense: what an operator needs to answer "who is
            # quarantined, what moved, is the budget holding"
            "quarantined_now": sum(
                1 for r in self._gray.values()
                if r["state"] == "quarantined"),
            "gray": {
                "quarantined_now": sorted(
                    n for n, r in self._gray.items()
                    if r["state"] == "quarantined"),
                "quarantines": self.stats["quarantines"],
                "evacuations": self.stats["evacuations"],
                "evacuations_failed": self.stats["evacuations_failed"],
                "canary_probes": self.stats["canary_probes"],
                "reinstated": self.stats["reinstated"],
                "retired": self.stats["gray_retired"],
                "budget_denials": self.stats["budget_denials"],
                "retry_budget_left": self._budget.left(),
                "detect_factor": self._gray_factor,
                "per_replica": {
                    n: {"state": r["state"], "streak": r["streak"],
                        "canary_ok": r["canary_ok"],
                        "canary_fail": r["canary_fail"]}
                    for n, r in self._gray.items()
                    if r["state"] != "ok" or r["streak"]},
            },
        }
