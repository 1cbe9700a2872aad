"""Trace-driven load for the serving fleet (``paddle_tpu/inference/loadgen.py``).

A burst that saturates every replica ends in queue growth and deadline
shedding unless capacity grows or service degrades deliberately. This
module is the traffic half of that loop; ``inference/autoscaler.py`` is
the control half. It is the JAX package's module, torch-free on both
sides: the same ``TraceSpec`` gives the same ``trace_bytes`` in both
packages.

``TraceSpec`` -> a deterministic request stream. A frozen spec fully
determines the trace: same seed => byte-identical stream (``trace_bytes``
is the canonical serialization). The stream has the shapes production
traffic has:

- heavy-tailed prompt/output lengths (lognormal body, clipped);
- Zipf tenant skew over many tenants, each tenant owning a shared prompt
  *prefix* (work for prefix-affinity routing and the prefix cache) and
  optionally an adapter id (multi-LoRA steering);
- diurnal rate modulation plus square-wave burst phases;
- a per-request deadline tier drawn from a weighted mix.

``run_trace(router, trace)`` replays a trace against a live
:class:`~.router.FleetRouter` in (scaled) real time, pumping
``router.poll()`` (and, when given, ``autoscaler.step()``) while it
samples per-request first-token times and queue ages. The report is per
deadline tier: p50/p99 time-to-first-token and inter-token gap,
ok/shed/timeout/lost counts. A fleet that defends its interactive tier by
shedding batch is healthy; one number averaged over both would hide it.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Dict, List, Optional

import numpy as np

__all__ = ["TraceSpec", "TraceRequest", "generate_trace", "trace_bytes",
           "run_trace"]


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    """Everything that determines a trace, and nothing else.

    Frozen + JSON-roundtrippable: a chaos drill records the spec, and a
    post-mortem regenerates the exact request stream from it (the
    replay-determinism property test pins this both across generator
    instances and across a serialize/deserialize roundtrip)."""

    seed: int = 0
    n_requests: int = 32
    #: arrival horizon (seconds of *trace* time — the driver's
    #: ``time_scale`` stretches or compresses it at replay)
    horizon_s: float = 4.0
    #: mean arrival rate (requests/s) before modulation
    base_rate: float = 16.0
    #: one diurnal cycle spans the horizon; rate swings +/- this fraction
    diurnal_amp: float = 0.5
    #: square-wave burst phases: (start_frac, end_frac, multiplier)
    bursts: tuple = ((0.4, 0.7, 4.0),)
    # -- heavy-tailed lengths (lognormal body, clipped to [min, cap]) --
    prompt_mean: float = 12.0
    prompt_sigma: float = 0.6
    prompt_min: int = 4
    prompt_cap: int = 48
    new_mean: float = 6.0
    new_sigma: float = 0.5
    new_min: int = 2
    new_cap: int = 12
    # -- tenant skew ----------------------------------------------------
    n_tenants: int = 8
    zipf_alpha: float = 1.2
    #: shared per-tenant prompt prefix length (prefix-affinity fodder)
    tenant_prefix_len: int = 6
    #: adapter-id space; 0 = no request carries an adapter
    n_adapters: int = 0
    # -- deadline tiers: ((deadline_s | None, weight), ...) -------------
    tiers: tuple = ((1.0, 0.25), (10.0, 0.5), (None, 0.25))
    vocab: int = 128

    def to_json(self) -> str:
        """Canonical (sorted-key) JSON — the replay contract's wire form."""
        d = dataclasses.asdict(self)
        d["bursts"] = [list(b) for b in self.bursts]
        d["tiers"] = [list(t) for t in self.tiers]
        return json.dumps(d, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "TraceSpec":
        d = json.loads(s)
        d["bursts"] = tuple(tuple(b) for b in d.get("bursts", ()))
        d["tiers"] = tuple((None if t[0] is None else float(t[0]),
                            float(t[1])) for t in d.get("tiers", ()))
        return cls(**d)


@dataclasses.dataclass
class TraceRequest:
    """One request of a trace: arrival time (trace seconds from t=0),
    prompt token ids, decode budget, deadline tier and tenant identity."""

    idx: int
    t: float
    prompt: tuple                    # token ids (ints)
    max_new: int
    deadline_s: Optional[float]
    tenant: int
    adapter_id: Optional[int]


def _rate_at(spec: TraceSpec, t: float) -> float:
    """Instantaneous arrival rate: diurnal sine over the horizon times
    any burst phase covering ``t``."""
    frac = (t / spec.horizon_s) if spec.horizon_s > 0 else 0.0
    rate = spec.base_rate * (
        1.0 + spec.diurnal_amp * np.sin(2.0 * np.pi * frac))
    for (f0, f1, mult) in spec.bursts:
        if f0 <= frac < f1:
            rate *= mult
    return max(rate, 1e-6)


def _zipf_pick(rng, n: int, alpha: float) -> int:
    """Zipf-skewed tenant draw over ranks 1..n (p ~ 1/rank^alpha) —
    explicit inverse-CDF so determinism never depends on numpy's
    rejection-sampler internals."""
    w = 1.0 / np.power(np.arange(1, n + 1, dtype=np.float64), alpha)
    cdf = np.cumsum(w / w.sum())
    return int(np.searchsorted(cdf, rng.random(), side="right"))


def _clipped_lognormal(rng, mean: float, sigma: float,
                       lo: int, hi: int) -> int:
    """Heavy-tailed length draw: lognormal with the given *linear* mean,
    clipped to [lo, hi]."""
    mu = np.log(max(mean, 1e-6)) - 0.5 * sigma * sigma
    return int(np.clip(round(rng.lognormal(mu, sigma)), lo, hi))


def generate_trace(spec: TraceSpec) -> List[TraceRequest]:
    """Materialize the deterministic request stream for ``spec``.

    One PCG64 stream seeded from ``spec.seed`` drives every draw in a
    fixed order, so two generator instances (or a roundtripped spec)
    produce identical streams — the replay contract the chaos drills
    depend on."""
    rng = np.random.Generator(np.random.PCG64(int(spec.seed)))
    # tenant prefixes drawn FIRST at a fixed count, so a request's
    # prompt never depends on which tenants earlier requests happened
    # to draw
    prefixes = [
        tuple(int(x) for x in rng.integers(
            0, spec.vocab, size=spec.tenant_prefix_len))
        for _ in range(max(spec.n_tenants, 1))]
    tier_w = np.asarray([w for _, w in spec.tiers], np.float64)
    tier_cdf = np.cumsum(tier_w / tier_w.sum())
    out: List[TraceRequest] = []
    t = 0.0
    for i in range(spec.n_requests):
        t += float(rng.exponential(1.0 / _rate_at(spec, t)))
        tenant = _zipf_pick(rng, max(spec.n_tenants, 1), spec.zipf_alpha)
        p_len = _clipped_lognormal(rng, spec.prompt_mean,
                                   spec.prompt_sigma, spec.prompt_min,
                                   spec.prompt_cap)
        n_new = _clipped_lognormal(rng, spec.new_mean, spec.new_sigma,
                                   spec.new_min, spec.new_cap)
        tail_len = max(1, p_len - spec.tenant_prefix_len)
        tail = tuple(int(x) for x in rng.integers(
            0, spec.vocab, size=tail_len))
        deadline = spec.tiers[int(np.searchsorted(
            tier_cdf, rng.random(), side="right"))][0]
        adapter = (tenant % spec.n_adapters
                   if spec.n_adapters > 0 else None)
        out.append(TraceRequest(
            idx=i, t=t, prompt=prefixes[tenant] + tail, max_new=n_new,
            deadline_s=None if deadline is None else float(deadline),
            tenant=tenant, adapter_id=adapter))
    return out


def trace_bytes(trace: List[TraceRequest]) -> bytes:
    """Canonical serialization of a generated stream — the byte string
    the same-seed => byte-identical property compares."""
    rows = [[r.idx, round(r.t, 9), list(r.prompt), r.max_new,
             r.deadline_s, r.tenant, r.adapter_id] for r in trace]
    return json.dumps(rows, sort_keys=True).encode()


# --------------------------------------------------------------- driver

def _pct(vals: List[float], q: float) -> Optional[float]:
    if not vals:
        return None
    s = sorted(vals)
    return s[min(len(s) - 1, int(round(q * (len(s) - 1))))]


def _tokens_seen(fr) -> int:
    """Tokens a request has provably emitted so far: the committed
    journal prefix plus the live engine binding's monotonically-growing
    token list (the same two sources failover commits from)."""
    gr = fr._gen_req
    return len(fr._committed) + (len(gr.tokens) if gr is not None else 0)


def run_trace(router, trace: List[TraceRequest], *,
              autoscaler=None, time_scale: float = 1.0,
              poll_interval: float = 0.001,
              settle_timeout_s: float = 120.0,
              sample_every_s: float = 0.05) -> Dict:
    """Replay ``trace`` against ``router`` in (scaled) real time.

    Submits each request when its scaled arrival time comes due while
    pumping ``router.poll()`` — and ``autoscaler.step()`` when one is
    given, which is how the elastic drills close the loop — then pumps
    until every request is terminal. ``time_scale`` > 1 stretches the
    trace (slower arrivals), < 1 compresses it.

    Returns the report dict: ``tiers`` (per-tier n/ok/shed/timeout/
    replica_lost + p50/p99 TTFT and inter-token ms), ``queue_curve``
    (time-sampled (t, queued, oldest_age_s)), ``shed`` total, and
    ``completed`` — {trace idx: (status, tokens)} for request-by-request
    parity against another replay of the same trace."""
    t0 = time.monotonic()
    rid_of: Dict[int, int] = {}
    first_tok: Dict[int, float] = {}
    last_tok: Dict[int, float] = {}
    n_tok: Dict[int, int] = {}
    queue_curve: List[tuple] = []
    next_sample = 0.0
    i = 0

    def pump(now: float) -> None:
        nonlocal next_sample
        router.poll()
        if autoscaler is not None:
            autoscaler.step()
        for idx, rid in rid_of.items():
            fr = router.request(rid)
            seen = _tokens_seen(fr) if not fr.done else len(fr.tokens)
            if seen > n_tok.get(idx, 0):
                n_tok[idx] = seen
                last_tok[idx] = now
                first_tok.setdefault(idx, now)
        if now >= next_sample:
            next_sample = now + sample_every_s
            oldest = max((now - (fr.submit_t - t0)
                          for q in router._tiers for fr in q),
                         default=0.0) if router._queued() else 0.0
            queue_curve.append((round(now, 4), router._queued(),
                                round(oldest, 4)))

    while i < len(trace):
        now = time.monotonic() - t0
        while i < len(trace) and trace[i].t * time_scale <= now:
            r = trace[i]
            rid_of[r.idx] = router.submit(
                np.asarray(r.prompt, np.int32), r.max_new,
                deadline_s=r.deadline_s, adapter_id=r.adapter_id)
            i += 1
        pump(now)
        time.sleep(poll_interval)
    deadline = time.monotonic() + settle_timeout_s
    while True:
        pump(time.monotonic() - t0)
        if all(router.request(rid).done for rid in rid_of.values()):
            break
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"trace replay did not settle in {settle_timeout_s}s: "
                f"{sum(not router.request(r).done for r in rid_of.values())}"
                f" request(s) outstanding")
        time.sleep(poll_interval)

    # ---- report -------------------------------------------------------
    completed = {r.idx: (router.request(rid_of[r.idx]).status,
                         list(router.request(rid_of[r.idx]).tokens))
                 for r in trace}
    tiers = _finalize_tiers(trace, rid_of, router, first_tok, last_tok,
                            n_tok, time_scale)
    return {
        "tiers": tiers,
        "queue_curve": queue_curve,
        "shed": sum(rec["shed"] for rec in tiers.values()),
        "completed": completed,
        "wall_s": time.monotonic() - t0,
    }


def _finalize_tiers(trace, rid_of, router, first_tok, last_tok, n_tok,
                    time_scale) -> Dict[int, dict]:
    tiers: Dict[int, dict] = {}
    for r in trace:
        fr = router.request(rid_of[r.idx])
        rec = tiers.setdefault(fr.tier, {
            "n": 0, "ok": 0, "shed": 0, "timeout": 0,
            "replica_lost": 0, "error": 0, "ttft": [], "itl": []})
        rec["n"] += 1
        key = fr.status if fr.status in ("ok", "shed", "timeout",
                                         "replica_lost") else "error"
        rec[key] += 1
        if r.idx in first_tok:
            rec["ttft"].append((first_tok[r.idx] - r.t * time_scale) * 1e3)
            if n_tok.get(r.idx, 0) >= 2:
                rec["itl"].append(
                    (last_tok[r.idx] - first_tok[r.idx]) * 1e3
                    / (n_tok[r.idx] - 1))
    for rec in tiers.values():
        ttft, itl = rec.pop("ttft"), rec.pop("itl")
        rec["ttft_p50_ms"] = _pct(ttft, 0.5)
        rec["ttft_p99_ms"] = _pct(ttft, 0.99)
        rec["itl_p50_ms"] = _pct(itl, 0.5)
        rec["itl_p99_ms"] = _pct(itl, 0.99)
    return tiers
