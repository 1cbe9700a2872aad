"""Deterministic fault-injection registry — the port's own copy of
``paddle_tpu/reliability/faults.py``, same grammar and environment variable.

Production code plants named *sites* — ``maybe_fail("engine.readback",
rid=...)`` — at the points where real systems die: store RPCs, the
serving engine's dispatch/readback, the fleet's heartbeat. The registry
is EMPTY by default and ``maybe_fail`` is then a single falsy-dict check,
so production paths pay effectively nothing.

Tests (or a chaos drill) arm sites with deterministic triggers:

    from paddle_tpu_torch.reliability import faults

    with faults.injected("engine.readback", nth=3):   # 3rd call raises
        engine.run()

    faults.inject("engine.readback", when=lambda ctx: ctx["rid"] == 7)
    faults.inject("store.get", p=0.01, seed=42)       # seeded Bernoulli
    faults.clear()

Env activation (no code change, e.g. a chaos canary in CI):

    PADDLE_TPU_FAULTS="engine.park:nth=2;store.get:p=0.05,seed=1"

Triggers are deterministic given (arm order, call order, seed): ``nth``
counts matching calls at the site, ``p`` draws from a
``random.Random(seed)`` private to the spec, ``when`` is an arbitrary
predicate over the call's context kwargs. ``times`` bounds how often a
spec fires (default: nth fires once, p/when fire unbounded). All counters
are thread-safe: sites live in serve and heartbeat threads, not just the
main thread.

Delay mode (gray failures): ``inject(site, delay_s=0.05, ...)`` makes a
firing spec STALL the caller instead of raising — the site sleeps
``delay_s`` seconds and then proceeds normally, which is how chaos makes
a replica slow-but-alive rather than dead. Delay specs compose with every
trigger and count in ``stats()``/``fired()`` like raising specs; the sleep
happens OUTSIDE the registry lock.
"""

from __future__ import annotations

import os
import random
import threading
import time
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional

_ENV_VAR = "PADDLE_TPU_FAULTS"


class FaultError(RuntimeError):
    """Default exception raised by a triggered fault site."""


class _Spec:
    def __init__(self, site: str, exc=None, nth: Optional[int] = None,
                 p: Optional[float] = None, seed: int = 0,
                 times: Optional[int] = None,
                 when: Optional[Callable[[dict], bool]] = None,
                 delay_s: Optional[float] = None):
        if nth is not None and nth < 1:
            raise ValueError(f"nth must be >= 1, got {nth}")
        if p is not None and not 0.0 <= p <= 1.0:
            raise ValueError(f"p must be in [0, 1], got {p}")
        if delay_s is not None and delay_s < 0:
            raise ValueError(f"delay_s must be >= 0, got {delay_s}")
        self.site = site
        self.exc = exc
        self.nth = nth
        self.p = p
        self.when = when
        self.delay_s = delay_s
        self.rng = random.Random(seed) if p is not None else None
        # nth-triggers are one-shot unless told otherwise; probabilistic /
        # predicate triggers keep firing until cleared
        self.times = times if times is not None else (
            1 if nth is not None else None)
        self.calls = 0      # matching calls seen by this spec
        self.fired = 0

    def should_fire(self, ctx: dict) -> bool:
        if self.times is not None and self.fired >= self.times:
            return False
        if self.when is not None and not self.when(ctx):
            return False
        self.calls += 1
        if self.nth is not None and self.calls != self.nth:
            return False
        if self.p is not None and self.rng.random() >= self.p:
            return False
        self.fired += 1
        return True

    def make_exc(self) -> BaseException:
        exc = self.exc
        if exc is None:
            return FaultError(f"injected fault at site {self.site!r}")
        if isinstance(exc, type) and issubclass(exc, BaseException):
            return exc(f"injected fault at site {self.site!r}")
        return exc


# reentrant: a user-supplied `when` predicate runs under this lock and may
# legitimately call back into the registry (e.g. cross-site triggers like
# when=lambda ctx: faults.fired("other.site") > 0)
_lock = threading.RLock()
_specs: Dict[str, List[_Spec]] = {}     # empty <=> disabled (the fast path)
_site_calls: Dict[str, int] = {}        # per-site maybe_fail() visit count
_site_fired: Dict[str, int] = {}


def inject(site: str, exc=None, nth: Optional[int] = None,
           p: Optional[float] = None, seed: int = 0,
           times: Optional[int] = None,
           when: Optional[Callable[[dict], bool]] = None,
           delay_s: Optional[float] = None) -> _Spec:
    """Arm `site`. With no trigger kwargs the site fires on every call.
    `delay_s` turns the spec into a DELAY: a firing call sleeps that many
    seconds and returns normally instead of raising (gray failure)."""
    spec = _Spec(site, exc, nth, p, seed, times, when, delay_s)
    with _lock:
        _specs.setdefault(site, []).append(spec)
    return spec


def clear(site: Optional[str] = None) -> None:
    """Disarm one site, or everything (also zeroes the hit counters)."""
    with _lock:
        if site is None:
            _specs.clear()
            _site_calls.clear()
            _site_fired.clear()
        else:
            _specs.pop(site, None)


@contextmanager
def injected(site: str, **kwargs):
    """Scoped arm: `with faults.injected("ckpt.write", nth=2): ...`"""
    spec = inject(site, **kwargs)
    try:
        yield spec
    finally:
        with _lock:
            lst = _specs.get(site)
            if lst is not None:
                try:
                    lst.remove(spec)
                except ValueError:
                    pass
                if not lst:
                    _specs.pop(site, None)


def enabled() -> bool:
    return bool(_specs)


def active_sites() -> List[str]:
    with _lock:
        return sorted(_specs)


def _trigger(site: str, ctx: dict) -> Optional[_Spec]:
    """The one locked trigger scan: counts the visit, returns the first
    firing spec (or None). should_fire/maybe_fail are thin shells so the
    trigger semantics can never diverge between them."""
    with _lock:
        specs = _specs.get(site)
        _site_calls[site] = _site_calls.get(site, 0) + 1
        if specs:
            for spec in specs:
                if spec.should_fire(ctx):
                    _site_fired[site] = _site_fired.get(site, 0) + 1
                    return spec
    return None


def should_fire(site: str, **ctx) -> bool:
    """Non-raising trigger check; `maybe_fail` is this + raise. A firing
    DELAY spec sleeps here and reports False — the site is slow, not
    failing, so callers must proceed down their success path."""
    if not _specs:              # disabled: one falsy-dict check, no lock
        return False
    spec = _trigger(site, ctx)
    if spec is not None and spec.delay_s is not None:
        time.sleep(spec.delay_s)        # outside the lock
        return False
    return spec is not None


def maybe_fail(site: str, **ctx) -> None:
    """The injection point: no-op unless `site` is armed and triggers.
    A firing delay spec sleeps `delay_s` and returns instead of raising
    (the site stalls — gray failure, not hard failure)."""
    if not _specs:              # zero-overhead production path
        return
    spec = _trigger(site, ctx)
    if spec is None:
        return
    if spec.delay_s is not None:
        time.sleep(spec.delay_s)        # outside the lock: a stalled
        return                          # site never blocks the registry
    raise spec.make_exc()


def stats() -> dict:
    """Snapshot for health_snapshot(): what is armed, what has fired."""
    with _lock:
        return {
            "enabled": bool(_specs),
            "active": sorted(_specs),
            "site_calls": dict(_site_calls),
            "site_fired": dict(_site_fired),
        }


def fired(site: str) -> int:
    with _lock:
        return _site_fired.get(site, 0)


def load_env(value: Optional[str] = None) -> int:
    """Arm sites from PADDLE_TPU_FAULTS (or an explicit string).

    Grammar: `site:key=val,key=val;site2:...` with keys
    nth/p/seed/times/delay_s.
    Returns the number of specs armed; raises ValueError on bad grammar.
    Called once at import (where malformed input is downgraded to a
    warning — the reliability layer's own knob must never make
    the import the thing that crashes); tests call it directly
    with a crafted string.
    """
    value = os.environ.get(_ENV_VAR, "") if value is None else value
    parsed = []        # parse EVERYTHING first: a typo in part 3 must not
    for part in value.split(";"):   # leave parts 1-2 silently armed (half
        part = part.strip()         # a chaos drill is worse than none)
        if not part:
            continue
        site, _, argstr = part.partition(":")
        kwargs: dict = {}
        for kv in argstr.split(","):
            kv = kv.strip()
            if not kv:
                continue
            k, _, v = kv.partition("=")
            k = k.strip()
            if k in ("p", "delay_s"):
                kwargs[k] = float(v)
            elif k in ("nth", "seed", "times"):
                kwargs[k] = int(v)
            else:
                raise ValueError(
                    f"{_ENV_VAR}: unknown trigger key {k!r} in {part!r}")
        # constructing the spec here also runs its range validation
        # (nth >= 1, p in [0, 1]) before anything is registered
        parsed.append(_Spec(site.strip(), **kwargs))
    with _lock:
        for spec in parsed:
            _specs.setdefault(spec.site, []).append(spec)
    return len(parsed)


try:
    load_env()
except ValueError as _e:
    import warnings as _warnings

    _warnings.warn(f"ignoring malformed {_ENV_VAR}: {_e}")
