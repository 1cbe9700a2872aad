"""RetryPolicy — bounded retry with exponential backoff, jitter, deadline
(the port's own copy of ``paddle_tpu/reliability/retry.py``).

One policy object serves every transient-failure path: store RPCs, the
fleet registry, the router's dispatch, the serving engine's dispatch
gate. Max attempts, exponential backoff with full jitter, an overall
wall-clock deadline, and a retryable-exception filter so poison errors
(ValueError from corrupt state, KeyboardInterrupt) fail fast instead of
burning the deadline.

Every retry is counted into a process-global table keyed by the policy's
``name`` — ``retry_counters()`` feeds ``reliability.health_snapshot()`` so
an operator can see *where* the system is absorbing faults.

    policy = RetryPolicy(max_attempts=4, base_delay_s=0.05, name="store")
    policy.call(fn, *args)                      # or @policy.wrap
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

_lock = threading.Lock()
_counters: Dict[str, Dict[str, int]] = {}


def retry_counters() -> Dict[str, Dict[str, int]]:
    """{policy name: {"attempts", "retries", "failures", "gave_up"}}."""
    with _lock:
        return {k: dict(v) for k, v in _counters.items()}


def reset_retry_counters() -> None:
    with _lock:
        _counters.clear()


def _bump(name: str, key: str, delta: int = 1) -> None:
    with _lock:
        c = _counters.setdefault(
            name, {"attempts": 0, "retries": 0, "failures": 0, "gave_up": 0})
        c[key] += delta


def bump_counter(name: str, key: str, delta: int = 1) -> None:
    """Count a retry-table event from OUTSIDE a RetryPolicy — for loops
    that absorb failures themselves but must still show up degraded in
    health_snapshot()["retry_counters"] (e.g. the elastic heartbeat loop
    bumping `elastic.beat` failures instead of silently swallowing)."""
    if key not in ("attempts", "retries", "failures", "gave_up"):
        raise ValueError(f"unknown retry counter key {key!r}")
    _bump(name, key, delta)


class RetryError(RuntimeError):
    """All attempts exhausted; `__cause__` is the last underlying error."""

    def __init__(self, msg: str, attempts: int):
        super().__init__(msg)
        self.attempts = attempts


@dataclass
class RetryPolicy:
    """Declarative retry schedule. Attempt k (0-based retry index) sleeps
    `min(base * multiplier**k, max_delay)` scaled by full jitter in
    `[1-jitter, 1]`; the overall `deadline_s` bounds total wall time —
    an attempt whose backoff would cross the deadline is not made."""

    max_attempts: int = 3
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.1                      # fraction of the delay
    deadline_s: Optional[float] = None       # overall wall budget
    retryable: Tuple[type, ...] = (OSError, TimeoutError, ConnectionError)
    name: str = "default"
    on_retry: Optional[Callable[[int, BaseException], None]] = None
    # injectable for tests / simulated clocks
    sleep: Callable[[float], None] = field(default=time.sleep, repr=False)
    clock: Callable[[], float] = field(default=time.monotonic, repr=False)
    _rng: random.Random = field(default_factory=random.Random, repr=False)

    def delay_for(self, retry_index: int) -> float:
        d = min(self.base_delay_s * (self.multiplier ** retry_index),
                self.max_delay_s)
        if self.jitter > 0:
            d *= 1.0 - self.jitter * self._rng.random()
        return d

    def is_retryable(self, exc: BaseException) -> bool:
        from .faults import FaultError

        # injected faults are always "transient": the chaos harness must be
        # able to exercise any retry loop without picking magic exc types
        return isinstance(exc, self.retryable + (FaultError,))

    def call(self, fn: Callable, *args, **kwargs):
        """Run `fn` under the policy; returns its value or raises
        RetryError (retryable exhaustion) / the original (non-retryable)."""
        start = self.clock()
        last: Optional[BaseException] = None
        for attempt in range(1, max(1, self.max_attempts) + 1):
            _bump(self.name, "attempts")
            try:
                return fn(*args, **kwargs)
            except BaseException as e:
                last = e
                if not self.is_retryable(e):
                    _bump(self.name, "failures")
                    raise
                _bump(self.name, "failures")
                if attempt >= max(1, self.max_attempts):
                    break
                delay = self.delay_for(attempt - 1)
                if (self.deadline_s is not None
                        and self.clock() - start + delay > self.deadline_s):
                    _bump(self.name, "gave_up")
                    raise RetryError(
                        f"{self.name}: deadline {self.deadline_s}s exhausted "
                        f"after {attempt} attempt(s)", attempt) from e
                if self.on_retry is not None:
                    self.on_retry(attempt, e)
                _bump(self.name, "retries")
                self.sleep(delay)
        _bump(self.name, "gave_up")
        raise RetryError(
            f"{self.name}: giving up after {self.max_attempts} attempt(s): "
            f"{type(last).__name__}: {last}", self.max_attempts) from last

    def wrap(self, fn: Callable) -> Callable:
        def wrapped(*args, **kwargs):
            return self.call(fn, *args, **kwargs)

        wrapped.__name__ = getattr(fn, "__name__", "wrapped")
        wrapped.__doc__ = fn.__doc__
        return wrapped
