"""paddle_tpu_torch.reliability — fault injection, retry, health surface
(the port's own copy of ``paddle_tpu/reliability``).

- ``faults``: deterministic fault-injection registry. Production code
  plants named sites (``faults.maybe_fail("engine.park")``); the registry
  is empty by default so the sites cost one falsy-dict check. Armed via
  ``inject()``, the ``injected()`` context manager, or
  ``PADDLE_TPU_FAULTS=site:nth=2;...``.
- ``RetryPolicy``: bounded retries with exponential backoff + jitter, an
  overall deadline, and a retryable-exception filter; retry counts feed
  the process-wide ``retry_counters()`` table.
- ``health_snapshot()``: one bundle of live engine stats, tier, adapter
  and arena residency, retry counters, fault-registry state, the elastic
  view, the serving fleets, the disaggregation workers and the
  autoscalers.
"""

from . import faults  # noqa: F401
from .faults import FaultError, injected, inject, maybe_fail  # noqa: F401
from .health import (  # noqa: F401
    autoscaler_state, elastic_state, fleet_state, health_snapshot,
    note_elastic_event, note_watchdog_timeout, register_autoscaler,
    register_engine, register_fleet, watchdog_timeouts)
from .retry import (  # noqa: F401
    RetryError, RetryPolicy, bump_counter, reset_retry_counters,
    retry_counters)
