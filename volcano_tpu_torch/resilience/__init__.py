"""Resilience seams of the scheduling cycle.

- ``breaker.CircuitBreaker`` — the device-solver circuit breaker
  (device -> host-oracle degradation ladder; installed on the cache by the
  Scheduler, consumed by actions/allocate.py);
- ``watchdog.ActionWatchdog`` — per-action deadline containment for the
  session loop (scheduler.py);
- ``faultinject.faults`` — the deterministic, seeded fault-injection
  harness behind the chaos seams (``solver_dispatch``, ``slow_action``,
  ``flatten_event``/``flatten_event_dup``, ``order_event``/
  ``order_event_dup``, ``bind_commit``).
"""

from .breaker import CircuitBreaker
from .faultinject import FaultError, FaultInjector, faults
from .watchdog import ActionTimeout, ActionWatchdog

__all__ = ["ActionTimeout", "ActionWatchdog", "CircuitBreaker",
           "FaultError", "FaultInjector", "faults"]
