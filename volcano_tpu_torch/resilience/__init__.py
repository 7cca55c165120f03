"""Resilience seams of the scheduling cycle.

- ``breaker.CircuitBreaker`` — the device-solver circuit breaker
  (device -> host-oracle degradation ladder; installed on the cache by the
  Scheduler, consumed by actions/allocate.py);
- ``watchdog.ActionWatchdog`` — per-action deadline containment for the
  session loop (scheduler.py);
- ``faultinject.faults`` — the deterministic, seeded fault-injection
  harness behind the chaos seams (``solver_dispatch``, ``slow_action``,
  ``flatten_event``/``flatten_event_dup``, ``order_event``/
  ``order_event_dup``, ``bind_commit``, ``sidecar_solve``);
- ``recovery.BindIntentJournal`` / ``recovery.reconcile_bind_intents`` —
  the crash-safe bind write-ahead journal and the takeover
  reconciliation pass (wired by Scheduler.run_with_leader_election,
  fenced by client.store.FencedStore);
- ``transient.retry_transient`` — one re-send of a dispatch that failed
  with a transport error (never of a CUDA error).
"""

from .breaker import CircuitBreaker
from .faultinject import FaultError, FaultInjector, faults
from .recovery import BindIntentJournal, reconcile_bind_intents
from .transient import TRANSIENT_MARKERS, is_transient, retry_transient
from .watchdog import ActionTimeout, ActionWatchdog

__all__ = ["ActionTimeout", "ActionWatchdog", "BindIntentJournal",
           "CircuitBreaker", "FaultError", "FaultInjector", "faults",
           "reconcile_bind_intents", "TRANSIENT_MARKERS", "is_transient",
           "retry_transient"]
