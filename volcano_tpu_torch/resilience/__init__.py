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
  with a transport error (never of a CUDA error);
- ``overload.AdmissionGate`` — the store server's overload-protected
  front door: priority-lane admission (system/control/bulk/read) with
  per-client fair queuing, wire deadlines, typed ``OverloadedError``
  sheds with retry-after hints, and the client-side ``RetryBudget``
  (wired through client/server.py and honored by client/remote.py).
"""

from .breaker import CircuitBreaker
from .faultinject import FaultError, FaultInjector, faults
from .overload import (
    AdmissionGate, LaneStore, OverloadedError, RetryBudget,
    RetryBudgetExhausted, classify, parse_lane_spec,
)
from .recovery import BindIntentJournal, reconcile_bind_intents
from .transient import TRANSIENT_MARKERS, is_transient, retry_transient
from .watchdog import ActionContained, ActionTimeout, ActionWatchdog

__all__ = ["ActionContained", "ActionTimeout", "ActionWatchdog",
           "AdmissionGate", "BindIntentJournal", "CircuitBreaker",
           "FaultError", "FaultInjector", "LaneStore", "OverloadedError", "RetryBudget",
           "RetryBudgetExhausted", "classify", "faults", "parse_lane_spec",
           "reconcile_bind_intents", "TRANSIENT_MARKERS", "is_transient",
           "retry_transient"]
