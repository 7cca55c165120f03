"""Device-path circuit breaker: closed -> open -> half-open -> closed.

The device solver is one shared dependency (the GPU and its runtime)
sitting under every solver dispatch. When that dependency is sick, each
cycle paying a dispatch-and-fail (a CUDA error, OOM, garbage readback) before falling back to the host
oracle turns a degraded chip into a degraded *scheduler*. The breaker
makes the fallback sticky: N consecutive device failures open it, the
session goes straight to the host oracle for a cool-down window, then ONE
half-open probe re-tries the device path — success closes the breaker,
failure re-opens it for another window. This is the standard breaker
state machine (the reference survives API-server flaps with the same
shape of containment: client-go backs off and re-lists instead of
hammering a failing dependency every cycle).

State transitions and fallback cycles are exported both as metrics
(``volcano_breaker_*``) and through ``Scheduler.last_cycle_timing``
(``breaker_state`` / ``breaker_fallback_cycles``), so "the scheduler is
running on the host oracle" is a first-class observable, not an
inference from latency.

Thread-safe; the clock is injectable so tests drive the cool-down
deterministically.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, List, Tuple

log = logging.getLogger(__name__)

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

#: numeric encoding for gauges / last_cycle_timing
STATE_CODES = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}

#: bounded transition history (enough for any soak's open/close trace)
MAX_TRANSITIONS = 256


class CircuitBreaker:
    def __init__(self, name: str = "device-solver",
                 failure_threshold: int = 3, cooldown_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        self.name = name
        self.failure_threshold = max(1, int(failure_threshold))
        self.cooldown_s = float(cooldown_s)
        self.clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        #: (timestamp, from_state, to_state), bounded
        self.transitions: List[Tuple[float, str, str]] = []
        #: cycles served by the fallback path while not closed
        self.fallback_cycles = 0
        self._export_state()

    # -- state machine ----------------------------------------------------

    def _transition(self, to: str) -> None:
        """Caller holds the lock."""
        if self._state == to:
            return
        frm, self._state = self._state, to
        if len(self.transitions) < MAX_TRANSITIONS:
            self.transitions.append((self.clock(), frm, to))
        log.warning("circuit breaker %r: %s -> %s", self.name, frm, to)
        self._export_state()
        try:
            from ..metrics import metrics
            metrics.breaker_transitions_total.inc(
                labels={"breaker": self.name, "to": to})
        except Exception:  # noqa: BLE001 — metrics must not break the breaker
            pass

    def _export_state(self) -> None:
        try:
            from ..metrics import metrics
            metrics.breaker_state.set(STATE_CODES[self._state],
                                      labels={"breaker": self.name})
        except Exception:  # noqa: BLE001
            pass

    def allow(self) -> bool:
        """May the protected path be attempted right now? OPEN flips to
        HALF_OPEN (and allows the probe) once the cool-down elapsed."""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if self.clock() - self._opened_at >= self.cooldown_s:
                    self._transition(HALF_OPEN)
                    return True
                return False
            return True  # HALF_OPEN: the probe is in flight this cycle

    def record_success(self) -> None:
        with self._lock:
            self._consecutive_failures = 0
            if self._state != CLOSED:
                self._transition(CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            if self._state == HALF_OPEN:
                # failed probe: straight back to a fresh cool-down
                self._opened_at = self.clock()
                self._transition(OPEN)
                return
            self._consecutive_failures += 1
            if self._state == CLOSED \
                    and self._consecutive_failures >= self.failure_threshold:
                self._opened_at = self.clock()
                self._transition(OPEN)

    # -- observability ----------------------------------------------------

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    @property
    def state_code(self) -> int:
        return STATE_CODES[self.state]

    def count_fallback(self) -> None:
        """One scheduling cycle degraded to the fallback path."""
        with self._lock:
            self.fallback_cycles += 1
        try:
            from ..metrics import metrics
            metrics.breaker_fallback_cycles_total.inc(
                labels={"breaker": self.name})
        except Exception:  # noqa: BLE001
            pass

    def __repr__(self) -> str:  # pragma: no cover — debugging aid
        return (f"CircuitBreaker({self.name!r}, state={self.state}, "
                f"failures={self._consecutive_failures}, "
                f"fallback_cycles={self.fallback_cycles})")
