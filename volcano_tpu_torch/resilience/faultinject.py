"""Deterministic fault-injection harness for the resilience subsystem.

Production code declares *injection points* — ``faults.fire("point")`` at
the exact seams where the real world fails (a store connection dropping
mid-request, a watch stream dying, the device solver throwing, an action
hanging) — and tests *arm* those points with a deterministic
schedule. Disarmed, a point costs one dict lookup; there is no injection
machinery on any hot path unless something was armed.

Schedules are counter-based (fire on the Nth call to the point), so a run
with the same workload and the same arming is bit-reproducible; the only
randomness is the optional probability mode, which draws from a seeded
``random.Random`` so even that replays. Every firing is recorded in
``faults.log`` and counted in ``volcano_faults_injected_total`` so a chaos
run's artifact can account for each fault it injected.

Arming is programmatic (``faults.arm(...)`` / ``faults.arm_once(...)``)
or env-driven for subprocess targets::

    VOLCANO_FAULTS="solver_dispatch=at:3-5;watch_stream=every:40"

Spec grammar per point: ``at:3,7`` / ``at:3-5`` (1-based call indices),
``every:N`` (each Nth call), ``p:0.1`` (probability), ``times:K`` (cap),
``delay:SECS`` (sleep instead of / before raising), ``exc:none`` (delay
only), ``exc:exit`` (kill the PROCESS at the seam — ``os._exit(17)``, the
moral equivalent of a SIGKILL landing exactly there; the kill-the-leader
chaos harness arms this on a live scheduler to crash it at a chosen
fault point). Injected exceptions are ``FaultError`` (a
``ConnectionError`` subclass, so the store/watch retry paths treat them
as the genuine connection failures they simulate).

Points on this package's path: ``solver_dispatch``
(actions/allocate device path — the failure counts against the breaker
and the cycle finishes through the host oracle), ``slow_action``
(scheduler per-action wrapper; arm with ``delay:`` to simulate a hang),
``bind_commit`` (framework/statement commit / bulk flush, before any
cache bind effect), ``flatten_event`` (ops/arrays FlattenCache.feed_event,
between observing a mirror delta and marking it into the event-sourced
flatten ledger — an armed firing DROPS the delta: the observation counter
moved, the mark never landed, and the next flatten's consistency-epoch
check detects the skew and falls back to the full re-diff),
``flatten_event_dup`` (same seam, after the mark — the delta applies
twice, skewing the epoch the other way), ``order_event`` /
``order_event_dup`` (ops/ordering OrderCache.feed_event, the same two
faults on the event-sourced ordering ledger; the next allocate
collection falls back to the full sort), ``reschedule_dispatch``
(reschedule/action.py, before the defrag solve dispatches — a failure
counts one breaker failure, invalidates the action's arena and skips the
pass; there is no host solve), and ``migration_commit``
(reschedule/action.py, per migration wave, after the wave's
migration-intent write and before its evictions dispatch — ``at:1``
fails with the first wave journaled but zero evictions applied, ``at:2``
with wave one fully evicted and wave two only journaled), and
``sidecar_solve`` (parallel/sidecar.py's server, after the arena's scatter
and before the solve — the server answers with an error frame; a client
of a CUDA server raises, a client of a CPU server falls back to the host
loop), and ``lease_renew`` (utils/leader_election.py, between deciding to
renew and committing the renewal).

Points of the networked store (client/, resilience/overload.py), at the
JAX package's seams: ``store_request`` (client/remote._request_once,
before each send — an injected ConnectionError drives the retry rules),
``watch_stream`` (the remote watch reader, per received frame — the
stream resumes via ``since:``), ``wal_fsync`` (client/durable.py
WriteAheadLog.sync — ``delay:`` for a slow disk, ``exc:`` for an fsync
failure), ``store_crash`` (DurableClusterStore commit seam, after the WAL
append and before the commit is announced — ``exc:exit`` kills the store
with the record durable and the response never sent), ``wal_ship``
(client/server.py ship stream, at every frame send), ``admission_shed``
and ``request_deadline`` (AdmissionGate.admit: force a typed shed, or
treat the request as expired on arrival), and ``delta_frame`` /
``delta_frame_dup`` (client/server.py delta watch listener: drop or
repeat one frame after its sequence number was consumed — the client
refuses the next frame typed and resumes on object frames).
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
from typing import Dict, List, Optional, Tuple

log = logging.getLogger(__name__)

FAULTS_ENV = "VOLCANO_FAULTS"


class FaultError(ConnectionError):
    """An injected fault (ConnectionError so transport retry paths treat
    simulated drops exactly like real ones)."""


class _Point:
    __slots__ = ("name", "at", "every", "p", "times", "delay", "exc",
                 "message", "calls", "fired")

    def __init__(self, name: str, at=(), every: Optional[int] = None,
                 p: Optional[float] = None, times: Optional[int] = None,
                 delay: float = 0.0, exc=FaultError,
                 message: Optional[str] = None):
        self.name = name
        self.at = frozenset(int(a) for a in at)
        self.every = every
        self.p = p
        self.times = times
        self.delay = float(delay)
        self.exc = exc
        self.message = message or f"injected fault at {name!r}"
        self.calls = 0
        self.fired = 0


class FaultInjector:
    """See module docstring. One process-global instance (``faults``)."""

    def __init__(self, seed: int = 0, env: Optional[str] = None):
        self._lock = threading.Lock()
        self.rng = random.Random(seed)
        self._points: Dict[str, _Point] = {}
        #: (point, 1-based call index) per firing, in order
        self.log: List[Tuple[str, int]] = []
        spec = env if env is not None else os.environ.get(FAULTS_ENV)
        if spec:
            try:
                self.configure(spec)
            except ValueError:
                log.exception("ignoring malformed %s", FAULTS_ENV)

    # -- arming -----------------------------------------------------------

    def arm(self, point: str, at=(), every: Optional[int] = None,
            p: Optional[float] = None, times: Optional[int] = None,
            delay: float = 0.0, exc=FaultError,
            message: Optional[str] = None) -> None:
        """(Re)arm a point; replaces any previous schedule for it."""
        with self._lock:
            self._points[point] = _Point(point, at=at, every=every, p=p,
                                         times=times, delay=delay, exc=exc,
                                         message=message)

    def arm_once(self, point: str, delay: float = 0.0, exc=FaultError,
                 message: Optional[str] = None) -> None:
        """Fire on the NEXT call to the point, once. Re-arming before the
        pending shot fires keeps it a single next-call shot."""
        with self._lock:
            prev = self._points.get(point)
            calls = prev.calls if prev is not None else 0
            pt = _Point(point, at=(calls + 1,), times=1, delay=delay,
                        exc=exc, message=message)
            pt.calls = calls
            self._points[point] = pt

    def configure(self, spec: str) -> None:
        """Parse an env-style spec: ``point=key:val,key:val;point2=...``."""
        for part in spec.split(";"):
            part = part.strip()
            if not part:
                continue
            point, _, body = part.partition("=")
            kw: dict = {}
            for item in body.split(","):
                key, _, val = item.strip().partition(":")
                if key == "at":
                    if "-" in val:
                        lo, hi = val.split("-")
                        kw["at"] = range(int(lo), int(hi) + 1)
                    else:
                        kw["at"] = (int(val),)
                elif key == "every":
                    kw["every"] = int(val)
                elif key == "p":
                    kw["p"] = float(val)
                elif key == "times":
                    kw["times"] = int(val)
                elif key == "delay":
                    kw["delay"] = float(val)
                elif key == "exc" and val.lower() in ("none", "off"):
                    kw["exc"] = None
                elif key == "exc" and val.lower() == "exit":
                    kw["exc"] = "exit"
                else:
                    raise ValueError(f"unknown fault spec key {key!r}")
            self.arm(point.strip(), **kw)

    def disarm(self, point: str) -> None:
        with self._lock:
            self._points.pop(point, None)

    def reset(self) -> None:
        with self._lock:
            self._points.clear()
            self.log.clear()

    # -- firing -----------------------------------------------------------

    def _decide(self, pt: _Point) -> bool:
        pt.calls += 1
        if pt.times is not None and pt.fired >= pt.times:
            return False
        if pt.calls in pt.at:
            return True
        if pt.every is not None and pt.calls % pt.every == 0:
            return True
        if pt.p is not None and self.rng.random() < pt.p:
            return True
        return False

    def fire(self, point: str) -> None:
        """Injection point: no-op unless ``point`` is armed and its
        schedule says this call fires; then sleep ``delay`` (if any) and
        raise ``exc`` (unless armed delay-only)."""
        if not self._points:
            return
        with self._lock:
            pt = self._points.get(point)
            if pt is None or not self._decide(pt):
                return
            pt.fired += 1
            self.log.append((point, pt.calls))
            delay, exc, message = pt.delay, pt.exc, pt.message
        try:
            from ..metrics import metrics
            metrics.faults_injected_total.inc(labels={"point": point})
        except Exception:  # noqa: BLE001 — accounting must not mask the fault
            pass
        log.warning("fault injected: %s (call %s)", point, message)
        if delay:
            time.sleep(delay)
        if exc == "exit":
            # simulated crash AT the seam: no cleanup, no atexit — the
            # closest a test can get to SIGKILL landing on this line
            log.critical("fault %s: simulated crash (os._exit)", point)
            os._exit(17)
        if exc is not None:
            raise exc(message)

    def fired(self, point: str) -> int:
        with self._lock:
            pt = self._points.get(point)
            return pt.fired if pt is not None else 0


#: process-global injector; disarmed (and therefore free) by default,
#: armed programmatically or via $VOLCANO_FAULTS
faults = FaultInjector()
