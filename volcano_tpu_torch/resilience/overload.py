"""Overload-protected front door: priority-lane admission for the store.

A thread-per-connection store server with unbounded concurrency and
no request classification lets a storm of watchers and lists starve
the control plane's own writes. The reference's lineage for this layer
is kube's client-side QPS throttle evolving into the apiserver's
max-in-flight limits and API Priority and Fairness; this module builds
it natively, in the Google-SRE mold: priority lanes with per-client
fair queuing, wire deadlines, and client-side retry budgets, so an
overloaded store degrades by shedding the RIGHT traffic instead of
collapsing the scheduler. The lanes, headers and typed errors are the
JAX package's, so either package's clients and servers interoperate.

**Lanes** (requests carry an additive ``prio`` header; headerless
requests are classified server-side so old clients interop unchanged):

- ``system`` — fenced writes, lease CAS/renewal, ``fence_check``,
  supervisor plumbing. NEVER shed, never queued behind anything: the
  scheduler's binds and the HA lease must land even mid-storm.
- ``control`` — controller syncs, watch-RESUME and ``bulk_watch``
  setup, bind/status writes from un-fenced controllers. Bounded but
  generous: the control plane's own feedback loops.
- ``bulk`` — ``bulk_apply`` ingest waves. Bounded so a mega-wave
  queues behind the lane, not in front of everyone else.
- ``read`` — list/get from vcctl, dashboards, storms, and plain watch
  setup. The first lane to shed under pressure.

Each lane has bounded concurrency (``max_inflight``), a bounded FIFO
queue (``max_queue``), and optionally a bound on concurrently-served
watch/ship STREAMS (``max_streams``; 0 = unbounded). Inside a lane,
queued requests are granted round-robin ACROSS CLIENTS (per-client flow
queues), so one hot client cannot starve its peers. When a lane's queue
is full, its queue-wait deadline passes, or a request arrives with its
wire deadline (``deadline_ms`` header) already expired, the request
fails FAST with a wire-typed :class:`OverloadedError` carrying a
retry-after hint — never a hang, never a silent drop.

**Retry budget** (client side, :class:`RetryBudget`): a token bucket
refilled at ~10% of recent request volume caps Overloaded retries, so
a shedding server is never met with a retry storm that amplifies the
outage; once the budget is dry the caller sees a typed
:class:`~..client.store.RetryBudgetExhausted`. ``system``-lane traffic
(lease renewal) bypasses the budget — giving up on the lease IS the
outage.

Fault points: ``admission_shed`` (force a shed at the gate on the Nth
request, regardless of lane) and ``request_deadline`` (treat the Nth
request as expired on arrival), both wired through
:meth:`AdmissionGate.admit` so a live server surfaces the client's
typed error end-to-end.
"""

from __future__ import annotations

import collections
import contextvars
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

from .faultinject import faults


class OverloadedError(Exception):
    """A request was shed at the admission gate (lane over capacity,
    queue-wait deadline passed, or the request's own wire deadline
    expired on arrival). Wire-typed like FencedError (client/store.py
    precedent): the server answers ``{"ok": false, "error":
    "OverloadedError", "retry_after_ms": ..., "lane": ..., "reason":
    ...}`` and the client re-raises this class with those fields — the
    caller always gets a fast, typed refusal with a retry-after hint,
    never a hang or a silent drop."""

    def __init__(self, message: str = "request shed at the admission "
                 "gate", retry_after_ms: Optional[float] = None,
                 lane: Optional[str] = None, reason: Optional[str] = None):
        super().__init__(message)
        self.retry_after_ms = retry_after_ms
        self.lane = lane
        self.reason = reason


class RetryBudgetExhausted(OverloadedError):
    """Client-side refusal to retry an OverloadedError: the global
    retry budget (token bucket, ~10% of recent requests) is dry, so
    another retry would amplify the very overload that shed the
    request. Raised by RemoteClusterStore in place of a retry;
    ``system``-lane ops (lease renewal) bypass the budget and never see
    this."""


LANES = ("system", "control", "bulk", "read")

#: lane -> (max_inflight, max_queue, max_streams); 0 = unbounded.
#: Fail-safe defaults: gate ON, limits generous enough that an unloaded
#: deployment is protocol-indistinguishable from an ungated one.
DEFAULT_LANES: Dict[str, Tuple[int, int, int]] = {
    "system": (0, 0, 0),
    "control": (64, 256, 0),
    "bulk": (32, 128, 0),
    "read": (64, 1024, 0),
}

DEFAULT_QUEUE_WAIT_MS = 2000.0

#: ambient lane hint (see LaneStore): consulted by RemoteClusterStore's
#: classifier so a component-scoped store view (the controller manager)
#: stamps its lane without threading a parameter through every call
_current_lane: "contextvars.ContextVar[Optional[str]]" = \
    contextvars.ContextVar("volcano_store_lane", default=None)


def current_lane() -> Optional[str]:
    return _current_lane.get()


def classify(op: Optional[str], kind: Optional[str] = None,
             fencing: Optional[dict] = None,
             prio: Optional[str] = None) -> str:
    """Lane for a request. The strong classifications win over any
    ``prio`` hint: a fenced write is ``system`` no matter who sent it
    (the scheduler's binds), lease traffic is the HA heartbeat, and a
    bulk wave is bulk however it is labeled. The hint then covers
    everything a header (or a LaneStore view) named; headerless
    leftovers default by op shape — stream SETUP for ``bulk_watch``/
    ``ship`` (controller fan-out, replica tailing) is control, plain
    ``watch`` and all remaining unary ops are read."""
    if fencing or op in ("fence_check", "set_peers") or kind == "leases":
        return "system"
    if op == "bulk_apply":
        return "bulk"
    if prio in LANES:
        return prio
    if op in ("bulk_watch", "ship"):
        return "control"
    return "read"


def parse_lane_spec(spec: Optional[str]) -> Dict[str, Tuple[int, int, int]]:
    """``--admission-lanes`` grammar:
    ``lane=inflight[:queue[:streams]][,lane=...]`` with 0 = unbounded;
    unnamed lanes keep their defaults. Example:
    ``read=16:64:32,bulk=8:32``."""
    lanes = dict(DEFAULT_LANES)
    if not spec:
        return lanes
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, body = part.partition("=")
        name = name.strip()
        if name not in LANES:
            raise ValueError(f"unknown admission lane {name!r} "
                             f"(lanes: {', '.join(LANES)})")
        fields = [f.strip() for f in body.split(":")]
        cur = lanes[name]
        inflight = int(fields[0]) if fields[0] else cur[0]
        max_queue = int(fields[1]) if len(fields) > 1 and fields[1] \
            else cur[1]
        streams = int(fields[2]) if len(fields) > 2 and fields[2] \
            else cur[2]
        lanes[name] = (inflight, max_queue, streams)
    return lanes


class _Waiter:
    __slots__ = ("granted", "shed")

    def __init__(self):
        self.granted = False
        self.shed: Optional[str] = None


class _Lane:
    __slots__ = ("name", "max_inflight", "max_queue", "max_streams",
                 "inflight", "queued", "streams", "flows", "admitted",
                 "sheds", "deadline_expired")

    def __init__(self, name: str, max_inflight: int, max_queue: int,
                 max_streams: int):
        self.name = name
        self.max_inflight = int(max_inflight)
        self.max_queue = int(max_queue)
        self.max_streams = int(max_streams)
        self.inflight = 0
        self.queued = 0
        self.streams = 0
        #: per-client FIFO flows, granted round-robin (move_to_end)
        self.flows: "collections.OrderedDict[str, collections.deque]" = \
            collections.OrderedDict()
        self.admitted = 0
        self.sheds: Dict[str, int] = {}
        self.deadline_expired = 0


class _Ticket:
    __slots__ = ("lane", "stream")

    def __init__(self, lane: str, stream: bool = False):
        self.lane = lane
        self.stream = stream


class AdmissionGate:
    """Per-lane bounded admission every request-serving surface consults
    before dispatch (see module docstring). One gate per server process
    — a shard WORKER owns its own, so one hot shard sheds without
    touching its siblings; the router in front has its own too.

    ``admit`` returns a ticket the handler must :meth:`release` after
    dispatch (``None`` when the gate is disabled or the grant was
    transient), or raises :class:`OverloadedError` — the caller turns
    that into the typed wire response with the retry-after hint."""

    def __init__(self,
                 lanes: Optional[Dict[str, Tuple[int, int, int]]] = None,
                 queue_wait_ms: float = DEFAULT_QUEUE_WAIT_MS,
                 retry_after_ms: float = 250.0,
                 enabled: bool = True,
                 clock: Callable[[], float] = time.monotonic):
        self.enabled = bool(enabled)
        self.queue_wait_ms = float(queue_wait_ms)
        self.retry_after_ms = float(retry_after_ms)
        self.clock = clock
        self._cv = threading.Condition()
        spec = dict(DEFAULT_LANES)
        for name, cfg in (lanes or {}).items():
            if name not in LANES:
                raise ValueError(f"unknown admission lane {name!r}")
            cfg = tuple(cfg) + (0,) * (3 - len(tuple(cfg)))
            spec[name] = cfg  # type: ignore[assignment]
        self.lanes: Dict[str, _Lane] = {
            name: _Lane(name, *spec[name]) for name in LANES}

    # -- admission ----------------------------------------------------------

    def admit(self, op: Optional[str], req: dict, client: str = "",
              hold: bool = True, stream: bool = False) -> Optional[_Ticket]:
        """Admit one request (or one watch/ship stream with
        ``stream=True``). ``hold=False`` grants transiently: the slot
        frees as soon as it is granted — the gate then paces and sheds
        bursts of arrivals without capping long-lived concurrency.
        Raises OverloadedError on shed/expiry."""
        if not self.enabled:
            return None
        lane_name = classify(op, req.get("kind"), req.get("fencing"),
                             req.get("prio"))
        lane = self.lanes[lane_name]
        # request_deadline fault: treat this request as expired on
        # arrival (the armed firing raises; the schedule decides when)
        expired = False
        try:
            faults.fire("request_deadline")
        except SystemExit:  # pragma: no cover — exc:exit passthrough
            raise
        except Exception:  # noqa: BLE001 — any armed exc means "expired"
            expired = True
        deadline_ms = req.get("deadline_ms")
        budget_s: Optional[float] = None
        if deadline_ms is not None:
            try:
                budget_s = float(deadline_ms) / 1000.0
            except (TypeError, ValueError):
                budget_s = None
        if expired or (budget_s is not None and budget_s <= 0):
            with self._cv:
                lane.deadline_expired += 1
                self._count_shed(lane, "deadline")
            self._export(lane)
            raise OverloadedError(
                f"request expired on arrival (lane {lane_name!r}): the "
                "deadline the client attached has already passed",
                retry_after_ms=0.0, lane=lane_name, reason="deadline")
        # admission_shed fault: force a shed at the gate, any lane —
        # the deterministic storm-in-a-box the chaos tests arm
        try:
            faults.fire("admission_shed")
        except SystemExit:  # pragma: no cover
            raise
        except Exception:  # noqa: BLE001
            with self._cv:
                self._count_shed(lane, "fault")
            self._export(lane)
            raise OverloadedError(
                f"request shed at the admission gate (lane "
                f"{lane_name!r}): injected admission_shed fault",
                retry_after_ms=self.retry_after_ms, lane=lane_name,
                reason="fault")
        with self._cv:
            if stream and lane.max_streams > 0 \
                    and lane.streams >= lane.max_streams:
                self._count_shed(lane, "streams")
                self._export_locked(lane)
                raise OverloadedError(
                    f"lane {lane_name!r} is serving its maximum of "
                    f"{lane.max_streams} streams",
                    retry_after_ms=self.retry_after_ms, lane=lane_name,
                    reason="streams")
            if lane.max_inflight <= 0:
                # unbounded lane (system): never queued, never shed
                lane.admitted += 1
                if stream:
                    lane.streams += 1
                elif hold:
                    lane.inflight += 1
                self._export_locked(lane)
                return _Ticket(lane_name, stream) \
                    if (hold or stream) else None
            if lane.inflight < lane.max_inflight and not lane.queued:
                lane.admitted += 1
                if stream:
                    lane.streams += 1
                elif hold:
                    lane.inflight += 1
                self._export_locked(lane)
                return _Ticket(lane_name, stream) \
                    if (hold or stream) else None
            if lane.queued >= lane.max_queue:
                self._count_shed(lane, "queue_full")
                self._export_locked(lane)
                raise OverloadedError(
                    f"lane {lane_name!r} is over capacity "
                    f"({lane.inflight} in flight, {lane.queued} queued)",
                    retry_after_ms=self.retry_after_ms, lane=lane_name,
                    reason="queue_full")
            # queue, per-client flow, granted round-robin across flows
            waiter = _Waiter()
            flow = lane.flows.get(client)
            if flow is None:
                flow = lane.flows[client] = collections.deque()
            flow.append(waiter)
            lane.queued += 1
            self._export_locked(lane)
            wait_s = self.queue_wait_ms / 1000.0
            if budget_s is not None:
                wait_s = min(wait_s, budget_s)
            deadline = self.clock() + wait_s
            while not waiter.granted:
                left = deadline - self.clock()
                if left <= 0:
                    self._evict_waiter(lane, client, waiter)
                    lane.queued -= 1
                    reason = "queue_wait"
                    if budget_s is not None \
                            and budget_s <= self.queue_wait_ms / 1000.0:
                        reason = "deadline"
                        lane.deadline_expired += 1
                    self._count_shed(lane, reason)
                    self._export_locked(lane)
                    raise OverloadedError(
                        f"lane {lane_name!r} queue wait exceeded "
                        f"{wait_s * 1000:.0f}ms",
                        retry_after_ms=self.retry_after_ms,
                        lane=lane_name, reason=reason)
                self._cv.wait(min(left, 0.05))
            # granted: the granter already moved us to inflight
            if stream:
                # re-check the stream cap at grant time (other streams
                # may have been admitted while this one queued), then
                # convert the inflight slot to a stream slot; the freed
                # inflight capacity grants the next waiter either way
                lane.inflight -= 1
                self._grant_next(lane)
                if lane.max_streams > 0 \
                        and lane.streams >= lane.max_streams:
                    self._count_shed(lane, "streams")
                    self._export_locked(lane)
                    raise OverloadedError(
                        f"lane {lane_name!r} is serving its maximum of "
                        f"{lane.max_streams} streams",
                        retry_after_ms=self.retry_after_ms,
                        lane=lane_name, reason="streams")
                lane.admitted += 1
                lane.streams += 1
                self._export_locked(lane)
                return _Ticket(lane_name, stream=True)
            lane.admitted += 1
            if not hold:
                lane.inflight -= 1
                self._grant_next(lane)
            self._export_locked(lane)
            return _Ticket(lane_name, stream) if (hold or stream) else None

    def release(self, ticket: Optional[_Ticket]) -> None:
        if ticket is None:
            return
        lane = self.lanes[ticket.lane]
        with self._cv:
            if ticket.stream:
                lane.streams = max(0, lane.streams - 1)
            else:
                lane.inflight = max(0, lane.inflight - 1)
                self._grant_next(lane)
            self._export_locked(lane)
            self._cv.notify_all()

    # -- internals (caller holds self._cv) ----------------------------------

    def _grant_next(self, lane: _Lane) -> None:
        while lane.flows and (lane.max_inflight <= 0
                              or lane.inflight < lane.max_inflight):
            client, flow = next(iter(lane.flows.items()))
            waiter = flow.popleft()
            if flow:
                lane.flows.move_to_end(client)  # round-robin across flows
            else:
                del lane.flows[client]
            waiter.granted = True
            lane.inflight += 1
            lane.queued -= 1
        self._cv.notify_all()

    @staticmethod
    def _evict_waiter(lane: _Lane, client: str, waiter: _Waiter) -> None:
        flow = lane.flows.get(client)
        if flow is None:
            return
        try:
            flow.remove(waiter)
        except ValueError:
            pass
        if not flow:
            lane.flows.pop(client, None)

    def _count_shed(self, lane: _Lane, reason: str) -> None:
        lane.sheds[reason] = lane.sheds.get(reason, 0) + 1
        try:
            from ..metrics import metrics
            metrics.store_admission_sheds_total.inc(
                labels={"lane": lane.name, "reason": reason})
            if reason == "deadline":
                metrics.store_admission_deadline_expired_total.inc(
                    labels={"lane": lane.name})
        except Exception:  # noqa: BLE001 — accounting only
            pass

    def _export_locked(self, lane: _Lane) -> None:
        try:
            from ..metrics import metrics
            labels = {"lane": lane.name}
            metrics.store_admission_inflight.set(
                lane.inflight + lane.streams, labels=labels)
            metrics.store_admission_queued.set(lane.queued, labels=labels)
        except Exception:  # noqa: BLE001 — accounting only
            pass

    def _export(self, lane: _Lane) -> None:
        with self._cv:
            self._export_locked(lane)

    # -- introspection ------------------------------------------------------

    def stats(self) -> Dict[str, Dict[str, Any]]:
        """Per-lane admission table (the ``admission_info`` wire op and
        the vcctl status table read this)."""
        out: Dict[str, Dict[str, Any]] = {}
        with self._cv:
            for name in LANES:
                lane = self.lanes[name]
                out[name] = {
                    "inflight": lane.inflight,
                    "streams": lane.streams,
                    "queued": lane.queued,
                    "admitted": lane.admitted,
                    "sheds": sum(lane.sheds.values()),
                    "shed_reasons": dict(lane.sheds),
                    "deadline_expired": lane.deadline_expired,
                    "max_inflight": lane.max_inflight,
                    "max_queue": lane.max_queue,
                    "max_streams": lane.max_streams,
                }
        return out


class RetryBudget:
    """Client-side token bucket capping Overloaded retries at ~``ratio``
    of recent request volume (the Google-SRE retry budget): every
    request deposits ``ratio`` tokens (bounded by ``capacity``), every
    retry withdraws one. A dry bucket means the server is shedding
    faster than this client's traffic earns retries — retrying harder
    would amplify the outage, so the caller gets a typed
    RetryBudgetExhausted instead. ``system``-lane ops bypass the budget
    at the call site (client/remote.py): lease renewal must keep
    trying."""

    def __init__(self, ratio: float = 0.1, capacity: float = 50.0,
                 initial: float = 10.0):
        self.ratio = float(ratio)
        self.capacity = float(capacity)
        self._tokens = min(float(initial), self.capacity)
        self._lock = threading.Lock()
        self.exhausted = 0

    def on_request(self) -> None:
        with self._lock:
            self._tokens = min(self.capacity, self._tokens + self.ratio)
        self._export()

    def try_spend(self, n: float = 1.0) -> bool:
        with self._lock:
            if self._tokens >= n:
                self._tokens -= n
                ok = True
            else:
                self.exhausted += 1
                ok = False
        self._export()
        if not ok:
            try:
                from ..metrics import metrics
                metrics.store_admission_retry_budget_exhausted_total.inc()
            except Exception:  # noqa: BLE001
                pass
        return ok

    def balance(self) -> float:
        with self._lock:
            return self._tokens

    def _export(self) -> None:
        try:
            from ..metrics import metrics
            metrics.store_admission_retry_budget.set(self.balance())
        except Exception:  # noqa: BLE001
            pass


#: ops a LaneStore view tags with its lane (everything that reaches the
#: wire; reads included — a controller's relist is control traffic)
_LANE_OPS = frozenset((
    "create", "update", "apply", "delete", "bulk_apply", "get",
    "try_get", "list", "list_versioned", "watch", "bulk_watch",
))


class LaneStore:
    """Store view that classifies every forwarded op into ``lane`` (via
    the ambient contextvar RemoteClusterStore's classifier consults) —
    the seam that lets one shared client stamp controller traffic as
    ``control`` while the rest of the process stays ``read``. Transparent
    over in-memory stores (the hint is simply never read). Strong
    classifications still win: a fenced write through a LaneStore is
    ``system``, a bulk wave is ``bulk``."""

    def __init__(self, store, lane: str):
        if lane not in LANES:
            raise ValueError(f"unknown admission lane {lane!r}")
        self._store = store
        self._lane = lane

    def __getattr__(self, name):
        attr = getattr(self._store, name)
        if name in _LANE_OPS and callable(attr):
            lane = self._lane

            def tagged(*args, **kwargs):
                token = _current_lane.set(lane)
                try:
                    return attr(*args, **kwargs)
                finally:
                    _current_lane.reset(token)
            return tagged
        return attr
