"""Cross-session upload/solve/readback pipeline.

Each synchronous session pays its upload, its solve and its result
readback one after another, with the device idle while the host works and
the host idle while the device does.

``SessionPipeline`` amortizes those trips across consecutive sessions by
keeping three phases in flight at once, on separate threads:

- **next-session delta upload** — session s+1's flatten + arena delta
  plan run on the caller thread and its dirty chunks are dispatched while
  session s is still solving;
- **in-flight solve** — session s executes on the device (device work is
  serial in dispatch order, so back-to-back dispatches queue without
  idling it);
- **previous-session readback** — session s-1's result transfer + decode
  block on the dedicated collector thread, concurrently with both of the
  above. ``start_readback`` additionally begins the device->host copy
  right at dispatch time, so the transfer overlaps the solve tail even
  before the collector blocks.

Decision safety: the pipeline never reorders *dependent* work — a
submit()'s dispatch closure runs on the caller thread in program order,
and results come back strictly FIFO. Callers whose session s+1 inputs
depend on session s's *results* (the scheduler's allocate action: binds
feed the next snapshot) must keep collect inside the cycle and only get
the start_readback overlap; callers with exogenous inputs get the full
three-phase overlap.

Arena safety: ``PackedDeviceCache.update`` scatters session s+1's dirty
chunks in place into the buffers session s's solve read, while s may
still be collecting. Both are enqueued on the caller's current stream, so
the scatter runs after every kernel of s's solve, and ``start_readback``
copies only the solve's result tensors, never the arena. The solve syncs
the host every round, so ``dispatch()`` returns with its solve done and
sessions do not overlap on the device.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, List, Optional, Tuple

import torch

__all__ = ["Readback", "SessionPipeline", "SessionTicket", "start_readback"]


class Readback:
    """An in-flight device->host copy of result tensors (``start_readback``).

    ``wait()`` blocks until the copy has landed and returns the host
    tensors. Reading the pinned host tensors before then would see stale
    bytes without any error, so every reader goes through ``wait()``."""

    __slots__ = ("_host", "_done")

    def __init__(self, host: List[torch.Tensor], done=None):
        self._host = host
        self._done = done   # torch.cuda.Event, or None when on the host

    def wait(self) -> List[torch.Tensor]:
        if self._done is not None:
            self._done.synchronize()
        return self._host


def start_readback(*tensors: torch.Tensor) -> Readback:
    """Begin the device->host transfer of result tensors now, so it
    overlaps whatever the host does before it needs them.

    On CUDA: an event recorded on the current stream marks the end of the
    work that produces the tensors; a side stream waits on it and copies
    each tensor into pinned host memory without blocking the host; a
    second event marks the copy's end, and ``Readback.wait`` synchronizes
    on it. Tensors already on the host are returned as they are."""
    if not tensors or tensors[0].device.type != "cuda":
        return Readback([t.cpu() for t in tensors])
    dev = tensors[0].device
    produced = torch.cuda.Event()
    produced.record(torch.cuda.current_stream(dev))
    side = torch.cuda.Stream(dev)
    done = torch.cuda.Event()
    with torch.cuda.stream(side):
        side.wait_event(produced)
        host = []
        for t in tensors:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            # the caching allocator must not hand t's memory to the
            # producer stream's next allocation before this copy ran
            t.record_stream(side)
            host.append(h)
        done.record(side)
    return Readback(host, done)


class SessionTicket:
    """Handle for one in-flight session: resolves to the collect
    callback's return value (or re-raises its exception)."""

    __slots__ = ("tag", "_event", "_value", "_error", "t_dispatched",
                 "t_collected")

    def __init__(self, tag):
        self.tag = tag
        self._event = threading.Event()
        self._value = None
        self._error: Optional[BaseException] = None
        self.t_dispatched: float = 0.0
        self.t_collected: float = 0.0

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError(f"session {self.tag!r} not collected "
                               f"within {timeout}s")
        if self._error is not None:
            raise self._error
        return self._value


class SessionPipeline:
    """FIFO three-phase session pipeline with one collector thread.

    ``submit(tag, dispatch, collect)`` runs ``dispatch()`` on the caller
    thread (upload + solve enqueue) and hands ``collect(dispatched)`` — the blocking
    readback + decode — to the collector thread. At most ``depth``
    sessions are in flight; a deeper submit blocks until the oldest
    collects (bounded device memory and arena writes in flight).

    The ``events`` log records ("dispatch"|"collect", tag, t) in real
    order — the phase-overlap smoke test asserts that session s+1's
    dispatch lands before session s's collect completes.
    """

    def __init__(self, depth: int = 2):
        if depth < 1:
            raise ValueError("pipeline depth must be >= 1")
        self.depth = depth
        self._lock = threading.Lock()
        self._inflight: List[SessionTicket] = []
        self._collected: List[SessionTicket] = []
        self.events: List[Tuple[str, Any, float]] = []
        self._cv = threading.Condition(self._lock)
        self._queue: List[Tuple[SessionTicket, Any, Callable]] = []
        self._stop = False
        self._collector = threading.Thread(
            target=self._collect_loop, name="session-collector", daemon=True)
        self._collector.start()

    # -- producer side (caller thread) ---------------------------------

    def submit(self, tag, dispatch: Callable[[], Any],
               collect: Callable[[Any], Any],
               timeout: Optional[float] = None) -> SessionTicket:
        # backpressure BEFORE dispatching: session s+1 must not write the
        # arena while depth sessions already queue (device memory and
        # fairness, not correctness)
        with self._cv:
            deadline = None if timeout is None else time.monotonic() + timeout
            while len(self._inflight) >= self.depth and not self._stop:
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise TimeoutError("pipeline backpressure timeout")
                self._cv.wait(remaining)
            if self._stop:
                raise RuntimeError("pipeline is closed")
            ticket = SessionTicket(tag)
            self._inflight.append(ticket)
        dispatched = dispatch()   # async: upload + solve enqueue
        ticket.t_dispatched = time.perf_counter()
        with self._cv:
            self.events.append(("dispatch", tag, ticket.t_dispatched))
            self._queue.append((ticket, dispatched, collect))
            self._cv.notify_all()
        return ticket

    def drain(self, timeout: Optional[float] = None) -> List[SessionTicket]:
        """Wait until every submitted session collected; returns all
        tickets in submit order (accumulated across the pipeline's
        lifetime)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while self._inflight:
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise TimeoutError("pipeline drain timeout")
                self._cv.wait(remaining)
            return list(self._collected)

    def close(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._collector.join(timeout=5.0)

    # -- collector side (background thread) ----------------------------

    def _collect_loop(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._stop:
                    self._cv.wait()
                if self._stop and not self._queue:
                    return
                ticket, dispatched, collect = self._queue.pop(0)
            try:
                ticket._value = collect(dispatched)
            except BaseException as e:  # noqa: BLE001 — surfaced at result()
                ticket._error = e
            ticket.t_collected = time.perf_counter()
            with self._cv:
                self.events.append(("collect", ticket.tag,
                                    ticket.t_collected))
                self._inflight.remove(ticket)
                self._collected.append(ticket)
                self._cv.notify_all()
            ticket._event.set()

    # -- introspection (tests / bench) ---------------------------------

    def overlap_pairs(self) -> int:
        """Count of (dispatch of session k+1) events that landed before
        (collect of session k) — the phase-overlap evidence the smoke
        test asserts on. Tags must be orderable submit indices."""
        with self._lock:
            ev = list(self.events)
        collected_at = {tag: t for kind, tag, t in ev if kind == "collect"}
        n = 0
        for kind, tag, t in ev:
            if kind != "dispatch":
                continue
            prev = tag - 1 if isinstance(tag, int) else None
            if prev is not None and prev in collected_at \
                    and t < collected_at[prev]:
                n += 1
        return n
