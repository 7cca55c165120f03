"""The port's own spans: where a scheduling cycle's host time goes.

A span is one named interval of a layer's work, ``vc.<layer>``: its id,
its parent's id, the id of the cycle it belongs to, its start and end
(``time.perf_counter_ns``) and a few integer or string attributes, the
counts taken at the same boundary. The tree under one ``vc.cycle``:
``vc.open`` (``vc.open.snapshot``, ``vc.open.plugin``), one ``vc.action``
per action (allocate's ``vc.flatten`` > ``vc.order``, ``vc.solve`` >
``vc.pack``, ``vc.delta_plan``, ``vc.dispatch`` > ``vc.round`` >
``vc.round.order``, ``vc.sync``; ``vc.overlap``, ``vc.readback``, then
``vc.replay``) and ``vc.close``; ``vc.gc`` and ``vc.store.write`` fall
between cycles and count towards the last one opened.

Recording is on exactly while a ``torch.profiler`` session is active:
there is no switch of its own. Each recorded span is also entered as
``torch.profiler.record_function(name)``, so it shows in the profiler's
trace as a ``user_annotation`` event on the trace's clock, and it is kept
here, in memory (at most ``CAP`` spans; later ones are counted in
``dropped()``). Nothing is written out. With no profiler, ``span`` costs
the check of the profiler's flag and its two clock reads (the phase keys
of ``Scheduler.last_cycle_timing`` are its ``ms``), and ``traced`` the
check alone.

Parents come from a per-thread stack; work handed to another thread
names its parent with ``adopt(current())``. Read with ``spans()``,
``chrome_events()`` (the spans as chrome trace events, on a torch
trace's timebase), ``dropped()``; ``clear()`` empties the buffer.
"""

from __future__ import annotations

import itertools
import os
import sys
import threading
import time
from typing import List, NamedTuple, Optional

#: most spans kept between two ``clear()`` calls
CAP = 1 << 20

_perf_ns = time.perf_counter_ns


class Span(NamedTuple):
    """One recorded span. ``parent`` 0: none; ``cycle`` 0: before the
    first ``vc.cycle``."""

    name: str
    id: int
    parent: int
    cycle: int
    start_ns: int
    end_ns: int
    attrs: dict
    thread: int

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


class _Unbound:
    """Stands in for ``torch.autograd.profiler`` until torch is loaded (a
    process without torch runs no profiler), then rebinds ``_P`` to it."""

    @property
    def _is_profiler_enabled(self) -> bool:
        global _P
        prof = sys.modules.get("torch.autograd.profiler")
        if prof is None:
            return False
        _P = prof
        return prof._is_profiler_enabled


_P = sys.modules.get("torch.autograd.profiler") or _Unbound()


def _anchor() -> tuple:
    """(perf_counter_ns, time_ns) read at one moment: of a few tries, the
    wall read that two clock reads bracket most tightly."""
    best = None
    for _ in range(5):
        a = _perf_ns()
        wall = time.time_ns()
        b = _perf_ns()
        if best is None or b - a < best[0]:
            best = (b - a, (a + b) // 2, wall)
    return best[1:]


class _Recorder:
    def __init__(self):
        self.lock = threading.Lock()
        self.buf: List[Span] = []
        self.dropped = 0
        #: (perf_counter_ns, time_ns) taken when recording started
        self.anchor: Optional[tuple] = None
        self.ids = itertools.count(1)
        self.last_cycle = 0
        self.local = threading.local()

    def stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def open(self, sp: "span") -> None:
        if self.anchor is None:
            self.anchor = _anchor()
        st = self.stack()
        parent = st[-1] if st else None
        sp.id = next(self.ids)
        sp.parent = parent.id if parent is not None else 0
        if sp.name == "vc.cycle":
            sp.cycle = self.last_cycle = sp.id
        else:
            sp.cycle = parent.cycle if parent is not None \
                else self.last_cycle
        st.append(sp)
        sp._rf = _P.record_function(sp.name)
        sp._rf.__enter__()

    def close(self, sp: "span") -> None:
        sp._rf.__exit__(None, None, None)
        sp._rf = None
        st = self.stack()
        # a span left open by an exception below it is popped with it
        while st and st.pop() is not sp:
            pass
        rec = Span(sp.name, sp.id, sp.parent, sp.cycle, sp.start_ns,
                   sp.end_ns, sp.attrs, threading.get_ident())
        with self.lock:
            if len(self.buf) < CAP:
                self.buf.append(rec)
            else:
                self.dropped += 1


_REC = _Recorder()


class span:
    """``with span(name, **attrs) as s:`` times the block (``s.ms`` after
    it) and records it while a profiler is active. ``s.set(**attrs)``
    adds attributes before the block ends."""

    __slots__ = ("name", "attrs", "start_ns", "end_ns", "id", "parent",
                 "cycle", "_rf")

    def __init__(self, name: str, /, **attrs):
        self.name = name
        self.attrs = attrs
        self._rf = None

    def __enter__(self) -> "span":
        # the two stamps lie inside the profiler's annotation, so that a
        # span's duration leaves out its own annotation's cost
        if _P._is_profiler_enabled:
            _REC.open(self)
        self.start_ns = _perf_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = _perf_ns()
        if self._rf is not None:
            _REC.close(self)
        return False

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


class _Off:
    """What ``traced`` and ``adopt`` return with no profiler: nothing."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


def traced(name: str, /, **attrs):
    """A span that exists only while a profiler is active (a no-op
    context otherwise): for layers with no ``last_cycle_timing`` key."""
    if not _P._is_profiler_enabled:
        return _OFF
    return span(name, **attrs)


def current() -> Optional[span]:
    """The innermost recorded span open on this thread, or None."""
    if not _P._is_profiler_enabled:
        return None
    st = _REC.stack()
    return st[-1] if st else None


class _Adopted:
    __slots__ = ("parent",)

    def __init__(self, parent: span):
        self.parent = parent

    def __enter__(self) -> "_Adopted":
        _REC.stack().append(self.parent)
        return self

    def __exit__(self, *exc) -> bool:
        st = _REC.stack()
        while st and st.pop() is not self.parent:
            pass
        return False


def adopt(parent: Optional[span]):
    """Make ``parent`` (``current()`` of the thread that handed the work
    over) the parent of the spans this thread opens inside the block."""
    if parent is None or not _P._is_profiler_enabled:
        return _OFF
    return _Adopted(parent)


def spans() -> List[Span]:
    """The spans recorded since the last ``clear()``, in closing order."""
    with _REC.lock:
        return list(_REC.buf)


def dropped() -> int:
    """Spans not kept since the last ``clear()``: the buffer was full."""
    return _REC.dropped


def clear() -> None:
    """Empty the buffer; the next recorded span takes a new anchor."""
    with _REC.lock:
        _REC.buf = []
        _REC.dropped = 0
        _REC.anchor = None


def chrome_events(base_time_ns: int = 0) -> List[dict]:
    """The recorded spans as chrome trace events (``"ph": "X"``, times in
    microseconds, attributes and ids under ``args``) on the timebase of a
    torch chrome trace whose ``baseTimeNanoseconds`` is
    ``base_time_ns``: there ``ts`` + base / 1e3 is Unix microseconds, and
    the anchor maps this recorder's clock to Unix time."""
    anchor = _REC.anchor
    if anchor is None:
        return []
    shift = anchor[1] - anchor[0] - base_time_ns
    pid = os.getpid()
    return [{"name": s.name, "cat": "vc_span", "ph": "X",
             "ts": (s.start_ns + shift) / 1e3,
             "dur": (s.end_ns - s.start_ns) / 1e3,
             "pid": pid, "tid": s.thread,
             "args": {"id": s.id, "parent": s.parent, "cycle": s.cycle,
                      **s.attrs}}
            for s in spans()]
