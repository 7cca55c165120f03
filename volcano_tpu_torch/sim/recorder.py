"""Per-cycle decision trace, written as canonical JSONL.

One record per scheduling cycle captures every decision the control
plane made — binds and evictions at the effector boundary
(cache.RecordingBinder/RecordingEvictor), pipeline statements and
per-job FitErrors summaries from the session-close hook
(framework.close_session -> observe_session), lifecycle events injected
by the virtual cluster, and the breaker/fallback state of the cycle.

Canonical form: keys sorted, no whitespace, lists sorted, floats
rounded — so "same seed + same config => byte-identical trace" is a
meaningful equality, and a SHA-256 over the lines is a stable run
fingerprint.

Reproducibility contract: a strict recorder refuses a wall-clock time
source outright, and while a record is being composed/serialized
``time.time``/``time.monotonic`` RAISE (the wall-clock ban hook) so an
accidentally wall-derived field can never leak into a golden trace.

The ban patches the ``time`` module for the whole process, so no other
thread may read the clock while a record is composed. A sim run starts
none: its cache has no async effector pool, its Scheduler no bucket
prewarmer, and its store is in process (no sidecar or watch reader
thread). Keep it that way. ``standalone --sim-record`` records with
``strict=False``, which bans nothing.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import time
from typing import Dict, List, Optional

from ..metrics import metrics

_WALL_CLOCKS = ("time", "monotonic", "perf_counter")


class DecisionRecorder:
    def __init__(self, clock, sink=None, strict: bool = True):
        """``clock`` is the run's time source (the virtual clock in sim
        runs; wall time is allowed only with ``strict=False``, e.g. for
        ``standalone --sim-record`` live observability traces). ``sink``
        is an optional open text file that gets each line appended."""
        if strict and clock in (time.time, time.monotonic,
                                time.perf_counter):
            raise ValueError(
                "strict DecisionRecorder requires a virtual clock, not a "
                "wall-clock time source (reproducibility contract)")
        self.clock = clock
        self.strict = strict
        self.sink = sink
        self.lines: List[str] = []
        self._sha = hashlib.sha256()
        self._cycle: Optional[int] = None
        self._reset_cycle_state()

    def _reset_cycle_state(self) -> None:
        self._vtime = 0.0
        self._binds: List[List[str]] = []
        self._evicts: List[List[str]] = []
        self._pipelines: List[List[str]] = []
        self._unsched: Dict[str, str] = {}
        self._events: Dict[str, List[str]] = {}

    # -- wall-clock ban hook -------------------------------------------------

    @contextlib.contextmanager
    def wallclock_banned(self):
        """While composing/serializing a record, wall-clock reads raise.
        No-op when strict is off (live traces timestamp with wall time by
        design)."""
        if not self.strict:
            yield
            return
        saved = {name: getattr(time, name) for name in _WALL_CLOCKS}

        def _banned(*_a, **_k):
            raise RuntimeError(
                "wall-clock read while composing a sim decision record — "
                "trace fields must derive from the virtual clock only")

        try:
            for name in _WALL_CLOCKS:
                setattr(time, name, _banned)
            yield
        finally:
            for name, fn in saved.items():
                setattr(time, name, fn)

    # -- per-cycle hooks ------------------------------------------------------

    def begin_cycle(self, cycle: int) -> None:
        self._cycle = int(cycle)
        self._reset_cycle_state()
        self._vtime = float(self.clock())

    def record_bind(self, key: str, node: str) -> None:
        self._binds.append([key, node])
        metrics.sim_decisions_total.inc(labels={"kind": "bind"})

    def record_evict(self, key: str, reason: str) -> None:
        self._evicts.append([key, reason])
        metrics.sim_decisions_total.inc(labels={"kind": "evict"})

    def record_pipeline(self, key: str, node: str) -> None:
        self._pipelines.append([key, node])
        metrics.sim_decisions_total.inc(labels={"kind": "pipeline"})

    def record_event(self, kind: str, name: str) -> None:
        """Workload/lifecycle events (arrival/complete/fail/replace) the
        virtual cluster injects — part of the trace so a divergence diff
        can tell decision drift from workload drift."""
        self._events.setdefault(kind, []).append(name)

    def observe_session(self, ssn) -> None:
        """close_session hook: pipeline statements + per-job aggregated
        FitErrors (api.unschedule_info.aggregate_fit_errors)."""
        from ..api import TaskStatus
        from ..api.unschedule_info import aggregate_fit_errors

        for uid in sorted(ssn.jobs):
            job = ssn.jobs[uid]
            for t in job.task_status_index.get(
                    TaskStatus.PIPELINED, {}).values():
                self.record_pipeline(t.key, t.node_name)
            if job.nodes_fit_errors:
                self._unsched[uid] = aggregate_fit_errors(
                    job.nodes_fit_errors, len(job.tasks))

    def end_cycle(self, timing: Optional[dict] = None) -> str:
        """Compose + append the cycle's canonical record; returns the
        line. Wall-clock reads are banned for the duration."""
        timing = timing or {}
        with self.wallclock_banned():
            rec = {
                "cycle": self._cycle,
                "vtime": round(self._vtime, 6),
                "binds": sorted(self._binds),
                "evicts": sorted(self._evicts),
                "pipelines": sorted(self._pipelines),
                "unschedulable": dict(sorted(self._unsched.items())),
                "events": {k: sorted(v)
                           for k, v in sorted(self._events.items())},
                "breaker": int(timing.get("breaker_state", 0) or 0),
                "fallback": int(bool(timing.get("host_fallback"))),
            }
            line = json.dumps(rec, sort_keys=True, separators=(",", ":"))
        self.lines.append(line)
        self._sha.update(line.encode() + b"\n")
        if self.sink is not None:
            self.sink.write(line + "\n")
            self.sink.flush()
        metrics.sim_cycles_total.inc()
        return line

    # -- trace access ---------------------------------------------------------

    def digest(self) -> str:
        return self._sha.hexdigest()

    def last_record(self) -> Optional[dict]:
        return json.loads(self.lines[-1]) if self.lines else None
