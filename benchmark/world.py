"""The system under test and the benchmark's record of what it was given.

``World`` builds the port's in-memory ``ClusterStore``, a
``SchedulerCache`` fed by the store's watch handlers, and a ``Scheduler``
with the configuration's conf, and installs ``StampingBinder``. The
traffic submits and completes gangs through it (store writes only); each
cycle runs the deployment loop's body (resync, ``run_once``, the
between-cycles collection) with the schedule period left out. Beside the
program, the World keeps the cluster as the benchmark handed it to the
store (``reference.ClusterState``) and, per cycle, what went in and what
was bound, for the metrics and the correctness check.
"""

from __future__ import annotations

import contextlib
import copy
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .binder import StampingBinder
from .reference import ClusterState, Gang, Node, Queue
from .reference.resource import parse_request


@dataclass
class GangSpec:
    """One gang as the traffic submits it: ``size`` pods alike."""

    name: str
    queue: str
    size: int
    min_member: int
    request: Dict[str, str]
    ct: float


def shape_of(g: GangSpec) -> tuple:
    """A gang's queue and pod request: what a completion is matched on."""
    return (g.queue, tuple(sorted(g.request.items())))


@dataclass
class Cycle:
    index: int
    t_intake: float = 0.0       # intake started
    t_start: float = 0.0        # run_once called
    t_end: float = 0.0          # run_once returned
    completed: List[str] = field(default_factory=list)
    submitted: List[str] = field(default_factory=list)
    timing: dict = field(default_factory=dict)
    failure: Optional[str] = None


class World:
    def __init__(self, config: dict, device: str, build_dir: str):
        from volcano_tpu_torch.cache import FakeEvictor, SchedulerCache
        from volcano_tpu_torch.client import ClusterStore
        from volcano_tpu_torch.models import Node as PNode, Queue as PQueue, \
            QueueSpec
        from volcano_tpu_torch.scheduler import Scheduler

        self.ns = config.get("namespace", "bench")
        self.store = ClusterStore()
        self.cache = SchedulerCache(self.store, device=device)
        self.binder = StampingBinder()
        self.cache.binder = self.binder
        self.cache.evictor = FakeEvictor()
        self.cache.run()
        queues = []
        for i, q in enumerate(config["queues"]):
            ann = {}
            if q.get("hierarchy"):
                ann = {"volcano.sh/hierarchy": q["hierarchy"],
                       "volcano.sh/hierarchy-weights": q["weights"]}
            self.store.apply("queues", PQueue(
                name=q["name"], annotations=ann,
                spec=QueueSpec(weight=q["weight"]),
                creation_timestamp=float(i)))
            queues.append(Queue(q["name"], q["weight"], q.get("hierarchy", ""),
                                q.get("weights", ""), float(i)))
        spec = config["nodes"]
        alloc = dict(spec["allocatable"])
        nodes = []
        for i in range(spec["count"]):
            name = f"n{i}"
            self.store.create("nodes", PNode(name=name, uid=name,
                                             allocatable=dict(alloc),
                                             capacity=dict(alloc)))
            nodes.append(Node(name, parse_request(alloc), int(alloc["pods"])))
        self.state = ClusterState(self.ns, nodes, queues)
        self.sched = Scheduler(self.cache, scheduler_conf=config["conf"],
                               compile_cache_dir=build_dir)
        self.gangs: Dict[str, GangSpec] = {}
        self.records: Dict[str, Gang] = {}   # every gang ever submitted
        self.submit_t: Dict[str, float] = {}
        self.cycles: List[Cycle] = []
        self.cur: Optional[Cycle] = None
        # bound pods per gang, and the fully bound gangs in the order they
        # became so (kept as the binds come, so intake never scans)
        self._nbound: Dict[str, int] = {}
        self._bound: Dict[str, None] = {}
        self._bound_by: Dict[tuple, Dict[str, None]] = {}

    # -- intake -------------------------------------------------------------

    def build(self, g: GangSpec) -> tuple:
        """The store objects of a gang: its podgroup and pods."""
        from volcano_tpu_torch.api.types import POD_GROUP_ANNOTATION
        from volcano_tpu_torch.models import (
            Pod, PodGroup, PodGroupPhase, PodGroupSpec, PodGroupStatus,
        )
        pg = PodGroup(name=g.name, namespace=self.ns, uid=f"pg-{g.name}",
                      spec=PodGroupSpec(min_member=g.min_member,
                                        queue=g.queue),
                      status=PodGroupStatus(phase=PodGroupPhase.PENDING),
                      creation_timestamp=g.ct)
        pods = [Pod(name=f"{g.name}-{i}", namespace=self.ns,
                    uid=f"{g.name}-{i:04d}", phase="Pending",
                    annotations={POD_GROUP_ANNOTATION: g.name},
                    containers=[{"requests": dict(g.request)}],
                    creation_timestamp=g.ct)
                for i in range(g.size)]
        return pg, pods

    def submit(self, g: GangSpec) -> None:
        pg, pods = self.build(g)
        self.submit_t[g.name] = time.perf_counter()
        self.store.create("podgroups", pg)
        for p in pods:
            self.store.create("pods", p)
        self.gangs[g.name] = g
        rec = self.records[g.name] = Gang(
            g.name, g.queue, g.min_member, [p.name for p in pods],
            [p.uid for p in pods], parse_request(g.request), g.ct)
        self.state.gangs[g.name] = rec
        if self.cur is not None:
            self.cur.submitted.append(g.name)

    def complete(self, name: str) -> None:
        """A bound gang finishes: its pods and podgroup are deleted."""
        g = self.state.gangs.pop(name)
        for pod in g.pods:
            self.store.delete("pods", pod, self.ns)
            self.state.placed.pop(pod, None)
        self.store.delete("podgroups", name, self.ns)
        self._nbound.pop(name, None)
        if self._bound.pop(name, 0) is None:
            del self._bound_by[shape_of(self.gangs[name])][name]
        del self.gangs[name]
        if self.cur is not None:
            self.cur.completed.append(name)

    def bound_gangs(self, shape: Optional[tuple] = None) -> List[str]:
        """Gangs whose every pod is bound (of ``shape``, ``shape_of``), in
        the order they became so."""
        if shape is None:
            return list(self._bound)
        return list(self._bound_by.get(shape, ()))

    def n_pending(self) -> int:
        """Submitted gangs none of whose pods is bound."""
        return len(self.gangs) - len(self._nbound)

    # -- cycles -------------------------------------------------------------

    def begin(self) -> Cycle:
        """Open the next cycle's record; intake that follows is its own."""
        c = Cycle(len(self.cycles), t_intake=time.perf_counter())
        self.cycles.append(c)
        self.cur = c
        return c

    def run(self, c: Cycle, span=None) -> None:
        """One pass of the deployment loop's body, period left out;
        ``span(name)``, when given, wraps the cycle ("run_once") and the
        collection after it ("gc") as context managers."""
        self.binder.cycle = c.index
        n_before = len(self.binder.records)
        with span("run_once") if span else contextlib.nullcontext():
            c.t_start = time.perf_counter()
            try:
                self.cache.process_resync_tasks()
                self.sched.run_once()
            except Exception as e:  # noqa: BLE001 — a failed cycle counts
                c.failure = f"raised {type(e).__name__}: {e}"
            c.t_end = time.perf_counter()
        t = self.sched.last_cycle_timing or {}
        c.timing = t
        if c.failure is None:
            for key in ("host_fallback", "allocate_error", "allocate_timeout",
                        "enqueue_error", "backfill_error"):
                if t.get(key):
                    c.failure = key
                    break
            else:
                if self.cache.breaker.state_code != 0:
                    c.failure = "breaker_open"
        with span("gc") if span else contextlib.nullcontext():
            self.sched._maybe_gc()
        for rec in self.binder.records[n_before:]:
            pod = rec[1].split("/", 1)[1]
            self.state.placed[pod] = rec[2]
            gang = pod.rsplit("-", 1)[0]
            n = self._nbound[gang] = self._nbound.get(gang, 0) + 1
            if n == self.gangs[gang].size:
                self._bound[gang] = None
                self._bound_by.setdefault(shape_of(self.gangs[gang]),
                                          {})[gang] = None
        self.cur = None

    def snapshot(self) -> ClusterState:
        """The cluster as handed to the store, now (a deep copy)."""
        return copy.deepcopy(self.state)
