"""The system under test and the benchmark's record of what it was given.

``World`` builds the port's in-memory ``ClusterStore``, a
``SchedulerCache`` fed by the store's watch handlers, and a ``Scheduler``
with the configuration's conf, and installs ``StampingBinder`` and
``StampingEvictor``. The configuration may add priority classes
(``"priority_classes": {name: value}``) and give a queue ``capability`` and
``reclaimable``; a gang (``GangSpec``) may take a priority class. Each
cycle runs the deployment loop's body (resync, ``run_once``, the
between-cycles collection) with the schedule period left out.

The traffic drives the store through these methods only, each recorded on
the cycle in order (``Cycle.events``) so that the check's replay follows
it:
- ``submit(gang)``: a new gang, Pending;
- ``place(gang, nodes)``: a gang whose pods already run on those nodes;
- ``complete(name)``: a gang finishes, its pods and podgroup deleted;
- ``report_running(pods)``: what a kubelet reports: bound pods written
  back with their node and phase Running;
- ``release(pod, recreate=True)``: an evicted pod ends and is deleted; with
  ``recreate`` it is made again Pending under its gang, as Volcano's job
  controller remakes a vcjob's missing pod.
Beside the program, the World keeps the cluster as the benchmark handed
it to the store (``reference.ClusterState``: where each pod is placed,
which are running and which releasing) and, per cycle, what went in and
what was bound and evicted, for the metrics and the correctness check.
A cycle fails on any ``<action>_error``, ``<action>_timeout`` or
``<action>_fault_reason`` of its timing, on ``host_fallback`` and on an
open breaker.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from .binder import StampingBinder, StampingEvictor
from .reference import ClusterState, Gang, Node, Queue
from .reference.resource import parse_request

#: the timing keys (by suffix) that mark a failed action
FAILURE_SUFFIXES = ("_error", "_timeout", "_fault_reason")


@dataclass
class GangSpec:
    """One gang as the traffic submits it: ``size`` pods alike."""

    name: str
    queue: str
    size: int
    min_member: int
    request: Dict[str, str]
    ct: float
    priority_class: str = ""     # "": none, as before priority classes


def shape_of(g: GangSpec) -> tuple:
    """A gang's queue and pod request: what a completion is matched on."""
    return (g.queue, tuple(sorted(g.request.items())))


def gang_of(pod: str) -> str:
    """The gang a pod name belongs to (pods are ``<gang>-<index>``)."""
    return pod.rsplit("-", 1)[0]


@dataclass
class Cycle:
    index: int
    t_intake: float = 0.0       # intake started
    t_start: float = 0.0        # run_once called
    t_end: float = 0.0          # run_once returned
    submitted: List[str] = field(default_factory=list)
    events: List[tuple] = field(default_factory=list)   # apply_event's
    timing: dict = field(default_factory=dict)
    failure: Optional[str] = None


def apply_event(state: ClusterState, ev: tuple, gangs: Dict[str, Gang]
                ) -> None:
    """Advance ``state`` by one of the traffic's store writes, as recorded
    in ``Cycle.events``; ``gangs``: every gang as submitted, by name."""
    kind = ev[0]
    if kind in ("submit", "place"):
        g = gangs[ev[1]]
        state.gangs[g.name] = g
        if kind == "place":
            for pod, node in zip(g.pods, ev[2]):
                state.placed[pod] = node
                state.running.add(pod)
    elif kind == "complete":
        for pod in state.gangs.pop(ev[1]).pods:
            _unplace(state, pod)
    elif kind == "running":
        state.running.update(ev[1])
    elif kind == "release":
        pod, uid = ev[1], ev[2]
        _unplace(state, pod)
        g = state.gangs[gang_of(pod)]
        i = g.pods.index(pod)
        if uid is None:
            state.gangs[g.name] = dataclasses.replace(
                g, pods=g.pods[:i] + g.pods[i + 1:],
                pod_uids=g.pod_uids[:i] + g.pod_uids[i + 1:])
        else:
            state.gangs[g.name] = dataclasses.replace(
                g, pod_uids=g.pod_uids[:i] + [uid] + g.pod_uids[i + 1:])
    else:
        raise ValueError(f"unknown event {ev!r}")


def apply_decisions(state: ClusterState, binds: Dict[str, str],
                    evictions: Sequence[str]) -> None:
    """Advance ``state`` by a cycle's binds ({"ns/pod": node}) and
    evictions ("ns/pod" keys): a bound pod is placed (still binding), an
    evicted one stops running and is releasing."""
    for key, node in binds.items():
        state.placed[key.split("/", 1)[1]] = node
    for key in evictions:
        pod = key.split("/", 1)[1]
        state.running.discard(pod)
        state.releasing.add(pod)


def _unplace(state: ClusterState, pod: str) -> None:
    state.placed.pop(pod, None)
    state.running.discard(pod)
    state.releasing.discard(pod)


class World:
    def __init__(self, config: dict, device: str, build_dir: str):
        from volcano_tpu_torch.cache import SchedulerCache
        from volcano_tpu_torch.client import ClusterStore
        from volcano_tpu_torch.models import Node as PNode, \
            PriorityClass, Queue as PQueue, QueueSpec
        from volcano_tpu_torch.scheduler import Scheduler

        self.ns = config.get("namespace", "bench")
        self.store = ClusterStore()
        self.cache = SchedulerCache(self.store, device=device)
        self.binder = StampingBinder()
        self.cache.binder = self.binder
        self.evictor = StampingEvictor()
        self.cache.evictor = self.evictor
        self.cache.run()
        self.priority_classes: Dict[str, int] = dict(
            config.get("priority_classes", {}))
        for name, value in self.priority_classes.items():
            self.store.create("priorityclasses", PriorityClass(name, value))
        queues = []
        for i, q in enumerate(config["queues"]):
            ann = {}
            if q.get("hierarchy"):
                ann = {"volcano.sh/hierarchy": q["hierarchy"],
                       "volcano.sh/hierarchy-weights": q["weights"]}
            self.store.apply("queues", PQueue(
                name=q["name"], annotations=ann,
                spec=QueueSpec(weight=q["weight"],
                               capability=dict(q.get("capability", {})),
                               reclaimable=q.get("reclaimable")),
                creation_timestamp=float(i)))
            queues.append(Queue(
                q["name"], q["weight"], q.get("hierarchy", ""),
                q.get("weights", ""), float(i),
                parse_request(q["capability"]) if q.get("capability")
                else None, q.get("reclaimable")))
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
        # pods bound and not yet reported Running, pods evicted and not yet
        # released, in the order they became so; recreations per pod
        self.binding: Dict[str, None] = {}
        self.releasing: Dict[str, None] = {}
        self._remade: Dict[str, int] = {}

    # -- intake -------------------------------------------------------------

    def _pod(self, g: GangSpec, i: int, uid: str, node: str = ""):
        from volcano_tpu_torch.api.types import POD_GROUP_ANNOTATION
        from volcano_tpu_torch.models import Pod
        extra = {}
        if g.priority_class:
            extra = {"priority": self.priority_classes[g.priority_class],
                     "priority_class_name": g.priority_class}
        return Pod(name=f"{g.name}-{i}", namespace=self.ns, uid=uid,
                   phase="Running" if node else "Pending", node_name=node,
                   annotations={POD_GROUP_ANNOTATION: g.name},
                   containers=[{"requests": dict(g.request)}],
                   creation_timestamp=g.ct, **extra)

    def build(self, g: GangSpec, nodes: Sequence[str] = ()) -> tuple:
        """The store objects of a gang: its podgroup and pods (running on
        ``nodes``, one a pod, when given)."""
        from volcano_tpu_torch.models import (
            PodGroup, PodGroupPhase, PodGroupSpec, PodGroupStatus,
        )
        phase = PodGroupPhase.RUNNING if nodes else PodGroupPhase.PENDING
        pg = PodGroup(name=g.name, namespace=self.ns, uid=f"pg-{g.name}",
                      spec=PodGroupSpec(min_member=g.min_member,
                                        queue=g.queue,
                                        priority_class_name=g.priority_class),
                      status=PodGroupStatus(phase=phase),
                      creation_timestamp=g.ct)
        pods = [self._pod(g, i, f"{g.name}-{i:04d}",
                          nodes[i] if nodes else "")
                for i in range(g.size)]
        return pg, pods

    def _record(self, ev: tuple) -> None:
        apply_event(self.state, ev, self.records)
        if self.cur is not None:
            self.cur.events.append(ev)

    def submit(self, g: GangSpec) -> None:
        """A new gang, its podgroup and pods Pending."""
        self._add(g, ())

    def place(self, g: GangSpec, nodes: Sequence[str]) -> None:
        """Submit a gang whose pods already run, pod i on ``nodes[i]``, as
        a kubelet reports them (its podgroup Running)."""
        if len(nodes) != g.size:
            raise ValueError(f"{g.name}: {g.size} pods, {len(nodes)} nodes")
        self._add(g, nodes)

    def _add(self, g: GangSpec, nodes: Sequence[str]) -> None:
        pg, pods = self.build(g, nodes)
        if not nodes:
            self.submit_t[g.name] = time.perf_counter()
        self.store.create("podgroups", pg)
        for p in pods:
            self.store.create("pods", p)
        self.gangs[g.name] = g
        self.records[g.name] = Gang(
            g.name, g.queue, g.min_member, [p.name for p in pods],
            [p.uid for p in pods], parse_request(g.request), g.ct,
            self.priority_classes[g.priority_class] if g.priority_class
            else 0)
        if nodes:
            self._record(("place", g.name, tuple(nodes)))
            self._nbound[g.name] = g.size
            self._mark_bound(g.name)
            return
        self._record(("submit", g.name))
        if self.cur is not None:
            self.cur.submitted.append(g.name)

    def complete(self, name: str) -> None:
        """A bound gang finishes: its pods and podgroup are deleted."""
        for pod in self.state.gangs[name].pods:
            self.store.delete("pods", pod, self.ns)
            self.binding.pop(pod, None)
            self.releasing.pop(pod, None)
        self.store.delete("podgroups", name, self.ns)
        self._record(("complete", name))
        self._nbound.pop(name, None)
        self._unmark_bound(name)
        del self.gangs[name]

    def report_running(self, pods: Sequence[str]) -> None:
        """A kubelet's report: each bound pod (by name) is written back to
        the store with its node and phase Running."""
        for pod in pods:
            if pod not in self.binding:
                raise ValueError(f"{pod} is not bound and unreported")
            obj = copy.copy(self.store.get("pods", pod, self.ns))
            obj.node_name = self.state.placed[pod]
            obj.phase = "Running"
            self.store.update("pods", obj)
            del self.binding[pod]
        self._record(("running", tuple(pods)))

    def release(self, pod: str, recreate: bool = True) -> None:
        """An evicted pod ends: deleted from the store; with ``recreate``
        made again, Pending, under its gang (same name, a new uid)."""
        name = gang_of(pod)
        g = self.gangs[name]
        self.store.delete("pods", pod, self.ns)
        uid = None
        if recreate:
            n = self._remade[pod] = self._remade.get(pod, 0) + 1
            i = int(pod.rsplit("-", 1)[1])
            uid = f"{name}-{i:04d}-{n}"
            self.store.create("pods", self._pod(g, i, uid))
        was_placed = pod in self.state.placed
        self.binding.pop(pod, None)
        self.releasing.pop(pod, None)
        self._record(("release", pod, uid))
        if was_placed:
            self._unmark_bound(name)
            n = self._nbound[name] - 1
            if n:
                self._nbound[name] = n
            else:
                del self._nbound[name]

    def _mark_bound(self, name: str) -> None:
        self._bound[name] = None
        self._bound_by.setdefault(shape_of(self.gangs[name]),
                                  {})[name] = None

    def _unmark_bound(self, name: str) -> None:
        if self._bound.pop(name, 0) is None:
            del self._bound_by[shape_of(self.gangs[name])][name]

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
        self.binder.cycle = self.evictor.cycle = c.index
        n_before = len(self.binder.records)
        e_before = len(self.evictor.records)
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
            for key, v in t.items():
                if v and (key == "host_fallback"
                          or key.endswith(FAILURE_SUFFIXES)):
                    c.failure = key
                    break
            else:
                if self.cache.breaker.state_code != 0:
                    c.failure = "breaker_open"
        with span("gc") if span else contextlib.nullcontext():
            self.sched._maybe_gc()
        binds = {rec[1]: rec[2] for rec in self.binder.records[n_before:]}
        evicted = [rec[1] for rec in self.evictor.records[e_before:]]
        apply_decisions(self.state, binds, evicted)
        for key in binds:
            pod = key.split("/", 1)[1]
            self.binding[pod] = None
            gang = gang_of(pod)
            n = self._nbound[gang] = self._nbound.get(gang, 0) + 1
            if n == len(self.state.gangs[gang].pods):
                self._mark_bound(gang)
        for key in evicted:
            pod = key.split("/", 1)[1]
            self.binding.pop(pod, None)
            self.releasing[pod] = None
        self.cur = None

    def snapshot(self) -> ClusterState:
        """The cluster as handed to the store, now (a deep copy)."""
        return copy.deepcopy(self.state)
