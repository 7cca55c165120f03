"""Virtual clock + pod-lifecycle emulation around the UNMODIFIED scheduler.

The simulator drives the real control-plane stack — ClusterStore,
SchedulerCache, Scheduler.run_once with the production actions/plugins —
against an emulated cluster on a virtual clock:

- arrivals come from a Workload (seeded generator or external JSONL
  trace) as PodGroup + Pending pods;
- binds go through the real DefaultBinder (store write -> watch echo ->
  mirror accounting), wrapped in cache.RecordingBinder so every bind is
  recorded and starts the pod's virtual run clock;
- a bound pod runs for its sampled duration, completes, and releases its
  resources; pods carrying a fail-after annotation fail once mid-run and
  are replaced by a fresh Pending pod (the job controller's recreate
  semantics), feeding failures back into the scheduler as new work;
- evictions (preempt/reclaim) use the graceful-deletion path: a
  virtual-clock evictor stamps deletion_timestamp in virtual seconds and
  the kubelet stand-in (controllers.kubelet.KubeletStandin with the
  virtual clock) finalizes after grace, after which the victim is
  replaced as a real cluster's job controller would.

Nothing in the decision path reads the wall clock: creation timestamps,
deletion timestamps, and grace periods are all virtual, so the same seed
and config reproduce the same decision trace byte for byte.

The scheduler's device arena lives on the CUDA device unless the caller
passes ``device="cpu"``; without a CUDA device and without that argument
the cluster raises (ops.convert.resolve_device) and never falls back to
the host on its own.
"""

from __future__ import annotations

import heapq
import logging
import re
from typing import Dict, List, Optional

from ..api import Resource
from ..api.types import POD_GROUP_ANNOTATION
from ..cache import RecordingBinder, RecordingEvictor, SchedulerCache
from ..cache.cache import DefaultBinder, DefaultEvictor
from ..client.store import ClusterStore, NotFoundError
from ..conf import DEFAULT_SCHEDULER_CONF
from ..controllers import ControllerOption
from ..controllers.kubelet import KubeletStandin
from ..models import Pod
from ..scheduler import Scheduler
from .recorder import DecisionRecorder
from .workload import (
    DURATION_ANNOTATION, FAIL_AFTER_ANNOTATION, Workload, build_job_objects,
)

log = logging.getLogger(__name__)


class VirtualClock:
    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def now(self) -> float:
        return self._now

    def advance(self, dt: float) -> None:
        self._now += dt


class VirtualEvictor(DefaultEvictor):
    """DefaultEvictor with the deletion timestamp taken from the virtual
    clock, so termination grace elapses in virtual seconds."""

    def __init__(self, cluster, clock):
        super().__init__(cluster)
        self._clock = clock

    def evict(self, pod, reason: str) -> None:
        pod.conditions = [c for c in pod.conditions
                          if c.get("type") != "Ready"]
        pod.conditions.append({"type": "Ready", "status": "False",
                               "reason": "Evict", "message": reason})
        if pod.deletion_timestamp is None:
            pod.deletion_timestamp = self._clock()
        self.cluster.update("pods", pod)


#: the default conf with the binpack scorer in the second tier: the conf
#: both arms of a defrag A/B run (the baseline must already pack as well
#: as the scorer can — the rescheduler's gain is un-doing HISTORY, not
#: compensating for a spread-scoring allocate)
BINPACK_CONF = """
actions: "enqueue, allocate, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: binpack
  - name: nodeorder
"""


def build_conf(mode: str = "solver", preempt: bool = False,
               base: Optional[str] = None,
               reschedule: Optional[dict] = None) -> str:
    """Scheduler conf for a sim run: the default conf with the allocate
    execution mode pinned (solver/host/sequential/sharded), optionally
    the preempt action enabled, and optionally the reschedule action
    appended with its bounding arguments (``reschedule`` is a dict with
    any of interval / max_moves / max_disruption_per_job /
    min_improvement)."""
    text = base if base is not None else DEFAULT_SCHEDULER_CONF
    if preempt and "preempt" not in text:
        text = text.replace(
            'actions: "enqueue, allocate, backfill"',
            'actions: "enqueue, allocate, preempt, backfill"')
    blocks = []
    if mode not in (None, "", "solver"):
        block = ("- name: allocate\n"
                 f"  arguments:\n    mode: {mode}\n")
        if mode == "host":
            for act in ("preempt", "reclaim"):
                block += (f"- name: {act}\n"
                          "  arguments:\n    mode: host\n")
        blocks.append(block)
    if reschedule:
        m = re.search(r'(actions:\s*"[^"]*)"', text)
        if m and "reschedule" not in m.group(1):
            text = text[:m.end(1)] + ", reschedule" + text[m.end(1):]
        args = {
            "reschedule.interval": reschedule.get("interval", 10),
            "reschedule.maxMoves": reschedule.get("max_moves", 8),
            "reschedule.maxDisruptionPerJob":
                reschedule.get("max_disruption_per_job", 1),
            "reschedule.minImprovement":
                reschedule.get("min_improvement", 0.01),
        }
        block = "- name: reschedule\n  arguments:\n"
        for k, v in args.items():
            block += f"    {k}: {v}\n"
        blocks.append(block)
    if blocks:
        if "configurations:" in text:
            raise ValueError(
                "build_conf cannot add configurations to a conf that "
                "already has a configurations block; pass the full conf "
                "instead")
        text = text + "\nconfigurations:\n" + "".join(blocks)
    return text


class VirtualCluster:
    """The emulated cluster + the real scheduler, stepped one virtual
    cycle at a time."""

    def __init__(self, workload: Workload, mode: str = "solver",
                 scheduler_conf: Optional[str] = None, dt: float = 1.0,
                 grace_cycles: int = 2, preempt: bool = False,
                 recorder: Optional[DecisionRecorder] = None,
                 solver_mode: Optional[str] = None,
                 sharded_byte_budget: int = 0,
                 reschedule: Optional[dict] = None,
                 device=None):
        self.workload = workload
        self.dt = float(dt)
        self.clock = VirtualClock()
        self.recorder = recorder if recorder is not None \
            else DecisionRecorder(clock=self.clock.now)
        self.store = ClusterStore()
        self.cache = SchedulerCache(self.store, device=device)
        # wall-clock finalize would fire instantly (virtual timestamps
        # look ancient to time.time()); the virtual kubelet below owns
        # eviction finalization instead
        self.cache.EVICTION_FINALIZE_GRACE = float("inf")
        # --solver-mode routing (vcctl sim): the deployment-level
        # preference applies only when the conf leaves the allocate mode
        # implicit (Action.resolve_mode), same as standalone
        if solver_mode:
            self.cache.solver_mode = solver_mode
            self.cache.sharded_byte_budget = int(sharded_byte_budget)
        self.cache.decision_recorder = self.recorder
        self.cache.binder = RecordingBinder(
            DefaultBinder(self.store), on_bind=self._on_bind)
        self.cache.evictor = RecordingEvictor(
            VirtualEvictor(self.store, self.clock.now),
            on_evict=self._on_evict)
        self.cache.run()
        self.kubelet = KubeletStandin(
            grace_seconds=grace_cycles * self.dt, clock=self.clock.now)
        self.kubelet.initialize(ControllerOption(cluster=self.store))
        self.store.watch("pods", self._on_pod_event, replay=False)
        self.sched = Scheduler(
            self.cache,
            scheduler_conf=build_conf(mode, preempt=preempt,
                                      base=scheduler_conf,
                                      reschedule=reschedule))

        # cluster objects (distinct virtual creation timestamps)
        for q in workload.queue_objects():
            self.store.apply("queues", q)
        for pc in workload.priority_class_objects():
            self.store.apply("priorityclasses", pc)
        for node in workload.node_objects():
            self.store.create("nodes", node)
        self._alloc_mcpu = sum(
            Resource.from_resource_list(n.allocatable).milli_cpu
            for n in workload.node_objects())
        # fragmentation reference slot: the workload's largest task shape
        # (free CPU on nodes that can't fit it counts as stranded)
        self._frag_ref = max(workload.spec.cpu_choices or (1,)) * 1000.0

        # lifecycle state
        self._cycle = 0
        self._heap: list = []          # (due_vtime, seq, kind, key)
        self._heap_seq = 0
        self._obj_seq = 0              # per-tick creation-timestamp spread
        self._running: Dict[str, tuple] = {}   # key -> (Resource, job, q)
        self._bind_time: Dict[str, float] = {}  # key -> virtual bind time
        self._expected_delete: set = set()
        self._replaced: Dict[str, int] = {}    # base pod name -> count
        self._job_pods: Dict[str, set] = {}    # jobkey -> pod keys ever

        # quality-score bookkeeping (all virtual-time)
        self.stats = {
            "arrive_time": {}, "ready_time": {}, "complete_time": {},
            "job_size": {}, "min_member": {}, "queue_of": {},
            "bound_count": {}, "completed_count": {},
            "binds": 0, "evictions": 0, "evictions_finalized": 0,
            "failures": 0, "migrations": 0,
            "bound_mcpu": 0.0, "released_mcpu": 0.0,
            "util_samples": [], "frag_samples": [],
            "largest_free_samples": [],
            "queue_running_mcpu": {}, "queue_service": {},
            "queue_weight": {q: w for q, w in workload.spec.queues},
        }

    # -- lifecycle hooks -----------------------------------------------------

    @staticmethod
    def _pod_req(pod) -> Resource:
        return Resource.sum_of(
            Resource.from_resource_list(c.get("requests", {}))
            for c in pod.containers)

    def _on_bind(self, pod, hostname: str) -> None:
        key = f"{pod.namespace}/{pod.name}"
        self.recorder.record_bind(key, hostname)
        st = self.stats
        now = self.clock.now()
        req = self._pod_req(pod)
        jobkey = (f"{pod.namespace}/"
                  f"{pod.annotations.get(POD_GROUP_ANNOTATION, '')}")
        queue = st["queue_of"].get(jobkey, "default")
        self._running[key] = (req, jobkey, queue)
        self._bind_time[key] = now
        st["binds"] += 1
        st["bound_mcpu"] += req.milli_cpu
        st["queue_running_mcpu"][queue] = \
            st["queue_running_mcpu"].get(queue, 0.0) + req.milli_cpu
        bc = st["bound_count"].get(jobkey, 0) + 1
        st["bound_count"][jobkey] = bc
        if jobkey not in st["ready_time"] \
                and bc >= st["min_member"].get(jobkey, 1):
            st["ready_time"][jobkey] = now
        duration = int(pod.annotations.get(DURATION_ANNOTATION, "5"))
        fail_after = pod.annotations.get(FAIL_AFTER_ANNOTATION)
        if fail_after is not None and int(fail_after) < duration:
            self._push(now + int(fail_after) * self.dt, "fail", key)
        else:
            self._push(now + duration * self.dt, "complete", key)

    def _on_evict(self, pod, reason: str) -> None:
        from ..reschedule import MIGRATION_REASON

        key = f"{pod.namespace}/{pod.name}"
        self.recorder.record_evict(key, reason)
        self.stats["evictions"] += 1
        if reason.startswith(MIGRATION_REASON):
            self.stats["migrations"] += 1

    def _push(self, due: float, kind: str, key: str) -> None:
        self._heap_seq += 1
        heapq.heappush(self._heap, (due, self._heap_seq, kind, key))

    def _release(self, key: str) -> None:
        ent = self._running.pop(key, None)
        self._bind_time.pop(key, None)
        if ent is None:
            return
        req, jobkey, queue = ent
        st = self.stats
        st["released_mcpu"] += req.milli_cpu
        st["queue_running_mcpu"][queue] = \
            st["queue_running_mcpu"].get(queue, 0.0) - req.milli_cpu

    def _replacement(self, pod, drop_fail: bool = True,
                     resume_duration: Optional[int] = None) -> Pod:
        """The job controller's recreate semantics: a failed or evicted
        pod comes back as a fresh Pending pod of the same gang. The fail
        annotation is dropped (a task fails once), so replacement chains
        terminate deterministically. ``resume_duration`` overrides the
        replacement's run time: a PLANNED migration (reschedule eviction)
        resumes from checkpoint instead of redoing the work — failures
        and preemptions keep full-restart semantics."""
        base = pod.name.split("-r")[0]
        n = self._replaced.get(base, 0) + 1
        self._replaced[base] = n
        ann = dict(pod.annotations)
        if drop_fail:
            ann.pop(FAIL_AFTER_ANNOTATION, None)
        if resume_duration is not None:
            ann[DURATION_ANNOTATION] = str(int(resume_duration))
        self._obj_seq += 1
        repl = Pod(name=f"{base}-r{n}", namespace=pod.namespace,
                   annotations=ann, containers=pod.containers,
                   priority_class_name=pod.priority_class_name,
                   creation_timestamp=self.clock.now()
                   + self._obj_seq * 1e-4)
        jobkey = (f"{pod.namespace}/"
                  f"{ann.get(POD_GROUP_ANNOTATION, '')}")
        self._job_pods.setdefault(jobkey, set()).add(
            f"{repl.namespace}/{repl.name}")
        return repl

    def _on_pod_event(self, event, obj, old) -> None:
        if event != "delete":
            return
        key = f"{obj.namespace}/{obj.name}"
        if key in self._expected_delete:
            self._expected_delete.discard(key)
            return
        if obj.deletion_timestamp is not None and key in self._running:
            # an evicted pod the virtual kubelet just finalized: release
            # its resources and feed the replacement back as new work.
            # A reschedule-reason eviction is a planned migration of a
            # checkpointed task: the replacement resumes with the
            # remaining duration (progress accrued until the eviction
            # was stamped), so the migration's cost is the grace +
            # requeue disruption, not lost work. Preemptions restart.
            resume = None
            if any(c.get("reason") == "Evict"
                   and str(c.get("message", "")).startswith("reschedule")
                   for c in obj.conditions or []):
                bind_t = self._bind_time.get(key)
                if bind_t is not None:
                    dur = int(obj.annotations.get(DURATION_ANNOTATION,
                                                  "5"))
                    ran = int(max(0.0, obj.deletion_timestamp - bind_t)
                              / self.dt)
                    resume = max(1, dur - ran)
            self._release(key)
            self.stats["evictions_finalized"] += 1
            self.recorder.record_event("evict_finalized", key)
            repl = self._replacement(obj, resume_duration=resume)
            self.store.create("pods", repl)
            self.recorder.record_event(
                "replace", f"{repl.namespace}/{repl.name}")

    # -- virtual event delivery ----------------------------------------------

    def _deliver_due(self) -> None:
        now = self.clock.now() + 1e-9
        st = self.stats
        while self._heap and self._heap[0][0] <= now:
            _, _, kind, key = heapq.heappop(self._heap)
            ns, name = key.split("/", 1)
            pod = self.store.try_get("pods", name, ns)
            if pod is None or pod.deletion_timestamp is not None \
                    or key not in self._running:
                continue  # completed/evicted/replaced under this event
            if kind == "complete":
                _, jobkey, _q = self._running[key]
                self._release(key)
                # the pod STAYS, as Succeeded, until the whole job
                # completes — gang counts terminated tasks toward
                # minAvailable (the cache's add_task keeps them on the
                # job, only node accounting skips them), so deleting a
                # finished pod early would make the gang plugin veto the
                # job's still-running/replaced siblings
                pod.phase = "Succeeded"
                self.store.update("pods", pod)
                self.recorder.record_event("complete", key)
                cc = st["completed_count"].get(jobkey, 0) + 1
                st["completed_count"][jobkey] = cc
                if cc >= st["job_size"].get(jobkey, 1 << 30):
                    st["complete_time"][jobkey] = self.clock.now()
                    self._retire_job(jobkey)
            elif kind == "fail":
                self._release(key)
                st["failures"] += 1
                self._expected_delete.add(key)
                pod.phase = "Failed"
                self.store.update("pods", pod)
                self.store.delete("pods", name, ns)
                self.recorder.record_event("fail", key)
                repl = self._replacement(pod)
                self.store.create("pods", repl)
                self.recorder.record_event(
                    "replace", f"{repl.namespace}/{repl.name}")

    def _retire_job(self, jobkey: str) -> None:
        """All tasks completed: remove the job's pods (now Succeeded) and
        its podgroup so the pending set stays bounded over long runs."""
        ns, pg_name = jobkey.split("/", 1)
        for podkey in sorted(self._job_pods.pop(jobkey, ())):
            pns, pname = podkey.split("/", 1)
            if self.store.try_get("pods", pname, pns) is not None:
                self._expected_delete.add(podkey)
                try:
                    self.store.delete("pods", pname, pns)
                except NotFoundError:
                    self._expected_delete.discard(podkey)
        try:
            self.store.delete("podgroups", pg_name, ns)
        except NotFoundError:
            pass

    # -- workload injection ----------------------------------------------------

    def _submit(self, ev: dict) -> None:
        self._obj_seq += 1
        pg, pods = build_job_objects(ev, self.clock.now(),
                                     seq_base=self._obj_seq * 1e-4)
        self._obj_seq += len(pods)
        jobkey = f"{pg.namespace}/{pg.name}"
        st = self.stats
        st["arrive_time"][jobkey] = self.clock.now()
        st["job_size"][jobkey] = len(pods)
        st["min_member"][jobkey] = pg.spec.min_member
        st["queue_of"][jobkey] = pg.spec.queue
        self.store.create("podgroups", pg)
        pod_keys = self._job_pods.setdefault(jobkey, set())
        for pod in pods:
            self.store.create("pods", pod)
            pod_keys.add(f"{pod.namespace}/{pod.name}")
        self.recorder.record_event("arrival", jobkey)

    # -- the cycle -------------------------------------------------------------

    def tick(self) -> str:
        """One virtual cycle: deliver due lifecycle events, finalize
        graceful deletions, inject arrivals, run ONE unmodified scheduler
        cycle, sample utilization, emit the cycle's trace record."""
        rec = self.recorder
        rec.begin_cycle(self._cycle)
        self._obj_seq = 0
        self._deliver_due()
        self.kubelet.process_all()
        for ev in self.workload.arrivals(self._cycle):
            self._submit(ev)
        self.cache.process_resync_tasks()
        self.sched.run_once()
        self._sample()
        line = rec.end_cycle(self.sched.last_cycle_timing)
        self.clock.advance(self.dt)
        self._cycle += 1
        return line

    def _sample(self) -> None:
        from ..reschedule import stranded_fraction

        st = self.stats
        used = sum(ni.used.milli_cpu for ni in self.cache.nodes.values())
        st["util_samples"].append(
            used / self._alloc_mcpu if self._alloc_mcpu else 0.0)
        free = [ni.idle.milli_cpu for ni in self.cache.nodes.values()
                if ni.node is not None]
        st["frag_samples"].append(
            stranded_fraction(free, self._frag_ref))
        cap = max((ni.allocatable.milli_cpu
                   for ni in self.cache.nodes.values()
                   if ni.node is not None), default=0.0)
        st["largest_free_samples"].append(
            max(free) / cap if free and cap else 0.0)
        for q, mcpu in st["queue_running_mcpu"].items():
            st["queue_service"][q] = \
                st["queue_service"].get(q, 0.0) + mcpu * self.dt

    def all_complete(self) -> bool:
        return all(j in self.stats["complete_time"]
                   for j in self.stats["arrive_time"])

    def run(self, cycles: int, drain: int = 0) -> List[str]:
        """Run ``cycles`` ticks, then up to ``drain`` extra ticks to let
        in-flight jobs finish (stops early once everything completed)."""
        lines = [self.tick() for _ in range(cycles)]
        for _ in range(drain):
            if self.all_complete():
                break
            lines.append(self.tick())
        return lines

    # -- invariants ------------------------------------------------------------

    def conservation(self) -> dict:
        """Lifecycle conservation: all bound resources are either still
        running or were released (completion/failure/eviction)."""
        running = sum(r.milli_cpu for r, _, _ in self._running.values())
        st = self.stats
        idle_ok = all(
            ni.used.milli_cpu < 1e-6 for ni in self.cache.nodes.values()
        ) if not self._running else None
        return {
            "bound_mcpu": st["bound_mcpu"],
            "released_mcpu": st["released_mcpu"],
            "running_mcpu": running,
            "balanced": abs(st["bound_mcpu"] - st["released_mcpu"]
                            - running) < 1e-6,
            "nodes_idle_when_empty": idle_ok,
        }
