"""SchedulerCache: the cluster-state mirror behind every session.

Reimplements reference pkg/scheduler/cache/{cache.go:71-855,
event_handlers.go:43-710} against the ClusterStore seam instead
of client-go informers. Single-threaded (one host core): effector calls are
synchronous, with the reference's resync-on-failure behavior preserved via an
err-task queue drained at the top of each cycle.
"""

from __future__ import annotations

import logging
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

from ..api import (
    ClusterInfo, JobInfo, NamespaceCollection, NodeInfo, QueueInfo, Resource,
    TaskInfo, TaskStatus,
)
from ..api.job_info import job_key_of_pod, pod_key, status_of_pod
from ..models import (
    PodGroup, PodGroupCondition, PodGroupPhase, Queue, QueueSpec,
)
from ..client.store import ClusterStore, ConflictError, NotFoundError
from ..metrics import metrics, tracing

log = logging.getLogger(__name__)

#: pod fields a delta watch patch may change while staying on the
#: targeted-update path (apply_pod_delta): none of these move the task
#: to a different job (annotations), change its identity (name/
#: namespace/uid), its resource shape (containers/init_containers), or
#: its owner (scheduler_name) — changes outside this set rebuild the
#: TaskInfo through the generic update ladder
_DELTA_FAST_FIELDS = frozenset((
    "phase", "deletion_timestamp", "node_name", "priority",
    "resource_version", "container_statuses", "conditions", "labels",
))


class DefaultBinder:
    """Writes the binding back to the cluster store (the reference POSTs a
    v1.Binding; the store reflects it into pod.node_name like kubelet+etcd
    would, cache.go:117-131)."""

    def __init__(self, cluster: ClusterStore):
        self.cluster = cluster

    def bind(self, pod, hostname: str) -> None:
        pod.node_name = hostname
        pod.phase = "Running"
        self.cluster.update("pods", pod)


class DefaultEvictor:
    """Sets PodReady=false then requests graceful deletion (cache.go:139-169).

    Deletion is graceful, as in k8s: the pod gets a deletion_timestamp and
    stays bound (task goes Releasing, so the freed space is FutureIdle, not
    Idle) until the kubelet stand-in finalizes the termination and removes
    the pod. Instant removal here would let the victim's replacement pod be
    recreated and re-bound in the very next cycle, starving the
    preemptor/reclaimer forever."""

    def __init__(self, cluster: ClusterStore):
        self.cluster = cluster

    def evict(self, pod, reason: str) -> None:
        pod.conditions = [c for c in pod.conditions if c.get("type") != "Ready"]
        pod.conditions.append({"type": "Ready", "status": "False",
                               "reason": "Evict", "message": reason})
        if pod.deletion_timestamp is None:
            pod.deletion_timestamp = time.time()
        self.cluster.update("pods", pod)


class DefaultStatusUpdater:
    def __init__(self, cluster: ClusterStore):
        self.cluster = cluster

    def update_pod_condition(self, pod, condition: dict) -> None:
        replaced = False
        for i, c in enumerate(pod.conditions):
            if c.get("type") == condition.get("type"):
                if c == condition:
                    # no-op rewrite: an unschedulable pod re-reported with
                    # the SAME condition every cycle would otherwise churn
                    # the store (and every mirror fed by it) per cycle —
                    # exactly the noise that keeps a quiet cluster's
                    # event-sourced flatten from being O(0)
                    return
                pod.conditions[i] = condition
                replaced = True
        if not replaced:
            pod.conditions.append(condition)
        if self.cluster.try_get("pods", pod.name, pod.namespace) is not None:
            self.cluster.update("pods", pod)

    def update_pod_group(self, pg) -> None:
        self.cluster.apply("podgroups", pg)


#: the WaitForFirstConsumer node pin (k8s volume-scheduling annotation)
SELECTED_NODE_ANNOTATION = "volume.kubernetes.io/selected-node"


class DefaultVolumeBinder:
    """WaitForFirstConsumer-style claim Assume/Bind against the cluster
    store (reference pkg/scheduler/cache/cache.go:234-254, which wraps k8s
    volumescheduling's AssumePodVolumes/BindPodVolumes; here the store
    itself plays the PV controller).

    allocate_volumes (statement.go:230-282's AllocateVolumes step) verifies
    every claim the pod references exists and is bindable on the chosen
    node, then records the tentative selection in memory — nothing is
    written. bind_volumes (statement Commit) writes the selected-node pin
    and flips the claim Bound; a write failure raises, and the statement's
    commit handler unwinds + resyncs the task. revert_volumes (statement
    Discard) drops the in-memory assumption."""

    def __init__(self, cluster):
        self.cluster = cluster
        # pod uid -> {(ns, claim): node} — in-flight Assume decisions,
        # visible to later assumes/predicates like volumescheduling's
        # assume cache (two same-session pods sharing a claim must agree);
        # session-scoped: the scheduler drops them at the next snapshot
        self._assumed: Dict[str, Dict[tuple, str]] = {}
        # reverse index for O(1) pin lookups on the predicate hot path
        self._assumed_by_claim: Dict[tuple, str] = {}

    def has_assumed(self) -> bool:
        """Whether any pod holds an in-flight volume assumption — when not,
        bind_volumes is a no-op for every task and batch commits skip the
        per-task calls entirely."""
        return bool(self._assumed)

    def allocate_volumes_batch(self, pairs) -> list:
        """allocate_volumes over [(task, hostname)]; returns
        [(task, hostname, exc)] failures. Volume-less pods (the typical
        burst) skip straight to volume_ready."""
        failures = []
        for task, hostname in pairs:
            if not getattr(task.pod, "volumes", None):
                task.volume_ready = True
                continue
            try:
                self.allocate_volumes(task, hostname)
            except (KeyError, ValueError) as e:
                failures.append((task, hostname, e))
        return failures

    @staticmethod
    def _claims(pod):
        for vol in getattr(pod, "volumes", None) or []:
            ref = (vol.get("persistentVolumeClaim") or {}).get("claimName")
            if ref:
                yield ref

    def missing_claims(self, pod) -> List[str]:
        return [name for name in self._claims(pod)
                if self.cluster.try_get("pvcs", name, pod.namespace) is None]

    def _pinned_node(self, key) -> Optional[str]:
        """Node a claim is pinned to: a written selected-node annotation,
        or any in-flight assumption. None = claim missing."""
        pvc = self.cluster.try_get("pvcs", key[1], key[0])
        if pvc is None:
            return None
        sel = (pvc.annotations or {}).get(SELECTED_NODE_ANNOTATION, "")
        return sel or self._assumed_by_claim.get(key, "")

    def node_ok(self, pod, hostname: str) -> bool:
        """Predicate half (volume-binding filter): every claim must exist
        and be unpinned or pinned to this node."""
        for name in self._claims(pod):
            sel = self._pinned_node((pod.namespace, name))
            if sel is None or (sel and sel != hostname):
                return False
        return True

    def drop_assumptions(self) -> None:
        """Called at snapshot time: assumptions are session-scoped (an
        uncommitted assume from a job that never dispatched must not pin
        the claim forever)."""
        self._assumed.clear()
        self._assumed_by_claim.clear()

    def allocate_volumes(self, task: TaskInfo, hostname: str) -> None:
        pod = task.pod
        assumed = {}
        for name in self._claims(pod):
            key = (pod.namespace, name)
            sel = self._pinned_node(key)
            if sel is None:
                raise ValueError(
                    f"pvc <{pod.namespace}/{name}> for task <{task.key}> "
                    "not found")
            if sel and sel != hostname:
                raise ValueError(
                    f"pvc <{pod.namespace}/{name}> is pinned to node "
                    f"<{sel}>, cannot allocate <{task.key}> on <{hostname}>")
            assumed[key] = hostname
        if assumed:
            self._assumed[pod.uid] = assumed
            self._assumed_by_claim.update(assumed)
        task.volume_ready = True

    def _drop_pod(self, pod_uid: str) -> Optional[Dict[tuple, str]]:
        assumed = self._assumed.pop(pod_uid, None)
        if assumed:
            for key in assumed:
                # keep the reverse entry if another in-flight pod still
                # assumes the same claim (same node by construction)
                if not any(key in m for m in self._assumed.values()):
                    self._assumed_by_claim.pop(key, None)
        return assumed

    def bind_volumes(self, task: TaskInfo) -> None:
        pod = task.pod
        assumed = self._drop_pod(pod.uid)
        if not assumed:
            return
        written = []
        try:
            for (ns, name), node in assumed.items():
                pvc = self.cluster.get("pvcs", name, ns)
                sel = (pvc.annotations or {}).get(
                    SELECTED_NODE_ANNOTATION, "")
                if sel and sel != node:
                    raise ValueError(
                        f"pvc <{ns}/{name}> was bound to <{sel}> while "
                        f"assumed on <{node}>")
                prev = (pvc.annotations.get(SELECTED_NODE_ANNOTATION),
                        pvc.phase, pvc.volume_name)
                pvc.annotations[SELECTED_NODE_ANNOTATION] = node
                pvc.phase = "Bound"
                pvc.volume_name = pvc.volume_name or f"pv-{name}"
                self.cluster.update("pvcs", pvc)
                written.append((pvc, prev))
        except Exception:
            # unwind partial multi-claim binds so one stuck claim can't
            # strand the pod half-pinned forever
            for pvc, (prev_sel, prev_phase, prev_vol) in reversed(written):
                if prev_sel is None:
                    pvc.annotations.pop(SELECTED_NODE_ANNOTATION, None)
                else:
                    pvc.annotations[SELECTED_NODE_ANNOTATION] = prev_sel
                pvc.phase = prev_phase
                pvc.volume_name = prev_vol
                try:
                    self.cluster.update("pvcs", pvc)
                except Exception:
                    log.exception("failed to unwind pvc bind for %s",
                                  pvc.name)
            task.volume_ready = False
            raise

    def revert_volumes(self, task: TaskInfo) -> None:
        if self._drop_pod(task.pod.uid) is not None:
            task.volume_ready = False


class SchedulerCache:
    """Mirror of cluster state + effector plumbing.

    ``device`` places the device-resident solver arena: None means the
    CUDA device and raises here when there is none; ``device="cpu"`` keeps
    the arena (and so the allocate solve) on the host."""

    def __init__(self, cluster: Optional[ClusterStore] = None,
                 scheduler_name: str = "volcano",
                 default_queue: str = "default",
                 async_effectors: bool = False,
                 device=None):
        self.cluster = cluster if cluster is not None else ClusterStore()
        self.scheduler_name = scheduler_name
        self.default_queue = default_queue
        # async bind/evict dispatch (cache.go:505-512, 559-565 fire the API
        # writes in goroutines with resync-on-failure). Off by default: the
        # in-memory store makes synchronous effects deterministic for tests;
        # turn on when effects go to a remote control plane.
        self._effector_pool = (
            ThreadPoolExecutor(max_workers=4, thread_name_prefix="effector")
            if async_effectors else None)
        self._pending_effects: List = []

        self.jobs: Dict[str, JobInfo] = {}
        self.nodes: Dict[str, NodeInfo] = {}
        self.queues: Dict[str, QueueInfo] = {}
        self.priority_classes: Dict[str, object] = {}
        self.default_priority: int = 0
        self.default_priority_class = None
        self.namespace_collections: Dict[str, NamespaceCollection] = {}

        self.binder = DefaultBinder(self.cluster)
        self.evictor = DefaultEvictor(self.cluster)
        self.status_updater = DefaultStatusUpdater(self.cluster)
        self.volume_binder = DefaultVolumeBinder(self.cluster)

        self._err_tasks: List[TaskInfo] = []
        self._synced = False

        # incremental snapshot-flatten state shared across sessions
        # (ops.arrays.FlattenCache; versions on JobInfo/NodeInfo invalidate).
        # The allocate cache runs EVENT-SOURCED: every watch delivery below
        # forwards a typed delta (feed_event) as it arrives, and the
        # version-gated snapshot-clone seam in _snapshot_locked re-marks
        # whatever it re-cuts, so a scheduling cycle starts with the dirty
        # rows already known and flatten_snapshot patches exactly those —
        # host cost O(events since last cycle), ~zero on a quiet cluster
        from ..ops.arrays import FlattenCache
        from ..ops.device_cache import PackedDeviceCache
        from ..ops.ordering import OrderCache
        self.flatten_cache = FlattenCache()
        self.flatten_cache.enable_events()
        # event-sourced ordering (ops.ordering.OrderCache): the allocate
        # action's namespace/queue/job/task ordering inputs kept warm
        # across sessions, fed from the same delta seam as the flatten
        # ledger below — a cycle's ordering pass patches only event-dirty
        # jobs instead of re-sorting every pending job/task
        self.order_cache = OrderCache()
        # separate caches for preempt/reclaim flattens: each action's task
        # set differs from allocate's AND from the other's, and sharing a
        # cache clobbers the wholesale fast-path key every cycle
        self.evict_flatten_caches = {"preempt": FlattenCache(),
                                     "reclaim": FlattenCache()}
        # device-resident packed solver buffers (delta-shipped per
        # session); built here so a missing GPU fails at construction,
        # not inside a cycle
        self.device_cache = PackedDeviceCache(device=device)
        self.device = self.device_cache.device
        # node-axis sharded arena (ops.device_cache.ShardedDeviceCache):
        # built lazily by the allocate action's first sharded session over
        # parallel.arena_mesh() on this cache's device type, unless one
        # was installed here first
        self.sharded_device_cache = None
        # solver-mode preference consumed by Action.resolve_mode: None /
        # "packed" keep per-action conf routing, "sharded" dispatches the
        # sharded solver, "auto" shards when the padded problem exceeds
        # sharded_byte_budget bytes (0 = never auto-shard)
        self.solver_mode = None
        self.sharded_byte_budget = 0
        # optional solver-sidecar client (parallel.sidecar.SidecarSolver):
        # when set, allocate and preempt/reclaim ship their solves to the
        # sidecar process that owns the card; this cache then runs on
        # device="cpu". The Scheduler installs a BucketPrewarmer
        # (ops.precompile) here when prewarm is on
        self.sidecar = None
        self.prewarmer = None
        # gates the allocate action's dispatch/collect overlap
        self.pipeline_solver = True
        # device-path circuit breaker (resilience.CircuitBreaker): the
        # Scheduler installs one; sessions read it for the device -> host
        # oracle degradation ladder in allocate/preempt/reclaim
        self.breaker = None
        # crash-safe HA seams, None unless installed: the write-ahead
        # bind-intent journal (consumed by Statement.commit /
        # flush_bulk_commit; resilience/recovery.py reconciles it at
        # takeover, Scheduler.run_with_leader_election) and the
        # fenced store handle the effectors write through once fencing
        # is on (install_fencing)
        self.bind_journal = None
        self.fenced_cluster = None
        # global rescheduler (reschedule/): deployment-level defaults for
        # the reschedule action (the Scheduler's reschedule_* flags; per-
        # action conf arguments override), its cross-session state (cycle
        # counter, its own flatten cache and arena on this cache's device,
        # the migration-intent journal) and the bounded per-plan history
        # that tests and chip_smoke.py read budget/cap compliance from
        self.reschedule_opts = None
        self.reschedule_state = None
        self.reschedule_log = []

        # job uid -> flat_version reflected by the last successful status
        # write; the job updater's skip-if-untouched check compares against
        # this (NOT session open) so inter-session informer changes count
        self.updater_versions: Dict[str, int] = {}
        # version-gated snapshot clone reuse (see _snapshot_locked)
        self._job_clone_cache: Dict[str, JobInfo] = {}
        self._node_clone_cache: Dict[str, NodeInfo] = {}

        self._create_default_queue()

    # -- startup ------------------------------------------------------------

    def _create_default_queue(self) -> None:
        """Reference creates the default queue CR at startup
        (cache.go:270-283). Losing the create race is fine — two HA
        schedulers attaching to one networked store both run this."""
        if self.cluster.try_get("queues", self.default_queue) is None:
            try:
                self.cluster.create(
                    "queues",
                    Queue(name=self.default_queue, spec=QueueSpec(weight=1)))
            except ConflictError:
                pass  # a peer created it between our read and write

    def install_fencing(self, token_provider) -> None:
        """Route every effector write (bind, evict, status update, volume
        pin) through a FencedStore carrying ``token_provider()``'s lease
        token, so the authoritative store — not the writer's own view of
        its leadership — arbitrates split brain (client.store.FencedStore;
        Omega-style optimistic commit fencing). Only effectors still
        pointed at this cache's raw cluster are rewired: fakes and
        recording decorators are left alone. Idempotent."""
        from ..client.store import FencedStore
        if self.fenced_cluster is not None:
            return
        fenced = FencedStore(self.cluster, token_provider)
        self.fenced_cluster = fenced
        for effector in (self.binder, self.evictor, self.status_updater,
                         self.volume_binder):
            if getattr(effector, "cluster", None) is self.cluster:
                effector.cluster = fenced

    def run(self) -> None:
        """Subscribe to the store's watch streams (informer start).
        Idempotent: repeated Scheduler.run() calls must not double-subscribe
        (the reference starts its informer factory once)."""
        if self._synced:
            return
        c = self.cluster
        c.watch("pods", self._on_pod)
        c.watch("nodes", self._on_node)
        c.watch("podgroups", self._on_podgroup)
        c.watch("queues", self._on_queue)
        c.watch("priorityclasses", self._on_priority_class)
        c.watch("resourcequotas", self._on_resource_quota)
        self._synced = True

    def wait_for_cache_sync(self) -> bool:
        return self._synced

    # -- watch dispatch -----------------------------------------------------

    def _feed_flatten(self, kind, event, job=None, node=None):
        """Forward one typed delta to the event-sourced flatten AND
        ordering ledgers (no-op for embeddings that run without the
        caches). One seam, two consumers: the watch hooks and the
        version-gated snapshot-clone catch-all below keep both caches'
        dirty sets complete with a single call site."""
        fc = self.flatten_cache
        if fc is not None:
            fc.feed_event(kind, event, job=job, node=node)
        oc = self.order_cache
        if oc is not None:
            oc.feed_event(kind, event, job=job, node=node)

    def _on_pod(self, event, obj, old, changed=None):
        if obj.scheduler_name == self.scheduler_name:
            key = job_key_of_pod(obj)
            self._feed_flatten("pod", event, job=key,
                               node=obj.node_name or None)
            if old is not None and old.node_name \
                    and old.node_name != obj.node_name:
                self._feed_flatten("pod", event, job=key,
                                   node=old.node_name)
        if event == "add":
            # resync-safe: a watch-resume (or re-list) can replay an add
            # for a pod this mirror already tracks; treating it as an
            # update keeps the node/job accounting single-counted instead
            # of raising out of the delivery (informer AddFunc semantics
            # on a re-listed object)
            if self._stored_task(TaskInfo(obj)) is not None:
                self.update_pod(obj, obj)
            else:
                self.add_pod(obj)
        elif event == "update":
            # a delta watch stream names the changed fields; when they
            # fit the targeted path, skip the full TaskInfo rebuild
            if changed is None or not self.apply_pod_delta(
                    old, obj, changed):
                self.update_pod(old, obj)
        else:
            self.delete_pod(obj)

    # a delta-capable store passes (event, obj, old, changed_fields) —
    # detected via getattr on the bound method (client/remote.py)
    _on_pod.delta_aware = True

    def _on_node(self, event, obj, old):
        # an "add" for an already-known node is a respec in place (no
        # position change); a genuinely new node relays the padded axis
        ev = event
        if event == "add" and obj.name in self.nodes \
                and self.nodes[obj.name].node is not None:
            ev = "update"
        self._feed_flatten("node", ev, node=obj.name)
        if event == "add":
            self.add_node(obj)
        elif event == "update":
            self.update_node(obj)
        else:
            self.delete_node(obj)

    def _on_podgroup(self, event, obj, old):
        self._feed_flatten("podgroup", event,
                           job=f"{obj.namespace}/{obj.name}")
        if event == "delete":
            self.delete_pod_group(obj)
        else:
            self.set_pod_group(obj)

    def _on_queue(self, event, obj, old):
        self._feed_flatten("queue", event)
        if event == "delete":
            self.delete_queue(obj)
        else:
            self.add_queue(obj)

    def _on_priority_class(self, event, obj, old):
        if event == "delete":
            self.delete_priority_class(obj)
        else:
            self.add_priority_class(obj)

    def _on_resource_quota(self, event, obj, old):
        name = obj.namespace
        coll = self.namespace_collections.setdefault(
            name, NamespaceCollection(name))
        if event == "delete":
            coll.delete(obj)
        else:
            coll.update(obj)

    # -- pod/task handlers (event_handlers.go:43-210) ------------------------

    def _get_or_create_job(self, ti: TaskInfo) -> Optional[JobInfo]:
        if not ti.job:
            return None  # bare pod: podgroup controller will wrap it
        if ti.job not in self.jobs:
            self.jobs[ti.job] = JobInfo(ti.job)
        return self.jobs[ti.job]

    def add_task(self, ti: TaskInfo) -> None:
        job = self._get_or_create_job(ti)
        if job is not None:
            job.add_task_info(ti)
        if ti.node_name:
            if ti.node_name not in self.nodes:
                self.nodes[ti.node_name] = NodeInfo()
                self.nodes[ti.node_name].name = ti.node_name
            # Terminated tasks (Succeeded/Failed) hold no node resources
            # (event_handlers.go:69-72 isTerminated gate).
            if ti.status not in (TaskStatus.SUCCEEDED, TaskStatus.FAILED):
                self.nodes[ti.node_name].add_task(ti)

    def add_pod(self, pod) -> None:
        if pod.scheduler_name != self.scheduler_name:
            return
        self.add_task(TaskInfo(pod))

    def delete_task(self, ti: TaskInfo) -> None:
        job_err = node_err = None
        if ti.job and ti.job in self.jobs:
            try:
                self.jobs[ti.job].delete_task_info(ti)
            except KeyError as e:
                job_err = e
        # skip node removal when the node never held the task (terminated
        # tasks aren't added — the isTerminated gate in add_task; the
        # reference logs a spurious error here instead). Membership, not
        # ti.status, is the test: watch deliveries can alias old/new pod
        # objects, and accounting uses the node's stored clone anyway.
        if ti.node_name and ti.node_name in self.nodes:
            node = self.nodes[ti.node_name]
            if ti.key in node.tasks:
                try:
                    node.remove_task(ti)
                except KeyError as e:
                    node_err = e
        if job_err or node_err:
            raise KeyError(f"failed to delete task {ti.key}: {job_err} {node_err}")

    def _stored_task(self, ti: TaskInfo) -> Optional[TaskInfo]:
        """The task as THIS cache knows it. Event objects from a remote
        store are decoded copies, so an update's ``old`` can lag the
        cache's own effector writes (cache.bind set node_name before the
        informer echo arrives); deleting by the stale copy would skip the
        node removal and the re-add would double-place. In-process the
        store shares objects, which masked this."""
        job = self.jobs.get(ti.job)
        if job is None:
            return None
        return job.tasks.get(ti.key)

    def update_pod(self, old_pod, new_pod) -> None:
        if new_pod.scheduler_name != self.scheduler_name:
            return
        old_ti = TaskInfo(old_pod)
        stored = self._stored_task(old_ti)
        try:
            self.delete_task(stored if stored is not None else old_ti)
        except KeyError:
            pass
        self.add_task(TaskInfo(new_pod))

    def apply_pod_delta(self, old_pod, new_pod, changed) -> bool:
        """Targeted update for a delta-watch column patch: ``changed``
        names the pod fields the patch touched. When they all fit the
        safe set, re-place the STORED TaskInfo through the same
        delete_task/add_task seams the generic path uses — identical
        index ordering, aggregate arithmetic and node accounting — but
        without re-deriving a TaskInfo (the resreq parse and status/key
        derivation are the per-event cost this path exists to kill).
        Returns False when the caller must run the generic rebuild."""
        if not _DELTA_FAST_FIELDS.issuperset(changed):
            return False
        if new_pod.scheduler_name != self.scheduler_name:
            return True  # not ours: same early-out as update_pod
        job = self.jobs.get(job_key_of_pod(new_pod))
        stored = job.tasks.get(pod_key(new_pod)) \
            if job is not None else None
        if stored is None:
            # bare pod or a task this mirror never added: the generic
            # ladder owns the odd cases
            return False
        try:
            self.delete_task(stored)
        except KeyError:
            pass
        stored.node_name = new_pod.node_name or ""
        stored.status = status_of_pod(new_pod)
        stored.priority = new_pod.priority \
            if new_pod.priority is not None else 1
        # reset exactly what a fresh TaskInfo(new_pod) would: the
        # rebuilt arm of an A/B run must not observe state this arm
        # carried over
        stored.volume_ready = False
        stored.sig_cache = None
        stored.pod = new_pod
        self.add_task(stored)
        return True

    def delete_pod(self, pod) -> None:
        if pod.scheduler_name != self.scheduler_name:
            return
        ti = TaskInfo(pod)
        stored = self._stored_task(ti)
        try:
            self.delete_task(stored if stored is not None else ti)
        except KeyError as e:
            log.warning("delete_pod: %s", e)
        job = self.jobs.get(ti.job)
        if job is not None and not job.tasks and job.pod_group is None:
            del self.jobs[ti.job]
            self.updater_versions.pop(ti.job, None)
            self._job_clone_cache.pop(ti.job, None)

    # -- node handlers ------------------------------------------------------

    def add_node(self, node) -> None:
        if node.name in self.nodes:
            self.nodes[node.name].set_node(node)
        else:
            ni = NodeInfo(node)
            # preserve tasks recorded before the node object arrived
            self.nodes[node.name] = ni

    update_node = add_node

    def delete_node(self, node) -> None:
        self.nodes.pop(node.name, None)
        self._node_clone_cache.pop(node.name, None)

    # -- podgroup / queue / priorityclass handlers --------------------------

    def set_pod_group(self, pg: PodGroup) -> None:
        key = f"{pg.namespace}/{pg.name}"
        if key not in self.jobs:
            self.jobs[key] = JobInfo(key)
        self.jobs[key].set_pod_group(pg)

    def delete_pod_group(self, pg: PodGroup) -> None:
        key = f"{pg.namespace}/{pg.name}"
        job = self.jobs.get(key)
        if job is None:
            return
        job.pod_group = None
        if not job.tasks:
            del self.jobs[key]
            self.updater_versions.pop(key, None)
            self._job_clone_cache.pop(key, None)

    def add_queue(self, queue: Queue) -> None:
        self.queues[queue.name] = QueueInfo(queue)

    def delete_queue(self, queue: Queue) -> None:
        self.queues.pop(queue.name, None)

    def add_priority_class(self, pc) -> None:
        if pc.global_default:
            self.default_priority = pc.value
            self.default_priority_class = pc
        self.priority_classes[pc.name] = pc

    def delete_priority_class(self, pc) -> None:
        self.priority_classes.pop(pc.name, None)
        if pc.global_default:
            self.default_priority = 0
            self.default_priority_class = None

    # -- resync (cache.go:645-667) ------------------------------------------

    def resync_task(self, task: TaskInfo) -> None:
        self._err_tasks.append(task)

    def process_resync_tasks(self) -> None:
        """Re-sync err tasks from store truth (informer ground truth)."""
        tasks, self._err_tasks = self._err_tasks, []
        for task in tasks:
            pod = self.cluster.try_get("pods", task.name, task.namespace)
            try:
                self.delete_task(task)
            except KeyError:
                pass
            if pod is not None:
                self.add_task(TaskInfo(pod))

    # -- snapshot (cache.go:670-748) ----------------------------------------

    #: kubelet-of-last-resort grace: an evicted pod still carrying its
    #: deletion_timestamp after this long is finalized by the scheduler
    #: cache itself — scheduler-only embeddings (no ControllerManager, so
    #: no KubeletStandin) must still converge after evictions
    EVICTION_FINALIZE_GRACE = 60.0

    def _finalize_expired_evictions(self) -> None:
        now = time.time()
        # materialize: deleting a pod can drop its job from self.jobs via
        # the delete listener while we iterate
        for job in list(self.jobs.values()):
            for task in list(job.task_status_index.get(
                    TaskStatus.RELEASING, {}).values()):
                pod = self.cluster.try_get("pods", task.name,
                                           task.namespace)
                if pod is None or pod.deletion_timestamp is None:
                    continue
                if now - pod.deletion_timestamp \
                        > self.EVICTION_FINALIZE_GRACE:
                    try:
                        self.cluster.delete("pods", pod.name, pod.namespace)
                    except NotFoundError:
                        pass

    def snapshot(self) -> ClusterInfo:
        # Take the store's write lock for the whole clone: async effector
        # threads mutate this cache via store listeners (which run under
        # that lock), so holding it here is the SchedulerCache.Mutex of the
        # reference (cache.go:72, Snapshot locks before cloning).
        with tracing.traced("vc.open.snapshot") as sp, \
                self.cluster.locked():
            self._finalize_expired_evictions()
            sn = self._snapshot_locked()
            sp.set(jobs=len(sn.jobs), nodes=len(sn.nodes))
            return sn

    def _snapshot_locked(self) -> ClusterInfo:
        drop = getattr(self.volume_binder, "drop_assumptions", None)
        if drop is not None:
            drop()  # assumptions are session-scoped
        sn = ClusterInfo()
        # Version-gated clone reuse: a clone handed to the PREVIOUS session
        # can serve again iff (a) the cache object hasn't changed since it
        # was cut AND (b) the session didn't mutate the clone — both
        # observable as recorded == cache.flat_version == clone.flat_version
        # (every mutation path bumps the version). This cuts the per-cycle
        # clone fan-out, the scheduler's host floor, to the churned subset —
        # the same delta idea the flatten/device caches use. Contract:
        # sessions on one cache are SEQUENTIAL (the scheduler loop); the
        # reference's snapshot has the same assumption (one runOnce at a
        # time under the scheduler mutex, cache.go:693-742).
        for name, ni in self.nodes.items():
            if not ni.ready:
                continue
            prev = self._node_clone_cache.get(name)
            if prev is not None and prev.flat_version == ni.flat_version \
                    and prev.flat_epoch == ni.flat_epoch:
                sn.nodes[name] = prev
                continue
            # version-gated clone seam doubles as the event feed's
            # catch-all: ANY divergence since the last cycle (a watch
            # delivery, a direct effector mutation, a session-mutated
            # clone) forces a re-cut, and the re-cut marks the row dirty
            # for the event-sourced flatten — so a delta the watch hooks
            # never saw still lands in the ledger before the flatten runs
            self._feed_flatten("node", "resync", node=name)
            clone = ni.clone()
            self._node_clone_cache[name] = clone
            sn.nodes[name] = clone
        for name, qi in self.queues.items():
            sn.queues[name] = qi.clone()
        for name, coll in self.namespace_collections.items():
            sn.namespace_info[name] = coll.snapshot()
        for key, job in self.jobs.items():
            if job.pod_group is None:
                log.info("job %s skipped: scheduling spec undefined", key)
                continue
            if job.queue not in self.queues:
                log.info("job %s skipped: queue %s not found", key, job.queue)
                continue
            prev = self._job_clone_cache.get(key)
            # clone() copies the version and the global counter never
            # repeats, so one comparison covers both cache-side and
            # session-side mutation since the clone was cut
            if prev is None or prev.flat_version != job.flat_version:
                # re-cut ahead: mark the job dirty for the event-sourced
                # flatten (same catch-all as the node seam above)
                self._feed_flatten("job", "resync", job=key)
            if prev is not None and prev.flat_version == job.flat_version:
                clone = prev
                # per-session slates that don't bump the version; the
                # timestamp reset matches fresh-clone-per-cycle semantics
                # (the cache-side job never carries it, so a fresh clone
                # always started from None)
                if clone.nodes_fit_errors:
                    clone.nodes_fit_errors = {}
                clone.schedule_start_timestamp = None
            else:
                clone = job.clone()
                self._job_clone_cache[key] = clone
            # resolve job priority from the PodGroup's priority class
            clone.priority = self.default_priority
            pc = self.priority_classes.get(clone.priority_class_name)
            if pc is not None:
                clone.priority = pc.value
            sn.jobs[key] = clone
        return sn

    # -- effector paths (cache.go:450-578) ----------------------------------

    def _find_job_and_task(self, ti: TaskInfo):
        job = self.jobs.get(ti.job)
        if job is None:
            raise KeyError(f"failed to find Job {ti.job} for Task {ti.key}")
        task = job.tasks.get(ti.key)
        if task is None:
            raise KeyError(f"failed to find task in status {ti.status} by key {ti.key}")
        return job, task

    def bind(self, ti: TaskInfo, hostname: str) -> None:
        job, task = self._find_job_and_task(ti)
        node = self.nodes.get(hostname)
        if node is None:
            raise KeyError(f"failed to bind Task {ti.key} to host {hostname}: "
                           "host does not exist")
        original = task.status
        job.update_task_status(task, TaskStatus.BINDING)
        try:
            node.add_task(task)
        except ValueError:
            job.update_task_status(task, original)
            raise
        start = (job.schedule_start_timestamp
                 or task.pod.creation_timestamp or 0.0)

        def effect():
            self.binder.bind(task.pod, hostname)
            metrics.schedule_attempts.inc(labels={"result": "scheduled"})
            if start:
                metrics.task_scheduling_latency.observe(
                    (time.time() - start) * 1e3)

        def failed():
            metrics.schedule_attempts.inc(labels={"result": "error"})
            self.resync_task(task)

        self._dispatch_effect(effect, failed, f"bind {task.key}")

    def bind_batch(self, tis) -> list:
        """Batched bind(): identical per-task cache state, but one
        accounting pass per (job, node) group and ONE dispatched effect for
        the whole wave — bind() dispatches an effect per task
        (cache.go:450-478's per-goroutine shape), which at a 10k-pod burst
        is most of the replay's host cost. Returns [(ti, exc)] for tasks
        whose cache-side accounting failed, carrying the same exceptions
        bind() would have raised; those tasks get no effect."""
        failures: list = []
        bound: list = []
        starts: list = []
        slow: list = []
        by_node: Dict[str, list] = {}
        last_jobid = None  # statements commit per job: one lookup suffices
        job = None
        seen = set()
        for ti in tis:
            if ti.job != last_jobid:
                job = self.jobs.get(ti.job)
                last_jobid = ti.job
            task = job.tasks.get(ti.key) if job is not None else None
            # duplicates within the wave go per-task: the second bind()
            # raises 'already on node' instead of double-counting
            if task is None or task.key in seen:
                slow.append(ti)
                continue
            seen.add(task.key)
            group = by_node.get(ti.node_name)
            if group is None:
                by_node[ti.node_name] = [(ti, job, task)]
            else:
                group.append((ti, job, task))
        # each node group is validated up front (same checks bind() relies
        # on, whole-group fit included) so the bulk mutators cannot raise
        # mid-wave; invalid groups demote to per-task bind()
        fast_nodes = []
        for hostname, group in by_node.items():
            node = self.nodes.get(hostname)
            ok = node is not None and node.node is not None
            if ok:
                node_tasks = node.tasks
                for _, _, task in group:
                    if task.key in node_tasks or (
                            task.node_name and task.node_name != hostname):
                        ok = False
                        break
            if ok:
                req = group[0][2].resreq if len(group) == 1 \
                    else Resource.sum_of(t.resreq for _, _, t in group)
                ok = req.less_equal(node.idle)
            if ok:
                fast_nodes.append((node, group))
            else:
                # demote the ORIGINAL input objects: bind() re-resolves its
                # own task and the failure tuples must hand callers back
                # what they gave us, never cache-side objects
                slow.extend(ti for ti, _, _ in group)
        by_job: Dict[str, tuple] = {}
        for node, group in fast_nodes:
            for ent3 in group:
                ent = by_job.get(ent3[2].job)
                if ent is None:
                    by_job[ent3[2].job] = (ent3[1], [ent3])
                else:
                    ent[1].append(ent3)
        demoted = set()
        for job, group in by_job.values():
            try:
                # raises BEFORE mutating (aggregates pre-checked): the
                # job's wave demotes to per-task bind() on failure
                job.bulk_update_status([t for _, _, t in group],
                                       TaskStatus.BINDING)
            except (KeyError, ValueError):
                demoted.update(id(t) for _, _, t in group)
                continue
            start = job.schedule_start_timestamp
            for _, _, task in group:
                bound.append(task)
                starts.append(start or task.pod.creation_timestamp or 0.0)
        for node, group in fast_nodes:
            if demoted:
                kept = [e for e in group if id(e[2]) not in demoted]
                slow.extend(e[0] for e in group if id(e[2]) in demoted)
                if not kept:
                    continue
                group = kept
            node.add_tasks_bulk([t for _, _, t in group], validated=True)
        for ti in slow:
            try:
                self.bind(ti, ti.node_name)
            except (KeyError, ValueError) as e:
                failures.append((ti, e))
        if bound:
            def effect():
                ok = 0
                lat = []
                for task, start in zip(bound, starts):
                    try:
                        self.binder.bind(task.pod, task.node_name)
                    except Exception:
                        log.exception("bind %s failed", task.key)
                        metrics.schedule_attempts.inc(
                            labels={"result": "error"})
                        self.resync_task(task)
                        continue
                    ok += 1
                    if start:
                        lat.append((time.time() - start) * 1e3)
                if ok:
                    metrics.schedule_attempts.inc(
                        ok, labels={"result": "scheduled"})
                metrics.task_scheduling_latency.observe_many(lat)

            self._dispatch_effect(effect, lambda: None,
                                  f"bind batch of {len(bound)}")
        return failures

    def evict(self, ti: TaskInfo, reason: str) -> None:
        job, task = self._find_job_and_task(ti)
        node = self.nodes.get(task.node_name)
        if node is None:
            raise KeyError(f"failed to evict Task {ti.key}: host "
                           f"{task.node_name} does not exist")
        original = task.status
        job.update_task_status(task, TaskStatus.RELEASING)
        try:
            node.update_task(task)
        except (ValueError, KeyError):
            job.update_task_status(task, original)
            raise
        self._dispatch_effect(
            lambda: self.evictor.evict(task.pod, reason),
            lambda: self.resync_task(task), f"evict {task.key}")

    def _dispatch_effect(self, effect, failed, what: str) -> None:
        """Run a side-effect against the control plane: inline by default,
        in the effector pool when async (the reference's fire-and-forget
        goroutines with rate-limited resync on failure)."""

        def run():
            try:
                effect()
            except Exception:
                log.exception("%s failed", what)
                failed()

        if self._effector_pool is None:
            run()
        else:
            parent = tracing.current()

            def adopted():
                with tracing.adopt(parent):
                    run()

            # prune completed futures so long-running schedulers that never
            # drain explicitly don't accumulate them without bound
            self._pending_effects = [f for f in self._pending_effects
                                     if not f.done()]
            self._pending_effects.append(
                self._effector_pool.submit(adopted))

    def wait_for_effects(self) -> None:
        """Drain in-flight async effects (tests / clean shutdown)."""
        pending, self._pending_effects = self._pending_effects, []
        for fut in pending:
            fut.result()

    def allocate_volumes(self, task: TaskInfo, hostname: str) -> None:
        self.volume_binder.allocate_volumes(task, hostname)

    def allocate_volumes_batch(self, pairs) -> list:
        """Batched allocate_volumes; [(task, hostname, exc)] failures."""
        vb = self.volume_binder
        batch = getattr(vb, "allocate_volumes_batch", None)
        if batch is not None:
            return batch(pairs)
        failures = []
        for task, hostname in pairs:
            try:
                vb.allocate_volumes(task, hostname)
            except (KeyError, ValueError) as e:
                failures.append((task, hostname, e))
        return failures

    def bind_volumes(self, task: TaskInfo) -> None:
        self.volume_binder.bind_volumes(task)

    def bind_volumes_batch(self, tasks) -> list:
        """bind_volumes over a wave; returns [(task, exc)] failures. When
        the volume binder reports no in-flight assumptions at all, the
        whole wave is a no-op and the per-task calls are skipped (the
        common case: a 10k-pod burst of volume-less pods)."""
        vb = self.volume_binder
        pending = getattr(vb, "has_assumed", None)
        if pending is not None and not pending():
            return []
        failures = []
        for t in tasks:
            try:
                vb.bind_volumes(t)
            except Exception as e:  # noqa: BLE001 — mirrors bind failure path
                failures.append((t, e))
        return failures

    def revert_volumes(self, task: TaskInfo) -> None:
        revert = getattr(self.volume_binder, "revert_volumes", None)
        if revert is not None:
            revert(task)

    def task_unschedulable(self, task: TaskInfo, message: str) -> None:
        """Write the Unschedulable pod condition (cache.go:590-612)."""
        metrics.schedule_attempts.inc(labels={"result": "unschedulable"})
        self.status_updater.update_pod_condition(task.pod, {
            "type": "PodScheduled", "status": "False",
            "reason": "Unschedulable", "message": message,
        })

    # -- job status writes (cache.go:760-855) -------------------------------

    def update_job_status(self, job: JobInfo, update_pg: bool = True) -> JobInfo:
        if update_pg and job.pod_group is not None:
            pg = job.pod_group
            pg.status.running = len(
                job.task_status_index.get(TaskStatus.RUNNING, {}))
            pg.status.succeeded = len(
                job.task_status_index.get(TaskStatus.SUCCEEDED, {}))
            pg.status.failed = len(
                job.task_status_index.get(TaskStatus.FAILED, {}))
            self.status_updater.update_pod_group(pg)
        self.record_job_status_event(job)
        return job

    def record_job_status_event(self, job: JobInfo) -> None:
        """Propagate per-task fit errors into pod conditions for
        unschedulable jobs (cache.go:791-826)."""
        if job.pod_group is None or job.ready():
            return
        base_msg = job.fit_message()
        for task in job.task_status_index.get(TaskStatus.PENDING, {}).values():
            fit_errors = job.nodes_fit_errors.get(task.key)
            msg = base_msg if fit_errors is None else fit_errors.error()
            try:
                self.task_unschedulable(task, msg)
            except Exception:
                log.exception("failed to update unschedulable condition for %s",
                              task.key)

    def string(self) -> str:
        return (f"SchedulerCache(jobs={len(self.jobs)} nodes={len(self.nodes)} "
                f"queues={len(self.queues)})")
