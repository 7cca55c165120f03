"""Job controller (reference pkg/controllers/job/job_controller*.go).

Reconciles batch Jobs: requests from job/pod/podgroup/command watch events
are queued with job-key affinity and drained by process_all(); each request
loads the cached JobInfo, resolves the action via applyPolicies, and runs
the state machine, which calls back into sync_job/kill_job.
"""

from __future__ import annotations

import logging
import random
import time
from typing import Dict, List, Optional, Tuple

from ...api import Resource
from ...api.job_info import container_requests
from ...api.types import POD_GROUP_ANNOTATION
from ...client.store import (
    AdmissionError, ClusterStore, ConflictError, NotFoundError,
)
from ...models import (
    Action, Event, Job, JobPhase, Pod, PodGroup, PodGroupPhase, PodGroupSpec,
)
from ...models.batch import (
    JOB_NAME_KEY, JOB_VERSION_KEY, TASK_SPEC_KEY,
)
from ..apis import JobInfo, Request
from ..cache import JobCache
from ..framework import Controller, ControllerOption
from .plugins import get_plugin
from .state import new_state

log = logging.getLogger(__name__)

MAX_RETRIES = 15          # reference maxRetry (job_controller.go)
RETRY_BASE_S = 0.1        # first backoff delay
RETRY_CAP_S = 30.0        # backoff ceiling


def apply_policies(job: Job, req: Request) -> Action:
    """Action resolution (job_controller_util.go:115-170)."""
    if req.action is not None:
        return req.action
    if req.event == Event.OUT_OF_SYNC:
        return Action.SYNC_JOB
    if req.job_version < job.status.version:
        return Action.SYNC_JOB

    def match(policy) -> bool:
        events = set(policy.events)
        if policy.event is not None:
            events.add(policy.event)
        if events and req.event is not None:
            if req.event in events or Event.ANY in events:
                return True
        if policy.exit_code is not None and policy.exit_code == req.exit_code \
                and req.exit_code != 0:
            return True
        return False

    if req.task_name:
        for task in job.spec.tasks:
            if task.name == req.task_name:
                for policy in task.policies:
                    if match(policy):
                        return policy.action
                break
    for policy in job.spec.policies:
        if match(policy):
            return policy.action
    return Action.SYNC_JOB


class JobController(Controller):
    def __init__(self):
        self.cluster: Optional[ClusterStore] = None
        self.scheduler_name = "volcano"
        self.default_queue = "default"
        self.worker_num = 3
        self.cache = JobCache()
        self.queues: List[List[Request]] = []
        # last observed pod phases: in-memory store objects are shared, so
        # the `old` object of an update event may alias the new one; phase
        # transitions are detected against this map instead
        self._pod_phases: Dict[str, str] = {}
        # last observed (spec fingerprint, phase) per job — status-only
        # updates must NOT re-enqueue OutOfSync or terminal-state jobs would
        # reconcile (and version-bump) forever
        # (job_controller_handler.go:98-103: "we only reconcile job based on
        # Spec ... ignored since no update in 'Spec'")
        self._job_obs: Dict[str, tuple] = {}
        # failed-sync backoff state (reference workqueue rate limiter +
        # maxRetry): consecutive failure count per job key, and the
        # deferred requests waiting out their delay as (not_before, req).
        # Injectable clock/rng keep the schedule testable/deterministic.
        self._retry_counts: Dict[str, int] = {}
        self._deferred: List[Tuple[float, Request]] = []
        self.clock = time.time
        self.retry_rng = random.Random(0)

    def name(self) -> str:
        return "job-controller"

    def initialize(self, opt: ControllerOption) -> None:
        self.cluster = opt.cluster
        self.scheduler_name = opt.scheduler_name
        self.default_queue = opt.default_queue
        self.worker_num = max(opt.worker_num, 1)
        self.queues = [[] for _ in range(self.worker_num)]

    # -- queueing (FNV-style job-key shard affinity) -------------------------

    def _enqueue(self, req: Request) -> None:
        shard = hash(req.key) % self.worker_num
        self.queues[shard].append(req)

    def run(self) -> None:
        c = self.cluster
        c.watch("jobs", self._on_job)
        c.watch("pods", self._on_pod)
        c.watch("podgroups", self._on_podgroup)
        c.watch("commands", self._on_command)

    def _retry_later(self, req: Request) -> None:
        """Schedule a failed request's re-enqueue with capped exponential
        backoff + jitter per job key (reference maxRetry + the workqueue
        rate limiter): immediate unbounded re-enqueues would hot-loop a
        permanently failing sync against the control plane. After
        MAX_RETRIES consecutive failures the request is dropped — the
        next genuine watch event for the job starts a fresh budget."""
        from ...metrics import metrics
        count = self._retry_counts.get(req.key, 0) + 1
        self._retry_counts[req.key] = count
        if count > MAX_RETRIES:
            log.error("giving up on %s after %d failed syncs", req.key,
                      count - 1)
            self._retry_counts.pop(req.key, None)
            return
        delay = min(RETRY_BASE_S * (2 ** (count - 1)), RETRY_CAP_S)
        delay *= 0.5 + self.retry_rng.random()  # jitter: spread the herd
        self._deferred.append((self.clock() + delay, req))
        metrics.job_retry_total.inc(labels={"job_id": req.key})

    def _drain_due_retries(self, batch: Dict[tuple, Request]) -> None:
        """Move deferred retries whose delay elapsed into the batch."""
        if not self._deferred:
            return
        now = self.clock()
        still_waiting = []
        for not_before, req in self._deferred:
            if not_before > now:
                still_waiting.append((not_before, req))
                continue
            dedup = (req.namespace, req.job_name, req.task_name,
                     req.event, req.exit_code, req.action)
            batch.setdefault(dedup, req)
        self._deferred = still_waiting

    def process_all(self, max_rounds: int = 16, parallel: int = 1) -> None:
        """Drain all shards; new requests produced while processing are
        handled in subsequent rounds. Identical requests are deduplicated
        per round (the reference's workqueue add-if-absent semantics) —
        without this, the watch-event feedback from each sync amplifies the
        queue exponentially. A request whose sync raises re-enqueues with
        capped exponential backoff per job key (_retry_later) instead of
        being dropped (or hot-looped).

        ``parallel`` > 1 fans a round's batch out across worker threads
        partitioned by the job key's STORE shard (client/sharded.py
        shard_for — the sharded front door's controller fan-out):
        requests for one job keep their key affinity in one worker,
        while workers whose syncs are store round trips overlap instead
        of queueing behind a single request at a time. Retry-backoff
        bookkeeping stays on the caller thread."""
        for _ in range(max_rounds):
            batch: Dict[tuple, Request] = {}
            for q in self.queues:
                for req in q:
                    dedup = (req.namespace, req.job_name, req.task_name,
                             req.event, req.exit_code, req.action)
                    batch.setdefault(dedup, req)
                q.clear()
            self._drain_due_retries(batch)
            if not batch:
                return
            if parallel <= 1 or len(batch) <= 1:
                for req in batch.values():
                    try:
                        self._process(req)
                    except Exception:
                        log.exception("failed to process request %s", req)
                        self._retry_later(req)
                    else:
                        self._retry_counts.pop(req.key, None)
                continue
            self._process_parallel(batch, parallel)

    def _process_parallel(self, batch: Dict[tuple, Request],
                          parallel: int) -> None:
        import threading

        from ...client.sharded import shard_for

        groups: Dict[int, List[Request]] = {}
        for req in batch.values():
            groups.setdefault(shard_for("jobs", req.key, parallel),
                              []).append(req)
        failed: List[Request] = []
        synced: List[str] = []

        def drain(reqs: List[Request]) -> None:
            for req in reqs:
                try:
                    self._process(req)
                except Exception:  # noqa: BLE001 — retried below
                    log.exception("failed to process request %s", req)
                    failed.append(req)
                else:
                    synced.append(req.key)

        threads = [threading.Thread(target=drain, args=(reqs,),
                                    name=f"job-sync-{shard}")
                   for shard, reqs in groups.items()]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for req in failed:
            self._retry_later(req)
        for key in synced:
            self._retry_counts.pop(key, None)

    # -- watch handlers (job_controller_handler.go) ---------------------------

    def _on_job(self, event, job: Job, old) -> None:
        if event == "add":
            self.cache.add(job)
            self._job_obs[job.key] = (repr(job.spec), job.status.state.phase)
            self._enqueue(Request(job.namespace, job.name,
                                  event=Event.OUT_OF_SYNC))
        elif event == "update":
            self.cache.update(job)
            obs = (repr(job.spec), job.status.state.phase)
            if self._job_obs.get(job.key) == obs:
                return
            self._job_obs[job.key] = obs
            self._enqueue(Request(job.namespace, job.name,
                                  event=Event.OUT_OF_SYNC,
                                  job_version=job.status.version))
        else:
            self._job_obs.pop(job.key, None)
            self.cache.delete(job)
            for name, args in (job.spec.plugins or {}).items():
                plugin = get_plugin(name, args, self.cluster)
                if plugin is not None:
                    try:
                        plugin.on_job_delete(job)
                    except Exception:
                        log.exception("plugin %s on_job_delete failed", name)

    def _on_pod(self, event, pod: Pod, old) -> None:
        job_name = (pod.annotations or {}).get(JOB_NAME_KEY)
        if not job_name:
            return
        task_name = (pod.annotations or {}).get(TASK_SPEC_KEY, "")
        version = int((pod.annotations or {}).get(JOB_VERSION_KEY, 0))
        pod_key = f"{pod.namespace}/{pod.name}"
        prev_phase = self._pod_phases.get(pod_key)
        if event == "delete":
            self._pod_phases.pop(pod_key, None)
        else:
            self._pod_phases[pod_key] = pod.phase
        if event == "add":
            self.cache.add_pod(pod)
            self._enqueue(Request(pod.namespace, job_name,
                                  event=Event.OUT_OF_SYNC,
                                  job_version=version))
        elif event == "update":
            self.cache.update_pod(pod)
            if pod.phase == "Failed" and prev_phase != "Failed":
                exit_code = 0
                for cs in pod.container_statuses:
                    term = (cs.get("state") or {}).get("terminated") or {}
                    if term.get("exitCode"):
                        exit_code = int(term["exitCode"])
                        break
                self._enqueue(Request(pod.namespace, job_name,
                                      task_name=task_name,
                                      event=Event.POD_FAILED,
                                      exit_code=exit_code,
                                      job_version=version))
            elif pod.phase == "Succeeded" and prev_phase != "Succeeded":
                if self.cache.task_completed(f"{pod.namespace}/{job_name}",
                                             task_name):
                    self._enqueue(Request(pod.namespace, job_name,
                                          task_name=task_name,
                                          event=Event.TASK_COMPLETED,
                                          job_version=version))
                else:
                    self._enqueue(Request(pod.namespace, job_name,
                                          event=Event.OUT_OF_SYNC,
                                          job_version=version))
            else:
                self._enqueue(Request(pod.namespace, job_name,
                                      event=Event.OUT_OF_SYNC,
                                      job_version=version))
        else:  # delete
            self.cache.delete_pod(pod)
            self._enqueue(Request(pod.namespace, job_name,
                                  task_name=task_name,
                                  event=Event.POD_EVICTED,
                                  job_version=version))

    def _on_podgroup(self, event, pg: PodGroup, old) -> None:
        if event != "update":
            return
        # phase flips (Pending -> Inqueue) unblock pod creation
        job = self.cluster.try_get("jobs", pg.name, pg.namespace)
        if job is not None:
            self._enqueue(Request(pg.namespace, pg.name,
                                  event=Event.OUT_OF_SYNC))

    def _on_command(self, event, cmd, old) -> None:
        if event != "add":
            return
        target = cmd.target_object or {}
        if target.get("kind") != "Job":
            return
        try:
            self.cluster.delete("commands", cmd.name, cmd.namespace)
        except NotFoundError:
            pass
        except ConflictError:
            # FencedError included: a deposed HA manager must neither
            # consume the command nor blow up the watch delivery — the
            # live manager will process it
            return
        self._enqueue(Request(cmd.namespace, target.get("name", ""),
                              action=cmd.action,
                              event=Event.COMMAND_ISSUED))

    # -- request processing (job_controller.go:286-347) ----------------------

    def _process(self, req: Request) -> None:
        ji = self.cache.get(req.key)
        if ji is None or ji.job is None:
            job = self.cluster.try_get("jobs", req.job_name, req.namespace)
            if job is None:
                return
            self.cache.add(job)
            ji = self.cache.get(req.key)
        st = new_state(ji, self)
        action = apply_policies(ji.job, req)
        st.execute(action)

    # -- plugins -------------------------------------------------------------

    def _plugins(self, job: Job):
        out = []
        for name, args in (job.spec.plugins or {}).items():
            plugin = get_plugin(name, args, self.cluster)
            if plugin is not None:
                out.append(plugin)
        return out

    # -- pod construction -----------------------------------------------------

    def _create_job_pod(self, job: Job, task, index: int) -> Pod:
        tmpl = task.template or {}
        spec = tmpl.get("spec", {})
        meta = tmpl.get("metadata", {})
        pod = Pod(
            name=f"{job.name}-{task.name}-{index}",
            namespace=job.namespace,
            containers=[dict(c) for c in spec.get("containers", [])],
            init_containers=[dict(c) for c in spec.get("initContainers", [])],
            node_selector=dict(spec.get("nodeSelector", {})),
            affinity=spec.get("affinity"),
            tolerations=list(spec.get("tolerations", [])),
            scheduler_name=job.spec.scheduler_name or self.scheduler_name,
            priority_class_name=job.spec.priority_class_name,
            labels={**meta.get("labels", {}), JOB_NAME_KEY: job.name},
            annotations={
                **meta.get("annotations", {}),
                TASK_SPEC_KEY: task.name,
                JOB_NAME_KEY: job.name,
                JOB_VERSION_KEY: str(job.status.version),
                POD_GROUP_ANNOTATION: job.name,
            },
        )
        for plugin in self._plugins(job):
            try:
                plugin.on_pod_create(pod, job)
            except Exception:
                log.exception("plugin on_pod_create failed")
        return pod

    def calc_pg_min_resources(self, job: Job) -> Dict[str, str]:
        """Sum the launch requests of the first min_available tasks
        (job_controller_actions.go calcPGMinResources, simplified to spec
        order)."""
        total = Resource()
        remaining = job.spec.min_available
        for task in job.spec.tasks:
            reqs = [container_requests(c) for c in
                    (task.template.get("spec", {}).get("containers", []))]
            per_pod = Resource()
            for r in reqs:
                per_pod.add(Resource.from_resource_list(r))
            n = min(task.replicas, remaining)
            total.add(per_pod.multi(n))
            remaining -= n
            if remaining <= 0:
                break
        out = {"cpu": f"{total.milli_cpu / 1000:g}",
               "memory": f"{total.memory:g}"}
        for k, v in total.scalars.items():
            out[k] = f"{v / 1000:g}"
        return out

    # -- sync / kill (job_controller_actions.go:40-570) -----------------------

    def _initiate(self, job: Job) -> None:
        if job.status.state.phase is None:
            job.status.state.phase = JobPhase.PENDING
        job.status.min_available = job.spec.min_available
        for plugin in self._plugins(job):
            try:
                plugin.on_job_add(job)
            except Exception:
                log.exception("plugin on_job_add failed")
        # PVCs for job volumes
        from ...models import PersistentVolumeClaim
        for i, vol in enumerate(job.spec.volumes or []):
            name = vol.get("volumeClaimName") or f"{job.name}-pvc-{i}"
            if self.cluster.try_get("pvcs", name, job.namespace) is None:
                self.cluster.create("pvcs", PersistentVolumeClaim(
                    name=name, namespace=job.namespace,
                    spec=dict(vol.get("volumeClaim", {}))))
        # PodGroup (created or updated; named after the job)
        pg = self.cluster.try_get("podgroups", job.name, job.namespace)
        if pg is None:
            pg = PodGroup(
                name=job.name, namespace=job.namespace,
                spec=PodGroupSpec(
                    min_member=job.spec.min_available,
                    queue=job.spec.queue or self.default_queue,
                    priority_class_name=job.spec.priority_class_name,
                    min_resources=self.calc_pg_min_resources(job)),
                owner_references=[{"kind": "Job", "name": job.name,
                                   "uid": job.uid}])
            self.cluster.create("podgroups", pg)
        else:
            min_res = self.calc_pg_min_resources(job)
            if (pg.spec.min_member != job.spec.min_available
                    or pg.spec.min_resources != min_res):
                pg.spec.min_member = job.spec.min_available
                pg.spec.min_resources = min_res
                self.cluster.update("podgroups", pg)

    @staticmethod
    def _status_tuple(status):
        return (status.state.phase, status.pending, status.running,
                status.succeeded, status.failed, status.terminating,
                status.unknown, status.version, status.retry_count)

    def _update_counts(self, status, pods_by_task) -> None:
        status.pending = status.running = status.succeeded = 0
        status.failed = status.terminating = status.unknown = 0
        for pods in pods_by_task.values():
            for pod in pods.values():
                if pod.deletion_timestamp:
                    status.terminating += 1
                elif pod.phase == "Pending":
                    status.pending += 1
                elif pod.phase == "Running":
                    status.running += 1
                elif pod.phase == "Succeeded":
                    status.succeeded += 1
                elif pod.phase == "Failed":
                    status.failed += 1
                else:
                    status.unknown += 1

    def sync_job(self, ji: JobInfo, update_status_fn) -> None:
        job = ji.job
        if job.deletion_timestamp is not None:
            return
        self._initiate(job)

        # the pod gate: while the PodGroup is Pending, pod creation waits
        pg = self.cluster.try_get("podgroups", job.name, job.namespace)
        create_allowed = pg is not None and \
            pg.status.phase != PodGroupPhase.PENDING

        desired: Dict[str, Dict[str, object]] = {}
        for task in job.spec.tasks:
            for i in range(task.replicas):
                desired.setdefault(task.name, {})[
                    f"{job.name}-{task.name}-{i}"] = (task, i)

        # create missing, delete surplus (scale down)
        to_create = []
        for task_name, pods in desired.items():
            actual = ji.pods.get(task_name, {})
            for pod_name, (task, i) in pods.items():
                if pod_name not in actual and create_allowed:
                    to_create.append(self._create_job_pod(job, task, i))
        if to_create:
            # one frame / one journal batch for the whole wave (the
            # ROADMAP item-3 bulk ingest seam); per-item results keep
            # the old loop's containment — a rejected pod costs that
            # pod, not the wave
            for pod, res in zip(to_create, self.cluster.bulk_apply(
                    [("pods", pod, "create") for pod in to_create])):
                if isinstance(res, AdmissionError):
                    log.info("pod %s rejected by admission: %s",
                             pod.name, res)
                elif isinstance(res, Exception):
                    log.error("failed to create pod %s: %s",
                              pod.name, res)
        for task_name, actual in list(ji.pods.items()):
            wanted = desired.get(task_name, {})
            for pod_name, pod in list(actual.items()):
                if pod_name not in wanted and pod.deletion_timestamp is None:
                    try:
                        self.cluster.delete("pods", pod_name, job.namespace)
                    except NotFoundError:
                        pass

        # refresh counts from the cache's post-diff view
        ji2 = self.cache.get(job.key)
        before = self._status_tuple(job.status)
        self._update_counts(job.status, ji2.pods if ji2 else {})
        # NOTE: sync never bumps status.version — the reference bumps only in
        # killJob (job_controller_actions.go:92); bumping here version-gates
        # first-generation pods' PodFailed requests to SyncJob and lifecycle
        # policies (RestartJob/AbortJob/...) would never fire.
        if update_status_fn:
            update_status_fn(job.status)
        if self._status_tuple(job.status) != before \
                or self.cluster.try_get("jobs", job.name, job.namespace) is None:
            self.cluster.apply("jobs", job)

    def kill_job(self, ji: JobInfo, retain_phases, update_status_fn) -> None:
        job = ji.job
        if job.deletion_timestamp is not None:
            return
        terminating = 0
        for task_name, pods in list(ji.pods.items()):
            for pod in list(pods.values()):
                if pod.phase in retain_phases:
                    continue
                if pod.deletion_timestamp is not None:
                    terminating += 1
                    continue
                try:
                    self.cluster.delete("pods", pod.name, pod.namespace)
                except NotFoundError:
                    pass
        ji2 = self.cache.get(job.key)
        self._update_counts(job.status, ji2.pods if ji2 else {})
        job.status.terminating = max(job.status.terminating, terminating)
        # "Job version is bumped only when job is killed" — unconditionally,
        # whether or not the phase closure transitions
        # (job_controller_actions.go:90-92).
        job.status.version += 1
        if update_status_fn:
            update_status_fn(job.status)
        self.cluster.apply("jobs", job)
