"""Preempt action (reference actions/preempt/preempt.go:41-262).

Within-queue: starving jobs (pending tasks, not pipelined) preempt Running
tasks of other jobs chosen by tier-intersected Preemptable fns; then
task-level preemption within each job. Statement-buffered: committed iff the
preemptor job reaches JobPipelined.
"""

from __future__ import annotations

import logging
from typing import Dict

from ..api import TaskStatus
from ..framework import Action
from ..metrics import metrics
from ..models import PodGroupPhase
from ..utils import PriorityQueue
from ..utils.scheduler_helper import validate_victims

log = logging.getLogger(__name__)


def _preempt_one(ssn, stmt, preemptor, node_filter) -> bool:
    """Try to free room for `preemptor` by evicting filtered victims
    (preempt.go:186-262)."""
    from ..plugins.predicates import PredicateError

    candidates = []
    for node in ssn.nodes.values():
        try:
            ssn.predicate_fn(preemptor, node)
        except PredicateError:
            continue
        candidates.append(node)
    scored = sorted(
        candidates,
        key=lambda n: ssn.node_order_fn(preemptor, n), reverse=True)

    for node in scored:
        preemptees = [t.clone() for t in node.tasks.values()
                      if node_filter(t)]
        victims = ssn.preemptable(preemptor, preemptees)
        metrics.preemption_victims.set(len(victims))
        err = validate_victims(preemptor, node, victims)
        if err is not None:
            continue
        # evict lowest-priority victims first
        victims_queue = PriorityQueue(
            lambda l, r: not ssn.task_order_fn(l, r))
        for v in victims:
            victims_queue.push(v)
        while not victims_queue.empty():
            if preemptor.init_resreq.less_equal(node.future_idle()):
                break
            victim = victims_queue.pop()
            try:
                stmt.evict(victim, "preempt")
            except (KeyError, ValueError) as e:
                log.warning("failed to preempt %s: %s", victim.key, e)
                continue
        metrics.preemption_attempts.inc()
        if preemptor.init_resreq.less_equal(node.future_idle()):
            stmt.pipeline(preemptor, node.name)
            return True
    return False


class PreemptAction(Action):
    def name(self) -> str:
        return "preempt"

    def execute(self, ssn) -> None:
        if self.resolve_mode(ssn) == "host":
            self._execute_host(ssn)
            return
        # per-job routing (mirrors allocate): host-only
        # claimers run the host loop; everyone else solves on device
        host_only = set(ssn.solver_options.get("host_only_jobs") or ())
        from .evict_solver import run_evict_solver
        claimers = run_evict_solver(ssn, "preempt", skip_jobs=host_only)
        if claimers is None:
            # device path unavailable (breaker open / solve failed):
            # degrade the whole action to the host loop for this cycle
            self._execute_host(ssn)
            return
        if host_only:
            self._execute_host(ssn, only_jobs=host_only)
        # intra-job task-level preemption stays on the host path (small,
        # within one job's own tasks — preempt.go:137-156 second phase).
        # It runs on exactly the solver's claimer set (the host loop's
        # under_request: jobs that were not yet pipelined at collection).
        self._intra_job(ssn, claimers)

    def _intra_job(self, ssn, jobs) -> None:
        oc = getattr(ssn, "order_cache", None)
        for job in jobs:
            # same order, two sources: the OrderCache's version-gated
            # sorted pending list when the job is unchanged since the
            # last keyed allocate cycle, else the comparator heap (jobs
            # the solver phase just mutated always take this path)
            pending = oc.pending_tasks(ssn, job) if oc is not None \
                else None
            if pending is None:
                pq = PriorityQueue(ssn.task_order_fn)
                for task in job.task_status_index.get(
                        TaskStatus.PENDING, {}).values():
                    if not task.resreq.is_empty():
                        pq.push(task)
                pending = []
                while not pq.empty():
                    pending.append(pq.pop())
            for preemptor in pending:
                stmt = ssn.statement()

                def task_filter(task, preemptor=preemptor):
                    if task.status != TaskStatus.RUNNING:
                        return False
                    if task.resreq.is_empty():
                        return False
                    return preemptor.job == task.job

                assigned = _preempt_one(ssn, stmt, preemptor, task_filter)
                stmt.commit()
                if not assigned:
                    break

    def _execute_host(self, ssn, only_jobs=None) -> None:
        preemptors_map: Dict[str, PriorityQueue] = {}
        preemptor_tasks: Dict[str, PriorityQueue] = {}
        under_request = []
        queues = {}

        for job in ssn.jobs.values():
            if only_jobs is not None and job.uid not in only_jobs:
                continue
            if job.pod_group.status.phase == PodGroupPhase.PENDING:
                continue
            vr = ssn.job_valid(job)
            if vr is not None and not vr.passed:
                continue
            queue = ssn.queues.get(job.queue)
            if queue is None:
                continue
            queues[queue.uid] = queue
            pending = job.task_status_index.get(TaskStatus.PENDING, {})
            if pending and not ssn.job_pipelined(job):
                preemptors_map.setdefault(
                    job.queue, PriorityQueue(ssn.job_order_fn)).push(job)
                under_request.append(job)
                pq = PriorityQueue(ssn.task_order_fn)
                for task in pending.values():
                    pq.push(task)
                preemptor_tasks[job.uid] = pq

        for queue in queues.values():
            # inter-job preemption within the queue
            while True:
                preemptors = preemptors_map.get(queue.name)
                if preemptors is None or preemptors.empty():
                    break
                preemptor_job = preemptors.pop()
                stmt = ssn.statement()
                assigned = False
                while True:
                    if ssn.job_pipelined(preemptor_job):
                        break
                    if preemptor_tasks[preemptor_job.uid].empty():
                        break
                    preemptor = preemptor_tasks[preemptor_job.uid].pop()

                    def job_filter(task, preemptor_job=preemptor_job,
                                   preemptor=preemptor):
                        if task.status != TaskStatus.RUNNING:
                            return False
                        if task.resreq.is_empty():
                            return False
                        job = ssn.jobs.get(task.job)
                        if job is None:
                            return False
                        return (job.queue == preemptor_job.queue
                                and preemptor.job != task.job)

                    if _preempt_one(ssn, stmt, preemptor, job_filter):
                        assigned = True
                if ssn.job_pipelined(preemptor_job):
                    stmt.commit()
                else:
                    stmt.discard()
                    continue
                if assigned:
                    preemptors.push(preemptor_job)

            # intra-job task-level preemption
            for job in under_request:
                while True:
                    pq = preemptor_tasks.get(job.uid)
                    if pq is None or pq.empty():
                        break
                    preemptor = pq.pop()
                    stmt = ssn.statement()

                    def task_filter(task, preemptor=preemptor):
                        if task.status != TaskStatus.RUNNING:
                            return False
                        if task.resreq.is_empty():
                            return False
                        return preemptor.job == task.job

                    assigned = _preempt_one(ssn, stmt, preemptor, task_filter)
                    stmt.commit()
                    if not assigned:
                        break
