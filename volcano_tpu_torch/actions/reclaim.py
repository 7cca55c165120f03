"""Reclaim action (reference actions/reclaim/reclaim.go:40-192).

Cross-queue: starving jobs of underused queues evict Running tasks of other,
reclaimable queues (tier-intersected Reclaimable fns). Evictions are
immediate (not statement-buffered), then the reclaimer pipelines.
"""

from __future__ import annotations

import logging
from typing import Dict

from ..api import Resource, TaskStatus
from ..framework import Action
from ..models import PodGroupPhase
from ..utils import PriorityQueue
from ..utils.scheduler_helper import validate_victims

log = logging.getLogger(__name__)


class ReclaimAction(Action):
    def name(self) -> str:
        return "reclaim"

    def execute(self, ssn) -> None:
        if self.resolve_mode(ssn) == "host":
            self._execute_host(ssn)
            return
        # per-job routing (mirrors allocate)
        host_only = set(ssn.solver_options.get("host_only_jobs") or ())
        from .evict_solver import run_evict_solver
        if run_evict_solver(ssn, "reclaim", skip_jobs=host_only) is None:
            # device path unavailable (breaker open / solve failed):
            # degrade the whole action to the host loop for this cycle
            self._execute_host(ssn)
            return
        if host_only:
            self._execute_host(ssn, only_jobs=host_only)

    def _execute_host(self, ssn, only_jobs=None) -> None:
        from ..plugins.predicates import PredicateError

        queues = PriorityQueue(ssn.queue_order_fn)
        queue_set = set()
        preemptors_map: Dict[str, PriorityQueue] = {}
        preemptor_tasks: Dict[str, PriorityQueue] = {}

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
            if queue.uid not in queue_set:
                queue_set.add(queue.uid)
                queues.push(queue)
            pending = job.task_status_index.get(TaskStatus.PENDING, {})
            if pending:
                preemptors_map.setdefault(
                    job.queue, PriorityQueue(ssn.job_order_fn)).push(job)
                pq = PriorityQueue(ssn.task_order_fn)
                for task in pending.values():
                    pq.push(task)
                preemptor_tasks[job.uid] = pq

        while not queues.empty():
            queue = queues.pop()
            if ssn.overused(queue):
                continue
            jobs = preemptors_map.get(queue.name)
            if jobs is None or jobs.empty():
                continue
            job = jobs.pop()
            tasks = preemptor_tasks.get(job.uid)
            if tasks is None or tasks.empty():
                continue
            task = tasks.pop()

            assigned = False
            for node in ssn.nodes.values():
                try:
                    ssn.predicate_fn(task, node)
                except PredicateError:
                    continue
                resreq = task.init_resreq.clone()
                reclaimed = Resource()
                reclaimees = []
                for t in node.tasks.values():
                    if t.status != TaskStatus.RUNNING:
                        continue
                    j = ssn.jobs.get(t.job)
                    if j is None:
                        continue
                    if j.queue != job.queue:
                        q = ssn.queues.get(j.queue)
                        if q is None or not q.reclaimable:
                            continue
                        reclaimees.append(t.clone())
                victims = ssn.reclaimable(task, reclaimees)
                if validate_victims(task, node, victims) is not None:
                    continue
                for reclaimee in victims:
                    try:
                        ssn.evict(reclaimee, "reclaim")
                    except (KeyError, ValueError) as e:
                        log.warning("failed to reclaim %s: %s",
                                    reclaimee.key, e)
                        continue
                    reclaimed.add(reclaimee.resreq)
                    if resreq.less_equal(reclaimed):
                        break
                if task.init_resreq.less_equal(reclaimed):
                    try:
                        ssn.pipeline(task, node.name)
                    except (KeyError, ValueError):
                        log.warning("failed to pipeline %s on %s",
                                    task.key, node.name)
                    assigned = True
                    break
            if assigned:
                jobs.push(job)
            queues.push(queue)
