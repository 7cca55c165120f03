"""Enqueue action (reference actions/enqueue/enqueue.go:56-174).

Pending PodGroups go Inqueue when the cluster's overcommitted idle can hold
their MinResources and every JobEnqueueable fn passes.
"""

from __future__ import annotations

from ..api import Resource
from ..framework import Action, Arguments
from ..models import PodGroupPhase
from ..utils import PriorityQueue

DEFAULT_OVERCOMMIT_FACTOR = 1.2


class EnqueueAction(Action):
    def name(self) -> str:
        return "enqueue"

    def _overcommit_factor(self, ssn) -> float:
        for conf in ssn.configurations:
            if conf.name == self.name():
                return Arguments(conf.arguments).get_float(
                    "overcommit-factor", DEFAULT_OVERCOMMIT_FACTOR)
        return DEFAULT_OVERCOMMIT_FACTOR

    def execute(self, ssn) -> None:
        queues = PriorityQueue(ssn.queue_order_fn)
        queue_set = set()
        jobs_map = {}
        # ordering keys are frozen during enqueue (nothing allocates), so
        # the key-sorted queue applies whenever the plugins provide keys
        job_queue_factory = ssn.keyed_job_queue_factory() \
            or (lambda: PriorityQueue(ssn.job_order_fn))

        import time
        for job in ssn.jobs.values():
            if job.schedule_start_timestamp is None:
                job.schedule_start_timestamp = time.time()
            queue = ssn.queues.get(job.queue)
            if queue is None:
                continue
            if queue.uid not in queue_set:
                queue_set.add(queue.uid)
                queues.push(queue)
            if job.pod_group.status.phase == PodGroupPhase.PENDING:
                jobs_map.setdefault(
                    job.queue, job_queue_factory()).push(job)

        used = Resource()
        for node in ssn.nodes.values():
            used.add(node.used)
        idle = ssn.total_allocatable().clone().multi(
            self._overcommit_factor(ssn))
        try:
            idle.sub(used)
        except ValueError:
            idle = Resource()

        while not queues.empty():
            if idle.is_empty():
                break
            queue = queues.pop()
            jobs = jobs_map.get(queue.name)
            if jobs is None or jobs.empty():
                continue
            job = jobs.pop()

            inqueue = False
            if not job.pod_group.spec.min_resources:
                inqueue = True
            else:
                min_req = Resource.from_resource_list(
                    job.pod_group.spec.min_resources)
                if ssn.job_enqueueable(job) and min_req.less_equal(idle):
                    try:
                        idle.sub(min_req)
                    except ValueError:
                        idle = Resource()
                    inqueue = True
            if inqueue:
                job.pod_group.status.phase = PodGroupPhase.INQUEUE
                # the flip happens on the session clone AFTER the snapshot
                # seam ran — an in-session delta the watch-fed ordering
                # ledger would never see (it changes allocate's
                # eligibility THIS cycle: Pending-phase jobs are skipped)
                oc = getattr(ssn, "order_cache", None)
                if oc is not None:
                    oc.feed_event("job", "session", job=job.uid)
            queues.push(queue)
