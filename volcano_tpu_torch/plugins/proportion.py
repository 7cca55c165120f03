"""Proportion plugin (reference plugins/proportion/proportion.go:75-326).

Weighted fair-share of the cluster among queues: iterative water-filling of
per-queue `deserved` by weight, clamped by capability and request; overused,
reclaimable and job-enqueueable checks derive from it.
"""

from __future__ import annotations

from typing import Dict, Optional

from ..api import Resource, allocated_status, TaskStatus
from ..framework import EventHandler, Plugin
from ..metrics import metrics
from ..models import PodGroupPhase
from .drf import share


class _QueueAttr:
    __slots__ = ("queue_id", "name", "weight", "deserved", "allocated",
                 "request", "inqueue", "capability", "share")

    def __init__(self, queue_id: str, name: str, weight: int):
        self.queue_id = queue_id
        self.name = name
        self.weight = max(int(weight or 1), 1)
        self.deserved = Resource()
        self.allocated = Resource()
        self.request = Resource()
        self.inqueue = Resource()
        self.capability: Optional[Resource] = None
        self.share = 0.0


def _min_resource(l: Resource, r: Resource) -> Resource:
    out = Resource(min(l.milli_cpu, r.milli_cpu), min(l.memory, r.memory))
    for k, v in l.scalars.items():
        out.scalars[k] = min(v, r.scalars.get(k, 0.0))
    return out


class ProportionPlugin(Plugin):
    def __init__(self, arguments=None):
        self.arguments = arguments or {}
        self.total_resource = Resource()
        self.queue_opts: Dict[str, _QueueAttr] = {}

    def name(self) -> str:
        return "proportion"

    def _update_share(self, attr: _QueueAttr) -> None:
        res = 0.0
        for rn in attr.deserved.resource_names():
            s = share(attr.allocated.get(rn), attr.deserved.get(rn))
            res = max(res, s)
        attr.share = res
        metrics.queue_share.set(res, {"queue_name": attr.name})

    def on_session_open(self, ssn) -> None:
        self.total_resource = ssn.total_allocatable().clone()

        for job in ssn.jobs.values():
            if job.queue not in self.queue_opts:
                queue = ssn.queues.get(job.queue)
                if queue is None:
                    continue
                attr = _QueueAttr(queue.uid, queue.name, queue.weight)
                if queue.capability:
                    attr.capability = Resource.from_resource_list(
                        queue.capability)
                self.queue_opts[job.queue] = attr
            attr = self.queue_opts[job.queue]
            # maintained aggregates (job_info) replace the per-task loops of
            # proportion.go:120-134: allocated = allocated-status sum,
            # request = allocated + pending sums — O(jobs) per session open
            attr.allocated.add(job.allocated)
            attr.request.add(job.allocated)
            attr.request.add(job.pending_request)
            if job.pod_group.status.phase == PodGroupPhase.INQUEUE:
                attr.inqueue.add(Resource.from_resource_list(
                    job.pod_group.spec.min_resources or {}))

        for attr in self.queue_opts.values():
            metrics.update_queue_metrics(attr.name, attr.allocated,
                                         attr.request)
            metrics.queue_weight.set(attr.weight, {"queue_name": attr.name})

        # iterative water-filling (proportion.go:137-197)
        remaining = self.total_resource.clone()
        meet = set()
        while True:
            total_weight = sum(a.weight for a in self.queue_opts.values()
                               if a.queue_id not in meet)
            if total_weight == 0:
                break
            increased, decreased = Resource(), Resource()
            for attr in self.queue_opts.values():
                if attr.queue_id in meet:
                    continue
                old_deserved = attr.deserved.clone()
                attr.deserved.add(
                    remaining.clone().multi(attr.weight / total_weight))
                if attr.capability is not None and \
                        not attr.deserved.less_equal_strict(attr.capability):
                    attr.deserved = _min_resource(attr.deserved,
                                                  attr.capability)
                    attr.deserved = _min_resource(attr.deserved, attr.request)
                    meet.add(attr.queue_id)
                elif attr.request.less(attr.deserved):
                    attr.deserved = _min_resource(attr.deserved, attr.request)
                    meet.add(attr.queue_id)
                self._update_share(attr)
                inc, dec = attr.deserved.diff(old_deserved)
                increased.add(inc)
                decreased.add(dec)
                metrics.queue_deserved_milli_cpu.set(
                    attr.deserved.milli_cpu, {"queue_name": attr.name})
                metrics.queue_deserved_memory_bytes.set(
                    attr.deserved.memory, {"queue_name": attr.name})
            try:
                remaining.sub(increased)
            except ValueError:
                remaining = Resource()
            remaining.add(decreased)
            if remaining.is_empty():
                break

        def queue_order_fn(l, r):
            la = self.queue_opts.get(l.uid)
            ra = self.queue_opts.get(r.uid)
            if la is None or ra is None:
                return 0
            if la.share == ra.share:
                return 0
            return -1 if la.share < ra.share else 1

        ssn.add_queue_order_fn(self.name(), queue_order_fn)

        # publish per-queue attrs so the allocate solver can water-fill
        # deserved on device and cap per-round admissions per queue
        ssn.solver_options["queue_opts"] = self.queue_opts
        # proportion.workConserving=false pins the solver to strict
        # reference parity: no overflow phases, no unrequested-dim cap
        # easing (ADVICE r2 #1 — operators who need proportion.go:245's
        # any-dim overused behavior byte-for-byte can opt out of the
        # strandings-avoidance improvements)
        from ..framework import Arguments
        args = (self.arguments if isinstance(self.arguments, Arguments)
                else Arguments(self.arguments))
        ssn.solver_options["work_conserving"] = args.get_bool(
            "proportion.workConserving", True)

        def reclaimable_fn(reclaimer, reclaimees):
            victims = []
            allocations: Dict[str, Resource] = {}
            for reclaimee in reclaimees:
                job = ssn.jobs.get(reclaimee.job)
                attr = self.queue_opts.get(job.queue)
                if attr is None:
                    continue
                if job.queue not in allocations:
                    allocations[job.queue] = attr.allocated.clone()
                allocated = allocations[job.queue]
                if allocated.less(reclaimee.resreq):
                    continue
                try:
                    allocated.sub(reclaimee.resreq)
                except ValueError:
                    continue
                if attr.deserved.less_equal_strict(allocated):
                    victims.append(reclaimee)
            return victims

        ssn.add_reclaimable_fn(self.name(), reclaimable_fn)

        def overused_fn(queue) -> bool:
            attr = self.queue_opts.get(queue.uid)
            if attr is None:
                return False
            overused = not attr.allocated.less_equal(attr.deserved)
            metrics.queue_overused.set(
                1.0 if overused else 0.0, {"queue_name": attr.name})
            return overused

        ssn.add_overused_fn(self.name(), overused_fn)

        def job_enqueueable_fn(job) -> bool:
            attr = self.queue_opts.get(job.queue)
            queue = ssn.queues.get(job.queue)
            if attr is None or queue is None:
                return True
            if not queue.capability:
                return True
            if not job.pod_group.spec.min_resources:
                return True
            min_req = Resource.from_resource_list(
                job.pod_group.spec.min_resources)
            cap = Resource.from_resource_list(queue.capability)
            total = min_req.clone().add(attr.allocated).add(attr.inqueue)
            if total.less_equal(cap):
                attr.inqueue.add(min_req)
                return True
            return False

        ssn.add_job_enqueueable_fn(self.name(), job_enqueueable_fn)

        def on_allocate(event):
            job = ssn.jobs.get(event.task.job)
            attr = self.queue_opts.get(job.queue)
            if attr is None:
                return
            attr.allocated.add(event.task.resreq)
            self._update_share(attr)

        def on_deallocate(event):
            job = ssn.jobs.get(event.task.job)
            attr = self.queue_opts.get(job.queue)
            if attr is None:
                return
            try:
                attr.allocated.sub(event.task.resreq)
            except ValueError:
                pass
            self._update_share(attr)

        def on_allocate_batch(tasks):
            """Additive form: one aggregate add + one share recompute per
            queue (share depends only on the allocated total)."""
            by_queue: Dict[str, list] = {}
            last_job = None  # statements fire per job: one lookup suffices
            queue = None
            for t in tasks:
                if t.job != last_job:
                    job = ssn.jobs.get(t.job)
                    queue = job.queue if job is not None else None
                    last_job = t.job
                if queue is None:
                    continue
                group = by_queue.get(queue)
                if group is None:
                    by_queue[queue] = [t]
                else:
                    group.append(t)
            for qname, group in by_queue.items():
                attr = self.queue_opts.get(qname)
                if attr is None:
                    continue
                attr.allocated.add(Resource.sum_of(t.resreq for t in group))
                self._update_share(attr)

        ssn.add_event_handler(EventHandler(
            allocate_func=on_allocate, deallocate_func=on_deallocate,
            batch_allocate_func=on_allocate_batch))

    def on_session_close(self, ssn) -> None:
        self.total_resource = Resource()
        self.queue_opts = {}
