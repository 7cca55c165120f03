"""Garbage collector (reference controllers/garbagecollector/garbagecollector.go:52-249).

Deletes finished Jobs (Completed/Failed/Terminated) after
ttl_seconds_after_finished expires, cascading to owned resources.
"""

from __future__ import annotations

import logging
import time
from typing import List, Optional

from ..client.store import ClusterStore, NotFoundError
from ..models import Job, JobPhase
from .framework import Controller, ControllerOption

log = logging.getLogger(__name__)

FINISHED_PHASES = {JobPhase.COMPLETED, JobPhase.FAILED, JobPhase.TERMINATED}


def _finish_time(job: Job) -> float:
    return job.status.state.last_transition_time or job.creation_timestamp


class GarbageCollector(Controller):
    def __init__(self):
        self.cluster: Optional[ClusterStore] = None
        self.queue: List[str] = []

    def name(self) -> str:
        return "gc-controller"

    def initialize(self, opt: ControllerOption) -> None:
        self.cluster = opt.cluster

    def run(self) -> None:
        self.cluster.watch("jobs", self._on_job)

    def _on_job(self, event, job: Job, old) -> None:
        if event == "delete":
            return
        if job.spec.ttl_seconds_after_finished is None:
            return
        if job.status.state.phase in FINISHED_PHASES:
            self.queue.append(job.key)

    def process_all(self, now: Optional[float] = None) -> None:
        """Collect expired jobs; `now` injectable for tests."""
        now = now if now is not None else time.time()
        keys, self.queue = list(dict.fromkeys(self.queue)), []
        for key in keys:
            ns, name = key.split("/", 1)
            job = self.cluster.try_get("jobs", name, ns)
            if job is None:
                continue
            if job.status.state.phase not in FINISHED_PHASES:
                continue
            ttl = job.spec.ttl_seconds_after_finished
            if ttl is None:
                continue
            expire_at = _finish_time(job) + ttl
            if now >= expire_at:
                self._cascade_delete(job)
            else:
                self.queue.append(key)  # re-check later

    def _cascade_delete(self, job: Job) -> None:
        # propagate: pods, podgroup, plugin resources owned by the job
        for pod in self.cluster.list("pods", namespace=job.namespace):
            if (pod.annotations or {}).get("volcano.sh/job-name") == job.name:
                try:
                    self.cluster.delete("pods", pod.name, pod.namespace)
                except NotFoundError:
                    pass
        for kind in ("podgroups", "configmaps", "services", "secrets"):
            for obj in self.cluster.list(kind, namespace=job.namespace):
                owners = getattr(obj, "owner_references", []) or []
                if any(o.get("uid") == job.uid for o in owners) \
                        or obj.name == job.name:
                    try:
                        self.cluster.delete(kind, obj.name, job.namespace)
                    except NotFoundError:
                        pass
        try:
            self.cluster.delete("jobs", job.name, job.namespace)
        except NotFoundError:
            pass
