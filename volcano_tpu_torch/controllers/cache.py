"""Controller job cache (reference pkg/controllers/cache/cache.go).

jobKey -> JobInfo{Job, Pods[task][podname]} so workers don't re-list.
"""

from __future__ import annotations

from typing import Dict, Optional

from ..models import Job, Pod
from ..models.batch import JOB_NAME_KEY
from .apis import JobInfo


def job_key_of_pod(pod: Pod) -> Optional[str]:
    job_name = (pod.annotations or {}).get(JOB_NAME_KEY)
    if not job_name:
        return None
    return f"{pod.namespace}/{job_name}"


class JobCache:
    def __init__(self):
        self.jobs: Dict[str, JobInfo] = {}

    def get(self, key: str) -> Optional[JobInfo]:
        ji = self.jobs.get(key)
        return ji.clone() if ji is not None else None

    def add(self, job: Job) -> None:
        key = job.key
        if key in self.jobs:
            self.jobs[key].job = job
        else:
            self.jobs[key] = JobInfo(job)

    def update(self, job: Job) -> None:
        self.add(job)

    def delete(self, job: Job) -> None:
        self.jobs.pop(job.key, None)

    def add_pod(self, pod: Pod) -> None:
        key = job_key_of_pod(pod)
        if key is None:
            return
        if key not in self.jobs:
            self.jobs[key] = JobInfo(None)
        self.jobs[key].add_pod(pod)

    def update_pod(self, pod: Pod) -> None:
        self.add_pod(pod)

    def delete_pod(self, pod: Pod) -> None:
        key = job_key_of_pod(pod)
        if key is None:
            return
        ji = self.jobs.get(key)
        if ji is not None:
            ji.delete_pod(pod)
            if ji.job is None and not ji.pods:
                del self.jobs[key]

    def task_completed(self, key: str, task_name: str) -> bool:
        """All pods of the task succeeded (cache.go TaskCompleted)."""
        ji = self.jobs.get(key)
        if ji is None or ji.job is None:
            return False
        pods = ji.pods.get(task_name, {})
        replicas = 0
        for task in ji.job.spec.tasks:
            if task.name == task_name:
                replicas = task.replicas
        if replicas == 0 or not pods:
            return False
        succeeded = sum(1 for p in pods.values() if p.phase == "Succeeded")
        return succeeded >= replicas
