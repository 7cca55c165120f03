"""Controller request/job-info types (reference pkg/controllers/apis)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from ..models import Action, Event, Job, Pod


@dataclass
class Request:
    namespace: str
    job_name: str
    task_name: str = ""
    event: Optional[Event] = None
    exit_code: int = 0
    action: Optional[Action] = None
    job_version: int = 0

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.job_name}"


class JobInfo:
    """Controller-cache view of a Job: the CR + its pods indexed by task
    (apis/job_info.go:28)."""

    def __init__(self, job: Job):
        self.job = job
        self.pods: Dict[str, Dict[str, Pod]] = {}  # task name -> pod name -> pod

    def clone(self) -> "JobInfo":
        ji = JobInfo(self.job)
        for task, pods in self.pods.items():
            ji.pods[task] = dict(pods)
        return ji

    def add_pod(self, pod: Pod) -> None:
        from ..models.batch import TASK_SPEC_KEY
        task_name = (pod.annotations or {}).get(TASK_SPEC_KEY, "")
        self.pods.setdefault(task_name, {})[pod.name] = pod

    def delete_pod(self, pod: Pod) -> None:
        from ..models.batch import TASK_SPEC_KEY
        task_name = (pod.annotations or {}).get(TASK_SPEC_KEY, "")
        bucket = self.pods.get(task_name)
        if bucket is not None:
            bucket.pop(pod.name, None)
            if not bucket:
                del self.pods[task_name]
