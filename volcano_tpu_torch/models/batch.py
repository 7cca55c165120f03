"""batch API group: the Job CR (reference pkg/apis/batch/v1alpha1/job.go:32-280)."""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .bus import Action, Event
from .core import new_uid

DEFAULT_MAX_RETRY = 3
TASK_SPEC_KEY = "volcano.sh/task-spec"
JOB_NAME_KEY = "volcano.sh/job-name"
JOB_NAMESPACE_KEY = "volcano.sh/job-namespace"
JOB_VERSION_KEY = "volcano.sh/job-version"
POD_TEMPLATE_KEY = "volcano.sh/template-uid"
JOB_TYPE_KEY = "volcano.sh/job-type"
PODGROUP_NAME_FMT = "podgroup-{uid}"


class JobPhase(str, enum.Enum):
    PENDING = "Pending"
    ABORTING = "Aborting"
    ABORTED = "Aborted"
    RUNNING = "Running"
    RESTARTING = "Restarting"
    COMPLETING = "Completing"
    COMPLETED = "Completed"
    TERMINATING = "Terminating"
    TERMINATED = "Terminated"
    FAILED = "Failed"


class JobEvent(str, enum.Enum):
    COMMAND_ISSUED = "CommandIssued"
    PLUGIN_ERROR = "PluginError"
    PVC_ERROR = "PVCError"
    POD_GROUP_ERROR = "PodGroupError"
    EXECUTE_ACTION = "ExecuteAction"
    JOB_STATUS_ERROR = "JobStatusError"


@dataclass
class LifecyclePolicy:
    """Maps an observed event (or exit code) to an action (job.go:94-134)."""

    action: Action = Action.SYNC_JOB
    event: Optional[Event] = None
    events: List[Event] = field(default_factory=list)
    exit_code: Optional[int] = None
    timeout_seconds: Optional[float] = None

    def matches(self, event: Event, exit_code: Optional[int]) -> bool:
        evs = set(self.events)
        if self.event is not None:
            evs.add(self.event)
        if Event.ANY in evs:
            return True
        if exit_code is not None and self.exit_code is not None:
            return self.exit_code == exit_code
        return event in evs


@dataclass
class TaskSpec:
    """One replica group in a Job (job.go:136-160)."""

    name: str = ""
    replicas: int = 1
    template: Dict[str, Any] = field(default_factory=dict)  # pod template dict
    policies: List[LifecyclePolicy] = field(default_factory=list)


@dataclass
class JobSpec:
    scheduler_name: str = "volcano"
    min_available: int = 0
    volumes: List[Dict[str, Any]] = field(default_factory=list)
    tasks: List[TaskSpec] = field(default_factory=list)
    policies: List[LifecyclePolicy] = field(default_factory=list)
    plugins: Dict[str, List[str]] = field(default_factory=dict)
    running_estimate: Optional[float] = None
    queue: str = ""
    max_retry: int = DEFAULT_MAX_RETRY
    ttl_seconds_after_finished: Optional[int] = None
    priority_class_name: str = ""


@dataclass
class JobState:
    phase: JobPhase = JobPhase.PENDING
    reason: str = ""
    message: str = ""
    last_transition_time: float = field(default_factory=time.time)


@dataclass
class JobStatus:
    state: JobState = field(default_factory=JobState)
    min_available: int = 0
    pending: int = 0
    running: int = 0
    succeeded: int = 0
    failed: int = 0
    terminating: int = 0
    unknown: int = 0
    version: int = 0
    retry_count: int = 0
    controlled_resources: Dict[str, str] = field(default_factory=dict)


@dataclass
class Job:
    name: str
    namespace: str = "default"
    uid: str = field(default_factory=lambda: new_uid("job"))
    annotations: Dict[str, str] = field(default_factory=dict)
    labels: Dict[str, str] = field(default_factory=dict)
    spec: JobSpec = field(default_factory=JobSpec)
    status: JobStatus = field(default_factory=JobStatus)
    creation_timestamp: float = field(default_factory=time.time)
    deletion_timestamp: Optional[float] = None
    resource_version: int = 0

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"
