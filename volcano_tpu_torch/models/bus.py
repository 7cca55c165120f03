"""bus API group: Command CR + Action/Event enums.

Mirrors reference pkg/apis/bus/v1alpha1/{commands.go,actions.go:20-61,
events.go:20-51}.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from .core import new_uid


class Action(str, enum.Enum):
    ABORT_JOB = "AbortJob"
    RESTART_JOB = "RestartJob"
    RESTART_TASK = "RestartTask"
    TERMINATE_JOB = "TerminateJob"
    COMPLETE_JOB = "CompleteJob"
    RESUME_JOB = "ResumeJob"
    SYNC_JOB = "SyncJob"
    ENQUEUE_JOB = "EnqueueJob"
    SYNC_QUEUE = "SyncQueue"
    OPEN_QUEUE = "OpenQueue"
    CLOSE_QUEUE = "CloseQueue"


class Event(str, enum.Enum):
    ANY = "*"
    POD_FAILED = "PodFailed"
    POD_EVICTED = "PodEvicted"
    UNKNOWN = "Unknown"
    TASK_COMPLETED = "TaskCompleted"
    OUT_OF_SYNC = "OutOfSync"
    COMMAND_ISSUED = "CommandIssued"
    JOB_UPDATED = "JobUpdated"


@dataclass
class Command:
    """An operation requested on a target object (usually a Job)."""

    name: str
    namespace: str = "default"
    uid: str = field(default_factory=lambda: new_uid("cmd"))
    action: Action = Action.SYNC_JOB
    target_object: Optional[Dict[str, Any]] = None  # owner-ref-shaped {kind, name, uid}
    reason: str = ""
    message: str = ""
