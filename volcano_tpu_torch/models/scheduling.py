"""scheduling API group: PodGroup and Queue CRs.

Mirrors reference pkg/apis/scheduling/types.go:142-270 (+v1beta1 wire form).
"""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .core import new_uid


class PodGroupPhase(str, enum.Enum):
    PENDING = "Pending"
    RUNNING = "Running"
    UNKNOWN = "Unknown"
    INQUEUE = "Inqueue"


# PodGroup condition types (types.go)
POD_GROUP_UNSCHEDULABLE_TYPE = "Unschedulable"
POD_GROUP_SCHEDULED_TYPE = "Scheduled"
NOT_ENOUGH_RESOURCES_REASON = "NotEnoughResources"
NOT_ENOUGH_PODS_REASON = "NotEnoughTasks"
POD_GROUP_READY_REASON = "tasks in gang are ready to be scheduled"
POD_GROUP_NOT_READY = "pod group is not ready"


@dataclass
class PodGroupCondition:
    type: str = ""
    status: str = "True"
    transition_id: str = ""
    last_transition_time: float = field(default_factory=time.time)
    reason: str = ""
    message: str = ""


@dataclass
class PodGroupSpec:
    min_member: int = 0
    queue: str = "default"
    priority_class_name: str = ""
    min_resources: Dict[str, Any] = field(default_factory=dict)  # resource list


@dataclass
class PodGroupStatus:
    phase: PodGroupPhase = PodGroupPhase.PENDING
    conditions: List[PodGroupCondition] = field(default_factory=list)
    running: int = 0
    succeeded: int = 0
    failed: int = 0

    def fingerprint(self) -> tuple:
        """Significance fingerprint: two statuses with equal fingerprints
        need no write (transition_id/time deliberately excluded, matching
        the job updater's diff rule). Cheap enough to take for every job at
        session open, unlike a full status copy."""
        return (self.phase, self.running, self.succeeded, self.failed,
                tuple((c.type, c.status, c.reason, c.message)
                      for c in self.conditions))


@dataclass
class PodGroup:
    name: str
    namespace: str = "default"
    uid: str = field(default_factory=lambda: new_uid("pg"))
    annotations: Dict[str, str] = field(default_factory=dict)
    labels: Dict[str, str] = field(default_factory=dict)
    spec: PodGroupSpec = field(default_factory=PodGroupSpec)
    status: PodGroupStatus = field(default_factory=PodGroupStatus)
    owner_references: List[Dict[str, Any]] = field(default_factory=list)
    creation_timestamp: float = field(default_factory=time.time)
    resource_version: int = 0


@dataclass
class BindIntent:
    """Durable record of a gang's bind decision, written to the store
    BEFORE the bind effects dispatch (resilience/recovery.py's write-ahead
    journal). ``bindings`` is the decided task->node map as [namespace,
    pod, node] triples; ``holder``/``epoch`` carry the writer's lease
    fencing token so a recovering leader can tell which leadership stint
    decided it. Cluster-scoped (no namespace), like Lease. Lives with the
    models so the wire codec carries it between HA processes."""

    name: str
    job: str = ""
    bindings: List[List[str]] = field(default_factory=list)
    holder: str = ""
    epoch: int = 0
    created: float = 0.0
    uid: str = field(default_factory=lambda: new_uid("bi"))
    resource_version: int = 0


@dataclass
class MigrationIntent:
    """Durable record of one rescheduler migration wave, written BEFORE
    the wave's evictions dispatch (reschedule/intent.py). ``moves`` is
    the decided [namespace, pod, from_node, to_node] quadruple list —
    the eviction set plus the solver's advisory targets. Unlike a
    BindIntent, recovery never re-drives these: a wave whose evictions
    the crash swallowed is ABANDONED (the next reschedule pass re-solves
    against fresh state), so a half-executed plan can only under-migrate,
    never double-evict. Cluster-scoped, like BindIntent."""

    name: str
    moves: List[List[str]] = field(default_factory=list)
    holder: str = ""
    epoch: int = 0
    created: float = 0.0
    uid: str = field(default_factory=lambda: new_uid("mi"))
    resource_version: int = 0


class QueueState(str, enum.Enum):
    OPEN = "Open"
    CLOSED = "Closed"
    CLOSING = "Closing"
    UNKNOWN = "Unknown"


@dataclass
class QueueSpec:
    weight: int = 1
    capability: Dict[str, Any] = field(default_factory=dict)  # resource list
    reclaimable: Optional[bool] = None
    state: Optional[QueueState] = None  # desired state (spec.state in v1beta1)


@dataclass
class QueueStatus:
    state: QueueState = QueueState.OPEN
    unknown: int = 0
    pending: int = 0
    running: int = 0
    inqueue: int = 0


@dataclass
class Queue:
    name: str
    uid: str = field(default_factory=lambda: new_uid("queue"))
    annotations: Dict[str, str] = field(default_factory=dict)
    spec: QueueSpec = field(default_factory=QueueSpec)
    status: QueueStatus = field(default_factory=QueueStatus)
    creation_timestamp: float = field(default_factory=time.time)
    resource_version: int = 0
