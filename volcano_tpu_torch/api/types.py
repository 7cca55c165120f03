"""Core enums and callback typedefs (reference pkg/scheduler/api/types.go)."""

from __future__ import annotations

import enum
import itertools

#: Global, never-repeating flatten-version source. Every mutation of a
#: JobInfo/NodeInfo takes a fresh value instead of incrementing a private
#: counter, so a session clone and the live cache object that diverge after
#: the clone can never alias the same (name, flat_version) flatten-cache key
#: — while an unmutated clone still carries its source's version and keeps
#: the cache warm.
_FLAT_VERSION_COUNTER = itertools.count(1)


def next_flat_version() -> int:
    return next(_FLAT_VERSION_COUNTER)


class TaskStatus(enum.IntEnum):
    """Task lifecycle status (types.go:26-58, bitmask-style iota order kept)."""

    PENDING = 1 << 0     # pod not scheduled yet
    ALLOCATED = 1 << 1   # assigned in session, not yet dispatched
    PIPELINED = 1 << 2   # assigned onto releasing resources
    BINDING = 1 << 3     # bind request sent
    BOUND = 1 << 4       # bound to host
    RUNNING = 1 << 5
    RELEASING = 1 << 6   # being evicted/deleted
    SUCCEEDED = 1 << 7
    FAILED = 1 << 8
    UNKNOWN = 1 << 9

    def __str__(self) -> str:  # parity with Go String()
        return self.name.capitalize()


#: Statuses counted as occupying node resources from the scheduler's
#: perspective (api/helpers.go AllocatedStatus).
ALLOCATED_STATUSES = frozenset(
    {TaskStatus.BOUND, TaskStatus.BINDING, TaskStatus.RUNNING, TaskStatus.ALLOCATED}
)


def allocated_status(status: TaskStatus) -> bool:
    return status in ALLOCATED_STATUSES


class NodePhase(enum.IntEnum):
    READY = 1
    NOT_READY = 2

    def __str__(self) -> str:
        return "Ready" if self is NodePhase.READY else "NotReady"


# Annotation keys (apis/scheduling/v1beta1/labels.go:19-33)
POD_GROUP_ANNOTATION = "scheduling.k8s.io/group-name"
HIERARCHY_ANNOTATION = "volcano.sh/hierarchy"
HIERARCHY_WEIGHT_ANNOTATION = "volcano.sh/hierarchy-weights"
NAMESPACE_WEIGHT_KEY = "volcano.sh/namespace.weight"

DEFAULT_QUEUE = "default"


def compare_float(l: float, r: float, epsilon: float = 1e-6) -> int:
    if abs(l - r) < epsilon:
        return 0
    return -1 if l < r else 1
