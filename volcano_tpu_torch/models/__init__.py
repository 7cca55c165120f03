"""Core-object shims (Pod/Node) and the scheduling API group (PodGroup,
Queue) the allocate solve reads. The batch and bus groups belong to the
controllers and are not part of this package yet."""

from .core import (  # noqa: F401
    ConfigMap, Lease, NetworkPolicy, Node, PersistentVolumeClaim, Pod,
    PriorityClass, ResourceQuota, Secret, Service, new_uid,
)
from .scheduling import (  # noqa: F401
    BindIntent, MigrationIntent,
    PodGroup, PodGroupCondition, PodGroupPhase, PodGroupSpec, PodGroupStatus,
    Queue, QueueSpec, QueueState, QueueStatus,
    POD_GROUP_UNSCHEDULABLE_TYPE, POD_GROUP_SCHEDULED_TYPE,
    NOT_ENOUGH_RESOURCES_REASON, NOT_ENOUGH_PODS_REASON, POD_GROUP_READY_REASON,
)
