"""CRD-shaped domain model of the port.

Three API groups mirroring the reference (pkg/apis/{batch,bus,scheduling})
plus core-object shims (Pod/Node) so the framework is cluster-agnostic.
"""

from .batch import (  # noqa: F401
    Job, JobEvent, JobPhase, JobSpec, JobState, JobStatus, LifecyclePolicy,
    TaskSpec, DEFAULT_MAX_RETRY, TASK_SPEC_KEY, JOB_NAME_KEY, JOB_VERSION_KEY,
)
from .bus import Action, Command, Event  # noqa: F401
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
