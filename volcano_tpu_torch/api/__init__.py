"""Scheduler data model (reference pkg/scheduler/api)."""

from .cluster_info import ClusterInfo  # noqa: F401
from .device_info import (  # noqa: F401
    GPU_INDEX, GPUDevice, PREDICATE_TIME, VOLCANO_GPU_NUMBER,
    VOLCANO_GPU_RESOURCE, add_gpu_index, get_gpu_index, gpu_resource_of_pod,
    predicate_gpu, remove_gpu_index,
)
from .job_info import (  # noqa: F401
    JobInfo, TaskInfo, job_key_of_pod, pod_key,
    get_pod_resource_request, get_pod_resource_without_init_containers,
    status_of_pod,
)
from .node_info import NodeInfo, NodeState  # noqa: F401
from .queue_info import NamespaceCollection, NamespaceInfo, QueueInfo  # noqa: F401
from .resource import (  # noqa: F401
    MIN_MEMORY, MIN_MILLI_CPU, MIN_MILLI_SCALAR,
    Resource, ResourceVocab, parse_quantity,
)
from .types import (  # noqa: F401
    ALLOCATED_STATUSES, DEFAULT_QUEUE, NodePhase, POD_GROUP_ANNOTATION,
    TaskStatus, allocated_status, compare_float,
)
from .unschedule_info import FitError, FitErrors  # noqa: F401
