"""GPUDevice: per-card GPU-memory accounting for the GPU-sharing predicate.

Reimplements reference pkg/scheduler/api/device_info.go:24-70,
pod_info.go:81-120 and the NodeInfo GPU helpers (node_info.go:148-170,
342-391). Cards are tracked host-side only: per-card feasibility depends on
which card each sharing pod landed on, so it stays a host predicate (the
allocate action drops to host mode when GPU sharing is enabled).
"""

from __future__ import annotations

import time
from typing import Dict

#: extended resource: total sharable GPU memory of a node / pod request
VOLCANO_GPU_RESOURCE = "volcano.sh/gpu-memory"
#: extended resource: number of physical cards on the node
VOLCANO_GPU_NUMBER = "volcano.sh/gpu-number"
#: pod annotation: the card index the scheduler picked
GPU_INDEX = "volcano.sh/gpu-index"
#: pod annotation: when the predicate decision was made
PREDICATE_TIME = "volcano.sh/predicate-time"


def gpu_resource_of_pod(pod) -> int:
    """GPU memory requested by the pod: sum of container *limits* of
    volcano.sh/gpu-memory (device_info.go:55-70)."""
    total = 0
    for c in pod.containers:
        val = (c.get("limits") or {}).get(VOLCANO_GPU_RESOURCE)
        if val is not None:
            total += int(float(val))
    return total


def get_gpu_index(pod) -> int:
    """The card index assigned via annotation, or -1 (pod_info.go:81-97)."""
    value = (pod.annotations or {}).get(GPU_INDEX)
    if value is None:
        return -1
    try:
        return int(value)
    except ValueError:
        return -1


def add_gpu_index(pod, dev_id: int) -> None:
    """Annotate the pod with its card (pod_info.go AddGPUIndexPatch — the
    JSON-patch becomes a direct annotation write against the store)."""
    pod.annotations[PREDICATE_TIME] = str(time.time_ns())
    pod.annotations[GPU_INDEX] = str(dev_id)


def remove_gpu_index(pod) -> None:
    pod.annotations.pop(PREDICATE_TIME, None)
    pod.annotations.pop(GPU_INDEX, None)


class GPUDevice:
    """One physical card: id, memory, and the pods sharing it
    (device_info.go:24-52)."""

    __slots__ = ("id", "memory", "pod_map")

    def __init__(self, dev_id: int, memory: int):
        self.id = dev_id
        self.memory = memory
        self.pod_map: Dict[str, object] = {}  # pod uid -> Pod

    def used_memory(self) -> int:
        used = 0
        for pod in self.pod_map.values():
            if pod.phase in ("Succeeded", "Failed"):
                continue
            used += gpu_resource_of_pod(pod)
        return used

    def clone(self) -> "GPUDevice":
        d = GPUDevice(self.id, self.memory)
        d.pod_map = dict(self.pod_map)
        return d


def predicate_gpu(pod, node_info) -> int:
    """First card with enough idle memory, or -1 (plugins/predicates/gpu.go
    predicateGPU)."""
    request = gpu_resource_of_pod(pod)
    idle = node_info.devices_idle_gpu_memory()
    for dev_id in sorted(idle):
        if idle[dev_id] >= request:
            return dev_id
    return -1
