"""NodeInfo: per-node resource accounting (reference api/node_info.go:27-392).

The status-dependent Add/Remove accounting is preserved exactly — it is the
ground truth the device arrays (idle / future-idle columns) are flattened
from each session.
"""

from __future__ import annotations

import itertools
from typing import Dict, Optional

from .device_info import (
    GPUDevice, VOLCANO_GPU_NUMBER, VOLCANO_GPU_RESOURCE, get_gpu_index,
    gpu_resource_of_pod,
)
from .job_info import TaskInfo
from .resource import Resource
from .types import NodePhase, TaskStatus, next_flat_version


class NodeState:
    __slots__ = ("phase", "reason")

    def __init__(self, phase: NodePhase = NodePhase.READY, reason: str = ""):
        self.phase = phase
        self.reason = reason


#: distinguishes a deleted-and-recreated node (fresh version counters) from
#: its predecessor in the flatten cache keys
_EPOCH_COUNTER = itertools.count(1)


class NodeInfo:
    """Mutable per-node scheduling state."""

    def __init__(self, node=None):
        self.name = ""
        self.node = None
        self.state = NodeState(NodePhase.NOT_READY, "init")
        self.releasing = Resource()   # being released by terminating tasks
        self.pipelined = Resource()   # promised to pipelined tasks
        self.idle = Resource()
        self.used = Resource()
        self.allocatable = Resource()
        self.capability = Resource()
        self.tasks: Dict[str, TaskInfo] = {}
        self.others: Dict[str, object] = {}
        # GPU sharing: card id -> GPUDevice (node_info.go:148-170)
        self.gpu_devices: Dict[int, GPUDevice] = {}
        # bumped on any accounting mutation; the snapshot flattener's
        # per-node row cache keys on it (ops.arrays)
        self.flat_version = 0
        # bumped only when the node spec changes (set_node): label/taint
        # predicate masks key on this, so binds don't invalidate them
        self.spec_version = 0
        self.flat_epoch = next(_EPOCH_COUNTER)
        if node is not None:
            self.set_node(node)

    # -- node object sync ---------------------------------------------------

    def _check_ready(self, node) -> bool:
        for cond in node.conditions or []:
            if cond.get("type") == "Ready" and cond.get("status") != "True":
                self.state = NodeState(NodePhase.NOT_READY,
                                       "node is not ready")
                return False
        if node.unschedulable:
            self.state = NodeState(NodePhase.NOT_READY, "node is unschedulable")
            return False
        self.state = NodeState(NodePhase.READY)
        return True

    def set_node(self, node) -> None:
        """Rebuild resource views from node.allocatable, replaying held tasks
        (node_info.go:171-210)."""
        self.flat_version = next_flat_version()
        self.spec_version += 1
        if not self._check_ready(node):
            # Keep self.node unset (reference keeps ni.Node nil) so held
            # tasks skip resource accounting until the node turns ready.
            self.name = node.name
            return
        self.name = node.name
        self.node = node
        self.allocatable = Resource.from_resource_list(node.allocatable)
        self.capability = Resource.from_resource_list(node.capacity)
        self.releasing = Resource()
        self.pipelined = Resource()
        self.idle = Resource.from_resource_list(node.allocatable)
        self.used = Resource()
        self._set_gpu_info(node)
        for ti in self.tasks.values():
            self.add_gpu_resource(ti.pod)
            if ti.status == TaskStatus.RELEASING:
                self.idle.sub(ti.resreq)
                self.releasing.add(ti.resreq)
                self.used.add(ti.resreq)
            elif ti.status == TaskStatus.PIPELINED:
                self.pipelined.add(ti.resreq)
            else:
                self.idle.sub(ti.resreq)
                self.used.add(ti.resreq)

    @property
    def ready(self) -> bool:
        return self.state.phase == NodePhase.READY

    def future_idle(self) -> Resource:
        """idle + releasing - pipelined (node_info.go:57-59)."""
        return self.idle.clone().add(self.releasing).sub(self.pipelined)

    # -- GPU sharing (node_info.go:148-170, 342-391) ------------------------

    def _set_gpu_info(self, node) -> None:
        """Per-card devices from capacity volcano.sh/gpu-{memory,number}."""
        self.gpu_devices = {}
        cap = node.capacity or {}
        total = cap.get(VOLCANO_GPU_RESOURCE)
        count = cap.get(VOLCANO_GPU_NUMBER)
        if not total or not count:
            return
        total, count = int(float(total)), int(float(count))
        if count <= 0:
            return
        per_card = total // count
        for i in range(count):
            self.gpu_devices[i] = GPUDevice(i, per_card)

    def devices_idle_gpu_memory(self) -> Dict[int, int]:
        return {dev_id: dev.memory - dev.used_memory()
                for dev_id, dev in self.gpu_devices.items()}

    def add_gpu_resource(self, pod) -> None:
        # empty-dict check first: most nodes have no shared GPUs, and this
        # runs once per task on the replay/bind hot path
        if not self.gpu_devices or gpu_resource_of_pod(pod) <= 0:
            return
        dev = self.gpu_devices.get(get_gpu_index(pod))
        if dev is not None:
            dev.pod_map[pod.uid] = pod

    def sub_gpu_resource(self, pod) -> None:
        if not self.gpu_devices or gpu_resource_of_pod(pod) <= 0:
            return
        dev = self.gpu_devices.get(get_gpu_index(pod))
        if dev is not None:
            dev.pod_map.pop(pod.uid, None)

    # -- task accounting ----------------------------------------------------

    def _allocate_idle(self, ti: TaskInfo) -> None:
        # sub() itself asserts less_equal; wrapping avoids paying the
        # check twice on the hot path
        try:
            self.idle.sub(ti.resreq)
        except ValueError:
            raise ValueError("selected node NotReady")

    def add_task(self, task: TaskInfo) -> None:
        """Status-dependent accounting (node_info.go:224-266). The node keeps
        a clone so later task status flips don't corrupt node counters."""
        if task.node_name and self.name and task.node_name != self.name:
            raise ValueError(
                f"task <{task.key}> already on different node <{task.node_name}>")
        if task.key in self.tasks:
            raise ValueError(f"task <{task.key}> already on node <{self.name}>")
        self.flat_version = next_flat_version()
        ti = task.clone()
        if self.node is not None:
            if ti.status == TaskStatus.RELEASING:
                self._allocate_idle(ti)
                self.releasing.add(ti.resreq)
                self.used.add(ti.resreq)
            elif ti.status == TaskStatus.PIPELINED:
                self.pipelined.add(ti.resreq)
            else:
                self._allocate_idle(ti)
                self.used.add(ti.resreq)
        task.node_name = self.name
        ti.node_name = self.name
        self.tasks[ti.key] = ti
        self.add_gpu_resource(ti.pod)

    def add_tasks_bulk(self, tasks, validated: bool = False) -> None:
        """add_task over a wave with one summed accounting update. Only
        allocated-status tasks qualify (the replay/bind path: ALLOCATED or
        BINDING waves); anything else — or any per-task validation failure,
        or a wave that doesn't fit idle as a whole — falls back to the
        per-task loop so partial-application + raise semantics stay exactly
        add_task's. ``validated=True`` asserts the caller already ran these
        exact checks (Statement.allocate_bulk / SchedulerCache.bind_batch
        validate per node group before any mutation) so they aren't paid
        twice per task on the replay hot path."""
        fast = self.node is not None
        if fast and not validated:
            seen = set()
            for t in tasks:
                if (t.node_name and self.name and t.node_name != self.name) \
                        or t.key in self.tasks or t.key in seen \
                        or t.status in (TaskStatus.RELEASING,
                                        TaskStatus.PIPELINED):
                    fast = False
                    break
                seen.add(t.key)
            if fast and not Resource.sum_of(
                    t.resreq for t in tasks).less_equal(self.idle):
                fast = False
        if not fast:
            for t in tasks:
                self.add_task(t)
            return
        self.flat_version = next_flat_version()
        # fit was checked wave-wide (the same tolerant less_equal sub()
        # asserts); apply the deltas without paying per-dimension checks
        # again
        idle = self.idle
        used = self.used
        name = self.name
        node_tasks = self.tasks
        for task in tasks:
            rr = task.resreq
            idle.milli_cpu -= rr.milli_cpu
            idle.memory -= rr.memory
            used.milli_cpu += rr.milli_cpu
            used.memory += rr.memory
            if rr.scalars:
                isc = idle.scalars
                usc = used.scalars
                for k, v in rr.scalars.items():
                    isc[k] = isc.get(k, 0.0) - v
                    usc[k] = usc.get(k, 0.0) + v
            ti = task.clone()
            task.node_name = name
            ti.node_name = name
            node_tasks[ti.key] = ti
            self.add_gpu_resource(ti.pod)

    def remove_task(self, ti: TaskInfo) -> None:
        task = self.tasks.get(ti.key)
        if task is None:
            raise KeyError(f"failed to find task <{ti.key}> on host <{self.name}>")
        self.flat_version = next_flat_version()
        if self.node is not None:
            if task.status == TaskStatus.RELEASING:
                self.releasing.sub(task.resreq)
                self.idle.add(task.resreq)
                self.used.sub(task.resreq)
            elif task.status == TaskStatus.PIPELINED:
                self.pipelined.sub(task.resreq)
            else:
                self.idle.add(task.resreq)
                self.used.sub(task.resreq)
        del self.tasks[task.key]
        self.sub_gpu_resource(task.pod)

    def update_task(self, ti: TaskInfo) -> None:
        self.remove_task(ti)
        self.add_task(ti)

    def clone(self) -> "NodeInfo":
        n = NodeInfo()
        n.name = self.name
        n.node = self.node
        n.state = NodeState(self.state.phase, self.state.reason)
        n.releasing = self.releasing.clone()
        n.pipelined = self.pipelined.clone()
        n.idle = self.idle.clone()
        n.used = self.used.clone()
        n.allocatable = self.allocatable.clone()
        n.capability = self.capability.clone()
        n.others = dict(self.others)
        n.gpu_devices = {i: d.clone() for i, d in self.gpu_devices.items()}
        # node-held TaskInfo entries are replace-only: add_task stores a
        # private clone and every later change goes through
        # remove_task/update_task (object replacement), never in-place
        # mutation — so clones share the entries. This halves the snapshot
        # clone fan-out, the scheduler's per-cycle host floor.
        n.tasks = dict(self.tasks)
        n.flat_version = self.flat_version
        n.spec_version = self.spec_version
        n.flat_epoch = self.flat_epoch
        return n

    def pods(self):
        return [t.pod for t in self.tasks.values()]

    def __repr__(self) -> str:
        return f"Node({self.name} idle={self.idle} used={self.used})"
