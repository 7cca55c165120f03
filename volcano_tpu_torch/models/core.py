"""Core-object shims: Pod and Node in the shape the scheduler consumes.

The reference schedules k8s v1.Pod/v1.Node objects delivered by informers.
The TPU build is cluster-agnostic: these dataclasses carry exactly the fields
the scheduler/controllers read, and the cache's event handlers accept them
from any transport (tests, gRPC sidecar, or a real k8s adapter).
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

_uid_counter = itertools.count(1)


def new_uid(prefix: str = "uid") -> str:
    return f"{prefix}-{next(_uid_counter)}"


@dataclass
class Pod:
    """The subset of v1.Pod the scheduler reads (spec+status flattened)."""

    name: str
    namespace: str = "default"
    uid: str = field(default_factory=lambda: new_uid("pod"))
    annotations: Dict[str, str] = field(default_factory=dict)
    labels: Dict[str, str] = field(default_factory=dict)
    # spec
    containers: List[Dict[str, Any]] = field(default_factory=list)  # [{'requests': {...}, 'ports': [..]}]
    init_containers: List[Dict[str, Any]] = field(default_factory=list)
    node_name: str = ""            # spec.nodeName (set on bind)
    node_selector: Dict[str, str] = field(default_factory=dict)
    volumes: List[Dict[str, Any]] = field(default_factory=list)  # [{'name':..., 'persistentVolumeClaim': {'claimName':...}}]
    affinity: Optional[Dict[str, Any]] = None
    tolerations: List[Dict[str, Any]] = field(default_factory=list)
    scheduler_name: str = "volcano"
    priority: Optional[int] = None
    priority_class_name: str = ""
    owner_references: List[Dict[str, Any]] = field(default_factory=list)
    # status
    phase: str = "Pending"
    conditions: List[Dict[str, Any]] = field(default_factory=list)
    deletion_timestamp: Optional[float] = None
    creation_timestamp: float = field(default_factory=time.time)
    # container terminate info used by the job controller (exit codes)
    container_statuses: List[Dict[str, Any]] = field(default_factory=list)
    resource_version: int = 0

    def ports(self) -> List[int]:
        out = []
        for c in self.containers:
            for p in c.get("ports", []):
                if p.get("hostPort"):
                    out.append(int(p["hostPort"]))
        return out


@dataclass
class Node:
    """The subset of v1.Node the scheduler reads."""

    name: str
    uid: str = field(default_factory=lambda: new_uid("node"))
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    allocatable: Dict[str, Any] = field(default_factory=dict)  # resource list
    capacity: Dict[str, Any] = field(default_factory=dict)
    taints: List[Dict[str, Any]] = field(default_factory=list)
    unschedulable: bool = False
    conditions: List[Dict[str, Any]] = field(
        default_factory=lambda: [{"type": "Ready", "status": "True"}])
    resource_version: int = 0


@dataclass
class PriorityClass:
    name: str
    value: int = 0
    global_default: bool = False


@dataclass
class ResourceQuota:
    name: str
    namespace: str = "default"
    annotations: Dict[str, str] = field(default_factory=dict)


@dataclass
class PersistentVolumeClaim:
    name: str
    namespace: str = "default"
    spec: Dict[str, Any] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    phase: str = "Pending"         # Pending until bound to a volume
    volume_name: str = ""
    resource_version: int = 0


@dataclass
class ConfigMap:
    name: str
    namespace: str = "default"
    data: Dict[str, str] = field(default_factory=dict)
    owner_references: List[Dict[str, Any]] = field(default_factory=list)


@dataclass
class Secret:
    name: str
    namespace: str = "default"
    data: Dict[str, bytes] = field(default_factory=dict)
    owner_references: List[Dict[str, Any]] = field(default_factory=list)


@dataclass
class Service:
    name: str
    namespace: str = "default"
    spec: Dict[str, Any] = field(default_factory=dict)
    owner_references: List[Dict[str, Any]] = field(default_factory=list)


@dataclass
class NetworkPolicy:
    name: str
    namespace: str = "default"
    spec: Dict[str, Any] = field(default_factory=dict)
    owner_references: List[Dict[str, Any]] = field(default_factory=list)


#: default lease duration (reference cmd/scheduler/app/server.go:50); the
#: single source of truth — utils.leader_election imports it
LEASE_DURATION = 15.0


@dataclass
class Lease:
    """coordination.k8s.io/v1 Lease subset (cluster-scoped here); the
    leader-election lock record (utils.leader_election). Lives with the
    models so the wire codec can carry it between HA processes."""

    name: str
    holder_identity: str = ""
    acquire_time: float = 0.0
    renew_time: float = 0.0
    lease_duration_seconds: float = LEASE_DURATION
    lease_transitions: int = 0
    resource_version: int = 0
    uid: str = field(default_factory=lambda: new_uid("lease"))
