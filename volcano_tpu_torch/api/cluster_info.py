"""ClusterInfo: the per-session snapshot container (reference api/cluster_info.go)."""

from __future__ import annotations

from typing import Dict

from .job_info import JobInfo
from .node_info import NodeInfo
from .queue_info import NamespaceInfo, QueueInfo


class ClusterInfo:
    def __init__(self):
        self.jobs: Dict[str, JobInfo] = {}
        self.nodes: Dict[str, NodeInfo] = {}
        self.queues: Dict[str, QueueInfo] = {}
        self.namespace_info: Dict[str, NamespaceInfo] = {}

    def __repr__(self) -> str:
        return (f"ClusterInfo(jobs={len(self.jobs)} nodes={len(self.nodes)} "
                f"queues={len(self.queues)})")
