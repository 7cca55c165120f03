"""Unschedulability bookkeeping (reference api/unschedule_info.go:20-103)."""

from __future__ import annotations

from typing import Dict, List

ALL_NODES_UNAVAILABLE = "all nodes are unavailable"

# Canonical fit-failure reasons (mirrors k8s / reference message strings)
NODE_RESOURCE_FIT_FAILED = "Insufficient resources"
NODE_UNSCHEDULABLE = "node(s) were unschedulable"
NODE_AFFINITY_FAILED = "node(s) didn't match node selector"
TAINT_FAILED = "node(s) had taints that the pod didn't tolerate"
POD_AFFINITY_FAILED = "node(s) didn't match pod affinity/anti-affinity"
NODE_PORTS_FAILED = "node(s) didn't have free ports for the requested pod ports"
GPU_SHARING_FAILED = "no enough gpu memory on single device"
POD_COUNT_FAILED = "node(s) had too many pods"
VOLUME_BINDING_FAILED = "node(s) didn't match the pod's volume node affinity"
PVC_NOT_FOUND = "persistentvolumeclaim not found"


class FitError:
    """Why one task doesn't fit one node."""

    __slots__ = ("task_namespace", "task_name", "node_name", "reasons")

    def __init__(self, task, node_name: str, reasons: List[str]):
        self.task_namespace = task.namespace
        self.task_name = task.name
        self.node_name = node_name
        self.reasons = list(reasons)

    def error(self) -> str:
        return f"task {self.task_namespace}/{self.task_name} on node {self.node_name} fit failed: {', '.join(self.reasons)}"

    __str__ = error


def aggregate_fit_errors(fit_errors_by_task: Dict[str, "FitErrors"],
                         total_tasks: int) -> str:
    """Aggregate a job's per-task FitErrors into the stable, deduplicated
    summary the reference posts as the PodGroup event message:
    ``"x/y tasks unschedulable: reason (count), ..."``.

    Each task contributes every DISTINCT reason once (a task failing the
    same predicate on 500 nodes counts one, not 500), counts are the
    number of tasks citing the reason, and the ordering is count-desc
    then alphabetical — byte-stable across runs, so the sim recorder can
    put it in golden traces and ``vcctl sim`` can print it verbatim."""
    hist: Dict[str, int] = {}
    for fe in fit_errors_by_task.values():
        if fe.err:
            reasons = {fe.err}
        elif fe.nodes:
            reasons = {r for node_fe in fe.nodes.values()
                       for r in node_fe.reasons}
        else:
            reasons = {ALL_NODES_UNAVAILABLE}
        for r in reasons:
            hist[r] = hist.get(r, 0) + 1
    parts = [f"{r} ({c})"
             for r, c in sorted(hist.items(), key=lambda kv: (-kv[1], kv[0]))]
    return (f"{len(fit_errors_by_task)}/{total_tasks} tasks unschedulable: "
            f"{', '.join(parts)}")


class FitErrors:
    """Per-task collection of per-node fit errors, histogrammed for the
    PodGroup condition message."""

    def __init__(self):
        self.nodes: Dict[str, FitError] = {}
        self.err: str = ""

    def set_node_error(self, node_name: str, fe: FitError) -> None:
        self.nodes[node_name] = fe

    def set_error(self, err: str) -> None:
        self.err = err

    def error(self) -> str:
        if self.err:
            return self.err
        if not self.nodes:
            return ALL_NODES_UNAVAILABLE
        hist: Dict[str, int] = {}
        for fe in self.nodes.values():
            for r in fe.reasons:
                hist[r] = hist.get(r, 0) + 1
        parts = sorted(f"{c} {r}" for r, c in hist.items())
        return f"0/{len(self.nodes)} nodes are available: {', '.join(parts)}."

    __str__ = error
