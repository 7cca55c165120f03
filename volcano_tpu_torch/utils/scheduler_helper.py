"""Scheduler helpers (reference util/scheduler_helper.go).

The predicate/score fan-out helpers of the reference became device kernels
(ops); what remains host-side is victim validation and the
global resource-reservation state shared by elect/reserve/allocate/enqueue.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..api import NodeInfo, TaskInfo


class ResourceReservation:
    """Global reservation state (scheduler_helper.go:252-262)."""

    def __init__(self):
        self.target_job = None
        self.locked_nodes: Dict[str, NodeInfo] = {}

    def reset(self) -> None:
        self.target_job = None
        self.locked_nodes = {}


#: module-level singleton, like the reference's util.Reservation
reservation = ResourceReservation()


#: adaptive feasible-node sampling floors (scheduler_helper.go:50-69 +
#: cmd/scheduler/app/options/options.go:37-40)
MIN_FEASIBLE_NODES_TO_FIND = 100
MIN_PERCENTAGE_OF_NODES_TO_FIND = 5


class NodeSampler:
    """Adaptive feasible-node sampling for the HOST predicate scan
    (scheduler_helper.go:50-128). The device kernel always scores the full
    padded matrix, so this only bounds host-loop work on
    large clusters — kept for config parity with the reference. Instance
    state: each scheduler owns its own rotation cursor."""

    def __init__(self, percentage: int = 100):
        self.percentage = max(0, min(int(percentage), 100))
        self.start = 0

    def feasible_nodes_to_find(self, num_nodes: int) -> int:
        """How many feasible nodes a scan needs before it can stop early;
        clamped UP to the reference's floors."""
        if num_nodes <= MIN_FEASIBLE_NODES_TO_FIND \
                or self.percentage >= 100:
            return num_nodes
        pct = max(self.percentage, MIN_PERCENTAGE_OF_NODES_TO_FIND)
        return max(num_nodes * pct // 100, MIN_FEASIBLE_NODES_TO_FIND)

    def plan(self, nodes: List[NodeInfo]):
        """(rotated node list, stop-early count) for one task's scan."""
        n = len(nodes)
        want = self.feasible_nodes_to_find(n)
        if want >= n:
            return nodes, n
        start = self.start % n
        return nodes[start:] + nodes[:start], want

    def advance(self, visited: int, num_nodes: int) -> None:
        """Move the cursor past every node the scan actually visited
        (nextStartNodeIndex: the next scan starts where this one stopped,
        so an infeasible prefix isn't rescanned per task)."""
        if num_nodes:
            self.start = (self.start + visited) % num_nodes


def validate_victims(preemptor: TaskInfo, node: NodeInfo,
                     victims: List[TaskInfo]) -> Optional[str]:
    """Future idle plus victims' resources must fit the preemptor
    (scheduler_helper.go:234-250). Returns an error string or None."""
    if not victims:
        return "no victims"
    future_idle = node.future_idle()
    for victim in victims:
        future_idle.add(victim.resreq)
    if not preemptor.init_resreq.less_equal(future_idle):
        return (f"not enough resources: requested <{preemptor.init_resreq}>, "
                f"but future idle <{future_idle}>")
    return None
