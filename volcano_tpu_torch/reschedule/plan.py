"""Migration planning: diff a device-solved defrag placement against the
incumbent one and bound the result into an executable plan.

Pure host-side code — no tensors, no session — so every bounding rule
(move budget, PDB-style per-job disruption caps, target feasibility,
no-op rejection) is unit-testable in isolation. The action
(reschedule/action.py) feeds it the solver's assignment and executes
whatever survives.

Selection policy — **hole punching**. Fragmentation hurts exactly when
the cluster's total free capacity would fit the workload's largest
request shape (``ref_cpu``) but no single node does: the big job queues
while free CPU sits stranded as dust. The durable fix is to concentrate
free capacity on ONE node until that shape fits:

1. reject outright when the shape already fits somewhere (``fits``) —
   rescheduling exists to un-do bad history, not to shuffle a healthy
   cluster;
2. otherwise, at the hole site (pinned by the action, which haircuts
   that node's shadow capacity so the device solve itself decides which
   tasks overflow elsewhere — or, unpinned, every node with outbound
   candidates), take candidates smallest-request-first (biggest-first
   as the fallback when budget/caps leave the small movers short) until
   the node's projected free reaches ``ref_cpu``. Each move is charged
   against the budget and its job's disruption cap, and must have a
   LANDING SITE:
   a non-hole node whose projected free (current free + capacity freed
   by already-selected moves) fits the displaced request — the same
   fullest-that-fits choice the allocate pack scoring will make for the
   replacement pod, so a selected move cannot boomerang back into the
   hole it is punching;
3. keep the cheapest achievable hole (fewest moves, then smallest
   deficit) and reject the plan whole when none is achievable
   (``no_hole``) or when the projected stranded-fraction improvement
   falls below ``min_improvement`` (``no_gain``).

One hole per plan: the interval re-runs the solve against fresh state,
so sustained pressure punches holes one bounded, observable plan at a
time instead of thrashing the cluster toward a global optimum that has
churned away by the time the moves land.

Only evictions execute — each displaced pod's replacement re-enters the
normal allocate solve, whose pack-scoring avoids the (now emptiest)
hole node, so the hole survives precisely because the scorer that
caused the fragmentation now defends it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence

#: eviction reason prefix: churn accounting and the decision trace
#: distinguish defrag migrations from preempt/reclaim victims by it
MIGRATION_REASON = "reschedule"


def stranded_fraction(free: Iterable[float], ref: float) -> float:
    """Fraction of free capacity stranded in slots too small to fit a
    reference request ``ref`` (the workload's largest task shape). 0.0 =
    every free slot is usable (or nothing is free); 1.0 = all free
    capacity is dust."""
    total = stranded = 0.0
    for f in free:
        total += f
        if f < ref:
            stranded += f
    if total <= 0.0 or ref <= 0.0:
        return 0.0
    return stranded / total


def largest_free_slot(free: Iterable[float]) -> float:
    vals = list(free)
    return max(vals) if vals else 0.0


@dataclass
class MoveCandidate:
    """One task the solved placement wants somewhere else."""

    key: str           # namespace/name
    namespace: str
    name: str
    job_uid: str
    from_node: str
    to_node: str
    cpu: float         # milli-cpu accounting request
    mem: float         # bytes


@dataclass
class MigrationPlan:
    """The bounded, feasibility-checked output of build_plan."""

    moves: List[MoveCandidate] = field(default_factory=list)
    proposed: int = 0          # raw diff size (solved != incumbent)
    capped: int = 0            # candidates cut by budget/caps/feasibility
    hole_node: str = ""        # the node the plan concentrates free on
    frag_before: float = 0.0
    frag_after: float = 0.0    # projected, over the selected moves only
    largest_before: float = 0.0
    largest_after: float = 0.0
    max_disruption: int = 0    # max moves charged to any single job
    rejected: Optional[str] = None  # None = executable

    @property
    def improvement(self) -> float:
        return self.frag_before - self.frag_after

    def summary(self) -> dict:
        return {
            "proposed": self.proposed,
            "selected": len(self.moves),
            "capped": self.capped,
            "hole_node": self.hole_node,
            "frag_before": round(self.frag_before, 6),
            "frag_after": round(self.frag_after, 6),
            "largest_before": self.largest_before,
            "largest_after": self.largest_after,
            "max_disruption": self.max_disruption,
            "rejected": self.rejected,
        }


def _account_target(trial: Dict[str, List[float]], hole: str,
                    cand: MoveCandidate) -> Optional[str]:
    """Where the displaced task can actually land: the fullest non-hole
    node whose projected free fits it — the same pack-scoring choice the
    allocate action will make for the replacement pod. The solver's
    ``to_node`` stays on the candidate as the advisory target (it came
    from a global repack whose OTHER shuffles this plan does not
    execute), but the budget accounting must be self-consistent against
    the projected free vector."""
    best = None
    for n in sorted(trial):
        if n == hole or n == cand.from_node:
            continue
        f = trial[n]
        if f[0] >= cand.cpu and f[1] >= cand.mem \
                and (best is None or f[0] < trial[best][0]):
            best = n
    return best


def build_plan(candidates: Sequence[MoveCandidate],
               free_cpu_mem: Dict[str, Sequence[float]],
               *,
               max_moves: int,
               max_disruption_per_job: int,
               min_improvement: float,
               ref_cpu: float,
               hole: Optional[str] = None) -> MigrationPlan:
    """Bound the raw placement diff into an executable hole-punch plan.

    ``free_cpu_mem``: node -> (free milli-cpu, free mem bytes) NOW;
    ``ref_cpu`` is the reference slot size the hole must reach — the
    largest request shape currently running or waiting, i.e. what defrag
    is trying to make room for. ``hole`` pins the hole site (the action
    chooses it before the solve so the solver's haircut and the plan
    agree); when None every candidate source node is tried and the
    cheapest achievable hole wins.
    """
    plan = MigrationPlan(proposed=len(candidates))
    free = {n: [float(v[0]), float(v[1])]
            for n, v in free_cpu_mem.items()}
    plan.frag_before = stranded_fraction(
        (v[0] for v in free.values()), ref_cpu)
    plan.largest_before = largest_free_slot(v[0] for v in free.values())
    plan.frag_after = plan.frag_before
    plan.largest_after = plan.largest_before

    def _reject(reason: str) -> MigrationPlan:
        plan.rejected = reason
        plan.capped = len(candidates)
        plan.moves = []
        plan.max_disruption = 0
        return plan

    if not candidates:
        return _reject("empty")
    if max_moves <= 0:
        return _reject("budget")
    if ref_cpu <= 0.0:
        return _reject("empty")
    if plan.largest_before >= ref_cpu:
        # the reference shape already fits somewhere: a healthy cluster,
        # nothing for defrag to un-do
        return _reject("fits")

    by_source: Dict[str, List[MoveCandidate]] = {}
    for c in candidates:
        by_source.setdefault(c.from_node, []).append(c)
    # smallest request first: more moves per hole, but each displaced
    # task re-places easily in a fragmented cluster (a small replacement
    # fits almost anywhere; a large one competes with the very shape the
    # hole is for), so the tail cost of a migration stays bounded.
    # biggest-first is the fallback when the budget or the caps leave
    # the small movers short of the deficit.
    ORDERS = (lambda c: (c.cpu, c.key), lambda c: (-c.cpu, c.key))

    # simulate punching the hole at the pinned site (or every candidate
    # node); keep the cheapest achievable one (fewest moves, then
    # smallest deficit)
    sites = [hole] if hole is not None else sorted(by_source)
    best = None
    for site in sites:
        if site not in free or site not in by_source:
            continue
        deficit = ref_cpu - free[site][0]
        if deficit <= 0:
            continue
        for order in ORDERS:
            trial = {n: list(v) for n, v in free.items()}
            jobs: Dict[str, int] = {}
            moves: List[MoveCandidate] = []
            for c in sorted(by_source[site], key=order):
                if trial[site][0] >= ref_cpu or len(moves) >= max_moves:
                    break
                if jobs.get(c.job_uid, 0) >= max_disruption_per_job:
                    continue
                target = _account_target(trial, site, c)
                if target is None:
                    continue  # the displaced task would boomerang back
                trial[c.from_node][0] += c.cpu
                trial[c.from_node][1] += c.mem
                trial[target][0] -= c.cpu
                trial[target][1] -= c.mem
                jobs[c.job_uid] = jobs.get(c.job_uid, 0) + 1
                moves.append(c)
            if trial[site][0] < ref_cpu or not moves:
                continue
            key = (len(moves), deficit, site)
            if best is None or key < best[0]:
                best = (key, site, moves, trial, jobs)
            break  # this site achieved; don't try the fallback order

    if best is None:
        return _reject("no_hole")
    _, hole, moves, trial, jobs = best
    plan.moves = moves
    plan.capped = len(candidates) - len(moves)
    plan.hole_node = hole
    plan.max_disruption = max(jobs.values()) if jobs else 0
    plan.frag_after = stranded_fraction(
        (v[0] for v in trial.values()), ref_cpu)
    plan.largest_after = largest_free_slot(v[0] for v in trial.values())
    if plan.improvement < min_improvement:
        # no-op churn guard: the projected stranded-fraction gain does
        # not pay for the disruption
        return _reject("no_gain")
    return plan
