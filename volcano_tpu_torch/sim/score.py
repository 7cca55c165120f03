"""Scheduling-quality scoring over a finished sim run.

Pure functions over the virtual cluster's stats — everything derives
from virtual time, so the score is as reproducible as the trace. The
metrics are the ones the cluster-trace literature regresses:

- job wait (arrival -> gang ready, i.e. min_member-th bind): mean/p50/p99;
- makespan (first arrival -> last completion, when the run drained);
- node utilization (mean fraction of allocatable CPU in use per cycle);
- Jain fairness index across queues over weight-normalized service
  (cpu-time integrated over the run): 1.0 = perfectly weighted-fair;
- preemption churn (non-migration evictions per successful bind) and
  failure/replace counts;
- fragmentation: the per-cycle stranded-free-capacity fraction (free
  CPU sitting on nodes too full to fit the workload's largest task
  shape; reschedule/plan.py stranded_fraction) averaged over the run,
  the mean largest-free-slot fraction, and migration churn (rescheduler
  evictions per successful bind) — the series the reschedule action's
  defrag gain is judged on.
"""

from __future__ import annotations

from typing import Optional


def _percentile(values, q: float) -> float:
    """Deterministic linear-interpolation percentile (numpy-free so the
    score path can run anywhere the recorder does)."""
    if not values:
        return 0.0
    vs = sorted(values)
    if len(vs) == 1:
        return float(vs[0])
    pos = (len(vs) - 1) * q
    lo = int(pos)
    hi = min(lo + 1, len(vs) - 1)
    frac = pos - lo
    return float(vs[lo] * (1 - frac) + vs[hi] * frac)


def jain_fairness(shares) -> float:
    """(sum x)^2 / (n * sum x^2); 1.0 for equal shares (and for the
    degenerate empty/all-zero case)."""
    xs = [float(x) for x in shares]
    n = len(xs)
    sq = sum(x * x for x in xs)
    if n == 0 or sq <= 0:
        return 1.0
    s = sum(xs)
    return (s * s) / (n * sq)


def compute(stats: dict, cycles: int, dt: float = 1.0) -> dict:
    """Quality report over a VirtualCluster.stats dict (see
    virtualcluster.py for the field inventory)."""
    arrive = stats["arrive_time"]
    ready = stats["ready_time"]
    complete = stats["complete_time"]
    waits = [ready[j] - arrive[j] for j in ready if j in arrive]
    unserved = [j for j in arrive if j not in ready]

    makespan: Optional[float] = None
    if arrive and complete and len(complete) == len(arrive):
        makespan = max(complete.values()) - min(arrive.values())

    util = stats["util_samples"]
    mean_util = sum(util) / len(util) if util else 0.0

    weights = stats.get("queue_weight", {})
    service = stats.get("queue_service", {})
    norm_shares = [service.get(q, 0.0) / max(float(w), 1e-9)
                   for q, w in sorted(weights.items())]
    jfi = jain_fairness(norm_shares)

    binds = stats["binds"]
    migrations = stats.get("migrations", 0)
    # preemption churn counts preempt/reclaim victims only; the
    # rescheduler's deliberate migrations get their own column
    churn = (stats["evictions"] - migrations) / binds if binds else 0.0

    frag = stats.get("frag_samples") or []
    largest = stats.get("largest_free_samples") or []

    r = {
        "jobs_arrived": len(arrive),
        "jobs_served": len(ready),
        "jobs_completed": len(complete),
        "jobs_unserved": len(unserved),
        "pods_bound": binds,
        "wait_mean": round(sum(waits) / len(waits), 6) if waits else 0.0,
        "wait_p50": round(_percentile(waits, 0.50), 6),
        "wait_p99": round(_percentile(waits, 0.99), 6),
        "makespan": round(makespan, 6) if makespan is not None else None,
        "utilization_mean": round(mean_util, 6),
        "jfi_queues": round(jfi, 6),
        "preemption_churn": round(churn, 6),
        "fragmentation_index": round(sum(frag) / len(frag), 6)
        if frag else 0.0,
        "largest_free_slot_mean": round(sum(largest) / len(largest), 6)
        if largest else 0.0,
        "migrations": migrations,
        "migration_churn": round(migrations / binds, 6) if binds else 0.0,
        "evictions": stats["evictions"],
        "evictions_finalized": stats["evictions_finalized"],
        "failures": stats["failures"],
        "cycles": cycles,
        "virtual_seconds": round(cycles * dt, 6),
    }
    return r
