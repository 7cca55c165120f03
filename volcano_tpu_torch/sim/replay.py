"""Golden-trace record / verify with structured first-divergence diffs.

Record mode runs a sim and writes the canonical decision trace; verify
mode re-runs with the same seed + config and compares byte for byte. On
mismatch it reports the FIRST diverging cycle with a per-field diff
(lists get golden_only/actual_only sets) so a refactor that changed a
scheduling decision is pinpointed to the cycle and the decision kind,
not just "traces differ".
"""

from __future__ import annotations

import json
from typing import List, NamedTuple, Optional

from ..metrics import metrics
from . import score as score_mod
from .virtualcluster import VirtualCluster
from .workload import Workload, WorkloadSpec


class SimResult(NamedTuple):
    lines: List[str]     # canonical trace lines (no newline)
    digest: str          # sha256 over the trace
    score: dict          # quality report (score.compute)
    stats: dict          # raw VirtualCluster stats
    vc: VirtualCluster   # the finished cluster (inspection/tests)


def run_sim(spec: Optional[WorkloadSpec] = None, cycles: int = 100,
            mode: str = "solver", drain: int = 0,
            workload: Optional[Workload] = None,
            scheduler_conf: Optional[str] = None, preempt: bool = False,
            record_path: Optional[str] = None,
            solver_mode: Optional[str] = None,
            sharded_byte_budget: int = 0,
            reschedule: Optional[dict] = None,
            device=None) -> SimResult:
    """One full sim run. ``workload`` overrides ``spec`` (external
    traces); ``drain`` allows extra cycles for in-flight jobs to finish
    so makespan/conservation are meaningful; ``reschedule`` (a dict of
    interval / max_moves / max_disruption_per_job / min_improvement)
    enables the global rescheduler action. ``device`` places the
    scheduler's arena: the CUDA device unless ``"cpu"`` is passed."""
    wl = workload if workload is not None \
        else Workload(spec or WorkloadSpec())
    vc = VirtualCluster(wl, mode=mode, scheduler_conf=scheduler_conf,
                        preempt=preempt, solver_mode=solver_mode,
                        sharded_byte_budget=sharded_byte_budget,
                        reschedule=reschedule, device=device)
    lines = vc.run(cycles, drain=drain)
    sc = score_mod.compute(vc.stats, cycles=len(lines), dt=vc.dt)
    if record_path:
        with open(record_path, "w") as f:
            f.write("\n".join(lines) + "\n")
    return SimResult(lines=lines, digest=vc.recorder.digest(), score=sc,
                     stats=vc.stats, vc=vc)


def load_trace(path: str) -> List[str]:
    with open(path) as f:
        return [ln.rstrip("\n") for ln in f if ln.strip()]


def _diff_field(golden, actual):
    if isinstance(golden, list) and isinstance(actual, list):
        gset = {json.dumps(x, sort_keys=True) for x in golden}
        aset = {json.dumps(x, sort_keys=True) for x in actual}
        return {
            "golden_only": sorted(json.loads(x) for x in gset - aset),
            "actual_only": sorted(json.loads(x) for x in aset - gset),
        }
    return {"golden": golden, "actual": actual}


def first_divergence(golden: List[str],
                     actual: List[str]) -> Optional[dict]:
    """None when byte-identical; otherwise a structured report for the
    first diverging cycle."""
    for i, (g, a) in enumerate(zip(golden, actual)):
        if g == a:
            continue
        try:
            gobj, aobj = json.loads(g), json.loads(a)
        except ValueError:
            return {"cycle": i, "fields": {
                "__raw__": {"golden": g, "actual": a}}}
        fields = {}
        for key in sorted(set(gobj) | set(aobj)):
            if gobj.get(key) != aobj.get(key):
                fields[key] = _diff_field(gobj.get(key), aobj.get(key))
        return {"cycle": gobj.get("cycle", i), "fields": fields}
    if len(golden) != len(actual):
        return {"cycle": min(len(golden), len(actual)),
                "fields": {"__length__": {"golden": len(golden),
                                          "actual": len(actual)}}}
    return None


def verify(golden, **run_kwargs) -> dict:
    """Re-run with the given config and compare against a golden trace
    (path or list of lines); ``run_kwargs`` go to run_sim, ``device``
    among them. Returns {"ok", "divergence", "cycles", "digest"}."""
    golden_lines = load_trace(golden) if isinstance(golden, str) \
        else list(golden)
    result = run_sim(**run_kwargs)
    div = first_divergence(golden_lines, result.lines)
    if div is not None:
        metrics.sim_replay_divergences_total.inc()
    return {"ok": div is None, "divergence": div,
            "cycles": len(result.lines), "digest": result.digest}
