"""Solver-mode machinery shared by preempt and reclaim: collect claimer
jobs and victims, flatten them, run ops.solve_evict on device, and replay
the result through the session's Statement/evict/pipeline boundary.

Mirrors the host loops' semantics (actions/preempt/preempt.go:41-262,
actions/reclaim/reclaim.go:40-192) with the documented frozen-order
deviations listed in ops/evict.py.

The solve runs where the session's cache keeps its arena
(``SchedulerCache.device``). A failed solve or an open breaker hands the
cycle to the actions' host loops only for a CPU arena; on a CUDA arena it
raises, and the action's error is the cycle's record of it.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Tuple

import numpy as np

from ..api import TaskStatus
from ..models import PodGroupPhase
from ..utils import PriorityQueue

log = logging.getLogger(__name__)


def collect_claimer_jobs(ssn, require_not_pipelined: bool,
                         skip_overused: bool,
                         skip_jobs=()) -> List[Tuple[object, List]]:
    """(job, pending_tasks) pairs in queue -> job -> task order.

    require_not_pipelined: preempt only feeds jobs that are not yet
    JobPipelined (preempt.go:84-90); reclaim takes any starving job.
    skip_overused: reclaim skips overused queues (reclaim.go:57-58).
    skip_jobs: claimer uids routed through the host loop instead
    (host-only jobs — GPU sharing / affinity / PVC).
    """
    queues_pq = PriorityQueue(ssn.queue_order_fn)
    per_queue: Dict[str, PriorityQueue] = {}
    for job in ssn.jobs.values():
        if job.uid in skip_jobs:
            continue
        if job.pod_group.status.phase == PodGroupPhase.PENDING:
            continue
        vr = ssn.job_valid(job)
        if vr is not None and not vr.passed:
            continue
        queue = ssn.queues.get(job.queue)
        if queue is None:
            continue
        pending = job.task_status_index.get(TaskStatus.PENDING, {})
        if not any(not t.resreq.is_empty() for t in pending.values()):
            continue
        if require_not_pipelined and ssn.job_pipelined(job):
            continue
        if job.queue not in per_queue:
            per_queue[job.queue] = PriorityQueue(ssn.job_order_fn)
            queues_pq.push(queue)
        per_queue[job.queue].push(job)

    out = []
    while not queues_pq.empty():
        queue = queues_pq.pop()
        if skip_overused and ssn.overused(queue):
            continue
        jobs = per_queue.get(queue.name)
        oc = getattr(ssn, "order_cache", None)
        while jobs is not None and not jobs.empty():
            job = jobs.pop()
            # version-gated reuse of the OrderCache's sorted pending
            # list: same filter (non-best-effort Pending) and the same
            # total order (task_order_fn == the full task key), so a job
            # unchanged since allocate's last keyed cycle skips the
            # per-task push/pop sort here
            tasks = oc.pending_tasks(ssn, job) if oc is not None else None
            if tasks is None:
                tq = PriorityQueue(ssn.task_order_fn)
                for t in job.task_status_index.get(
                        TaskStatus.PENDING, {}).values():
                    if not t.resreq.is_empty():
                        tq.push(t)
                tasks = []
                while not tq.empty():
                    tasks.append(tq.pop())
            if tasks:
                out.append((job, tasks))
    return out


def collect_victims(ssn, nodes_list) -> List:
    """Running, non-best-effort tasks of known jobs, grouped by node in the
    node-index order of the flatten, cheapest-first within each node (the
    order the host loops pop their victim priority queue,
    preempt.go:219-228). Clones, like the host paths, so replay decisions
    never mutate session state early."""
    victims = []
    for ni in nodes_list:
        pq = PriorityQueue(lambda l, r: not ssn.task_order_fn(l, r))
        for t in ni.tasks.values():
            if t.status != TaskStatus.RUNNING or t.resreq.is_empty():
                continue
            if t.job not in ssn.jobs:
                continue
            pq.push(t.clone())
        while not pq.empty():
            victims.append(pq.pop())
    return victims


def build_victim_arrays(ssn, arr, victims, job_order, mode: str) -> Dict:
    """Victim device arrays + per-claimer-job eligibility masks.

    Eligibility = queue scoping (same queue & different job for preempt;
    other reclaimable queues for reclaim) intersected with the session's
    tiered Preemptable/Reclaimable verdicts, evaluated once per claimer job
    (the plugin fns read the claimer's job, not the individual task)."""
    from ..ops.arrays import bucket

    node_index = {n.name: i for i, n in enumerate(arr.nodes_list)}
    R = arr.R
    J = arr.job_min.shape[0]
    V = bucket(max(len(victims), 1))
    v_req = np.zeros((V, R), dtype=np.float32)
    v_node = np.zeros(V, dtype=np.int32)
    v_valid = np.zeros(V, dtype=bool)
    for i, t in enumerate(victims):
        v_req[i] = t.resreq.to_vector(arr.vocab)
        v_node[i] = node_index[t.node_name]
        v_valid[i] = True

    elig = np.zeros((J, V), dtype=bool)
    need = np.zeros(J, dtype=np.int32)
    for j, (job, tasks) in enumerate(job_order):
        if mode == "preempt":
            cands = [t for t in victims
                     if ssn.jobs[t.job].queue == job.queue
                     and t.job != job.uid]
            allowed = {v.uid for v in ssn.preemptable(tasks[0], cands)}
            # pipelines still needed for JobPipelined (job_info.go:373-377)
            need[j] = max(0, job.min_available
                          - (job.ready_task_num() + job.waiting_task_num()))
        else:
            cands = []
            for t in victims:
                vq = ssn.queues.get(ssn.jobs[t.job].queue)
                if (ssn.jobs[t.job].queue != job.queue
                        and vq is not None and vq.reclaimable):
                    cands.append(t)
            allowed = {v.uid for v in ssn.reclaimable(tasks[0], cands)}
            need[j] = len(tasks)  # uncapped (reclaim has no gang stop)
        for i, t in enumerate(victims):
            elig[j, i] = t.uid in allowed
    return {"v_req": v_req, "v_node": v_node, "v_valid": v_valid,
            "elig": elig, "job_need": need}


def _evictions_by_job(evicted_by: np.ndarray) -> Dict[int, List[int]]:
    """claimer job index -> victim indices in victim-sorted
    (cheapest-first) order."""
    out: Dict[int, List[int]] = {}
    for vi, ji in enumerate(evicted_by):
        if ji >= 0:
            out.setdefault(int(ji), []).append(vi)
    return out


def _uniform_job_arrays(arr, job_order):
    """(job_req, job_acct [J,R], job_count [J]) when every claimer job's
    pending tasks share one fit request, one accounting request, and one
    signature, else None (the per-job closed-form kernel requires
    uniformity)."""
    J = arr.job_min.shape[0]
    job_req = np.zeros((J, arr.R), dtype=np.float32)
    job_acct = np.zeros((J, arr.R), dtype=np.float32)
    job_count = np.zeros(J, dtype=np.int32)
    off = 0
    for j, (_job, tasks) in enumerate(job_order):
        k = len(tasks)
        fit = arr.task_init_req[off:off + k]
        acct = arr.task_req[off:off + k]
        sigs = arr.task_sig[off:off + k]
        if k > 1 and (not (fit == fit[0]).all()
                      or not (acct == acct[0]).all()
                      or not (sigs == sigs[0]).all()):
            return None
        job_req[j] = fit[0]
        job_acct[j] = acct[0]
        job_count[j] = k
        off += k
    return job_req, job_acct, job_count


def run_evict_solver(ssn, mode: str, skip_jobs=()):
    """Flatten claimers + victims, solve on the arena's device (or through
    the session's solver sidecar), replay.
    Returns the claimer jobs processed (the host loops' under_request set —
    preempt's intra-job phase must run on exactly these), [] when there was
    nothing to do, or None when the device path is unavailable (circuit
    breaker open, or the solve itself failed) on a CPU arena — the caller
    then degrades to its host loop for this cycle. On a CUDA arena (or a
    sidecar on a CUDA device) either failure raises instead: the solve has
    no host fallback there."""
    import time

    from ..ops import flatten_snapshot
    from ..ops.evict import (
        decode_evict_compact, solve_evict, solve_evict_uniform,
    )
    from ..resilience import faults
    from .allocate import _on_card, build_score_inputs, device_fault_reason

    timing = ssn.solver_options.setdefault("timing", {})
    breaker = getattr(ssn, "breaker", None)
    if breaker is not None and not breaker.allow():
        timing[f"{mode}_fault_reason"] = "breaker_open"
        if _on_card(ssn):
            raise RuntimeError(
                f"{mode}: the device path is circuit-broken after repeated "
                "device failures; a CUDA arena has no host fallback")
        breaker.count_fallback()
        return None  # circuit open: host loop covers this cycle
    preempt = mode == "preempt"
    job_order = collect_claimer_jobs(
        ssn, require_not_pipelined=preempt, skip_overused=not preempt,
        skip_jobs=skip_jobs)
    if not job_order:
        return []
    tasks_in_order = [t for _, tasks in job_order for t in tasks]
    arr = flatten_snapshot(
        {j.uid: j for j, _ in job_order}, ssn.nodes, tasks_in_order,
        queues=ssn.queues,
        cache=getattr(ssn, "evict_flatten_caches", {}).get(mode),
        grouped=job_order)
    victims = collect_victims(ssn, arr.nodes_list)
    if not victims:
        return [j for j, _ in job_order]
    varrays = build_victim_arrays(ssn, arr, victims, job_order, mode)
    params, families = build_score_inputs(ssn, arr)

    # the closed-form solve is preempt-only: reclaim's per-claimer victim
    # coverage rule is not a per-node divisibility (see solve_evict_uniform)
    uniform = _uniform_job_arrays(arr, job_order) if preempt else None
    if uniform is not None:
        (varrays["job_req"], varrays["job_acct"],
         varrays["job_count"]) = uniform
    vnp = {k: np.asarray(v) for k, v in varrays.items()}
    dev = getattr(ssn.cache, "device", None)
    sidecar = getattr(ssn, "sidecar", None)
    t0 = time.perf_counter()
    try:
        # breaker scope: a throwing evict dispatch/collect (or an injected
        # fault) counts one consecutive device failure
        faults.fire("evict_dispatch")
        if sidecar is not None:
            # process boundary: the eviction solve ships to the solver
            # sidecar too (job_req in the victim dict selects its fast
            # path)
            assigned, evicted_by = sidecar.solve_evict(
                arr.numpy_dict(), vnp, params, score_families=families,
                require_freed_covers=not preempt,
                allow_revert=preempt, stop_at_need=preempt)
        else:
            if uniform is not None:
                # gang fast path: one solve step per JOB
                # (solve_evict_uniform)
                res = solve_evict_uniform(
                    arr.numpy_dict(), vnp, params, score_families=families,
                    require_freed_covers=False, stop_at_need=True,
                    device=dev)
            else:
                res = solve_evict(
                    arr.numpy_dict(), vnp, params, score_families=families,
                    require_freed_covers=not preempt,
                    allow_revert=preempt, stop_at_need=preempt, device=dev)
            try:
                # one int16 readback carries both outputs
                assigned, evicted_by = decode_evict_compact(
                    res.compact, arr.task_init_req.shape[0])
            except ValueError:  # >32k nodes/jobs: indices overflow packing
                assigned = res.assigned.cpu().numpy()
                evicted_by = res.evicted_by.cpu().numpy()
    except Exception as e:
        timing[f"{mode}_fault_reason"] = device_fault_reason(e)
        if breaker is not None:
            breaker.record_failure()
        if _on_card(ssn):
            raise
        log.exception("%s device solve failed; degrading to the host "
                      "loop for this cycle", mode)
        return None
    timing[f"{mode}_solve_ms"] = (time.perf_counter() - t0) * 1e3
    timing[f"{mode}_uniform"] = float(uniform is not None)
    if breaker is not None:
        breaker.record_success()
    by_job = _evictions_by_job(evicted_by)

    from ..metrics import metrics
    idx = 0
    for j, (job, tasks) in enumerate(job_order):
        stmt = ssn.statement() if preempt else None
        evs = by_job.get(j, ())
        if evs:
            # post-solve validation: the solve froze plugin
            # verdicts at collection time, so several claimers can jointly
            # evict more of one victim job than per-placement re-evaluated
            # verdicts allow (share-bounded plugins like DRF). Re-ask the
            # session NOW — prior jobs' evictions are already applied. If
            # the live verdict retracts ANY planned victim, skip this
            # claimer's whole replay (evict nothing, pipeline nothing):
            # its placements were computed against capacity those victims
            # would have freed, so partially replaying would pipeline onto
            # capacity that never frees. The job retries next cycle with
            # fresh verdicts.
            live = [victims[vi] for vi in evs]
            verdict = (ssn.preemptable if preempt else ssn.reclaimable)(
                tasks[0], live)
            allowed_now = {v.uid for v in verdict}
            if any(victims[vi].uid not in allowed_now for vi in evs):
                log.info("%s: live plugin verdicts retracted victims for "
                         "%s; deferring the job to the next cycle",
                         mode, job.uid)
                idx += len(tasks)
                continue
        # the job's evictions land first (cheapest-first order), then its
        # claimers pipeline — one Statement per job like the host loop's
        # per-preemptor statements rolled up. Per-victim try: one failing
        # eviction must not skip the rest (the pipelines would otherwise
        # land on capacity that was never freed)
        for vi in evs:
            try:
                if preempt:
                    stmt.evict(victims[vi], "preempt")
                else:
                    ssn.evict(victims[vi], "reclaim")
            except (KeyError, ValueError):
                log.exception("%s eviction replay failed for %s",
                              mode, victims[vi].key)
        for task in tasks:
            t_idx = idx
            idx += 1
            node_idx = int(assigned[t_idx])
            if node_idx < 0:
                continue
            node_name = arr.nodes_list[node_idx].name
            try:
                if preempt:
                    stmt.pipeline(task, node_name)
                    metrics.preemption_attempts.inc()
                else:
                    ssn.pipeline(task, node_name)
            except (KeyError, ValueError):
                log.exception("%s replay failed for %s", mode, task.key)
        if preempt:
            metrics.preemption_victims.set(len(evs))
            if ssn.job_pipelined(job):
                stmt.commit()
            else:
                stmt.discard()
    return [j for j, _ in job_order]
