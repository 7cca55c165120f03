"""Allocate action: the hot path (reference actions/allocate/allocate.go:43-266).

Two execution modes:

- solver (default): collect pending tasks in the session's
  namespace/queue/job/task order (host-side comparators), flatten the
  decision problem into padded arrays, solve it on the device through the
  resident arena (ops.device_cache.PackedDeviceCache.update +
  ops.solver.solve_allocate_packed2d), and
  replay the returned assignments through Statement/Pipeline — the
  ordering and transaction semantics stay in the control plane, the
  task x node math runs on device. In mode sharded (or under the
  Scheduler's solver_mode "sharded", or "auto" past its byte budget) the
  solve is the node-axis sharded one over the sharded arena
  (ops.device_cache.ShardedDeviceCache +
  parallel.solve_allocate_sharded_arena). With a solver sidecar on the
  cache (parallel.sidecar.SidecarSolver) the packed snapshot ships to
  the sidecar process that owns the card instead, and its assignments
  replay the same way.
- host: a faithful per-task loop (predicate -> prioritize -> best node ->
  allocate/pipeline) used when custom host-only plugins are present, for
  parity testing, and as the reference semantics oracle. It also finishes
  a session whose device path failed, but only for a CPU arena: on a CUDA
  arena, or a sidecar that solves on a CUDA device, the failure is the
  action's error.
"""

from __future__ import annotations

import logging
import sys
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np
import torch

from ..api import Resource, TaskStatus
from ..api.unschedule_info import (
    ALL_NODES_UNAVAILABLE, FitError, FitErrors, NODE_RESOURCE_FIT_FAILED,
)
from ..framework import Action
from ..metrics import tracing
from ..models import PodGroupPhase
from ..utils import PriorityQueue

log = logging.getLogger(__name__)

_UNRESOLVED = object()  # sentinel: _pending_tasks resolves the key itself


def _on_card(ssn, dc=None) -> bool:
    """True when the session's cache keeps its solver arena on a CUDA
    device, the arena ``dc`` is a sharded one with a CUDA shard, or the
    session's solver sidecar named a CUDA device. The host-oracle
    fallback is kept only for a CPU arena (or a sidecar on the CPU)."""
    dev = getattr(ssn.cache, "device", None)
    mesh = getattr(dc, "mesh", None)
    return getattr(dev, "type", None) == "cuda" or (
        mesh is not None and any(d.type == "cuda" for d in mesh.devices)
    ) or getattr(getattr(ssn, "sidecar", None), "on_card", False)


def device_fault_reason(exc) -> str:
    """The typed reason a failed device solve records
    (``<action>_fault_reason``): the sidecar's failures carry theirs
    (``parallel.sidecar``: sidecar_unavailable, sidecar_error,
    sidecar_device); anything else is a device_error."""
    return getattr(exc, "reason", "device_error")


def _task_order_key(ssn):
    """Full task-order key (pod creation-timestamp tiebreak) or None."""
    return ssn.full_order_key("task_order_fns",
                              ct_of=lambda t: t.pod.creation_timestamp)


def build_score_inputs(ssn, arr):
    """Resolve the session's plugin score weights against this flatten's
    vocab/shape: (params dict for ops.score_matrix, static families tuple)."""
    sp = ssn.score_params
    weights_fn = ssn.solver_options.get("binpack_vocab_weights")
    if weights_fn is not None:
        sp.binpack_res_weights = weights_fn(arr.vocab)
    rp = sp.resolved(arr.R, arr.N)
    params = {
        "binpack_weight": np.float32(rp.binpack_weight),
        "binpack_res_weights": rp.binpack_res_weights,
        "least_req_weight": np.float32(rp.least_req_weight),
        "most_req_weight": np.float32(rp.most_req_weight),
        "balanced_weight": np.float32(rp.balanced_weight),
        "node_static": rp.node_static,
    }
    families = []
    if rp.binpack_weight:
        families.append("binpack")
    if rp.least_req_weight or rp.most_req_weight or rp.balanced_weight:
        families.append("kube")
    if not families:
        families = ["kube"]
    return params, tuple(families)


class AllocateAction(Action):
    def name(self) -> str:
        return "allocate"

    # ------------------------------------------------------------------
    # shared: job/task ordering
    # ------------------------------------------------------------------

    def _ordered_jobs(self, ssn):
        """Yield schedulable jobs in namespace -> queue -> job order,
        skipping Pending-phase podgroups, invalid jobs, unknown queues and
        overused queues (allocate.go:61-160).

        When every active job-order plugin registered a key extractor the
        per-queue ordering is ONE sort by composite key instead of O(n log
        n) comparator dispatches — equivalent here because solver-mode
        collection happens before any session mutation, so the keys
        (shares, readiness) are frozen for its duration."""
        queue_factory = ssn.keyed_job_queue_factory() \
            or (lambda: PriorityQueue(ssn.job_order_fn))

        namespaces = PriorityQueue(ssn.namespace_order_fn)
        jobs_map: Dict[str, Dict[str, PriorityQueue]] = {}

        for job in ssn.jobs.values():
            # a job with no Pending tasks yields an empty task list and is
            # skipped by the caller anyway; filtering here keeps the
            # steady-state walk O(pending jobs), not O(all jobs) — at 1k
            # running jobs the full sort was most of the cycle's host time
            if TaskStatus.PENDING not in job.task_status_index:
                continue
            if job.pod_group.status.phase == PodGroupPhase.PENDING:
                continue
            vr = ssn.job_valid(job)
            if vr is not None and not vr.passed:
                continue
            if job.queue not in ssn.queues:
                continue
            ns = job.namespace
            if ns not in jobs_map:
                jobs_map[ns] = {}
                namespaces.push(ns)
            jobs_map[ns].setdefault(job.queue, queue_factory()).push(job)

        while not namespaces.empty():
            ns = namespaces.pop()
            queue_map = jobs_map[ns]
            queue = None
            for qname in list(queue_map):
                qi = ssn.queues[qname]
                if ssn.overused(qi):
                    del queue_map[qname]
                    continue
                if queue is None or ssn.queue_order_fn(qi, queue):
                    queue = qi
            if queue is None:
                continue
            jobs = queue_map.get(queue.name)
            if jobs is None or jobs.empty():
                # Exhausted queue: drop it and rescan the namespace. The
                # reference instead relies on live share updates to steer
                # the next pick away (allocate.go:160-166 allocates inline);
                # this pre-solve collection has no updates, so an order tie
                # would starve every other queue's jobs out of the flatten.
                queue_map.pop(queue.name, None)
                namespaces.push(ns)
                continue
            job = jobs.pop()
            yield job
            namespaces.push(ns)

    def _pending_tasks(self, ssn, job, taskkey=_UNRESOLVED) -> List:
        """Pending, non-best-effort tasks in task order
        (allocate.go:175-189). ``taskkey`` is the full task-order key
        (resolve once per action via ssn.full_order_key and pass it in for
        multi-job loops; None falls back to comparator sorting). Jobs
        unchanged since the OrderCache's last keyed cycle reuse their
        cached sorted list (version-gated; a mutated or dirty job misses
        and re-sorts here)."""
        oc = getattr(ssn, "order_cache", None)
        if oc is not None:
            cached = oc.pending_tasks(ssn, job)
            if cached is not None:
                return cached
        pending = [
            t for t in job.task_status_index.get(
                TaskStatus.PENDING, {}).values()
            if not t.resreq.is_empty()  # BestEffort tasks are backfill's
        ]
        if taskkey is _UNRESOLVED:
            taskkey = _task_order_key(ssn)
        if taskkey is not None:
            pending.sort(key=taskkey)
            return pending
        pq = PriorityQueue(ssn.task_order_fn)
        for task in pending:
            pq.push(task)
        out = []
        while not pq.empty():
            out.append(pq.pop())
        return out

    def _collect(self, ssn) -> List:
        """[(job, sorted pending tasks), ...] in session order: the
        event-sourced OrderCache when it can serve this conf (patching
        only event-dirty jobs — O(changes), not O(pending)), else the
        live comparator walk above. Both produce the identical sequence;
        the cache degrades itself with a typed reason on anything it
        cannot prove (ops.ordering)."""
        oc = getattr(ssn, "order_cache", None)
        if oc is not None:
            try:
                collected = oc.collect(ssn)
            except Exception:  # noqa: BLE001 — degrade, don't contain
                log.exception("order cache failed; dropping it and "
                              "collecting via the live comparator walk")
                oc.invalidate("order_cache_error")
                collected = None
            if collected is not None:
                return collected
        taskkey = _task_order_key(ssn)
        return [(job, self._pending_tasks(ssn, job, taskkey))
                for job in self._ordered_jobs(ssn)]

    # ------------------------------------------------------------------
    # solver mode
    # ------------------------------------------------------------------

    def _execute_solver(self, ssn, sequential: bool = False,
                        sharded: bool = False) -> None:
        import time as _time

        from ..ops import flatten_snapshot, solve_allocate

        from ..resilience import ActionContained, faults

        timing = ssn.solver_options.setdefault("timing", {})
        breaker = getattr(ssn, "breaker", None)
        # the phase keys are the durations of the spans (metrics.tracing);
        # flatten_ms covers order_ms
        with tracing.span("vc.flatten") as flattened:
            with tracing.span("vc.order") as ordered:
                host_only = ssn.solver_options.get("host_only_jobs") or ()
                job_order = []
                tasks_in_order = []
                # the ordering pass: event-sourced when the OrderCache can
                # serve this conf (O(changes since last cycle)), the live
                # comparator walk otherwise — surfaced per cycle as
                # order_{mode,ms,entries_patched,fallback_reason}
                collected = self._collect(ssn)
            timing["order_ms"] = ordered.ms
            oc = getattr(ssn, "order_cache", None)
            if oc is not None:
                timing["order_mode"] = oc.last_mode
                timing["order_entries_patched"] = \
                    float(oc.last_entries_patched)
                if oc.last_reason:
                    timing["order_fallback_reason"] = oc.last_reason
            # host-only jobs (GPU sharing, required pod affinity, PVCs) that
            # OUTRANK every device-path job run through the host loop BEFORE
            # the solve, so per-job routing cannot invert priority (a
            # top-priority GPU gang must not find its CPU eaten by
            # lower-priority solver placements). Host-only jobs ranked mid
            # -sequence still run after — an accepted coarsening of the
            # reference's fully sequential order, noted in the contract.
            pre_host, post_host = [], []
            for job, tasks in collected:
                if job.uid in host_only:
                    (post_host if job_order else pre_host).append(job.uid)
                    continue
                if tasks:
                    job_order.append((job, tasks))
                    tasks_in_order.extend(tasks)
            ssn.solver_options["_post_host_jobs"] = post_host
            if pre_host:
                self._execute_host(ssn, only_jobs=set(pre_host))
            if not tasks_in_order:
                return

            fc = getattr(ssn, "flatten_cache", None)
            if fc is not None and getattr(fc, "events_enabled", False) \
                    and getattr(ssn, "_mutation_ops", 0):
                # an earlier action in this cycle already mutated the session's
                # clones; those deltas never reached the event ledger, so the
                # event-sourced fast path must re-diff this cycle
                fc.suppress_event_path("session_mutations")
            t_fs = _time.perf_counter()
            arr = flatten_snapshot(
                {j.uid: j for j, _ in job_order}, ssn.nodes, tasks_in_order,
                queues=ssn.queues, cache=fc, grouped=job_order)
            fs_ms = (_time.perf_counter() - t_fs) * 1e3
            if fc is not None:
                # the event -> incremental -> cold ladder made observable:
                # which assembly path this cycle's flatten took, how many rows
                # it patched, and the patch-vs-full-pass latency split
                timing["flatten_mode"] = fc.last_flatten_mode
                timing["flatten_rows_patched"] = float(fc.last_rows_patched)
                timing["flatten_events_applied"] = \
                    float(fc.last_events_applied)
                if fc.last_flatten_mode == "event":
                    timing["flatten_patch_ms"] = fs_ms
                else:
                    timing["flatten_full_ms"] = fs_ms
                if fc.last_fallback_reason:
                    timing["flatten_fallback_reason"] = fc.last_fallback_reason

            # queue fairness: when proportion is active its session-open attrs
            # (allocated/request over ALL jobs, incl. running-only queues) feed
            # the in-kernel water-fill + per-round deserved caps
            queue_opts = ssn.solver_options.get("queue_opts")
            use_queue_cap = bool(queue_opts)
            work_conserving = bool(
                ssn.solver_options.get("work_conserving", True))
            if use_queue_cap:
                self._fill_queue_arrays(arr, queue_opts, ssn)

            # live DRF ordering on device (drf plugin active): the kernel
            # re-ranks jobs by dominant share every round. Job-order providers
            # dispatched BEFORE drf in the tiers (priority, gang) compose as a
            # static MAJOR rank (arr.job_drf_prerank) that live shares only
            # tie-break — the reference's comparator chain returns on the
            # first non-zero, so strict priorities dominate and equal
            # priorities fall through to drf, which the kernel now mirrors
            # instead of disabling the re-rank outright (a disabled re-rank
            # froze the snapshot order and could starve later-created jobs
            # under the default priority-before-drf conf). Falls back to the
            # static order only when a preceding provider registered no sort
            # key.
            drf_opts = ssn.solver_options.get("drf_order")
            use_drf_order = bool(drf_opts) and not sequential
            if use_drf_order:
                providers = [name for _, name, _
                             in ssn._tier_fns("job_order_fns")]
                if "drf" not in providers:
                    use_drf_order = False
                else:
                    pre = providers[:providers.index("drf")]
                    keyfns = [ssn.order_key_fns.get(
                        "job_order_fns", {}).get(p) for p in pre]
                    if any(kf is None for kf in keyfns):
                        use_drf_order = False
                    elif keyfns:
                        keys = [tuple(kf(job) for kf in keyfns)
                                for job in arr.jobs_list]
                        order = sorted(range(len(keys)), key=keys.__getitem__)
                        # dense rank; EQUAL key tuples share a rank so shares
                        # can tie-break across them
                        prev = None
                        rank_val = -1
                        for j in order:
                            if keys[j] != prev:
                                rank_val += 1
                                prev = keys[j]
                            arr.job_drf_prerank[j] = rank_val
            use_hdrf_order = False
            if use_drf_order:
                attrs = drf_opts["job_attrs"]
                for j, job in enumerate(arr.jobs_list):
                    attr = attrs.get(job.uid)
                    if attr is not None:
                        arr.job_drf_allocated[j] = \
                            attr.allocated.to_vector(arr.vocab)
                arr.drf_total = drf_opts["total"].to_vector(arr.vocab)
                if drf_opts.get("hierarchy"):
                    # the queue-path tree as arrays (ops.hdrf): their presence
                    # changes the packed layout, so the arena re-ships whole
                    # on the first hdrf session after a plain one
                    from ..ops.hdrf import build_hdrf
                    build_hdrf(arr, ssn.queues, attrs,
                               drf_opts["total_allocated"])
                    use_hdrf_order = True

        timing["flatten_ms"] = flattened.ms
        with tracing.span("vc.solve") as solved:
            params, families = build_score_inputs(ssn, arr)
            herd = ssn.solver_options.get("herd_mode")
            if herd is None:
                herd = "pack" if params["binpack_weight"] > (
                    params["least_req_weight"]
                    + params["balanced_weight"]) else "spread"

            dc = getattr(ssn, "device_cache", None)
            sidecar = getattr(ssn, "sidecar", None)
            # which arena a device fault must invalidate (and whose devices
            # decide whether the host oracle may finish the session): the
            # packed one, or the sharded one in a sharded session
            fault_dc = getattr(ssn, "sharded_device_cache", None) if sharded \
                else dc
            solve_kw = dict(herd_mode=herd, score_families=families,
                            use_queue_cap=use_queue_cap,
                            use_drf_order=use_drf_order,
                            use_hdrf_order=use_hdrf_order,
                            work_conserving=work_conserving)
            host_params = params
            via_sidecar = False
            try:
                # device-path circuit-breaker scope: anything that throws out
                # of the dispatch (a CUDA error, OOM, an injected fault) counts
                # one consecutive device failure; this session then finishes
                # through the host oracle on a CPU arena and re-raises on a
                # CUDA one (_device_fault_fallback)
                faults.fire("solver_dispatch")
                if sequential:
                    # the parity oracle: one device step per task, off the
                    # flatten's host arrays (not the resident arena)
                    from ..ops.solver import solve_allocate_sequential
                    dev = getattr(ssn.cache, "device", None)
                    res = solve_allocate_sequential(
                        arr.numpy_dict(), params, score_families=families,
                        use_queue_cap=use_queue_cap,
                        work_conserving=work_conserving, device=dev)
                elif sharded:
                    # mode: sharded — the node-axis sharded solver over the
                    # sharded device-resident arena (ShardedDeviceCache): node
                    # chunks live per shard, task/job chunks once per device,
                    # and a steady session ships dirty chunks only to the
                    # shards owning them (0 bytes when nothing changed). At D=1
                    # the solve is the packed path's with no collective
                    from ..parallel import solve_allocate_sharded_arena
                    from ..resilience.transient import retry_transient
                    with tracing.span("vc.pack") as packed:
                        fbuf, ibuf, layout = arr.packed()
                    timing["pack_ms"] = packed.ms
                    sdc = self._sharded_arena(ssn)
                    fault_dc = sdc
                    with sdc.fenced(ssn):
                        with tracing.span("vc.delta_plan") as planned:
                            bufs = sdc.update(fbuf, ibuf, layout)
                            params = sdc.params_device(params)
                        timing["delta_plan_ms"] = planned.ms
                        timing["delta_chunks"] = float(sdc.last_shipped_chunks)
                        timing["arena_mode"] = "sharded"
                        timing["arena_bytes_shipped"] = \
                            float(sdc.last_shipped_bytes)
                        timing["arena_full_ship"] = float(sdc.last_full_ship)
                        timing["arena_shard_bytes"] = \
                            [float(b) for b in sdc.last_shard_bytes]
                        pw = getattr(ssn, "prewarmer", None)
                        if pw is not None and pw.mesh is None:
                            # a sharded session pre-warms the sharded solve
                            pw.mesh = sdc.mesh
                        # the inputs the bucket prewarmer re-lays into the
                        # next bucket (ops.precompile)
                        sdc.last_solve_flags = dict(layout=layout, **solve_kw)
                        sdc.last_solve_inputs = (fbuf, ibuf, host_params)
                        # the sharded solve always runs the overflow phases
                        # under queue caps: it takes no work_conserving flag
                        kw = {k: v for k, v in solve_kw.items()
                              if k != "work_conserving"}
                        # one re-send of a transport failure (never of a
                        # CUDA error, resilience.transient). update()
                        # already scattered: the retry re-dispatches on the
                        # updated arena, and a failure that stays reaches
                        # the fallback below, which invalidates it
                        with tracing.span("vc.dispatch") as dispatched:
                            res = retry_transient(
                                lambda: solve_allocate_sharded_arena(
                                    *bufs, params, sdc.mesh, **kw),
                                what="sharded solver dispatch")
                        timing["dispatch_ms"] = dispatched.ms
                elif sidecar is not None:
                    # process boundary: ship the packed snapshot to the solver
                    # sidecar (which owns the card) and replay its
                    # assignments; its arena is the server's
                    with tracing.span("vc.pack") as packed:
                        fbuf, ibuf, layout = arr.packed()
                    timing["pack_ms"] = packed.ms
                    with tracing.span("vc.dispatch") as dispatched:
                        assigned, kind, info = sidecar.solve(
                            fbuf, ibuf, layout, params, **solve_kw)
                    timing["dispatch_ms"] = dispatched.ms
                    timing["sidecar_rtt_ms"] = sidecar.last_rtt_ms
                    timing["sidecar_request_bytes"] = \
                        float(sidecar.last_request_bytes)
                    for k in ("rounds", "shipped_chunks", "launches"):
                        if k in info:
                            timing[f"sidecar_{k}"] = float(info[k])
                    # the reply's buffers are read-only: copy into tensors
                    res = SimpleNamespace(assigned=torch.tensor(assigned),
                                          kind=torch.tensor(kind))
                    via_sidecar = True
                elif dc is not None:
                    # device-resident buffers: update() scatters the exact
                    # dirty chunks in place and the solve reads views of the
                    # resident buffers, so a session costs one scatter + solve
                    # + one compact readback. A failure after the scatter
                    # reaches _device_fault_fallback, which invalidates the
                    # arena: the next session re-ships it whole
                    from ..ops.solver import solve_allocate_packed2d
                    with tracing.span("vc.pack") as packed:
                        fbuf, ibuf, layout = arr.packed()
                    timing["pack_ms"] = packed.ms
                    with dc.fenced(ssn):
                        params = dc.params_device(params)
                        # the inputs the bucket prewarmer re-lays into the
                        # next bucket (ops.precompile)
                        dc.last_solve_flags = dict(layout=layout, **solve_kw)
                        dc.last_solve_inputs = (fbuf, ibuf, host_params)
                        with tracing.span("vc.delta_plan") as planned:
                            f2d, i2d = dc.update(fbuf, ibuf, layout)
                        timing["delta_plan_ms"] = planned.ms
                        timing["delta_chunks"] = float(dc.last_shipped_chunks)
                        timing["arena_mode"] = "packed"
                        timing["arena_bytes_shipped"] = \
                            float(dc.last_shipped_bytes)
                        timing["arena_full_ship"] = float(dc.last_full_ship)
                        with tracing.span("vc.dispatch") as dispatched:
                            res = solve_allocate_packed2d(
                                f2d, i2d, layout, params, **solve_kw)
                        timing["dispatch_ms"] = dispatched.ms
                else:
                    dev = getattr(ssn.cache, "device", None)
                    res = solve_allocate(arr.device_dict(dev), params,
                                         device=dev, **solve_kw)
            except ActionContained:
                raise  # abandoned: not a device fault
            except Exception:
                log.exception("solver dispatch failed; resetting the device "
                              "cache")
                self._device_fault_fallback(ssn, fault_dc, timing, breaker)
                return
            # --------------------------------------------------------------
            # dispatch/collect split: the result's device->host copy starts
            # now (ops.pipeline.start_readback), so it overlaps the host work
            # below: replay preparation (the node-name table the Statement
            # replay indexes), the bucket-prewarm occupancy check
            # (ops.precompile) and a young-generation gc pass (collection is
            # disabled during the cycle — see Scheduler.run_once).
            # pipeline_solver=False keeps the strictly serial order for parity
            # testing. A sidecar's result is on the host already.
            # --------------------------------------------------------------
            from ..ops.pipeline import start_readback
            from ..ops.solver import COMPACT_KIND_SHIFT, decode_compact
            # one int16 readback instead of two int32 ones; above 16k nodes the
            # node index overflows the int16 packing, and neither the sharded
            # solve nor the sidecar has a compact form
            compact_ok = not (sharded or via_sidecar) \
                and arr.N <= (1 << COMPACT_KIND_SHIFT)
            result = (res.compact,) if compact_ok else (res.assigned, res.kind)
            pipelined = bool(getattr(ssn, "pipeline_solver", True))
            node_names = None
            statements = None
            if pipelined:
                with tracing.span("vc.overlap") as overlapped:
                    readback = start_readback(*result)
                    node_names = [n.name for n in arr.nodes_list]
                    # Statement construction is pure (no session
                    # registration until ops are recorded), so the replay's
                    # per-job statements can be built before the results
                    # exist
                    statements = [ssn.statement(defer_events=True)
                                  for _ in job_order]
                    self._observe_prewarm(ssn, arr, fault_dc)
                    if result[0].device.type != "cpu":
                        # young-gen GC only when the solve runs on a real
                        # accelerator: there the readback wait is genuine host
                        # idle, while on the CPU host and "device" share
                        # cores and the collection would just lengthen the
                        # cycle
                        import gc
                        gc.collect(0)
                timing["overlap_ms"] = overlapped.ms
            with tracing.span("vc.readback") as read_back:
                try:
                    if not pipelined:
                        readback = start_readback(*result)
                    host = readback.wait()
                    if compact_ok:
                        assigned, kind = decode_compact(host[0])
                    else:
                        assigned, kind = host[0].numpy(), host[1].numpy()
                    self._check_solver_output(assigned, kind,
                                              len(tasks_in_order),
                                              len(arr.nodes_list))
                except Exception:
                    # collect failure: the error surfaces HERE, after the
                    # solve already scattered into the arena — drop the
                    # arena's device buffers so the next session re-ships in
                    # full instead of solving on (or scattering into)
                    # untrusted buffers, and finish THIS session through the
                    # host oracle so a device fault costs one slow cycle, not
                    # a scheduling gap
                    log.exception("solver collect failed; resetting the "
                                  "device cache")
                    self._device_fault_fallback(ssn, fault_dc, timing, breaker)
                    return
            timing["readback_ms"] = read_back.ms
            if not pipelined:
                # serial mode still pre-warms (after the readback), so turning
                # the overlap off doesn't also disable the first-use
                # protection
                self._observe_prewarm(ssn, arr, fault_dc)
            if breaker is not None:
                # a full dispatch+collect round-trip with sane output: the
                # device path is healthy (closes a half-open breaker)
                breaker.record_success()
        timing["solve_ms"] = solved.ms
        with tracing.span("vc.replay") as replayed:
            # replay through the Statement boundary in job order; events fire
            # as one batch per committed job and each job's accounting applies
            # as one bulk Statement wave (identical final handler/session state
            # — see Statement.allocate_bulk — at a fraction of the per-task
            # cost; the per-task loop blew the 1 s period on a 10k burst)
            assigned = assigned.tolist()  # plain ints: no np scalar per lookup
            kind = kind.tolist()
            # bulk-commit window: committed statements queue their cache-side
            # binds + allocate events; ONE flush applies them with full-width
            # node grouping (per-job commits degrade to 1-task node groups
            # when gangs spread across nodes — see Statement.commit)
            from ..framework.statement import begin_bulk_commit, \
                flush_bulk_commit
            acc = begin_bulk_commit(ssn)
            try:
                self._replay(ssn, arr, job_order, assigned, kind, node_names,
                             statements)
            finally:
                # exception-safe: jobs already committed into the window MUST
                # still get their cache binds + events even if a later job's
                # replay blows up (per-statement commits applied them eagerly)
                flush_bulk_commit(ssn, acc)
        timing["replay_ms"] = replayed.ms

    @staticmethod
    def _sharded_arena(ssn):
        """The cache's sharded arena, built on first use over
        parallel.arena_mesh() on the cache's device type (every CUDA card
        up to a power of two, or the cache's one CPU device) and kept on
        the cache: an arena must outlive the session that built it. A
        caller may install its own (over any mesh) on the cache first."""
        sdc = getattr(ssn, "sharded_device_cache", None)
        if sdc is None:
            from ..ops.device_cache import ShardedDeviceCache
            from ..parallel import arena_mesh
            dev = getattr(ssn.cache, "device", None)
            on_cpu = getattr(dev, "type", None) == "cpu"
            sdc = ShardedDeviceCache(arena_mesh([dev] if on_cpu else None))
            ssn.sharded_device_cache = sdc
            ssn.cache.sharded_device_cache = sdc
        return sdc

    def _device_fault_fallback(self, ssn, dc, timing, breaker) -> None:
        """Shared device-failure containment: count the failure against
        the circuit breaker, invalidate the arena's (possibly half-
        scattered) device buffers — keeping the pinned params for
        re-validation next session — and finish THIS
        session through the host oracle: a device fault costs one slow
        cycle plus one full re-ship, never a scheduling gap or a
        permanently cold arena (degradation ladder: device -> host
        oracle -> skip cycle).

        Called from an ``except`` block. On a CUDA arena the exception is
        re-raised after the accounting instead: a failed kernel build or
        launch must surface as the action's error, not as a cycle that
        quietly ran on the host."""
        timing["allocate_fault_reason"] = device_fault_reason(
            sys.exc_info()[1])
        if breaker is not None:
            breaker.record_failure()
        if dc is not None:
            dc.invalidate()
        if _on_card(ssn, dc):
            raise
        log.warning("finishing the session through the host loop")
        timing["host_fallback"] = 1.0
        ssn.solver_options["_post_host_jobs"] = []
        self._execute_host(ssn)

    @staticmethod
    def _observe_prewarm(ssn, arr, dc) -> None:
        """Feed the bucket prewarmer (ops.precompile.BucketPrewarmer) the
        live occupancy; a trigger only spawns a daemon thread, so this is
        safe inside the dispatch/collect overlap window."""
        pw = getattr(ssn, "prewarmer", None)
        if pw is None or dc is None:
            return
        try:
            pw.observe(arr, dc)
        except Exception:  # noqa: BLE001 — prewarm is advisory
            log.exception("bucket prewarm observe failed")

    @staticmethod
    def _check_solver_output(assigned, kind, n_tasks: int,
                             n_nodes: int) -> None:
        """Reject garbage readbacks (a sick device can return buffers
        full of nonsense without raising): node indices must be in
        [-1, n_nodes) and the pipeline flag boolean for every real task.
        Raising here routes through the same collect-failure fallback as
        an exception from the device itself."""
        a = np.asarray(assigned)[:n_tasks]
        k = np.asarray(kind)[:n_tasks]
        if not np.isfinite(a.astype(np.float64)).all():
            raise RuntimeError("solver returned non-finite assignments")
        if a.size and (((a < -1) | (a >= n_nodes)).any()
                       or ((a >= 0) & (k != 0) & (k != 1)).any()):
            raise RuntimeError(
                "solver output failed sanity checks (node index out of "
                f"[-1, {n_nodes}) or non-boolean pipeline flag)")

    def _replay(self, ssn, arr, job_order, assigned, kind,
                node_names: Optional[List[str]] = None,
                statements: Optional[List] = None) -> None:
        # node-name table + per-job statements: prepped in the
        # dispatch/collect overlap window when the pipeline is on,
        # rebuilt here otherwise
        if node_names is None:
            node_names = [n.name for n in arr.nodes_list]
        idx = 0
        for j, (job, tasks) in enumerate(job_order):
            stmt = statements[j] if statements is not None \
                else ssn.statement(defer_events=True)
            pairs = []
            for task in tasks:
                t_idx = idx
                idx += 1
                node_idx = assigned[t_idx]
                if node_idx < 0:
                    fe = FitErrors()
                    fe.set_error(ALL_NODES_UNAVAILABLE)
                    job.nodes_fit_errors[task.key] = fe
                    continue
                node_name = node_names[node_idx]
                if kind[t_idx] == 0:
                    pairs.append((task, node_name))
                    continue
                try:
                    ssn.pipeline(task, node_name)
                except (KeyError, ValueError) as e:
                    log.exception("replay failed for %s", task.key)
                    fe = FitErrors()
                    fe.set_node_error(node_name, FitError(
                        task, node_name, [str(e)]))
                    job.nodes_fit_errors[task.key] = fe
            for task, node_name, e in stmt.allocate_bulk(pairs):
                log.error("replay failed for %s", task.key, exc_info=e)
                fe = FitErrors()
                fe.set_node_error(node_name, FitError(
                    task, node_name, [str(e)]))
                job.nodes_fit_errors[task.key] = fe
            if ssn.job_ready(job):
                stmt.commit()
            else:
                stmt.discard()

    @staticmethod
    def _fill_queue_arrays(arr, queue_opts, ssn) -> None:
        """Overwrite the flatten's queue arrays from the proportion plugin's
        per-queue attrs (weight/capability/allocated/request). Queues known
        to the plugin but absent from the pending flatten (running-only
        queues) still participate in the water-fill, so their weight share
        is not redistributed to hungry queues (proportion.go:137-167)."""
        from ..ops.arrays import bucket

        vocab = arr.vocab
        R = len(vocab)
        names = list(arr.queues_list)
        known = set(names)
        names += [n for n in queue_opts if n not in known]
        Q = bucket(max(len(names), 1))
        weight = np.zeros(Q, dtype=np.float32)
        cap = np.full((Q, R), np.inf, dtype=np.float32)
        alloc = np.zeros((Q, R), dtype=np.float32)
        req = np.zeros((Q, R), dtype=np.float32)
        for i, n in enumerate(names):
            attr = queue_opts.get(n)
            if attr is None:
                qi = ssn.queues.get(n)
                weight[i] = getattr(qi, "weight", 1) or 1
                req[i] = np.inf  # unknown demand: stays hungry
                continue
            weight[i] = attr.weight
            alloc[i] = attr.allocated.to_vector(vocab)
            req[i] = attr.request.to_vector(vocab)
            if attr.capability is not None:
                cap_vec = attr.capability.to_vector(vocab)
                cap[i] = np.where(cap_vec > 0, cap_vec, np.inf)
        arr.queue_weight = weight
        arr.queue_capability = cap
        arr.queue_allocated = alloc
        arr.queue_request = req

    # ------------------------------------------------------------------
    # host mode (reference per-task loop)
    # ------------------------------------------------------------------

    def _predicate(self, ssn, task, node) -> None:
        if not task.init_resreq.less_equal(node.future_idle()):
            from ..plugins.predicates import PredicateError
            raise PredicateError(
                FitError(task, node.name, [NODE_RESOURCE_FIT_FAILED]))
        ssn.predicate_fn(task, node)

    def _execute_host(self, ssn, only_jobs=None) -> None:
        from ..plugins.predicates import PredicateError

        # Faithful control-flow port of allocate.go:124-265: the namespace
        # loop pops one job per iteration, requeues a ready job with
        # remaining tasks, and re-picks the queue each round so share-driven
        # orders (drf/hdrf/proportion) steer every single placement.
        # only_jobs restricts the loop to the jobs the solver routed here
        # (required inter-pod affinity needs in-flight placement tracking).
        namespaces = PriorityQueue(ssn.namespace_order_fn)
        jobs_map: Dict[str, Dict[str, PriorityQueue]] = {}
        for job in ssn.jobs.values():
            if only_jobs is not None and job.uid not in only_jobs:
                continue
            if TaskStatus.PENDING not in job.task_status_index:
                continue  # nothing to place (see _ordered_jobs)
            if job.pod_group.status.phase == PodGroupPhase.PENDING:
                continue
            vr = ssn.job_valid(job)
            if vr is not None and not vr.passed:
                continue
            if job.queue not in ssn.queues:
                continue
            ns = job.namespace
            if ns not in jobs_map:
                jobs_map[ns] = {}
                namespaces.push(ns)
            jobs_map[ns].setdefault(
                job.queue, PriorityQueue(ssn.job_order_fn)).push(job)

        pending_tasks: Dict[str, List] = {}
        while not namespaces.empty():
            ns = namespaces.pop()
            queue_map = jobs_map[ns]
            queue = None
            for qname in list(queue_map):
                qi = ssn.queues[qname]
                if ssn.overused(qi):
                    del queue_map[qname]
                    continue
                if queue is None or ssn.queue_order_fn(qi, queue):
                    queue = qi
            if queue is None:
                continue
            jobs = queue_map.get(queue.name)
            if jobs is None or jobs.empty():
                # drained queue: drop it and keep the namespace live so
                # its OTHER queues still pop (allocate.go:165-171 pops
                # the empty queue off the heap and continues; dropping
                # the namespace here would strand every sibling queue)
                queue_map.pop(queue.name, None)
                if any(not q.empty() for q in queue_map.values()):
                    namespaces.push(ns)
                continue
            job = jobs.pop()
            if job.uid not in pending_tasks:
                pending_tasks[job.uid] = self._pending_tasks(ssn, job)
            tasks = pending_tasks[job.uid]

            stmt = ssn.statement()
            sampler = getattr(ssn, "node_sampler", None)
            while tasks:
                task = tasks.pop(0)
                fit_errors = FitErrors()
                candidates = []
                all_nodes = list(ssn.nodes.values())
                if sampler is not None:
                    node_list, want = sampler.plan(all_nodes)
                else:
                    node_list, want = all_nodes, len(all_nodes)
                visited = 0
                for node in node_list:
                    visited += 1
                    try:
                        self._predicate(ssn, task, node)
                        candidates.append(node)
                        if len(candidates) >= want:
                            break  # adaptive sampling: enough feasible nodes
                    except PredicateError as e:
                        fit_errors.set_node_error(node.name, e.fit_error)
                if sampler is not None:
                    sampler.advance(visited, len(all_nodes))
                if not candidates:
                    job.nodes_fit_errors[task.key] = fit_errors
                    break
                candidates = [
                    n for n in candidates
                    if task.init_resreq.less_equal(n.idle)
                    or task.init_resreq.less_equal(n.future_idle())]
                if not candidates:
                    continue
                scores = {n.name: ssn.node_order_fn(task, n)
                          for n in candidates}
                batch = ssn.batch_node_order_fn(task, candidates)
                for name, s in batch.items():
                    scores[name] = scores.get(name, 0.0) + s
                best = ssn.best_node_fn(task, scores)
                if best is None:
                    best = max(candidates, key=lambda n: scores[n.name])
                try:
                    if task.init_resreq.less_equal(best.idle):
                        stmt.allocate(task, best.name)
                    else:
                        ssn.pipeline(task, best.name)
                except ValueError as e:
                    # e.g. AllocateVolumes failure (allocate.go:232-237
                    # logs and moves on; the resync path re-tries later)
                    log.warning("allocate failed for %s on %s: %s",
                                task.key, best.name, e)
                    continue
                if ssn.job_ready(job) and tasks:
                    jobs.push(job)
                    break
            if ssn.job_ready(job):
                stmt.commit()
            else:
                stmt.discard()
            namespaces.push(ns)

    def execute(self, ssn) -> None:
        mode = self.resolve_mode(ssn)
        breaker = getattr(ssn, "breaker", None)
        if mode != "host" and breaker is not None and not breaker.allow():
            # device path circuit-broken: go straight to the host oracle
            # for this cycle instead of paying a doomed dispatch (the
            # cool-down's half-open probe re-tries the device path later).
            # A CUDA arena, or a sharded one with a CUDA shard, has no
            # host fallback: the cycle fails instead
            sdc = getattr(ssn, "sharded_device_cache", None)
            timing = ssn.solver_options.setdefault("timing", {})
            timing["allocate_fault_reason"] = "breaker_open"
            if _on_card(ssn, sdc if mode == "sharded" else None):
                raise RuntimeError(
                    "the device path is circuit-broken after repeated "
                    "device failures; a CUDA arena has no host fallback")
            timing["host_fallback"] = 1.0
            timing["breaker_open"] = 1.0
            breaker.count_fallback()
            mode = "host"
        if mode == "host":
            self._execute_host(ssn)
            return
        self._execute_solver(ssn, sequential=(mode == "sequential"),
                             sharded=(mode == "sharded"))
        host_only = ssn.solver_options.get("host_only_jobs")
        if host_only:
            # host-only jobs ranked after some device-path job place via
            # the host loop against the post-solve session state (required
            # pod affinity wants other placements visible); the outranking
            # ones already placed BEFORE the solve in _execute_solver
            post = ssn.solver_options.get("_post_host_jobs")
            only = set(post) if post is not None else set(host_only)
            if only:
                self._execute_host(ssn, only_jobs=only)
