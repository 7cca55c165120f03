"""The ``reschedule`` action: periodic device-solved defragmentation.

Every allocate cycle only places *pending* work, so a long-running
cluster accumulates placement history no score function ever revisits —
the descheduler problem. This action closes the loop:

1. **snapshot** the running placement from the session's cache mirror:
   every RUNNING, resource-carrying task of a known job, with its
   current node as the incumbent;
2. **solve the full assignment problem on device** by presenting those
   running tasks as schedulable clones against shadow nodes whose
   migratable usage has been freed — the one packed arena path the
   allocate action uses (``PackedDeviceCache.update`` then
   ``ops.solver.solve_allocate_packed2d``, so on CUDA every round runs
   the ``fused_choice`` kernel), over the action's own arena on the
   cache's device, with the binpack family forced on so the solve is a
   global re-pack;
3. **diff** the solved placement against the incumbent one and bound it
   into a hole-punch migration plan (reschedule/plan.py): move budget,
   PDB-style per-job disruption caps, target feasibility, and a minimum
   fragmentation-improvement threshold that rejects no-op churn;
4. **execute** the plan as per-source-node eviction waves through the
   fenced Statement machinery, each wave journaled as a migration
   intent (reschedule/intent.py) BEFORE its evictions dispatch, so a
   leader crash mid-plan reconciles to zero lost / zero duplicate binds.

The evicted pods' replacements re-enter as pending work and the normal
allocate binpack places them onto the consolidating targets — eviction
is the only cluster-visible effect, exactly the reference descheduler's
contract, but the *decision* is one device solve instead of per-pod host
heuristics.

Degradation ladder: breaker open => the action skips the cycle outright
(defragmentation is optional work; it must never compete with placement
for a sick device), and a failed solve costs one skipped pass plus one
breaker failure count and an invalidated arena — never a scheduling gap.
Nothing is ever solved on the host instead: a skipped pass evicts
nothing.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..api import JobInfo, TaskStatus
from ..framework import Action, Arguments
from ..metrics import metrics
from ..resilience.faultinject import faults
from .intent import MigrationIntentJournal
from .plan import MIGRATION_REASON, MigrationPlan, MoveCandidate, build_plan

log = logging.getLogger(__name__)

#: configuration defaults; the Scheduler's reschedule_* flags land in
#: cache.reschedule_opts and per-action conf arguments override both
DEFAULTS = {
    "interval": 10,                # run the defrag solve every N cycles
    "max_moves": 8,                # migration budget per plan
    "max_disruption_per_job": 1,   # PDB-style per-job cap per plan
    "min_improvement": 0.01,       # stranded-fraction gain below which a
                                   # plan is rejected as no-op churn
}

#: bounded in-memory plan history (cache.reschedule_log): tests and
#: chip_smoke.py read per-plan budget/cap compliance from here
LOG_LIMIT = 256


class _State:
    """Cross-session rescheduler state, pinned on the SchedulerCache so
    the defrag solve gets the same arena amortization as allocate."""

    def __init__(self):
        self.cycle = 0
        self.flatten_cache = None     # ops.arrays.FlattenCache
        self.device_cache = None      # ops.device_cache.PackedDeviceCache
        self.journal: Optional[MigrationIntentJournal] = None
        self.rounds = 0               # rounds of the last defrag solve


class RescheduleAction(Action):
    def name(self) -> str:
        return "reschedule"

    # ------------------------------------------------------------------
    # configuration / state plumbing
    # ------------------------------------------------------------------

    def _resolve_opts(self, ssn) -> dict:
        opts = dict(DEFAULTS)
        opts.update(getattr(ssn.cache, "reschedule_opts", None) or {})
        for conf in ssn.configurations:
            if conf.name != self.name():
                continue
            args = Arguments(conf.arguments)
            opts["interval"] = args.get_int(
                "reschedule.interval", opts["interval"])
            opts["max_moves"] = args.get_int(
                "reschedule.maxMoves", opts["max_moves"])
            opts["max_disruption_per_job"] = args.get_int(
                "reschedule.maxDisruptionPerJob",
                opts["max_disruption_per_job"])
            opts["min_improvement"] = args.get_float(
                "reschedule.minImprovement", opts["min_improvement"])
        return opts

    @staticmethod
    def _state(cache) -> _State:
        state = getattr(cache, "reschedule_state", None)
        if state is None:
            state = _State()
            cache.reschedule_state = state
        return state

    @staticmethod
    def _journal(cache, state: _State):
        """Leader-only, like the bind-intent journal: non-HA embeddings
        pay nothing and need no recovery pass."""
        if getattr(cache, "bind_journal", None) is None:
            state.journal = None
            return None
        if state.journal is None:
            state.journal = MigrationIntentJournal(
                cache.fenced_cluster or cache.cluster,
                identity=getattr(cache.bind_journal, "identity", ""))
        return state.journal

    @staticmethod
    def _log_plan(cache, record: dict) -> None:
        log_ = getattr(cache, "reschedule_log", None)
        if log_ is None:
            log_ = cache.reschedule_log = []
        log_.append(record)
        del log_[:-LOG_LIMIT]

    def _skip(self, timing, reason: str) -> None:
        timing["reschedule_skipped"] = reason
        metrics.reschedule_plans_total.inc(labels={"outcome": reason})

    # ------------------------------------------------------------------
    # snapshot: the running placement as a schedulable shadow problem
    # ------------------------------------------------------------------

    def _collect(self, ssn, ref=None) -> List[Tuple[object, List]]:
        """(job, [stored running tasks]) in deterministic order. Host-only
        jobs (GPU sharing / affinity state the device solver cannot
        model) are never migration candidates, and neither are tasks as
        large as the reference shape — a ref-sized incumbent IS the
        fragmentation victim and has nowhere to land while the cluster
        is fragmented, so it stays pinned as fixed node usage."""
        host_only = ssn.solver_options.get("host_only_jobs") or ()
        out = []
        for job in sorted(ssn.jobs.values(),
                          key=lambda j: (j.creation_timestamp or 0.0,
                                         j.uid)):
            if job.pod_group is None or job.queue not in ssn.queues:
                continue
            if job.uid in host_only:
                continue
            running = job.task_status_index.get(TaskStatus.RUNNING, {})
            tasks = [
                t for t in running.values()
                if not t.resreq.is_empty()
                and t.node_name and t.node_name in ssn.nodes
                and ssn.nodes[t.node_name].node is not None
                and (ref is None or t.resreq.milli_cpu < ref.milli_cpu)
            ]
            if tasks:
                tasks.sort(key=lambda t: (t.pod.creation_timestamp or 0.0,
                                          t.uid))
                out.append((job, tasks))
        return out

    @staticmethod
    def _shadow_problem(ssn, job_order, hole=None, ref=None):
        """Clone world: running tasks as PENDING, their usage freed from
        shadow nodes — the 'empty cluster re-pack' formulation. When a
        hole site is pinned, that shadow node's capacity is HAIRCUT by
        the reference shape, so the device solve itself answers the
        defrag question: which tasks overflow the hole node, and can the
        rest of the cluster absorb them (a gang that cannot be fully
        placed reverts and proposes no moves)."""
        shadow_order = []
        shadow_jobs: Dict[str, JobInfo] = {}
        migratable = set()
        for job, tasks in job_order:
            sj = JobInfo(job.uid)
            sj.name, sj.namespace = job.name, job.namespace
            sj.queue, sj.priority = job.queue, job.priority
            sj.priority_class_name = job.priority_class_name
            sj.creation_timestamp = job.creation_timestamp
            sj.pod_group = job.pod_group
            # gang the shadow at full width: the re-pack either keeps the
            # whole running job placed or (on revert) proposes no moves
            sj.min_available = len(tasks)
            clones = []
            for t in tasks:
                c = t.clone()
                c.status = TaskStatus.PENDING
                c.node_name = ""
                sj.add_task_info(c)
                clones.append(c)
                migratable.add(t.key)
            shadow_jobs[sj.uid] = sj
            shadow_order.append((sj, clones))
        shadow_nodes = {}
        for name, ni in ssn.nodes.items():
            sn = ni.clone()
            for key in list(sn.tasks):
                if key in migratable:
                    sn.remove_task(sn.tasks[key])
            if name == hole and ref is not None:
                from ..api import Resource
                cut = Resource(
                    milli_cpu=min(ref.milli_cpu, sn.idle.milli_cpu),
                    memory=min(ref.memory, sn.idle.memory))
                sn.allocatable = sn.allocatable.clone().sub(cut)
                sn.idle = sn.idle.clone().sub(cut)
            shadow_nodes[name] = sn
        tasks_in_order = [c for _, cs in shadow_order for c in cs]
        return shadow_jobs, shadow_nodes, shadow_order, tasks_in_order

    # ------------------------------------------------------------------
    # the device solve (packed solver over a dedicated arena)
    # ------------------------------------------------------------------

    def _solve(self, ssn, state: _State, arr):
        from ..actions.allocate import AllocateAction, build_score_inputs
        from ..ops.device_cache import PackedDeviceCache
        from ..ops.solver import (
            COMPACT_KIND_SHIFT, decode_compact, solve_allocate_packed2d,
        )

        params, families = build_score_inputs(ssn, arr)
        if float(params["binpack_weight"]) == 0.0:
            # defrag IS a packing problem: when the session's conf runs
            # spread-style scoring, force a unit binpack objective so the
            # re-pack consolidates instead of reproducing the spread
            params["binpack_weight"] = np.float32(1.0)
            if "binpack" not in families:
                families = tuple(families) + ("binpack",)
        if state.device_cache is None:
            # the arena lives where the cache's does: a CPU cache gets a
            # CPU arena, never the CUDA default
            state.device_cache = PackedDeviceCache(
                device=getattr(ssn.cache, "device", None))
        dc = state.device_cache
        faults.fire("reschedule_dispatch")
        fbuf, ibuf, layout = arr.packed()
        params = dc.params_device(params)
        f2d, i2d = dc.update(fbuf, ibuf, layout)
        res = solve_allocate_packed2d(
            f2d, i2d, layout, params, herd_mode="pack",
            score_families=families, use_queue_cap=False,
            use_drf_order=False, use_hdrf_order=False, work_conserving=True)
        if arr.N <= (1 << COMPACT_KIND_SHIFT):
            assigned, kind = decode_compact(res.compact)
        else:
            assigned, kind = res.assigned.cpu().numpy(), res.kind.cpu().numpy()
        state.rounds = int(res.rounds)
        AllocateAction._check_solver_output(
            assigned, kind, arr.T, len(arr.nodes_list))
        return assigned.tolist(), kind.tolist()

    # ------------------------------------------------------------------
    # diff + plan + execute
    # ------------------------------------------------------------------

    @staticmethod
    def _ref_shape(ssn):
        """The reference slot the hole must reach: the largest-cpu
        request shape currently running OR waiting — waiting demand is
        exactly what defragmentation makes room for. Returns a Resource
        (cpu + that task's memory) or None when there is no demand."""
        ref = None
        for job in ssn.jobs.values():
            if job.pod_group is None or job.queue not in ssn.queues:
                continue
            for t in job.tasks.values():
                if not t.resreq.is_empty() and (
                        ref is None
                        or t.resreq.milli_cpu > ref.milli_cpu):
                    ref = t.resreq
        return ref

    @staticmethod
    def _choose_hole(ssn, job_order, ref, per_job_cap: int) \
            -> Optional[str]:
        """The hole site, picked host-side BEFORE the solve so the
        shadow haircut and the plan agree: the node with the most free
        CPU (smallest deficit => fewest moves) among nodes that could
        actually reach the reference shape. A node's vacatable capacity
        counts each job's movers only up to the PDB-style per-job
        disruption cap (largest first, matching the plan's selection
        order), and the deficit must fit the other nodes' combined free
        (the displaced movers need landing capacity). None when no node
        qualifies."""
        per_node_job: Dict[str, Dict[str, List[float]]] = {}
        for job, tasks in job_order:
            for t in tasks:
                per_node_job.setdefault(t.node_name, {}) \
                    .setdefault(job.uid, []).append(t.resreq.milli_cpu)
        vacatable: Dict[str, float] = {}
        for node, jobs in per_node_job.items():
            vacatable[node] = sum(
                sum(sorted(cpus, reverse=True)[:per_job_cap])
                for cpus in jobs.values())
        free = {name: ni.idle.milli_cpu
                for name, ni in ssn.nodes.items() if ni.node is not None}
        total_free = sum(free.values())
        best = None
        for name in sorted(free):
            deficit = ref.milli_cpu - free[name]
            if deficit <= 0:
                continue  # execute() already checked; defensive
            if vacatable.get(name, 0.0) < deficit:
                continue  # even a capped full vacate misses the shape
            if total_free - free[name] < deficit:
                continue  # the displaced movers have nowhere to land
            if best is None or free[name] > free[best]:
                best = name
        return best

    @staticmethod
    def _candidates(arr, job_order, assigned, kind) -> List[MoveCandidate]:
        node_names = [n.name for n in arr.nodes_list]
        cands = []
        idx = 0
        for job, tasks in job_order:
            for t in tasks:
                a, k = assigned[idx], kind[idx]
                idx += 1
                if a < 0 or k != 0:
                    continue  # unplaced or pipelined: never a firm move
                target = node_names[a]
                if target == t.node_name:
                    continue
                cands.append(MoveCandidate(
                    key=t.key, namespace=t.namespace, name=t.name,
                    job_uid=job.uid, from_node=t.node_name,
                    to_node=target, cpu=t.resreq.milli_cpu,
                    mem=t.resreq.memory))
        return cands

    def _execute_plan(self, ssn, plan: MigrationPlan, journal) -> int:
        """Per-source-node eviction waves through the fenced Statement
        machinery; each wave journaled before its evictions dispatch. A
        FencedError from the journal aborts the remainder of the plan —
        a deposed leader must not migrate."""
        from ..client.store import FencedError

        waves: Dict[str, List[MoveCandidate]] = {}
        for m in plan.moves:
            waves.setdefault(m.from_node, []).append(m)
        executed = 0
        for source in sorted(waves):
            wave = waves[source]
            if journal is not None:
                try:
                    journal.record(wave)
                except FencedError:
                    log.error("migration-intent journal fenced; abandoning"
                              " the remainder of the plan (%d waves left)",
                              len(waves) - len([s for s in sorted(waves)
                                                if s < source]))
                    break
                except Exception:  # noqa: BLE001 — journal is best-effort
                    log.exception("migration-intent journal write failed; "
                                  "executing the wave without the record")
            faults.fire("migration_commit")
            stmt = ssn.statement()
            n = 0
            for m in wave:
                job = ssn.jobs.get(m.job_uid)
                task = job.tasks.get(m.key) if job is not None else None
                if task is None or task.status != TaskStatus.RUNNING \
                        or task.node_name != m.from_node:
                    continue  # the landscape moved under the plan
                try:
                    stmt.evict(
                        task,
                        f"{MIGRATION_REASON}: defragmentation -> "
                        f"{m.to_node}")
                    n += 1
                except (KeyError, ValueError):
                    log.exception("migration evict failed for %s", m.key)
            stmt.commit()
            executed += n
        return executed

    # ------------------------------------------------------------------
    # the action
    # ------------------------------------------------------------------

    def execute(self, ssn) -> None:
        from ..ops import flatten_snapshot
        from ..ops.arrays import FlattenCache

        timing = ssn.solver_options.setdefault("timing", {})
        cache = ssn.cache
        opts = self._resolve_opts(ssn)
        state = self._state(cache)
        journal = self._journal(cache, state)
        if journal is not None:
            try:
                journal.sweep()
            except Exception:  # noqa: BLE001 — sweep retries next cycle
                log.exception("migration-intent sweep failed")
        state.cycle += 1
        if opts["interval"] <= 0 \
                or (state.cycle - 1) % opts["interval"] != 0:
            timing["reschedule_skipped"] = "interval"
            return
        breaker = getattr(ssn, "breaker", None)
        if breaker is not None and not breaker.allow():
            # degradation ladder: breaker open => skip the cycle; defrag
            # never probes a sick device and never host-falls-back
            self._skip(timing, "skipped_breaker")
            return

        t0 = time.perf_counter()
        # host-side pre-checks BEFORE any device work: the defrag solve
        # only dispatches when the cluster is actually fragmented (the
        # reference shape fits nowhere) and some node can be made to fit
        # it by vacating migratable movers
        ref = self._ref_shape(ssn)
        free = {name: (ni.idle.milli_cpu, ni.idle.memory)
                for name, ni in ssn.nodes.items() if ni.node is not None}
        if ref is None or not free:
            self._skip(timing, "empty")
            return
        if max(v[0] for v in free.values()) >= ref.milli_cpu:
            self._skip(timing, "fits")
            return
        job_order = self._collect(ssn, ref)
        if not job_order:
            self._skip(timing, "empty")
            return
        hole = self._choose_hole(ssn, job_order, ref,
                                 opts["max_disruption_per_job"])
        if hole is None:
            self._skip(timing, "no_hole")
            return
        shadow_jobs, shadow_nodes, shadow_order, tasks_in_order = \
            self._shadow_problem(ssn, job_order, hole=hole, ref=ref)
        if state.flatten_cache is None:
            state.flatten_cache = FlattenCache()
        arr = flatten_snapshot(
            shadow_jobs, shadow_nodes, tasks_in_order,
            queues=ssn.queues, cache=state.flatten_cache,
            grouped=shadow_order)
        try:
            assigned, kind = self._solve(ssn, state, arr)
        except Exception:
            log.exception("reschedule solve failed; skipping this pass")
            if breaker is not None:
                breaker.record_failure()
            if state.device_cache is not None:
                state.device_cache.invalidate()
            self._skip(timing, "solve_failed")
            return
        if breaker is not None:
            breaker.record_success()
        solve_ms = (time.perf_counter() - t0) * 1e3

        cands = self._candidates(arr, job_order, assigned, kind)
        plan = build_plan(
            cands, free,
            max_moves=opts["max_moves"],
            max_disruption_per_job=opts["max_disruption_per_job"],
            min_improvement=opts["min_improvement"],
            ref_cpu=ref.milli_cpu, hole=hole)

        executed = 0
        if plan.rejected is None:
            executed = self._execute_plan(ssn, plan, journal)
            metrics.reschedule_plans_total.inc(
                labels={"outcome": "executed"})
        else:
            metrics.reschedule_plans_total.inc(
                labels={"outcome": f"rejected_{plan.rejected}"})
        metrics.reschedule_moves_total.inc(
            plan.proposed, labels={"stage": "proposed"})
        metrics.reschedule_moves_total.inc(
            len(plan.moves), labels={"stage": "selected"})
        metrics.reschedule_moves_total.inc(
            executed, labels={"stage": "executed"})
        metrics.reschedule_moves_total.inc(
            plan.capped, labels={"stage": "capped"})
        metrics.reschedule_fragmentation.set(
            plan.frag_before, labels={"phase": "pre"})
        metrics.reschedule_fragmentation.set(
            plan.frag_after, labels={"phase": "post"})
        metrics.reschedule_plan_solve_ms.set(solve_ms)
        timing["reschedule_solve_ms"] = solve_ms
        timing["reschedule_moves_proposed"] = float(plan.proposed)
        timing["reschedule_moves_selected"] = float(len(plan.moves))
        timing["reschedule_moves_executed"] = float(executed)
        timing["reschedule_moves_capped"] = float(plan.capped)
        timing["reschedule_frag_pre"] = plan.frag_before
        timing["reschedule_frag_post"] = plan.frag_after
        record = plan.summary()
        record["executed"] = executed
        record["solve_ms"] = round(solve_ms, 3)
        record["budget"] = opts["max_moves"]
        record["per_job_cap"] = opts["max_disruption_per_job"]
        self._log_plan(cache, record)
