"""Session: snapshot-backed per-cycle scheduling state + plugin dispatch.

Reimplements reference framework/{session.go:37-429, session_plugins.go:26-591}:
19 plugin-fn registries with tiered dispatch — first tier with an answer wins
for orders and victims (victims additionally intersected within a tier),
vetoes short-circuit for ready/pipelined/valid/enqueueable, and scores sum.

The device twist: the Session also carries the flattened device-array view of
the snapshot (built lazily by ops.SnapshotArrays) so actions can
hand the whole decision problem to the solver kernel, then replay results
through exactly these Allocate/Pipeline/Evict primitives.
"""

from __future__ import annotations

import logging
import threading
import uuid
from typing import Callable, Dict, List, Optional

from ..api import (
    ClusterInfo, JobInfo, NodeInfo, QueueInfo, Resource, TaskInfo,
    TaskStatus, allocated_status,
)
from ..models import PodGroupPhase
from .event import Event, EventHandler
from .interface import ValidateResult

log = logging.getLogger(__name__)

#: registry-name -> PluginOption enable-flag attribute (None = always on)
FN_REGISTRIES = {
    "job_order_fns": "enabled_job_order",
    "queue_order_fns": "enabled_queue_order",
    "task_order_fns": "enabled_task_order",
    "namespace_order_fns": "enabled_namespace_order",
    "job_ready_fns": "enabled_job_ready",
    "job_pipelined_fns": "enabled_job_pipelined",
    "job_valid_fns": None,
    "job_enqueueable_fns": None,
    "predicate_fns": "enabled_predicate",
    "best_node_fns": "enabled_best_node",
    "node_order_fns": "enabled_node_order",
    "batch_node_order_fns": "enabled_node_order",
    "node_map_fns": "enabled_node_order",
    "node_reduce_fns": "enabled_node_order",
    "preemptable_fns": "enabled_preemptable",
    "reclaimable_fns": "enabled_reclaimable",
    "overused_fns": None,
    "target_job_fns": "enabled_target_job",
    "reserved_nodes_fns": "enabled_reserved_nodes",
}


def _enabled(plugin_option, flag_attr: Optional[str]) -> bool:
    if flag_attr is None:
        return True
    v = getattr(plugin_option, flag_attr, None)
    return True if v is None else bool(v)


class Session:
    def __init__(self, cache, snapshot: ClusterInfo):
        self.uid = str(uuid.uuid4())
        self.cache = cache
        self.jobs: Dict[str, JobInfo] = snapshot.jobs
        self.nodes: Dict[str, NodeInfo] = snapshot.nodes
        self.queues: Dict[str, QueueInfo] = snapshot.queues
        self.namespace_info = snapshot.namespace_info

        self.tiers = []          # List[conf.Tier]
        self.configurations = []  # per-action args
        self.plugins = {}        # name -> Plugin instance

        # status fingerprint of every PodGroup at session open; the job
        # updater diffs end-of-session status against this to decide writes
        # (job_updater.go:95-100 ssn.podGroupStatus). A significance tuple
        # replaces the earlier per-field status copy: same diff answer,
        # ~3x cheaper at 1k jobs/cycle (close_session's floor)
        self.pod_group_status = {
            uid: job.pod_group.status.fingerprint()
            for uid, job in self.jobs.items() if job.pod_group is not None
        }
        self._total_allocatable: Optional[Resource] = None
        # jobs whose podgroup conditions changed significantly this
        # session (update_pod_group_condition); one of the job updater's
        # dirty signals
        self._conditions_touched = set()

        for reg in FN_REGISTRIES:
            setattr(self, reg, {})
        self.event_handlers: List[EventHandler] = []
        # memoized _tier_fns lists (invalidated by _add): dispatchers run
        # O(tasks) times per cycle, so rebuilding the tier walk each call
        # dominates the host profile at 10k tasks
        self._tier_cache: Dict[str, list] = {}
        # optional per-plugin sort KEY extractors mirroring the pairwise
        # order fns: when every active provider of an order registry also
        # registered a key, actions may sort once by composite key instead
        # of O(n log n) comparator dispatches (solver-mode collection only
        # — the host loop needs live comparators)
        self.order_key_fns: Dict[str, Dict[str, Callable]] = {}
        # per-plugin key CONTEXT extractors (add_order_key_context_fn):
        # a key fn that reads state beyond the item itself declares that
        # outside state here so the cross-session OrderCache can tell when
        # cached keys of UNCHANGED items went stale (drf: cluster total;
        # priority: the priority-class table)
        self.order_key_context_fns: Dict[str, Dict[str, Callable]] = {}

        # device seam: plugins contribute scalar weights for the on-device
        # scoring families here instead of per-(task,node) callbacks; the
        # allocate action feeds them to ops.solve_allocate
        from ..ops.arrays import ScoreParams
        self.score_params = ScoreParams()
        self.solver_options: Dict[str, object] = {}
        # session-side mutation odometer: bumped by every allocate/
        # pipeline/evict applied to the session's clones (fire sites +
        # statement records). The allocate action reads it before its
        # flatten — a non-zero count means an earlier action mutated the
        # flatten inputs OUTSIDE the event ledger's sight (e.g. a conf
        # ordering preempt before allocate), so the event-sourced fast
        # path must stand down for this cycle
        self._mutation_ops = 0
        self.flatten_cache = getattr(cache, "flatten_cache", None)
        # event-sourced ordering inputs (ops.ordering.OrderCache): the
        # allocate action's collection pass patches only event-dirty jobs;
        # preempt/reclaim reuse its per-job sorted pending lists
        self.order_cache = getattr(cache, "order_cache", None)
        self.evict_flatten_caches = getattr(cache, "evict_flatten_caches",
                                            None) or {}
        # the device-resident packed arena (ops.device_cache), the node-axis
        # sharded arena and the solver-mode routing preference (the
        # allocate action builds the sharded arena lazily and writes it
        # back to the cache so it persists across sessions)
        self.device_cache = getattr(cache, "device_cache", None)
        self.sharded_device_cache = getattr(cache, "sharded_device_cache",
                                            None)
        self.solver_mode = getattr(cache, "solver_mode", None)
        # the solver-sidecar client and the bucket prewarmer, when the
        # cache carries them (parallel.sidecar, ops.precompile)
        self.sidecar = getattr(cache, "sidecar", None)
        self.prewarmer = getattr(cache, "prewarmer", None)
        self.sharded_byte_budget = getattr(cache, "sharded_byte_budget", 0)
        # the allocate action's dispatch/collect overlap (False = strictly
        # serial solve for parity testing)
        self.pipeline_solver = getattr(cache, "pipeline_solver", True)
        # resilience seams: the device-path circuit breaker (installed on
        # the cache by the Scheduler; consumed by allocate/evict_solver
        # for the device -> host-oracle degradation ladder), plus the
        # open-statement ledger + action epochs the scheduler's per-action
        # containment uses to roll back a hung or throwing action's
        # uncommitted transactions (see resilience/watchdog.py)
        self.breaker = getattr(cache, "breaker", None)
        self._open_statements: Dict[int, object] = {}
        self._action_epoch = 0
        self._contained_epochs: set = set()
        # an action running on a watchdog thread pins its own epoch: the
        # loop's _action_epoch moves on when the action is abandoned
        self._epoch_pin = threading.local()
        # decision-trace seam (sim.recorder.DecisionRecorder): when the
        # cache carries a recorder, close_session hands it the finished
        # session so pipeline statements and per-job FitErrors reach the
        # trace; binds/evicts are captured at the effector boundary
        # (cache.RecordingBinder/RecordingEvictor)
        self.decision_recorder = getattr(cache, "decision_recorder", None)

    def pin_action_epoch(self, epoch: int) -> None:
        """Bind ``epoch`` to the calling thread (a watchdog's action
        thread), so its statements and fences keep the epoch it started
        with after the loop has moved on."""
        self._epoch_pin.epoch = epoch

    def current_epoch(self) -> int:
        """The calling thread's action epoch: its pinned one, else the
        loop's."""
        return getattr(self._epoch_pin, "epoch", self._action_epoch)

    def action_contained(self) -> bool:
        """Whether the calling thread's action was abandoned and contained
        (its deadline passed): what it does from now on must not reach
        the cluster or the device arena."""
        return self.current_epoch() in self._contained_epochs

    # ------------------------------------------------------------------
    # registration API used by plugins (session_plugins.go:26-118)
    # ------------------------------------------------------------------

    def _add(self, registry: str, name: str, fn: Callable) -> None:
        getattr(self, registry)[name] = fn
        self._tier_cache.pop(registry, None)

    def add_order_key_fn(self, registry: str, name: str, fn: Callable) -> None:
        """Register a sort-key extractor equivalent to plugin ``name``'s
        pairwise comparator in ``registry`` (e.g. "job_order_fns"):
        fn(item) -> value such that comparator(l, r) < 0 iff fn(l) < fn(r).
        Keys must be static for the duration of a solver-mode collection.

        Cross-session contract (ops.ordering.OrderCache): a key must be a
        pure function of the item's own version-gated state; a key that
        also reads anything else (cluster totals, config tables) MUST
        declare that state via add_order_key_context_fn, or cached orders
        can go silently stale."""
        self.order_key_fns.setdefault(registry, {})[name] = fn

    def add_order_key_context_fn(self, registry: str, name: str,
                                 fn: Callable) -> None:
        """Declare the outside state plugin ``name``'s key extractor in
        ``registry`` depends on: fn() -> hashable whose value changes
        whenever that state changes. The OrderCache compares contexts
        every cycle and falls back to the full sort when any moved."""
        self.order_key_context_fns.setdefault(registry, {})[name] = fn

    def composite_order_key(self, registry: str) -> Optional[Callable]:
        """A key(item) -> tuple covering every active provider of
        ``registry`` in tier order, or None when some provider has no
        registered key (callers fall back to comparator sorting)."""
        keyfns = []
        reg_keys = self.order_key_fns.get(registry, {})
        for _, name, _ in self._tier_fns(registry):
            kf = reg_keys.get(name)
            if kf is None:
                return None
            keyfns.append(kf)
        return lambda item: tuple(kf(item) for kf in keyfns)

    def full_order_key(self, registry: str,
                       ct_of: Callable = None) -> Optional[Callable]:
        """Composite plugin key + the creation-timestamp/uid tiebreak that
        the comparator dispatchers apply after plugin ties (job_order_fn /
        task_order_fn), as ONE key function; None when some provider has
        no registered key."""
        key = self.composite_order_key(registry)
        if key is None:
            return None
        if ct_of is None:
            ct_of = lambda item: item.creation_timestamp  # noqa: E731

        def full_key(item):
            ct = ct_of(item)
            return (key(item), ct is not None, ct or 0, item.uid)

        return full_key

    def keyed_job_queue_factory(self) -> Optional[Callable]:
        """Factory for KeySortedQueue job queues, or None when a job-order
        plugin lacks a key and callers must keep comparator
        PriorityQueues."""
        from ..utils import KeySortedQueue
        full_key = self.full_order_key("job_order_fns")
        if full_key is None:
            return None
        return lambda: KeySortedQueue(full_key)

    def add_job_order_fn(self, name, fn): self._add("job_order_fns", name, fn)
    def add_queue_order_fn(self, name, fn): self._add("queue_order_fns", name, fn)
    def add_task_order_fn(self, name, fn): self._add("task_order_fns", name, fn)
    def add_namespace_order_fn(self, name, fn): self._add("namespace_order_fns", name, fn)
    def add_job_ready_fn(self, name, fn): self._add("job_ready_fns", name, fn)
    def add_job_pipelined_fn(self, name, fn): self._add("job_pipelined_fns", name, fn)
    def add_job_valid_fn(self, name, fn): self._add("job_valid_fns", name, fn)
    def add_job_enqueueable_fn(self, name, fn): self._add("job_enqueueable_fns", name, fn)
    def add_predicate_fn(self, name, fn): self._add("predicate_fns", name, fn)
    def add_best_node_fn(self, name, fn): self._add("best_node_fns", name, fn)
    def add_node_order_fn(self, name, fn): self._add("node_order_fns", name, fn)
    def add_batch_node_order_fn(self, name, fn): self._add("batch_node_order_fns", name, fn)
    def add_node_map_fn(self, name, fn): self._add("node_map_fns", name, fn)
    def add_node_reduce_fn(self, name, fn): self._add("node_reduce_fns", name, fn)
    def add_preemptable_fn(self, name, fn): self._add("preemptable_fns", name, fn)
    def add_reclaimable_fn(self, name, fn): self._add("reclaimable_fns", name, fn)
    def add_overused_fn(self, name, fn): self._add("overused_fns", name, fn)
    def add_target_job_fn(self, name, fn): self._add("target_job_fns", name, fn)
    def add_reserved_nodes_fn(self, name, fn): self._add("reserved_nodes_fns", name, fn)

    def add_event_handler(self, eh: EventHandler) -> None:
        self.event_handlers.append(eh)

    # ------------------------------------------------------------------
    # tier iteration helper
    # ------------------------------------------------------------------

    def _tier_fns(self, registry: str):
        """(tier_index, plugin_name, fn) for enabled plugins holding a fn in
        this registry, in tier order. Memoized: dispatchers call this per
        comparison/task, and the tier walk itself was ~15% of a 10k-task
        cycle before caching (_add invalidates)."""
        cached = self._tier_cache.get(registry)
        if cached is None:
            flag = FN_REGISTRIES[registry]
            fns = getattr(self, registry)
            cached = [
                (ti, opt.name, fns[opt.name])
                for ti, tier in enumerate(self.tiers)
                for opt in tier.plugins
                if _enabled(opt, flag) and opt.name in fns
            ]
            self._tier_cache[registry] = cached
        return cached

    # ------------------------------------------------------------------
    # dispatchers (session_plugins.go:120-591)
    # ------------------------------------------------------------------

    def _compare_dispatch(self, registry: str, l, r) -> int:
        for _, _, fn in self._tier_fns(registry):
            j = fn(l, r)
            if j != 0:
                return j
        return 0

    def job_order_fn(self, l: JobInfo, r: JobInfo) -> bool:
        j = self._compare_dispatch("job_order_fns", l, r)
        if j != 0:
            return j < 0
        if l.creation_timestamp == r.creation_timestamp:
            return l.uid < r.uid
        return l.creation_timestamp < r.creation_timestamp

    def queue_order_fn(self, l: QueueInfo, r: QueueInfo) -> bool:
        j = self._compare_dispatch("queue_order_fns", l, r)
        if j != 0:
            return j < 0
        lt = l.queue.creation_timestamp
        rt = r.queue.creation_timestamp
        if lt == rt:
            return l.uid < r.uid
        return lt < rt

    def task_compare_fns(self, l: TaskInfo, r: TaskInfo) -> int:
        return self._compare_dispatch("task_order_fns", l, r)

    def task_order_fn(self, l: TaskInfo, r: TaskInfo) -> bool:
        j = self.task_compare_fns(l, r)
        if j != 0:
            return j < 0
        if l.pod.creation_timestamp == r.pod.creation_timestamp:
            return l.uid < r.uid
        return l.pod.creation_timestamp < r.pod.creation_timestamp

    def namespace_order_fn(self, l: str, r: str) -> bool:
        j = self._compare_dispatch("namespace_order_fns", l, r)
        if j != 0:
            return j < 0
        return l < r

    def _victims_dispatch(self, registry: str, claimer, claimees):
        """Intersect candidate lists across plugins; return at the end of the
        first tier whose running intersection is non-empty.

        The intersection accumulator is NOT reset between tiers
        (session_plugins.go:121-160: `init` persists) — once any fn returns
        no victims, every later tier intersects against the empty set. In
        practice this means e.g. reclaim only yields victims when the
        first tier's gang fn (priority-based) approves them, which is why
        the reference's positive reclaim e2e cases all use high-vs-low
        priority classes."""
        victims = None
        for _, group in _group_by_tier(self._tier_fns(registry)):
            for _, _, fn in group:
                candidates = fn(claimer, claimees)
                if victims is None:
                    victims = list(candidates)
                else:
                    cand_uids = {c.uid for c in candidates}
                    victims = [v for v in victims if v.uid in cand_uids]
            if victims:
                return victims
        return []

    def preemptable(self, preemptor: TaskInfo, preemptees: List[TaskInfo]):
        return self._victims_dispatch("preemptable_fns", preemptor, preemptees)

    def reclaimable(self, reclaimer: TaskInfo, reclaimees: List[TaskInfo]):
        return self._victims_dispatch("reclaimable_fns", reclaimer, reclaimees)

    def overused(self, queue: QueueInfo) -> bool:
        return any(fn(queue) for _, _, fn in self._tier_fns("overused_fns"))

    def job_ready(self, job: JobInfo) -> bool:
        return all(fn(job) for _, _, fn in self._tier_fns("job_ready_fns"))

    def job_pipelined(self, job: JobInfo) -> bool:
        return all(fn(job) for _, _, fn in self._tier_fns("job_pipelined_fns"))

    def job_valid(self, job: JobInfo) -> Optional[ValidateResult]:
        for _, _, fn in self._tier_fns("job_valid_fns"):
            vr = fn(job)
            if vr is not None and not vr.passed:
                return vr
        return None

    def job_enqueueable(self, job: JobInfo) -> bool:
        return all(fn(job) for _, _, fn in self._tier_fns("job_enqueueable_fns"))

    def target_job(self, jobs: List[JobInfo]) -> Optional[JobInfo]:
        for _, _, fn in self._tier_fns("target_job_fns"):
            return fn(jobs)
        return None

    def reserved_nodes(self) -> None:
        for _, _, fn in self._tier_fns("reserved_nodes_fns"):
            fn()

    def predicate_fn(self, task: TaskInfo, node: NodeInfo) -> None:
        """Raises FitError-carrying exception on failure (error = veto)."""
        for _, _, fn in self._tier_fns("predicate_fns"):
            fn(task, node)

    def best_node_fn(self, task: TaskInfo, node_scores) -> Optional[NodeInfo]:
        for _, _, fn in self._tier_fns("best_node_fns"):
            best = fn(task, node_scores)
            if best is not None:
                return best
        return None

    def node_order_fn(self, task: TaskInfo, node: NodeInfo) -> float:
        """Sum of per-plugin scores (session_plugins.go NodeOrderFn)."""
        return sum(fn(task, node) for _, _, fn in self._tier_fns("node_order_fns"))

    def batch_node_order_fn(self, task: TaskInfo, nodes: List[NodeInfo]):
        score: Dict[str, float] = {n.name: 0.0 for n in nodes}
        for _, _, fn in self._tier_fns("batch_node_order_fns"):
            per_node = fn(task, nodes)
            for name, s in per_node.items():
                score[name] = score.get(name, 0.0) + s
        return score

    def node_order_map_fn(self, task: TaskInfo, node: NodeInfo):
        """Per-plugin map scores: returns (plugin->score dict, sum of
        priority scores)."""
        node_score_map: Dict[str, float] = {}
        total = 0.0
        for _, name, fn in self._tier_fns("node_map_fns"):
            score = fn(task, node)
            node_score_map[name] = score
            total += score
        return node_score_map, total

    def node_order_reduce_fn(self, task: TaskInfo, plugin_node_scores):
        """Reduce phase: plugin -> {node -> score} maps reduced to node sums."""
        out: Dict[str, float] = {}
        reduce_fns = dict(
            (name, fn) for _, name, fn in self._tier_fns("node_reduce_fns"))
        for plugin, node_scores in plugin_node_scores.items():
            rf = reduce_fns.get(plugin)
            scores = rf(task, node_scores) if rf is not None else node_scores
            for node_name, s in scores.items():
                out[node_name] = out.get(node_name, 0.0) + s
        return out

    # ------------------------------------------------------------------
    # state mutation (session.go:214-378)
    # ------------------------------------------------------------------

    def total_allocatable(self) -> Resource:
        """Cluster-wide allocatable, summed once per session — drf and
        proportion each walked all nodes for the same total, which at 2k
        nodes was a measurable slice of the steady-state cycle. Callers
        must not mutate the returned Resource (clone first)."""
        t = self._total_allocatable
        if t is None:
            t = Resource.sum_of(
                n.allocatable for n in self.nodes.values())
            self._total_allocatable = t
        return t

    def statement(self, defer_events: bool = False):
        from .statement import Statement
        stmt = Statement(self, defer_events=defer_events)
        # ledger for containment sweeps; commit/discard remove themselves
        self._open_statements[id(stmt)] = stmt
        return stmt

    def discard_open_statements(self) -> int:
        """Containment sweep: discard every statement that was opened but
        neither committed nor discarded, newest first — a contained
        (throwing or timed-out) action's in-flight transactions must not
        leak half-applied session state into the rest of the cycle.
        Returns the number of statements that actually carried ops."""
        stmts = list(self._open_statements.values())
        self._open_statements.clear()
        n = 0
        for stmt in reversed(stmts):
            try:
                if stmt.operations:
                    n += 1
                stmt.discard()
            except Exception:  # noqa: BLE001 — sweep every statement
                log.exception("failed to discard a contained statement")
        return n

    def _fire_allocate(self, task: TaskInfo) -> None:
        self._mutation_ops += 1
        for eh in self.event_handlers:
            if eh.allocate_func is not None:
                eh.allocate_func(Event(task))

    def _fire_deallocate(self, task: TaskInfo) -> None:
        self._mutation_ops += 1
        for eh in self.event_handlers:
            if eh.deallocate_func is not None:
                eh.deallocate_func(Event(task))

    def _fire_allocate_batch(self, tasks: list) -> None:
        """Fire allocate events for many tasks at once; handlers with a
        batch form get one call, others get the per-task loop."""
        if not tasks:
            return
        self._mutation_ops += len(tasks)
        for eh in self.event_handlers:
            if eh.batch_allocate_func is not None:
                eh.batch_allocate_func(tasks)
            elif eh.allocate_func is not None:
                for t in tasks:
                    eh.allocate_func(Event(t))

    def pipeline(self, task: TaskInfo, hostname: str) -> None:
        job = self.jobs.get(task.job)
        if job is None:
            raise KeyError(f"failed to find job {task.job} when pipelining")
        job.update_task_status(task, TaskStatus.PIPELINED)
        task.node_name = hostname
        node = self.nodes.get(hostname)
        if node is None:
            raise KeyError(f"failed to find node {hostname}")
        node.add_task(task)
        self._fire_allocate(task)

    def allocate(self, task: TaskInfo, hostname: str) -> None:
        """Assign in-session; auto-dispatch the whole job once JobReady
        (session.go:255-311)."""
        self.cache.allocate_volumes(task, hostname)
        job = self.jobs.get(task.job)
        if job is None:
            raise KeyError(f"failed to find job {task.job}")
        job.update_task_status(task, TaskStatus.ALLOCATED)
        task.node_name = hostname
        node = self.nodes.get(hostname)
        if node is None:
            raise KeyError(f"failed to find node {hostname}")
        node.add_task(task)
        self._fire_allocate(task)

        if self.job_ready(job):
            for t in list(job.task_status_index.get(TaskStatus.ALLOCATED, {}).values()):
                self.dispatch(t)

    def dispatch(self, task: TaskInfo) -> None:
        self.cache.bind_volumes(task)
        self.cache.bind(task, task.node_name)
        job = self.jobs.get(task.job)
        if job is None:
            raise KeyError(f"failed to find job {task.job}")
        job.update_task_status(task, TaskStatus.BINDING)

    def evict(self, reclaimee: TaskInfo, reason: str) -> None:
        self.cache.evict(reclaimee, reason)
        job = self.jobs.get(reclaimee.job)
        if job is None:
            raise KeyError(f"failed to find job {reclaimee.job}")
        job.update_task_status(reclaimee, TaskStatus.RELEASING)
        node = self.nodes.get(reclaimee.node_name)
        if node is not None:
            node.update_task(reclaimee)
        self._fire_deallocate(reclaimee)

    def update_pod_group_condition(self, job_info: JobInfo, cond) -> None:
        job = self.jobs.get(job_info.uid)
        if job is None:
            raise KeyError(f"failed to find job {job_info.uid}")
        conds = job.pod_group.status.conditions
        for i, c in enumerate(conds):
            if c.type == cond.type:
                # only a significant change dirties the job for the
                # updater — same significance rule as
                # PodGroupStatus.fingerprint() (transition_id/time don't
                # count), so gang's steady per-cycle re-post of an
                # identical Scheduled condition doesn't force 1k no-op
                # recomputes
                if (c.status, c.reason, c.message) != (
                        cond.status, cond.reason, cond.message):
                    self._conditions_touched.add(job.uid)
                conds[i] = cond
                return
        self._conditions_touched.add(job.uid)
        conds.append(cond)

    def __str__(self) -> str:
        return (f"Session {self.uid}: jobs={len(self.jobs)} "
                f"nodes={len(self.nodes)}")


def _group_by_tier(it):
    """Group (tier, name, fn) triples by tier index preserving order."""
    groups: Dict[int, list] = {}
    for t, name, fn in it:
        groups.setdefault(t, []).append((t, name, fn))
    return sorted(groups.items())


def job_status(ssn: Session, job: JobInfo):
    """Recompute PodGroup status from session state (session.go:166-205)."""
    from ..models import POD_GROUP_UNSCHEDULABLE_TYPE

    pg = job.pod_group
    status = pg.status
    unschedulable = any(
        c.type == POD_GROUP_UNSCHEDULABLE_TYPE and c.status == "True"
        and c.transition_id == ssn.uid
        for c in status.conditions)

    if job.task_status_index.get(TaskStatus.RUNNING) and unschedulable:
        status.phase = PodGroupPhase.UNKNOWN
    else:
        allocated = sum(
            len(tasks) for st, tasks in job.task_status_index.items()
            if allocated_status(st) or st == TaskStatus.SUCCEEDED)
        if allocated >= pg.spec.min_member:
            status.phase = PodGroupPhase.RUNNING
        elif pg.status.phase != PodGroupPhase.INQUEUE:
            status.phase = PodGroupPhase.PENDING

    status.running = len(job.task_status_index.get(TaskStatus.RUNNING, {}))
    status.failed = len(job.task_status_index.get(TaskStatus.FAILED, {}))
    status.succeeded = len(job.task_status_index.get(TaskStatus.SUCCEEDED, {}))
    return status
