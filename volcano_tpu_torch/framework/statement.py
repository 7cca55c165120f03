"""Statement: transaction log of {Evict, Pipeline, Allocate} session ops.

The gang all-or-nothing primitive (reference framework/statement.go:28-388):
operations mutate session state immediately; Commit() applies side effects
through the cache (bind/evict), Discard() undoes everything in reverse order.
The device solver's assignments are replayed through exactly this boundary.
"""

from __future__ import annotations

import enum
import logging
from typing import List, Tuple

from ..api import Resource, TaskInfo, TaskStatus
from ..resilience.faultinject import faults

log = logging.getLogger(__name__)


class Op(enum.Enum):
    EVICT = "evict"
    PIPELINE = "pipeline"
    ALLOCATE = "allocate"


#: operation log entries are plain (op, task, reason) tuples — a 10k-task
#: replay appends one per task, and dataclass construction was measurable
_Operation = Tuple[Op, TaskInfo, str]


class Statement:
    def __init__(self, ssn, defer_events: bool = False):
        self.ssn = ssn
        self.operations: List[_Operation] = []
        # defer_events: don't fire per-task allocate events as ALLOCATE ops
        # are recorded; fire them as ONE batch at commit. A discarded
        # statement then fires nothing for its allocate ops — identical
        # final handler state to the reference's fire-then-unfire (handlers
        # are additive), at a tenth of the cost. Pipelined tasks are NOT
        # covered: ssn.pipeline() is outside the Statement (allocate.go
        # pipelines via ssn.Pipeline) and keeps firing live, surviving
        # discard exactly as before. Used by the solver replay; the host
        # loop keeps live events because its ordering decisions read
        # shares mid-flight.
        self.defer_events = defer_events
        # containment bookkeeping: which action epoch opened this
        # statement. A watchdog-contained (timed-out) action's zombie
        # thread may call commit() long after the scheduler moved on; the
        # epoch guard turns that late commit into a discard so nothing an
        # abandoned action decided reaches the cluster (see
        # resilience/watchdog.py).
        self._epoch = ssn.current_epoch()

    # -- evict --------------------------------------------------------------

    def evict(self, reclaimee: TaskInfo, reason: str) -> None:
        """Mark Releasing in session now; the pod delete happens at Commit."""
        job = self.ssn.jobs.get(reclaimee.job)
        if job is not None:
            job.update_task_status(reclaimee, TaskStatus.RELEASING)
        node = self.ssn.nodes.get(reclaimee.node_name)
        if node is not None:
            node.update_task(reclaimee)
        self.ssn._fire_deallocate(reclaimee)
        self.operations.append((Op.EVICT, reclaimee, reason))

    def _commit_evict(self, reclaimee: TaskInfo, reason: str) -> None:
        try:
            self.ssn.cache.evict(reclaimee, reason)
        except Exception:
            log.exception("commit evict failed for %s", reclaimee.key)
            self._unevict(reclaimee)
            raise

    def _unevict(self, reclaimee: TaskInfo) -> None:
        job = self.ssn.jobs.get(reclaimee.job)
        if job is not None:
            job.update_task_status(reclaimee, TaskStatus.RUNNING)
        node = self.ssn.nodes.get(reclaimee.node_name)
        if node is not None:
            node.update_task(reclaimee)
        self.ssn._fire_allocate(reclaimee)

    # -- pipeline -----------------------------------------------------------

    def pipeline(self, task: TaskInfo, hostname: str) -> None:
        job = self.ssn.jobs.get(task.job)
        if job is not None:
            job.update_task_status(task, TaskStatus.PIPELINED)
        task.node_name = hostname
        node = self.ssn.nodes.get(hostname)
        if node is not None:
            node.add_task(task)
        self.ssn._fire_allocate(task)
        self.operations.append((Op.PIPELINE, task, ""))

    def _unpipeline(self, task: TaskInfo) -> None:
        job = self.ssn.jobs.get(task.job)
        if job is not None:
            job.update_task_status(task, TaskStatus.PENDING)
        node = self.ssn.nodes.get(task.node_name)
        if node is not None:
            node.remove_task(task)
        task.node_name = ""
        self.ssn._fire_deallocate(task)

    # -- allocate -----------------------------------------------------------

    def allocate(self, task: TaskInfo, hostname: str) -> None:
        self.ssn.cache.allocate_volumes(task, hostname)
        job = self.ssn.jobs.get(task.job)
        if job is not None:
            job.update_task_status(task, TaskStatus.ALLOCATED)
        task.node_name = hostname
        node = self.ssn.nodes.get(hostname)
        if node is not None:
            node.add_task(task)
        if not self.defer_events:
            self.ssn._fire_allocate(task)
        else:
            self.ssn._mutation_ops += 1
        self.operations.append((Op.ALLOCATE, task, ""))

    def allocate_bulk(self, pairs) -> list:
        """allocate() over a whole assignment wave ([(task, hostname)]) in
        one pass: volume assumptions, events and undo records keep their
        per-task semantics, while job/node accounting is applied as bulk
        index moves + one summed resource delta per (job, node) group.
        Pairs the fast path can't take (missing job/node, wave that doesn't
        fit, foreign objects) go through plain allocate() instead. Returns
        [(task, hostname, exc)] for pairs that failed — the same exceptions
        allocate() would have raised (callers record FitErrors from
        them)."""
        ssn = self.ssn
        failures = []
        slow = []
        vol_batch = getattr(ssn.cache, "allocate_volumes_batch", None)
        if vol_batch is not None:
            vol_failures = vol_batch(pairs)
            if vol_failures:
                failures.extend(vol_failures)
                failed = {id(t) for t, _, _ in vol_failures}
                pairs = [(t, h) for t, h in pairs if id(t) not in failed]
        by_node = {}
        jobs = ssn.jobs
        last_jobid = None  # replay waves are per-job: one lookup suffices
        job = None
        seen = set()
        for task, hostname in pairs:
            if vol_batch is None:
                try:
                    ssn.cache.allocate_volumes(task, hostname)
                except (KeyError, ValueError) as e:
                    failures.append((task, hostname, e))
                    continue
            if task.job != last_jobid:
                job = jobs.get(task.job)
                last_jobid = task.job
            key = task.key
            # slow-path pairs: unknown job, a task that is not the job's
            # stored object (bulk_update_status would quietly route it but
            # the atomicity argument needs stored-only waves), or a
            # duplicate within the wave (the per-task loop raises on the
            # second occurrence; the wave must not double-count it)
            if job is None or job.tasks.get(key) is not task \
                    or key in seen:
                slow.append((task, hostname))
                continue
            seen.add(key)
            group = by_node.get(hostname)
            if group is None:
                by_node[hostname] = [task]
            else:
                group.append(task)
        # the fast path must be unable to raise mid-wave (a partial bulk
        # mutation would leave applied tasks without undo records), so each
        # node group is validated with the same checks add_task makes —
        # whole-group fit included — and demoted to the per-task path
        # otherwise, whose partial-application + raise semantics the caller
        # already handles
        fast_nodes = []
        bad = (TaskStatus.RELEASING, TaskStatus.PIPELINED)
        for hostname, tasks in by_node.items():
            node = ssn.nodes.get(hostname)
            ok = node is not None and node.node is not None
            if ok:
                node_tasks = node.tasks
                for t in tasks:
                    if (t.node_name and t.node_name != hostname) \
                            or t.key in node_tasks or t.status in bad:
                        ok = False
                        break
            if ok:
                req = tasks[0].resreq if len(tasks) == 1 \
                    else Resource.sum_of(t.resreq for t in tasks)
                ok = req.less_equal(node.idle)
            if ok:
                fast_nodes.append((node, tasks))
            else:
                slow.extend((t, hostname) for t in tasks)
        by_job = {}
        for node, tasks in fast_nodes:
            for t in tasks:
                by_job.setdefault(t.job, []).append(t)
        demoted = set()
        for jobid, tasks in by_job.items():
            try:
                # raises BEFORE mutating (aggregates pre-checked), so a
                # failed job's whole wave can still demote to the per-task
                # path and surface per-task failures
                ssn.jobs[jobid].bulk_update_status(
                    tasks, TaskStatus.ALLOCATED)
            except (KeyError, ValueError):
                demoted.update(id(t) for t in tasks)
        ops = self.operations
        for node, tasks in fast_nodes:
            if demoted:
                kept = [t for t in tasks if id(t) not in demoted]
                slow.extend((t, node.name) for t in tasks
                            if id(t) in demoted)
                if not kept:
                    continue
                tasks = kept
            node.add_tasks_bulk(tasks, validated=True)
            if not self.defer_events:
                for task in tasks:
                    ssn._fire_allocate(task)
            else:
                ssn._mutation_ops += len(tasks)
            for task in tasks:
                ops.append((Op.ALLOCATE, task, ""))
        for task, hostname in slow:
            try:
                # volumes were already assumed; re-assuming is idempotent
                self.allocate(task, hostname)
            except (KeyError, ValueError) as e:
                failures.append((task, hostname, e))
        return failures

    def _commit_allocate(self, task: TaskInfo) -> None:
        try:
            self.ssn.cache.bind_volumes(task)
            self.ssn.cache.bind(task, task.node_name)
        except Exception:
            log.exception("commit allocate failed for %s", task.key)
            self._unallocate(task)
            raise

    def _unallocate(self, task: TaskInfo, fired: bool = True) -> None:
        _undo_allocate(self.ssn, task, fired)

    # -- transaction boundary ----------------------------------------------

    def _close_ledger(self) -> None:
        ledger = getattr(self.ssn, "_open_statements", None)
        if ledger is not None:
            ledger.pop(id(self), None)

    def commit(self) -> None:
        """Apply side effects (statement.go:370-388)."""
        if self._epoch in getattr(self.ssn, "_contained_epochs", ()):
            # the action that opened this statement was contained (it
            # blew its deadline and was abandoned): its decisions were
            # rolled back, so a zombie thread's late commit must discard
            log.warning("discarding commit from a contained action")
            self.discard()
            return
        self._close_ledger()
        acc = getattr(self.ssn, "_bulk_commit_acc", None)
        if acc is not None and self.defer_events and self.operations \
                and getattr(self.ssn.cache, "bind_batch", None) is not None \
                and all(name is Op.ALLOCATE
                        for name, _, _ in self.operations):
            # bulk-commit window (the solver replay): defer this
            # statement's cache-side effects and allocate events to ONE
            # end-of-replay wave (flush_bulk_commit). Per-job commits
            # produce node groups of ~1 task when a job's gang spreads
            # across nodes, degrading every bulk helper to per-task work;
            # the merged wave re-groups the whole replay by node.
            acc.extend(task for _, task, _ in self.operations)
            self.operations = []
            return
        # crash-safe window: journal the decided binds BEFORE any effect
        # dispatches (resilience/recovery.py; leader-only — bind_journal
        # is None outside HA), then cross the bind_commit fault seam. A
        # crash landing anywhere past this line leaves a durable intent
        # the next leader reconciles; a FencedError from the journal
        # means this writer was deposed and must discard, not commit.
        _journal_statement_binds(self)
        faults.fire("bind_commit")
        if self.defer_events:
            self.ssn._fire_allocate_batch(
                [task for name, task, _ in self.operations
                 if name is Op.ALLOCATE])
        bind_batch = getattr(self.ssn.cache, "bind_batch", None)
        if bind_batch is not None and len(self.operations) > 1 and all(
                name is Op.ALLOCATE for name, _, _ in self.operations):
            # pure-allocate statement (the solver replay shape): volumes
            # bind as one wave, then ONE batched cache bind — identical
            # cache state and failure handling to the per-op loop, without
            # its per-task dispatch cost
            cache = self.ssn.cache
            tasks = [task for _, task, _ in self.operations]
            vb_batch = getattr(cache, "bind_volumes_batch", None)
            if vb_batch is not None:
                vol_failures = vb_batch(tasks)
            else:
                vol_failures = []
                for task in tasks:
                    try:
                        cache.bind_volumes(task)
                    except Exception as e:  # noqa: BLE001
                        vol_failures.append((task, e))
            if vol_failures:
                failed = {id(t) for t, _ in vol_failures}
                tasks = [t for t in tasks if id(t) not in failed]
                for task, exc in vol_failures:
                    log.error("commit bind_volumes failed for %s: %s",
                              task.key, exc)
                    self._unallocate(task)
            for task, exc in bind_batch(tasks):
                log.error("commit bind failed for %s: %s", task.key, exc)
                self._unallocate(task)
            self.operations = []
            return
        for name, task, reason in self.operations:
            try:
                if name is Op.EVICT:
                    self._commit_evict(task, reason)
                elif name is Op.ALLOCATE:
                    self._commit_allocate(task)
                # Pipeline has no cache side effect: the promise lives in
                # session/PodGroup state until resources actually free.
            except Exception:
                continue
        self.operations = []

    def discard(self) -> None:
        """Reverse-order undo (statement.go:345-367)."""
        self._close_ledger()
        # a discarded statement must leave nothing in the bulk-commit
        # window (its ops were never accumulated — commit() is the only
        # writer — so plain reverse-undo below is complete)
        for name, task, _ in reversed(self.operations):
            if name is Op.EVICT:
                self._unevict(task)
            elif name is Op.PIPELINE:
                self._unpipeline(task)
            elif name is Op.ALLOCATE:
                # deferred mode never fired the allocate event, so the
                # undo must not fire the deallocate one
                self._unallocate(task, fired=not self.defer_events)
        self.operations = []


def _journal_statement_binds(stmt: "Statement") -> None:
    """Persist a Statement's decided ALLOCATE wave as one bind intent
    (see resilience/recovery.py) before any effect dispatches. No-op
    unless the cache carries a journal (leader-only). FencedError aborts
    the commit — a deposed leader's decisions discard instead of
    reaching the cluster; any other journal failure is logged and the
    commit proceeds (the journal narrows crash windows, it must not
    widen availability ones)."""
    journal = getattr(stmt.ssn.cache, "bind_journal", None)
    if journal is None or not stmt.operations:
        return
    tasks = [task for name, task, _ in stmt.operations
             if name is Op.ALLOCATE]
    if not tasks:
        return
    try:
        journal.record(tasks)
    except Exception as e:  # noqa: BLE001 — classify below
        from ..client.store import FencedError
        if isinstance(e, FencedError):
            log.error("bind-intent journal fenced; discarding the "
                      "deposed leader's statement: %s", e)
            stmt.discard()
            raise
        log.exception("bind-intent journal write failed; committing "
                      "without the intent record")


def _journal_wave_binds(ssn, tasks: list) -> None:
    """flush_bulk_commit's counterpart of _journal_statement_binds: one
    intent for the whole merged replay wave."""
    journal = getattr(ssn.cache, "bind_journal", None)
    if journal is None or not tasks:
        return
    try:
        journal.record(tasks)
    except Exception as e:  # noqa: BLE001 — classify below
        from ..client.store import FencedError
        if isinstance(e, FencedError):
            log.error("bind-intent journal fenced; unwinding the "
                      "deposed leader's replay wave: %s", e)
            # the deferred allocate events were never fired for this
            # wave, so the unwind fires nothing either (handler parity
            # with a discarded deferred statement)
            for task in tasks:
                _undo_allocate(ssn, task, fired=False)
            raise
        log.exception("bind-intent journal write failed; committing "
                      "without the intent record")


def _undo_allocate(ssn, task: TaskInfo, fired: bool = True) -> None:
    """Reverse one session-side allocate (shared by Statement._unallocate
    and the bulk-commit flush, which outlives its statements)."""
    revert = getattr(ssn.cache, "revert_volumes", None)
    if revert is not None:
        revert(task)  # drop the AllocateVolumes assumption
    job = ssn.jobs.get(task.job)
    if job is not None:
        job.update_task_status(task, TaskStatus.PENDING)
    node = ssn.nodes.get(task.node_name)
    if node is not None:
        node.remove_task(task)
    task.node_name = ""
    if fired:
        ssn._fire_deallocate(task)


def begin_bulk_commit(ssn) -> list:
    """Open a bulk-commit window on the session: subsequent pure-allocate
    deferred-event statements queue their tasks here instead of paying a
    cache bind wave each (see Statement.commit). Caller MUST pair with
    flush_bulk_commit."""
    acc: list = []
    ssn._bulk_commit_acc = acc
    return acc


def flush_bulk_commit(ssn, acc: list) -> None:
    """Close the window and apply every queued statement's side effects as
    one wave: a single allocate-event batch, one volume bind wave, one
    cache bind_batch over the WHOLE replay (node groups re-form at full
    width instead of per job). Cache state and failure semantics are
    identical to per-statement commits — a task whose cache-side bind
    fails is unallocated session-side exactly as Statement.commit would."""
    ssn._bulk_commit_acc = None
    if not acc:
        return
    # same crash-safe window as Statement.commit: intent first, then the
    # bind_commit fault seam, then effects (see resilience/recovery.py)
    _journal_wave_binds(ssn, acc)
    faults.fire("bind_commit")
    ssn._fire_allocate_batch(acc)
    cache = ssn.cache
    tasks = acc
    vb_batch = getattr(cache, "bind_volumes_batch", None)
    if vb_batch is not None:
        vol_failures = vb_batch(tasks)
    else:
        vol_failures = []
        for task in tasks:
            try:
                cache.bind_volumes(task)
            except Exception as e:  # noqa: BLE001
                vol_failures.append((task, e))
    if vol_failures:
        failed = {id(t) for t, _ in vol_failures}
        tasks = [t for t in tasks if id(t) not in failed]
        for task, exc in vol_failures:
            log.error("commit bind_volumes failed for %s: %s",
                      task.key, exc)
            _undo_allocate(ssn, task, fired=False)
            ssn._fire_deallocate(task)
    # Statement.commit only queues into the window when the cache HAS
    # bind_batch; the guard here keeps the flush total anyway
    bind_batch = getattr(cache, "bind_batch", None)
    if bind_batch is not None:
        failures = bind_batch(tasks)
    else:
        failures = []
        for task in tasks:
            try:
                cache.bind(task, task.node_name)
            except Exception as e:  # noqa: BLE001
                failures.append((task, e))
    for task, exc in failures:
        log.error("commit bind failed for %s: %s", task.key, exc)
        _undo_allocate(ssn, task, fired=False)
        ssn._fire_deallocate(task)
