"""Event-sourced session ordering: the OrderCache.

The allocate action's collection pass re-derives the namespace -> queue ->
job -> task order from scratch every cycle (reference allocate.go:61-189):
filter every job, evaluate every composite order key, sort every queue's
jobs and every job's pending list. After PR 11 event-sourced the flatten,
that pass was the last cycle-start host cost scaling with cluster size
instead of change volume — at 10k pending tasks across 1k jobs it re-keys
and re-sorts everything even when three watch events arrived since the
last solve.

The OrderCache keeps the ordering *inputs* warm across sessions, fed by
the same typed watch-event deltas that drive the FlattenCache ledger
(SchedulerCache._feed_flatten: watch hooks + the version-gated
snapshot-clone seam catch-all) plus the enqueue action's in-session phase
flips:

- per job: an eligibility record (the _ordered_jobs filters), the
  composite job-order key (session.full_order_key), and the pending task
  list already sorted by the full task-order key;
- per (namespace, queue): the eligible jobs as a bisect-maintained sorted
  index of (key, uid) pairs.

At cycle start only event-dirty jobs are re-filtered / re-keyed /
re-sorted and re-placed in their queue index; the final namespace/queue
interleave then runs as a flat walk over the sorted indexes with the
LIVE queue-order / overused / namespace-order dispatchers evaluated once
per queue per cycle — valid because solver-mode collection happens before
any session mutation, so those orders are frozen for its duration
(exactly the contract the keyed job queues already rely on,
actions/allocate._ordered_jobs). A cycle with zero deltas reuses the
previous walk result object outright.

Consistency epoch, PR-11 discipline: feed_event counts deltas observed
vs deltas marked; a dropped or duplicated delivery (the ``order_event``/
``order_event_dup`` fault points) skews the counters and the next collect
detects it and falls back to the full sort, which trusts nothing.
Anything structural degrades the same way with a typed reason:

- ``comparator_only``  — some active order plugin registered no key
  extractor; the cache stands down and the caller runs the live
  comparator walk (marks keep accruing, so a later keyed cycle resumes
  incrementally);
- ``conf_reload``      — a hot-reload changed the active order-provider
  set (plugin added/removed/moved tiers);
- ``key_context``      — a provider's declared key context moved (e.g.
  drf's cluster total after a node respec, a priority-class edit):
  live-share-dependent keys are only trusted while their context holds;
- ``session_mutations``— an earlier action in this cycle mutated the
  session's clones outside the ledger's sight (preempt-before-allocate
  confs); the full sort reads the post-mutation state;
- ``queue_membership`` — a queue event changed the queue set, which can
  flip eligibility of jobs the ledger never marked;
- ``epoch_mismatch``   — the drop/dup case above;
- ``cold_start`` / ``membership_drift`` / ``index_drift`` — first cycle
  and the defensive invariants.

Key contract: an order-key extractor registered via
``Session.add_order_key_fn`` must be a pure function of the item's own
(version-gated) state; a key that also reads cluster-wide state must
register a context fn via ``Session.add_order_key_context_fn`` whose
value changes whenever that outside state changes (drf registers the
cluster total, priority the priority-class table). Order identity is
asserted element-for-element against the live comparator walk across a
seeded churn matrix of the repo's ordering tests.
"""

from __future__ import annotations

import threading
from bisect import bisect_left, insort
from functools import cmp_to_key
from typing import Dict, List, Optional, Tuple

from ..api import TaskStatus
from ..models import PodGroupPhase


class _Decline(Exception):
    """Internal: abandon the event path for this cycle, typed reason."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


def _task_ct(t):
    return t.pod.creation_timestamp


class OrderCache:
    """See module docstring. One instance lives on the SchedulerCache
    (like the FlattenCache) and persists across sessions."""

    def __init__(self):
        # -- event ledger ---------------------------------------------------
        self._lock = threading.Lock()
        self._feed = 0          # deltas OBSERVED (pre-drop)
        self._seq = 0           # deltas actually marked
        self._prev_feed = 0     # both counters as of the last consume
        self._prev_seq = 0
        self._dirty_jobs: set = set()
        self._queue_event = False   # queue add/update/delete seen
        self._broken: Optional[str] = None
        # -- keyed order state ----------------------------------------------
        self._entries: Dict[str, dict] = {}       # job uid -> entry
        #: ns -> {queue name -> sorted [(job full key, uid), ...]}
        self._ns_queues: Dict[str, Dict[str, list]] = {}
        self._queue_names: frozenset = frozenset()
        self._sig: Optional[tuple] = None    # active order-provider tuple
        self._ctx: Optional[tuple] = None    # provider context values
        self._primed = False
        self._last_walk: Optional[list] = None
        self._ctx_memo: Optional[tuple] = None  # (session, ok) for reuse
        # -- observability --------------------------------------------------
        self.last_mode = "none"   # reuse | event | full | legacy
        self.last_reason: Optional[str] = None
        self.last_entries_patched = 0
        self.fallback_counts: Dict[str, int] = {}
        #: cumulative count of actual list sorts (task lists + queue
        #: indexes) — the quiet-cluster regression counter
        self.sorts_performed = 0
        self.walks_reused = 0

    # -- event feed ---------------------------------------------------------

    def feed_event(self, kind: str, event: str, job: Optional[str] = None,
                   node: Optional[str] = None) -> None:
        """Record one typed mirror delta (same call shape as
        FlattenCache.feed_event; the SchedulerCache forwards every delta to
        both ledgers). Node deltas are counted but never dirty a job —
        node state reaches ordering only through declared key contexts."""
        from ..resilience.faultinject import faults
        with self._lock:
            self._feed += 1
        try:
            # chaos seam: an armed `order_event` drops this delta exactly
            # as a torn feed would — observed counter moved, mark never
            # lands, epoch check catches the skew at the next collect
            faults.fire("order_event")
        except Exception:  # noqa: BLE001 — the drop IS the fault
            return
        self._mark(kind, event, job, node)
        try:
            # `order_event_dup`: the same delta delivered twice
            faults.fire("order_event_dup")
        except Exception:  # noqa: BLE001
            self._mark(kind, event, job, node)

    def _mark(self, kind: str, event: str, job: Optional[str],
              node: Optional[str]) -> None:
        with self._lock:
            self._seq += 1
            if kind in ("pod", "job", "podgroup"):
                if job:
                    self._dirty_jobs.add(job)
            elif kind == "node":
                pass  # ordering reads nodes only via key contexts
            elif kind == "queue":
                # membership can flip eligibility of unmarked jobs;
                # validated against the live queue set at collect
                self._queue_event = True
            else:
                self._broken = f"unmapped:{kind}"

    def suppress(self, reason: str) -> None:
        """Decline the event path at the next collect with ``reason``."""
        with self._lock:
            self._broken = reason

    def _take(self) -> dict:
        with self._lock:
            return {
                "feed": self._feed, "seq": self._seq,
                "jobs": set(self._dirty_jobs),
                "queue_event": self._queue_event,
                "broken": self._broken,
            }

    def _consume(self, taken: dict) -> None:
        with self._lock:
            self._dirty_jobs -= taken["jobs"]
            if self._feed == taken["feed"]:
                # no concurrent marks: flags fully consumed; otherwise
                # leave them for the next cycle's validation
                self._queue_event = False
                self._broken = None
            self._prev_feed = taken["feed"]
            self._prev_seq = taken["seq"]

    # -- provider signature / key contexts ----------------------------------

    def _signature(self, ssn) -> Tuple[tuple, tuple]:
        """(active order-provider tuple, context values) for the job and
        task order registries. Providers without a context fn are trusted
        as pure functions of the (version-gated) item."""
        sig, ctx = [], []
        for registry in ("job_order_fns", "task_order_fns"):
            reg_ctx = ssn.order_key_context_fns.get(registry, {})
            for ti, name, _ in ssn._tier_fns(registry):
                sig.append((registry, ti, name))
                cfn = reg_ctx.get(name)
                if cfn is not None:
                    ctx.append(((registry, name), cfn()))
        return tuple(sig), tuple(ctx)

    # -- per-job entries ----------------------------------------------------

    def _entry(self, ssn, job, jobkey, taskkey) -> dict:
        """Eligibility + key + sorted pending list for one job — the exact
        filter sequence of actions/allocate._ordered_jobs and the exact
        task filter/sort of _pending_tasks."""
        pending_map = job.task_status_index.get(TaskStatus.PENDING)
        eligible = bool(pending_map)
        if eligible and (job.pod_group is None
                         or job.pod_group.status.phase
                         == PodGroupPhase.PENDING):
            eligible = False
        if eligible:
            vr = ssn.job_valid(job)
            if vr is not None and not vr.passed:
                eligible = False
        if eligible and job.queue not in ssn.queues:
            eligible = False
        if not eligible:
            return {"ver": job.flat_version, "eligible": False}
        tasks = [t for t in pending_map.values()
                 if not t.resreq.is_empty()]  # BestEffort is backfill's
        if len(tasks) > 1:
            tasks.sort(key=taskkey)
            self.sorts_performed += 1
        return {"ver": job.flat_version, "eligible": True,
                "ns": job.namespace, "queue": job.queue,
                "key": jobkey(job), "tasks": tasks}

    def _index_insert(self, ent: dict, uid: str) -> None:
        lst = self._ns_queues.setdefault(
            ent["ns"], {}).setdefault(ent["queue"], [])
        insort(lst, (ent["key"], uid))

    def _index_remove(self, ent: dict, uid: str) -> None:
        lst = self._ns_queues.get(ent["ns"], {}).get(ent["queue"])
        item = (ent["key"], uid)
        if lst:
            i = bisect_left(lst, item)
            if i < len(lst) and lst[i] == item:
                del lst[i]
                return
        raise _Decline("index_drift")

    # -- the walk -----------------------------------------------------------

    def _walk(self, ssn) -> list:
        """namespace -> queue -> job interleave over the sorted indexes.
        Identical yield order to _ordered_jobs' heap walk because every
        dispatcher it consults (namespace_order_fn, queue_order_fn,
        overused, the job keys) is a strict total order frozen for the
        collection: the heap's pop-one-push-back loop degenerates to
        draining namespaces in namespace order, each namespace's
        non-overused queues in queue order, each queue's jobs in key
        order."""
        jobs = ssn.jobs
        entries = self._entries
        ns_items = [(ns, qmap) for ns, qmap in self._ns_queues.items()
                    if any(qmap.values())]
        if len(ns_items) > 1:
            def ns_cmp(a, b):
                if ssn.namespace_order_fn(a[0], b[0]):
                    return -1
                if ssn.namespace_order_fn(b[0], a[0]):
                    return 1
                return 0
            ns_items.sort(key=cmp_to_key(ns_cmp))
        out = []
        for _ns, qmap in ns_items:
            qis = []
            for qname, lst in qmap.items():
                if not lst:
                    continue
                qi = ssn.queues.get(qname)
                if qi is None:
                    # an entry's queue vanished without the queue-event
                    # revalidation catching it: don't guess, full sort
                    raise _Decline("queue_membership")
                if ssn.overused(qi):
                    continue
                qis.append(qi)
            if len(qis) > 1:
                def q_cmp(a, b):
                    if ssn.queue_order_fn(a, b):
                        return -1
                    if ssn.queue_order_fn(b, a):
                        return 1
                    return 0
                qis.sort(key=cmp_to_key(q_cmp))
            for qi in qis:
                for _key, uid in qmap[qi.name]:
                    job = jobs.get(uid)
                    if job is None:
                        raise _Decline("membership_drift")
                    out.append((job, entries[uid]["tasks"]))
        return out

    # -- cycle entry points -------------------------------------------------

    def collect(self, ssn) -> Optional[List[tuple]]:
        """The ordering pass: [(job, sorted pending tasks), ...] in the
        session's namespace/queue/job/task order, or None when the active
        conf is comparator-only and the caller must run the live walk.
        Consumes the ledger like FlattenCache's flatten (PR-11
        discipline); the result's task lists are cache-owned — callers
        must not mutate them (the allocate action hands them straight to
        the flatten, which makes the same demand)."""
        jobkey = ssn.full_order_key("job_order_fns")
        taskkey = ssn.full_order_key("task_order_fns", ct_of=_task_ct)
        if jobkey is None or taskkey is None:
            self._note("legacy", "comparator_only", 0)
            return None
        sig, ctx = self._signature(ssn)
        taken = self._take()
        result = None
        reason = None
        patched = 0
        if self._primed:
            try:
                result, mode, patched = self._collect_event(
                    ssn, taken, sig, ctx, jobkey, taskkey)
            except _Decline as d:
                reason = d.reason
        else:
            reason = "cold_start"
        if result is None:
            result = self._rebuild(ssn, jobkey, taskkey)
            mode = "full"
            patched = len(self._entries)
        self._consume(taken)
        self._primed = True
        self._sig, self._ctx = sig, ctx
        self._queue_names = frozenset(ssn.queues)
        self._last_walk = result
        self._note(mode, reason, patched)
        return result

    def _collect_event(self, ssn, taken, sig, ctx, jobkey, taskkey):
        if taken["broken"]:
            raise _Decline(taken["broken"])
        if getattr(ssn, "_mutation_ops", 0):
            # an earlier action already mutated the session's clones;
            # those deltas never reached this ledger
            raise _Decline("session_mutations")
        if sig != self._sig:
            raise _Decline("conf_reload")
        if ctx != self._ctx:
            raise _Decline("key_context")
        if (taken["feed"] - self._prev_feed) \
                != (taken["seq"] - self._prev_seq):
            # the consistency epoch: a delta was observed but never
            # marked (or marked twice) — the ledger cannot be trusted
            raise _Decline("epoch_mismatch")
        if taken["queue_event"]:
            if frozenset(ssn.queues) != self._queue_names:
                raise _Decline("queue_membership")
        if (taken["feed"] == self._prev_feed and not taken["jobs"]
                and self._last_walk is not None
                and len(self._entries) == len(ssn.jobs)
                and not ssn._tier_fns("namespace_order_fns")):
            # a genuinely quiet cycle: zero deltas of any kind since the
            # last collect, so every input to the walk (entries, queue
            # attrs, overuse) is unchanged — reuse the previous walk
            # object outright. Declined when namespace-order providers
            # are active: their inputs (resource quotas) are not part of
            # this ledger's feed.
            self.walks_reused += 1
            return self._last_walk, "reuse", 0
        entries = self._entries
        patched = 0
        for uid in taken["jobs"]:
            old = entries.pop(uid, None)
            if old is not None and old["eligible"]:
                self._index_remove(old, uid)
            job = ssn.jobs.get(uid)
            if job is None:
                continue  # departed (or not in this snapshot's job set)
            ent = self._entry(ssn, job, jobkey, taskkey)
            entries[uid] = ent
            if ent["eligible"]:
                self._index_insert(ent, uid)
            patched += 1
        if len(entries) != len(ssn.jobs):
            # a job entered/left the snapshot without a mark — the
            # catch-all seam should make this impossible; don't guess
            raise _Decline("membership_drift")
        return self._walk(ssn), "event", patched

    def _rebuild(self, ssn, jobkey, taskkey) -> list:
        """The full sort: recompute every entry and queue index from the
        live session — trusts nothing, same yield order as the live
        comparator walk."""
        entries: Dict[str, dict] = {}
        nsq: Dict[str, Dict[str, list]] = {}
        for uid, job in ssn.jobs.items():
            ent = self._entry(ssn, job, jobkey, taskkey)
            entries[uid] = ent
            if ent["eligible"]:
                nsq.setdefault(ent["ns"], {}).setdefault(
                    ent["queue"], []).append((ent["key"], uid))
        for qmap in nsq.values():
            for lst in qmap.values():
                if len(lst) > 1:
                    lst.sort()
                    self.sorts_performed += 1
        self._entries = entries
        self._ns_queues = nsq
        return self._walk(ssn)

    def _note(self, mode: str, reason: Optional[str],
              patched: int) -> None:
        self.last_mode = mode
        self.last_reason = reason
        self.last_entries_patched = patched
        if reason is not None:
            self.fallback_counts[reason] = \
                self.fallback_counts.get(reason, 0) + 1

    def invalidate(self, reason: str = "invalidated") -> None:
        """Hard reset after an unexpected error: drop every cached
        structure and re-baseline the ledger; the next keyed collect
        rebuilds from scratch (``cold_start``). The caller's degradation
        contract: an ordering-cache bug costs one comparator-walk cycle,
        never a contained allocate action."""
        with self._lock:
            self._dirty_jobs.clear()
            self._prev_feed = self._feed
            self._prev_seq = self._seq
            self._queue_event = False
            self._broken = None
        self._primed = False
        self._entries = {}
        self._ns_queues = {}
        self._last_walk = None
        self._ctx_memo = None
        self._note("legacy", reason, 0)

    # -- shared pending-task lists ------------------------------------------

    def pending_tasks(self, ssn, job) -> Optional[list]:
        """A COPY of ``job``'s cached sorted pending list, or None when
        the entry is missing/stale or this session's task-order providers
        or contexts differ from the cache's. Version-gated on the session
        clone's flat_version, so any mutation since the entry was cut
        (binds, evictions, watch deliveries) is an automatic miss — safe
        to call from any action at any point in the cycle (preempt/
        reclaim claimer collection, the host allocate loop)."""
        if not self._primed:
            return None
        memo = self._ctx_memo
        if memo is None or memo[0] is not ssn:
            ok = False
            if self._sig is not None and ssn.full_order_key(
                    "task_order_fns", ct_of=_task_ct) is not None:
                sig, ctx = self._signature(ssn)
                ok = sig == self._sig and ctx == self._ctx
            memo = (ssn, ok)
            self._ctx_memo = memo
        if not memo[1]:
            return None
        ent = self._entries.get(job.uid)
        if ent is None or not ent["eligible"] \
                or ent["ver"] != job.flat_version:
            return None
        return list(ent["tasks"])
