"""Event-sourced ordering: scheduler-level wiring, the quiet-cluster
zero-work contract, the order_event fault-injection ladder, every typed
fallback, and the seeded churn matrix asserting the incremental order is
element-for-element identical to the full sort every cycle:
tests/test_order_events.py through the port on the CPU
(``device="cpu"``), with the reference's own expectations.

Where a test drives whole cycles, a JAX-package Scheduler follows the
same store (``torch_helpers.JaxTwin``, the same faults armed in its own
injector) and each cycle's binds, ordering mode and fallback reason
equal the port's (exact). The 40-cycle churn matrix holds the port to
its own full sort, as the reference holds itself (a JAX twin there
costs ~20 s of jitted cycles, a third of the file's time limit).
TestBenchConfig runs bench.py's
cycle_start_scale scenario through the port (the port has no benchmark
yet), its cycles held to a JAX twin.
"""

import pytest

pytest.importorskip("jax")  # the JAX reference: absent on the card's machine

from volcano_tpu_torch.actions.allocate import AllocateAction  # noqa: E402
from volcano_tpu_torch.api import TaskStatus  # noqa: E402
from volcano_tpu_torch.cache import (  # noqa: E402
    FakeBinder, FakeEvictor, SchedulerCache,
)
from volcano_tpu_torch.client import ClusterStore  # noqa: E402
from volcano_tpu_torch.framework import (  # noqa: E402
    close_session, open_session,
)
from volcano_tpu_torch.models import PodGroupPhase, PriorityClass  # noqa
from volcano_tpu_torch.scheduler import Scheduler  # noqa: E402

from torch_helpers import Builders, JaxTwin  # noqa: E402

_B = Builders("torch")
build_node = _B.build_node
build_pod = _B.build_pod
build_pod_group = _B.build_pod_group
build_queue = _B.build_queue

LADDER_KEYS = ("order_mode", "order_fallback_reason")


def cycle_both(sched, twin, ladder=True):
    """One cycle of the port's Scheduler and of its JAX twin: the same
    binds and, with ``ladder``, the same ordering mode and reason."""
    jt = twin.cycle(sched)
    t = sched.last_cycle_timing
    assert sched.cache.binder.binds == twin.cache.binder.binds
    if ladder:
        assert [t.get(k) for k in LADDER_KEYS] \
            == [jt.get(k) for k in LADDER_KEYS]
    return t


def _rig(n_nodes=12, node_cpu="8", n_queues=2):
    store = ClusterStore()
    cache = SchedulerCache(store, device="cpu")
    cache.binder = FakeBinder()
    cache.evictor = FakeEvictor()
    cache.run()
    for i in range(n_queues):
        store.apply("queues", build_queue(f"q{i}", weight=i + 1))
    for i in range(n_nodes):
        store.create("nodes", build_node(
            f"n{i}", {"cpu": node_cpu, "memory": "32Gi"}))
    return store, cache


def _wave(store, k, cpu="20", members=2, queue=None, ns="b",
          priority=None, priority_class=""):
    """members pods of cpu each; cpu > node capacity => a stable
    unschedulable backlog (pending every cycle, no store churn)."""
    pg = build_pod_group(f"j{k}", ns, min_member=members,
                         queue=queue or f"q{k % 2}")
    pg.status.phase = PodGroupPhase.PENDING
    if priority_class:
        pg.spec.priority_class_name = priority_class
    store.create("podgroups", pg)
    for i in range(members):
        store.create("pods", build_pod(
            ns, f"j{k}-{i}", "", "Pending",
            {"cpu": cpu, "memory": "1Gi"}, f"j{k}", priority=priority))


def _legacy_collect(action, ssn):
    """The live comparator/full-sort reference: _ordered_jobs + a
    from-scratch pending sort that never consults the OrderCache."""
    taskkey = ssn.full_order_key(
        "task_order_fns", ct_of=lambda t: t.pod.creation_timestamp)
    out = []
    for job in action._ordered_jobs(ssn):
        pending = [
            t for t in job.task_status_index.get(
                TaskStatus.PENDING, {}).values()
            if not t.resreq.is_empty()]
        if taskkey is not None:
            pending.sort(key=taskkey)
        else:
            from volcano_tpu_torch.utils import PriorityQueue
            pq = PriorityQueue(ssn.task_order_fn)
            for t in pending:
                pq.push(t)
            pending = []
            while not pq.empty():
                pending.append(pq.pop())
        out.append((job, pending))
    return out


def _order_ids(collected):
    return [(j.uid, [t.uid for t in ts]) for j, ts in collected]


class TestSchedulerWiring:
    def test_watch_hooks_feed_order_ledger(self):
        store, cache = _rig()
        oc = cache.order_cache
        before = oc._feed
        _wave(store, 0)
        assert oc._feed > before  # pod/podgroup deliveries observed
        assert "b/j0" in oc._dirty_jobs

    def test_cycle_reports_order_mode_and_ladder(self):
        store, cache = _rig()
        for k in range(4):
            _wave(store, k)
        sched = Scheduler(cache)
        twin = JaxTwin(store)
        t = cycle_both(sched, twin)
        assert t.get("order_mode") == "full"
        assert t.get("order_fallback_reason") == "cold_start"
        assert "order_ms" in t
        t = cycle_both(sched, twin)
        # condition writes from cycle 0 arrive as deltas; patched in place
        assert t.get("order_mode") == "event"
        assert t.get("order_entries_patched", 0) > 0
        t = cycle_both(sched, twin)
        # nothing changed since: the previous walk object is reused
        assert t.get("order_mode") == "reuse"
        assert t.get("order_entries_patched") == 0.0

    def test_pending_membership_stays_on_event_path(self):
        """A new schedulable wave changes the pending-problem membership
        — the FLATTEN must re-diff (job_layout), but the ordering ledger
        handles membership by construction and stays on the event path."""
        store, cache = _rig()
        for k in range(4):
            _wave(store, k)
        sched = Scheduler(cache)
        twin = JaxTwin(store)
        cycle_both(sched, twin)
        cycle_both(sched, twin)
        _wave(store, 10, cpu="1")
        t = cycle_both(sched, twin)
        assert t.get("order_mode") == "event"
        assert t.get("flatten_mode") in ("incremental", "cold")
        assert len(cache.binder.binds) == 2  # the wave actually bound

    def test_metrics_family_exported(self):
        from volcano_tpu_torch.metrics import metrics

        store, cache = _rig()
        for k in range(3):
            _wave(store, k)
        sched = Scheduler(cache)
        base_ev = metrics.order_cycles_total.get({"mode": "event"})
        base_full = metrics.order_cycles_total.get({"mode": "full"})
        for _ in range(3):
            sched.run_once()
        assert metrics.order_cycles_total.get(
            {"mode": "full"}) >= base_full + 1
        assert metrics.order_cycles_total.get(
            {"mode": "event"}) >= base_ev + 1
        exposition = metrics.registry.expose()
        assert "volcano_order_cycles_total" in exposition
        assert "volcano_order_entries_patched" in exposition
        assert "volcano_order_fallbacks_total" in exposition

    def test_mutating_action_before_allocate_stands_down(self):
        """A conf ordering preempt before allocate mutates the session's
        clones outside the ledger's sight: the ordering pass must fall
        back to the full sort for that cycle (same odometer the flatten
        uses)."""
        conf = """
actions: "enqueue, preempt, allocate"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: conformance
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
  - name: binpack
"""
        store, cache = _rig(n_nodes=2, node_cpu="4")
        store.create("priorityclasses", PriorityClass("high-priority", 1000))
        low_pg = build_pod_group("low", "b", min_member=2, queue="q0")
        low_pg.status.phase = PodGroupPhase.RUNNING
        store.create("podgroups", low_pg)
        for i in range(2):
            store.create("pods", build_pod(
                "b", f"low-{i}", f"n{i}", "Running",
                {"cpu": "4", "memory": "1Gi"}, "low"))
        _wave(store, 0, cpu="20")
        sched = Scheduler(cache, scheduler_conf=conf)
        sched.run_once()
        sched.run_once()
        assert sched.last_cycle_timing.get("order_mode") in (
            "event", "reuse")
        high_pg = build_pod_group("high", "b", min_member=1, queue="q0")
        high_pg.spec.priority_class_name = "high-priority"
        high_pg.status.phase = PodGroupPhase.PENDING
        store.create("podgroups", high_pg)
        store.create("pods", build_pod(
            "b", "high-0", "", "Pending",
            {"cpu": "4", "memory": "1Gi"}, "high", priority=1000))
        sched.run_once()
        t = sched.last_cycle_timing
        assert t.get("order_mode") == "full"
        assert t.get("order_fallback_reason") == "session_mutations"


class TestQuietCluster:
    def test_zero_event_cycle_zero_resorts_and_reuse(self):
        """The quiet-cluster regression contract: a cycle with no mirror
        deltas performs zero re-sorts, patches zero entries, and reuses
        the previous walk result object AND its per-job task list
        objects."""
        store, cache = _rig()
        for k in range(5):
            _wave(store, k)
        sched = Scheduler(cache)
        oc = cache.order_cache
        for _ in range(3):
            sched.run_once()
        assert sched.last_cycle_timing.get("order_mode") == "reuse"
        prior_walk = oc._last_walk
        prior_tasks = [ts for _, ts in prior_walk]
        sorts_before = oc.sorts_performed
        reused_before = oc.walks_reused
        from volcano_tpu_torch.metrics import metrics
        patched_before = metrics.order_entries_patched_total.get()
        for _ in range(3):
            sched.run_once()
            t = sched.last_cycle_timing
            assert t.get("order_mode") == "reuse"
            assert t.get("order_entries_patched") == 0.0
            assert t.get("order_ms", 1e9) < 1e9
        # zero re-sorts, the walk object survived, task lists identical
        assert oc.sorts_performed == sorts_before
        assert oc.walks_reused == reused_before + 3
        assert oc._last_walk is prior_walk
        assert all(ts is pts for (_, ts), pts
                   in zip(oc._last_walk, prior_tasks))
        assert metrics.order_entries_patched_total.get() == patched_before

    def test_queue_status_rewrite_is_deduped(self):
        """The queue controller must not churn the store with identical
        status syncs — its own update event re-enqueues the queue, so an
        unconditional write is a self-perpetuating loop that alone keeps
        a quiet standalone from the zero-event fast path."""
        from volcano_tpu_torch.controllers.framework import ControllerOption
        from volcano_tpu_torch.controllers.queue import QueueController

        store = ClusterStore()
        store.apply("queues", build_queue("qd"))
        qc = QueueController()
        qc.initialize(ControllerOption(cluster=store))
        qc.run()
        qc.process_all()  # first sync writes the computed status once
        rv = store._rv
        qc.queue.append("qd")
        qc.process_all()
        assert store._rv == rv  # identical status: no write, no re-loop
        assert not qc.queue


class TestFaultInjectionLadder:
    def test_dropped_order_event_detected_and_healed(self):
        """Arm order_event to drop one ordering delta: the epoch check
        must detect the skew, the cycle must fall back to the full sort
        (identical element-for-element to the live comparator walk), and
        the ledger must recover to the event path."""
        from volcano_tpu.resilience.faultinject import faults as j_faults
        from volcano_tpu_torch.resilience.faultinject import faults

        store, cache = _rig()
        for k in range(4):
            _wave(store, k)
        sched = Scheduler(cache)
        twin = JaxTwin(store)
        cycle_both(sched, twin)
        cycle_both(sched, twin)
        assert sched.last_cycle_timing.get("order_mode") in (
            "event", "reuse")
        orders = {}
        orig = AllocateAction._collect

        def checked(self, ssn):
            res = orig(self, ssn)
            orders["cached"] = _order_ids(res)
            orders["legacy"] = _order_ids(_legacy_collect(self, ssn))
            return res

        AllocateAction._collect = checked
        try:
            faults.arm_once("order_event")
            j_faults.arm_once("order_event")
            # this delivery reaches the flatten ledger but is DROPPED by
            # the armed point before the ordering mark lands (in both
            # packages: the twin follows the write)
            store.create("pods", build_pod(
                "b", "ghost", "", "Pending",
                {"cpu": "20", "memory": "1Gi"}, "j0"))
            assert faults.fired("order_event") == 1
            assert j_faults.fired("order_event") == 1
            t = cycle_both(sched, twin)
            assert t.get("order_fallback_reason") == "epoch_mismatch"
            assert t.get("order_mode") == "full"
            # no silent drift: post-fallback order == the full sort,
            # INCLUDING the dropped delta's task (j0 now has 3 pending)
            assert orders["cached"] == orders["legacy"]
            assert [len(uids) for uid, uids in orders["cached"]
                    if uid == "b/j0"] == [3]
            cycle_both(sched, twin)
            assert sched.last_cycle_timing.get("order_mode") in (
                "event", "reuse")
            assert orders["cached"] == orders["legacy"]
            from volcano_tpu_torch.metrics import metrics
            assert metrics.order_fallbacks_total.get(
                {"reason": "epoch_mismatch"}) >= 1
        finally:
            AllocateAction._collect = orig
            faults.reset()
            j_faults.reset()

    def test_duplicated_order_event_detected(self):
        from volcano_tpu.resilience.faultinject import faults as j_faults
        from volcano_tpu_torch.resilience.faultinject import faults

        store, cache = _rig()
        for k in range(3):
            _wave(store, k)
        sched = Scheduler(cache)
        twin = JaxTwin(store)
        cycle_both(sched, twin)
        cycle_both(sched, twin)
        try:
            faults.arm_once("order_event_dup")
            j_faults.arm_once("order_event_dup")
            store.create("pods", build_pod(
                "b", "dup-ghost", "", "Pending",
                {"cpu": "20", "memory": "1Gi"}, "j1"))
            assert faults.fired("order_event_dup") == 1
            assert j_faults.fired("order_event_dup") == 1
            t = cycle_both(sched, twin)
            assert t.get("order_fallback_reason") == "epoch_mismatch"
            assert t.get("order_mode") == "full"
            cycle_both(sched, twin)
            assert sched.last_cycle_timing.get("order_mode") in (
                "event", "reuse")
        finally:
            faults.reset()
            j_faults.reset()

    def test_drop_unit_level(self):
        """Unit: the ledger counters skew on a drop and the next collect
        declines; consuming re-baselines the epoch."""
        from volcano_tpu_torch.ops.ordering import OrderCache
        from volcano_tpu_torch.resilience.faultinject import faults

        oc = OrderCache()
        oc.feed_event("pod", "add", job="a/j")
        assert (oc._feed, oc._seq) == (1, 1)
        try:
            faults.arm_once("order_event")
            oc.feed_event("pod", "add", job="a/k")
        finally:
            faults.reset()
        assert oc._feed == 2 and oc._seq == 1  # observed, never marked
        taken = oc._take()
        assert (taken["feed"] - oc._prev_feed) \
            != (taken["seq"] - oc._prev_seq)
        oc._consume(taken)
        assert (oc._prev_feed, oc._prev_seq) == (2, 1)


class TestFallbackLadder:
    def _primed(self, n_waves=4):
        store, cache = _rig()
        for k in range(n_waves):
            _wave(store, k)
        sched = Scheduler(cache)
        sched.run_once()
        sched.run_once()
        return store, cache, sched

    def test_comparator_only_stands_down(self):
        """An order provider without a key extractor: the cache stands
        down (caller runs the live comparator walk) and resumes
        incrementally once keys are back."""
        store, cache, sched = self._primed()
        ssn = open_session(cache, sched.tiers, sched.configurations)
        try:
            ssn.order_key_fns["job_order_fns"].pop("priority")
            oc = cache.order_cache
            res = oc.collect(ssn)
            assert res is None
            assert oc.last_mode == "legacy"
            assert oc.last_reason == "comparator_only"
            # the allocate collection falls back to the comparator walk
            # and still produces the full order
            action = AllocateAction()
            collected = action._collect(ssn)
            assert _order_ids(collected) == _order_ids(
                _legacy_collect(action, ssn))
        finally:
            close_session(ssn)
        # marks kept accruing while stood down: the next keyed cycle
        # resumes on the event path, not a cold rebuild
        _wave(store, 90)
        sched.run_once()
        assert sched.last_cycle_timing.get("order_mode") == "event"

    def test_conf_reload_swapping_order_plugins(self):
        store, cache, sched = self._primed()
        no_priority = """
actions: "enqueue, allocate, backfill"
tiers:
- plugins:
  - name: gang
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
"""
        sched._conf_text = no_priority
        sched.run_once()
        t = sched.last_cycle_timing
        assert t.get("order_mode") == "full"
        assert t.get("order_fallback_reason") == "conf_reload"
        sched.run_once()
        assert sched.last_cycle_timing.get("order_mode") in (
            "event", "reuse")

    def test_priority_class_edit_is_key_context(self):
        """Editing a priority class changes job keys WITHOUT any per-job
        event (clone priority is re-resolved at snapshot): the priority
        plugin's declared key context must catch it."""
        store, cache, sched = self._primed()
        store.create("priorityclasses", PriorityClass("bump", 500))
        sched.run_once()  # the create itself: no order providers read it yet
        _wave(store, 50, priority_class="bump", priority=500)
        for _ in range(3):  # consume the wave + its condition writes
            sched.run_once()
        assert sched.last_cycle_timing.get("order_mode") == "reuse"
        # now EDIT the class value: zero job events, keys move anyway
        store.apply("priorityclasses", PriorityClass("bump", 2000))
        orders = {}
        orig = AllocateAction._collect

        def checked(self, ssn):
            res = orig(self, ssn)
            orders["cached"] = _order_ids(res)
            orders["legacy"] = _order_ids(_legacy_collect(self, ssn))
            return res

        AllocateAction._collect = checked
        try:
            sched.run_once()
        finally:
            AllocateAction._collect = orig
        t = sched.last_cycle_timing
        assert t.get("order_mode") == "full"
        assert t.get("order_fallback_reason") == "key_context"
        assert orders["cached"] == orders["legacy"]
        # the bumped job now outranks everything in its queue
        first_uid = orders["cached"][0][0]
        assert first_uid == "b/j50"

    def test_node_respec_is_key_context_for_drf(self):
        """drf's share key depends on the cluster total: a node respec
        (no job events at all) must invalidate cached share orderings via
        the declared context."""
        store, cache, sched = self._primed()
        sched.run_once()
        assert sched.last_cycle_timing.get("order_mode") == "reuse"
        store.apply("nodes", build_node(
            "n0", {"cpu": "64", "memory": "256Gi"}))
        sched.run_once()
        t = sched.last_cycle_timing
        assert t.get("order_mode") == "full"
        assert t.get("order_fallback_reason") == "key_context"
        sched.run_once()
        assert sched.last_cycle_timing.get("order_mode") in (
            "event", "reuse")

    def test_queue_membership_change_falls_back(self):
        """A job referencing a queue that does not exist yet is skipped
        with NO job-level event when the queue later appears — the queue
        event must force the full sort, which picks the job up."""
        store, cache, sched = self._primed()
        twin = JaxTwin(store)  # the primed cluster: waves, no binds
        _wave(store, 70, cpu="1", queue="qx")  # queue qx doesn't exist
        twin.cycle(sched)  # the twin's first cycle is its cold start
        cycle_both(sched, twin)
        assert len(cache.binder.binds) == 0  # unknown queue: never placed
        store.apply("queues", build_queue("qx", weight=5))
        t = cycle_both(sched, twin)
        assert t.get("order_mode") == "full"
        assert t.get("order_fallback_reason") == "queue_membership"
        assert len(cache.binder.binds) == 2  # the job scheduled
        sched.run_once()
        assert sched.last_cycle_timing.get("order_mode") in (
            "event", "reuse")


class TestErrorContainment:
    def test_order_cache_error_degrades_not_contains(self):
        """An unexpected OrderCache failure must cost one comparator-walk
        cycle (hard reset + legacy collection), never a contained
        allocate action."""
        store, cache = _rig()
        for k in range(3):
            _wave(store, k)
        _wave(store, 9, cpu="1")  # something that actually binds
        sched = Scheduler(cache)
        twin = JaxTwin(store)
        cycle_both(sched, twin)
        cycle_both(sched, twin)
        oc = cache.order_cache

        def boom(ssn):
            raise RuntimeError("synthetic order-cache bug")

        oc.collect = boom
        _wave(store, 30, cpu="1")
        # the legacy walk binds what the JAX twin's healthy cache binds
        t = cycle_both(sched, twin, ladder=False)
        assert "allocate_error" not in t  # degraded, not contained
        assert t.get("order_mode") == "legacy"
        assert t.get("order_fallback_reason") == "order_cache_error"
        assert len(cache.binder.binds) == 4  # the new wave still bound
        del oc.collect  # back to the class method
        sched.run_once()
        t = sched.last_cycle_timing
        assert t.get("order_mode") == "full"  # hard reset: cold rebuild
        assert t.get("order_fallback_reason") == "cold_start"
        sched.run_once()
        assert sched.last_cycle_timing.get("order_mode") in (
            "event", "reuse")


class TestSharedPendingLists:
    def test_claimer_collection_identical_with_and_without_cache(self):
        from volcano_tpu_torch.actions.evict_solver import collect_claimer_jobs

        store, cache = _rig()
        for k in range(4):
            _wave(store, k)
        sched = Scheduler(cache)
        sched.run_once()
        sched.run_once()
        ssn = open_session(cache, sched.tiers, sched.configurations)
        try:
            assert ssn.order_cache is not None
            with_cache = collect_claimer_jobs(ssn, False, False)
            # at least one job must actually have served from the cache
            served = [j for j, _ in with_cache
                      if ssn.order_cache.pending_tasks(ssn, j) is not None]
            assert served
            ssn.order_cache = None
            without = collect_claimer_jobs(ssn, False, False)
            assert _order_ids(with_cache) == _order_ids(without)
        finally:
            ssn.order_cache = cache.order_cache
            close_session(ssn)


class TestOrderIdentityChurnMatrix:
    def test_40_cycle_seeded_churn_identical_to_full_sort(self):
        """40 real Scheduler cycles over a seeded churn matrix — job
        add/remove, priority flips, queue overuse transitions (binding
        waves saturating small queues), task phase changes, a
        priority-class value edit, and a conf hot-reload swapping order
        plugins — asserting the incremental order equals the full sort
        element-for-element EVERY cycle."""
        import random

        rng = random.Random(14)
        store, cache = _rig(n_nodes=8, node_cpu="8", n_queues=3)
        store.create("priorityclasses", PriorityClass("churn-high", 900))
        for k in range(10):
            _wave(store, k, cpu="20", members=2, queue=f"q{k % 3}")
        sched = Scheduler(cache)
        sched.run_once()

        conf_alt = """
actions: "enqueue, allocate, backfill"
tiers:
- plugins:
  - name: gang
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
"""
        mismatch = []
        modes = []
        orig = AllocateAction._collect

        def checked(self, ssn):
            res = orig(self, ssn)
            a = _order_ids(res)
            b = _order_ids(_legacy_collect(self, ssn))
            if a != b:
                mismatch.append((len(modes), a, b))
            return res

        AllocateAction._collect = checked
        next_id = [100]
        live = []
        try:
            for cycle in range(40):
                roll = rng.random()
                if roll < 0.25:  # job add (some schedulable => binds,
                    k = next_id[0]  # phase changes, queue overuse churn)
                    next_id[0] += 1
                    cpu = rng.choice(["1", "2", "20"])
                    _wave(store, k, cpu=cpu, members=2,
                          queue=f"q{rng.randrange(3)}",
                          priority_class=rng.choice(["", "churn-high"]),
                          priority=900 if rng.random() < 0.3 else None)
                    live.append(k)
                elif roll < 0.45 and live:  # job remove
                    k = live.pop(rng.randrange(len(live)))
                    for i in range(2):
                        try:
                            store.delete("pods", f"j{k}-{i}", "b")
                        except Exception:  # noqa: BLE001 — may be bound
                            pass
                    store.delete("podgroups", f"j{k}", "b")
                elif roll < 0.65:  # priority flip on a backlog job
                    k = rng.randrange(10)
                    pg = store.get("podgroups", f"j{k}", "b")
                    pg.spec.priority_class_name = \
                        "" if pg.spec.priority_class_name \
                        else "churn-high"
                    store.apply("podgroups", pg)
                elif roll < 0.8:  # min_member flip
                    k = rng.randrange(10)
                    pg = store.get("podgroups", f"j{k}", "b")
                    pg.spec.min_member = 1 + (pg.spec.min_member % 3)
                    store.apply("podgroups", pg)
                # structural pokes at fixed cycles
                if cycle == 15:
                    store.apply("priorityclasses",
                                PriorityClass("churn-high", 1500))
                if cycle == 25:
                    sched._conf_text = conf_alt
                sched.run_once()
                modes.append(
                    (sched.last_cycle_timing.get("order_mode"),
                     sched.last_cycle_timing.get(
                         "order_fallback_reason")))
        finally:
            AllocateAction._collect = orig
        assert not mismatch, mismatch[:1]
        seen_modes = {m for m, _ in modes}
        reasons = {r for _, r in modes if r}
        # the matrix exercised both the fast path and the ladder
        assert "event" in seen_modes
        assert "full" in seen_modes
        assert "key_context" in reasons      # the class edit at cycle 15
        assert "conf_reload" in reasons      # the swap at cycle 25


def cycle_start_scale(n_nodes, n_jobs, tpj, steady_cycles, quiet_cycles):
    """bench.py's cycle_start_scale scenario through the port: two
    identical rigs (a stable unschedulable backlog of ``n_jobs`` gangs of
    ``tpj`` 20-cpu pods over 8-cpu nodes, the same seeded churn script:
    min_member and priority-class flips and one schedulable 2-pod wave a
    cycle), one on the OrderCache and one on the full sort; the cached
    arm's every cycle is held to a JAX twin. Returns the structure
    bench.py reports, without timings."""
    def rig(use_order_cache):
        store = ClusterStore()
        cache = SchedulerCache(store, device="cpu")
        cache.binder = FakeBinder()
        cache.evictor = FakeEvictor()
        if not use_order_cache:
            cache.order_cache = None
        cache.run()
        for i in range(3):
            store.apply("queues", build_queue(f"q{i}", weight=i + 1))
        store.create("priorityclasses", PriorityClass("cyc-high", 1000))
        for i in range(n_nodes):
            store.create("nodes", build_node(
                f"n{i}", {"cpu": "8", "memory": "64Gi"}))
        for k in range(n_jobs):
            pg = build_pod_group(f"j{k}", "bench", min_member=tpj,
                                 queue=f"q{k % 3}")
            pg.status.phase = PodGroupPhase.PENDING
            store.create("podgroups", pg)
            for i in range(tpj):
                store.create("pods", build_pod(
                    "bench", f"j{k}-{i}", "", "Pending",
                    {"cpu": "20", "memory": "1Gi"}, f"j{k}"))
        return store, cache, Scheduler(cache)

    def churn(store, s):
        for d in range(max(n_jobs // 100, 1)):
            k = (s * 7 + d * 13) % n_jobs
            pg = store.get("podgroups", f"j{k}", "bench")
            pg.spec.min_member = 1 + (s + d) % tpj
            store.apply("podgroups", pg)
        for d in range(2):
            k = (s * 11 + d * 17) % n_jobs
            pg = store.get("podgroups", f"j{k}", "bench")
            pg.spec.priority_class_name = \
                "" if pg.spec.priority_class_name else "cyc-high"
            store.apply("podgroups", pg)
        pg = build_pod_group(f"w{s}", "bench", min_member=2,
                             queue=f"q{s % 3}")
        pg.status.phase = PodGroupPhase.PENDING
        store.create("podgroups", pg)
        for i in range(2):
            store.create("pods", build_pod(
                "bench", f"w{s}-{i}", "", "Pending",
                {"cpu": "1", "memory": "1Gi"}, f"w{s}"))

    def run_arm(use_order_cache):
        store, cache, sched = rig(use_order_cache)
        twin = JaxTwin(store) if use_order_cache else None

        def cycle():
            if twin is not None:
                return cycle_both(sched, twin)
            sched.run_once()
            return sched.last_cycle_timing

        cycle()  # cold burst
        cycle()  # settle the first cycle's status writes
        oc = cache.order_cache
        modes, quiet_modes = {}, {}
        for s in range(steady_cycles):
            churn(store, s)
            m = cycle().get("order_mode", "legacy")
            modes[m] = modes.get(m, 0) + 1
        cycle()  # settle the last wave's writes
        cycle()
        quiet_patched = 0.0
        sorts_before = oc.sorts_performed if oc is not None else 0
        for _ in range(quiet_cycles):
            t = cycle()
            m = t.get("order_mode", "legacy")
            quiet_modes[m] = quiet_modes.get(m, 0) + 1
            quiet_patched += t.get("order_entries_patched", 0.0)
        return {"steady_modes": modes, "quiet_modes": quiet_modes,
                "quiet_entries_patched": quiet_patched,
                "quiet_sorts": (oc.sorts_performed - sorts_before)
                if oc is not None else -1,
                "binds": list(cache.binder.channel)}

    cached, legacy = run_arm(True), run_arm(False)
    return {"event_sourced": cached, "full_sort": legacy,
            "binds_identical": cached["binds"] == legacy["binds"],
            "binds_compared": len(cached["binds"])}


class TestBenchConfig:
    def test_cycle_start_scale_smoke(self):
        """CPU-smoke run of the bench config at toy scale: structure,
        bind-for-bind identity, and the quiet-cycle zero-work
        contract (the >=3x speedup floor is only meaningful at full
        scale and is not asserted here)."""
        r = cycle_start_scale(n_nodes=40, n_jobs=20, tpj=2,
                              steady_cycles=4, quiet_cycles=3)
        assert r["binds_identical"]
        assert r["binds_compared"] > 0
        ev = r["event_sourced"]
        assert set(ev["steady_modes"]) == {"event"}
        assert set(ev["quiet_modes"]) == {"reuse"}
        assert ev["quiet_entries_patched"] == 0.0
        assert ev["quiet_sorts"] == 0
        assert set(r["full_sort"]["steady_modes"]) == {"legacy"}
