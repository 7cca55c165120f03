"""Session/Statement/tier-dispatch tests: tests/test_framework.py
through the port, every cache on ``device="cpu"``. Tolerance: exact."""

import pytest

from volcano_tpu_torch.api import TaskStatus
from volcano_tpu_torch.cache import FakeBinder, FakeEvictor, SchedulerCache
from volcano_tpu_torch.client import ClusterStore
from volcano_tpu_torch.conf import PluginOption, Tier
from volcano_tpu_torch.framework import (
    Arguments, EventHandler, Plugin, ValidateResult, close_session,
    open_session, register_plugin_builder,
)
from volcano_tpu_torch.utils import PriorityQueue

from torch_helpers import Builders

_B = Builders("torch")
build_node, build_pod, build_pod_group = _B.build_node, _B.build_pod, _B.build_pod_group


def make_session(tiers, pods=2, min_member=2):
    store = ClusterStore()
    cache = SchedulerCache(store, device="cpu")
    cache.binder = FakeBinder()
    cache.evictor = FakeEvictor()
    cache.run()
    store.create("nodes", build_node("n1", {"cpu": "8", "memory": "16Gi"}))
    store.create("podgroups", build_pod_group("pg1", "ns1", min_member=min_member))
    for i in range(pods):
        store.create("pods", build_pod("ns1", f"p{i}", "", "Pending",
                                       {"cpu": "1", "memory": "1Gi"}, "pg1"))
    return store, cache, open_session(cache, tiers)


class _RecorderPlugin(Plugin):
    """Registers order fns and records session-open/close calls."""

    opened = 0
    closed = 0

    def __init__(self, args: Arguments):
        self.args = args

    def name(self):
        return "recorder"

    def on_session_open(self, ssn):
        _RecorderPlugin.opened += 1
        ssn.add_task_order_fn("recorder", lambda l, r:
                              -1 if l.priority > r.priority else
                              (1 if l.priority < r.priority else 0))

    def on_session_close(self, ssn):
        _RecorderPlugin.closed += 1


register_plugin_builder("recorder", _RecorderPlugin)


class TestSessionLifecycle:
    def test_open_close_calls_plugins(self):
        tiers = [Tier(plugins=[PluginOption(name="recorder")])]
        before_open = _RecorderPlugin.opened
        store, cache, ssn = make_session(tiers)
        assert _RecorderPlugin.opened == before_open + 1
        assert len(ssn.jobs) == 1 and len(ssn.nodes) == 1
        close_session(ssn)
        assert _RecorderPlugin.closed >= 1
        assert not ssn.jobs and not ssn.plugins

    def test_job_valid_vetoes_via_dispatch(self):
        # openSession does NOT filter (the reference's filter runs before
        # plugins register, so it never fires); actions consult job_valid
        class Rejector(Plugin):
            def __init__(self, args):
                pass

            def name(self):
                return "rejector"

            def on_session_open(self, ssn):
                ssn.add_job_valid_fn("rejector", lambda job: ValidateResult(
                    False, "NotEnoughTasks", "job rejected"))

            def on_session_close(self, ssn):
                pass

        register_plugin_builder("rejector", Rejector)
        tiers = [Tier(plugins=[PluginOption(name="rejector")])]
        store, cache, ssn = make_session(tiers)
        assert ssn.jobs  # jobs stay in the session
        vr = ssn.job_valid(ssn.jobs["ns1/pg1"])
        assert vr is not None and not vr.passed

    def test_tier_order_first_answer_wins(self):
        calls = []

        class P(Plugin):
            def __init__(self, name, answer):
                self._name, self._answer = name, answer

            def name(self):
                return self._name

            def on_session_open(self, ssn):
                def fn(l, r, me=self._name, ans=self._answer):
                    calls.append(me)
                    return ans
                ssn.add_job_order_fn(self._name, fn)

            def on_session_close(self, ssn):
                pass

        register_plugin_builder("p-decisive", lambda a: P("p-decisive", -1))
        register_plugin_builder("p-neutral", lambda a: P("p-neutral", 0))
        tiers = [Tier(plugins=[PluginOption(name="p-neutral")]),
                 Tier(plugins=[PluginOption(name="p-decisive")])]
        store, cache, ssn = make_session(tiers)
        job = next(iter(ssn.jobs.values()))
        assert ssn.job_order_fn(job, job) is True  # decisive says l < r
        assert calls == ["p-neutral", "p-decisive"]


class TestVictimDispatch:
    def _session_with(self, victim_plugins):
        tiers = []
        for i, (name, fn_builder) in enumerate(victim_plugins):
            register_plugin_builder(name, fn_builder)
            if i == 0 or True:
                tiers.append(Tier(plugins=[PluginOption(name=name)]))
        return make_session(tiers)

    def test_intersection_within_tier(self):
        class V(Plugin):
            def __init__(self, name, picks):
                self._name, self._picks = name, picks

            def name(self):
                return self._name

            def on_session_open(self, ssn):
                ssn.add_preemptable_fn(
                    self._name,
                    lambda preemptor, preemptees: [
                        t for t in preemptees if t.name in self._picks])

            def on_session_close(self, ssn):
                pass

        register_plugin_builder("v1", lambda a: V("v1", {"p0", "p1"}))
        register_plugin_builder("v2", lambda a: V("v2", {"p1"}))
        tiers = [Tier(plugins=[PluginOption(name="v1"),
                               PluginOption(name="v2")])]
        store, cache, ssn = make_session(tiers, pods=3, min_member=1)
        tasks = list(ssn.jobs["ns1/pg1"].tasks.values())
        victims = ssn.preemptable(tasks[0], tasks)
        assert [v.name for v in victims] == ["p1"]

    def test_empty_tier_result_poisons_later_tiers(self):
        class V(Plugin):
            def __init__(self, name, picks):
                self._name, self._picks = name, picks

            def name(self):
                return self._name

            def on_session_open(self, ssn):
                ssn.add_preemptable_fn(
                    self._name,
                    lambda preemptor, preemptees: [
                        t for t in preemptees if t.name in self._picks])

            def on_session_close(self, ssn):
                pass

        register_plugin_builder("vnone", lambda a: V("vnone", set()))
        register_plugin_builder("vp2", lambda a: V("vp2", {"p2"}))
        # an earlier tier whose fn RAN and returned nothing poisons later
        # tiers: the intersection accumulator is never reset
        # (session_plugins.go:121-160, `init` persists across tiers)
        tiers = [Tier(plugins=[PluginOption(name="vnone")]),
                 Tier(plugins=[PluginOption(name="vp2")])]
        store, cache, ssn = make_session(tiers, pods=3, min_member=1)
        tasks = list(ssn.jobs["ns1/pg1"].tasks.values())
        victims = ssn.preemptable(tasks[0], tasks)
        assert victims == []

    def test_tier_without_fns_falls_through(self):
        """A tier whose plugins register no victim fn makes no decision;
        the next tier's answer stands."""
        class V(Plugin):
            def __init__(self, name, picks):
                self._name, self._picks = name, picks

            def name(self):
                return self._name

            def on_session_open(self, ssn):
                if self._picks is not None:
                    ssn.add_preemptable_fn(
                        self._name,
                        lambda preemptor, preemptees: [
                            t for t in preemptees if t.name in self._picks])

            def on_session_close(self, ssn):
                pass

        register_plugin_builder("vsilent", lambda a: V("vsilent", None))
        register_plugin_builder("vp2b", lambda a: V("vp2b", {"p2"}))
        tiers = [Tier(plugins=[PluginOption(name="vsilent")]),
                 Tier(plugins=[PluginOption(name="vp2b")])]
        store, cache, ssn = make_session(tiers, pods=3, min_member=1)
        tasks = list(ssn.jobs["ns1/pg1"].tasks.values())
        victims = ssn.preemptable(tasks[0], tasks)
        assert [v.name for v in victims] == ["p2"]


class TestStatement:
    def _open(self):
        return make_session([], pods=2, min_member=2)

    def test_allocate_commit_binds(self):
        store, cache, ssn = self._open()
        stmt = ssn.statement()
        tasks = sorted(ssn.jobs["ns1/pg1"].tasks.values(), key=lambda t: t.name)
        for t in tasks:
            stmt.allocate(t, "n1")
        assert ssn.nodes["n1"].idle.milli_cpu == 8000 - 2000
        stmt.commit()
        assert set(cache.binder.binds) == {"ns1/p0", "ns1/p1"}
        assert cache.binder.binds["ns1/p0"] == "n1"

    def test_allocate_discard_restores(self):
        store, cache, ssn = self._open()
        stmt = ssn.statement()
        tasks = sorted(ssn.jobs["ns1/pg1"].tasks.values(), key=lambda t: t.name)
        stmt.allocate(tasks[0], "n1")
        stmt.discard()
        assert not cache.binder.binds
        assert ssn.nodes["n1"].idle.milli_cpu == 8000
        assert tasks[0].status == TaskStatus.PENDING
        assert tasks[0].node_name == ""

    def test_pipeline_has_no_cache_effect(self):
        store, cache, ssn = self._open()
        stmt = ssn.statement()
        t = sorted(ssn.jobs["ns1/pg1"].tasks.values(), key=lambda x: x.name)[0]
        stmt.pipeline(t, "n1")
        assert t.status == TaskStatus.PIPELINED
        stmt.commit()
        assert not cache.binder.binds

    def test_event_handlers_fire(self):
        store, cache, ssn = self._open()
        events = []
        ssn.add_event_handler(EventHandler(
            allocate_func=lambda e: events.append(("alloc", e.task.name)),
            deallocate_func=lambda e: events.append(("dealloc", e.task.name))))
        stmt = ssn.statement()
        t = sorted(ssn.jobs["ns1/pg1"].tasks.values(), key=lambda x: x.name)[0]
        stmt.allocate(t, "n1")
        stmt.discard()
        assert events == [("alloc", "p0"), ("dealloc", "p0")]


class TestStatementBulk:
    """allocate_bulk / bind_batch must be observationally identical to the
    per-task allocate/commit loop (the burst replay runs through them)."""

    def _open(self, pods=4, min_member=4):
        return make_session([], pods=pods, min_member=min_member)

    def _state(self, ssn, cache):
        job = ssn.jobs["ns1/pg1"]
        node = ssn.nodes["n1"]
        cjob = cache.jobs["ns1/pg1"]
        cnode = cache.nodes["n1"]
        return {
            "statuses": {k: t.status for k, t in job.tasks.items()},
            "node_names": {k: t.node_name for k, t in job.tasks.items()},
            "idle": (node.idle.milli_cpu, node.idle.memory),
            "used": (node.used.milli_cpu, node.used.memory),
            "node_tasks": set(node.tasks),
            "allocated": (job.allocated.milli_cpu, job.allocated.memory),
            "pending": (job.pending_request.milli_cpu,
                        job.pending_request.memory),
            "index": {s: set(m) for s, m in job.task_status_index.items()},
            "cache_statuses": {k: t.status for k, t in cjob.tasks.items()},
            "cache_idle": (cnode.idle.milli_cpu, cnode.idle.memory),
            "cache_node_tasks": set(cnode.tasks),
            "cache_allocated": (cjob.allocated.milli_cpu,
                                cjob.allocated.memory),
            "binds": dict(cache.binder.binds),
        }

    def test_bulk_matches_per_task(self):
        # same cluster, two paths: state must match field for field
        store1, cache1, ssn1 = self._open()
        stmt1 = ssn1.statement(defer_events=True)
        tasks1 = sorted(ssn1.jobs["ns1/pg1"].tasks.values(),
                        key=lambda t: t.name)
        for t in tasks1:
            stmt1.allocate(t, "n1")
        stmt1.commit()

        store2, cache2, ssn2 = self._open()
        stmt2 = ssn2.statement(defer_events=True)
        tasks2 = sorted(ssn2.jobs["ns1/pg1"].tasks.values(),
                        key=lambda t: t.name)
        failures = stmt2.allocate_bulk([(t, "n1") for t in tasks2])
        assert failures == []
        stmt2.commit()

        assert self._state(ssn1, cache1) == self._state(ssn2, cache2)

    def test_bulk_discard_restores(self):
        store, cache, ssn = self._open()
        before = self._state(ssn, cache)
        stmt = ssn.statement(defer_events=True)
        tasks = sorted(ssn.jobs["ns1/pg1"].tasks.values(),
                       key=lambda t: t.name)
        assert stmt.allocate_bulk([(t, "n1") for t in tasks]) == []
        assert ssn.nodes["n1"].idle.milli_cpu == 8000 - 4000
        stmt.discard()
        assert self._state(ssn, cache) == before

    def test_bulk_events_fire_per_task(self):
        store, cache, ssn = self._open()
        events = []
        ssn.add_event_handler(EventHandler(
            allocate_func=lambda e: events.append(e.task.name)))
        stmt = ssn.statement()  # live events
        tasks = sorted(ssn.jobs["ns1/pg1"].tasks.values(),
                       key=lambda t: t.name)
        assert stmt.allocate_bulk([(t, "n1") for t in tasks]) == []
        assert sorted(events) == [t.name for t in tasks]

    def test_bulk_unknown_node_matches_per_task_leniency(self):
        # Statement.allocate is lenient about a missing node (no node
        # accounting, task still marked); the bulk path must match
        store, cache, ssn = self._open()
        stmt = ssn.statement(defer_events=True)
        tasks = sorted(ssn.jobs["ns1/pg1"].tasks.values(),
                       key=lambda t: t.name)
        pairs = [(tasks[0], "n1"), (tasks[1], "ghost"),
                 (tasks[2], "n1"), (tasks[3], "n1")]
        assert stmt.allocate_bulk(pairs) == []
        # the three real placements applied; the ghost one skipped node
        # accounting exactly like per-task allocate()
        assert ssn.nodes["n1"].idle.milli_cpu == 8000 - 3000
        assert tasks[1].status == TaskStatus.ALLOCATED
        assert tasks[1].node_name == "ghost"
        assert len(stmt.operations) == 4

    def test_bulk_overcommit_falls_back_per_task(self):
        # a wave that exceeds idle as a whole must behave like the
        # sequential loop: earlier tasks take node accounting, later ones
        # raise out of add_task and surface as failures
        from volcano_tpu_torch.framework import open_session
        store = ClusterStore()
        cache = SchedulerCache(store, device="cpu")
        cache.binder = FakeBinder()
        cache.evictor = FakeEvictor()
        cache.run()
        store.create("nodes", build_node("n1", {"cpu": "8",
                                                "memory": "16Gi"}))
        store.create("podgroups", build_pod_group("pg1", "ns1",
                                                  min_member=1))
        for i in range(4):
            store.create("pods", build_pod(
                "ns1", f"p{i}", "", "Pending",
                {"cpu": "3", "memory": "1Gi"}, "pg1"))
        ssn = open_session(cache, [])
        stmt = ssn.statement(defer_events=True)
        tasks = sorted(ssn.jobs["ns1/pg1"].tasks.values(),
                       key=lambda t: t.name)
        failures = stmt.allocate_bulk([(t, "n1") for t in tasks])
        # 8000 idle / 3000 per task -> 2 take accounting, 2 raise
        assert [t.name for t, _, _ in failures] == ["p2", "p3"]
        assert ssn.nodes["n1"].idle.milli_cpu == 8000 - 6000
        assert len(ssn.nodes["n1"].tasks) == 2

    def test_add_tasks_bulk_unvalidated_checks_itself(self):
        # the validated=False path must run the same checks the callers do
        store, cache, ssn = self._open()
        node = ssn.nodes["n1"]
        job = ssn.jobs["ns1/pg1"]
        tasks = sorted(job.tasks.values(), key=lambda t: t.name)
        for t in tasks:
            job.update_task_status(t, TaskStatus.ALLOCATED)
        node.add_tasks_bulk(tasks[:2])
        assert node.idle.milli_cpu == 8000 - 2000
        assert set(node.tasks) == {"ns1/p0", "ns1/p1"}
        # a duplicate key falls back per task and raises like add_task
        with pytest.raises(ValueError):
            node.add_tasks_bulk([tasks[0]])

    def test_bind_batch_partial_fit_demotes_with_input_objects(self):
        # a group that doesn't fit as a whole must bind the fitting prefix
        # per task and report failures with the CALLER's task objects
        store, cache, ssn = self._open()
        tasks = sorted(ssn.jobs["ns1/pg1"].tasks.values(),
                       key=lambda t: t.name)
        stmt = ssn.statement()
        for t in tasks:
            stmt.allocate(t, "n1")
        # shrink the cache-side node so only two of the four fit
        cache.nodes["n1"].idle.milli_cpu = 2000.0
        failures = cache.bind_batch(tasks)
        assert [t.name for t, _ in failures] == ["p2", "p3"]
        assert all(t is tasks[i + 2] for i, (t, _) in enumerate(failures))
        assert cache.jobs["ns1/pg1"].tasks["ns1/p0"].status \
            == TaskStatus.BINDING
        assert cache.jobs["ns1/pg1"].tasks["ns1/p2"].status \
            != TaskStatus.BINDING

    def test_bulk_duplicate_task_raises_like_per_task(self):
        # the same task twice in one wave: first applies, second surfaces
        # the per-task 'already on node' failure — never double accounting
        store, cache, ssn = self._open()
        stmt = ssn.statement(defer_events=True)
        tasks = sorted(ssn.jobs["ns1/pg1"].tasks.values(),
                       key=lambda t: t.name)
        failures = stmt.allocate_bulk([(tasks[0], "n1"), (tasks[0], "n1")])
        assert len(failures) == 1 and failures[0][0] is tasks[0]
        assert ssn.nodes["n1"].idle.milli_cpu == 8000 - 1000
        job = ssn.jobs["ns1/pg1"]
        assert job.allocated.milli_cpu == 1000

    def test_bulk_aggregate_drift_demotes_job(self):
        # a drifted pending aggregate must not abort the cycle or leave a
        # half-mutated job: bulk pre-checks, fails closed to per-task
        store, cache, ssn = self._open()
        job = ssn.jobs["ns1/pg1"]
        job.pending_request.milli_cpu = 0.0  # simulate drift
        stmt = ssn.statement(defer_events=True)
        tasks = sorted(job.tasks.values(), key=lambda t: t.name)
        failures = stmt.allocate_bulk([(t, "n1") for t in tasks])
        # per-task path: each update_task_status raises the same ValueError
        assert len(failures) == 4
        assert all(isinstance(e, ValueError) for _, _, e in failures)

        # parity: the per-task loop on an identical cluster ends in the
        # same (quirky: status flips before the aggregate assert) state
        store2, cache2, ssn2 = self._open()
        job2 = ssn2.jobs["ns1/pg1"]
        job2.pending_request.milli_cpu = 0.0
        stmt2 = ssn2.statement(defer_events=True)
        tasks2 = sorted(job2.tasks.values(), key=lambda t: t.name)
        raised = 0
        for t in tasks2:
            try:
                stmt2.allocate(t, "n1")
            except ValueError:
                raised += 1
        assert raised == 4
        assert {k: t.status for k, t in job.tasks.items()} \
            == {k: t.status for k, t in job2.tasks.items()}
        assert ssn.nodes["n1"].idle.milli_cpu \
            == ssn2.nodes["n1"].idle.milli_cpu
        assert job.allocated.milli_cpu == job2.allocated.milli_cpu

    def test_bind_batch_matches_bind(self):
        store1, cache1, ssn1 = self._open()
        tasks1 = sorted(ssn1.jobs["ns1/pg1"].tasks.values(),
                        key=lambda t: t.name)
        stmt1 = ssn1.statement()
        for t in tasks1:
            stmt1.allocate(t, "n1")
        for t in tasks1:
            cache1.bind(t, "n1")

        store2, cache2, ssn2 = self._open()
        tasks2 = sorted(ssn2.jobs["ns1/pg1"].tasks.values(),
                        key=lambda t: t.name)
        stmt2 = ssn2.statement()
        for t in tasks2:
            stmt2.allocate(t, "n1")
        assert cache2.bind_batch(tasks2) == []

        assert self._state(ssn1, cache1) == self._state(ssn2, cache2)
        assert cache2.jobs["ns1/pg1"].tasks["ns1/p0"].status \
            == TaskStatus.BINDING


class TestPriorityQueue:
    def test_order_and_stability(self):
        pq = PriorityQueue(lambda l, r: l[0] < r[0])
        pq.push((2, "b"))
        pq.push((1, "a"))
        pq.push((2, "c"))
        assert pq.pop() == (1, "a")
        assert pq.pop() == (2, "b")  # FIFO among equals
        assert pq.pop() == (2, "c")
        assert pq.pop() is None


class TestNodeSampling:
    """Adaptive feasible-node sampling (scheduler_helper.go:50-128)."""

    def test_default_scans_everything(self):
        from volcano_tpu_torch.utils import NodeSampler
        assert NodeSampler(100).feasible_nodes_to_find(5000) == 5000

    def test_floors_clamp_up(self):
        from volcano_tpu_torch.utils import NodeSampler
        s = NodeSampler(10)
        # small clusters always scan fully
        assert s.feasible_nodes_to_find(80) == 80
        # 10% of 5000 = 500
        assert s.feasible_nodes_to_find(5000) == 500
        # percentage below the 5% floor clamps up
        assert NodeSampler(1).feasible_nodes_to_find(5000) == 250
        # count floor: never below 100 nodes
        assert NodeSampler(1).feasible_nodes_to_find(1500) == 100

    def test_cursor_advances_past_visited(self):
        from volcano_tpu_torch.utils import NodeSampler
        s = NodeSampler(10)
        nodes = list(range(1000))
        first, want = s.plan(nodes)
        assert sorted(first) == nodes  # a rotation, not a subset
        assert want == 100
        s.advance(700, 1000)  # scan walked 700 nodes to find 100 feasible
        second, _ = s.plan(nodes)
        assert second[0] == 700  # next scan starts where the last stopped


class TestJobUpdaterDirtySkip:
    """The skip-if-untouched fast path must not miss changes landing
    BETWEEN sessions (informer pod updates) or unready jobs whose
    Unschedulable conditions post unconditionally."""

    def _cluster(self):
        from volcano_tpu_torch.cache import FakeEvictor, SchedulerCache
        from volcano_tpu_torch.client import ClusterStore
        from volcano_tpu_torch.scheduler import Scheduler

        store = ClusterStore()
        cache = SchedulerCache(store, device="cpu")
        cache.evictor = FakeEvictor()
        cache.run()
        store.create("nodes", build_node("n1", {"cpu": "8", "memory": "16Gi"}))
        pg = build_pod_group("j1", "ns", min_member=2)
        store.create("podgroups", pg)
        for i in range(2):
            store.create("pods", build_pod("ns", f"j1-{i}", "", "Pending",
                                           {"cpu": "1", "memory": "1Gi"},
                                           "j1"))
        return store, cache, Scheduler(cache)

    def test_pod_succeeding_between_cycles_updates_status(self):
        store, cache, sched = self._cluster()
        sched.run_once()  # binds both pods (default binder -> Running)
        sched.run_once()  # steady cycle: status settles, versions recorded
        pg = store.get("podgroups", "j1", "ns")
        assert pg.status.running == 2

        # a pod succeeds between cycles (informer-driven, no session touch)
        pod = store.get("pods", "j1-0", "ns")
        pod.phase = "Succeeded"
        store.update("pods", pod)
        sched.run_once()
        pg = store.get("podgroups", "j1", "ns")
        assert pg.status.succeeded == 1, \
            "between-cycle pod completion must re-dirty the job"
        assert pg.status.running == 1

    def test_untouched_unschedulable_job_keeps_getting_conditions(self):
        from volcano_tpu_torch.cache import FakeEvictor, SchedulerCache
        from volcano_tpu_torch.client import ClusterStore
        from volcano_tpu_torch.scheduler import Scheduler

        store = ClusterStore()
        cache = SchedulerCache(store, device="cpu")
        cache.evictor = FakeEvictor()
        cache.run()
        store.create("nodes", build_node("n1", {"cpu": "1", "memory": "2Gi"}))
        pg = build_pod_group("big", "ns", min_member=4)
        store.create("podgroups", pg)
        for i in range(4):
            store.create("pods", build_pod("ns", f"big-{i}", "", "Pending",
                                           {"cpu": "1", "memory": "1Gi"},
                                           "big"))
        sched = Scheduler(cache)
        sched.run_once()
        sched.run_once()  # the job stays unready; conditions must re-post
        pod = store.get("pods", "big-0", "ns")
        assert any(c.get("type") == "PodScheduled" for c in pod.conditions)
