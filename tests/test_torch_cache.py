"""Cache tests (reference pkg/scheduler/cache/cache_test.go pattern):
tests/test_cache.py through the port, every cache on ``device="cpu"``.
Tolerance: exact."""

import pytest

from volcano_tpu_torch.api import TaskInfo, TaskStatus
from volcano_tpu_torch.cache import FakeBinder, FakeEvictor, SchedulerCache
from volcano_tpu_torch.client import ClusterStore
from volcano_tpu_torch.models import PriorityClass

from torch_helpers import Builders

_B = Builders("torch")
build_node, build_pod, build_pod_group, build_queue = _B.build_node, _B.build_pod, _B.build_pod_group, _B.build_queue


def make_cache():
    store = ClusterStore()
    cache = SchedulerCache(store, device="cpu")
    cache.run()
    return store, cache


class TestCacheHandlers:
    def test_default_queue_created(self):
        store, cache = make_cache()
        assert store.try_get("queues", "default") is not None
        assert "default" in cache.queues

    def test_watch_stream_builds_state(self):
        store, cache = make_cache()
        store.create("nodes", build_node("n1", {"cpu": "4", "memory": "8Gi"}))
        store.create("podgroups", build_pod_group("pg1", "ns1", min_member=2))
        p1 = build_pod("ns1", "p1", "n1", "Running",
                       {"cpu": "1", "memory": "1Gi"}, "pg1")
        p2 = build_pod("ns1", "p2", "", "Pending",
                       {"cpu": "1", "memory": "1Gi"}, "pg1")
        store.create("pods", p1)
        store.create("pods", p2)
        assert len(cache.nodes) == 1
        job = cache.jobs["ns1/pg1"]
        assert len(job.tasks) == 2
        assert cache.nodes["n1"].used.milli_cpu == 1000
        # pod before node object arrives: placeholder node holds it
        p3 = build_pod("ns1", "p3", "n2", "Running",
                       {"cpu": "1", "memory": "1Gi"}, "pg1")
        store.create("pods", p3)
        assert "n2" in cache.nodes
        store.create("nodes", build_node("n2", {"cpu": "2", "memory": "4Gi"}))
        assert cache.nodes["n2"].used.milli_cpu == 1000
        assert cache.nodes["n2"].idle.milli_cpu == 1000

    def test_delete_pod_removes_task(self):
        store, cache = make_cache()
        store.create("nodes", build_node("n1", {"cpu": "4", "memory": "8Gi"}))
        store.create("podgroups", build_pod_group("pg1", "ns1"))
        p = build_pod("ns1", "p1", "n1", "Running",
                      {"cpu": "1", "memory": "1Gi"}, "pg1")
        store.create("pods", p)
        assert cache.nodes["n1"].used.milli_cpu == 1000
        store.delete("pods", "p1", "ns1")
        assert cache.nodes["n1"].used.milli_cpu == 0
        assert not cache.jobs["ns1/pg1"].tasks

    def test_foreign_scheduler_pods_ignored(self):
        store, cache = make_cache()
        p = build_pod("ns1", "p1", "", "Pending", {"cpu": "1", "memory": "0"}, "pg1")
        p.scheduler_name = "default-scheduler"
        store.create("pods", p)
        assert "ns1/pg1" not in cache.jobs


class TestSnapshot:
    def test_snapshot_filters(self):
        store, cache = make_cache()
        store.create("nodes", build_node("n1", {"cpu": "4", "memory": "8Gi"}))
        bad = build_node("n2", {"cpu": "4", "memory": "8Gi"})
        bad.unschedulable = True
        store.create("nodes", bad)
        store.create("podgroups", build_pod_group("pg1", "ns1", min_member=1))
        # job with no podgroup (bare task group) must be skipped
        orphan = build_pod("ns1", "p9", "", "Pending",
                           {"cpu": "1", "memory": "0"}, "orphan-pg")
        store.create("pods", orphan)
        # job in a nonexistent queue must be skipped
        store.create("podgroups",
                     build_pod_group("pg2", "ns1", min_member=1, queue="nope"))
        sn = cache.snapshot()
        assert list(sn.nodes) == ["n1"]
        assert list(sn.jobs) == ["ns1/pg1"]
        assert "default" in sn.queues

    def test_snapshot_resolves_priority(self):
        store, cache = make_cache()
        store.create("priorityclasses", PriorityClass("high", 1000))
        store.create("priorityclasses",
                     PriorityClass("def", 7, global_default=True))
        pg = build_pod_group("pg1", "ns1", min_member=1)
        pg.spec.priority_class_name = "high"
        store.create("podgroups", pg)
        store.create("podgroups", build_pod_group("pg2", "ns1", min_member=1))
        sn = cache.snapshot()
        assert sn.jobs["ns1/pg1"].priority == 1000
        assert sn.jobs["ns1/pg2"].priority == 7

    def test_snapshot_is_deep_copy(self):
        store, cache = make_cache()
        store.create("nodes", build_node("n1", {"cpu": "4", "memory": "8Gi"}))
        store.create("podgroups", build_pod_group("pg1", "ns1", min_member=1))
        store.create("pods", build_pod("ns1", "p1", "", "Pending",
                                       {"cpu": "1", "memory": "0"}, "pg1"))
        sn = cache.snapshot()
        t = next(iter(sn.jobs["ns1/pg1"].tasks.values()))
        sn.jobs["ns1/pg1"].update_task_status(t, TaskStatus.ALLOCATED)
        sn.nodes["n1"].idle.milli_cpu = 0.0
        assert cache.jobs["ns1/pg1"].tasks[t.key].status == TaskStatus.PENDING
        assert cache.nodes["n1"].idle.milli_cpu == 4000


class TestEffectors:
    def _scheduled_cluster(self):
        store, cache = make_cache()
        cache.binder = FakeBinder()
        cache.evictor = FakeEvictor()
        store.create("nodes", build_node("n1", {"cpu": "4", "memory": "8Gi"}))
        store.create("podgroups", build_pod_group("pg1", "ns1", min_member=1))
        p = build_pod("ns1", "p1", "", "Pending",
                      {"cpu": "1", "memory": "1Gi"}, "pg1")
        store.create("pods", p)
        return store, cache

    def test_bind_updates_state_and_calls_binder(self):
        store, cache = self._scheduled_cluster()
        task = cache.jobs["ns1/pg1"].tasks["ns1/p1"]
        cache.bind(task, "n1")
        assert cache.binder.binds == {"ns1/p1": "n1"}
        assert task.status == TaskStatus.BINDING
        assert cache.nodes["n1"].idle.milli_cpu == 3000

    def test_bind_unknown_host_raises(self):
        store, cache = self._scheduled_cluster()
        task = cache.jobs["ns1/pg1"].tasks["ns1/p1"]
        with pytest.raises(KeyError):
            cache.bind(task, "ghost")
        assert task.status == TaskStatus.PENDING

    def test_evict(self):
        store, cache = self._scheduled_cluster()
        task = cache.jobs["ns1/pg1"].tasks["ns1/p1"]
        cache.bind(task, "n1")
        cache.evict(task, "preempted")
        assert cache.evictor.evicts == ["ns1/p1"]
        assert task.status == TaskStatus.RELEASING
        # releasing resources counted in future-idle, not idle
        assert cache.nodes["n1"].idle.milli_cpu == 3000
        assert cache.nodes["n1"].future_idle().milli_cpu == 4000


class TestAsyncEffectors:
    def test_async_bind_fires_and_drains(self):
        """cache.go:505-512 fires Bind in a goroutine; the async pool is
        the equivalent, with wait_for_effects as the drain seam."""
        from volcano_tpu_torch.cache import FakeBinder, FakeEvictor, SchedulerCache
        from volcano_tpu_torch.client import ClusterStore
        from volcano_tpu_torch.conf import PluginOption, Tier
        from volcano_tpu_torch.framework import (
            close_session, get_action, open_session,
        )
        from torch_helpers import Builders

        _B = Builders("torch")
        build_node, build_pod, build_pod_group = _B.build_node, _B.build_pod, _B.build_pod_group

        store = ClusterStore()
        cache = SchedulerCache(store, async_effectors=True, device="cpu")
        cache.binder = FakeBinder()
        cache.evictor = FakeEvictor()
        cache.run()
        store.create("nodes", build_node("n1", {"cpu": "4", "memory": "8Gi"}))
        store.create("podgroups", build_pod_group("pg1", "c1", min_member=1))
        store.create("pods", build_pod("c1", "p1", "", "Pending",
                                       {"cpu": "1", "memory": "1Gi"}, "pg1"))
        tiers = [Tier(plugins=[PluginOption(name="gang"),
                               PluginOption(name="predicates")])]
        ssn = open_session(cache, tiers)
        get_action("allocate").execute(ssn)
        close_session(ssn)
        cache.wait_for_effects()
        assert cache.binder.binds == {"c1/p1": "n1"}


class TestSnapshotCloneReuse:
    """Version-gated snapshot clone reuse: unchanged objects hand back the
    SAME clone; any cache-side or session-side mutation forces a fresh
    one."""

    def _world(self):
        from volcano_tpu_torch.client import ClusterStore

        store = ClusterStore()
        cache = SchedulerCache(store, device="cpu")
        cache.binder = FakeBinder()
        cache.evictor = FakeEvictor()
        cache.run()
        store.create("nodes", build_node("n1", {"cpu": "8", "memory": "16Gi"}))
        store.create("podgroups", build_pod_group("j1", "ns", min_member=1))
        store.create("pods", build_pod("ns", "j1-0", "", "Pending",
                                       {"cpu": "1", "memory": "1Gi"}, "j1"))
        return store, cache

    def test_unchanged_objects_reuse_clones(self):
        store, cache = self._world()
        s1 = cache.snapshot()
        s2 = cache.snapshot()
        assert s2.jobs["ns/j1"] is s1.jobs["ns/j1"]
        assert s2.nodes["n1"] is s1.nodes["n1"]

    def test_cache_side_change_invalidates(self):
        store, cache = self._world()
        s1 = cache.snapshot()
        pod = store.get("pods", "j1-0", "ns")
        pod.phase = "Running"
        pod.node_name = "n1"
        store.update("pods", pod)  # informer flips the task
        s2 = cache.snapshot()
        assert s2.jobs["ns/j1"] is not s1.jobs["ns/j1"]
        assert s2.nodes["n1"] is not s1.nodes["n1"]
        t = s2.jobs["ns/j1"].tasks["ns/j1-0"]
        from volcano_tpu_torch.api import TaskStatus
        assert t.status == TaskStatus.RUNNING

    def test_session_side_mutation_invalidates(self):
        from volcano_tpu_torch.api import TaskStatus

        store, cache = self._world()
        s1 = cache.snapshot()
        job = s1.jobs["ns/j1"]
        task = next(iter(job.tasks.values()))
        job.update_task_status(task, TaskStatus.ALLOCATED)  # session mutates
        s2 = cache.snapshot()
        assert s2.jobs["ns/j1"] is not job
        t2 = next(iter(s2.jobs["ns/j1"].tasks.values()))
        assert t2.status == TaskStatus.PENDING  # fresh from cache truth

    def test_reused_clone_fit_errors_cleared(self):
        from volcano_tpu_torch.api.unschedule_info import FitErrors

        store, cache = self._world()
        s1 = cache.snapshot()
        s1.jobs["ns/j1"].nodes_fit_errors["ns/j1-0"] = FitErrors()
        s2 = cache.snapshot()
        assert not s2.jobs["ns/j1"].nodes_fit_errors
