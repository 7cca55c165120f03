"""Action tests (reference actions/allocate/allocate_test.go pattern) and the
BASELINE config #1 end-to-end slice: tests/test_actions.py through the
port on the CPU (``device="cpu"``). Every allocate and backfill session is
also run by the JAX package over a codec copy of the store
(``torch_helpers.jax_session_binds``) and the two must bind alike.
Tolerance: exact."""

import pytest

from volcano_tpu_torch.api import TaskStatus
from volcano_tpu_torch.cache import FakeBinder, FakeEvictor, SchedulerCache
from volcano_tpu_torch.client import ClusterStore
from volcano_tpu_torch.conf import PluginOption, Tier, load_scheduler_conf
from volcano_tpu_torch.framework import close_session, open_session
from volcano_tpu_torch.models import PodGroupPhase
from volcano_tpu_torch.scheduler import Scheduler

from torch_helpers import Builders, jax_session_binds

_B = Builders("torch")
build_node, build_pod, build_pod_group, build_queue = _B.build_node, _B.build_pod, _B.build_pod_group, _B.build_queue


def gang_tiers():
    return [Tier(plugins=[PluginOption(name="priority"),
                          PluginOption(name="gang")]),
            Tier(plugins=[PluginOption(name="predicates"),
                          PluginOption(name="nodeorder")])]


def make_cluster(nodes, podgroups, pods, queues=()):
    store = ClusterStore()
    cache = SchedulerCache(store, device="cpu")
    cache.binder = FakeBinder()
    cache.evictor = FakeEvictor()
    cache.run()
    for q in queues:
        store.apply("queues", q)
    for n in nodes:
        store.create("nodes", n)
    for pg in podgroups:
        store.create("podgroups", pg)
    for p in pods:
        store.create("pods", p)
    return store, cache


def run_allocate(cache, tiers, mode="solver"):
    """One allocate session in the port, held bind for bind to the same
    session in the JAX package over a codec copy of the store."""
    from volcano_tpu_torch.framework import get_action
    from volcano_tpu_torch.conf import Configuration
    confs = [Configuration("allocate", {"mode": mode})]
    want = jax_session_binds(cache.cluster, tiers, confs)
    ssn = open_session(cache, tiers, confs)
    get_action("allocate").execute(ssn)
    close_session(ssn)
    assert cache.binder.binds == want
    return ssn


@pytest.fixture(params=["solver", "sequential", "host"])
def mode(request):
    return request.param


class TestAllocateAction:
    def test_single_gang_job(self, mode):
        # allocate_test.go case 1: one job, two pods, one node
        store, cache = make_cluster(
            [build_node("n1", {"cpu": "2", "memory": "4Gi"})],
            [build_pod_group("pg1", "c1", min_member=1)],
            [build_pod("c1", "p1", "", "Pending",
                       {"cpu": "1", "memory": "1Gi"}, "pg1"),
             build_pod("c1", "p2", "", "Pending",
                       {"cpu": "1", "memory": "1Gi"}, "pg1")])
        run_allocate(cache, gang_tiers(), mode)
        assert cache.binder.binds == {"c1/p1": "n1", "c1/p2": "n1"}

    def test_two_jobs_two_nodes(self, mode):
        store, cache = make_cluster(
            [build_node("n1", {"cpu": "2", "memory": "4Gi"}),
             build_node("n2", {"cpu": "2", "memory": "4Gi"})],
            [build_pod_group("pg1", "c1", min_member=1),
             build_pod_group("pg2", "c1", min_member=1)],
            [build_pod("c1", "p1", "", "Pending",
                       {"cpu": "2", "memory": "1Gi"}, "pg1"),
             build_pod("c1", "p2", "", "Pending",
                       {"cpu": "2", "memory": "1Gi"}, "pg2")])
        run_allocate(cache, gang_tiers(), mode)
        assert len(cache.binder.binds) == 2
        assert {cache.binder.binds["c1/p1"],
                cache.binder.binds["c1/p2"]} == {"n1", "n2"}

    def test_gang_all_or_nothing(self, mode):
        # 3-replica gang needs 3 cpu, cluster has 2 -> no binds at all
        store, cache = make_cluster(
            [build_node("n1", {"cpu": "2", "memory": "4Gi"})],
            [build_pod_group("pg1", "c1", min_member=3)],
            [build_pod("c1", f"p{i}", "", "Pending",
                       {"cpu": "1", "memory": "1Gi"}, "pg1")
             for i in range(3)])
        ssn = run_allocate(cache, gang_tiers(), mode)
        assert cache.binder.binds == {}
        # gang close wrote the Unschedulable condition
        pg = store.get("podgroups", "pg1", "c1")
        assert any(c.type == "Unschedulable" and c.status == "True"
                   for c in pg.status.conditions)

    def test_node_selector_respected(self, mode):
        n1 = build_node("n1", {"cpu": "4", "memory": "8Gi"}, labels={"gpu": "no"})
        n2 = build_node("n2", {"cpu": "4", "memory": "8Gi"}, labels={"gpu": "yes"})
        p = build_pod("c1", "p1", "", "Pending", {"cpu": "1", "memory": "1Gi"},
                      "pg1", node_selector={"gpu": "yes"})
        store, cache = make_cluster(
            [n1, n2], [build_pod_group("pg1", "c1", min_member=1)], [p])
        run_allocate(cache, gang_tiers(), mode)
        assert cache.binder.binds == {"c1/p1": "n2"}

    def test_required_anti_affinity_not_colocated(self, mode):
        # Two anti-affine pods must land on different nodes in EVERY mode:
        # required inter-pod terms force the sequential host loop (the
        # kernel's precomputed masks can't see in-flight placements), so the
        # solver-mode kernel can no longer co-locate them.
        anti = {"podAntiAffinity": {
            "requiredDuringSchedulingIgnoredDuringExecution": [
                {"labelSelector": {"matchLabels": {"app": "db"}},
                 "topologyKey": "kubernetes.io/hostname"}]}}
        pods = []
        for i in (1, 2):
            p = build_pod("c1", f"p{i}", "", "Pending",
                          {"cpu": "1", "memory": "1Gi"}, "pg1",
                          labels={"app": "db"})
            p.affinity = anti
            pods.append(p)
        store, cache = make_cluster(
            [build_node("n1", {"cpu": "8", "memory": "16Gi"}),
             build_node("n2", {"cpu": "8", "memory": "16Gi"})],
            [build_pod_group("pg1", "c1", min_member=2)], pods)
        run_allocate(cache, gang_tiers(), mode)
        assert len(cache.binder.binds) == 2
        assert cache.binder.binds["c1/p1"] != cache.binder.binds["c1/p2"]

    def test_pending_phase_podgroup_skipped(self, mode):
        pg = build_pod_group("pg1", "c1", min_member=1,
                             phase=PodGroupPhase.PENDING)
        store, cache = make_cluster(
            [build_node("n1", {"cpu": "4", "memory": "8Gi"})], [pg],
            [build_pod("c1", "p1", "", "Pending",
                       {"cpu": "1", "memory": "1Gi"}, "pg1")])
        run_allocate(cache, gang_tiers(), mode)
        assert cache.binder.binds == {}


class TestEnqueueAction:
    def test_pending_podgroup_goes_inqueue(self):
        pg = build_pod_group("pg1", "c1", min_member=1,
                             phase=PodGroupPhase.PENDING,
                             min_resources={"cpu": "1", "memory": "1Gi"})
        store, cache = make_cluster(
            [build_node("n1", {"cpu": "4", "memory": "8Gi"})], [pg], [])
        from volcano_tpu_torch.framework import get_action
        ssn = open_session(cache, gang_tiers())
        get_action("enqueue").execute(ssn)
        assert ssn.jobs["c1/pg1"].pod_group.status.phase == PodGroupPhase.INQUEUE
        close_session(ssn)

    def test_oversized_podgroup_stays_pending(self):
        pg = build_pod_group("pg1", "c1", min_member=1,
                             phase=PodGroupPhase.PENDING,
                             min_resources={"cpu": "100", "memory": "1Gi"})
        store, cache = make_cluster(
            [build_node("n1", {"cpu": "4", "memory": "8Gi"})], [pg], [])
        from volcano_tpu_torch.framework import get_action
        ssn = open_session(cache, gang_tiers())
        get_action("enqueue").execute(ssn)
        assert ssn.jobs["c1/pg1"].pod_group.status.phase == PodGroupPhase.PENDING
        close_session(ssn)


class TestBackfillAction:
    def test_best_effort_task_backfilled(self):
        store, cache = make_cluster(
            [build_node("n1", {"cpu": "2", "memory": "4Gi"})],
            [build_pod_group("pg1", "c1", min_member=1)],
            [build_pod("c1", "be", "", "Pending", {}, "pg1")])
        from volcano_tpu_torch.framework import get_action
        want = jax_session_binds(cache.cluster, gang_tiers(),
                                 actions=("backfill",))
        ssn = open_session(cache, gang_tiers())
        get_action("backfill").execute(ssn)
        close_session(ssn)
        assert cache.binder.binds == {"c1/be": "n1"} == want


class TestSchedulerLoop:
    def test_baseline_config1_end_to_end(self):
        """BASELINE config #1: single 4-replica PodGroup on a 3-node
        cluster; default conf (enqueue, allocate, backfill); pods bound and
        podgroup Running after one cycle."""
        store = ClusterStore()
        cache = SchedulerCache(store, device="cpu")
        cache.binder = FakeBinder()
        cache.evictor = FakeEvictor()
        sched = Scheduler(cache)
        for i in range(3):
            store.create("nodes",
                         build_node(f"n{i}", {"cpu": "4", "memory": "8Gi"}))
        pg = build_pod_group("job-1", "default", min_member=4,
                             phase=PodGroupPhase.PENDING,
                             min_resources={"cpu": "4", "memory": "4Gi"})
        store.create("podgroups", pg)
        for i in range(4):
            store.create("pods", build_pod(
                "default", f"job-1-{i}", "", "Pending",
                {"cpu": "1", "memory": "1Gi"}, "job-1"))
        sched.run(stop_after=1)
        assert len(cache.binder.binds) == 4
        assert set(cache.binder.binds.values()) <= {"n0", "n1", "n2"}
        pg_after = store.get("podgroups", "job-1", "default")
        assert pg_after.status.phase == PodGroupPhase.RUNNING
        # pods got bound in the store (default binder replaced by fake, so
        # store pods keep Pending - but bind records exist per pod)
        assert sorted(cache.binder.binds) == [
            f"default/job-1-{i}" for i in range(4)]

    def test_conf_hot_reload(self, tmp_path):
        conf1 = 'actions: "enqueue, allocate"\ntiers:\n- plugins:\n  - name: gang\n'
        conf_file = tmp_path / "scheduler.yaml"
        conf_file.write_text(conf1)
        store = ClusterStore()
        cache = SchedulerCache(store, device="cpu")
        sched = Scheduler(cache, conf_path=str(conf_file))
        assert [a.name() for a in sched.actions] == ["enqueue", "allocate"]
        import os, time
        conf2 = 'actions: "allocate, backfill"\ntiers:\n- plugins:\n  - name: gang\n'
        conf_file.write_text(conf2)
        os.utime(conf_file, (time.time() + 2, time.time() + 2))
        sched.load_conf()
        assert [a.name() for a in sched.actions] == ["allocate", "backfill"]
