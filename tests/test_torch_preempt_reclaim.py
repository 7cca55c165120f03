"""Preempt/reclaim/elect/reserve tests (reference actions/preempt/
preempt_test.go, actions/reclaim/reclaim_test.go patterns):
tests/test_preempt_reclaim.py through the port on the CPU
(``device="cpu"``), with the reference's own expectations. Every
preempt, reclaim and elect/reserve session also runs in the JAX package
over a codec copy of the store (``torch_helpers.jax_open_session``):
evictions, binds and each job's pipelined count equal (exact). The
minimality solve is held to the JAX package's solve on the same arrays
(exact)."""

import numpy as np
import pytest

pytest.importorskip("jax")  # the JAX reference: absent on the card's machine

import torch  # noqa: E402

from volcano_tpu_torch.api import TaskStatus  # noqa: E402
from volcano_tpu_torch.cache import (  # noqa: E402
    FakeBinder, FakeEvictor, SchedulerCache,
)
from volcano_tpu_torch.client import ClusterStore  # noqa: E402
from volcano_tpu_torch.conf import (  # noqa: E402
    Configuration, PluginOption, Tier,
)
from volcano_tpu_torch.framework import (  # noqa: E402
    close_session, get_action, open_session,
)
from volcano_tpu_torch.models import PriorityClass  # noqa: E402
from volcano_tpu_torch.utils.scheduler_helper import (  # noqa: E402
    reservation,
)

from torch_helpers import Builders, jax_open_session  # noqa: E402

_B = Builders("torch")
build_node = _B.build_node
build_pod = _B.build_pod
build_pod_group = _B.build_pod_group
build_queue = _B.build_queue


@pytest.fixture(params=["solver", "host"])
def mode(request):
    return request.param


def open_mode(cache, tiers, mode):
    """The port's session, with its JAX twin (a session of the JAX
    package over a codec copy of the store) kept on it for ``execute``."""
    confs = [Configuration("preempt", {"mode": mode}),
             Configuration("reclaim", {"mode": mode})]
    ssn = open_session(cache, tiers, confs)
    ssn.jax_twin = jax_open_session(cache.cluster, tiers, confs)
    return ssn


def pipelined(ssn) -> dict:
    return {uid: j.waiting_task_num() for uid, j in ssn.jobs.items()}


def execute(ssn, action, name=None):
    """Run ``action`` (a name, or an action object and its ``name``) in
    the port's session and in its JAX twin: evictions, binds and the
    pipelined counts equal."""
    from volcano_tpu.framework import get_action as j_get_action
    jcache, jssn = ssn.jax_twin
    if isinstance(action, str):
        j_get_action(action).execute(jssn)
        get_action(action).execute(ssn)
    else:
        j_get_action(name).execute(jssn)
        action.execute(ssn)
    assert ssn.cache.evictor.evicts == jcache.evictor.evicts
    assert ssn.cache.binder.binds == jcache.binder.binds
    assert pipelined(ssn) == pipelined(jssn)


def make_cluster(nodes, podgroups, pods, queues=(), priority_classes=()):
    store = ClusterStore()
    cache = SchedulerCache(store, device="cpu")
    cache.binder = FakeBinder()
    cache.evictor = FakeEvictor()
    cache.run()
    for pc in priority_classes:
        store.create("priorityclasses", pc)
    for q in queues:
        store.apply("queues", q)
    for n in nodes:
        store.create("nodes", n)
    for pg in podgroups:
        store.create("podgroups", pg)
    for p in pods:
        store.create("pods", p)
    return store, cache


class TestPreempt:
    def test_high_priority_job_preempts_within_queue(self, mode):
        """preempt_test.go case: node full with low-prio job; high-prio job
        with pending tasks evicts victims and pipelines."""
        low_pg = build_pod_group("low", "c1", min_member=1)
        high_pg = build_pod_group("high", "c1", min_member=1)
        high_pg.spec.priority_class_name = "high-priority"
        store, cache = make_cluster(
            [build_node("n1", {"cpu": "2", "memory": "4Gi"})],
            [low_pg, high_pg],
            [build_pod("c1", "low-1", "n1", "Running",
                       {"cpu": "1", "memory": "1Gi"}, "low"),
             build_pod("c1", "low-2", "n1", "Running",
                       {"cpu": "1", "memory": "1Gi"}, "low"),
             build_pod("c1", "high-1", "", "Pending",
                       {"cpu": "1", "memory": "1Gi"}, "high")],
            priority_classes=[PriorityClass("high-priority", 1000)])
        tiers = [Tier(plugins=[PluginOption(name="priority"),
                               PluginOption(name="gang"),
                               PluginOption(name="conformance")]),
                 Tier(plugins=[PluginOption(name="predicates"),
                               PluginOption(name="nodeorder")])]
        ssn = open_mode(cache, tiers, mode)
        execute(ssn, "preempt")
        assert len(cache.evictor.evicts) >= 1
        assert all(e.startswith("c1/low") for e in cache.evictor.evicts)
        high_job = ssn.jobs["c1/high"]
        assert high_job.waiting_task_num() == 1  # pipelined
        close_session(ssn)

    def test_no_preemption_between_equal_priority(self, mode):
        pg_a = build_pod_group("a", "c1", min_member=1)
        pg_b = build_pod_group("b", "c1", min_member=1)
        store, cache = make_cluster(
            [build_node("n1", {"cpu": "2", "memory": "4Gi"})],
            [pg_a, pg_b],
            [build_pod("c1", "a-1", "n1", "Running",
                       {"cpu": "2", "memory": "1Gi"}, "a"),
             build_pod("c1", "b-1", "", "Pending",
                       {"cpu": "1", "memory": "1Gi"}, "b")])
        tiers = [Tier(plugins=[PluginOption(name="priority"),
                               PluginOption(name="gang"),
                               PluginOption(name="conformance")])]
        ssn = open_mode(cache, tiers, mode)
        execute(ssn, "preempt")
        assert cache.evictor.evicts == []
        close_session(ssn)

    def test_conformance_protects_kube_system(self, mode):
        sys_pg = build_pod_group("sys", "kube-system", min_member=1)
        high_pg = build_pod_group("high", "c1", min_member=1)
        high_pg.spec.priority_class_name = "high-priority"
        sys_pod = build_pod("kube-system", "sys-1", "n1", "Running",
                            {"cpu": "2", "memory": "1Gi"}, "sys")
        store, cache = make_cluster(
            [build_node("n1", {"cpu": "2", "memory": "4Gi"})],
            [sys_pg, high_pg],
            [sys_pod,
             build_pod("c1", "high-1", "", "Pending",
                       {"cpu": "1", "memory": "1Gi"}, "high")],
            priority_classes=[PriorityClass("high-priority", 1000)])
        tiers = [Tier(plugins=[PluginOption(name="priority"),
                               PluginOption(name="gang"),
                               PluginOption(name="conformance")])]
        ssn = open_mode(cache, tiers, mode)
        execute(ssn, "preempt")
        assert cache.evictor.evicts == []
        close_session(ssn)


class TestGangPreempt:
    """BASELINE config #4 in miniature: a high-priority gang claims room
    held by a low-priority job — all-or-nothing."""

    def _cluster(self, n_nodes, low_pods_per_node, min_member, mode):
        low_pg = build_pod_group("low", "c1", min_member=1)
        high_pg = build_pod_group("high", "c1", min_member=min_member)
        high_pg.spec.priority_class_name = "high-priority"
        pods = []
        for n in range(n_nodes):
            for i in range(low_pods_per_node):
                pods.append(build_pod(
                    "c1", f"low-{n}-{i}", f"n{n}", "Running",
                    {"cpu": "1", "memory": "1Gi"}, "low"))
        for i in range(min_member):
            pods.append(build_pod("c1", f"high-{i}", "", "Pending",
                                  {"cpu": "1", "memory": "1Gi"}, "high"))
        store, cache = make_cluster(
            [build_node(f"n{n}", {"cpu": "2", "memory": "8Gi"})
             for n in range(n_nodes)],
            [low_pg, high_pg], pods,
            priority_classes=[PriorityClass("high-priority", 1000)])
        tiers = [Tier(plugins=[PluginOption(name="priority"),
                               PluginOption(name="gang"),
                               PluginOption(name="conformance")]),
                 Tier(plugins=[PluginOption(name="predicates"),
                               PluginOption(name="nodeorder")])]
        ssn = open_mode(cache, tiers, mode)
        return store, cache, ssn

    def test_gang_preempts_across_nodes(self, mode):
        # 2 full nodes (2x2 low pods); high gang of 3 must evict 3 victims
        # spread over both nodes and pipeline all 3
        store, cache, ssn = self._cluster(2, 2, 3, mode)
        execute(ssn, "preempt")
        assert len(cache.evictor.evicts) == 3
        assert all(e.startswith("c1/low") for e in cache.evictor.evicts)
        assert ssn.jobs["c1/high"].waiting_task_num() == 3
        close_session(ssn)

    def test_nonuniform_gang_uses_scan_kernel(self, mode):
        # mixed task sizes disqualify the per-job closed-form fast path;
        # the scan kernel must produce the same gang preemption
        low_pg = build_pod_group("low", "c1", min_member=1)
        high_pg = build_pod_group("high", "c1", min_member=2)
        high_pg.spec.priority_class_name = "high-priority"
        store, cache = make_cluster(
            [build_node("n1", {"cpu": "4", "memory": "8Gi"})],
            [low_pg, high_pg],
            [build_pod("c1", f"low-{i}", "n1", "Running",
                       {"cpu": "1", "memory": "1Gi"}, "low")
             for i in range(4)]
            + [build_pod("c1", "high-big", "", "Pending",
                         {"cpu": "2", "memory": "1Gi"}, "high"),
               build_pod("c1", "high-small", "", "Pending",
                         {"cpu": "1", "memory": "1Gi"}, "high")],
            priority_classes=[PriorityClass("high-priority", 1000)])
        tiers = [Tier(plugins=[PluginOption(name="priority"),
                               PluginOption(name="gang"),
                               PluginOption(name="conformance")]),
                 Tier(plugins=[PluginOption(name="predicates"),
                               PluginOption(name="nodeorder")])]
        ssn = open_mode(cache, tiers, mode)
        execute(ssn, "preempt")
        assert len(cache.evictor.evicts) == 3  # 3 cpu freed for 2+1
        assert ssn.jobs["c1/high"].waiting_task_num() == 2
        close_session(ssn)

    def test_gang_unsatisfiable_reverts_all_evictions(self, mode):
        # high gang of 5 can never fit 2x2-CPU nodes: NOTHING may be evicted
        store, cache, ssn = self._cluster(2, 2, 5, mode)
        execute(ssn, "preempt")
        assert cache.evictor.evicts == []
        assert ssn.jobs["c1/high"].waiting_task_num() == 0
        close_session(ssn)


class TestReclaim:
    def test_cross_queue_reclaim(self, mode):
        """reclaim_test.go:44-177: q2's starving high-priority job reclaims
        from q1's low-priority job. One tier [conformance, gang], victims
        come from gang's priority comparison — reclaim across equal-priority
        jobs yields no victims in this reference version (the dispatch's
        intersection accumulator persists across tiers)."""
        from volcano_tpu_torch.models import PriorityClass
        queues = [build_queue("q1", weight=1), build_queue("q2", weight=1)]
        pg1 = build_pod_group("pg1", "c1", min_member=1, queue="q1")
        pg1.spec.priority_class_name = "low-priority"
        pg2 = build_pod_group("pg2", "c1", min_member=1, queue="q2")
        pg2.spec.priority_class_name = "high-priority"
        store, cache = make_cluster(
            [build_node("n1", {"cpu": "4", "memory": "4Gi"})],
            [pg1, pg2],
            [build_pod("c1", f"a{i}", "n1", "Running",
                       {"cpu": "1", "memory": "1Gi"}, "pg1")
             for i in range(4)]
            + [build_pod("c1", "b0", "", "Pending",
                         {"cpu": "1", "memory": "1Gi"}, "pg2")],
            queues=queues,
            priority_classes=[PriorityClass(name="high-priority", value=100),
                              PriorityClass(name="low-priority", value=1)])
        tiers = [Tier(plugins=[PluginOption(name="conformance"),
                               PluginOption(name="gang")])]
        ssn = open_mode(cache, tiers, mode)
        execute(ssn, "reclaim")
        assert len(cache.evictor.evicts) == 1
        assert cache.evictor.evicts[0].startswith("c1/a")
        job2 = ssn.jobs["c1/pg2"]
        assert job2.waiting_task_num() == 1
        close_session(ssn)

    def test_equal_priority_no_cross_queue_reclaim(self, mode):
        """With gang registered and equal job priorities, the victim
        intersection is empty and stays empty through later tiers
        (session_plugins.go:121-160 `init` persists across tiers)."""
        queues = [build_queue("q1", weight=1), build_queue("q2", weight=1)]
        pg1 = build_pod_group("pg1", "c1", min_member=1, queue="q1")
        pg2 = build_pod_group("pg2", "c1", min_member=1, queue="q2")
        store, cache = make_cluster(
            [build_node("n1", {"cpu": "4", "memory": "4Gi"})],
            [pg1, pg2],
            [build_pod("c1", f"a{i}", "n1", "Running",
                       {"cpu": "1", "memory": "1Gi"}, "pg1")
             for i in range(4)]
            + [build_pod("c1", "b0", "", "Pending",
                         {"cpu": "1", "memory": "1Gi"}, "pg2")],
            queues=queues)
        tiers = [Tier(plugins=[PluginOption(name="gang"),
                               PluginOption(name="conformance")]),
                 Tier(plugins=[PluginOption(name="proportion"),
                               PluginOption(name="predicates")])]
        ssn = open_mode(cache, tiers, mode)
        execute(ssn, "reclaim")
        assert cache.evictor.evicts == []
        close_session(ssn)

    def test_non_reclaimable_queue_protected(self, mode):
        queues = [build_queue("q1", weight=1, reclaimable=False),
                  build_queue("q2", weight=1)]
        pg1 = build_pod_group("pg1", "c1", min_member=1, queue="q1")
        pg2 = build_pod_group("pg2", "c1", min_member=1, queue="q2")
        store, cache = make_cluster(
            [build_node("n1", {"cpu": "4", "memory": "4Gi"})],
            [pg1, pg2],
            [build_pod("c1", f"a{i}", "n1", "Running",
                       {"cpu": "1", "memory": "1Gi"}, "pg1")
             for i in range(4)]
            + [build_pod("c1", "b0", "", "Pending",
                         {"cpu": "1", "memory": "1Gi"}, "pg2")],
            queues=queues)
        tiers = [Tier(plugins=[PluginOption(name="gang")]),
                 Tier(plugins=[PluginOption(name="proportion"),
                               PluginOption(name="predicates")])]
        ssn = open_mode(cache, tiers, mode)
        execute(ssn, "reclaim")
        assert cache.evictor.evicts == []
        close_session(ssn)


class TestElectReserve:
    def test_elect_then_reserve_locks_node(self):
        reservation.reset()
        from volcano_tpu_torch.models import PodGroupPhase
        pg = build_pod_group("pg1", "c1", min_member=1,
                             phase=PodGroupPhase.PENDING)
        store, cache = make_cluster(
            [build_node("n1", {"cpu": "4", "memory": "8Gi"}),
             build_node("n2", {"cpu": "8", "memory": "16Gi"})],
            [pg],
            [build_pod("c1", "p1", "", "Pending",
                       {"cpu": "1", "memory": "1Gi"}, "pg1")])
        tiers = [Tier(plugins=[PluginOption(name="reservation"),
                               PluginOption(name="gang")])]
        ssn = open_session(cache, tiers)
        get_action("elect").execute(ssn)
        assert reservation.target_job is not None
        assert reservation.target_job.name == "pg1"
        get_action("reserve").execute(ssn)
        # max-idle node locked
        assert "n2" in reservation.locked_nodes
        close_session(ssn)
        # the JAX package elects the same job and locks the same node
        from volcano_tpu.framework import get_action as j_get_action
        from volcano_tpu.utils.scheduler_helper import \
            reservation as j_reservation
        j_reservation.reset()
        try:
            _, jssn = jax_open_session(store, tiers)
            j_get_action("elect").execute(jssn)
            j_get_action("reserve").execute(jssn)
            assert j_reservation.target_job.name == "pg1"
            assert set(j_reservation.locked_nodes) \
                == set(reservation.locked_nodes)
        finally:
            j_reservation.reset()
        reservation.reset()


class TestEvictionMinimality:
    """BENCH config #4 shape, scaled down: eviction count must track the
    analytic minimum (spend free capacity everywhere before killing)."""

    def test_uniform_gang_near_minimal_evictions(self):
        from volcano_tpu_torch.api import JobInfo, NodeInfo, TaskInfo
        from volcano_tpu_torch.api.types import POD_GROUP_ANNOTATION
        from volcano_tpu_torch.models import Node, Pod, PodGroup, PodGroupSpec
        from volcano_tpu_torch.ops import bucket, flatten_snapshot
        from volcano_tpu_torch.ops.evict import (
            decode_evict_compact, solve_evict_uniform,
        )
        from volcano_tpu_torch.ops.arrays import ScoreParams

        # 20 nodes x 16 cpu; 10 x 1-cpu victims each (future idle = 6);
        # 100 claimers of 2 cpu. Analytic minimum: 5 claimers/node =
        # 3 free + 2 via evicting 4 victims -> 20 x 4 = 80 evictions.
        n_nodes, n_victims, n_claim = 20, 200, 100
        nodes = {}
        for i in range(n_nodes):
            rl = {"cpu": "16", "memory": "64Gi", "pods": 110}
            nodes[f"n{i}"] = NodeInfo(Node(name=f"n{i}", allocatable=rl,
                                           capacity=dict(rl)))
        low = JobInfo("ns/low", PodGroup(name="low", namespace="ns",
                                         spec=PodGroupSpec(min_member=1)))
        victims = []
        for i in range(n_victims):
            pod = Pod(name=f"low-{i}", namespace="ns",
                      node_name=f"n{i % n_nodes}", phase="Running",
                      annotations={POD_GROUP_ANNOTATION: "low"},
                      containers=[{"requests": {"cpu": "1",
                                                "memory": "2Gi"}}])
            t = TaskInfo(pod)
            t.status = TaskStatus.RUNNING
            low.add_task_info(t)
            nodes[f"n{i % n_nodes}"].add_task(t)
            victims.append(t)
        hi = JobInfo("ns/hi", PodGroup(name="hi", namespace="ns",
                                       spec=PodGroupSpec(min_member=n_claim)))
        claimers = []
        for i in range(n_claim):
            pod = Pod(name=f"hi-{i}", namespace="ns",
                      annotations={POD_GROUP_ANNOTATION: "hi"},
                      containers=[{"requests": {"cpu": "2",
                                                "memory": "4Gi"}}])
            t = TaskInfo(pod)
            hi.add_task_info(t)
            claimers.append(t)

        arr = flatten_snapshot({hi.uid: hi}, nodes, claimers)
        sp = ScoreParams(least_req_weight=1.0).resolved(arr.R, arr.N)
        params = {
            "binpack_weight": np.float32(sp.binpack_weight),
            "binpack_res_weights": sp.binpack_res_weights,
            "least_req_weight": np.float32(sp.least_req_weight),
            "most_req_weight": np.float32(sp.most_req_weight),
            "balanced_weight": np.float32(sp.balanced_weight),
            "node_static": sp.node_static,
        }
        node_index = {n.name: i for i, n in enumerate(arr.nodes_list)}
        ordered = sorted(victims, key=lambda t: node_index[t.node_name])
        V = bucket(len(ordered))
        J = arr.job_min.shape[0]
        v_req = np.zeros((V, arr.R), np.float32)
        v_node = np.zeros(V, np.int32)
        v_valid = np.zeros(V, bool)
        for i, t in enumerate(ordered):
            v_req[i] = t.resreq.to_vector(arr.vocab)
            v_node[i] = node_index[t.node_name]
            v_valid[i] = True
        elig = np.zeros((J, V), bool)
        elig[0, :len(ordered)] = True
        need = np.zeros(J, np.int32)
        need[0] = n_claim
        job_req = np.zeros((J, arr.R), np.float32)
        job_req[0] = arr.task_init_req[0]
        job_acct = np.zeros((J, arr.R), np.float32)
        job_acct[0] = arr.task_req[0]
        job_count = np.zeros(J, np.int32)
        job_count[0] = n_claim
        varrays = {"v_req": v_req, "v_node": v_node, "v_valid": v_valid,
                   "elig": elig, "job_need": need, "job_req": job_req,
                   "job_acct": job_acct, "job_count": job_count}
        res = solve_evict_uniform(
            arr.device_dict("cpu"),
            {k: torch.from_numpy(v) for k, v in varrays.items()},
            {k: torch.from_numpy(np.asarray(v)) for k, v in params.items()},
            device="cpu")
        assigned, evicted_by = decode_evict_compact(
            res.compact, arr.task_init_req.shape[0])
        # the JAX package's closed-form solve on the same arrays: equal
        from volcano_tpu.ops.evict import \
            decode_evict_compact as j_decode, solve_evict_uniform as j_solve
        want = j_solve(arr.numpy_dict(), varrays, params)
        j_assigned, j_evicted_by = j_decode(
            want.compact, arr.task_init_req.shape[0])
        np.testing.assert_array_equal(assigned, np.asarray(j_assigned))
        np.testing.assert_array_equal(evicted_by, np.asarray(j_evicted_by))
        placed = int((assigned[:n_claim] >= 0).sum())
        evictions = int((evicted_by >= 0).sum())
        assert placed == n_claim
        # capacity check: per node, demand must fit idle + freed
        demand = np.zeros(arr.N)
        for i in range(n_claim):
            demand[assigned[i]] += 2000.0
        freed = np.zeros(arr.N)
        for v in np.nonzero(evicted_by >= 0)[0]:
            freed[v_node[v]] += v_req[v][0]
        idle0 = arr.node_idle[:, 0]
        assert (demand <= idle0 + freed + 1e-3).all()
        # minimality: analytic minimum is 80; allow 10% slack
        assert evictions <= 88, f"evictions {evictions} vs minimum 80"


class TestPerJobHostRouting:
    """ADVICE r2 #3: a host-only claimer (PVC/affinity/GPU) must not
    downgrade the whole preempt/reclaim action — other claimers keep the
    device solver path."""

    def test_preempt_keeps_solver_for_other_claimers(self, monkeypatch):
        import volcano_tpu_torch.actions.evict_solver as es
        from volcano_tpu_torch.actions.preempt import PreemptAction

        calls = {}
        orig = es.run_evict_solver

        def spy(ssn, mode, skip_jobs=()):
            calls["skip"] = set(skip_jobs)
            return orig(ssn, mode, skip_jobs=skip_jobs)

        monkeypatch.setattr(es, "run_evict_solver", spy)

        high_pg = build_pod_group("high", min_member=1)
        high_pg.spec.priority_class_name = "high-priority"
        store, cache = make_cluster(
            [build_node("n1", {"cpu": "2", "memory": "4Gi"})],
            [build_pod_group("low", min_member=1), high_pg],
            [build_pod("default", "low-0", "n1", "Running",
                       {"cpu": "2", "memory": "2Gi"}, "low"),
             build_pod("default", "high-0", "", "Pending",
                       {"cpu": "2", "memory": "2Gi"}, "high")],
            queues=[build_queue("default", 1)],
            priority_classes=[PriorityClass("high-priority", 1000)])
        tiers = [Tier(plugins=[PluginOption(name="priority"),
                               PluginOption(name="gang"),
                               PluginOption(name="conformance")]),
                 Tier(plugins=[PluginOption(name="predicates"),
                               PluginOption(name="nodeorder")])]
        ssn = open_mode(cache, tiers, "solver")
        # simulate a host-only claimer job alongside the real one
        ssn.solver_options["host_only_jobs"] = {"default/other"}
        ssn.jax_twin[1].solver_options["host_only_jobs"] = {"default/other"}
        execute(ssn, PreemptAction(), "preempt")
        close_session(ssn)
        # the solver ran (not a whole-cycle downgrade) and skipped exactly
        # the host-only set
        assert calls["skip"] == {"default/other"}
        assert len(cache.evictor.evicts) == 1  # high evicted low via solver


class TestHierarchicalReclaim:
    def test_reclaim_victims_follow_the_weighted_tree(self, mode):
        """drf.go:348-408 (hierarchy reclaimableFn): with
        drf.enableHierarchy, reclaim victims are gated by the hdrf
        comparator AFTER the hypothetical reclaim — a starving
        heavy-weight queue reclaims from an over-share light-weight
        sibling, and both action modes agree."""
        queues = [
            build_queue("q-heavy", annotations={
                "volcano.sh/hierarchy": "root/heavy",
                "volcano.sh/hierarchy-weights": "10/8"}),
            build_queue("q-light", annotations={
                "volcano.sh/hierarchy": "root/light",
                "volcano.sh/hierarchy-weights": "10/2"}),
        ]
        pg_l = build_pod_group("pgl", "c1", min_member=1, queue="q-light")
        pg_h = build_pod_group("pgh", "c1", min_member=1, queue="q-heavy")
        store, cache = make_cluster(
            [build_node("n1", {"cpu": "4", "memory": "4Gi"})],
            [pg_l, pg_h],
            # light's job occupies the whole node; heavy starves
            [build_pod("c1", f"l{i}", "n1", "Running",
                       {"cpu": "1", "memory": "1Gi"}, "pgl")
             for i in range(4)]
            + [build_pod("c1", "h0", "", "Pending",
                         {"cpu": "1", "memory": "1Gi"}, "pgh")],
            queues=queues)
        # gang's reclaimable requires a strictly higher-priority claimer
        # (gang.go:74-98) and would empty the tier intersection for these
        # equal-priority jobs: disable it, as hierarchy confs do
        # (enabledReclaimable: false), so the hdrf comparator rule decides
        tiers = [Tier(plugins=[
            PluginOption(name="drf",
                         arguments={"drf.enableHierarchy": True}),
            PluginOption(name="gang", enabled_reclaimable=False),
            PluginOption(name="predicates"),
            PluginOption(name="nodeorder")])]
        ssn = open_mode(cache, tiers, mode)
        execute(ssn, "reclaim")
        assert len(cache.evictor.evicts) == 1, cache.evictor.evicts
        assert cache.evictor.evicts[0].startswith("c1/l")
        close_session(ssn)

    def test_no_reclaim_when_claimer_is_the_over_share_queue(self, mode):
        """The mirror case: the LIGHT-weight queue starving while the
        heavy-weight queue holds its deserved share must NOT reclaim —
        after a hypothetical reclaim the light queue's weighted key would
        overtake the heavy one's (comparator > 0), so the hdrf rule
        yields no victims."""
        queues = [
            build_queue("q-heavy", annotations={
                "volcano.sh/hierarchy": "root/heavy",
                "volcano.sh/hierarchy-weights": "10/8"}),
            build_queue("q-light", annotations={
                "volcano.sh/hierarchy": "root/light",
                "volcano.sh/hierarchy-weights": "10/2"}),
        ]
        pg_l = build_pod_group("pgl", "c1", min_member=1, queue="q-light")
        pg_h = build_pod_group("pgh", "c1", min_member=1, queue="q-heavy")
        store, cache = make_cluster(
            [build_node("n1", {"cpu": "10", "memory": "10Gi"})],
            [pg_h, pg_l],
            # heavy runs 8 of 10 cpu = exactly its 8/10 weighted share
            [build_pod("c1", f"h{i}", "n1", "Running",
                       {"cpu": "1", "memory": "1Gi"}, "pgh")
             for i in range(8)]
            + [build_pod("c1", "l0", "n1", "Running",
                         {"cpu": "1", "memory": "1Gi"}, "pgl")]
            + [build_pod("c1", "l1", "", "Pending",
                         {"cpu": "2", "memory": "2Gi"}, "pgl")],
            queues=queues)
        tiers = [Tier(plugins=[
            PluginOption(name="drf",
                         arguments={"drf.enableHierarchy": True}),
            PluginOption(name="gang", enabled_reclaimable=False),
            PluginOption(name="predicates"),
            PluginOption(name="nodeorder")])]
        ssn = open_mode(cache, tiers, mode)
        execute(ssn, "reclaim")
        # light is ENTITLED to 2/10; it already holds 1 and wants 2 more:
        # reclaiming from heavy would push heavy below ITS weighted share
        # -> the comparator refuses; nothing is evicted
        assert cache.evictor.evicts == [], cache.evictor.evicts
        close_session(ssn)
