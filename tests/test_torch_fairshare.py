"""DRF / hierarchical DRF / proportion tests (reference hdrf_test.go,
proportion semantics): tests/test_fairshare.py through the port on the
CPU (``device="cpu"``), with the reference's own expectations. Where the
JAX package computes the same result it is held to it on the same
inputs: every session's binds (over a codec copy of the store,
``torch_helpers.jax_session_binds`` / ``jax_open_session``), the
proportion plugin's deserved and the drf shares (exact), the placements
of the host-mode progressive-filling runs, and the device ops
``water_fill_deserved`` and ``hdrf_rank_state`` (the JAX side op by op,
``jax.disable_jit``: exact). The suite's own tolerances stand where it
states one (the water fill against the host plugin, rel 1e-3; the
progressive-filling drift of one task)."""

import numpy as np
import pytest

pytest.importorskip("jax")  # the JAX reference: absent on the card's machine

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from volcano_tpu_torch.api import Resource  # noqa: E402
from volcano_tpu_torch.cache import FakeBinder, FakeEvictor, SchedulerCache
from volcano_tpu_torch.client import ClusterStore
from volcano_tpu_torch.conf import Configuration, PluginOption, Tier
from volcano_tpu_torch.framework import close_session, get_action, open_session
from volcano_tpu_torch.models import PodGroupPhase

from torch_helpers import (
    Builders, jax_cache, jax_conf, jax_open_session, jax_session_binds,
)

_B = Builders("torch")
build_node = _B.build_node
build_pod = _B.build_pod
build_pod_group = _B.build_pod_group
build_queue = _B.build_queue


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


def run_actions(cache, tiers, confs=(), actions=("allocate",)):
    """``actions`` in one port session (returned open), held bind for
    bind to the same session of the JAX package over a codec copy of the
    store."""
    want = jax_session_binds(cache.cluster, tiers, confs, actions)
    ssn = open_session(cache, tiers, list(confs))
    for name in actions:
        get_action(name).execute(ssn)
    assert cache.binder.binds == want
    return ssn


def deserved(pp, names):
    return {n: (pp.queue_opts[n].deserved.milli_cpu,
                pp.queue_opts[n].deserved.memory) for n in names}


class TestProportion:
    TIERS = [Tier(plugins=[PluginOption(name="gang")]),
             Tier(plugins=[PluginOption(name="proportion"),
                           PluginOption(name="nodeorder")])]

    def _session(self, queues, podgroups, pods, nodes):
        """The port's session, with the JAX package's deserved on the
        same cluster asserted equal (exact)."""
        store, cache = make_cluster(nodes, podgroups, pods, queues)
        jcache, jssn = jax_open_session(store, self.TIERS)
        ssn = open_session(cache, self.TIERS)
        names = [q.name for q in queues]
        assert deserved(ssn.plugins["proportion"], names) \
            == deserved(jssn.plugins["proportion"], names)
        from volcano_tpu.framework import close_session as j_close
        j_close(jssn)
        return cache, ssn

    def test_water_filling_by_weight(self):
        # 2 queues, weights 3:1, both requesting more than deserved ->
        # deserved splits the 12-cpu cluster 9:3
        queues = [build_queue("q1", weight=3), build_queue("q2", weight=1)]
        pgs = [build_pod_group("pg1", queue="q1"),
               build_pod_group("pg2", queue="q2")]
        pods = ([build_pod("default", f"a{i}", "", "Pending",
                           {"cpu": "1", "memory": "1Gi"}, "pg1")
                 for i in range(12)]
                + [build_pod("default", f"b{i}", "", "Pending",
                             {"cpu": "1", "memory": "1Gi"}, "pg2")
                   for i in range(12)])
        nodes = [build_node("n1", {"cpu": "12", "memory": "100Gi"})]
        cache, ssn = self._session(queues, pgs, pods, nodes)
        pp = ssn.plugins["proportion"]
        assert pp.queue_opts["q1"].deserved.milli_cpu == pytest.approx(9000)
        assert pp.queue_opts["q2"].deserved.milli_cpu == pytest.approx(3000)
        close_session(ssn)

    def test_deserved_clamped_by_request(self):
        queues = [build_queue("q1", weight=1), build_queue("q2", weight=1)]
        pgs = [build_pod_group("pg1", queue="q1"),
               build_pod_group("pg2", queue="q2")]
        # q1 requests only 2 cpu; q2 requests a lot -> q2 gets the rest
        pods = ([build_pod("default", f"a{i}", "", "Pending",
                           {"cpu": "1", "memory": "1Gi"}, "pg1")
                 for i in range(2)]
                + [build_pod("default", f"b{i}", "", "Pending",
                             {"cpu": "1", "memory": "1Gi"}, "pg2")
                   for i in range(20)])
        nodes = [build_node("n1", {"cpu": "12", "memory": "100Gi"})]
        cache, ssn = self._session(queues, pgs, pods, nodes)
        pp = ssn.plugins["proportion"]
        assert pp.queue_opts["q1"].deserved.milli_cpu == pytest.approx(2000)
        assert pp.queue_opts["q2"].deserved.milli_cpu == pytest.approx(10000)
        close_session(ssn)

    def test_overused_and_allocation_stops(self):
        # q1 runs 20 of 24 cpus; 1:1 water-filling gives it deserved=18 ->
        # overused, so allocate skips q1's pending pod entirely
        queues = [build_queue("q1", weight=1), build_queue("q2", weight=1)]
        pgs = [build_pod_group("pg1", queue="q1"),
               build_pod_group("pg2", queue="q2")]
        pods = ([build_pod("default", f"a{i}", "n1", "Running",
                           {"cpu": "2", "memory": "1Gi"}, "pg1")
                 for i in range(6)]
                + [build_pod("default", f"a{i}", "n2", "Running",
                             {"cpu": "2", "memory": "1Gi"}, "pg1")
                   for i in range(6, 10)]
                + [build_pod("default", "a-new", "", "Pending",
                             {"cpu": "1", "memory": "1Gi"}, "pg1")]
                + [build_pod("default", f"b{i}", "", "Pending",
                             {"cpu": "1", "memory": "1Gi"}, "pg2")
                   for i in range(12)])
        nodes = [build_node("n1", {"cpu": "12", "memory": "100Gi"}),
                 build_node("n2", {"cpu": "12", "memory": "100Gi"})]
        cache, ssn = self._session(queues, pgs, pods, nodes)
        pp = ssn.plugins["proportion"]
        assert pp.queue_opts["q1"].deserved.milli_cpu == pytest.approx(12000)
        assert ssn.overused(ssn.queues["q1"])
        assert not ssn.overused(ssn.queues["q2"])
        # allocate skips the overused queue: only q2 pods get bound
        want = jax_session_binds(cache.cluster, self.TIERS)
        get_action("allocate").execute(ssn)
        assert cache.binder.binds == want
        bound = set(cache.binder.binds)
        assert all(k.startswith("default/b") for k in bound)
        assert len(bound) == 4
        close_session(ssn)

    def test_enqueueable_respects_capability(self):
        queues = [build_queue("q1", weight=1,
                              capability={"cpu": "4", "memory": "100Gi"})]
        pg1 = build_pod_group("pg1", queue="q1", phase=PodGroupPhase.PENDING,
                              min_resources={"cpu": "3", "memory": "1Gi"})
        pg2 = build_pod_group("pg2", queue="q1", phase=PodGroupPhase.PENDING,
                              min_resources={"cpu": "3", "memory": "1Gi"})
        nodes = [build_node("n1", {"cpu": "100", "memory": "1000Gi"})]
        cache, ssn = self._session(queues, [pg1, pg2], [], nodes)
        jcache, jssn = jax_open_session(cache.cluster, self.TIERS)
        from volcano_tpu.framework import get_action as j_get_action
        j_get_action("enqueue").execute(jssn)
        get_action("enqueue").execute(ssn)
        phases = sorted(j.pod_group.status.phase.value
                        for j in ssn.jobs.values())
        assert {k: j.pod_group.status.phase.value
                for k, j in ssn.jobs.items()} \
            == {k: j.pod_group.status.phase.value
                for k, j in jssn.jobs.items()}
        # only one fits under the 4-cpu capability
        assert phases == ["Inqueue", "Pending"]
        close_session(ssn)


class TestDRF:
    def test_job_order_prefers_lower_share(self):
        store, cache = make_cluster(
            [build_node("n1", {"cpu": "10", "memory": "10Gi"})],
            [build_pod_group("pg1"), build_pod_group("pg2")],
            # pg1 has 4 cpu running (share 0.4), pg2 has 1 cpu (share 0.1)
            [build_pod("default", "a0", "n1", "Running",
                       {"cpu": "4", "memory": "1Gi"}, "pg1"),
             build_pod("default", "b0", "n1", "Running",
                       {"cpu": "1", "memory": "1Gi"}, "pg2"),
             build_pod("default", "a1", "", "Pending",
                       {"cpu": "1", "memory": "1Gi"}, "pg1"),
             build_pod("default", "b1", "", "Pending",
                       {"cpu": "1", "memory": "1Gi"}, "pg2")])
        tiers = [Tier(plugins=[PluginOption(name="drf")])]
        ssn = open_session(cache, tiers)
        j1, j2 = ssn.jobs["default/pg1"], ssn.jobs["default/pg2"]
        assert ssn.job_order_fn(j2, j1)  # pg2 (lower share) first
        drf = ssn.plugins["drf"]
        assert drf.job_attrs[j1.uid].share == pytest.approx(0.4)
        assert drf.job_attrs[j1.uid].dominant_resource == "cpu"
        _, jssn = jax_open_session(store, tiers)
        jdrf = jssn.plugins["drf"]
        assert {u: (a.share, a.dominant_resource)
                for u, a in drf.job_attrs.items()} \
            == {u: (a.share, a.dominant_resource)
                for u, a in jdrf.job_attrs.items()}
        assert jssn.job_order_fn(jssn.jobs["default/pg2"],
                                 jssn.jobs["default/pg1"])
        close_session(ssn)

    def test_share_updates_on_allocate_events(self):
        store, cache = make_cluster(
            [build_node("n1", {"cpu": "10", "memory": "10Gi"})],
            [build_pod_group("pg1", min_member=1)],
            [build_pod("default", "a0", "", "Pending",
                       {"cpu": "5", "memory": "1Gi"}, "pg1")])
        tiers = [Tier(plugins=[PluginOption(name="drf")])]
        ssn = open_session(cache, tiers)
        drf = ssn.plugins["drf"]
        job = ssn.jobs["default/pg1"]
        assert drf.job_attrs[job.uid].share == 0
        task = next(iter(job.tasks.values()))
        _, jssn = jax_open_session(store, tiers)
        jjob = jssn.jobs["default/pg1"]
        jstmt = jssn.statement()
        jstmt.allocate(next(iter(jjob.tasks.values())), "n1")
        stmt = ssn.statement()
        stmt.allocate(task, "n1")
        assert drf.job_attrs[job.uid].share == pytest.approx(0.5)
        assert drf.job_attrs[job.uid].share \
            == jssn.plugins["drf"].job_attrs[jjob.uid].share
        stmt.discard()
        jstmt.discard()
        assert drf.job_attrs[job.uid].share == 0
        assert jssn.plugins["drf"].job_attrs[jjob.uid].share == 0
        close_session(ssn)


class TestDRFInKernel:
    @pytest.mark.parametrize("mode", ["solver", "host"])
    def test_saturated_cluster_splits_between_equal_jobs(self, mode):
        """Two equal jobs (min 1) competing for 8 cpus: live DRF ordering
        must split the cluster ~4:4 instead of the static snapshot order
        handing everything to the first job. In solver mode the shares are
        recomputed on device every admission round (SURVEY §7 stage 4);
        host mode re-sorts via the drf event handlers."""
        store, cache = make_cluster(
            [build_node(f"n{i}", {"cpu": "2", "memory": "8Gi"})
             for i in range(4)],
            [build_pod_group("pg1", min_member=1),
             build_pod_group("pg2", min_member=1)],
            [build_pod("default", f"a{i}", "", "Pending",
                       {"cpu": "1", "memory": "1Gi"}, "pg1")
             for i in range(8)]
            + [build_pod("default", f"b{i}", "", "Pending",
                         {"cpu": "1", "memory": "1Gi"}, "pg2")
               for i in range(8)])
        tiers = [Tier(plugins=[PluginOption(name="drf"),
                               PluginOption(name="gang")]),
                 Tier(plugins=[PluginOption(name="predicates"),
                               PluginOption(name="nodeorder")])]
        ssn = run_actions(cache, tiers,
                          [Configuration("allocate", {"mode": mode})])
        close_session(ssn)
        placed_1 = sum(1 for k in cache.binder.binds if k.startswith(
            "default/a"))
        placed_2 = sum(1 for k in cache.binder.binds if k.startswith(
            "default/b"))
        assert placed_1 + placed_2 == 8
        assert placed_1 == 4 and placed_2 == 4, (placed_1, placed_2)


class TestHDRF:
    def test_rescaling(self):
        """hdrf_test.go 'rescaling test': 10-cpu/10G node; sci gets half,
        eng's two children split the other half by dominant resource."""
        queues = [
            build_queue("root-sci", annotations={
                "volcano.sh/hierarchy": "root/sci",
                "volcano.sh/hierarchy-weights": "100/50"}),
            build_queue("root-eng-dev", annotations={
                "volcano.sh/hierarchy": "root/eng/dev",
                "volcano.sh/hierarchy-weights": "100/50/50"}),
            build_queue("root-eng-prod", annotations={
                "volcano.sh/hierarchy": "root/eng/prod",
                "volcano.sh/hierarchy-weights": "100/50/50"}),
        ]
        pgs = [build_pod_group("pg1", queue="root-sci", min_member=1),
               build_pod_group("pg21", queue="root-eng-dev", min_member=1),
               build_pod_group("pg22", queue="root-eng-prod", min_member=1)]
        pods = []
        for i in range(10):
            pods.append(build_pod("default", f"pg1-p{i}", "", "Pending",
                                  {"cpu": "1", "memory": "1G"}, "pg1"))
            pods.append(build_pod("default", f"pg21-p{i}", "", "Pending",
                                  {"cpu": "1", "memory": "0"}, "pg21"))
            pods.append(build_pod("default", f"pg22-p{i}", "", "Pending",
                                  {"cpu": "0", "memory": "1G"}, "pg22"))
        nodes = [build_node("n", {"cpu": "10", "memory": "10G"})]
        store, cache = make_cluster(nodes, pgs, pods, queues)
        tiers = [Tier(plugins=[
            PluginOption(name="drf",
                         arguments={"drf.enableHierarchy": True}),
            PluginOption(name="gang"),
            PluginOption(name="predicates"),
            PluginOption(name="nodeorder")])]
        ssn = run_actions(cache, tiers,
                          [Configuration("allocate", {"mode": "host"})])
        # tally allocated per job from binds
        alloc = {}
        for key, node in cache.binder.binds.items():
            pod_name = key.split("/")[1]
            pg = pod_name.rsplit("-p", 1)[0]
            cpu, mem = (1000, 1e9) if pg == "pg1" else \
                       ((1000, 0) if pg == "pg21" else (0, 1e9))
            c, m = alloc.get(pg, (0, 0))
            alloc[pg] = (c + cpu, m + mem)
        assert alloc["pg1"] == (5000, 5e9)
        assert alloc["pg21"][0] == 5000
        assert alloc["pg22"][1] == 5e9
        close_session(ssn)


class TestWaterFillKernel:
    """On-device water_fill_deserved parity vs the host proportion plugin."""

    def _kernel_deserved(self, total, weights, caps, requests):
        """The port's water_fill_deserved on CPU tensors, held to the JAX
        package's on the same inputs (op by op: exact)."""
        from volcano_tpu.ops.solver import water_fill_deserved as j_fill
        from volcano_tpu_torch.ops.solver import water_fill_deserved
        Q = len(weights)
        R = len(total)
        thr = np.array([10.0, 1.0] + [10.0] * (R - 2), dtype=np.float32)
        cap = np.full((Q, R), np.inf, dtype=np.float32)
        for i, c in enumerate(caps):
            if c is not None:
                cap[i] = c
        args = (np.asarray(total, np.float32),
                np.asarray(weights, np.float32), cap,
                np.asarray(requests, np.float32), thr)
        out = water_fill_deserved(*map(torch.from_numpy, args),
                                  max_iters=Q + 1).numpy()
        with jax.disable_jit():
            want = np.asarray(j_fill(*map(jnp.asarray, args),
                                     max_iters=Q + 1))
        np.testing.assert_array_equal(out, want)
        return out

    def test_weight_split(self):
        d = self._kernel_deserved(
            total=[12000.0, 100e9], weights=[3.0, 1.0],
            caps=[None, None],
            requests=[[12000.0, 12e9], [12000.0, 12e9]])
        assert d[0][0] == pytest.approx(9000, rel=1e-3)
        assert d[1][0] == pytest.approx(3000, rel=1e-3)

    def test_request_clamp_redistributes(self):
        d = self._kernel_deserved(
            total=[12000.0, 100e9], weights=[1.0, 1.0],
            caps=[None, None],
            requests=[[2000.0, 2e9], [20000.0, 20e9]])
        assert d[0][0] == pytest.approx(2000, rel=1e-3)
        assert d[1][0] == pytest.approx(10000, rel=1e-3)

    def test_capability_clamp(self):
        d = self._kernel_deserved(
            total=[12000.0, 100e9], weights=[1.0, 1.0],
            caps=[np.array([3000.0, np.inf], np.float32), None],
            requests=[[20000.0, 20e9], [20000.0, 20e9]])
        assert d[0][0] == pytest.approx(3000, rel=1e-3)
        assert d[1][0] == pytest.approx(9000, rel=1e-3)

    def test_matches_host_plugin(self):
        """Same inputs through the plugin's host water-fill and the kernel."""
        queues = [build_queue("qa", weight=2), build_queue("qb", weight=1),
                  build_queue("qc", weight=1)]
        pgs = [build_pod_group("pga", queue="qa"),
               build_pod_group("pgb", queue="qb"),
               build_pod_group("pgc", queue="qc")]
        pods = ([build_pod("default", f"a{i}", "", "Pending",
                           {"cpu": "2", "memory": "2Gi"}, "pga")
                 for i in range(10)]
                + [build_pod("default", f"b{i}", "", "Pending",
                             {"cpu": "1", "memory": "4Gi"}, "pgb")
                   for i in range(3)]
                + [build_pod("default", f"c{i}", "", "Pending",
                             {"cpu": "1", "memory": "1Gi"}, "pgc")
                   for i in range(20)])
        nodes = [build_node("n1", {"cpu": "16", "memory": "64Gi"}),
                 build_node("n2", {"cpu": "16", "memory": "64Gi"})]
        store, cache = make_cluster(nodes, pgs, pods, queues)
        tiers = [Tier(plugins=[PluginOption(name="gang")]),
                 Tier(plugins=[PluginOption(name="proportion"),
                               PluginOption(name="nodeorder")])]
        ssn = open_session(cache, tiers)
        pp = ssn.plugins["proportion"]
        total = [32000.0, float(2 * 64 * 2**30)]
        weights, requests, caps = [], [], []
        names = ["qa", "qb", "qc"]
        for n in names:
            attr = pp.queue_opts[n]
            weights.append(attr.weight)
            requests.append([attr.request.milli_cpu, attr.request.memory])
            caps.append(None)
        d = self._kernel_deserved(total, weights, caps, requests)
        for i, n in enumerate(names):
            assert d[i][0] == pytest.approx(
                pp.queue_opts[n].deserved.milli_cpu, rel=1e-3), n
            assert d[i][1] == pytest.approx(
                pp.queue_opts[n].deserved.memory, rel=1e-3), n
        close_session(ssn)


class TestHeterogeneousQueueProfiles:
    @pytest.mark.parametrize("mode", ["solver", "host"])
    def test_disjoint_resource_queues_fully_utilize(self, mode):
        """A cpu-heavy queue and a memory-heavy queue on one cluster.

        The reference STRANDS capacity here: a queue goes overused as soon
        as ANY dim exceeds its jointly-water-filled deserved
        (proportion.go:245 `!allocated.LessEqual(deserved)`), so each
        queue stops near half its own resource although nobody else wants
        it. Host mode reproduces that faithfully. The production rounds
        kernel improves on it: capped phases enforce the same fair shares
        first, then work-conserving overflow phases hand out capacity no
        competing queue could take — both queues fill their resource."""
        queues = [build_queue("qcpu", weight=1), build_queue("qmem", weight=1)]
        pgs = [build_pod_group("pgc", queue="qcpu", min_member=1),
               build_pod_group("pgm", queue="qmem", min_member=1)]
        # 8 cpu / 8Gi cluster; qcpu wants all cpu (tiny mem), qmem wants
        # all memory (tiny cpu)
        pods = ([build_pod("default", f"c{i}", "", "Pending",
                           {"cpu": "1", "memory": "64Mi"}, "pgc")
                 for i in range(8)]
                + [build_pod("default", f"m{i}", "", "Pending",
                             {"cpu": "100m", "memory": "1Gi"}, "pgm")
                   for i in range(7)])
        nodes = [build_node("n1", {"cpu": "9", "memory": "9Gi"})]
        store, cache = make_cluster(nodes, pgs, pods, queues=queues)
        tiers = [Tier(plugins=[PluginOption(name="gang")]),
                 Tier(plugins=[PluginOption(name="proportion"),
                               PluginOption(name="predicates"),
                               PluginOption(name="nodeorder")])]
        ssn = run_actions(cache, tiers,
                          [Configuration("allocate", {"mode": mode})])
        close_session(ssn)
        placed_c = sum(1 for k in cache.binder.binds if "/c" in k)
        placed_m = sum(1 for k in cache.binder.binds if "/m" in k)
        if mode == "solver":  # work-conserving: everything places
            assert (placed_c, placed_m) == (8, 7), (placed_c, placed_m)
        else:  # faithful reference stranding: stop just past deserved
            assert placed_c == 5 and placed_m == 5, (placed_c, placed_m)


class TestCapabilityQuota:
    @pytest.mark.parametrize("mode", ["solver", "host"])
    def test_overflow_never_exceeds_capability(self, mode):
        """The work-conserving overflow pass relaxes fair-share deserved
        but NEVER the hard capability quota. Solver mode stops exactly at
        the 4-cpu capability; host mode reproduces the reference's
        between-picks overused check, which lets the crossing allocation
        through (5) before stopping — both bounded, solver the stricter."""
        queues = [build_queue("q1", weight=1,
                              capability={"cpu": "4", "memory": "100Gi"})]
        pgs = [build_pod_group("pg1", queue="q1", min_member=1)]
        pods = [build_pod("default", f"a{i}", "", "Pending",
                          {"cpu": "1", "memory": "1Gi"}, "pg1")
                for i in range(8)]
        nodes = [build_node("n1", {"cpu": "8", "memory": "100Gi"})]
        store, cache = make_cluster(nodes, pgs, pods, queues=queues)
        tiers = [Tier(plugins=[PluginOption(name="gang")]),
                 Tier(plugins=[PluginOption(name="proportion"),
                               PluginOption(name="predicates"),
                               PluginOption(name="nodeorder")])]
        ssn = run_actions(cache, tiers,
                          [Configuration("allocate", {"mode": mode})])
        close_session(ssn)
        expected = 4 if mode == "solver" else 5
        assert len(cache.binder.binds) == expected, \
            sorted(cache.binder.binds)


class TestHDRFKernel:
    """The hdrf rescaling scenario through the SOLVER path: the in-kernel
    hierarchical re-rank (ops.hdrf) must reproduce the host outcome."""

    def test_rescaling_solver_mode(self):
        queues = [
            build_queue("root-sci", annotations={
                "volcano.sh/hierarchy": "root/sci",
                "volcano.sh/hierarchy-weights": "100/50"}),
            build_queue("root-eng-dev", annotations={
                "volcano.sh/hierarchy": "root/eng/dev",
                "volcano.sh/hierarchy-weights": "100/50/50"}),
            build_queue("root-eng-prod", annotations={
                "volcano.sh/hierarchy": "root/eng/prod",
                "volcano.sh/hierarchy-weights": "100/50/50"}),
        ]
        pgs = [build_pod_group("pg1", queue="root-sci", min_member=1),
               build_pod_group("pg21", queue="root-eng-dev", min_member=1),
               build_pod_group("pg22", queue="root-eng-prod", min_member=1)]
        pods = []
        for i in range(10):
            pods.append(build_pod("default", f"pg1-p{i}", "", "Pending",
                                  {"cpu": "1", "memory": "1G"}, "pg1"))
            pods.append(build_pod("default", f"pg21-p{i}", "", "Pending",
                                  {"cpu": "1", "memory": "0"}, "pg21"))
            pods.append(build_pod("default", f"pg22-p{i}", "", "Pending",
                                  {"cpu": "0", "memory": "1G"}, "pg22"))
        nodes = [build_node("n", {"cpu": "10", "memory": "10G"})]
        store, cache = make_cluster(nodes, pgs, pods, queues)
        tiers = [Tier(plugins=[
            PluginOption(name="drf",
                         arguments={"drf.enableHierarchy": True}),
            PluginOption(name="gang"),
            PluginOption(name="predicates"),
            PluginOption(name="nodeorder")])]
        ssn = run_actions(cache, tiers,
                          [Configuration("allocate", {"mode": "solver"})])
        alloc = {}
        for key, node in cache.binder.binds.items():
            pod_name = key.split("/")[1]
            pg = pod_name.rsplit("-p", 1)[0]
            cpu, mem = (1000, 1e9) if pg == "pg1" else \
                       ((1000, 0) if pg == "pg21" else (0, 1e9))
            c, m = alloc.get(pg, (0, 0))
            alloc[pg] = (c + cpu, m + mem)
        close_session(ssn)
        # sci (weight 50 at level 1) takes half; eng's two children split
        # the other half along their dominant resources
        assert alloc["pg1"] == (5000, 5e9), alloc
        assert alloc["pg21"][0] == 5000, alloc
        assert alloc["pg22"][1] == 5e9, alloc


class TestHDRFProgressiveParity:
    """Progressive-filling parity (VERDICT r4 missing #1): the round
    solver's hierarchy-aware cap (ops.hdrf.hdrf_state) must land on the
    same converged split as the reference's place-one-then-resort loop
    (drf.go:527-633, run faithfully by allocate's host mode) on mixed
    uniform/disjoint-dominant WEIGHTED trees. Tolerance: exact per-job
    equality, or an equal-total split with per-job drift <= 1 task (the
    round-batched admission may commit one like-for-like swap the strict
    sequential order would not — cf. the config2 rounds trade)."""

    HIER = [("root/a", "10/8"), ("root/b", "10/2"),
            ("root/c/x", "10/5/6"), ("root/c/y", "10/5/2")]
    #: ragged depths + heavy weight skew: the encoding's padded levels and
    #: the cap's weight-proportional steps both get exercised hard
    HIER_RAGGED = [("root/p", "10/9"), ("root/q/u/m", "10/1/3/5"),
                   ("root/q/u/n", "10/1/3/1"), ("root/q/v", "10/1/1")]
    #: cpu-heavy, mem-heavy and mixed profiles: random picks compose
    #: same-dominant and disjoint-dominant sibling subtrees
    PROFILES = [("1", "1Gi"), ("1", "64Mi"), ("100m", "1Gi")]

    def _run(self, seed, mode, hier=None):
        hier = hier or self.HIER
        # the JAX twin of a solver run compiles an hdrf solve per tree
        # shape (5-12 s on the CPU): the solver runs are held to the host
        # runs, as the reference holds them (TestHDRFKernel holds the
        # hdrf solve to the JAX package's)
        twin = mode == "host"
        rng = np.random.default_rng(seed)
        queues, pgs, pods = [], [], []
        for k in range(4):
            h, w = hier[k % 4]
            qn = f"q{k}"
            queues.append(build_queue(qn, annotations={
                "volcano.sh/hierarchy": h,
                "volcano.sh/hierarchy-weights": w}))
            pgs.append(build_pod_group(f"pg{k}", queue=qn, min_member=1))
            cpu, mem = self.PROFILES[int(rng.integers(0, 3))]
            for i in range(16):
                pods.append(build_pod(
                    "default", f"j{k}-p{i}", "", "Pending",
                    {"cpu": cpu, "memory": mem}, f"pg{k}"))
        nodes = [build_node(f"n{i}", {"cpu": "8", "memory": "8Gi"})
                 for i in range(2)]
        store, cache = make_cluster(nodes, pgs, pods, queues)
        tiers = [Tier(plugins=[
            PluginOption(name="drf",
                         arguments={"drf.enableHierarchy": True}),
            PluginOption(name="gang"),
            PluginOption(name="predicates"),
            PluginOption(name="nodeorder")])]
        # run scheduling periods to convergence, like the scheduler loop;
        # the JAX package's sessions over a copy of the cluster bind
        # alike, period for period
        from volcano_tpu.framework import close_session as j_close
        from volcano_tpu.framework import get_action as j_get_action
        from volcano_tpu.framework import open_session as j_open
        jcache = jax_cache(store) if twin else None
        confs = [Configuration("allocate", {"mode": mode})]
        prev = -1
        for _ in range(6):
            ssn = open_session(cache, tiers, confs)
            get_action("allocate").execute(ssn)
            close_session(ssn)
            if twin:
                jssn = j_open(jcache, *jax_conf(tiers, confs))
                j_get_action("allocate").execute(jssn)
                j_close(jssn)
                assert cache.binder.binds == jcache.binder.binds
            n = len(cache.binder.binds)
            if n == prev:
                break
            prev = n
        placed = {}
        for key in cache.binder.binds:
            jk = key.split("/")[1].rsplit("-p", 1)[0]
            placed[jk] = placed.get(jk, 0) + 1
        return placed

    def _check(self, host, solver, total_tol=0):
        if host == solver:
            return
        # total_tol=1 only where observed: the kernel's float32
        # scale-aware fit tolerance (ops.solver.REL_FIT_TOL) can admit an
        # exact fit the host's float64 math rejects by a handful of bytes
        assert abs(sum(host.values()) - sum(solver.values())) \
            <= total_tol, (host, solver)
        for k in set(host) | set(solver):
            assert abs(host.get(k, 0) - solver.get(k, 0)) <= 1, \
                (host, solver)

    @pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5, 6, 7])
    def test_solver_matches_host_progressive_filling(self, seed):
        self._check(self._run(seed, "host"), self._run(seed, "solver"))

    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_ragged_weight_skewed_trees(self, seed):
        self._check(self._run(seed, "host", self.HIER_RAGGED),
                    self._run(seed, "solver", self.HIER_RAGGED),
                    total_tol=1)


class TestHDRFRaggedParity:
    """Ragged-hierarchy contract (VERDICT r3 weak #4): the kernel encodes
    the host comparator (drf.go:560-633 / plugins.drf._compare_queues) as
    a fixed-depth lexicographic key, padding short paths with neutral
    levels. The fuzz asserts the kernel ordering is a REFINEMENT of the
    host's: every pair the host comparator decides (beyond float noise)
    orders identically in the kernel; the padding may only break host
    TIES (where the reference falls to its static job-order tiebreak, an
    arbitrary-but-stable choice)."""

    HIERARCHIES = [
        ("root/a", "100/3"),
        ("root/a/b", "100/3/2"),
        ("root/a/c", "100/3/1"),
        ("root/d", "100/2"),
        ("root/d/e/f", "100/2/4/1"),
        ("root/g", "100/1"),
        ("root/g/h", "100/1/2"),
    ]

    def _host_order_matrix(self, drf, root, jqueues, tol=1e-4):
        n = len(jqueues)
        out = {}
        for i in range(n):
            for j in range(n):
                if i == j:
                    continue
                r = drf._compare_queues(root, jqueues[i], jqueues[j])
                out[(i, j)] = 0 if abs(r) <= tol else (-1 if r < 0 else 1)
        return out

    @pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5, 6, 7])
    def test_kernel_refines_host_comparator(self, seed):
        from types import SimpleNamespace

        from volcano_tpu_torch.api import JobInfo, NodeInfo, TaskInfo
        from volcano_tpu_torch.api.types import POD_GROUP_ANNOTATION
        from volcano_tpu_torch.models import Node, Pod, PodGroup, PodGroupSpec
        from volcano_tpu_torch.ops import flatten_snapshot
        from volcano_tpu_torch.ops.hdrf import build_hdrf, hdrf_rank_state
        from volcano_tpu_torch.plugins.drf import DRFPlugin, _DrfAttr, _HNode

        rng = np.random.default_rng(seed)
        n_jobs = int(rng.integers(5, 9))
        picks = rng.integers(0, len(self.HIERARCHIES), size=n_jobs)

        nodes = {"n0": NodeInfo(Node(
            name="n0", allocatable={"cpu": "64", "memory": "256Gi"},
            capacity={"cpu": "64", "memory": "256Gi"}))}
        jobs, tasks, queues, jqueues = {}, [], {}, []
        allocs = []
        for k in range(n_jobs):
            hierarchy, weights = self.HIERARCHIES[picks[k]]
            qname = f"q{k}"
            q = SimpleNamespace(name=qname, weight=1, capability=None,
                                hierarchy=hierarchy, weights=weights)
            queues[qname] = q
            jqueues.append(q)
            pg = PodGroup(name=f"j{k}", namespace="z",
                          spec=PodGroupSpec(min_member=1, queue=qname))
            job = JobInfo(f"z/j{k}", pg)
            job.queue = qname
            pod = Pod(name=f"j{k}-0", namespace="z",
                      annotations={POD_GROUP_ANNOTATION: f"j{k}"},
                      containers=[{"requests": {
                          "cpu": str(1 + int(rng.integers(0, 4))),
                          "memory": f"{1 + int(rng.integers(0, 4))}Gi"}}])
            t = TaskInfo(pod)
            job.add_task_info(t)
            tasks.append(t)
            jobs[job.uid] = job
            # integral allocations so saturation comparisons are exact in
            # both float64 (host) and float32 (kernel)
            allocs.append(Resource(
                milli_cpu=1000.0 * int(rng.integers(0, 9)),
                memory=float(1 << 30) * int(rng.integers(0, 9))))

        # ---- host: build the tree, one full share update ----
        drf = DRFPlugin()
        drf.total_resource = Resource(milli_cpu=64000.0,
                                      memory=256.0 * (1 << 30))
        root = _HNode("root", 1.0, children={})
        total_allocated = Resource()
        attrs = {}
        for k, job in enumerate(jobs.values()):
            attr = _DrfAttr(allocs[k].clone())
            drf._update_share(attr)
            attrs[job.uid] = attr
            total_allocated.add(allocs[k])
            drf._build_hierarchy(root, job, attr,
                                 jqueues[k].hierarchy, jqueues[k].weights)
        demanding = {}
        for rn in drf.total_resource.resource_names():
            if total_allocated.get(rn) < drf.total_resource.get(rn):
                demanding[rn] = True
        drf._update_hierarchical_share(root, demanding)
        host = self._host_order_matrix(drf, root, jqueues)

        # ---- kernel: same tree through build_hdrf + hdrf_rank ----
        arr = flatten_snapshot(jobs, nodes, tasks, queues=queues)
        for k in range(n_jobs):
            arr.job_drf_allocated[k] = allocs[k].to_vector(arr.vocab)
        arr.drf_total = drf.total_resource.to_vector(arr.vocab)
        build_hdrf(arr, queues, attrs, total_allocated)

        fn = hdrf_rank_state(arr.device_dict("cpu"), None)
        ranks = fn(torch.zeros((arr.job_min.shape[0], arr.R),
                               dtype=torch.float32)).numpy()
        # the JAX package's re-rank on the same arrays (op by op): equal
        from volcano_tpu.ops.hdrf import hdrf_rank_state as j_rank_state
        with jax.disable_jit():
            jfn = j_rank_state({key: jnp.asarray(v) for key, v
                                in arr.numpy_dict().items()}, None)
            want = np.asarray(jfn(jnp.zeros(
                (arr.job_min.shape[0], arr.R), jnp.float32)))
        np.testing.assert_array_equal(ranks, want)
        # one task per job in flatten order: task k belongs to job k
        kernel_pos = {k: int(ranks[k]) for k in range(n_jobs)}

        violations = []
        for (i, j), cmp in host.items():
            if cmp == -1 and not kernel_pos[i] < kernel_pos[j]:
                violations.append((i, j, jqueues[i].hierarchy,
                                   jqueues[j].hierarchy))
        assert not violations, (
            f"kernel inverted host-decided pairs: {violations}; "
            f"kernel_pos={kernel_pos}")
