"""Volume Assume/Bind semantics through the Statement boundary
(reference pkg/scheduler/cache/cache.go:234-254 wrapping volumescheduling,
statement.go:230-282 AllocateVolumes + Commit-time BindVolumes):
tests/test_volume_binding.py through the port on ``device="cpu"``; every
allocate session is also run by the JAX package over a codec copy of the
store and must bind alike. Tolerance: exact."""

import pytest

from volcano_tpu_torch.cache import SchedulerCache, FakeBinder, FakeEvictor
from volcano_tpu_torch.cache.cache import SELECTED_NODE_ANNOTATION
from volcano_tpu_torch.client import ClusterStore
from volcano_tpu_torch.conf import Configuration, PluginOption, Tier
from volcano_tpu_torch.framework import close_session, get_action, open_session
from volcano_tpu_torch.models import PersistentVolumeClaim

from torch_helpers import Builders, jax_session_binds

_B = Builders("torch")
build_node, build_pod, build_pod_group = _B.build_node, _B.build_pod, _B.build_pod_group


def tiers():
    return [Tier(plugins=[PluginOption(name="gang"),
                          PluginOption(name="priority")]),
            Tier(plugins=[PluginOption(name="predicates"),
                          PluginOption(name="nodeorder")])]


def make_cluster(nodes, podgroups, pods, pvcs=()):
    store = ClusterStore()
    cache = SchedulerCache(store, device="cpu")
    cache.binder = FakeBinder()
    cache.evictor = FakeEvictor()
    cache.run()
    for pvc in pvcs:
        store.create("pvcs", pvc)
    for n in nodes:
        store.create("nodes", n)
    for pg in podgroups:
        store.create("podgroups", pg)
    for p in pods:
        store.create("pods", p)
    return store, cache


def with_claim(pod, claim):
    pod.volumes = [{"name": "data",
                    "persistentVolumeClaim": {"claimName": claim}}]
    return pod


def run_allocate(cache, mode="host"):
    """One allocate session, held bind for bind to the JAX package's on a
    codec copy of the store."""
    confs = [Configuration("allocate", {"mode": mode})]
    want = jax_session_binds(cache.cluster, tiers(), confs)
    ssn = open_session(cache, tiers(), confs)
    get_action("allocate").execute(ssn)
    close_session(ssn)
    assert cache.binder.binds == want
    return ssn


class TestVolumeBinding:
    def test_commit_pins_claim_to_node(self):
        p = with_claim(build_pod("c1", "p1", "", "Pending",
                                 {"cpu": "1", "memory": "1Gi"}, "pg1"),
                       "claim1")
        store, cache = make_cluster(
            [build_node("n1", {"cpu": "4", "memory": "8Gi"})],
            [build_pod_group("pg1", "c1", min_member=1)], [p],
            pvcs=[PersistentVolumeClaim(name="claim1", namespace="c1")])
        run_allocate(cache)
        assert cache.binder.binds == {"c1/p1": "n1"}
        pvc = store.get("pvcs", "claim1", "c1")
        assert pvc.annotations[SELECTED_NODE_ANNOTATION] == "n1"
        assert pvc.phase == "Bound"
        assert pvc.volume_name

    @pytest.mark.parametrize("mode", ["host", "solver"])
    def test_pinned_claim_steers_placement(self, mode):
        # claim pre-pinned to n2: the pod must land there even though n1
        # scores identically. In solver mode the predicates plugin routes
        # PVC-carrying jobs through the host loop (host_only_jobs), so both
        # modes run the volume-binding predicate.
        pvc = PersistentVolumeClaim(name="claim1", namespace="c1")
        pvc.annotations[SELECTED_NODE_ANNOTATION] = "n2"
        p = with_claim(build_pod("c1", "p1", "", "Pending",
                                 {"cpu": "1", "memory": "1Gi"}, "pg1"),
                       "claim1")
        store, cache = make_cluster(
            [build_node("n1", {"cpu": "4", "memory": "8Gi"}),
             build_node("n2", {"cpu": "4", "memory": "8Gi"})],
            [build_pod_group("pg1", "c1", min_member=1)], [p], pvcs=[pvc])
        run_allocate(cache, mode=mode)
        assert cache.binder.binds == {"c1/p1": "n2"}

    def test_two_pods_sharing_claim_colocate(self):
        pvc = PersistentVolumeClaim(name="shared", namespace="c1")
        pods = [with_claim(build_pod("c1", f"p{i}", "", "Pending",
                                     {"cpu": "1", "memory": "1Gi"}, "pg1"),
                           "shared")
                for i in (1, 2)]
        store, cache = make_cluster(
            [build_node("n1", {"cpu": "4", "memory": "8Gi"}),
             build_node("n2", {"cpu": "4", "memory": "8Gi"})],
            [build_pod_group("pg1", "c1", min_member=2)], pods, pvcs=[pvc])
        run_allocate(cache)
        assert len(cache.binder.binds) == 2
        assert cache.binder.binds["c1/p1"] == cache.binder.binds["c1/p2"]

    def test_missing_claim_blocks_task_without_crash(self):
        p = with_claim(build_pod("c1", "p1", "", "Pending",
                                 {"cpu": "1", "memory": "1Gi"}, "pg1"),
                       "nope")
        store, cache = make_cluster(
            [build_node("n1", {"cpu": "4", "memory": "8Gi"})],
            [build_pod_group("pg1", "c1", min_member=1)], [p])
        run_allocate(cache)
        assert cache.binder.binds == {}

    def test_discard_reverts_assumption(self):
        # gang of 2 with only room for 1: statement discards; the claim
        # must stay unpinned (no write happened, assumption dropped)
        pvc = PersistentVolumeClaim(name="claim1", namespace="c1")
        pods = [with_claim(build_pod("c1", f"p{i}", "", "Pending",
                                     {"cpu": "3", "memory": "1Gi"}, "pg1"),
                           "claim1")
                for i in (1, 2)]
        store, cache = make_cluster(
            [build_node("n1", {"cpu": "4", "memory": "8Gi"})],
            [build_pod_group("pg1", "c1", min_member=2)], pods, pvcs=[pvc])
        run_allocate(cache)
        assert cache.binder.binds == {}
        pvc = store.get("pvcs", "claim1", "c1")
        assert SELECTED_NODE_ANNOTATION not in pvc.annotations
        assert pvc.phase == "Pending"
        # and the binder holds no stale assumptions
        assert cache.volume_binder._assumed == {}
