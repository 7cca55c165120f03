"""The port's multi-process store shards
(volcano_tpu_torch/client/shardproc.py) on the CPU: the cases of
tests/test_shardproc.py, the same cases and bounds, through the port's
own supervisor, workers (``python -m volcano_tpu_torch.client.shardproc``),
router and client — shard workers as real OS processes behind the thin
ProcShardRouter, client-side direct
routing off the ``topology`` op, supervised capped-backoff worker
restarts, the ``shard_proc_crash`` fault point, per-endpoint connection
pools — and the kill-9 chaos: one worker SIGKILLed mid-churn while
direct-routed clients write, zero lost/dup, per-shard recovered_records
matching per-shard commits.

``TestProcRouterWire`` re-runs the EXISTING test_sharded_store.py wire
suite against the multi-process configuration (the acceptance bar: the
wire protocol, resume semantics and fencing must be indistinguishable
from the in-process router for a router-only client); here it inherits
the port's own suite, tests/test_torch_sharded_store.py.

``TestSupervision::test_status_ops_show_shard_map`` holds the wire data
the reference's ``vcctl status`` test reads (store_info + topology); the
rendering is tests/test_torch_cli.py's and ``TestStandaloneShardProcs``
tests/test_torch_standalone.py's.

Tolerance: exact (objects, rvs, events, counts)."""

from __future__ import annotations

import os
import signal
import threading
import time

import pytest

import test_torch_sharded_store as tss
from test_torch_netha import free_port, run_store_crash_soak
from torch_helpers import Builders
from volcano_tpu_torch.client import (
    ClusterStore, FencedError, ProcShardRouter, ProcShardedStore,
    RemoteClusterStore, ShardProcSupervisor, ShardUnavailableError,
    StoreServer, shard_for,
)
from volcano_tpu_torch.client.server import _Handler
from volcano_tpu_torch.client.shardproc import encoded_key
from volcano_tpu_torch.client.codec import encode
from volcano_tpu_torch.models import Lease, Pod
from volcano_tpu_torch.resilience.faultinject import faults

build_pod = Builders("torch").build_pod


def wait_for(cond, timeout=15.0, interval=0.01):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return cond()


def make_pod(i, ns="ns"):
    return build_pod(ns, f"p{i}", "", "Pending", {"cpu": "1"}, "pg")


@pytest.fixture()
def proc_cluster(tmp_path):
    """4 shard-worker PROCESSES (durable, own lineages under tmp_path)
    behind a ProcShardRouter, plus a DIRECT-ROUTING client."""
    sup = ShardProcSupervisor(4, data_dir=str(tmp_path), fsync="off",
                              restart_backoff_base_s=0.1).start()
    store = ProcShardedStore(sup)
    router = ProcShardRouter(store, port=0).start()
    remote = RemoteClusterStore(f"127.0.0.1:{router.port}",
                                connect_timeout=2.0,
                                watch_backoff_cap_s=0.2,
                                direct_watch=True)
    yield sup, store, router, remote
    remote.close()
    router.stop()
    sup.stop()


# -- the existing wire suite, multi-process ----------------------------------


@pytest.fixture()
def served_shards():
    """The test_sharded_store.py fixture shape — (store, router, remote)
    — but with 4 worker PROCESSES behind a ProcShardRouter and a
    router-only client (direct_routing off): exactly what an old client
    sees. The inherited suite below must pass unchanged."""
    sup = ShardProcSupervisor(4, restart_backoff_base_s=0.1).start()
    store = ProcShardedStore(sup)
    router = ProcShardRouter(store, port=0).start()
    remote = RemoteClusterStore(f"127.0.0.1:{router.port}",
                                connect_timeout=2.0,
                                watch_backoff_cap_s=0.2,
                                direct_routing=False)
    yield store, router, remote
    remote.close()
    router.stop()
    sup.stop()


class TestProcRouterWire(tss.TestShardRouterWire):
    """test_sharded_store.py's router wire tests, re-run against worker
    processes (see the served_shards override above)."""

    def test_shard_metrics_exported(self, served_shards, tmp_path):
        # events commit in the WORKER processes, so the in-router
        # store_shard_events_total counter does not apply; worker
        # liveness/ingest observability is covered by
        # TestSupervision::test_worker_observability_metrics instead
        store, router, remote = served_shards
        sup = store.sup
        sup._poll_stats()
        from volcano_tpu_torch.metrics import metrics
        for i in range(4):
            assert metrics.store_shard_worker_up.get(
                {"shard": str(i)}) == 1.0
            assert metrics.store_shard_worker_pid.get(
                {"shard": str(i)}) == sup.workers[i].pid


class TestControllersOverProcRouter:
    def test_controllers_one_bulk_stream(self, served_shards):
        from volcano_tpu_torch.controllers import ControllerManager

        store, router, remote = served_shards
        n_socks = len(remote._watch_socks)
        mgr = ControllerManager(remote, default_queue="default",
                                bulk_watch=True)
        mgr.run()
        assert len(remote._watch_socks) == n_socks + 1
        tss.TestControllerFanout._submit_jobs(None, remote, n=2)
        assert wait_for(lambda: (mgr.process_all() or
                                 len(remote.list("podgroups")) == 2),
                        timeout=10.0)


# -- routing keys off the wire ----------------------------------------------


class TestEncodedKey:
    def test_matches_object_key_with_sparse_fields(self):
        from volcano_tpu_torch.client.store import _key
        from volcano_tpu_torch.models import Node, Queue

        # namespace "default" is the dataclass default => omitted on
        # the wire; encoded_key must still compute ns/name
        pod = Pod(name="p1")  # namespace defaults to "default"
        assert encoded_key(encode(pod)) == _key(pod) == "default/p1"
        pod2 = Pod(name="p2", namespace="other")
        assert encoded_key(encode(pod2)) == _key(pod2) == "other/p2"
        # kinds without a namespace field key by bare name
        node = Node(name="n1")
        assert encoded_key(encode(node)) == _key(node) == "n1"
        q = Queue(name="q1")
        assert encoded_key(encode(q)) == _key(q) == "q1"


# -- topology + direct routing ----------------------------------------------


class _NoTopologyHandler(_Handler):
    def _dispatch(self, store, op, req):
        if op == "topology":
            raise RuntimeError(f"unknown op {op!r}")  # a pre-topology server
        return _Handler._dispatch(self, store, op, req)


class _NoTopologyServer(StoreServer):
    handler_class = _NoTopologyHandler


class TestTopologyFallback:
    def test_shards1_inprocess_server_stays_router_only(self):
        # a single-process server answers topology with no endpoints:
        # the client must keep the exact historical routing
        server = StoreServer(ClusterStore(), port=0).start()
        remote = RemoteClusterStore(f"127.0.0.1:{server.port}")
        try:
            remote.create("pods", make_pod(0))
            remote._ensure_topology()
            assert remote._shard_endpoints == []
            assert remote._n_shards == 1
            assert remote.direct_requests == 0
            assert remote.get("pods", "p0", "ns").name == "p0"
        finally:
            remote.close()
            server.stop()

    def test_absent_topology_op_degrades_gracefully(self):
        # an old server that has never heard of the op: the fetch fails
        # typed and the client silently stays router-only
        server = _NoTopologyServer(ClusterStore(), port=0).start()
        remote = RemoteClusterStore(f"127.0.0.1:{server.port}")
        try:
            remote.create("pods", make_pod(1))
            assert remote._topo_checked
            assert remote._shard_endpoints == []
            assert len(remote.list("pods")) == 1
        finally:
            remote.close()
            server.stop()

    def test_direct_routing_lands_on_owning_worker(self, proc_cluster):
        sup, store, router, remote = proc_cluster
        for i in range(16):
            remote.create("pods", make_pod(i))
        assert remote._n_shards == 4
        assert len(remote._shard_endpoints) == 4
        assert remote.direct_requests >= 16
        # each object really lives on the shard the hash names, and the
        # worker answers for it directly
        for i in range(16):
            idx = shard_for("pods", f"ns/p{i}", 4)
            direct = RemoteClusterStore(sup.endpoint(idx),
                                        direct_routing=False)
            try:
                assert direct.get("pods", f"p{i}", "ns").name == f"p{i}"
            finally:
                direct.close()

    def test_leases_pin_to_worker_zero_and_fence_rpc(self, proc_cluster):
        sup, store, router, remote = proc_cluster
        remote.create("leases", Lease(
            name="volcano", holder_identity="a",
            renew_time=time.time(), lease_transitions=3))
        w0 = RemoteClusterStore(sup.endpoint(0), direct_routing=False)
        try:
            assert w0.get("leases", "volcano").holder_identity == "a"
        finally:
            w0.close()
        token = {"lock": "volcano", "holder": "a", "epoch": 3}
        # fenced writes on EVERY shard validate against worker 0's
        # lease record via the fence_check RPC
        for i in range(12):
            remote.create("pods", make_pod(i), fencing=token)
        with pytest.raises(FencedError):
            remote.create("pods", make_pod(50), fencing={
                "lock": "volcano", "holder": "b", "epoch": 3})
        with pytest.raises(FencedError):
            remote.delete("pods", "p0", "ns", fencing={
                "lock": "volcano", "holder": "a", "epoch": 2})

    def test_direct_failure_falls_back_to_router(self, proc_cluster):
        sup, store, router, remote = proc_cluster
        remote.create("pods", make_pod(0))  # resolves topology
        # break ONE shard's direct endpoint (a dead port): single-key
        # ops for that shard must fall back to the router and still land
        victim = shard_for("pods", "ns/fb0", 4)
        remote.retry_attempts = 0
        remote._shard_endpoints[victim] = ("127.0.0.1", free_port())
        pod = build_pod("ns", "fb0", "", "Pending", {"cpu": "1"}, "pg")
        remote.create("pods", pod)
        assert remote.direct_fallbacks >= 1
        assert remote.get("pods", "fb0", "ns").name == "fb0"

    def test_per_endpoint_connection_pools(self, proc_cluster):
        sup, store, router, remote = proc_cluster
        for i in range(16):
            remote.create("pods", make_pod(i))
        # direct connections live in their own per-endpoint pools, not
        # serialized through the router's socket
        assert len(remote._pools) >= 3
        for pool in remote._pools.values():
            assert pool["n"] <= remote.pool_size


# -- supervision -------------------------------------------------------------


class TestSupervision:
    def test_down_worker_contained_then_restarted(self, proc_cluster):
        sup, store, router, remote = proc_cluster
        for i in range(12):
            remote.create("pods", make_pod(i))
        victim = sup.workers[2]
        os.kill(victim.pid, signal.SIGKILL)
        assert wait_for(lambda: not victim.alive, timeout=10.0)
        # while down: typed containment through the router for a client
        # with no retry budget
        impatient = RemoteClusterStore(f"127.0.0.1:{router.port}",
                                       direct_routing=False,
                                       retry_attempts=0)
        try:
            key = next(i for i in range(100, 200)
                       if shard_for("pods", f"ns/p{i}", 4) == 2)
            with pytest.raises(ShardUnavailableError):
                impatient.create("pods", make_pod(key))
            with pytest.raises(ShardUnavailableError):
                impatient.list("pods")  # a partial list would lie
            other = next(i for i in range(100, 200)
                         if shard_for("pods", f"ns/p{i}", 4) != 2)
            impatient.create("pods", make_pod(other))  # others serve
        finally:
            impatient.close()
        # capped-backoff restart on the same port + data dir:
        # construction is recovery
        assert wait_for(lambda: victim.alive and victim.restarts == 1,
                        timeout=20.0)
        assert len(remote.list("pods")) == 13
        info = sup.request(2, {"op": "store_info"})
        assert info["recovered"] > 0

    def test_worker_observability_metrics(self, proc_cluster):
        from volcano_tpu_torch.metrics import metrics

        sup, store, router, remote = proc_cluster
        for i in range(20):
            remote.create("pods", make_pod(i))
        sup._poll_stats()
        time.sleep(0.1)
        for i in range(4):
            labels = {"shard": str(i)}
            assert metrics.store_shard_worker_up.get(labels) == 1.0
            assert metrics.store_shard_worker_pid.get(labels) \
                == sup.workers[i].pid
            assert metrics.store_shard_worker_uptime_seconds.get(
                labels) >= 0.0
        topo = remote._request({"op": "topology"})
        assert topo["n_shards"] == 4
        assert [w["alive"] for w in topo["workers"]] == [True] * 4
        assert [w["pid"] for w in topo["workers"]] == \
            [w.pid for w in sup.workers]

    def test_status_ops_show_shard_map(self, proc_cluster):
        # what the reference's `vcctl status` renders, read off the wire
        sup, store, router, remote = proc_cluster
        info = remote._request({"op": "store_info"})
        topo = remote._request({"op": "topology"})
        assert topo["n_shards"] == 4
        assert info["durable"]
        assert sorted(info["rv"]) == ["0", "1", "2", "3"]
        workers = topo["workers"]
        assert [w["shard"] for w in workers] == [0, 1, 2, 3]
        for w, worker in zip(workers, sup.workers):
            assert w["pid"] == worker.pid
            assert w["endpoint"] == sup.endpoint(worker.idx)
            assert w["alive"] and w["restarts"] == 0
            assert "uptime_s" in w and "events_per_sec" in w

    def test_shard_proc_crash_fault_point(self, tmp_path):
        # arm exc:exit in ONE worker: it dies at its Nth dispatched op,
        # the supervisor restarts it, and a retrying client rides
        # through with every write landing exactly once
        sup = ShardProcSupervisor(
            2, data_dir=str(tmp_path), fsync="off",
            restart_backoff_base_s=0.1,
            worker_faults={1: "shard_proc_crash=at:6,exc:exit"}).start()
        store = ProcShardedStore(sup)
        router = ProcShardRouter(store, port=0).start()
        remote = RemoteClusterStore(f"127.0.0.1:{router.port}",
                                    retry_base_s=0.05)
        try:
            keys = [i for i in range(200)
                    if shard_for("pods", f"ns/p{i}", 2) == 1][:12]
            for i in keys:
                remote.create("pods", make_pod(i))
            assert wait_for(
                lambda: sup.workers[1].restarts >= 1
                and sup.workers[1].alive, timeout=20.0)
            listed = {p.name for p in remote.list("pods")}
            assert listed == {f"p{i}" for i in keys}
        finally:
            remote.close()
            router.stop()
            sup.stop()


# -- kill-9 mid-churn (the satellite chaos test) ------------------------------


class TestKill9MidChurn:
    def test_worker_kill9_direct_clients_and_watchers_ride_through(
            self, proc_cluster):
        sup, store, router, remote = proc_cluster
        seen = []
        remote.bulk_watch([("pods", lambda e, o, old:
                            seen.append(o.name))])
        assert len(remote._watch_socks) == 4  # direct per-worker streams
        stop = threading.Event()
        wrote: list = []
        errors: list = []

        def churn():
            i = 0
            while not stop.is_set():
                try:
                    remote.create("pods", make_pod(i))
                    wrote.append(f"p{i}")
                except Exception as e:  # noqa: BLE001 — counted, fails test
                    errors.append(repr(e))
                i += 1
                time.sleep(0.004)

        t = threading.Thread(target=churn)
        t.start()
        try:
            assert wait_for(lambda: len(wrote) >= 40)
            victim = sup.workers[1]
            os.kill(victim.pid, signal.SIGKILL)
            assert wait_for(lambda: victim.alive and victim.restarts == 1,
                            timeout=20.0)
            assert wait_for(lambda: len(wrote) >= 120)
        finally:
            stop.set()
            t.join()
        # direct-routed writers rode through the worker restart: the
        # transport retry (or router fallback) landed every write once
        assert errors == []
        listed = {p.name for p in remote.list("pods")}
        assert listed == set(wrote)
        # watchers resumed via since: — zero lost, zero duplicated
        assert wait_for(lambda: len(seen) >= len(wrote), timeout=20.0)
        assert sorted(seen) == sorted(wrote)
        assert remote.watch_resumes >= 1
        assert not remote.watch_failed
        # per-shard recovery bookkeeping: the restarted worker replayed
        # exactly the records committed to ITS lineage before the kill
        per_shard = [0] * 4
        for name in wrote:
            per_shard[shard_for("pods", f"ns/{name}", 4)] += 1
        info = sup.request(1, {"op": "store_info"})
        assert info["recovered"] <= per_shard[1]
        assert info["rv"] == per_shard[1]
        for idx in (0, 2, 3):
            assert sup.request(idx, {"op": "store_info"})["rv"] \
                == per_shard[idx]


# -- the acceptance soak ------------------------------------------------------


@pytest.mark.slow
class TestShardProcKill9Soak:
    def test_worker_kill9_identical_to_golden(self, tmp_path):
        """One shard WORKER SIGKILLed mid-churn (wave 2, pods durable
        but unbound), supervisor restarts it on the same lineage —
        decisions bind-for-bind identical to a never-killed golden run,
        zero lost/dup binds, zero crash-only resyncs."""

        waves, kill_at = 5, 2
        golden = run_store_crash_soak(str(tmp_path / "golden"),
                                      waves=waves, shards=4,
                                      bulk_watch=True, shard_procs=True,
                                      direct_watch=True)
        crash = run_store_crash_soak(str(tmp_path / "crash"),
                                     waves=waves, kill_at_wave=kill_at,
                                     shards=4, bulk_watch=True,
                                     shard_procs=True, kill_worker=1,
                                     direct_watch=True)
        assert golden["stalls"] == [] and crash["stalls"] == []
        assert crash["binds_by_wave"] == golden["binds_by_wave"]
        assert crash["total_binds"] > 0
        assert crash["lost_binds"] == 0 and crash["dup_binds"] == 0
        assert crash["crashes"] == 0 and golden["crashes"] == 0
        assert crash["worker_restarts"] >= 1
        assert crash["crash_only_resyncs"] == 0
