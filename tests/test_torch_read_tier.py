"""The port's read tier (volcano_tpu_torch/client/readtier.py and the
replica relay of client/server.py) on the CPU: the cases of
tests/test_read_tier.py, the same cases and bounds, through the port's
own primary, replicas, client, controllers and Scheduler
(device="cpu"). The read tier as a composable layer (fan-out trees): a
replica
re-serves bootstrap+ship so depth-2 chains mirror byte-identically
without touching the primary, controllers ride a ReadTierStore
(replica reads, fenced primary writes, read-your-writes via min_rv),
direct-routing clients discover per-shard read endpoints through
``topology``, and the ``ship_relay`` / ``replica_stale_read`` fault
points prove the degradation ladders typed — all with the primary's
own request counters as the ground truth for "the tree absorbed it".

``TestChainObservability::test_replica_info_walks_upstream_chain`` holds
the hop-by-hop walk the reference's ``vcctl status`` test renders (the
rendering itself is tests/test_torch_cli.py's). Replica processes are
tests/test_torch_replica.py's ``replica`` role.

Tolerance: exact (encoded objects, rvs, request counters, binds).
"""

import json
import os
import signal
import subprocess
import sys
import time

import pytest

from volcano_tpu_torch.client import (
    ClusterStore, DurableClusterStore, ReadTierStore, RemoteClusterStore,
    ReplicaLagError, ReplicaStore, ShardedClusterStore, ShardRouter,
    StoreServer,
)
from volcano_tpu_torch.client.codec import encode
from volcano_tpu_torch.metrics import metrics
from volcano_tpu_torch.resilience.faultinject import faults

from test_torch_netha import free_port
from test_torch_replica import _start_replica_proc
from torch_helpers import Builders

_B = Builders("torch")
build_node, build_pod, build_queue = _B.build_node, _B.build_pod, \
    _B.build_queue

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(autouse=True)
def _reset_faults():
    faults.reset()
    yield
    faults.reset()


def wait_until(cond, timeout=15.0, interval=0.01):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return cond()


def caught_up(replica, primary_store) -> bool:
    applied = replica.applied_rv()
    if isinstance(applied, dict):
        return all(applied[str(i)] == s._rv
                   for i, s in enumerate(primary_store.shards))
    return applied == primary_store._rv


def chained_up(child, parent) -> bool:
    """child replica has applied everything its PARENT replica has."""
    a, b = child.applied_rv(), parent.applied_rv()
    if isinstance(a, dict):
        return all(a[k] == b[k] for k in b)
    return a == b


def dump(store, kinds=("pods", "nodes", "queues")) -> dict:
    out = {}
    for kind in kinds:
        objs = sorted(store.list(kind),
                      key=lambda o: (getattr(o, "namespace", "") or "",
                                     o.name))
        out[kind] = [encode(o) for o in objs]
    return out


def churn(store, n=30, ns="ns"):
    for i in range(n):
        pod = store.create("pods", build_pod(ns, f"c{i}", "", "Pending",
                                             {"cpu": "1"}, "pg"))
        if i % 3 == 0:
            pod.phase = "Running"
            store.update("pods", pod)
        if i % 5 == 0:
            store.delete("pods", f"c{i}", ns)


@pytest.fixture()
def chain(tmp_path):
    """Durable primary -> r1 (serving) -> r2 (serving): the smallest
    fan-out tree, everything in-process, both replicas caught up."""
    store = DurableClusterStore(str(tmp_path / "primary"), fsync="off")
    server = StoreServer(store).start()
    churn(store, n=20)
    r1 = ReplicaStore(server.address)
    rs1 = r1.serve()
    r1.start()
    r2 = ReplicaStore(rs1.address)
    rs2 = r2.serve()
    r2.start()
    assert wait_until(lambda: caught_up(r1, store))
    assert wait_until(lambda: chained_up(r2, r1))
    # and each ship stream has answered: a replica fresh from its
    # bootstrap reports lag None until its upstream's first frame (the
    # reference's fixture does not wait, and its replica_info case
    # flakes on that race)
    assert wait_until(lambda: r1.lag_records() is not None
                      and r2.lag_records() is not None)
    try:
        yield store, server, r1, rs1, r2, rs2
    finally:
        r2.close()
        r1.close()
        server.stop()
        store.close()


# ---------------------------------------------------------------------------
# the tentpole: replica-of-a-replica
# ---------------------------------------------------------------------------


class TestFanoutTree:
    def test_depth2_chain_byte_identity_primary_untouched(self, chain):
        store, server, r1, rs1, r2, rs2 = chain
        churn(store, n=25, ns="live")
        assert wait_until(lambda: caught_up(r2, store))
        assert dump(r1.store) == dump(store)
        assert dump(r2.store) == dump(store)
        # depth is derived from the upstream's own depth
        assert (r1.depth, r2.depth) == (1, 2)
        # the primary served exactly ONE replica: r2's bootstrap and
        # ship stream landed on r1
        counts = server._server.op_counts
        assert counts["bootstrap"] == 1
        assert counts["ship"] == 1
        assert r1.ship_served["bootstraps"] == 1
        assert r1.ship_served["streams"] == 1
        assert r1.ship_served["records"] > 0

    def test_depth2_chain_sharded(self, tmp_path):
        store = ShardedClusterStore(4, data_dir=str(tmp_path / "p"),
                                    fsync="off")
        server = ShardRouter(store).start()
        churn(store, n=40)
        r1 = ReplicaStore(server.address)
        rs1 = r1.serve()
        r1.start()
        r2 = ReplicaStore(rs1.address)
        assert r2.n_shards == 4
        r2.serve()
        r2.start()
        try:
            churn(store, n=20, ns="live")
            assert wait_until(lambda: caught_up(r2, store))
            assert dump(r2.store, kinds=("pods",)) == \
                dump(store, kinds=("pods",))
            assert dump(r1.store, kinds=("pods",)) == \
                dump(store, kinds=("pods",))
            # one ship stream per shard, all landing on r1
            assert r1.ship_served["streams"] == 4
            assert server._server.op_counts["ship"] == 4
        finally:
            r2.close()
            r1.close()
            server.stop()
            store.close()

    def test_mid_tree_rebootstrap_lands_on_parent(self, chain):
        """A gap at depth 2 re-bootstraps from the DEPTH-1 replica:
        the primary's bootstrap counter stays flat."""
        store, server, r1, rs1, r2, rs2 = chain
        # with exactly ONE record in flight the chain serializes the
        # replica_apply seam: hit 1 is r1's apply (passes, relays),
        # hit 2 is r2's — which fires and drops the record
        faults.arm("replica_apply", at=(2,), times=1)
        store.create("queues", build_queue("gapq"))
        assert wait_until(lambda: faults.fired("replica_apply") == 1)
        churn(store, n=10, ns="gap")
        assert wait_until(lambda: caught_up(r2, store))
        assert dump(r2.store) == dump(store)
        assert r2.bootstraps["apply_gap"] == 1
        assert r1.bootstraps["apply_gap"] == 0
        # the re-bootstrap was served by r1 — the primary never saw it
        assert r1.ship_served["bootstraps"] == 2  # initial + re-seed
        assert server._server.op_counts["bootstrap"] == 1

    def test_mid_tier_restart_reseeds_children_itself(self, chain):
        """r1 restarts from scratch (fresh bootstrap from the primary):
        its re-ship window floor moves to its bootstrap rv, so r2 —
        resuming below the floor — re-bootstraps from r1, not the
        primary."""
        store, server, r1, rs1, r2, rs2 = chain
        port = rs1.port
        r1.close()  # r1 (and its server) dies
        churn(store, n=15, ns="while-down")
        store.snapshot()  # the fresh r1 will seed PAST r2's resume rv
        # a fresh r1 on the same port: bootstraps from the primary's
        # newest snapshot state, ship floor = its seeded rv
        r1b = ReplicaStore(server.address)
        r1b.serve(port=port)
        r1b.start()
        try:
            assert wait_until(lambda: caught_up(r1b, store))
            churn(store, n=10, ns="after")
            assert wait_until(lambda: caught_up(r2, store), timeout=30.0)
            assert dump(r2.store) == dump(store)
            # r2 re-seeded below r1b's window — served by r1b
            assert r2.bootstraps["out_of_window"] >= 1
            assert r1b.ship_served["bootstraps"] >= 1
            # the primary served bootstraps only to the two r1
            # incarnations, never to r2
            assert server._server.op_counts["bootstrap"] == 2
        finally:
            r1b.close()


# ---------------------------------------------------------------------------
# fault points: ship_relay and replica_stale_read
# ---------------------------------------------------------------------------


class TestRelayFaults:
    def test_ship_relay_drop_resumes_from_parent(self, chain):
        """A relayed ship frame dies mid-tree: the child reconnects to
        its PARENT and resumes at a record boundary — no re-bootstrap,
        no duplicate, and the primary's counters stay flat."""
        store, server, r1, rs1, r2, rs2 = chain
        faults.arm("ship_relay", at=(1,), times=1)
        churn(store, n=12, ns="relay")
        assert wait_until(lambda: caught_up(r2, store))
        assert dump(r2.store) == dump(store)
        assert r2.bootstraps["apply_gap"] == 0
        assert r2.bootstraps["out_of_window"] == 0
        # the drop cost one reconnect — to r1, not the primary
        assert r1.ship_served["streams"] == 2
        assert server._server.op_counts["ship"] == 1
        assert server._server.op_counts["bootstrap"] == 1

    def test_stale_read_fault_is_typed(self, chain):
        store, server, r1, rs1, r2, rs2 = chain
        rc = RemoteClusterStore(rs2.address)
        try:
            min_rv = store._rv
            assert len(rc.list("pods", min_rv=min_rv)) > 0
            faults.arm("replica_stale_read", at=(1,), times=1)
            with pytest.raises(ReplicaLagError):
                rc.list("pods", min_rv=min_rv, wait_s=0.2)
            # one-shot: the next bounded read is served again
            assert len(rc.list("pods", min_rv=min_rv)) > 0
        finally:
            rc.close()

    def test_stale_read_falls_back_to_primary_in_read_tier(self, chain):
        store, server, r1, rs1, r2, rs2 = chain
        write = RemoteClusterStore(server.address)
        read = RemoteClusterStore(rs2.address)
        rts = ReadTierStore(write, read, wait_s=0.2)
        try:
            rts.create("nodes", build_node("rt-n1", {"cpu": "4"}))
            assert rts.applied_hwm() is not None
            assert [n.name for n in rts.list("nodes")] == ["rt-n1"]
            assert rts.reads_replica == 1
            faults.arm("replica_stale_read", at=(1,), times=1)
            before = server._server.op_counts["list"]
            assert [n.name for n in rts.list("nodes")] == ["rt-n1"]
            assert rts.read_fallbacks == 1
            assert server._server.op_counts["list"] == before + 1
        finally:
            read.close()
            write.close()


# ---------------------------------------------------------------------------
# the PR-16 delta dialect, served by a replica
# ---------------------------------------------------------------------------


class TestDeltaViaReplica:
    def test_delta_negotiates_and_converges_through_replica(self, chain):
        import copy
        store, server, r1, rs1, r2, rs2 = chain
        dc = RemoteClusterStore(rs2.address, delta_watch=True)
        mirror = {}

        def on_pod(event, obj, old, changed=None):
            key = f"{obj.namespace}/{obj.name}"
            if event == "delete":
                mirror.pop(key, None)
            else:
                mirror[key] = obj
        on_pod.delta_aware = True
        dc.watch("pods", on_pod)
        try:
            for i in range(8):
                store.create("pods", build_pod(
                    "d", f"dp{i}", "", "Pending", {"cpu": "1"}, "g"))
            for i in range(8):
                cur = copy.deepcopy(store.get("pods", f"dp{i}",
                                              namespace="d"))
                cur.phase = "Running"
                store.update("pods", cur)
            assert wait_until(lambda: chained_up(r2, r1) and
                              caught_up(r1, store))
            assert dc.wait_stream_applied("pods", store._rv, timeout=15)
            expect = {f"{p.namespace}/{p.name}": p.phase
                      for p in store.list("pods")}
            got = {k: v.phase for k, v in mirror.items()}
            assert got == expect
            st = dc.delta_stats
            assert st["frames"] > 0 and st["events"] > 0
            assert not st["fallbacks"]
        finally:
            dc.close()


# ---------------------------------------------------------------------------
# discovery: topology read_endpoints + read_from_replicas clients
# ---------------------------------------------------------------------------


class TestReadTierDiscovery:
    def test_announce_propagates_to_primary_topology(self, chain):
        store, server, r1, rs1, r2, rs2 = chain
        c = RemoteClusterStore(server.address)
        try:
            eps = {e["endpoint"]: e["depth"]
                   for e in c._request({"op": "topology"})
                   .get("read_endpoints") or []}
            assert eps == {rs1.address: 1, rs2.address: 2}
        finally:
            c.close()

    def test_client_prefers_deepest_replica_and_falls_back(self, chain):
        store, server, r1, rs1, r2, rs2 = chain
        c = RemoteClusterStore(server.address, read_from_replicas=True)
        try:
            store.create("nodes", build_node("disc-n", {"cpu": "2"}))
            assert wait_until(lambda: chained_up(r2, r1) and
                              caught_up(r1, store))
            before_list = server._server.op_counts["list"]
            before_get = server._server.op_counts["get"]
            assert any(n.name == "disc-n" for n in c.list("nodes"))
            assert c.get("nodes", "disc-n").name == "disc-n"
            assert c.read_tier_reads == 2
            # the deepest endpoint (r2) answered; the primary's read
            # lanes never saw the requests
            assert server._server.op_counts["list"] == before_list
            assert server._server.op_counts["get"] == before_get
            assert rs2._server.op_counts["list"] >= 1
            assert rs2._server.op_counts["get"] >= 1
            # read-your-writes: a mutation through THIS client stamps
            # the hwm the next read demands from the replica
            c.create("nodes", build_node("disc-n2", {"cpu": "2"}))
            assert c.applied_hwm() == store._rv
            assert any(n.name == "disc-n2" for n in c.list("nodes"))
            assert c.read_tier_reads == 3
            # the tree dies: reads degrade to the primary, typed+counted
            r2.close()
            r1.close()
            assert any(n.name == "disc-n2" for n in c.list("nodes"))
            assert c.read_tier_fallbacks >= 1
            assert server._server.op_counts["list"] == before_list + 1
        finally:
            c.close()


# ---------------------------------------------------------------------------
# controllers on the read tier (the e2e)
# ---------------------------------------------------------------------------


class TestControllersOnReplica:
    def test_job_schedules_with_controller_reads_on_replica(self, chain):
        """The full lifecycle with the controller manager's list/get/
        watch all riding the replica chain: the job must reach RUNNING
        with ZERO read-lane wire requests served by the primary —
        read-your-writes comes from the min_rv bound, not from reading
        the writer."""
        from volcano_tpu_torch.cache import SchedulerCache
        from volcano_tpu_torch.controllers import ControllerManager
        from volcano_tpu_torch.models import (
            Job, JobPhase, JobSpec, TaskSpec,
        )
        from volcano_tpu_torch.scheduler import Scheduler

        store, server, r1, rs1, r2, rs2 = chain
        write = RemoteClusterStore(server.address)
        read = RemoteClusterStore(rs2.address)
        cm = ControllerManager(write, read_store=read)
        cm.run()
        rts = cm.opt.cluster
        assert isinstance(rts, ReadTierStore)
        # the scheduler stays in-process on the primary store: only
        # controller traffic rides the wire in this test
        sched = Scheduler(SchedulerCache(store, device="cpu"))
        base_reads = {op: server._server.op_counts[op]
                      for op in ("list", "get", "watch", "bulk_watch")}
        for i in range(2):
            store.create("nodes", build_node(
                f"cn{i}", {"cpu": "4", "memory": "8Gi"}))
        store.create("jobs", Job(
            name="rtjob", namespace="default",
            spec=JobSpec(min_available=2, tasks=[TaskSpec(
                name="task", replicas=2, template={
                    "spec": {"containers": [{
                        "name": "c",
                        "requests": {"cpu": "1", "memory": "1Gi"}}]},
                })])))

        def job_running():
            cm.process_all()
            sched.run(stop_after=1)
            job = store.try_get("jobs", "rtjob", "default")
            return (job is not None
                    and job.status.state.phase == JobPhase.RUNNING)

        assert wait_until(job_running, timeout=60.0, interval=0.1)
        pods = store.list("pods", namespace="default")
        assert len(pods) == 2 and all(p.node_name for p in pods)
        # every controller read was answered by the replica...
        assert rts.reads_replica > 0
        assert rts.read_fallbacks == 0
        # ...with the min_rv read-your-writes bound armed by the
        # controllers' own acked mutations
        assert rts.applied_hwm() is not None and rts.applied_hwm() > 0
        # the primary's read lanes saw NOTHING over the wire
        for op, before in base_reads.items():
            assert server._server.op_counts[op] == before, op
        read.close()
        write.close()


# ---------------------------------------------------------------------------
# the scheduler on the read tier
# ---------------------------------------------------------------------------


@pytest.fixture()
def sharded_tree(tmp_path):
    """A durable 4-shard store behind a ShardRouter: yields (store, its
    address, a list the test appends its replicas to, closed after)."""
    store = ShardedClusterStore(4, data_dir=str(tmp_path / "p"),
                                fsync="off")
    router = ShardRouter(store, port=0).start()
    addr = f"127.0.0.1:{router.port}"
    made = []
    try:
        yield store, addr, made
    finally:
        for rep in reversed(made):
            rep.close()
        router.stop()
        store.close()


def grow_tree(addr, made):
    """r1 tailing ``addr``, r2 tailing r1, each served once caught up."""
    reps = []
    upstream = addr
    for _ in range(2):
        rep = ReplicaStore(upstream)
        made.append(rep)
        rep.start()
        rep.wait_applied(rep._client._request({"op": "store_info"})["rv"],
                         wait_s=30.0)
        reps.append((rep, rep.serve()))
        upstream = reps[-1][1].address
    return reps


class TestSchedulerOnReadTier:
    def test_binds_equal_a_primary_fed_twin(self, sharded_tree):
        """The port's Scheduler (device="cpu") over
        ReadTierStore(primary, depth-2 leaf): list/watch off r2 with the
        delta watch, binds direct to the primary; every cycle binds as
        an in-process twin fed the same objects, bind for bind, and the
        primary serves it only PRIMARY_KINDS."""
        import chip_smoke as cs
        from volcano_tpu_torch.client.readtier import PRIMARY_KINDS

        store, addr, made = sharded_tree
        primary = RemoteClusterStore(addr)
        tap = cs.PrimaryTap(primary, 4)
        cell = cs.NetCell(24)
        pgs, pods, _ = cell.gangs_objs(8, bound_on=24)
        canary = cell.canary()
        seed = [cell.base, pgs + canary[:1], pods + canary[1:]]
        for items in seed:
            assert not any(isinstance(r, Exception) for r in
                           primary.bulk_apply([(k, o, "create")
                                               for k, o in items]))
        (r1, rs1), (r2, rs2) = grow_tree(addr, made)
        assert r2.depth == 2
        leaf = RemoteClusterStore(rs2.address, delta_watch=True,
                                  direct_routing=False)
        rts = ReadTierStore(tap, leaf)
        try:
            cache, sched = cs.net_scheduler("cpu", rts)
            twin_store, twin_cache, twin = cs.tree_twin("cpu", leaf,
                                                        cache, seed)
            bound = 0
            for _ in range(4):
                pgs, pods, names = cell.gangs_objs(3)
                cs.feed_tree(tap, leaf, twin_store, (pgs, pods))
                sched.run_once()
                twin.run_once()
                keys = [k for g in names for k in cell.gangs[g]]
                mine = {k: cache.binder.nodes.get(k) for k in keys}
                assert mine == {k: twin_cache.binder.nodes.get(k)
                                for k in keys}
                bound += sum(n is not None for n in mine.values())
            assert bound > 0
            tap.settle(leaf)
            stored = {f"{p.namespace}/{p.name}": p.node_name
                      for p in store.list("pods") if p.node_name}
            assert all(stored[k] == n for k, n in
                       cache.binder.nodes.items())
            assert rts.reads_replica > 0
            assert rts.read_fallbacks == 0
            assert all(kind in PRIMARY_KINDS for _, kind in tap.reads)
        finally:
            leaf.close()
            primary.close()

    def test_lease_taken_and_renewed_on_the_primary(self, sharded_tree):
        """A read-tiered Scheduler's run_with_leader_election arbitrates
        its lease against the write store: the lease lives (and renews)
        on the primary, and the elector's lock holds the primary."""
        import threading

        from volcano_tpu_torch.cache import SchedulerCache
        from volcano_tpu_torch.scheduler import Scheduler

        store, addr, made = sharded_tree
        store.apply("queues", build_queue("default", weight=1))
        (_, _), (r2, rs2) = grow_tree(addr, made)
        primary = RemoteClusterStore(addr)
        leaf = RemoteClusterStore(rs2.address, direct_routing=False)
        rts = ReadTierStore(primary, leaf)
        sched = Scheduler(SchedulerCache(rts, device="cpu"), period=0.05)
        stop = threading.Event()
        t = threading.Thread(target=sched.run_with_leader_election,
                             args=(stop,),
                             kwargs=dict(identity="a", lease_duration=2.0,
                                         renew_deadline=1.5,
                                         retry_period=0.1),
                             daemon=True)
        t.start()
        try:
            assert wait_until(lambda: store.try_get("leases", "volcano")
                              is not None, timeout=20.0)
            first = store.get("leases", "volcano")
            assert first.holder_identity == "a"
            assert sched._elector.lock.store is primary
            assert wait_until(lambda: store.get("leases", "volcano")
                              .renew_time > first.renew_time, timeout=20.0)
            # the replica follows the primary's lease, it never holds one
            assert wait_until(lambda: r2.store.try_get(
                "leases", "volcano") is not None)
        finally:
            stop.set()
            t.join(timeout=10)
            leaf.close()
            primary.close()

    def test_mid_tier_restarted_caught_up_children_resume(self,
                                                         sharded_tree):
        """r1 closed and restarted on its port, served only once it has
        caught up with the primary: r2 resumes its tail without a
        bootstrap, and a watcher on r2 sees every event once (the order
        chip_smoke.py's replica role keeps; ROADMAP Queue C)."""
        store, addr, made = sharded_tree
        for i in range(400):
            store.create("pods", build_pod("ns", f"p{i}", "", "Pending",
                                           {"cpu": "1"}, "pg"))
        (r1, rs1), (r2, rs2) = grow_tree(addr, made)
        leaf = RemoteClusterStore(rs2.address, direct_routing=False)
        seen = []
        leaf.watch("pods", lambda e, o, old: seen.append((e, o.name)))
        port = rs1.port
        r1.close()
        for i in range(400, 460):
            store.create("pods", build_pod("ns", f"p{i}", "", "Pending",
                                           {"cpu": "1"}, "pg"))
        r1b = ReplicaStore(addr)
        made.append(r1b)
        r1b.start()
        r1b.wait_applied({str(i): s._rv for i, s in
                          enumerate(store.shards)}, wait_s=30.0)
        r1b.serve(port=port)
        try:
            assert wait_until(lambda: caught_up(r2, store), timeout=30.0)
            assert dict(r2.bootstraps) == {"initial": 4}
            assert wait_until(lambda: len(seen) == 460)
            assert sorted(n for _, n in seen) == sorted(
                f"p{i}" for i in range(460))
            assert not leaf.watch_failed
        finally:
            leaf.close()


@pytest.mark.cuda
def test_card_scheduler_on_read_tier():
    """chip_smoke.py's netshard phase at 60 nodes on the card: the
    Scheduler over ReadTierStore(primary of 4 worker processes, depth-2
    leaf), binds equal to an in-process twin's through a worker kill and
    a mid-tier replica kill, every launch held against the plain
    version."""
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    root = os.path.dirname(TESTS_DIR)
    code = ("import json, torch, chip_smoke as c\n"
            "out = c.phase_netshard(torch.device('cuda', 0), dict("
            "n_nodes=60, n_jobs=30, waves=4, kill_worker_wave=1, "
            "kill_replica_wave=2))\n"
            "print('NETSHARD', json.dumps([out['launches'], "
            "out['tree']['tree_ok']]))\n")
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=root, capture_output=True,
        text=True, timeout=600, env=dict(os.environ, PYTHONHASHSEED="0"))
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    launches, tree_ok = json.loads(
        proc.stdout.split("NETSHARD", 1)[1].strip().splitlines()[0])
    assert launches > 0 and tree_ok


# ---------------------------------------------------------------------------
# vcctl + metrics
# ---------------------------------------------------------------------------


class TestChainObservability:
    def test_replica_info_walks_upstream_chain(self, chain):
        # the reference's `vcctl status` chain table, read hop by hop
        store, server, r1, rs1, r2, rs2 = chain
        hops, endpoint = [], rs2.address
        while True:
            c = RemoteClusterStore(endpoint, direct_routing=False,
                                   retry_attempts=1)
            try:
                try:
                    info = c._request({"op": "replica_info"})
                except Exception:  # noqa: BLE001 — not a replica
                    info = None
                if info and info.get("ok"):
                    hops.append((endpoint, info))
                    endpoint = info["upstream"]
                    continue
                primary_rv = c._request({"op": "store_info"})["rv"]
                break
            finally:
                c.close()
        # depth-2 -> depth-1 -> primary, with lag and bootstrap columns
        assert [(e, i["depth"]) for e, i in hops] == [
            (rs2.address, 2), (rs1.address, 1)]
        assert endpoint == server.address and primary_rv == store._rv
        for _, info in hops:
            assert info["bootstraps"] == {"initial": 1}
            assert info["per_shard"]["0"]["lag_records"] == 0
            assert "lag_seconds" in info["per_shard"]["0"]

    def test_replica_info_op_and_metrics(self, chain):
        store, server, r1, rs1, r2, rs2 = chain
        c = RemoteClusterStore(rs2.address)
        try:
            info = c._request({"op": "replica_info"})
            assert info["depth"] == 2
            assert info["upstream"] == rs1.address
            assert info["per_shard"]["0"]["lag_records"] == 0
            assert info["bootstraps"] == {"initial": 1}
            # the depth-1 hop reports the traffic it re-served
            c1 = RemoteClusterStore(rs1.address)
            try:
                i1 = c1._request({"op": "replica_info"})
            finally:
                c1.close()
            assert i1["ship_served"]["streams"] >= 1
            assert i1["ship_served"]["bootstraps"] >= 1
            # against a primary the probe is refused typed, quietly
            cp = RemoteClusterStore(server.address)
            try:
                with pytest.raises(Exception, match="not a replica"):
                    cp._request({"op": "replica_info"})
            finally:
                cp.close()
            assert metrics.replica_upstream_depth.get() == 2.0
            assert metrics.replica_ship_served_records_total.get() > 0
        finally:
            c.close()


# ---------------------------------------------------------------------------
# the mid-tier kill-9 (slow)
# ---------------------------------------------------------------------------


@pytest.mark.slow
class TestMidTierKill9:
    def test_kill9_mid_tier_grandchild_reseeds_from_parent(self, tmp_path):
        """kill -9 lands on the MIDDLE of a depth-2 chain mid-churn: a
        fresh mid-tier comes up on the same port, the grandchild
        re-bootstraps FROM IT, the primary's serving counters stay
        attributable to the mid-tier alone, and the final mirrors are
        byte-identical — zero lost, zero duplicated."""

        store = DurableClusterStore(str(tmp_path / "p"), fsync="off")
        server = StoreServer(store).start()
        churn(store, n=20)
        rport = free_port()
        mid = _start_replica_proc(server.address, rport)
        r2 = ReplicaStore(f"127.0.0.1:{rport}")
        r2.start()
        try:
            assert wait_until(lambda: caught_up(r2, store))
            # churn with the kill landing mid-wave
            churn(store, n=25, ns="wave1")
            mid.send_signal(signal.SIGKILL)
            mid.wait()
            churn(store, n=25, ns="wave2")
            # compact: the restarted mid-tier seeds from this snapshot,
            # putting its re-ship floor PAST the grandchild's resume rv
            store.snapshot()
            mid = _start_replica_proc(server.address, rport)
            churn(store, n=25, ns="wave3")
            assert wait_until(lambda: caught_up(r2, store), timeout=60.0)
            assert dump(r2.store) == dump(store)
            # the grandchild re-seeded (restart moved the mid-tier's
            # ship floor past r2's resume rv) — and it did so from the
            # restarted mid-tier: the primary served exactly the two
            # mid-tier incarnations
            assert r2.bootstraps["out_of_window"] >= 1
            counts = server._server.op_counts
            assert counts["bootstrap"] == 2
            assert counts["ship"] == 2
        finally:
            r2.close()
            if mid.poll() is None:
                mid.kill()
            mid.wait()
            server.stop()
            store.close()
