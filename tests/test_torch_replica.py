"""The port's WAL-shipped read replicas (volcano_tpu_torch/client/
replica.py) on the CPU: the cases of tests/test_replica.py, the same
cases and bounds, through the port's own primary, replica and client —
bootstrap + ship-tail equivalence,
rv-bounded staleness, watch resume across replica AND primary restarts,
out-of-window re-bootstrap, the replica_apply/wal_ship fault points,
read-only fail-closed — and the slow kill-9 soak where a churning
primary and a watcher-laden replica are each killed twice and the
replica's final mirror must be bind-for-bind identical to a
never-killed golden.

``TestRvBoundedReads::test_replica_reads_surface_applied_rv`` holds the
wire read the reference's ``vcctl --replica --min-rv`` test makes (the
CLI's own case is tests/test_torch_cli.py's). Replica processes are this
file's ``replica`` role (``python tests/test_torch_replica.py replica
...``),
the port's counterpart of tests/replica_proc.py; read-tier tests and the
interop tests start them too.

Tolerance: exact (encoded objects, rvs, counters)."""

import argparse
import os
import subprocess
import sys
import threading
import time

import pytest

from volcano_tpu_torch.client import (
    ClusterStore, DurableClusterStore, RemoteClusterStore, ReplicaLagError,
    ReplicaReadOnlyError, ReplicaStore, ShardedClusterStore, ShardRouter,
    StoreServer,
)
from volcano_tpu_torch.client.codec import encode
from volcano_tpu_torch.metrics import metrics
from volcano_tpu_torch.resilience.faultinject import faults

from test_torch_netha import free_port, start_store_proc
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


def wait_until(cond, timeout=10.0, interval=0.01):
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


def dump(store, kinds=("pods", "nodes", "queues")) -> dict:
    """Canonical byte-comparable content of a store, per kind."""
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
def primary(tmp_path):
    store = DurableClusterStore(str(tmp_path / "primary"), fsync="off")
    server = StoreServer(store).start()
    replicas = []

    def make_replica(**kw):
        rep = ReplicaStore(server.address, **kw)
        replicas.append(rep)
        return rep

    try:
        yield store, server, make_replica
    finally:
        for rep in replicas:
            rep.close()
        server.stop()
        store.close()


class TestBootstrapAndTail:
    def test_snapshot_bootstrap_plus_tail_is_byte_identical(self, primary):
        store, server, make_replica = primary
        for i in range(10):
            store.create("nodes", build_node(f"n{i}", {"cpu": "8"}))
        store.create("queues", build_queue("q0", weight=2))
        store.snapshot()          # bootstrap seed
        churn(store, n=20)        # and a WAL tail past it
        rep = make_replica()
        assert rep.bootstraps["initial"] == 1
        assert rep.applied_rv() == store.recovered_snapshot_rv \
            or rep.applied_rv() >= 0  # seeded from the snapshot
        rep.start()
        assert wait_until(lambda: caught_up(rep, store))
        assert dump(rep.store) == dump(store)
        # live tail keeps it identical
        churn(store, n=15, ns="live")
        assert wait_until(lambda: caught_up(rep, store))
        assert dump(rep.store) == dump(store)
        assert rep.lag_records(0) == 0

    def test_no_snapshot_bootstraps_empty_and_replays_wal(self, primary):
        store, server, make_replica = primary
        churn(store, n=12)
        rep = make_replica()
        assert rep.applied_rv() == 0  # nothing compacted yet
        rep.start()
        assert wait_until(lambda: caught_up(rep, store))
        assert dump(rep.store) == dump(store)

    def test_in_memory_primary_refused(self):
        server = StoreServer(ClusterStore()).start()
        try:
            with pytest.raises(RuntimeError, match="not durable"):
                ReplicaStore(server.address)
        finally:
            server.stop()

    def test_replica_list_response_carries_applied_rv(self, primary):
        store, server, make_replica = primary
        churn(store, n=9)
        rep = make_replica()
        rs = rep.serve()
        rep.start()
        assert wait_until(lambda: caught_up(rep, store))
        rc = RemoteClusterStore(rs.address)
        try:
            objs, applied = rc.list_versioned("pods")
            assert applied == store._rv
            assert rc.last_list_applied_rv == store._rv
        finally:
            rc.close()


class TestRvBoundedReads:
    def test_min_rv_blocks_until_applied(self, primary):
        store, server, make_replica = primary
        churn(store, n=10)
        rep = make_replica()     # bootstrapped at rv 0, NOT tailing yet
        rs = rep.serve()
        rc = RemoteClusterStore(rs.address)
        got = {}

        def bounded_list():
            got["objs"], got["rv"] = rc.list_versioned(
                "pods", min_rv=store._rv, wait_s=10.0)

        t = threading.Thread(target=bounded_list)
        t.start()
        time.sleep(0.3)
        assert t.is_alive()      # blocked: the rv is not applied yet
        rep.start()
        t.join(timeout=10)
        assert not t.is_alive()
        try:
            assert got["rv"] >= store._rv
            assert dump(rep.store) == dump(store)
        finally:
            rc.close()

    def test_min_rv_fails_typed_past_wait_budget(self, primary):
        store, server, make_replica = primary
        churn(store, n=5)
        rep = make_replica()
        rs = rep.serve()
        rep.start()
        assert wait_until(lambda: caught_up(rep, store))
        rc = RemoteClusterStore(rs.address, retry_attempts=0)
        try:
            with pytest.raises(ReplicaLagError):
                rc.list("pods", min_rv=store._rv + 1000, wait_s=0.2)
        finally:
            rc.close()

    def test_primary_list_stamps_applied_rv(self, primary):
        store, server, _ = primary
        churn(store, n=5)
        rc = RemoteClusterStore(server.address)
        try:
            _, applied = rc.list_versioned("pods")
            assert applied == store._rv
        finally:
            rc.close()

    def test_replica_reads_surface_applied_rv(self, primary):
        store, server, make_replica = primary
        from volcano_tpu_torch.models import Job, JobSpec, TaskSpec
        store.create("jobs", Job(name="j1", namespace="default",
                                 spec=JobSpec(min_available=1, tasks=[
                                     TaskSpec(name="t", replicas=1)])))
        rep = make_replica()
        rs = rep.serve()
        rep.start()
        assert wait_until(lambda: caught_up(rep, store))
        rc = RemoteClusterStore(rs.address)
        try:
            jobs, applied = rc.list_versioned("jobs", min_rv=store._rv)
        finally:
            rc.close()
        assert [j.name for j in jobs] == ["j1"]
        assert applied == store._rv


class TestReadOnly:
    def test_every_mutation_fails_closed_over_the_wire(self, primary):
        store, server, make_replica = primary
        store.create("queues", build_queue("q0"))
        rep = make_replica()
        rs = rep.serve()
        rep.start()
        assert wait_until(lambda: caught_up(rep, store))
        rc = RemoteClusterStore(rs.address)
        pod = build_pod("ns", "w0", "", "Pending", {"cpu": "1"}, "pg")
        try:
            with pytest.raises(ReplicaReadOnlyError):
                rc.create("pods", pod)
            with pytest.raises(ReplicaReadOnlyError):
                rc.update("queues", build_queue("q0"))
            with pytest.raises(ReplicaReadOnlyError):
                rc.apply("queues", build_queue("q0"))
            with pytest.raises(ReplicaReadOnlyError):
                rc.delete("queues", "q0")
            with pytest.raises(ReplicaReadOnlyError):
                rc.bulk_apply([("pods", pod, "create")])
            # fenced writes (lease arbitration) fail closed the same
            # way: a replica never arbitrates leadership
            with pytest.raises(ReplicaReadOnlyError):
                rc.create("pods", pod)
            # and the replica's state never moved
            assert rc.list("pods") == []
        finally:
            rc.close()

    def test_in_process_mutations_fail_closed(self, primary):
        store, server, make_replica = primary
        rep = make_replica()
        with pytest.raises(ReplicaReadOnlyError):
            rep.store.create("pods", build_pod("ns", "x", "", "Pending",
                                               {"cpu": "1"}, "pg"))
        with pytest.raises(ReplicaReadOnlyError):
            rep.store.bulk_apply([])


class TestWatchAcrossRestarts:
    def test_watch_resumes_across_replica_restart(self, primary, tmp_path):
        store, server, make_replica = primary
        churn(store, n=8)
        port = free_port()
        rep = make_replica()
        rep.serve(port=port)
        rep.start()
        assert wait_until(lambda: caught_up(rep, store))

        mirror = {}
        resyncs = []
        rc = RemoteClusterStore(f"127.0.0.1:{port}",
                                watch_backoff_cap_s=0.5,
                                on_watch_failure=lambda: resyncs.append(1))

        def on_pod(event, obj, old):
            if event == "delete":
                mirror.pop(f"{obj.namespace}/{obj.name}", None)
            else:
                mirror[f"{obj.namespace}/{obj.name}"] = obj.phase

        rc.watch("pods", on_pod)
        try:
            churn(store, n=6, ns="w1")
            assert wait_until(lambda: caught_up(rep, store))
            # kill the replica; a fresh one takes over the same port
            rep.close()
            churn(store, n=6, ns="w2")  # events while the replica is down
            rep2 = make_replica()
            rep2.serve(port=port)
            rep2.start()
            assert wait_until(lambda: caught_up(rep2, store))
            churn(store, n=6, ns="w3")
            assert wait_until(lambda: caught_up(rep2, store))
            expect = {f"{p.namespace}/{p.name}": p.phase
                      for p in store.list("pods")}
            assert wait_until(lambda: mirror == expect)
            # the stream RESUMED (since: against the rebuilt journal);
            # the crash-only resync path never fired
            assert rc.watch_resumes >= 1
            assert not rc.watch_failed and resyncs == []
        finally:
            rc.close()

    def test_watch_resumes_across_primary_restart(self, tmp_path):
        data_dir = str(tmp_path / "p")
        port = free_port()
        store = DurableClusterStore(data_dir, fsync="off")
        server = StoreServer(store, port=port).start()
        churn(store, n=8)
        rep = ReplicaStore(server.address)
        rs = rep.serve()
        rep.start()
        assert wait_until(lambda: caught_up(rep, store))

        mirror = {}
        resyncs = []
        rc = RemoteClusterStore(rs.address, watch_backoff_cap_s=0.5,
                                on_watch_failure=lambda: resyncs.append(1))

        def on_pod(event, obj, old):
            if event == "delete":
                mirror.pop(f"{obj.namespace}/{obj.name}", None)
            else:
                mirror[f"{obj.namespace}/{obj.name}"] = obj.phase

        rc.watch("pods", on_pod)
        try:
            # primary dies (clean fd close, recovery path is identical
            # for kill -9 — the subprocess soak proves that end)
            server.stop()
            store.close()
            store2 = DurableClusterStore(data_dir, fsync="off")
            server2 = StoreServer(store2, port=port).start()
            churn(store2, n=10, ns="after")
            # the replica's tailer reconnects and resumes at its
            # applied rv; the watcher never noticed anything
            assert wait_until(lambda: caught_up(rep, store2),
                              timeout=20.0)
            assert dump(rep.store) == dump(store2)
            expect = {f"{p.namespace}/{p.name}": p.phase
                      for p in store2.list("pods")}
            assert wait_until(lambda: mirror == expect)
            assert not rc.watch_failed and resyncs == []
            assert rep.bootstraps["initial"] == 1
            assert rep.bootstraps["out_of_window"] == 0  # resumed, not
            assert rep.bootstraps["apply_gap"] == 0      # re-seeded
            server2.stop()
            store2.close()
        finally:
            rc.close()
            rep.close()


class TestHoleDetection:
    def test_out_of_window_degrades_to_fresh_bootstrap(self, tmp_path):
        store = DurableClusterStore(str(tmp_path / "p"), fsync="off",
                                    snapshot_every=10 ** 9)
        server = StoreServer(store).start()
        churn(store, n=10)
        rep = ReplicaStore(server.address)
        rep.start()
        try:
            assert wait_until(lambda: caught_up(rep, store))
            rep.close()  # replica goes offline at rv X
            # the primary churns on and compacts TWICE: segments
            # covering rv X are pruned — the window moved past the
            # sleeping replica
            churn(store, n=40, ns="gap1")
            store.snapshot()
            churn(store, n=40, ns="gap2")
            store.snapshot()
            assert store.ship_floor() > 0
            before = metrics.replica_bootstraps_total.get(
                labels={"reason": "out_of_window"})
            rep2 = ReplicaStore(server.address)
            # re-wind its applied rv to the pre-gap position, as if it
            # had resumed from a stale on-disk mirror
            rep2.store.load_state(5, None)
            rep2.start()
            assert wait_until(lambda: caught_up(rep2, store))
            assert dump(rep2.store) == dump(store)
            assert rep2.bootstraps["out_of_window"] >= 1
            assert metrics.replica_bootstraps_total.get(
                labels={"reason": "out_of_window"}) > before
            rep2.close()
        finally:
            server.stop()
            store.close()

    def test_dropped_record_triggers_rebootstrap(self, primary):
        store, server, make_replica = primary
        store.create("queues", build_queue("q0"))
        rep = make_replica()
        rep.start()
        assert wait_until(lambda: caught_up(rep, store))
        before = metrics.replica_bootstraps_total.get(
            labels={"reason": "apply_gap"})
        faults.arm("replica_apply", at=(1,), times=1)
        churn(store, n=10, ns="drop")
        assert wait_until(lambda: caught_up(rep, store))
        assert rep.bootstraps["apply_gap"] == 1
        assert metrics.replica_bootstraps_total.get(
            labels={"reason": "apply_gap"}) == before + 1
        assert dump(rep.store) == dump(store)  # the gap never served

    def test_duplicated_record_triggers_rebootstrap(self, primary):
        store, server, make_replica = primary
        store.create("queues", build_queue("q0"))
        rep = make_replica()
        rep.start()
        assert wait_until(lambda: caught_up(rep, store))
        faults.arm("replica_apply_dup", at=(1,), times=1)
        churn(store, n=10, ns="dup")
        assert wait_until(lambda: caught_up(rep, store))
        assert rep.bootstraps["apply_gap"] == 1
        assert dump(rep.store) == dump(store)

    def test_wal_ship_link_drop_resumes_at_record_boundary(self, primary):
        store, server, make_replica = primary
        churn(store, n=30)   # enough for a multi-frame catch-up
        # the 2nd ship frame send dies mid-segment (server side): the
        # tailer must reconnect and resume at its applied-record
        # boundary — no duplicate, no hole, no re-bootstrap
        faults.arm("wal_ship", at=(2,), times=1)
        rep = make_replica()
        rep.start()
        assert wait_until(lambda: caught_up(rep, store))
        churn(store, n=10, ns="after")
        assert wait_until(lambda: caught_up(rep, store))
        assert dump(rep.store) == dump(store)
        assert rep.bootstraps["apply_gap"] == 0
        assert rep.bootstraps["out_of_window"] == 0


class TestShardedReplica:
    def test_sharded_bootstrap_tail_and_bounded_reads(self, tmp_path):
        store = ShardedClusterStore(4, data_dir=str(tmp_path / "p"),
                                    fsync="off")
        server = ShardRouter(store).start()
        for i in range(30):
            store.create("pods", build_pod("ns", f"p{i}", "", "Pending",
                                           {"cpu": "1"}, "pg"))
        store.snapshot()
        for i in range(30, 50):
            store.create("pods", build_pod("ns", f"p{i}", "", "Pending",
                                           {"cpu": "1"}, "pg"))
        rep = ReplicaStore(server.address)
        assert rep.n_shards == 4
        rs = rep.serve()
        rep.start()
        rc = RemoteClusterStore(rs.address)
        try:
            assert wait_until(lambda: caught_up(rep, store))
            assert dump(rep.store, kinds=("pods",)) == \
                dump(store, kinds=("pods",))
            min_rv = {str(i): s._rv for i, s in enumerate(store.shards)}
            objs, applied = rc.list_versioned("pods", min_rv=min_rv)
            assert len(objs) == 50
            assert applied == min_rv
            with pytest.raises(ReplicaReadOnlyError):
                rc.delete("pods", "p0", "ns")
            # watch through the sharded replica serves shard-tagged
            # events the standard client consumes unchanged
            seen = []
            rc.watch("pods", lambda e, o, old: seen.append(o.name))
            assert len(seen) == 50  # replay
            store.create("pods", build_pod("ns", "live", "", "Pending",
                                           {"cpu": "1"}, "pg"))
            assert wait_until(lambda: "live" in seen)
        finally:
            rc.close()
            rep.close()
            server.stop()
            store.close()


class TestStaleListDiscard:
    def test_list_behind_stream_hwm_is_discarded_and_retried(self):
        """The PR-5-class hole for reads: a (retried) list response
        whose applied_rv is BEHIND what this client's watch stream
        already delivered must never be served — here the first
        response is forged stale and the client re-requests."""
        store = ClusterStore()
        server = StoreServer(store).start()
        rc = RemoteClusterStore(server.address)
        try:
            store.create("nodes", build_node("n1", {"cpu": "1"}))
            rc.watch("nodes", lambda *a: None)
            store.create("nodes", build_node("n2", {"cpu": "1"}))
            assert wait_until(
                lambda: rc._kind_hwm.get("nodes", {}).get("0") == 2)
            calls = []
            real = rc._request

            def flaky(payload):
                resp = real(payload)
                if payload.get("op") == "list" and not calls:
                    calls.append(1)
                    resp = dict(resp)
                    resp["applied_rv"] = 1  # behind the stream's rv 2
                return resp

            rc._request = flaky
            objs, applied = rc.list_versioned("nodes")
            assert calls  # the stale response was seen...
            assert applied == 2  # ...and discarded, not served
            assert len(objs) == 2
        finally:
            rc.close()
            server.stop()

    def test_list_ahead_of_stream_waits_for_catchup(self):
        """The other direction: a list AHEAD of the stream must not
        drive a mirror until the stream caught up (else older events
        would regress it)."""
        store = ClusterStore()
        server = StoreServer(store).start()
        rc = RemoteClusterStore(server.address)
        try:
            store.create("nodes", build_node("n1", {"cpu": "1"}))
            rc.watch("nodes", lambda *a: None)
            _, applied = rc.list_versioned("nodes")
            assert rc.wait_stream_applied("nodes", applied, timeout=5.0)
            store.create("nodes", build_node("n2", {"cpu": "1"}))
            _, applied = rc.list_versioned("nodes")
            # the stream will deliver rv 2 shortly; the wait holds the
            # caller until the mirror is at least as new as the list
            assert rc.wait_stream_applied("nodes", applied, timeout=5.0)
            assert rc._kind_hwm["nodes"]["0"] >= applied
        finally:
            rc.close()
            server.stop()


# ---------------------------------------------------------------------------
# the kill-9 soak
# ---------------------------------------------------------------------------


def _start_replica_proc(primary_addr: str, port: int,
                        timeout: float = 60.0) -> subprocess.Popen:
    """This file's ``replica`` role; waits for its READY line."""
    root = os.path.dirname(TESTS_DIR)
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "replica",
         "--primary", primary_addr, "--port", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=root, env=dict(os.environ, PYTHONPATH=os.pathsep.join(
            [root, TESTS_DIR, os.environ.get("PYTHONPATH", "")])))
    deadline = time.time() + timeout
    while time.time() < deadline:
        line = proc.stdout.readline()
        if line.startswith("READY"):
            return proc
        if proc.poll() is not None:
            break
        time.sleep(0.01)
    proc.kill()
    raise AssertionError(
        f"replica proc did not come up (rc={proc.poll()}): "
        f"{proc.stdout.read() if proc.stdout else ''}")


def _canon(encoded: dict) -> dict:
    """Run-independent object content: rv stamps can differ when a
    kill-9 retry double-applies (idempotent content, extra rv bump) and
    creation timestamps are wall clock — everything else must match a
    never-killed golden exactly."""
    f = dict(encoded.get("f") or {})
    f.pop("resource_version", None)
    f.pop("creation_timestamp", None)
    f.pop("uid", None)  # helpers mint uids from a process-global counter
    return {"__t": encoded.get("__t"), "f": f}


def run_replica_soak(data_dir: str, waves: int = 6,
                     kill_replica_at=(), kill_primary_at=(),
                     n_watchers: int = 8, pods_per_wave: int = 20,
                     wait_s: float = 45.0) -> dict:
    """Deterministic churn against a durable primary PROCESS with a
    replica PROCESS serving watchers; kill -9 lands on the replica at
    ``kill_replica_at`` waves and on the primary at ``kill_primary_at``
    waves. Returns final primary/replica dumps + watcher mirrors."""

    pport, rport = free_port(), free_port()
    # snapshot_every huge: replica bootstraps replay the whole WAL, so
    # a restarted replica's journal floor is 0 and every watcher resume
    # mark stays inside its window
    procs = {"primary": start_store_proc(pport, data_dir, fsync="off",
                                         snapshot_every=10 ** 9)}
    try:
        procs["replica"] = _start_replica_proc(f"127.0.0.1:{pport}", rport)
    except BaseException:
        procs["primary"].kill()
        raise
    writer = RemoteClusterStore(f"127.0.0.1:{pport}", connect_timeout=2.0,
                                retry_attempts=12, retry_base_s=0.1,
                                retry_cap_s=1.0)
    reader = RemoteClusterStore(f"127.0.0.1:{rport}", connect_timeout=2.0,
                                retry_attempts=12, retry_base_s=0.1,
                                retry_cap_s=1.0, watch_backoff_cap_s=0.5)
    resyncs = []
    watch_client = RemoteClusterStore(
        f"127.0.0.1:{rport}", connect_timeout=2.0,
        watch_backoff_cap_s=0.5,
        on_watch_failure=lambda: resyncs.append(1))
    mirrors = [dict() for _ in range(n_watchers)]

    def make_on_pod(mirror):
        def on_pod(event, obj, old):
            key = f"{obj.namespace}/{obj.name}"
            if event == "delete":
                mirror.pop(key, None)
            else:
                mirror[key] = obj.phase
        return on_pod

    result = {"stalls": [], "kills": []}

    def retried(fn, *a, **kw):
        # kill-9 can land mid-request: unconditional ops surface the
        # transport error to the caller, who re-applies (idempotent
        # content); NotFound on a retried delete means it landed
        from volcano_tpu_torch.client import NotFoundError
        for _ in range(30):
            try:
                return fn(*a, **kw)
            except NotFoundError:
                return None
            except (ConnectionError, OSError):
                time.sleep(0.2)
        raise AssertionError("primary stayed unreachable")

    try:
        for w, m in enumerate(mirrors):
            watch_client.watch("pods", make_on_pod(m))
        for w in range(waves):
            for i in range(pods_per_wave):
                retried(writer.apply, "pods",
                        build_pod("soak", f"w{w}-p{i}", "", "Pending",
                                  {"cpu": "1"}, "pg"))
            if w in kill_replica_at:
                # kill -9 the replica with the wave half-applied; a
                # fresh process re-bootstraps while churn continues
                procs["replica"].kill()
                procs["replica"].wait(timeout=10)
                result["kills"].append((w, "replica"))
            restarter = None
            if w in kill_primary_at:
                # kill -9 the primary MID-CHURN: the restart races the
                # wave's remaining writes, which must ride the client
                # retry rules through the outage
                procs["primary"].kill()
                procs["primary"].wait(timeout=10)
                result["kills"].append((w, "primary"))

                def _restart():
                    procs["primary"] = start_store_proc(
                        pport, data_dir, fsync="off",
                        snapshot_every=10 ** 9)

                restarter = threading.Timer(0.8, _restart)
                restarter.start()
            for i in range(pods_per_wave):
                if i % 2 == 0:
                    pod = build_pod("soak", f"w{w}-p{i}", "", "Running",
                                    {"cpu": "1"}, "pg")
                    retried(writer.apply, "pods", pod)
            if restarter is not None:
                restarter.join(timeout=60)
            if w in kill_replica_at:
                procs["replica"] = _start_replica_proc(
                    f"127.0.0.1:{pport}", rport)
            for i in range(pods_per_wave):
                if i % 4 == 0:
                    retried(writer.delete, "pods", f"w{w}-p{i}", "soak")

        # convergence: the replica's applied rv reaches the primary's
        def converged():
            try:
                prv = writer._request({"op": "store_info"})["rv"]
                arv = reader._request({"op": "store_info"})["rv"]
                return prv == arv
            except (ConnectionError, OSError):
                return False

        if not wait_until(converged, timeout=wait_s):
            result["stalls"].append("convergence")
        primary_rv = writer._request({"op": "store_info"})["rv"]
        # replica read with the explicit rv bound: the mirror must have
        # applied everything the primary committed
        replica_pods, applied = reader.list_versioned(
            "pods", min_rv=primary_rv, wait_s=20.0)
        primary_pods = writer.list("pods")
        result["applied_rv"] = applied
        result["primary_rv"] = primary_rv
        result["replica_dump"] = sorted(
            (str(encode(p)) for p in replica_pods))
        result["primary_dump"] = sorted(
            (str(encode(p)) for p in primary_pods))
        result["content"] = sorted(
            str(_canon(encode(p))) for p in primary_pods)
        expect = {f"{p.namespace}/{p.name}": p.phase for p in primary_pods}
        if not wait_until(lambda: all(m == expect for m in mirrors),
                          timeout=20.0):
            result["stalls"].append("watch_mirrors")
        result["mirrors_match"] = all(m == expect for m in mirrors)
        result["crash_only_resyncs"] = len(resyncs)
        result["watch_failed"] = watch_client.watch_failed
        return result
    finally:
        for c in (writer, reader, watch_client):
            try:
                c.close()
            except Exception:  # noqa: BLE001
                pass
        for proc in procs.values():
            proc.kill()
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass


@pytest.mark.slow
class TestReplicaKill9Soak:
    def test_kill9_both_directions_converges_to_golden(self, tmp_path):
        """The acceptance soak: replica SIGKILLed twice and primary
        SIGKILLed twice mid-churn; the replica's final mirror must be
        bind-for-bind identical to the primary AND (modulo retry-minted
        resource_versions) to a never-killed golden run — zero lost,
        zero duplicated, zero silently skipped events."""
        golden = run_replica_soak(str(tmp_path / "golden"))
        chaos = run_replica_soak(str(tmp_path / "chaos"),
                                 kill_replica_at=(1, 3),
                                 kill_primary_at=(2, 4))
        assert golden["stalls"] == [] and chaos["stalls"] == []
        assert len(chaos["kills"]) == 4
        # replica mirror byte-identical to ITS primary (rv stamps incl.)
        assert chaos["replica_dump"] == chaos["primary_dump"]
        assert golden["replica_dump"] == golden["primary_dump"]
        # chaos converged to the same cluster content as the golden
        assert chaos["content"] == golden["content"]
        # every watcher mirror tracked through all four kills
        assert chaos["mirrors_match"] and golden["mirrors_match"]
        # streams resumed; the crash-only resync path never fired
        assert chaos["crash_only_resyncs"] == 0
        assert not chaos["watch_failed"]


# ---------------------------------------------------------------------------
# the replica process (tests/replica_proc.py's counterpart)
# ---------------------------------------------------------------------------


def replica_main(args) -> int:
    """ONE port ReplicaStore following ``--primary``, serving reads on
    ``--port``; prints ``READY <port> applied=<rv>`` once serving, then
    serves until killed. Imports stay store-only (no torch), so a
    restart is fast."""
    from volcano_tpu_torch.client import (
        RemoteClusterStore as Remote, ReplicaStore as Replica,
    )
    from volcano_tpu_torch.resilience import faults as port_faults

    if args.faults:
        port_faults.configure(args.faults)
    upstream = args.primary
    if args.topology_direct:
        # --primary names a shard-worker router: tail the shard-0 worker
        probe = Remote(upstream)
        try:
            endpoints = probe._request({"op": "topology"}).get(
                "endpoints") or []
        finally:
            probe.close()
        if endpoints:
            upstream = endpoints[0]
    replica = Replica(upstream)
    server = replica.serve(port=args.port)
    replica.start()
    print(f"READY {server.port} applied={replica.applied_rv()}",
          flush=True)
    threading.Event().wait()
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="role", required=True)
    rp = sub.add_parser("replica")
    rp.add_argument("--primary", required=True)
    rp.add_argument("--port", type=int, required=True)
    rp.add_argument("--faults", default=None)
    rp.add_argument("--topology-direct", action="store_true")
    ns = ap.parse_args()
    sys.exit(replica_main(ns))
