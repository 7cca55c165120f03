"""The port's networked store (volcano_tpu_torch.client: server, remote,
durable) on the CPU, against the JAX package's where both can meet.

- The cases of tests/test_netstore.py (remote CRUD and watch, a remote
  scheduling cache, token auth, TLS, the watch-failure callback, slow
  watchers, the WAL, durable recovery, bulk_apply, the job controller's
  bulk ingest) but for the vcctl ones, in tests/test_torch_cli.py and
  tests/test_torch_standalone.py, and the
  codec (tests/test_torch_codec.py) and the kill-9 store soak
  (tests/test_torch_netha.py), which live beside their kind.
- tests/test_delta_path.py: negotiation and the typed fallback ladder.
- tests/test_wire_delta.py's 40-cycle churn matrix: the port's Scheduler
  (device="cpu") over the port's wire, delta and object arms, bind for
  bind against the JAX Scheduler over the JAX wire under the same seeded
  churn, mirrors and packed arrays included.
- tests/test_resilience.py's TestRequestRetry, TestWatchResume,
  TestCrossProcessWatchResume (a port scheduler process) and
  TestChaosSoak; tests/test_failover.py's fencing over the wire.
- Interop: a port client against a JAX StoreServer and a JAX client
  against a port StoreServer (CRUD, watch replay and live events,
  bulk_apply, delta negotiation); one WAL directory written by each
  package and recovered by the other, the same objects and rv counters.
- ControllerManager(bulk_watch=True) over a RemoteClusterStore opens one
  stream.

Tolerance: exact (objects, binds, bytes, counters).
"""

import copy
import hashlib
import os
import random
import subprocess
import sys
import threading
import time

import pytest

from volcano_tpu_torch.cache import FakeEvictor, SchedulerCache
from volcano_tpu_torch.client import (
    AdmissionError, ClusterStore, ConflictError, DurableClusterStore,
    FencedError, NotFoundError, RemoteClusterStore, StoreServer,
)
from volcano_tpu_torch.metrics import metrics
from volcano_tpu_torch.models import Node, PodGroupPhase
from volcano_tpu_torch.resilience import CircuitBreaker, faults
from volcano_tpu_torch.scheduler import Scheduler

from torch_helpers import Builders, pkg_mod

pytest.importorskip("jax")  # the JAX reference: absent on the card's machine

_B = Builders("torch")
build_node, build_pod = _B.build_node, _B.build_pod
build_pod_group, build_queue = _B.build_pod_group, _B.build_queue
HERE = os.path.dirname(os.path.abspath(__file__))
PKGS = ("jax", "torch")


@pytest.fixture(autouse=True)
def _clean_faults():
    for pkg in PKGS:
        pkg_mod(pkg, "resilience").faults.reset()
    yield
    for pkg in PKGS:
        pkg_mod(pkg, "resilience").faults.reset()


@pytest.fixture()
def served_store():
    store = ClusterStore()
    server = StoreServer(store).start()
    try:
        yield store, RemoteClusterStore(server.address)
    finally:
        server.stop()


class TestRemoteCrud:
    def test_create_get_list_delete(self, served_store):
        store, remote = served_store
        remote.create("nodes", build_node("n1", {"cpu": "4",
                                                 "memory": "8Gi"}))
        assert store.get("nodes", "n1").name == "n1"  # landed server-side
        got = remote.get("nodes", "n1")
        assert isinstance(got, Node) and got.allocatable["cpu"] == "4"
        remote.create("pods", build_pod("ns1", "p1", "", "Pending",
                                        {"cpu": "1"}, "pg"))
        assert [p.name for p in remote.list("pods", namespace="ns1")] \
            == ["p1"]
        assert remote.list("pods", namespace="other") == []
        remote.delete("pods", "p1", "ns1")
        with pytest.raises(NotFoundError):
            remote.get("pods", "p1", "ns1")

    def test_conflict_propagates(self, served_store):
        store, remote = served_store
        remote.create("queues", build_queue("q1", weight=1))
        q = remote.get("queues", "q1")
        q2 = remote.get("queues", "q1")
        q.weight = 5
        remote.update("queues", q)
        q2.weight = 7  # stale resource_version now
        with pytest.raises(ConflictError):
            remote.update("queues", q2)
        with pytest.raises(ConflictError):
            remote.create("queues", build_queue("q1"))

    def test_admission_error_propagates(self, served_store):
        store, remote = served_store

        def deny(verb, kind, obj):
            if kind == "pods" and verb == "create":
                raise AdmissionError("no pods today")
            return obj

        store.add_interceptor(deny)
        with pytest.raises(AdmissionError, match="no pods today"):
            remote.create("pods", build_pod("ns1", "p1", "", "Pending",
                                            {"cpu": "1"}, "pg"))

    def test_remote_interceptors_rejected(self, served_store):
        _, remote = served_store
        with pytest.raises(NotImplementedError):
            remote.add_interceptor(lambda v, k, o: o)


class TestRemoteWatch:
    def test_replay_then_live_events(self, served_store):
        store, remote = served_store
        store.create("nodes", build_node("n1", {"cpu": "1"}))
        events = []
        done = threading.Event()

        def listener(event, obj, old):
            events.append((event, obj.name,
                           old.name if old is not None else None))
            if len(events) >= 3:
                done.set()

        remote.watch("nodes", listener)  # replay applied inline
        assert events == [("add", "n1", None)]
        n2 = store.create("nodes", build_node("n2", {"cpu": "1"}))
        n2.unschedulable = True
        store.update("nodes", n2)
        assert done.wait(5.0)
        assert events[1] == ("add", "n2", None)
        assert events[2] == ("update", "n2", "n2")  # old travels too

    def test_dead_watcher_unsubscribes(self, served_store):
        store, remote = served_store
        # the server's EventJournal holds one permanent listener per kind;
        # measure the WATCHER's listener against that baseline
        base = len(store._listeners["nodes"])
        remote.watch("nodes", lambda *a: None)
        deadline = time.time() + 5
        while len(store._listeners["nodes"]) <= base \
                and time.time() < deadline:
            time.sleep(0.01)
        assert len(store._listeners["nodes"]) == base + 1
        remote.close()
        # the reader thread's socket closing makes the server's next
        # heartbeat/send fail and unwatch; force an event to flush it
        for i in range(3, 40):
            store.create("nodes", build_node(f"n{i}", {"cpu": "1"}))
            if len(store._listeners["nodes"]) <= base:
                break
            time.sleep(0.1)
        assert len(store._listeners["nodes"]) == base


class TestRemoteScheduling:
    def test_remote_cache_schedules(self, served_store):
        """A SchedulerCache attached over TCP sees the same cluster and
        binds pods through the wire."""
        from volcano_tpu_torch.cache import FakeEvictor, SchedulerCache
        from volcano_tpu_torch.scheduler import Scheduler

        store, remote = served_store
        store.create("nodes", build_node("n1", {"cpu": "8",
                                                "memory": "16Gi"}))
        pg = build_pod_group("pg1", "ns1", min_member=2)
        store.create("podgroups", pg)
        for i in range(2):
            store.create("pods", build_pod("ns1", f"p{i}", "", "Pending",
                                           {"cpu": "1", "memory": "1Gi"},
                                           "pg1"))
        cache = SchedulerCache(remote, device="cpu")
        cache.evictor = FakeEvictor()
        cache.run()
        cache.wait_for_cache_sync()
        sched = Scheduler(cache)
        sched.run_once()
        cache.wait_for_effects()
        deadline = time.time() + 5
        while time.time() < deadline:
            pods = store.list("pods", namespace="ns1")
            if pods and all(p.node_name == "n1" for p in pods):
                break
            time.sleep(0.05)
        assert all(p.node_name == "n1"
                   for p in store.list("pods", namespace="ns1"))

        # a SECOND wave after the first bind's informer echo: the echoed
        # update's stale `old` must not corrupt the mirror (the cache
        # deletes by its own stored task, not the event copy)
        pg2 = build_pod_group("pg2", "ns1", min_member=2)
        store.create("podgroups", pg2)
        for i in range(2):
            store.create("pods", build_pod("ns1", f"q{i}", "", "Pending",
                                           {"cpu": "1", "memory": "1Gi"},
                                           "pg2"))
        time.sleep(0.3)  # let the watch deliver the new wave
        sched.run_once()
        cache.wait_for_effects()
        deadline = time.time() + 5
        while time.time() < deadline:
            pods = [p for p in store.list("pods", namespace="ns1")
                    if p.name.startswith("q")]
            if len(pods) == 2 and all(p.node_name for p in pods):
                break
            time.sleep(0.05)
        assert all(p.node_name == "n1" for p in pods), [
            (p.name, p.node_name) for p in pods]
        assert not remote.watch_failed


class TestStoreAuth:
    """Shared-token auth on the store server: wrong/missing token is
    refused before any op can touch the store; the right token works
    end to end (the manifest requires this for non-loopback binds)."""

    def test_token_required_and_accepted(self):
        store = ClusterStore()
        server = StoreServer(store, token="s3cret").start()
        try:
            good = RemoteClusterStore(server.address, token="s3cret")
            good.create("nodes", build_node("n1", {"cpu": "1"}))
            assert store.get("nodes", "n1").name == "n1"

            for bad_token in ("", "wrong"):
                bad = RemoteClusterStore(server.address, token=bad_token)
                with pytest.raises((RuntimeError, ConnectionError,
                                    OSError)):
                    bad.list("nodes")
            assert len(store.list("nodes")) == 1
        finally:
            server.stop()

    def test_tokenless_server_ignores_auth(self):
        store = ClusterStore()
        server = StoreServer(store).start()
        try:
            remote = RemoteClusterStore(server.address, token="whatever")
            assert remote.ping()
        finally:
            server.stop()


class TestWatchFailureCallback:
    def test_server_death_triggers_callback_once(self):
        store = ClusterStore()
        server = StoreServer(store).start()
        fired = []
        # short resume window: the server is gone for good, so the
        # crash-only fallback must fire once the reconnect attempts
        # exhaust (tests/test_resilience.py covers the resume side)
        remote = RemoteClusterStore(server.address, token="",
                                    watch_resume_window_s=1.0,
                                    on_watch_failure=lambda:
                                    fired.append(1))
        remote.watch("nodes", lambda *a: None)
        remote.watch("pods", lambda *a: None)
        server.stop()  # kills the streams
        deadline = time.time() + 10
        while not fired and time.time() < deadline:
            time.sleep(0.05)
        time.sleep(0.3)  # the second stream's failure must not re-fire
        assert fired == [1]
        assert remote.watch_failed

    def test_clean_close_does_not_fire(self):
        store = ClusterStore()
        server = StoreServer(store).start()
        fired = []
        remote = RemoteClusterStore(server.address, token="",
                                    on_watch_failure=lambda:
                                    fired.append(1))
        remote.watch("nodes", lambda *a: None)
        remote.close()
        time.sleep(0.3)
        assert fired == [] and not remote.watch_failed
        server.stop()

    def test_unknown_watch_kind_refused_without_leak(self):
        store = ClusterStore()
        server = StoreServer(store).start()
        try:
            import socket as socket_mod
            from volcano_tpu_torch.client.server import (
                MAGIC, recv_frame, send_frame,
            )
            sock = socket_mod.create_connection(
                (server.host, server.port), timeout=5)
            sock.sendall(MAGIC)
            send_frame(sock, {"op": "watch",
                              "kinds": ["pods", "bogus"]})
            resp = recv_frame(sock)
            assert resp["ok"] is False and "bogus" in resp["message"]
            sock.close()
            # nothing stayed subscribed beyond the journal's listener
            assert store._listeners["pods"] \
                == [dict(server.journal._listeners)["pods"]]
        finally:
            server.stop()


class TestStoreTLS:
    """TLS on the store protocol (the reference's equivalent seam — the
    k8s API server — is always TLS): a cert-verifying client round-trips
    CRUD and watch; a client pinning the wrong CA refuses the server; a
    plaintext client cannot talk to a TLS server."""

    @pytest.fixture()
    def certs(self, tmp_path):
        # cert generation needs pyca/cryptography, which the runtime
        # image may not carry — TLS coverage skips cleanly there
        pytest.importorskip("cryptography")
        from volcano_tpu_torch.webhooks.server import generate_self_signed_cert
        cert, key = generate_self_signed_cert(str(tmp_path / "a"))
        cert2, key2 = generate_self_signed_cert(str(tmp_path / "b"))
        return cert, key, cert2

    def test_tls_crud_and_watch_roundtrip(self, certs):
        cert, key, _ = certs
        store = ClusterStore()
        server = StoreServer(store, token="t0k",
                             tls_cert=cert, tls_key=key).start()
        try:
            remote = RemoteClusterStore(server.address, token="t0k",
                                        tls_ca=cert)
            remote.create("nodes", build_node("n1", {"cpu": "1"}))
            assert store.get("nodes", "n1").name == "n1"
            seen = []
            remote.watch("nodes", lambda ev, obj, old:
                         seen.append((ev, obj.name)))
            assert seen == [("add", "n1")]  # replay over TLS
            store.create("nodes", build_node("n2", {"cpu": "1"}))
            deadline = time.time() + 5
            while len(seen) < 2 and time.time() < deadline:
                time.sleep(0.02)
            assert ("add", "n2") in seen  # live event over TLS
        finally:
            server.stop()

    def test_wrong_ca_refused(self, certs):
        cert, key, other_cert = certs
        store = ClusterStore()
        server = StoreServer(store, tls_cert=cert, tls_key=key).start()
        try:
            bad = RemoteClusterStore(server.address, tls_ca=other_cert)
            with pytest.raises((ConnectionError, OSError)):
                bad.ping()
        finally:
            server.stop()

    def test_plaintext_client_rejected_by_tls_server(self, certs):
        cert, key, _ = certs
        store = ClusterStore()
        server = StoreServer(store, tls_cert=cert, tls_key=key).start()
        try:
            plain = RemoteClusterStore(server.address)
            with pytest.raises((RuntimeError, ConnectionError, OSError)):
                plain.ping()
            assert store.list("nodes") == []
        finally:
            server.stop()


class TestSlowWatcher:
    def test_overflowing_watcher_is_dropped_not_buffered(self, monkeypatch):
        """A watcher that never reads must be disconnected once its event
        queue overflows, instead of growing server memory without bound;
        the store itself keeps serving and other listeners are unaffected."""
        import socket as socket_mod

        from volcano_tpu_torch.client import server as srv

        monkeypatch.setattr(srv, "WATCH_QUEUE_MAX", 8)
        # the writer only notices the stall when its blocked sendall hits
        # the send timeout; the production 30s exceeds this test's budget
        monkeypatch.setattr(srv, "WATCH_SEND_TIMEOUT_S", 1.0)
        from volcano_tpu_torch.metrics import metrics

        dropped_before = metrics.store_watch_dropped_total.get()
        store = ClusterStore()
        server = StoreServer(store).start()
        try:
            sock = socket_mod.create_connection(
                (server.host, server.port), timeout=5)
            sock.sendall(srv.MAGIC)
            srv.send_frame(sock, {"op": "watch", "kinds": ["nodes"],
                                  "replay": False})
            # never read from sock; flood events until the bounded queue
            # condemns the watcher and its listener unsubscribes (the
            # journal's own per-kind listener stays, by design)
            base = 1  # the journal's listener
            # wait for the handler to actually subscribe first — flooding
            # before that point exits the loop vacuously (listeners never
            # exceeded base) and nothing was ever dropped
            deadline = time.time() + 10
            while len(store._listeners["nodes"]) <= base \
                    and time.time() < deadline:
                time.sleep(0.005)
            assert len(store._listeners["nodes"]) == base + 1
            deadline = time.time() + 10
            i = 0
            while len(store._listeners["nodes"]) > base \
                    and time.time() < deadline:
                store.apply("nodes", build_node(f"n{i % 40}",
                                                {"cpu": "1"}))
                i += 1
                time.sleep(0.001)
            assert len(store._listeners["nodes"]) == base, \
                "slow watcher was never dropped"
            # the drop is no longer log-only: it is exported
            deadline = time.time() + 5
            while metrics.store_watch_dropped_total.get() \
                    <= dropped_before and time.time() < deadline:
                time.sleep(0.02)
            assert metrics.store_watch_dropped_total.get() \
                > dropped_before
            sock.close()
        finally:
            server.stop()


class TestWAL:
    """WAL edge cases: torn-tail truncation, fsync policies, framing."""

    def _fill(self, d, n=5):
        store = DurableClusterStore(str(d))
        for i in range(n):
            store.create("nodes", build_node(f"n{i}", {"cpu": "1"}))
        store.close()
        return store

    def test_torn_final_record_truncated(self, tmp_path):
        from volcano_tpu_torch.client.durable import read_frames
        store = self._fill(tmp_path, n=5)
        seg = [p for p in os.listdir(tmp_path) if p.startswith("wal-")]
        assert len(seg) == 1
        path = str(tmp_path / seg[0])
        good_size = os.path.getsize(path)
        # a crash mid-append: half a record's worth of debris at the tail
        with open(path, "ab") as f:
            f.write(b"\xff\x00\x00\x00garbage-that-is-not-a-frame")
        records, valid, torn = read_frames(path)
        assert torn and len(records) == 5 and valid == good_size
        s2 = DurableClusterStore(str(tmp_path))
        assert sorted(n.name for n in s2.list("nodes")) \
            == [f"n{i}" for i in range(5)]
        assert s2._rv == store._rv  # rv counter restored exactly
        assert os.path.getsize(path) == good_size  # debris cut off
        # appends after recovery land on a clean frame boundary
        s2.create("nodes", build_node("post", {"cpu": "1"}))
        s2.close()
        s3 = DurableClusterStore(str(tmp_path))
        assert s3.try_get("nodes", "post") is not None

    def test_corrupt_crc_truncates_from_there(self, tmp_path):
        self._fill(tmp_path, n=4)
        seg = [p for p in os.listdir(tmp_path) if p.startswith("wal-")]
        path = str(tmp_path / seg[0])
        raw = bytearray(open(path, "rb").read())
        raw[len(raw) - 3] ^= 0xFF  # flip a byte inside the LAST record
        open(path, "wb").write(raw)
        s2 = DurableClusterStore(str(tmp_path))
        # the first three records survive; the corrupted final one is gone
        assert sorted(n.name for n in s2.list("nodes")) \
            == ["n0", "n1", "n2"]

    def test_fsync_policies(self, tmp_path):
        s_every = DurableClusterStore(str(tmp_path / "every"),
                                      fsync="every")
        for i in range(4):
            s_every.create("nodes", build_node(f"n{i}", {"cpu": "1"}))
        assert s_every.wal.fsyncs == 4  # one per commit

        s_int = DurableClusterStore(str(tmp_path / "interval"),
                                    fsync="interval",
                                    fsync_interval_s=3600.0)
        for i in range(4):
            s_int.create("nodes", build_node(f"n{i}", {"cpu": "1"}))
        assert s_int.wal.fsyncs <= 1  # group commit: the window absorbs

        s_off = DurableClusterStore(str(tmp_path / "off"), fsync="off")
        for i in range(4):
            s_off.create("nodes", build_node(f"n{i}", {"cpu": "1"}))
        assert s_off.wal.fsyncs == 0
        # flushed-but-not-fsynced records still survive a PROCESS death
        # (the bytes are in the OS): a fresh recovery sees them
        s2 = DurableClusterStore(str(tmp_path / "off"))
        assert len(s2.list("nodes")) == 4

    def test_wal_fsync_fault_point_fires(self, tmp_path):
        from volcano_tpu_torch.resilience import faults
        faults.reset()
        try:
            faults.arm("wal_fsync", every=1, exc=None)
            store = DurableClusterStore(str(tmp_path), fsync="every")
            store.create("nodes", build_node("n0", {"cpu": "1"}))
            assert faults.fired("wal_fsync") >= 1
        finally:
            faults.reset()

    def test_store_crash_point_sits_between_append_and_announce(
            self, tmp_path):
        from volcano_tpu_torch.resilience import faults
        faults.reset()
        try:
            seen = []
            store = DurableClusterStore(str(tmp_path))
            store.watch("nodes", lambda ev, obj, old:
                        seen.append(obj.name), replay=False)
            faults.arm_once("store_crash")
            with pytest.raises(ConnectionError):
                store.create("nodes", build_node("n0", {"cpu": "1"}))
            # the record IS durable (the crash seam is after the append)
            # but no listener ever heard the commit announced
            assert seen == []
            assert store.wal.appends == 1
        finally:
            faults.reset()


class TestDurableRecovery:
    def test_full_state_roundtrip_with_rv_counters(self, tmp_path):
        s1 = DurableClusterStore(str(tmp_path))
        s1.create("queues", build_queue("q1", weight=3))
        n = s1.create("nodes", build_node("n1", {"cpu": "4"}))
        n.unschedulable = True
        s1.update("nodes", n)
        s1.create("pods", build_pod("ns", "p1", "", "Pending",
                                    {"cpu": "1"}, "pg"))
        s1.delete("pods", "p1", "ns")
        s1.create("podgroups", build_pod_group("pg1", "ns", min_member=2))
        s2 = DurableClusterStore(str(tmp_path))
        assert s2._rv == s1._rv
        assert s2._kind_rv == s1._kind_rv
        assert s2.get("nodes", "n1").unschedulable is True
        assert s2.get("nodes", "n1").resource_version \
            == s1.get("nodes", "n1").resource_version
        assert s2.list("pods") == []  # the delete replayed too
        assert s2.get("podgroups", "pg1", "ns").spec.min_member == 2
        assert s2.recovered_records == 6

    def test_corrupt_snapshot_falls_back_to_previous_plus_wal(
            self, tmp_path):
        s1 = DurableClusterStore(str(tmp_path))
        for i in range(3):
            s1.create("nodes", build_node(f"a{i}", {"cpu": "1"}))
        s1.snapshot()
        for i in range(3):
            s1.create("nodes", build_node(f"b{i}", {"cpu": "1"}))
        s1.snapshot()
        s1.create("nodes", build_node("tail", {"cpu": "1"}))
        s1.close()
        snaps = sorted(p for p in os.listdir(tmp_path)
                       if p.startswith("snapshot-"))
        assert len(snaps) == 2
        newest = str(tmp_path / snaps[-1])
        raw = bytearray(open(newest, "rb").read())
        raw[20] ^= 0xFF
        open(newest, "wb").write(raw)
        s2 = DurableClusterStore(str(tmp_path))
        assert s2.snapshot_fallbacks == 1
        assert sorted(n.name for n in s2.list("nodes")) \
            == sorted(["a0", "a1", "a2", "b0", "b1", "b2", "tail"])
        assert s2._rv == s1._rv

    def test_snapshot_compaction_prunes_and_recovers(self, tmp_path):
        s1 = DurableClusterStore(str(tmp_path), snapshot_every=4)
        for i in range(11):  # crosses the threshold twice
            s1.create("nodes", build_node(f"n{i}", {"cpu": "1"}))
        s1.close()
        snaps = [p for p in os.listdir(tmp_path)
                 if p.startswith("snapshot-")]
        assert len(snaps) == 2  # keep_snapshots caps retention
        s2 = DurableClusterStore(str(tmp_path))
        assert len(s2.list("nodes")) == 11
        assert s2._rv == s1._rv

    def test_watch_resumes_across_store_restart(self, tmp_path):
        """The tentpole seam: a watcher mid-stream when the store dies
        resumes over the restart via ``since:`` — the events it missed
        (committed while it was disconnected) replay from the journal
        seeded out of the recovered WAL tail. No crash-only resync."""
        s1 = DurableClusterStore(str(tmp_path))
        server = StoreServer(s1)
        server.start()
        port = server.port
        fired = []
        remote = RemoteClusterStore(server.address,
                                    watch_backoff_cap_s=0.3,
                                    on_watch_failure=lambda:
                                    fired.append(1))
        seen = []
        remote.watch("nodes", lambda ev, obj, old:
                     seen.append((ev, obj.name)))
        s1.create("nodes", build_node("n1", {"cpu": "1"}))
        deadline = time.time() + 5
        while len(seen) < 1 and time.time() < deadline:
            time.sleep(0.01)
        assert seen == [("add", "n1")]
        # the server dies; MORE writes commit before the crash finishes
        # taking the store down (the watcher never hears them live)
        server.stop()
        s1.create("nodes", build_node("n2", {"cpu": "1"}))
        n2 = s1.get("nodes", "n2")
        n2.unschedulable = True
        s1.update("nodes", n2)
        del s1  # crash: no clean close
        s2 = DurableClusterStore(str(tmp_path))
        server2 = StoreServer(s2, port=port).start()
        try:
            deadline = time.time() + 10
            while len(seen) < 3 and time.time() < deadline:
                time.sleep(0.02)
            assert seen == [("add", "n1"), ("add", "n2"),
                            ("update", "n2")]
            assert remote.watch_resumes == 1
            assert not remote.watch_failed and fired == []
            # and the stream is LIVE again after the replay
            s2.create("nodes", build_node("n3", {"cpu": "1"}))
            deadline = time.time() + 5
            while len(seen) < 4 and time.time() < deadline:
                time.sleep(0.02)
            assert seen[-1] == ("add", "n3")
        finally:
            remote.close()
            server2.stop()

    def test_in_memory_default_untouched(self, tmp_path):
        """No --store-data-dir => no WAL I/O: the plain store has no
        journaling seam engaged and writes nothing to disk."""
        store = ClusterStore()
        assert not hasattr(store, "_wal")
        before = set(os.listdir(tmp_path))
        store.create("nodes", build_node("n1", {"cpu": "1"}))
        store.bulk_apply([("nodes", build_node("n2", {"cpu": "1"}))])
        assert set(os.listdir(tmp_path)) == before


class TestBulkApply:
    def test_in_memory_mixed_verbs_and_containment(self):
        store = ClusterStore()

        def deny(verb, kind, obj):
            if kind == "pods" and obj.name == "bad":
                raise AdmissionError("denied")
            return obj

        store.add_interceptor(deny)
        store.create("nodes", build_node("n1", {"cpu": "1"}))
        results = store.bulk_apply([
            ("pods", build_pod("ns", "p1", "", "Pending",
                               {"cpu": "1"}, "pg"), "create"),
            ("pods", build_pod("ns", "bad", "", "Pending",
                               {"cpu": "1"}, "pg"), "create"),
            ("pods", build_pod("ns", "p2", "", "Pending",
                               {"cpu": "1"}, "pg"), "create"),
            ("nodes", build_node("n1", {"cpu": "2"}), "apply"),
        ])
        assert [type(r).__name__ for r in results] \
            == ["Pod", "AdmissionError", "Pod", "Node"]
        # the denied pod cost that pod, not the wave
        assert sorted(p.name for p in store.list("pods")) == ["p1", "p2"]
        assert store.get("nodes", "n1").allocatable["cpu"] == "2"
        # duplicate create surfaces per-item too
        results = store.bulk_apply([
            ("pods", build_pod("ns", "p1", "", "Pending",
                               {"cpu": "1"}, "pg"), "create")])
        assert isinstance(results[0], ConflictError)

    def test_over_the_wire_one_frame(self, served_store):
        store, remote = served_store
        results = remote.bulk_apply(
            [("nodes", build_node(f"n{i}", {"cpu": "1"}))
             for i in range(10)]
            + [("pods", build_pod("ns", "p0", "", "Pending",
                                  {"cpu": "1"}, "pg"), "create")])
        assert all(not isinstance(r, Exception) for r in results)
        assert len(store.list("nodes")) == 10
        # per-item errors come back as rebuilt exception instances
        results = remote.bulk_apply(
            [("pods", build_pod("ns", "p0", "", "Pending",
                                {"cpu": "1"}, "pg"), "create"),
             ("nodes", build_node("n0", {"cpu": "4"}))])
        assert isinstance(results[0], ConflictError)
        assert results[1].allocatable["cpu"] == "4"

    def test_one_journal_batch_one_fsync(self, tmp_path):
        store = DurableClusterStore(str(tmp_path), fsync="every")
        base_syncs = store.wal.fsyncs
        store.bulk_apply([("nodes", build_node(f"n{i}", {"cpu": "1"}))
                          for i in range(16)])
        assert store.wal.appends == 16
        assert store.wal.fsyncs == base_syncs + 1  # ONE sync per batch
        # and everything in the batch is durable
        s2 = DurableClusterStore(str(tmp_path))
        assert len(s2.list("nodes")) == 16


class TestJobControllerBulkIngest:
    def test_wave_created_in_one_batch(self, monkeypatch):
        from volcano_tpu_torch.controllers import ControllerManager
        from volcano_tpu_torch.models import Job, JobSpec, PodGroupPhase, TaskSpec

        store = ClusterStore()
        calls = []
        orig = ClusterStore.bulk_apply

        def spy(self, items, fencing=None):
            items = list(items)
            calls.append(len(items))
            return orig(self, items, fencing=fencing)

        monkeypatch.setattr(ClusterStore, "bulk_apply", spy)
        cm = ControllerManager(store)
        cm.run()
        store.create("jobs", Job(
            name="bulkjob", namespace="default",
            spec=JobSpec(min_available=3, tasks=[TaskSpec(
                name="task", replicas=3, template={
                    "spec": {"containers": [{"name": "c", "requests":
                             {"cpu": "1", "memory": "1Gi"}}]}})])))
        cm.process_all()
        pg = store.get("podgroups", "bulkjob", "default")
        pg.status.phase = PodGroupPhase.INQUEUE
        store.update("podgroups", pg)
        cm.process_all()
        assert sorted(p.name for p in store.list("pods")) \
            == ["bulkjob-task-0", "bulkjob-task-1", "bulkjob-task-2"]
        assert 3 in calls  # the whole wave went through ONE batch


# ---------------------------------------------------------------------------
# tests/test_delta_path.py: negotiation and the fallback ladder
# ---------------------------------------------------------------------------

@pytest.fixture()
def served():
    store = ClusterStore()
    server = StoreServer(store).start()
    clients = []

    def client(**kw):
        c = RemoteClusterStore(server.address, **kw)
        clients.append(c)
        return c

    try:
        yield store, server, client
    finally:
        faults.reset()
        for c in clients:
            try:
                c.close()
            except Exception:  # noqa: BLE001
                pass
        server.stop()


def pod_mirror(client, **kw):
    """A delta-aware dict mirror of the pods stream: key -> pod, plus an
    event log of (event, phase) for exactly-once assertions."""
    m, log = {}, []

    def on_pod(event, obj, old, changed=None):
        key = f"{obj.namespace}/{obj.name}"
        log.append((event, obj.phase))
        if event == "delete":
            m.pop(key, None)
        else:
            m[key] = obj
    on_pod.delta_aware = True
    client.watch("pods", on_pod)
    return m, log


def wait_applied(client, store, kind="pods", timeout=30.0):
    assert client.wait_stream_applied(kind, store._rv, timeout=timeout)


class TestNegotiation:
    def test_patch_flow_and_mirror_parity(self, served):
        store, server, client = served
        dc = client(delta_watch=True)
        oc = client()
        dm, _ = pod_mirror(dc)
        om, _ = pod_mirror(oc)
        for i in range(10):
            store.create("pods", build_pod(
                "d", f"p{i}", "", "Pending", {"cpu": "1"}, "g"))
        for f, phase in enumerate(("Running", "Succeeded")):
            for i in range(10):
                cur = copy.deepcopy(store.get("pods", f"p{i}",
                                              namespace="d"))
                cur.phase = phase
                cur.node_name = f"n{f}"
                store.update("pods", cur)
        wait_applied(dc, store)
        wait_applied(oc, store)
        assert set(dm) == set(om) and len(dm) == 10
        for k in om:
            assert dm[k].phase == om[k].phase == "Succeeded"
            assert dm[k].node_name == om[k].node_name == "n1"
            assert dm[k].resource_version == om[k].resource_version
        st = dc.delta_stats
        assert st["events"] == 20 and not st["fallbacks"]
        assert st["fields"] >= 40  # phase + node_name (+ rv) per update
        assert oc.delta_stats["events"] == 0

    def test_fail_safe_default_is_object_frames(self, served):
        store, server, client = served
        oc = client()  # no delta_watch: must never see delta machinery
        om, _ = pod_mirror(oc)
        store.create("pods", build_pod("d", "p0", "", "Pending",
                                       {"cpu": "1"}, "g"))
        cur = copy.deepcopy(store.get("pods", "p0", namespace="d"))
        cur.phase = "Running"
        store.update("pods", cur)
        wait_applied(oc, store)
        st = oc.delta_stats
        assert om["d/p0"].phase == "Running"
        assert st["frames"] == 0 and st["events"] == 0
        assert st["bytes_delta"] == 0 and st["bytes_object"] > 0

    def test_server_without_encoder_declines(self, served):
        store, server, client = served
        del server._server.delta_enc  # an old server: no delta support
        dc = client(delta_watch=True)
        dm, _ = pod_mirror(dc)
        store.create("pods", build_pod("d", "p0", "", "Pending",
                                       {"cpu": "1"}, "g"))
        cur = copy.deepcopy(store.get("pods", "p0", namespace="d"))
        cur.phase = "Running"
        store.update("pods", cur)
        wait_applied(dc, store)
        st = dc.delta_stats
        assert dm["d/p0"].phase == "Running"
        assert st["events"] == 0 and not st["fallbacks"]  # clean decline


def _flip_thrice(store):
    """Three single-field updates against pod d/p0 — the fault-ladder
    shape: each phase must reach a mirror exactly once."""
    for phase in ("Running", "Succeeded", "Failed"):
        cur = copy.deepcopy(store.get("pods", "p0", namespace="d"))
        cur.phase = phase
        store.update("pods", cur)


class TestFallbackLadder:
    def _run_ladder(self, served, point):
        store, server, client = served
        dc = client(delta_watch=True)
        oc = client()
        dm, dlog = pod_mirror(dc)
        om, olog = pod_mirror(oc)
        store.create("pods", build_pod("d", "p0", "", "Pending",
                                       {"cpu": "1"}, "g"))
        wait_applied(dc, store)
        faults.arm_once(point)
        _flip_thrice(store)
        wait_applied(dc, store)
        wait_applied(oc, store)
        # zero lost, zero duplicated: every phase exactly once, both arms
        updates = [p for e, p in dlog if e == "update"]
        assert updates == ["Running", "Succeeded", "Failed"]
        assert updates == [p for e, p in olog if e == "update"]
        assert dm["d/p0"].phase == om["d/p0"].phase == "Failed"
        return dc

    def test_dropped_frame_recovers_via_object_path(self, served):
        dc = self._run_ladder(served, "delta_frame")
        assert dc.delta_stats["fallbacks"] == {"delta_gap": 1}

    def test_duplicated_frame_recovers_via_object_path(self, served):
        dc = self._run_ladder(served, "delta_frame_dup")
        assert dc.delta_stats["fallbacks"] == {"delta_gap": 1}

    def test_vocab_overflow_falls_back_typed(self, served):
        store, server, client = served
        dc = client(delta_watch=True)
        dc.delta_vocab_max = 3  # tiny table: the first adds overflow it
        dm, _ = pod_mirror(dc)
        store.create("pods", build_pod("d", "p0", "", "Pending",
                                       {"cpu": "1"}, "g"))
        _flip_thrice(store)
        wait_applied(dc, store)
        assert dm["d/p0"].phase == "Failed"
        assert dc.delta_stats["fallbacks"].get("vocab_overflow", 0) >= 1

    def test_unknown_field_falls_back_typed(self, served, monkeypatch):
        from volcano_tpu_torch.client import remote as remote_mod
        monkeypatch.setattr(remote_mod, "known_fields",
                            lambda cls: frozenset())
        store, server, client = served
        dc = client(delta_watch=True)
        dm, _ = pod_mirror(dc)
        store.create("pods", build_pod("d", "p0", "", "Pending",
                                       {"cpu": "1"}, "g"))
        _flip_thrice(store)
        wait_applied(dc, store)
        assert dm["d/p0"].phase == "Failed"
        assert dc.delta_stats["fallbacks"] == {"unknown_field": 1}


# ---------------------------------------------------------------------------
# tests/test_resilience.py: request retry, watch resume, the chaos soak
# ---------------------------------------------------------------------------

class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


class TestRequestRetry:
    def test_read_rides_out_a_server_restart(self):
        store = ClusterStore()
        store.create("nodes", build_node("n1", {"cpu": "1"}))
        server = StoreServer(store).start()
        port = server.port
        remote = RemoteClusterStore(
            f"127.0.0.1:{port}", connect_timeout=1.0,
            retry_attempts=40, retry_base_s=0.05, retry_cap_s=0.3)
        assert remote.ping()
        server.stop()
        box = []

        def restart():
            time.sleep(1.0)  # ~a systemd bounce
            box.append(StoreServer(store, port=port).start())

        t = threading.Thread(target=restart, daemon=True)
        before = metrics.store_request_retries_total.get()
        t.start()
        try:
            got = remote.get("nodes", "n1")  # retries through the gap
            assert got.name == "n1"
            assert metrics.store_request_retries_total.get() > before
        finally:
            t.join()
            remote.close()
            for s in box:
                s.stop()

    def test_injected_drop_is_retried(self, served):
        store, remote = served
        store.create("nodes", build_node("n1", {"cpu": "1"}))
        faults.arm_once("store_request")
        assert remote.get("nodes", "n1").name == "n1"
        assert faults.fired("store_request") == 1

    @pytest.fixture()
    def served(self):
        store = ClusterStore()
        server = StoreServer(store).start()
        remote = RemoteClusterStore(server.address, retry_base_s=0.01)
        try:
            yield store, remote
        finally:
            remote.close()
            server.stop()

    def _lose_ack_once(self, monkeypatch, for_ops):
        """Deliver the request frame, then break the connection on the
        RESPONSE read — the applied-but-unacked window (a failure inside
        the send itself is unambiguous and always retry-safe)."""
        import volcano_tpu_torch.client.remote as remote_mod
        orig_send = remote_mod.send_frame
        orig_recv = remote_mod.recv_frame
        dropped = []
        state = {"armed": None}

        def send(sock, payload):
            orig_send(sock, payload)
            if payload.get("op") in for_ops and not dropped:
                state["armed"] = payload.get("op")

        def recv(sock):
            if state["armed"] is not None:
                dropped.append(state["armed"])
                state["armed"] = None
                raise ConnectionError("simulated ack loss")
            return orig_recv(sock)

        monkeypatch.setattr(remote_mod, "send_frame", send)
        monkeypatch.setattr(remote_mod, "recv_frame", recv)
        return dropped

    def test_unacked_update_retries_conditionally_surfaces_conflict(
            self, served, monkeypatch):
        """A bind-shaped update whose ack is lost after the server
        applied it must NOT double-apply on retry: the carried
        resource_version re-presents the precondition, so the replay
        surfaces ConflictError to the caller instead."""
        from volcano_tpu_torch.client.store import ConflictError

        store, remote = served
        store.create("nodes", build_node("n1", {"cpu": "1"}))
        node = remote.get("nodes", "n1")
        node.labels = {"zone": "a"}
        dropped = self._lose_ack_once(monkeypatch, ("update",))
        with pytest.raises(ConflictError):
            remote.update("nodes", node)
        assert dropped == ["update"]
        assert store.get("nodes", "n1").labels == {"zone": "a"}  # applied ONCE

    def test_unacked_create_retries_and_surfaces_conflict(
            self, served, monkeypatch):
        from volcano_tpu_torch.client.store import ConflictError

        store, remote = served
        dropped = self._lose_ack_once(monkeypatch, ("create",))
        with pytest.raises(ConflictError):
            remote.create("nodes", build_node("n1", {"cpu": "1"}))
        assert dropped == ["create"]
        assert len(store.list("nodes")) == 1  # exactly one, not two

    def test_unacked_unconditional_update_still_raises_transport_error(
            self, served, monkeypatch):
        """No resource_version = no precondition: replaying would be a
        blind double-apply, so the transport error surfaces instead."""
        from volcano_tpu_torch.models import Node

        store, remote = served
        store.create("nodes", build_node("n1", {"cpu": "1"}))
        bare = Node(name="n1", allocatable={"cpu": "2"})  # rv 0
        self._lose_ack_once(monkeypatch, ("update",))
        with pytest.raises((ConnectionError, OSError)):
            remote.update("nodes", bare)


# ---------------------------------------------------------------------------
# watch-stream resume
# ---------------------------------------------------------------------------

def _wait(cond, timeout=10.0, step=0.02):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(step)
    return cond()


class TestWatchResume:
    def test_injected_break_resumes_and_replays_missed_events(self):
        """Stream dies between two events (server stays up): the resume
        replays exactly the missed events from the journal, once."""
        store = ClusterStore()
        server = StoreServer(store).start()
        events = []
        remote = RemoteClusterStore(server.address,
                                    watch_backoff_cap_s=0.2)
        try:
            store.create("nodes", build_node("n1", {"cpu": "1"}))
            remote.watch("nodes", lambda ev, obj, old:
                         events.append((ev, obj.name)))
            assert events == [("add", "n1")]
            # the next received frame breaks the stream BEFORE delivery:
            # n2's event is lost from the wire, recovered via the journal
            faults.arm_once("watch_stream")
            store.create("nodes", build_node("n2", {"cpu": "1"}))
            assert _wait(lambda: ("add", "n2") in events)
            store.create("nodes", build_node("n3", {"cpu": "1"}))
            assert _wait(lambda: ("add", "n3") in events)
            assert events.count(("add", "n2")) == 1  # no duplicate
            assert remote.watch_resumes >= 1
            assert not remote.watch_failed
        finally:
            remote.close()
            server.stop()

    def test_resume_across_store_server_restart(self):
        store = ClusterStore()
        server = StoreServer(store).start()
        port = server.port
        events, fired = [], []
        remote = RemoteClusterStore(
            f"127.0.0.1:{port}", connect_timeout=1.0,
            watch_backoff_cap_s=0.2,
            on_watch_failure=lambda: fired.append(1))
        server2 = None
        try:
            store.create("nodes", build_node("n1", {"cpu": "1"}))
            remote.watch("nodes", lambda ev, obj, old:
                         events.append((ev, obj.name)))
            server.stop()
            time.sleep(0.3)  # client is now in its backoff loop
            server2 = StoreServer(store, port=port).start()
            store.create("nodes", build_node("n2", {"cpu": "1"}))
            assert _wait(lambda: ("add", "n2") in events)
            assert events == [("add", "n1"), ("add", "n2")]
            assert not fired and not remote.watch_failed
            # the counter increments after the resume's inline replay
            # returns: under load the replayed event lands a beat first
            assert _wait(lambda: remote.watch_resumes >= 1)
        finally:
            remote.close()
            for s in (server2,):
                if s is not None:
                    s.stop()

    def test_lost_resume_window_falls_back_crash_only(self):
        """Writes land while the server is down: the new server's journal
        cannot cover them, the resume refuses (ResumeGapError) and the
        crash-only contract fires exactly once."""
        store = ClusterStore()
        server = StoreServer(store).start()
        port = server.port
        fired = []
        remote = RemoteClusterStore(
            f"127.0.0.1:{port}", connect_timeout=1.0,
            watch_backoff_cap_s=0.2,
            on_watch_failure=lambda: fired.append(1))
        server2 = None
        try:
            store.create("nodes", build_node("n1", {"cpu": "1"}))
            remote.watch("nodes", lambda *a: None)
            server.stop()
            # missed while down — unreplayable by the restarted server
            store.create("nodes", build_node("n2", {"cpu": "1"}))
            server2 = StoreServer(store, port=port).start()
            assert _wait(lambda: fired == [1])
            assert remote.watch_failed
        finally:
            remote.close()
            for s in (server2,):
                if s is not None:
                    s.stop()

    def test_delete_events_survive_resume(self):
        """Deletes bump the store's rv and replay through the journal."""
        store = ClusterStore()
        server = StoreServer(store).start()
        events = []
        remote = RemoteClusterStore(server.address,
                                    watch_backoff_cap_s=0.2)
        try:
            store.create("nodes", build_node("n1", {"cpu": "1"}))
            store.create("nodes", build_node("n2", {"cpu": "1"}))
            remote.watch("nodes", lambda ev, obj, old:
                         events.append((ev, obj.name)))
            faults.arm_once("watch_stream")
            store.delete("nodes", "n2")
            assert _wait(lambda: ("delete", "n2") in events)
            assert events.count(("delete", "n2")) == 1
            assert not remote.watch_failed
        finally:
            remote.close()
            server.stop()


class TestCrossProcessWatchResume:
    def test_scheduler_proc_survives_server_restart(self):
        """A port scheduler process (tests/test_torch_netha.py's
        ``scheduler`` entry, device="cpu") rides a transient store-server
        drop out in place (watch resume + request retry), without the
        exit(3) crash-restart."""
        from volcano_tpu_torch.models import Node, Pod, PodGroup, PodGroupSpec
        from volcano_tpu_torch.api.types import POD_GROUP_ANNOTATION

        store = ClusterStore()
        server = StoreServer(store).start()
        port = server.port
        store.create("nodes", Node(
            name="n1", allocatable={"cpu": "32", "memory": "64Gi"},
            capacity={"cpu": "32", "memory": "64Gi"}))

        def submit(idx):
            store.create("podgroups", PodGroup(
                name=f"pg{idx}", namespace="d",
                spec=PodGroupSpec(min_member=1)))
            store.create("pods", Pod(
                name=f"p{idx}", namespace="d",
                annotations={POD_GROUP_ANNOTATION: f"pg{idx}"},
                containers=[{"requests": {"cpu": "1", "memory": "1Gi"}}]))

        def bound(name):
            p = store.try_get("pods", name, "d")
            return p is not None and bool(p.node_name)

        submit(0)
        proc = subprocess.Popen(
            [sys.executable, os.path.join(HERE, "test_torch_netha.py"),
             "scheduler", "--server", f"127.0.0.1:{port}",
             "--identity", "solo"],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
            cwd=os.path.dirname(HERE))
        server2 = None
        try:
            assert _wait(lambda: bound("p0"), timeout=120), \
                "scheduler never bound p0"
            server.stop()
            time.sleep(0.5)  # outage window: watch streams are broken
            server2 = StoreServer(store, port=port).start()
            submit(1)
            assert _wait(lambda: bound("p1"), timeout=60), \
                "scheduler did not recover after the server restart"
            # the proc rode the restart out in place — no crash-only exit
            assert proc.poll() is None
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
            for s in (server2,):
                if s is not None:
                    s.stop()


# ---------------------------------------------------------------------------
# the chaos soak: 15 cycles over the wire with faults on every seam
# ---------------------------------------------------------------------------

class TestChaosSoak:
    def test_fifteen_cycles_with_faults_zero_crashes(self):
        store = ClusterStore()
        server = StoreServer(store).start()
        remote = RemoteClusterStore(server.address, connect_timeout=2.0,
                                    retry_base_s=0.05,
                                    watch_backoff_cap_s=0.3)
        cache = SchedulerCache(remote, device="cpu")
        cache.evictor = FakeEvictor()
        cache.run()
        clock = FakeClock()
        cache.breaker = CircuitBreaker("device-solver",
                                       failure_threshold=2,
                                       cooldown_s=3.0, clock=clock)
        sched = Scheduler(cache, period=0.05)
        store.apply("queues", build_queue("q0", weight=1))
        for i in range(4):
            store.create("nodes", build_node(
                f"n{i}", {"cpu": "16", "memory": "64Gi"}))

        def wave(k):
            pg = build_pod_group(f"j{k}", "t", min_member=2, queue="q0")
            pg.status.phase = PodGroupPhase.PENDING
            store.create("podgroups", pg)
            for i in range(2):
                store.create("pods", build_pod(
                    "t", f"j{k}-{i}", "", "Pending",
                    {"cpu": "1", "memory": "1Gi"}, f"j{k}"))

        crashes = 0
        try:
            for s in range(15):
                if s in (3, 9):
                    faults.arm_once("watch_stream")
                if s in (5, 11):
                    faults.arm_once("store_request")
                if s in (6, 7):
                    faults.arm_once("solver_dispatch")
                wave(s)
                assert _wait(lambda: f"t/j{s}" in cache.jobs
                             and len(cache.jobs[f"t/j{s}"].tasks) == 2), \
                    f"mirror froze before cycle {s}"
                clock.t += 1.0
                try:
                    sched.run_once()
                except Exception:
                    crashes += 1
            assert crashes == 0
            assert not remote.watch_failed
            assert cache.breaker.state == "closed"  # recovered
            # every gang of every cycle got placed despite the faults
            assert _wait(lambda: all(
                p.node_name for p in store.list("pods", namespace="t")))
        finally:
            remote.close()
            server.stop()


# ---------------------------------------------------------------------------
# tests/test_wire_delta.py's churn matrix: the port against the JAX package
# ---------------------------------------------------------------------------

class ChurnWorld:
    """One package's live server over its store, two scheduler arms (a
    delta-watch client and an object-frame client) on FakeBinder, and
    the reference matrix's seeded churn script. Driven in lockstep with
    the other package's world from an identically seeded Random: the
    stores only change through the script (FakeBinder writes nothing),
    so both stores pass through the same states."""

    def __init__(self, pkg):
        self.pkg = pkg
        b = Builders(pkg)
        self.b = b
        client = pkg_mod(pkg, "client")
        cache_mod = pkg_mod(pkg, "cache")
        self.faults = pkg_mod(pkg, "resilience").faults
        self.flatten_snapshot = pkg_mod(pkg, "ops").flatten_snapshot
        self.store = client.ClusterStore()
        self.server = client.StoreServer(self.store).start()
        self.clients = []
        self.rng = random.Random(1316)
        self.store.apply("queues", b.build_queue("q0", weight=1))
        for i in range(4):
            self.store.create("nodes", b.build_node(
                f"n{i}", {"cpu": "16", "memory": "64Gi"}))
        self.next_job = 0
        self.jobs = [self.add_job() for _ in range(6)]
        self.drained = {}
        self.arms = {}
        kw = {"device": "cpu"} if pkg == "torch" else {}
        for label, delta in (("delta", True), ("object", False)):
            c = client.RemoteClusterStore(self.server.address,
                                          delta_watch=delta)
            self.clients.append(c)
            cache = cache_mod.SchedulerCache(c, **kw)
            cache.binder = cache_mod.FakeBinder()
            cache.evictor = cache_mod.FakeEvictor()
            cache.status_updater = cache_mod.FakeStatusUpdater()
            cache.run()
            cache.wait_for_cache_sync()
            self.arms[label] = (cache, pkg_mod(pkg, "scheduler").Scheduler(
                cache))

    def close(self):
        for c in self.clients:
            c.close()
        self.server.stop()

    def add_job(self):
        b = self.b
        name = f"m{self.next_job}"
        self.next_job += 1
        self.store.create("podgroups", b.build_pod_group(
            name, "churn", min_member=2, queue="q0"))
        for i in range(2):
            self.store.create("pods", b.build_pod(
                "churn", f"{name}-{i}", "", "Pending",
                {"cpu": "1", "memory": "1Gi"}, name))
        return name

    def live_pods(self):
        return list(self.store.list("pods", namespace="churn"))

    def churn_once(self, cycle):
        store, rng, drained, b = self.store, self.rng, self.drained, self.b
        readded = False
        for name in [n for n, left in drained.items() if left == 0]:
            store.create("nodes", b.build_node(
                name, {"cpu": "16", "memory": "64Gi"}))
            del drained[name]
            readded = True
        if readded:
            self.settle()
        for name in drained:
            drained[name] -= 1
        for _ in range(4):
            op = rng.choice(["flip", "flip", "priority", "bind", "drain",
                             "jobs"])
            pods = self.live_pods()
            if op == "flip" and pods:
                cur = copy.deepcopy(rng.choice(pods))
                cur.phase = rng.choice(["Pending", "Running", "Succeeded"])
                cur.labels = dict(cur.labels or {}, cycle=str(cycle))
                store.update("pods", cur)
            elif op == "priority" and pods:
                cur = copy.deepcopy(rng.choice(pods))
                cur.priority = rng.randint(1, 3)
                store.update("pods", cur)
            elif op == "bind" and pods:
                alive = [n for n in (f"n{i}" for i in range(4))
                         if n not in drained]
                cur = copy.deepcopy(rng.choice(pods))
                cur.node_name = rng.choice(alive)
                cur.phase = "Running"
                store.update("pods", cur)
            elif op == "drain":
                alive = [n for n in (f"n{i}" for i in range(4))
                         if n not in drained]
                if len(alive) > 2:
                    victim = rng.choice(alive)
                    for p in pods:
                        if p.node_name == victim:
                            cur = copy.deepcopy(p)
                            cur.node_name = ""
                            cur.phase = "Pending"
                            store.update("pods", cur)
                    self.settle()
                    store.delete("nodes", victim)
                    drained[victim] = 2
            elif op == "jobs":
                if len(self.jobs) > 4 and rng.random() < 0.5:
                    gone = self.jobs.pop(rng.randrange(len(self.jobs)))
                    for i in range(2):
                        try:
                            store.delete("pods", f"{gone}-{i}", "churn")
                        except Exception:  # noqa: BLE001
                            pass
                    store.delete("podgroups", gone, "churn")
                elif len(self.jobs) < 8:
                    self.jobs.append(self.add_job())

    def inject_fallback(self):
        """The matrix's mid-run fallback-and-resume (see the reference)."""
        self.settle()
        self.faults.arm_once("delta_frame")
        for marker in ("fault-canary", "gap-detector"):
            cur = copy.deepcopy(self.live_pods()[0])
            cur.labels = dict(cur.labels or {}, canary=marker)
            self.store.update("pods", cur)

    def digest(self, cache):
        sn = cache.snapshot()
        tasks = [t for j in sn.jobs.values() for t in j.tasks.values()]
        if not tasks:
            return "empty"
        fbuf, ibuf, layout = self.flatten_snapshot(
            sn.jobs, sn.nodes, tasks).packed()
        h = hashlib.sha256()
        h.update(fbuf.tobytes())
        h.update(ibuf.tobytes())
        h.update(repr(layout).encode())
        return h.hexdigest()

    @staticmethod
    def fingerprint(cache):
        with cache.cluster.locked():
            jobs = {jk: [(tk, t.status.name, t.node_name, t.priority,
                          t.pod.phase, dict(t.pod.labels or {}))
                         for tk, t in job.tasks.items()]
                    for jk, job in cache.jobs.items()}
            return jobs, list(cache.jobs), sorted(
                n for n, ni in cache.nodes.items() if ni.node is not None)

    def settle(self, timeout=30.0):
        """Both arms' mirrors hold every store event (the reference's
        per-kind key-set and resource_version check)."""
        store = self.store

        def want():
            with store.locked():
                return ({f"{p.namespace}/{p.name}": p.resource_version
                         for p in store.list("pods")},
                        {pg.name: pg.resource_version
                         for pg in store.list("podgroups")},
                        {n.name: n.resource_version
                         for n in store.list("nodes")})

        def caught_up(cache, pods, pgs, nodes):
            with cache.cluster.locked():
                have = {f"{t.pod.namespace}/{t.pod.name}":
                        t.pod.resource_version
                        for j in cache.jobs.values()
                        for t in j.tasks.values()}
                if have != pods:
                    return False
                real = {name: ni.node.resource_version
                        for name, ni in cache.nodes.items()
                        if ni.node is not None}
                if real != nodes:
                    return False
                for name, rv in pgs.items():
                    job = cache.jobs.get(f"churn/{name}")
                    if job is None or job.pod_group is None \
                            or job.pod_group.resource_version != rv:
                        return False
            return True

        deadline = time.time() + timeout
        while time.time() < deadline:
            pods, pgs, nodes = want()
            if all(caught_up(cache, pods, pgs, nodes)
                   for cache, _ in self.arms.values()):
                return
            time.sleep(0.005)
        raise AssertionError(f"{self.pkg}: arms failed to settle")


class TestChurnMatrix:
    """40 seeded churn cycles: in each package the delta arm and the
    object arm agree (mirror, packed arrays, binds), and the port's arms
    agree with the JAX package's bind for bind, every cycle, across the
    mid-run injected delta fallback-and-resume."""

    CYCLES = 40
    FAULT_CYCLE = 20

    def test_40_cycles_bind_for_bind_port_equals_jax(self):
        worlds = {pkg: ChurnWorld(pkg) for pkg in PKGS}
        try:
            for cycle in range(self.CYCLES):
                for w in worlds.values():
                    w.churn_once(cycle)
                    if cycle == self.FAULT_CYCLE:
                        w.inject_fallback()
                    w.settle()
                    for _, sched in w.arms.values():
                        sched.run_once()
                seen = {}
                for pkg, w in worlds.items():
                    for label, (cache, _) in w.arms.items():
                        seen[pkg, label] = (
                            w.fingerprint(cache), w.digest(cache),
                            dict(cache.binder.binds),
                            list(cache.binder.channel))
                want = seen["jax", "object"]
                for key, got in seen.items():
                    assert got[0] == want[0], f"mirror {key} @{cycle}"
                    assert got[1] == want[1], f"arrays {key} @{cycle}"
                    assert got[2:] == want[2:], f"binds {key} @{cycle}"
            for pkg, w in worlds.items():
                stats = w.arms["delta"][0].cluster.delta_stats
                assert stats["events"] > 0, pkg
                assert stats["fallbacks"] == {"delta_gap": 1}, pkg
            assert worlds["torch"].arms["delta"][0].binder.binds
        finally:
            for w in worlds.values():
                w.close()


# ---------------------------------------------------------------------------
# tests/test_failover.py: the lease fencing token over the wire
# ---------------------------------------------------------------------------

class TestRemoteFencing:
    def test_fencing_travels_the_wire(self):
        """RemoteClusterStore carries the token; the SERVER's lease
        record arbitrates (the deposed client's view is untrusted)."""
        from volcano_tpu_torch.utils import LeaderElector, LeaseLock
        store = ClusterStore()
        clock = FakeClock(1000.0)
        store.clock = clock
        server = StoreServer(store).start()
        remote = RemoteClusterStore(server.address)
        try:
            ea = LeaderElector(LeaseLock(remote, "volcano"), identity="A",
                               lease_duration=10.0, clock=clock)
            assert ea.step()
            remote.create("pods", build_pod("d", "p", "", "Pending",
                                            {"cpu": "1"}, "pg"),
                          fencing=ea.fencing_token())
            clock.t += 11
            eb = LeaderElector(LeaseLock(remote, "volcano"), identity="B",
                               lease_duration=10.0, clock=clock)
            assert eb.step()
            pod = remote.get("pods", "p", "d")
            with pytest.raises(FencedError):
                remote.update("pods", pod, fencing={
                    "lock": "volcano", "holder": "A", "epoch": 1})
        finally:
            remote.close()
            server.stop()


# ---------------------------------------------------------------------------
# interop: either package's client against either package's server, and
# one WAL directory recovered by either package
# ---------------------------------------------------------------------------

def _state(store):
    """A store's objects (encoded with the JAX codec, so both packages'
    objects compare as the same JSON) and its rv counters."""
    import json
    enc = pkg_mod("jax", "client.codec").encode
    with store.locked():
        return ({kind: sorted(json.dumps(enc(o), sort_keys=True)
                              for o in store.list(kind))
                 for kind in ("nodes", "pods", "podgroups", "queues",
                              "jobs", "leases")},
                store._rv, dict(store._kind_rv))


class TestInterop:
    @pytest.mark.parametrize("client_pkg,server_pkg",
                             [("torch", "jax"), ("jax", "torch")])
    def test_client_against_other_package_server(self, client_pkg,
                                                 server_pkg):
        srv_client = pkg_mod(server_pkg, "client")
        cli = pkg_mod(client_pkg, "client")
        cb, sb = Builders(client_pkg), Builders(server_pkg)
        store = srv_client.ClusterStore()
        server = srv_client.StoreServer(store).start()
        remotes = []
        try:
            remote = cli.RemoteClusterStore(server.address)
            delta = cli.RemoteClusterStore(server.address, delta_watch=True)
            remotes += [remote, delta]
            # CRUD: objects cross as the receiving package's classes
            remote.create("nodes", cb.build_node("n1", {"cpu": "4"}))
            assert type(store.get("nodes", "n1")) is sb.models.Node
            got = remote.get("nodes", "n1")
            assert type(got) is cb.models.Node
            assert got.allocatable["cpu"] == "4"
            q = remote.create("queues", cb.build_queue("q1", weight=2))
            stale = copy.deepcopy(q)
            q.spec.weight = 5
            remote.update("queues", q)
            stale.spec.weight = 7
            with pytest.raises(cli.ConflictError):
                remote.update("queues", stale)
            with pytest.raises(cli.NotFoundError):
                remote.get("queues", "nope")
            # watch: replay, then live events, on both dialects
            seen = {"object": [], "delta": []}
            for label, c in (("object", remote), ("delta", delta)):
                def on_pod(ev, obj, old, changed=None, label=label):
                    seen[label].append((ev, obj.name, obj.phase,
                                        type(obj).__name__))
                on_pod.delta_aware = True
                c.watch("pods", on_pod)
            store.create("pods", sb.build_pod("d", "p0", "", "Pending",
                                              {"cpu": "1"}, "g"))
            # bulk_apply: per-item results, an error rebuilt in place
            res = remote.bulk_apply(
                [("pods", cb.build_pod("d", f"b{i}", "", "Pending",
                                       {"cpu": "1"}, "g"), "create")
                 for i in range(3)]
                + [("pods", cb.build_pod("d", "p0", "", "Pending",
                                         {"cpu": "1"}, "g"), "create")])
            assert [type(r).__name__ for r in res] == [
                "Pod", "Pod", "Pod", "ConflictError"]
            for phase in ("Running", "Succeeded"):
                cur = copy.deepcopy(store.get("pods", "p0", "d"))
                cur.phase = phase
                store.update("pods", cur)
            for c in (remote, delta):
                assert c.wait_stream_applied("pods", store._rv, 10.0)
            want = [("add", "p0", "Pending", "Pod")] + [
                ("add", f"b{i}", "Pending", "Pod") for i in range(3)] + [
                ("update", "p0", "Running", "Pod"),
                ("update", "p0", "Succeeded", "Pod")]
            assert seen["object"] == want
            assert seen["delta"] == want
            # the delta dialect was negotiated and carried the updates
            assert delta.delta_stats["events"] == 2
            assert not delta.delta_stats["fallbacks"]
            assert remote.delta_stats["events"] == 0
            assert sorted(p.name for p in remote.list("pods", "d")) == [
                "b0", "b1", "b2", "p0"]
        finally:
            for c in remotes:
                c.close()
            server.stop()

    @pytest.mark.parametrize("writer,reader", [("torch", "jax"),
                                               ("jax", "torch")])
    def test_wal_recovered_by_other_package(self, tmp_path, writer,
                                            reader):
        wb = Builders(writer)
        w = pkg_mod(writer, "client").DurableClusterStore(
            str(tmp_path), snapshot_every=5)
        w.create("queues", wb.build_queue("q1", weight=3))
        for i in range(4):
            w.create("nodes", wb.build_node(f"n{i}", {"cpu": "4"}))
        n = w.get("nodes", "n1")
        n.unschedulable = True
        w.update("nodes", n)
        w.bulk_apply([("pods", wb.build_pod("d", f"p{i}", "", "Pending",
                                            {"cpu": "1"}, "pg"), "create")
                      for i in range(3)])
        w.delete("pods", "p1", "d")
        w.create("podgroups", wb.build_pod_group("pg", "d", min_member=2))
        job = wb.models.Job(name="j", namespace="d")
        job.status.state.phase = wb.models.JobPhase.RUNNING
        w.create("jobs", job)
        written = _state(w)
        del w  # a crash: no clean close
        import shutil
        shutil.copytree(tmp_path, tmp_path.parent / f"{tmp_path.name}-own")
        own = pkg_mod(writer, "client").DurableClusterStore(
            str(tmp_path.parent / f"{tmp_path.name}-own"))
        r = pkg_mod(reader, "client").DurableClusterStore(str(tmp_path))
        # the other package recovers exactly what the writer's own does
        assert _state(r) == _state(own)
        assert r.recovered_records == own.recovered_records
        assert r.recovered_snapshot_rv == own.recovered_snapshot_rv > 0
        # objects and the global rv as written; a kind's event rv can
        # trail by one when a snapshot lands on that kind's own commit
        # (the reference records it before the event's update)
        assert _state(r)[:2] == written[:2]
        assert type(r.get("jobs", "j", "d").status.state.phase) is \
            Builders(reader).models.JobPhase
        # and the reader appends on, recovered in turn by the writer
        r.create("nodes", Builders(reader).build_node("post", {"cpu": "1"}))
        after = _state(r)
        r.close()
        again = pkg_mod(writer, "client").DurableClusterStore(str(tmp_path))
        assert _state(again) == after


# ---------------------------------------------------------------------------
# ControllerManager(bulk_watch=True) over the wire
# ---------------------------------------------------------------------------

class TestControllersOverWire:
    def test_bulk_watch_opens_one_stream(self):
        from volcano_tpu_torch.controllers import ControllerManager
        from volcano_tpu_torch.models import Job, JobSpec, TaskSpec
        store = ClusterStore()
        server = StoreServer(store).start()
        remote = RemoteClusterStore(server.address)
        try:
            base = {k: len(v) for k, v in store._listeners.items()}
            cm = ControllerManager(remote, bulk_watch=True)
            cm.run()
            opened = {k: len(v) - base.get(k, 0)
                      for k, v in store._listeners.items()
                      if len(v) > base.get(k, 0)}
            # ONE connection subscribed every watched kind, once each
            assert len(remote._watch_socks) == 1
            assert server._server.op_counts["bulk_watch"] == 1
            assert server._server.op_counts["watch"] == 0
            assert set(opened) >= {"jobs", "pods", "podgroups", "queues",
                                   "commands"}
            assert all(n == 1 for n in opened.values())
            # and the stream carries events the controllers act on
            store.create("jobs", Job(
                name="j", namespace="default",
                spec=JobSpec(min_available=1, tasks=[TaskSpec(
                    name="t", replicas=1, template={"spec": {"containers": [
                        {"name": "c", "requests": {"cpu": "1"}}]}})])))
            deadline = time.time() + 10
            while store.try_get("podgroups", "j", "default") is None \
                    and time.time() < deadline:
                cm.process_all()
                time.sleep(0.02)
            assert store.try_get("podgroups", "j", "default") is not None
        finally:
            remote.close()
            server.stop()
