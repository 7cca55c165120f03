"""The port's sharded front door (volcano_tpu_torch/client/sharded.py)
on the CPU: the cases of tests/test_sharded_store.py, the same cases and
bounds, through the port's own store, router, client and controllers —
routing determinism, per-shard rv/journal/WAL lineages, the one-endpoint
ShardRouter on the unchanged wire protocol, bulk_watch with per-shard
resume, chunked bulk_apply, single-shard crash isolation, controller
fan-out — and the slow shards=4 kill-9 soak proving a crash mid-wave
stays bind-for-bind identical to an uninterrupted golden run (the port's
Scheduler on device="cpu").

tests/test_torch_shardproc.py's wire class inherits TestShardRouterWire
from here, as the reference's does. Interop with the JAX package lives in
tests/test_torch_shard_interop.py.

Tolerance: exact (objects, rvs, events, binds)."""

from __future__ import annotations

import time
import zlib

import pytest

from torch_helpers import Builders
from volcano_tpu_torch.client import (
    AdmissionError, FencedError, RemoteClusterStore, ShardedClusterStore,
    ShardRouter, ShardUnavailableError, shard_for,
)
from volcano_tpu_torch.client.sharded import PINNED_KINDS
from volcano_tpu_torch.models import Lease
from volcano_tpu_torch.resilience.faultinject import faults

_B = Builders("torch")
build_node, build_pod, build_queue = _B.build_node, _B.build_pod, \
    _B.build_queue


def wait_for(cond, timeout=8.0, interval=0.01):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return cond()


def make_pod(i, ns="ns"):
    return build_pod(ns, f"p{i}", "", "Pending", {"cpu": "1"}, "pg")


class TestRouting:
    def test_routing_is_crc32_of_kind_and_key(self):
        # definitionally stable across processes and restarts (hash()
        # is salted; crc32 is not)
        assert shard_for("pods", "ns/p1", 4) == \
            zlib.crc32(b"pods/ns/p1") % 4

    def test_single_shard_and_pinned_kinds_route_to_zero(self):
        assert shard_for("pods", "anything", 1) == 0
        for kind in PINNED_KINDS:
            for n in (1, 4, 8):
                assert shard_for(kind, "any/name", n) == 0

    def test_distribution_roughly_even(self):
        counts = [0] * 8
        for i in range(1000):
            counts[shard_for("pods", f"ns/pod-{i}", 8)] += 1
        assert all(c > 0 for c in counts)
        assert max(counts) < 2 * (1000 / 8)

    def test_same_object_same_shard_across_restart(self, tmp_path):
        store = ShardedClusterStore(4, data_dir=str(tmp_path),
                                    fsync="off")
        homes = {}
        for i in range(24):
            store.create("pods", make_pod(i))
            idx = store.shard_of("pods", f"ns/p{i}")
            assert f"ns/p{i}" in store.shards[idx]._buckets["pods"]
            homes[i] = idx
        store.close()
        again = ShardedClusterStore(4, data_dir=str(tmp_path),
                                    fsync="off")
        for i, idx in homes.items():
            assert again.shard_of("pods", f"ns/p{i}") == idx
            assert f"ns/p{i}" in again.shards[idx]._buckets["pods"]
        again.close()


class TestShardedStoreSemantics:
    def test_crud_routes_and_list_merges(self):
        s = ShardedClusterStore(4)
        for i in range(20):
            s.create("pods", make_pod(i))
        assert len(s.list("pods")) == 20
        assert s.get("pods", "p3", "ns").name == "p3"
        assert s.try_get("pods", "nope", "ns") is None
        s.delete("pods", "p3", "ns")
        assert len(s.list("pods")) == 19
        # at least two shards actually hold objects
        occupied = [i for i, sh in enumerate(s.shards)
                    if sh._buckets["pods"]]
        assert len(occupied) > 1

    def test_per_shard_rv_monotonic_and_stamped(self):
        s = ShardedClusterStore(4)
        seen = {}  # shard -> [rv]
        s.watch_sharded("pods",
                        lambda sh, rv, e, o, old:
                        seen.setdefault(sh, []).append(rv))
        for i in range(40):
            obj = s.create("pods", make_pod(i))
            idx = s.shard_of("pods", f"ns/p{i}")
            # the object's resource_version is ITS shard's sequence
            assert obj.resource_version == s.shards[idx]._rv
        for sh, rvs in seen.items():
            assert rvs == sorted(rvs)
            assert len(rvs) == len(set(rvs))

    def test_watch_replays_and_delivers_across_shards(self):
        s = ShardedClusterStore(4)
        for i in range(10):
            s.create("pods", make_pod(i))
        events = []
        s.watch("pods", lambda e, o, old: events.append((e, o.name)))
        assert len(events) == 10  # replay from every shard
        s.create("pods", make_pod(99))
        assert ("add", "p99") in events

    def test_fencing_arbitrated_on_shard_zero(self):
        s = ShardedClusterStore(4)
        s.clock = lambda: 1000.0
        s.create("leases", Lease(name="volcano", holder_identity="a",
                                 renew_time=1000.0, lease_transitions=3))
        assert "volcano" in s.shards[0]._buckets["leases"]
        token = {"lock": "volcano", "holder": "a", "epoch": 3}
        # a fenced write on ANY shard validates against shard 0's lease
        for i in range(8):
            s.create("pods", make_pod(i), fencing=token)
        stale = {"lock": "volcano", "holder": "a", "epoch": 2}
        with pytest.raises(FencedError):
            s.create("pods", make_pod(50), fencing=stale)
        other = {"lock": "volcano", "holder": "b", "epoch": 3}
        with pytest.raises(FencedError):
            s.delete("pods", "p0", "ns", fencing=other)

    def test_bulk_apply_partitions_with_containment(self):
        s = ShardedClusterStore(4)

        def deny(verb, kind, obj):
            if kind == "pods" and obj.name == "p7":
                raise AdmissionError("p7 denied")
            return obj

        s.add_interceptor(deny)
        res = s.bulk_apply([("pods", make_pod(i), "create")
                            for i in range(16)])
        assert len(res) == 16
        assert isinstance(res[7], AdmissionError)
        assert all(not isinstance(r, Exception)
                   for i, r in enumerate(res) if i != 7)
        # results line up with submission order, not shard order
        assert [r.name for i, r in enumerate(res) if i != 7] == \
            [f"p{i}" for i in range(16) if i != 7]


class TestShardCrashIsolation:
    def test_down_shard_contained_others_serve(self, tmp_path):
        s = ShardedClusterStore(4, data_dir=str(tmp_path), fsync="off")
        for i in range(24):
            s.create("pods", make_pod(i))
        events = []
        s.watch("pods", lambda e, o, old: events.append(o.name),
                replay=False)
        idx = s.shard_of("pods", "ns/p0")
        s.crash_shard(idx)
        with pytest.raises(ShardUnavailableError):
            s.get("pods", "p0", "ns")
        with pytest.raises(ShardUnavailableError):
            s.list("pods")  # a partial list would lie; it must refuse
        # the other shards keep serving reads AND writes
        other = next(i for i in range(24)
                     if s.shard_of("pods", f"ns/p{i}") != idx)
        assert s.get("pods", f"p{other}", "ns") is not None
        live = next(i for i in range(100, 200)
                    if s.shard_of("pods", f"ns/p{i}") != idx)
        s.create("pods", make_pod(live))
        assert f"p{live}" in events
        # a bulk wave: ONLY the down shard's items fail
        res = s.bulk_apply([("pods", make_pod(i), "create")
                            for i in range(200, 240)])
        for i, r in enumerate(res):
            if s.shard_of("pods", f"ns/p{200 + i}") == idx:
                assert isinstance(r, ShardUnavailableError)
            else:
                assert not isinstance(r, Exception)
        s.close()

    def test_recover_replays_own_wal_and_resubscribes(self, tmp_path):
        s = ShardedClusterStore(4, data_dir=str(tmp_path), fsync="off")
        for i in range(24):
            s.create("pods", make_pod(i))
        events = []
        s.watch("pods", lambda e, o, old: events.append(o.name),
                replay=False)
        idx = s.shard_of("pods", "ns/p0")
        rv_before = s.shards[idx]._rv
        s.crash_shard(idx)
        recovered = s.recover_shard(idx)
        # construction IS recovery: the shard's own WAL, nothing else
        assert recovered.recovered_records > 0
        assert s.get("pods", "p0", "ns").name == "p0"
        # rv continuity: the recovered sequence continues monotonic
        assert recovered._rv == rv_before
        # watchers re-attached: new commits on the recovered shard flow
        back = next(i for i in range(100, 200)
                    if s.shard_of("pods", f"ns/p{i}") == idx)
        s.create("pods", make_pod(back))
        assert f"p{back}" in events
        assert s.shards[idx]._rv == rv_before + 1
        s.close()


class TestShardedDurableRecovery:
    def test_each_shard_replays_only_its_own_wal(self, tmp_path):
        s = ShardedClusterStore(4, data_dir=str(tmp_path), fsync="off")
        per_shard = [0] * 4
        for i in range(40):
            s.create("pods", make_pod(i))
            per_shard[s.shard_of("pods", f"ns/p{i}")] += 1
        rvs = [sh._rv for sh in s.shards]
        s.close()
        again = ShardedClusterStore(4, data_dir=str(tmp_path),
                                    fsync="off")
        for idx in range(4):
            assert again.shards[idx].recovered_records == per_shard[idx]
            assert again.shards[idx]._rv == rvs[idx]
        assert len(again.list("pods")) == 40
        # per-shard lineages live in separate directories
        assert (tmp_path / "shard-000").is_dir()
        assert (tmp_path / "shard-003").is_dir()
        again.close()


@pytest.fixture()
def served_shards():
    """A 4-shard in-memory store behind a ShardRouter + remote client."""
    store = ShardedClusterStore(4)
    router = ShardRouter(store, port=0).start()
    remote = RemoteClusterStore(f"127.0.0.1:{router.port}",
                                connect_timeout=2.0,
                                watch_backoff_cap_s=0.2)
    yield store, router, remote
    remote.close()
    router.stop()


class TestShardRouterWire:
    def test_crud_roundtrip_through_one_endpoint(self, served_shards):
        store, router, remote = served_shards
        for i in range(12):
            remote.create("pods", make_pod(i))
        assert len(remote.list("pods")) == 12
        got = remote.get("pods", "p5", "ns")
        assert got.name == "p5"
        remote.delete("pods", "p5", "ns")
        assert remote.try_get("pods", "p5", "ns") is None
        # the objects actually spread across the server's shards
        occupied = [i for i, sh in enumerate(store.shards)
                    if sh._buckets["pods"]]
        assert len(occupied) > 1

    def test_legacy_watch_resumes_with_per_shard_marks(self,
                                                       served_shards):
        store, router, remote = served_shards
        names = []
        remote.watch("pods", lambda e, o, old: names.append(o.name))
        for i in range(12):
            store.create("pods", make_pod(i))
        assert wait_for(lambda: len(names) == 12)
        # hard-drop every stream server-side; the client resumes with a
        # {shard: rv} map and replays nothing twice
        for sock in list(router._server.active):
            try:
                sock.close()
            except OSError:
                pass
        store.create("pods", make_pod(50))
        assert wait_for(lambda: "p50" in names)
        assert len(names) == len(set(names)) == 13
        assert remote.watch_resumes >= 1 and not remote.watch_failed

    def test_bulk_watch_many_kinds_one_stream(self, served_shards):
        store, router, remote = served_shards
        for i in range(30):
            store.create("pods", make_pod(i))
        store.apply("queues", build_queue("q0", weight=1))
        seen = []
        n_socks = len(remote._watch_socks)
        remote.bulk_watch([
            ("pods", lambda e, o, old: seen.append(("pods", o.name))),
            ("queues", lambda e, o, old: seen.append(("queues", o.name))),
            ("nodes", lambda e, o, old: seen.append(("nodes", o.name))),
        ])
        # one connection for all three kinds, replay applied inline
        assert len(remote._watch_socks) == n_socks + 1
        assert len([x for x in seen if x[0] == "pods"]) == 30
        assert ("queues", "q0") in seen
        store.apply("nodes", build_node("n0", {"cpu": "8"}))
        wave = store.bulk_apply([("pods", make_pod(100 + i), "create")
                                 for i in range(40)])
        assert all(not isinstance(r, Exception) for r in wave)
        assert wait_for(lambda: len([x for x in seen
                                     if x[0] == "pods"]) == 70
                        and ("nodes", "n0") in seen)

    def test_bulk_watch_resume_across_store_restart(self, tmp_path):
        work = str(tmp_path)
        store = ShardedClusterStore(4, data_dir=work, fsync="off")
        router = ShardRouter(store, port=0).start()
        port = router.port
        remote = RemoteClusterStore(f"127.0.0.1:{port}",
                                    watch_backoff_cap_s=0.2,
                                    watch_resume_window_s=15.0)
        try:
            got = []
            remote.bulk_watch(
                [("pods", lambda e, o, old: got.append(o.name))])
            for i in range(25):
                store.create("pods", make_pod(i))
            assert wait_for(lambda: len(got) == 25)
            # cut the stream, commit events that reach ONLY the WALs,
            # then restart store + router on the same port: the missed
            # events must replay from each shard's recovered tail
            router.stop()
            for i in range(6):
                store.create("pods", build_pod(
                    "ns", f"missed{i}", "", "Pending", {"cpu": "1"},
                    "pg"))
            store.close()
            store2 = ShardedClusterStore(4, data_dir=work, fsync="off")
            router2 = ShardRouter(store2, port=port).start()
            try:
                assert wait_for(
                    lambda: sum(1 for n in got
                                if n.startswith("missed")) == 6,
                    timeout=15.0)
                assert len(got) == len(set(got)) == 31  # zero dup/lost
                # the counter increments after the resume's inline
                # replay returns — the replayed events can be observed
                # a beat before it on a loaded box
                assert wait_for(lambda: remote.watch_resumes >= 1)
                assert not remote.watch_failed
            finally:
                router2.stop()
                store2.close()
        finally:
            remote.close()

    def test_bulk_apply_chunks_bounded_frames(self, served_shards,
                                              monkeypatch):
        store, router, remote = served_shards
        calls = []
        real = RemoteClusterStore._request

        def spy(self, payload):
            if payload.get("op") == "bulk_apply":
                calls.append(len(payload["items"]))
            return real(self, payload)

        monkeypatch.setattr(RemoteClusterStore, "_request", spy)
        res = remote.bulk_apply(
            [("pods", make_pod(i), "create") for i in range(40)],
            chunk_bytes=1500)
        assert len(calls) > 1              # the wave really split
        assert sum(calls) == 40            # nothing dropped
        assert [r.name for r in res] == [f"p{i}" for i in range(40)]
        assert len(store.list("pods")) == 40

    def test_shard_request_fault_rides_the_retry_path(self,
                                                      served_shards):
        store, router, remote = served_shards
        faults.arm("shard_request", every=3)
        try:
            for i in range(12):
                remote.create("pods", make_pod(i))
            assert faults.fired("shard_request") > 0
        finally:
            faults.reset()
        assert len(store.list("pods")) == 12

    def test_shard_crash_fault_lands_write_exactly_once(self,
                                                        served_shards):
        store, router, remote = served_shards
        faults.arm("shard_crash", at=(1,))
        try:
            remote.create("pods", make_pod(0))
        finally:
            faults.reset()
        assert len(store.list("pods")) == 1

    def test_shard_metrics_exported(self, served_shards, tmp_path):
        from volcano_tpu_torch.metrics import metrics

        store, router, remote = served_shards
        names = []
        remote.bulk_watch([("pods",
                            lambda e, o, old: names.append(o.name))])
        for i in range(30):
            store.create("pods", make_pod(i))
        assert wait_for(lambda: len(names) == 30)
        total = sum(metrics.store_shard_events_total.get(
            {"shard": str(i)}) for i in range(4))
        assert total >= 30
        # the wal family carries the shard label on sharded lineages
        durable = ShardedClusterStore(2, data_dir=str(tmp_path),
                                      fsync="off")
        before = metrics.store_wal_appends_total.get({"shard": "1"})
        for i in range(40):
            durable.create("pods", make_pod(i))
        assert metrics.store_wal_appends_total.get({"shard": "1"}) > before
        durable.close()


class TestControllerFanout:
    def _submit_jobs(self, store, n=6):
        from volcano_tpu_torch.models import Job, JobSpec, TaskSpec
        store.apply("queues", build_queue("default", weight=1))
        for j in range(n):
            store.create("jobs", Job(
                name=f"fan{j}", namespace="ns",
                spec=JobSpec(min_available=2, queue="default", tasks=[
                    TaskSpec(name="t", replicas=2, template={
                        "spec": {"containers": [
                            {"name": "c",
                             "requests": {"cpu": "1",
                                          "memory": "1Gi"}}]}})])))

    def test_parallel_drain_matches_serial(self):
        from volcano_tpu_torch.controllers import ControllerManager

        outcomes = {}
        for label, workers in (("serial", 1), ("parallel", 4)):
            store = ShardedClusterStore(4)
            mgr = ControllerManager(store, default_queue="default",
                                    shard_workers=workers)
            mgr.run()
            self._submit_jobs(store)
            for _ in range(6):
                mgr.process_all()
            outcomes[label] = sorted(
                (pg.name, pg.spec.min_member)
                for pg in store.list("podgroups"))
        assert outcomes["serial"] == outcomes["parallel"]
        assert len(outcomes["parallel"]) == 6

    def test_controllers_over_one_bulk_stream(self, served_shards):
        from volcano_tpu_torch.controllers import ControllerManager

        store, router, remote = served_shards
        n_socks = len(remote._watch_socks)
        mgr = ControllerManager(remote, default_queue="default",
                                bulk_watch=True)
        mgr.run()
        # every controller subscription rides ONE stream
        assert len(remote._watch_socks) == n_socks + 1
        self._submit_jobs(remote, n=2)
        assert wait_for(lambda: (mgr.process_all() or
                                 len(remote.list("podgroups")) == 2),
                        timeout=10.0)


@pytest.mark.slow
class TestShardedStoreCrashSoak:
    def test_shards4_kill9_identical_to_golden(self, tmp_path):
        """The acceptance soak: a 4-shard durable store process
        SIGKILLed mid-churn with a wave's pods spread across per-shard
        WALs, restarted on the same port + data dir (every shard
        recovers from only its own WAL), controllers on one bulk_watch
        stream — decisions bind-for-bind identical to the uninterrupted
        golden run, zero lost/dup, zero crash-only resyncs."""
        from test_torch_netha import run_store_crash_soak

        waves, kill_at = 5, 2
        golden = run_store_crash_soak(str(tmp_path / "golden"),
                                      waves=waves, shards=4,
                                      bulk_watch=True)
        crash = run_store_crash_soak(str(tmp_path / "crash"),
                                     waves=waves, kill_at_wave=kill_at,
                                     shards=4, bulk_watch=True)
        assert golden["stalls"] == [] and crash["stalls"] == []
        assert crash["binds_by_wave"] == golden["binds_by_wave"]
        assert crash["total_binds"] > 0
        assert crash["lost_binds"] == 0 and crash["dup_binds"] == 0
        assert crash["crashes"] == 0 and golden["crashes"] == 0
        assert crash["watch_resumes"] > 0
        assert crash["crash_only_resyncs"] == 0
