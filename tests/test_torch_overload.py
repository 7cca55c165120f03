"""The port's overload-protected front door
(volcano_tpu_torch/resilience/overload.py, wired through
client/server.py and client/remote.py), on the CPU.

- The cases of tests/test_overload.py through the port (gate units,
  the retry budget, live-server typed sheds, retry discipline and wire
  compatibility, the metric families, TestShardedAndProc's gated
  router and per-worker gates) but for the vcctl tables, which are
  tests/test_torch_cli.py's.
- One scripted sequence of admissions through both packages' gates
  under a fake clock: the same grants, sheds, reasons, retry-after
  hints and lane tables, step by step.

Tolerance: exact.
"""

import socket
import threading
import time

import pytest

from volcano_tpu_torch.client import (
    ClusterStore, OverloadedError, RemoteClusterStore, RetryBudget,
    RetryBudgetExhausted, StoreServer,
)
from volcano_tpu_torch.client.codec import encode
from volcano_tpu_torch.client.server import MAGIC, recv_frame, send_frame
from volcano_tpu_torch.models import Lease
from volcano_tpu_torch.resilience.faultinject import faults
from volcano_tpu_torch.resilience.overload import (
    DEFAULT_LANES, AdmissionGate, LaneStore, classify, parse_lane_spec,
)

from torch_helpers import Builders, pkg_mod

build_node = Builders("torch").build_node
build_queue = Builders("torch").build_queue



@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    yield
    faults.reset()


@pytest.fixture()
def gated_store():
    """Default-gate server: generous limits, protocol-indistinguishable
    under no load."""
    store = ClusterStore()
    server = StoreServer(store).start()
    client = RemoteClusterStore(server.address)
    try:
        yield store, server, client
    finally:
        client.close()
        server.stop()


def fast_client(address, **kw):
    kw.setdefault("retry_base_s", 0.01)
    kw.setdefault("retry_cap_s", 0.02)
    return RemoteClusterStore(address, **kw)


# ---------------------------------------------------------------------------
# the gate itself
# ---------------------------------------------------------------------------

class TestAdmissionGateUnit:
    def test_classify_lanes(self):
        assert classify("get") == "read"
        assert classify("watch") == "read"
        assert classify("bulk_watch") == "control"
        assert classify("ship") == "control"
        assert classify("bulk_apply", prio="read") == "bulk"
        assert classify("update", fencing={"lock": "l"}) == "system"
        assert classify("get", kind="leases") == "system"
        assert classify("fence_check") == "system"
        assert classify("set_peers") == "system"
        assert classify("list", prio="control") == "control"
        assert classify("list", prio="bogus") == "read"

    def test_parse_lane_spec(self):
        lanes = parse_lane_spec("read=4:8:2,bulk=16")
        assert lanes["read"] == (4, 8, 2)
        assert lanes["bulk"] == (16, DEFAULT_LANES["bulk"][1], 0)
        assert lanes["system"] == DEFAULT_LANES["system"]
        assert parse_lane_spec(None) == dict(DEFAULT_LANES)
        with pytest.raises(ValueError, match="unknown admission lane"):
            parse_lane_spec("vip=1:1")

    def test_inflight_bound_queues_then_grants(self):
        gate = AdmissionGate({"read": (1, 4, 0)}, queue_wait_ms=5000)
        t1 = gate.admit("get", {})
        granted = []

        def second():
            t2 = gate.admit("get", {})
            granted.append(t2)
            gate.release(t2)

        th = threading.Thread(target=second)
        th.start()
        time.sleep(0.1)
        assert not granted  # queued behind the held slot
        assert gate.stats()["read"]["queued"] == 1
        gate.release(t1)
        th.join(timeout=5)
        assert granted
        st = gate.stats()["read"]
        assert st["inflight"] == 0 and st["queued"] == 0
        assert st["admitted"] == 2 and st["sheds"] == 0

    def test_queue_full_sheds_typed_with_retry_after(self):
        gate = AdmissionGate({"read": (1, 0, 0)}, retry_after_ms=123.0)
        t1 = gate.admit("get", {})
        with pytest.raises(OverloadedError) as ei:
            gate.admit("get", {})
        assert ei.value.reason == "queue_full"
        assert ei.value.lane == "read"
        assert ei.value.retry_after_ms == 123.0
        gate.release(t1)
        st = gate.stats()["read"]
        assert st["sheds"] == 1 and st["shed_reasons"] == {"queue_full": 1}

    def test_queue_wait_deadline_sheds(self):
        gate = AdmissionGate({"read": (1, 4, 0)}, queue_wait_ms=50)
        t1 = gate.admit("get", {})
        t0 = time.monotonic()
        with pytest.raises(OverloadedError) as ei:
            gate.admit("get", {})
        assert ei.value.reason == "queue_wait"
        assert 0.03 < time.monotonic() - t0 < 2.0
        gate.release(t1)
        assert gate.stats()["read"]["queued"] == 0

    def test_wire_deadline_expired_on_arrival(self):
        gate = AdmissionGate()
        with pytest.raises(OverloadedError) as ei:
            gate.admit("get", {"deadline_ms": 0})
        assert ei.value.reason == "deadline"
        st = gate.stats()["read"]
        assert st["deadline_expired"] == 1
        # a live deadline admits normally
        t = gate.admit("get", {"deadline_ms": 5000})
        gate.release(t)
        assert gate.stats()["read"]["deadline_expired"] == 1

    def test_wire_deadline_caps_queue_wait(self):
        gate = AdmissionGate({"read": (1, 4, 0)}, queue_wait_ms=30000)
        t1 = gate.admit("get", {})
        t0 = time.monotonic()
        with pytest.raises(OverloadedError) as ei:
            gate.admit("get", {"deadline_ms": 60})
        # shed at the request's own deadline, not the 30s lane wait
        assert time.monotonic() - t0 < 5.0
        assert ei.value.reason == "deadline"
        assert gate.stats()["read"]["deadline_expired"] == 1
        gate.release(t1)

    def test_system_lane_never_queues_never_sheds(self):
        gate = AdmissionGate({"read": (1, 0, 0)})
        held = [gate.admit("update", {"fencing": {"lock": "l"}})
                for _ in range(64)]
        lease_t = gate.admit("get", {"kind": "leases"})
        st = gate.stats()["system"]
        assert st["inflight"] == 65 and st["queued"] == 0
        assert st["sheds"] == 0
        for t in held:
            gate.release(t)
        gate.release(lease_t)
        assert gate.stats()["system"]["inflight"] == 0

    def test_per_client_fairness_round_robin(self):
        # one hot client floods the lane; a second client's single
        # request must NOT wait out the whole backlog
        gate = AdmissionGate({"read": (1, 64, 0)}, queue_wait_ms=30000)
        order = []
        lock = threading.Lock()
        first = gate.admit("get", {}, client="hot")

        def worker(client, tag):
            t = gate.admit("get", {}, client=client)
            with lock:
                order.append(tag)
            time.sleep(0.01)
            gate.release(t)

        hot = [threading.Thread(target=worker, args=("hot", f"hot{i}"))
               for i in range(6)]
        for th in hot:
            th.start()
        for _ in range(100):
            if gate.stats()["read"]["queued"] >= 6:
                break
            time.sleep(0.01)
        cold = threading.Thread(target=worker, args=("cold", "cold"))
        cold.start()
        for _ in range(100):
            if gate.stats()["read"]["queued"] >= 7:
                break
            time.sleep(0.01)
        gate.release(first)  # start draining
        cold.join(timeout=10)
        for th in hot:
            th.join(timeout=10)
        # round-robin across flows: the cold client is granted right
        # after the next hot grant, never behind the whole hot backlog
        assert order.index("cold") <= 1, order

    def test_stream_cap(self):
        gate = AdmissionGate({"read": (8, 8, 2)})
        s1 = gate.admit("watch", {}, stream=True)
        s2 = gate.admit("watch", {}, stream=True)
        with pytest.raises(OverloadedError) as ei:
            gate.admit("watch", {}, stream=True)
        assert ei.value.reason == "streams"
        gate.release(s1)
        s3 = gate.admit("watch", {}, stream=True)  # slot freed
        gate.release(s2)
        gate.release(s3)
        assert gate.stats()["read"]["streams"] == 0

    def test_disabled_gate_is_a_noop(self):
        gate = AdmissionGate({"read": (1, 0, 0)}, enabled=False)
        assert gate.admit("get", {}) is None
        assert gate.admit("get", {"deadline_ms": 0}) is None

    def test_admission_shed_fault_forces_shed_any_lane(self):
        gate = AdmissionGate()
        faults.arm("admission_shed", at=(1,))
        with pytest.raises(OverloadedError) as ei:
            gate.admit("get", {"kind": "leases"})  # even system
        assert ei.value.reason == "fault"
        assert gate.stats()["system"]["shed_reasons"] == {"fault": 1}

    def test_request_deadline_fault_expires_on_arrival(self):
        gate = AdmissionGate()
        faults.arm("request_deadline", at=(1,))
        with pytest.raises(OverloadedError) as ei:
            gate.admit("get", {})
        assert ei.value.reason == "deadline"
        assert gate.stats()["read"]["deadline_expired"] == 1


class TestRetryBudget:
    def test_refill_and_spend(self):
        rb = RetryBudget(ratio=0.5, capacity=2.0, initial=0.0)
        assert not rb.try_spend()
        for _ in range(2):
            rb.on_request()
        assert rb.balance() == 1.0
        assert rb.try_spend()
        assert not rb.try_spend()
        assert rb.exhausted == 2
        for _ in range(100):
            rb.on_request()
        assert rb.balance() == 2.0  # capped


# ---------------------------------------------------------------------------
# live server: typed sheds, retry discipline, wire compat
# ---------------------------------------------------------------------------

class TestOverloadWire:
    def test_default_gate_invisible_under_no_load(self, gated_store):
        store, server, client = gated_store
        client.create("queues", build_queue("q1", weight=1))
        client.apply("nodes", build_node("n1", {"cpu": "1"}))
        seen = []
        client.watch("queues", lambda e, o, old: seen.append((e, o.name)))
        assert ("add", "q1") in seen
        info = client.admission_info()
        assert info["enabled"]
        lanes = info["lanes"]
        assert all(st["sheds"] == 0 for st in lanes.values())
        assert all(st["deadline_expired"] == 0 for st in lanes.values())
        assert lanes["read"]["admitted"] >= 2

    def test_headerless_old_client_interops(self, gated_store):
        # a pre-overload client sends no prio/client/deadline_ms: the
        # server classifies by op shape and serves it unchanged
        store, server, client = gated_store
        sock = socket.create_connection(("127.0.0.1", server.port))
        try:
            sock.sendall(MAGIC)
            send_frame(sock, {"op": "create", "kind": "queues",
                              "obj": encode(build_queue("oldq"))})
            resp = recv_frame(sock)
            assert resp["ok"]
            send_frame(sock, {"op": "get", "kind": "queues",
                              "name": "oldq"})
            assert recv_frame(sock)["ok"]
        finally:
            sock.close()
        assert store.get("queues", "oldq").name == "oldq"
        # fenced frames from an old client still land in system lane
        assert client.admission_info()["lanes"]["read"]["admitted"] >= 2

    def test_header_stamping_client_against_old_server(self):
        # "old server" = ungated (the pre-overload dispatch never read
        # these fields; unknown request fields are ignored either way)
        store = ClusterStore()
        server = StoreServer(store,
                             gate=AdmissionGate(enabled=False)).start()
        client = fast_client(server.address, lane="control",
                             op_deadline_ms=5000.0)
        try:
            client.create("queues", build_queue("q1"))
            assert client.get("queues", "q1").name == "q1"
            assert [q.name for q in client.list("queues")] == ["q1"]
            # an ungated server reports the gate off, with no lanes
            # (a genuinely pre-overload server would refuse the op as
            # unknown; either way vcctl degrades to no table)
            info = client.admission_info()
            assert info["enabled"] is False and info["lanes"] == {}
        finally:
            client.close()
            server.stop()

    def test_forced_shed_surfaces_typed_with_hint(self, gated_store):
        store, server, client = gated_store
        client.create("queues", build_queue("q1"))
        shed_client = fast_client(server.address, retry_attempts=0)
        faults.arm("admission_shed", every=1)
        try:
            with pytest.raises(OverloadedError) as ei:
                shed_client.list("queues")
            assert ei.value.retry_after_ms is not None
            assert ei.value.lane == "read"
            assert ei.value.reason == "fault"
        finally:
            faults.reset()
            shed_client.close()
        info = client.admission_info()
        assert info["lanes"]["read"]["shed_reasons"].get("fault", 0) >= 1

    def test_request_deadline_fault_through_live_server(self, gated_store):
        store, server, client = gated_store
        client.create("queues", build_queue("q1"))
        c = fast_client(server.address, retry_attempts=0)
        faults.arm("request_deadline", at=(1,))
        try:
            with pytest.raises(OverloadedError) as ei:
                c.list("queues")
            assert ei.value.reason == "deadline"
        finally:
            faults.reset()
            c.close()
        lanes = client.admission_info()["lanes"]
        assert lanes["read"]["deadline_expired"] >= 1

    def test_expired_deadline_rejected_on_arrival(self, gated_store):
        # the wire contract itself: deadline_ms <= 0 refuses before a
        # thread burns on a response nobody is waiting for
        store, server, client = gated_store
        sock = socket.create_connection(("127.0.0.1", server.port))
        try:
            sock.sendall(MAGIC)
            send_frame(sock, {"op": "list", "kind": "queues",
                              "deadline_ms": -5})
            resp = recv_frame(sock)
            assert resp["ok"] is False
            assert resp["error"] == "OverloadedError"
            assert resp["reason"] == "deadline"
            assert "retry_after_ms" in resp
            # the connection survives a shed: next request serves
            send_frame(sock, {"op": "ping"})
            assert recv_frame(sock)["ok"]
        finally:
            sock.close()

    def test_retry_honors_retry_after_then_succeeds(self, gated_store):
        store, server, client = gated_store
        client.create("queues", build_queue("q1"))
        c = fast_client(server.address, retry_attempts=3)
        faults.arm("admission_shed", at=(1, 2))  # shed twice, then serve
        try:
            assert [q.name for q in c.list("queues")] == ["q1"]
            assert c.overload_retries == 2
        finally:
            faults.reset()
            c.close()

    def test_retry_budget_exhausted_typed(self, gated_store):
        store, server, client = gated_store
        client.create("queues", build_queue("q1"))
        c = fast_client(server.address, retry_attempts=5,
                        retry_budget=RetryBudget(ratio=0.0, initial=1.0))
        faults.arm("admission_shed", every=1)
        try:
            with pytest.raises(RetryBudgetExhausted) as ei:
                c.list("queues")
            assert ei.value.reason == "retry_budget"
            # the budget refused the SECOND retry: one spend, one refusal
            assert c.overload_retries == 1
        finally:
            faults.reset()
            c.close()

    def test_system_lane_bypasses_retry_budget(self, gated_store):
        # lease renewal must keep retrying even with a dry budget:
        # giving up on the lease IS the outage
        store, server, client = gated_store
        lease = Lease(name="volcano", holder_identity="s1",
                      lease_duration_seconds=30, renew_time=time.time())
        client.create("leases", lease)
        c = fast_client(server.address, retry_attempts=4,
                        retry_budget=RetryBudget(ratio=0.0, initial=0.0))
        # warm the lazy topology probe first, so the armed schedule
        # below counts only the lease reads
        assert c.get("leases", "volcano").holder_identity == "s1"
        faults.arm("admission_shed", at=(1, 2))
        try:
            got = c.get("leases", "volcano")  # system lane: kind==leases
            assert got.holder_identity == "s1"
            assert c.overload_retries == 2  # retried, budget untouched
            assert c.retry_budget.balance() == 0.0
            assert c.retry_budget.exhausted == 0
        finally:
            faults.reset()
            c.close()

    def test_watch_storm_sheds_at_stream_cap(self):
        # the read lane's max_streams bounds LIVE fan-out: watcher 3 is
        # refused typed; the admitted watchers keep delivering
        store = ClusterStore()
        server = StoreServer(
            store, gate=AdmissionGate({"read": (8, 8, 2)})).start()
        a = fast_client(server.address)
        b = fast_client(server.address)
        try:
            seen = []
            a.watch("queues", lambda e, o, old: seen.append(o.name))
            a.watch("nodes", lambda e, o, old: None)
            with pytest.raises(OverloadedError) as ei:
                b.watch("pods", lambda e, o, old: None)
            assert ei.value.reason == "streams"
            # control lane is untouched: the controller fan-out stream
            # still subscribes
            b.bulk_watch([("podgroups", lambda e, o, old: None)])
            store.create("queues", build_queue("qx"))
            deadline = time.time() + 5
            while "qx" not in seen and time.time() < deadline:
                time.sleep(0.01)
            assert "qx" in seen  # admitted stream unaffected by the shed
            st = server.gate.stats()
            assert st["read"]["streams"] == 2
            assert st["control"]["streams"] == 1
        finally:
            a.close()
            b.close()
            server.stop()

    def test_stream_slot_freed_on_disconnect(self):
        store = ClusterStore()
        server = StoreServer(
            store, gate=AdmissionGate({"read": (8, 8, 1)})).start()
        a = fast_client(server.address)
        b = fast_client(server.address)
        try:
            a.watch("queues", lambda e, o, old: None)
            with pytest.raises(OverloadedError):
                b.watch("queues", lambda e, o, old: None)
            a.close()  # stream ends -> slot frees
            deadline = time.time() + 15
            while time.time() < deadline:
                # the pump notices the dead peer at its next send:
                # push events until the slot frees
                store.create("queues", build_queue(
                    f"tick{int(time.time() * 1000) % 10 ** 9}"))
                if server.gate.stats()["read"]["streams"] == 0:
                    break
                time.sleep(0.05)
            b.watch("queues", lambda e, o, old: None)
            assert server.gate.stats()["read"]["streams"] == 1
        finally:
            a.close()
            b.close()
            server.stop()

    def test_lane_store_tags_control(self, gated_store):
        store, server, client = gated_store
        view = LaneStore(client, "control")
        view.create("queues", build_queue("ctrlq"))
        view.list("queues")
        lanes = client.admission_info()["lanes"]
        assert lanes["control"]["admitted"] >= 2
        # bulk still classifies bulk through the view
        view.bulk_apply([("queues", build_queue("bq"))])
        assert client.admission_info()["lanes"]["bulk"]["admitted"] >= 1


# ---------------------------------------------------------------------------
# the metric families the gate and the retry budget set
# ---------------------------------------------------------------------------

class TestMetricsExposition:
    def test_metrics_exposition(self, gated_store):
        from volcano_tpu_torch.metrics.metrics import registry
        store, server, client = gated_store
        client.create("queues", build_queue("q1"))
        c = fast_client(server.address, retry_attempts=1,
                        retry_budget=RetryBudget(ratio=0.0, initial=1.0))
        faults.arm("admission_shed", every=1)
        with pytest.raises(OverloadedError):
            c.list("queues")
        faults.arm("request_deadline", at=(1,))
        faults.disarm("admission_shed")
        with pytest.raises(OverloadedError):
            c.list("queues")
        faults.reset()
        c.close()
        text = registry.expose()
        assert "volcano_store_admission_inflight{lane=" in text
        assert "volcano_store_admission_queued{lane=" in text
        assert ('volcano_store_admission_sheds_total{lane="read",'
                'reason="fault"}') in text
        assert ("volcano_store_admission_deadline_expired_total"
                '{lane="read"}') in text
        assert "volcano_store_admission_retry_budget " in text
        assert ("volcano_store_admission_retry_budget_exhausted_total"
                in text)


# ---------------------------------------------------------------------------
# both packages' gates, one scripted sequence
# ---------------------------------------------------------------------------

class TestShardedAndProc:
    def test_sharded_router_gated(self):
        from volcano_tpu_torch.client import ShardedClusterStore, ShardRouter
        store = ShardedClusterStore(4)
        router = ShardRouter(store).start()
        client = fast_client(f"127.0.0.1:{router.port}",
                             retry_attempts=0)
        try:
            client.create("queues", build_queue("q1"))
            info = client.admission_info()
            assert info["enabled"]
            faults.arm("admission_shed", every=1)
            with pytest.raises(OverloadedError):
                client.list("queues")
            faults.reset()
            assert [q.name for q in client.list("queues")] == ["q1"]
        finally:
            faults.reset()
            client.close()
            router.stop()

    def test_worker_gates_shed_independently(self, tmp_path):
        # each shard WORKER owns its own gate (one hot shard sheds
        # alone): an expired-deadline request against worker 1 is
        # refused typed there and counted in ITS table only; the
        # router's admission_info aggregates every worker's table
        from volcano_tpu_torch.client import (
            ProcShardRouter, ProcShardedStore, ShardProcSupervisor,
        )
        sup = ShardProcSupervisor(
            2, data_dir=str(tmp_path), fsync="off", admission=False,
            admission_lanes="read=1:4").start()
        store = ProcShardedStore(sup)
        router = ProcShardRouter(store, port=0).start()
        client = fast_client(f"127.0.0.1:{router.port}",
                             retry_attempts=0, direct_routing=False)
        try:
            r0 = sup.request(0, {"op": "ping"})
            assert r0["ok"]
            r1 = sup.request(1, {"op": "ping", "deadline_ms": -1})
            assert r1["ok"] is False
            assert r1["error"] == "OverloadedError"
            assert r1.get("reason") == "deadline"
            info = client.admission_info()
            assert info["enabled"]
            workers = info["workers"]
            assert set(workers) == {"0", "1"}
            assert workers["1"]["read"]["deadline_expired"] >= 1
            assert workers["0"]["read"]["sheds"] == 0
            # the lane spec reached every worker's own gate
            assert workers["0"]["read"]["max_inflight"] == 1
            assert workers["1"]["read"]["max_inflight"] == 1
        finally:
            client.close()
            router.stop()
            sup.stop()


class FakeClock:
    """Advances ``step`` seconds at every reading: a queued request's
    wait deadline has passed by the next reading."""

    def __init__(self, step: float = 1.0):
        self.t = 100.0
        self.step = step

    def __call__(self):
        self.t += self.step
        return self.t


#: (what, args): admit (op, req, client, stream) and hold the ticket
#: under a name, release a held ticket, or arm a fault before the step
SCRIPT = (
    ("admit", "r1", "get", {}, "c1", False),
    ("admit", "r2", "list", {}, "c2", False),
    ("admit", "r3", "get", {}, "c1", False),        # read full: queue_wait
    ("admit", "s1", "update", {"fencing": {"lock": "l"}}, "c1", False),
    ("admit", "s2", "get", {"kind": "leases"}, "c3", False),
    ("admit", "b1", "bulk_apply", {"prio": "read"}, "c2", False),
    ("admit", "b2", "bulk_apply", {}, "c2", False),  # bulk full, no queue
    ("admit", "d1", "get", {"deadline_ms": 0}, "c6", False),
    ("admit", "d2", "list", {"deadline_ms": -3, "prio": "control"}, "c6",
     False),
    ("release", "r1"),
    ("admit", "r4", "get", {}, "c2", False),
    ("fault", "admission_shed"),
    ("admit", "f1", "get", {"kind": "leases"}, "c3", False),
    ("fault", "request_deadline"),
    ("admit", "f2", "list", {"prio": "control"}, "c1", False),
    ("release", "r2"), ("release", "r4"),
    ("admit", "w1", "watch", {}, "c4", True),
    ("admit", "w2", "watch", {}, "c5", True),        # stream cap
    ("admit", "k1", "bulk_watch", {}, "c4", True),
    ("release", "w1"),
    ("admit", "w3", "watch", {}, "c5", True),
    ("release", "s1"), ("release", "s2"), ("release", "b1"),
    ("release", "k1"), ("release", "w3"),
)


def run_script(pkg):
    overload = pkg_mod(pkg, "resilience.overload")
    injector = pkg_mod(pkg, "resilience.faultinject").faults
    injector.reset()
    gate = overload.AdmissionGate(
        {"read": (2, 1, 1), "bulk": (1, 0, 0), "control": (4, 0, 2)},
        queue_wait_ms=50.0, retry_after_ms=75.0, clock=FakeClock())
    held, trace = {}, []
    try:
        for step in SCRIPT:
            if step[0] == "fault":
                injector.arm(step[1], at=(1,))
                trace.append(("armed", step[1]))
                continue
            if step[0] == "release":
                if step[1] in held:
                    gate.release(held.pop(step[1]))
                trace.append(("released", step[1]))
                continue
            _, name, op, req, client, stream = step
            try:
                held[name] = gate.admit(op, dict(req), client=client,
                                        stream=stream)
                trace.append(("granted", name, overload.classify(
                    op, kind=req.get("kind"), fencing=req.get("fencing"),
                    prio=req.get("prio"))))
            except overload.OverloadedError as e:
                trace.append(("shed", name, e.lane, e.reason,
                              e.retry_after_ms))
            trace.append(("stats", gate.stats()))
    finally:
        injector.reset()
    return trace


class TestGateParity:
    def test_scripted_sequence_same_in_both_packages(self):
        got, want = run_script("torch"), run_script("jax")
        assert got == want
        sheds = [t for t in got if t[0] == "shed"]
        # the script reaches every shed reason the gate has
        assert sorted({t[3] for t in sheds}) == [
            "deadline", "fault", "queue_full", "queue_wait", "streams"]
        # an expired request is not worth a retry: its hint is 0
        assert all(t[4] == (0.0 if t[3] == "deadline" else 75.0)
                   for t in sheds)

    def test_retry_budget_sequence_same_in_both_packages(self):
        def trace(pkg):
            rb = pkg_mod(pkg, "resilience.overload").RetryBudget(
                ratio=0.25, capacity=3.0, initial=1.0)
            out = []
            for i in range(24):
                if i % 3:
                    rb.on_request()
                out.append((rb.try_spend() if i % 4 == 0 else None,
                            rb.balance(), rb.exhausted))
            return out
        assert trace("torch") == trace("jax")
