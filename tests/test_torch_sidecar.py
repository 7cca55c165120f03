"""The port's solver sidecar (volcano_tpu_torch.parallel.sidecar) against
the JAX package's (tests/test_sidecar.py), on the CPU.

- tests/test_sidecar.py's four scenarios through a port server on
  ``device="cpu"`` (in a thread): the round trip equals the local solve
  and a repeated unchanged snapshot ships 0 chunks; preempt, allocate and
  an hdrf allocate through the sidecar decide what the JAX package
  decides.
- The wire format is the JAX package's: a port client against a JAX
  SolverServer and a JAX client against a port server return the same
  assignments as the port's own pair (the JAX server solves op by op,
  ``jax.disable_jit``, so no FMA contraction moves a tie).
- A solve that fails on a CPU server reaches the host fallback, as the
  JAX package's does; a server that names a CUDA device and then fails
  (a fake server here: no card) makes the client's allocate and preempt
  raise — nothing binds or evicts through the host oracle.

Tolerance: exact (assignments, binds, evictions). The test marked
``cuda`` runs a port server on the card (it skips without a GPU); this
module imports JAX only inside the tests that need it, so there it runs
with ``python -m pytest --noconftest -m cuda tests/test_torch_sidecar.py``.
"""

from __future__ import annotations

import socket
import threading
import time

import numpy as np
import pytest
import torch

from torch_helpers import (
    SeededCluster, build_node, build_pod, build_pod_group, build_queue,
    pkg_mod,
)


@pytest.fixture(autouse=True)
def _clean_faults():
    faults = pkg_mod("torch", "resilience").faults
    faults.reset()
    yield
    faults.reset()


def _serve(pkg, path, device="cpu", op_by_op=False):
    """A ``pkg`` SolverServer on ``path`` serving in a daemon thread.
    Returns (thread, server)."""
    sc = pkg_mod(pkg, "parallel.sidecar")
    server = sc.SolverServer(path, device=device) if pkg == "torch" \
        else sc.SolverServer(path)

    def run():
        if op_by_op:
            import jax
            with jax.disable_jit():
                server.serve_forever()
        else:
            server.serve_forever()

    th = threading.Thread(target=run, daemon=True)
    th.start()
    return th, server


def _client(pkg, path):
    sc = pkg_mod(pkg, "parallel.sidecar")
    # the port's client learns the device from the replies here: its
    # servers in this file name the CPU, or no device
    kw = {"device": None} if pkg == "torch" else {}
    for _ in range(100):
        try:
            client = sc.SidecarSolver(path, **kw)
            client._connect()
            return client
        except OSError:
            time.sleep(0.05)
    pytest.fail("sidecar server did not come up")


def _stop(client, th, server):
    try:
        client.shutdown_server()
    except Exception:  # noqa: BLE001
        server.stop()
    th.join(timeout=10)
    assert not th.is_alive()


@pytest.fixture
def sidecar(tmp_path):
    path = str(tmp_path / "solver.sock")
    th, server = _serve("torch", path)
    client = _client("torch", path)
    yield client
    _stop(client, th, server)


def _problem(n_nodes=8, n_jobs=4, tasks_per_job=3):
    """__graft_entry__._make_problem from the port's models, flattened and
    packed, with its binpack score params."""
    api = pkg_mod("torch", "api")
    m = pkg_mod("torch", "models")
    ops = pkg_mod("torch", "ops")
    nodes = {}
    for i in range(n_nodes):
        rl = {"cpu": "8", "memory": "32Gi", "pods": 110}
        nodes[f"n{i}"] = api.NodeInfo(m.Node(name=f"n{i}", allocatable=rl,
                                             capacity=dict(rl)))
    jobs, tasks = {}, []
    for k in range(n_jobs):
        job = api.JobInfo(f"bench/j{k}", m.PodGroup(
            name=f"j{k}", namespace="bench",
            spec=m.PodGroupSpec(min_member=tasks_per_job)))
        for i in range(tasks_per_job):
            t = api.TaskInfo(m.Pod(
                name=f"j{k}-{i}", namespace="bench",
                annotations={api.POD_GROUP_ANNOTATION: f"j{k}"},
                containers=[{"requests": {"cpu": "1", "memory": "2Gi"}}]))
            job.add_task_info(t)
            tasks.append(t)
        jobs[job.uid] = job
    arr = ops.flatten_snapshot(jobs, nodes, tasks)
    sp = ops.ScoreParams(binpack_weight=1.0).resolved(arr.R, arr.N)
    params = {
        "binpack_weight": np.float32(sp.binpack_weight),
        "binpack_res_weights": sp.binpack_res_weights,
        "least_req_weight": np.float32(sp.least_req_weight),
        "most_req_weight": np.float32(sp.most_req_weight),
        "balanced_weight": np.float32(sp.balanced_weight),
        "node_static": sp.node_static,
    }
    return arr.packed(), params


def test_roundtrip_matches_local_solve(sidecar):
    from volcano_tpu_torch.ops import PackedDeviceCache
    from volcano_tpu_torch.ops.solver import solve_allocate_packed2d
    (fbuf, ibuf, layout), params = _problem()
    assigned, kind, info = sidecar.solve(fbuf, ibuf, layout, params)
    dc = PackedDeviceCache(device="cpu")
    local = solve_allocate_packed2d(*dc.update(fbuf, ibuf, layout), layout,
                                    params, score_families=("binpack",))
    assert np.array_equal(assigned, local.assigned.numpy())
    assert np.array_equal(kind, local.kind.numpy())
    assert (assigned >= 0).sum() == 12
    assert info["shipped_chunks"] > 0  # first request ships everything
    assert info["device"] == "cpu" and sidecar.device == "cpu"
    assert not sidecar.on_card
    assert sidecar.last_request_bytes >= fbuf.nbytes + ibuf.nbytes

    # second solve over the same connection: the server-side arena
    # diffs against the previous upload
    assigned2, _, info2 = sidecar.solve(fbuf, ibuf, layout, params)
    assert np.array_equal(assigned2, assigned)
    assert info2["shipped_chunks"] == 0


@pytest.mark.parametrize("server_pkg,client_pkg",
                         [("jax", "torch"), ("torch", "jax")],
                         ids=["port_client_jax_server",
                              "jax_client_port_server"])
def test_wire_format_crosses_packages(tmp_path, server_pkg, client_pkg):
    (fbuf, ibuf, layout), params = _problem()
    got = {}
    for pair in ((server_pkg, client_pkg), ("torch", "torch")):
        path = str(tmp_path / f"{pair[0]}-{pair[1]}.sock")
        th, server = _serve(pair[0], path, op_by_op=pair[0] == "jax")
        client = _client(pair[1], path)
        try:
            a, k, info = client.solve(fbuf, ibuf, layout, params)
            a2, _, info2 = client.solve(fbuf, ibuf, layout, params)
        finally:
            _stop(client, th, server)
        assert np.array_equal(a2, a) and info2["shipped_chunks"] == 0
        got[pair] = (a.tolist(), k.tolist(), int(info["rounds"]))
    assert got[(server_pkg, client_pkg)] == got[("torch", "torch")]


def _preempt(pkg, sidecar=None):
    m = pkg_mod(pkg, "models")
    ann = pkg_mod(pkg, "api").POD_GROUP_ANNOTATION
    cache_mod = pkg_mod(pkg, "cache")
    fw = pkg_mod(pkg, "framework")
    conf = pkg_mod(pkg, "conf")
    store = pkg_mod(pkg, "client").ClusterStore()
    kw = {"device": "cpu"} if pkg == "torch" else {}
    cache = cache_mod.SchedulerCache(store, **kw)
    cache.binder = cache_mod.FakeBinder()
    cache.evictor = cache_mod.FakeEvictor()
    cache.sidecar = sidecar
    cache.run()
    store.create("priorityclasses", m.PriorityClass("high", 1000))
    store.create("nodes", build_node(m, "n1", {"cpu": "2",
                                               "memory": "4Gi"}))
    inq = m.PodGroupPhase.INQUEUE   # tests/helpers.py's default phase
    low = build_pod_group(m, "low", "c1", 1, "default", phase=inq)
    high = build_pod_group(m, "high", "c1", 1, "default", phase=inq)
    high.spec.priority_class_name = "high"
    store.create("podgroups", low)
    store.create("podgroups", high)
    for i in (1, 2):
        store.create("pods", build_pod(
            m, ann, "c1", f"low-{i}", "n1", "Running",
            {"cpu": "1", "memory": "1Gi"}, "low"))
    store.create("pods", build_pod(
        m, ann, "c1", "high-1", "", "Pending",
        {"cpu": "1", "memory": "1Gi"}, "high"))
    tiers = [conf.Tier(plugins=[conf.PluginOption(name="priority"),
                                conf.PluginOption(name="gang"),
                                conf.PluginOption(name="conformance")]),
             conf.Tier(plugins=[conf.PluginOption(name="predicates"),
                                conf.PluginOption(name="nodeorder")])]
    ssn = fw.open_session(cache, tiers)
    try:
        fw.get_action("preempt").execute(ssn)
    finally:
        fw.close_session(ssn)
    return list(cache.evictor.evicts)


def test_preempt_action_through_sidecar(sidecar):
    """Eviction solves ship over the socket too: a high-priority gang
    preempts via the sidecar's solve_evict op, as the JAX package
    preempts in process."""
    import jax
    got = _preempt("torch", sidecar)
    assert len(got) == 1 and got[0].startswith("c1/low")
    with jax.disable_jit():
        assert got == _preempt("jax")


def _allocate(pkg, sidecar=None, hdrf=False):
    m = pkg_mod(pkg, "models")
    ann = pkg_mod(pkg, "api").POD_GROUP_ANNOTATION
    cache_mod = pkg_mod(pkg, "cache")
    fw = pkg_mod(pkg, "framework")
    conf = pkg_mod(pkg, "conf")
    store = pkg_mod(pkg, "client").ClusterStore()
    kw = {"device": "cpu"} if pkg == "torch" else {}
    cache = cache_mod.SchedulerCache(store, **kw)
    cache.binder = cache_mod.FakeBinder()
    cache.evictor = cache_mod.FakeEvictor()
    if sidecar is not None:
        cache.sidecar = sidecar
        # prove the solve goes through the sidecar: no in-process arena
        cache.device_cache = None
    cache.run()
    confs = None
    inq = m.PodGroupPhase.INQUEUE   # tests/helpers.py's default phase
    if hdrf:
        for name, h, w in (("root-sci", "root/sci", "100/50"),
                           ("root-eng-dev", "root/eng/dev", "100/50/50"),
                           ("root-eng-prod", "root/eng/prod", "100/50/50")):
            store.apply("queues", build_queue(m, name, annotations={
                "volcano.sh/hierarchy": h,
                "volcano.sh/hierarchy-weights": w}))
        store.create("nodes", build_node(m, "n", {"cpu": "10",
                                                  "memory": "10G"}))
        for pg_name, q, req in (
                ("pg1", "root-sci", {"cpu": "1", "memory": "1G"}),
                ("pg21", "root-eng-dev", {"cpu": "1", "memory": "0"}),
                ("pg22", "root-eng-prod", {"cpu": "0", "memory": "1G"})):
            store.create("podgroups", build_pod_group(m, pg_name, "default",
                                                      1, q, phase=inq))
            for i in range(10):
                store.create("pods", build_pod(
                    m, ann, "default", f"{pg_name}-p{i}", "", "Pending",
                    req, pg_name))
        tiers = [conf.Tier(plugins=[
            conf.PluginOption(name="drf",
                              arguments={"drf.enableHierarchy": True}),
            conf.PluginOption(name="gang"),
            conf.PluginOption(name="predicates"),
            conf.PluginOption(name="nodeorder")])]
        confs = [conf.Configuration("allocate", {"mode": "solver"})]
    else:
        for n in ("n1", "n2"):
            store.create("nodes", build_node(m, n, {"cpu": "4",
                                                    "memory": "8Gi"}))
        store.create("podgroups", build_pod_group(m, "pg1", "c1", 2,
                                                  "default", phase=inq))
        for i in (1, 2):
            store.create("pods", build_pod(
                m, ann, "c1", f"p{i}", "", "Pending",
                {"cpu": "2", "memory": "1Gi"}, "pg1"))
        tiers = [conf.Tier(plugins=[conf.PluginOption(name="gang"),
                                    conf.PluginOption(name="priority")]),
                 conf.Tier(plugins=[conf.PluginOption(name="predicates"),
                                    conf.PluginOption(name="nodeorder")])]
    ssn = fw.open_session(cache, tiers, confs)
    try:
        if sidecar is not None:
            assert ssn.sidecar is sidecar
        fw.get_action("allocate").execute(ssn)
        timing = dict(ssn.solver_options.get("timing", {}))
    finally:
        fw.close_session(ssn)
    return dict(cache.binder.binds), timing


def test_allocate_action_through_sidecar(sidecar):
    import jax
    binds, timing = _allocate("torch", sidecar)
    assert len(binds) == 2 and timing["sidecar_shipped_chunks"] > 0
    assert "host_fallback" not in timing
    with jax.disable_jit():
        assert binds == _allocate("jax")[0]


def test_hdrf_allocate_through_sidecar(sidecar):
    """The hdrf tree arrays ride the packed layout across the socket and
    the server honors use_hdrf_order: the split matches the JAX
    package's in-process solve."""
    import jax
    binds, _ = _allocate("torch", sidecar, hdrf=True)
    alloc = {}
    for key in binds:
        pg = key.split("/")[1].rsplit("-p", 1)[0]
        alloc[pg] = alloc.get(pg, 0) + 1
    assert alloc == {"pg1": 5, "pg21": 5, "pg22": 5}, alloc
    with jax.disable_jit():
        assert binds == _allocate("jax", hdrf=True)[0]


def test_cpu_server_failure_reaches_the_host_fallback(sidecar):
    """A solve that fails on a CPU server finishes the session through
    the host loop, binding what the JAX package's host fallback binds."""
    import jax
    t = SeededCluster("torch", 23, n_nodes=8)
    j = SeededCluster("jax", 23, n_nodes=8)
    t.cache.sidecar = sidecar
    t_faults = pkg_mod("torch", "resilience").faults
    j_faults = pkg_mod("jax", "resilience").faults
    try:
        t_faults.arm_once("sidecar_solve")
        j_faults.arm_once("solver_dispatch")
        bt = t.cycle(4)
        with jax.disable_jit():
            bj = j.cycle(4)
    finally:
        t_faults.reset()
        j_faults.reset()
    assert bt == bj and bt
    timing = t.sched.last_cycle_timing
    assert timing.get("host_fallback") == 1.0
    assert "allocate_error" not in timing
    assert t.cache.breaker._consecutive_failures == 1
    # the server invalidated its arena: the next request re-ships whole
    bt = t.cycle(3, churn=0.2)
    with jax.disable_jit():
        assert bt == j.cycle(3, churn=0.2)
    timing = t.sched.last_cycle_timing
    assert not timing.get("host_fallback")
    assert timing["sidecar_shipped_chunks"] > 0


class _CudaFailingServer:
    """Answers every request with the error frame a port server on a CUDA
    device sends after a failed solve."""

    def __init__(self, path):
        from volcano_tpu_torch.parallel import sidecar as sc
        self._sc = sc
        self.requests = []
        self.listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.listener.bind(path)
        self.listener.listen(1)
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def _serve(self):
        try:
            conn, _ = self.listener.accept()
        except OSError:
            return
        with conn:
            while True:
                try:
                    header, _ = self._sc._recv_frame(conn)
                except (ConnectionError, OSError):
                    return
                self.requests.append(header.get("op"))
                self._sc._send_frame(conn, {
                    "error": "RuntimeError: fused_choice kernel launch "
                             "failed: CUDA error 6",
                    "device": "cuda:0"}, [])

    def close(self):
        self.listener.close()
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()


@pytest.mark.parametrize("action", ["allocate", "preempt"])
def test_cuda_server_failure_raises_on_the_client(tmp_path, action):
    """A server that names a CUDA device and fails: the client's action
    raises (the Scheduler records allocate_error / preempt_error), and
    nothing binds or evicts through the host oracle."""
    path = str(tmp_path / "cuda.sock")
    server = _CudaFailingServer(path)
    sc = pkg_mod("torch", "parallel.sidecar")
    client = sc.SidecarSolver(path, device=None)   # learns it from a reply
    try:
        if action == "allocate":
            c = SeededCluster("torch", 31, n_nodes=6)
            c.cache.sidecar = client
            binds = c.cycle(3)
            timing = c.sched.last_cycle_timing
            assert binds == [] and c.cache.binder.binds == {}
        else:
            with pytest.raises(RuntimeError, match="CUDA error"):
                _preempt("torch", client)
            timing = {}
    finally:
        client.close()
        server.close()
    assert client.device == "cuda:0" and client.on_card
    if action == "allocate":
        assert timing.get("allocate_error") == 1.0
        assert "host_fallback" not in timing
        assert c.cache.breaker._consecutive_failures == 1
        assert server.requests == ["solve"]
    else:
        assert server.requests == ["solve_evict"]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_sidecar_server_on_card(tmp_path):
    """A port server on the card: its replies name the CUDA device, the
    solve equals the same solve on a CPU server, and an unchanged second
    request ships 0 chunks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    (fbuf, ibuf, layout), params = _problem(n_nodes=64, n_jobs=16,
                                            tasks_per_job=8)
    out = {}
    for dev in ("cuda", "cpu"):
        path = str(tmp_path / f"{dev}.sock")
        th, server = _serve("torch", path, device=dev if dev == "cpu"
                            else None)
        client = _client("torch", path)
        try:
            a, k, info = client.solve(fbuf, ibuf, layout, params)
            _, _, info2 = client.solve(fbuf, ibuf, layout, params)
        finally:
            _stop(client, th, server)
        assert info2["shipped_chunks"] == 0
        out[dev] = (a.tolist(), k.tolist(), client.device, info)
    assert out["cuda"][2].startswith("cuda") and out["cuda"][3]["launches"]
    assert out["cuda"][:2] == out["cpu"][:2]
    assert not out["cpu"][3]["launches"]
