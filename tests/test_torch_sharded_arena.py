"""The port's sharded arena (volcano_tpu_torch.ops.device_cache.
ShardedDeviceCache), its solve entry (parallel.solve_allocate_sharded_arena)
and the sharded allocate mode through the Scheduler, on the CPU.

- ``split_packed_layout`` equals the JAX package's, tuple for tuple, and
  raises for a node axis the shard count does not divide.
- Host mirrors and byte accounting equal the JAX package's
  ``ShardedDeviceCache`` over the same sessions (its ``update`` runs here;
  only its solve entry is red on this jax); the resident buffers equal the
  mirrors; a dirty node row ships only to its shard, a zero-dirty session
  ships 0 bytes to every shard, ``invalidate()`` forces one full re-ship
  and keeps the pinned params; a scatter that fails part-way resets the
  arena.
- ``solve_allocate_sharded_arena`` on a 4-shard ``cpu`` mesh equals the
  port's ``solve_allocate_packed2d`` over churned sessions, and the JAX
  package's ``solve_allocate_sharded`` on the first snapshot (op by op:
  ``jax.disable_jit``, see test_torch_solver.py).
- Routing (the counterpart of tests/test_sharded_arena.py
  TestSolverModeRouting): defaults, a conf pin wins, ``auto`` on the byte
  budget, the Scheduler's ``solver_mode`` / ``sharded_byte_budget``.
- Whole Scheduler cycles with a 4-shard ``cpu`` mesh installed on the
  cache: burst and steady cycles bind identically, bind for bind, to the
  port's packed Scheduler and to the JAX package's Scheduler, with and
  without ``drf.enableHierarchy``; a sharded session's bytes land on the
  sharded arena's series only; a failed sharded solve invalidates the
  sharded arena (host fallback on a CPU arena, the action's error on a
  CUDA one); with the cache on the CPU and a sharded arena whose mesh
  names CUDA devices, a failed sharded dispatch and an open breaker are
  both the action's error.

Tolerance: exact.
"""

from __future__ import annotations

import numpy as np
import pytest

pytest.importorskip("jax")  # the JAX reference: absent on the card's machine

import torch

import jax

from volcano_tpu.ops.device_cache import (
    ShardedDeviceCache as JShardedDeviceCache,
)
from volcano_tpu.ops.device_cache import split_packed_layout as j_split
from volcano_tpu.parallel import make_mesh as j_make_mesh
from volcano_tpu.parallel import solve_allocate_sharded as j_sharded
from volcano_tpu_torch.ops import device_cache as tdc_mod
from volcano_tpu_torch.ops.device_cache import (
    ShardedDeviceCache, split_packed_layout,
)
from volcano_tpu_torch.ops.solver import solve_allocate_packed2d
from volcano_tpu_torch.ops import PackedDeviceCache
from volcano_tpu_torch.parallel import (
    Mesh, mesh as t_mesh, solve_allocate_sharded_arena,
)

from test_torch_flatten import cluster_spec, flatten
from test_torch_hdrf import EXAMPLE, HDRF_CONF
from test_torch_solver import params_dict
from torch_helpers import SeededCluster, pkg_mod

D4 = Mesh(["cpu"] * 4)
FLAGS = dict(herd_mode="pack", score_families=("binpack",),
             use_queue_cap=True)


def _problem(seed: int = 7, n_nodes: int = 32):
    arr = flatten("torch", cluster_spec(seed, n_nodes=n_nodes, n_jobs=10,
                                        tasks_per_job=3))
    arr.drf_total = arr.node_alloc[arr.node_valid].sum(axis=0)
    return arr, params_dict(arr, binpack=1.0, least=1.0, balanced=1.0)


def _churn(arr, rng):
    """A cycle's worth of changes in place, layout kept: three node rows
    lose idle, two tasks leave the pending set."""
    n_valid = int(arr.node_valid.sum())
    for i in rng.choice(n_valid, 3, replace=False):
        take = arr.node_idle[i] * np.float32(rng.uniform(0.1, 0.6))
        arr.node_idle[i] -= take
        arr.node_used[i] += take
        arr.node_npods[i] += 1
    valid_t = np.nonzero(arr.task_valid)[0]
    arr.task_valid[rng.choice(valid_t, 2, replace=False)] = False


def _resident_equals_mirror(sdc) -> bool:
    for dev in sdc.mesh.distinct:
        for buf, host in ((sdc._dev_rep_f[dev], sdc._host_rep_f),
                          (sdc._dev_rep_i[dev], sdc._host_rep_i)):
            if not torch.equal(buf.reshape(-1).cpu(), torch.from_numpy(host)):
                return False
    for d in range(sdc.D):
        for buf, host in ((sdc._dev_node_f[d], sdc._host_node_f[d]),
                          (sdc._dev_node_i[d], sdc._host_node_i[d])):
            if not torch.equal(buf.reshape(-1).cpu(), torch.from_numpy(host)):
                return False
    return True


# ---------------------------------------------------------------------------
# layout, mirrors and accounting
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D", (1, 2, 4, 8))
def test_split_packed_layout_equals_jax(D):
    for seed, n_nodes in ((0, 24), (3, 37)):
        arr, _ = _problem(seed, n_nodes)
        layout = arr.packed()[2]
        got = split_packed_layout(layout, D)
        assert got == j_split(layout, D)
        rep, node = got
        assert {k for k, *_ in node} == set(tdc_mod.NODE_AXIS_KEYS) | set(
            tdc_mod.NODE_COL_KEYS)
        assert len(rep) + len(node) == len(layout)
    bad = (("node_idle", "f", 0, 20, (10, 2)),)
    with pytest.raises(ValueError, match="does not divide"):
        split_packed_layout(bad, 8)
    with pytest.raises(ValueError, match="does not divide"):
        split_packed_layout((("sig_masks", "b", 0, 30, (3, 10)),), 4)


def test_mirrors_and_accounting_equal_jax():
    """The same sessions through both packages' sharded arenas: full,
    zero-dirty, one node row of shard 2, churn, a task-only change."""
    rng = np.random.default_rng(3)
    arr, _ = _problem()
    t = ShardedDeviceCache(D4, chunk=64)
    j = JShardedDeviceCache(j_make_mesh(jax.devices()[:4]), chunk=64)
    nl = arr.N // 4

    def session(label):
        fbuf, ibuf, layout = arr.packed()
        t.update(fbuf, ibuf, layout)
        j.update(fbuf, ibuf, layout)
        for k in ("_host_rep_f", "_host_rep_i", "_host_node_f",
                  "_host_node_i"):
            assert getattr(t, k).tobytes() == getattr(j, k).tobytes(), \
                (label, k)
        for k in ("last_shipped_chunks", "last_full_ship", "full_ships",
                  "delta_sessions"):
            assert getattr(t, k) == getattr(j, k), (label, k)
        if t.last_full_ship:
            for k in ("last_shard_bytes", "last_shipped_bytes"):
                assert getattr(t, k) == getattr(j, k), (label, k)
        else:
            # a delta ships exactly its dirty chunks (values + an int32
            # index each) where the JAX package pads them to a power of
            # two: the same shards receive bytes, never more than there
            assert t.last_shipped_bytes == \
                t.last_shipped_chunks * (64 * 4 + 4), label
            for tb, jb in zip(t.last_shard_bytes, j.last_shard_bytes):
                assert tb % (64 * 4 + 4) == 0 and (tb > 0) == (jb > 0) \
                    and tb <= jb, (label, t.last_shard_bytes,
                                   j.last_shard_bytes)
        assert t.full_upload_bytes() == j.full_upload_bytes()
        assert _resident_equals_mirror(t), label
        return list(t.last_shard_bytes)

    assert all(session("full"))
    assert session("zero-dirty") == [0, 0, 0, 0]
    arr.node_idle[2 * nl, 0] -= 1.0
    assert [d for d, b in enumerate(session("node row")) if b] == [2]
    _churn(arr, rng)
    session("churn")
    arr.task_valid[np.nonzero(arr.task_valid)[0][0]] = False
    assert all(session("task row"))


def test_zero_dirty_invalidate_and_params():
    arr, params = _problem()
    fbuf, ibuf, layout = arr.packed()
    sdc = ShardedDeviceCache(D4, chunk=64)
    first = sdc.update(fbuf, ibuf, layout)
    assert sdc.last_full_ship and all(sdc.last_shard_bytes)
    pinned = sdc.params_device(params)
    assert len(pinned) == 4 and sdc.params_repins == 1
    assert all(p["node_static"].shape == (arr.N // 4,) for p in pinned)
    # one replicated buffer per distinct device, one node slab per shard
    assert len({id(x) for x in first[0]}) == 1
    assert len({id(x) for x in first[2]}) == 4
    again = sdc.update(fbuf, ibuf, layout)
    assert sdc.last_shipped_bytes == 0 and sdc.last_shard_bytes == [0] * 4
    assert not sdc.last_full_ship
    assert all(a is b for a, b in zip(again[2], first[2]))
    sdc.invalidate()
    assert sdc._dev_rep_f is None and sdc._dev_node_f is None
    assert sdc._params_blob is not None and sdc.invalidations == 1
    sdc.update(fbuf, ibuf, layout)
    assert sdc.full_ships == 2 and sdc.last_full_ship
    assert sdc.params_device(params) is pinned and sdc.params_repins == 1
    assert sdc.full_upload_bytes() > 0


def test_failed_scatter_resets_the_arena(monkeypatch):
    """A delta whose scatter fails after some shards took their chunks:
    the arena resets (nothing resident can be trusted), the next session
    full-ships, and the solve then equals the packed path's."""
    arr, params = _problem()
    sdc = ShardedDeviceCache(D4, chunk=64)
    sdc.update(*arr.packed())
    for d in range(4):
        arr.node_idle[d * (arr.N // 4), 0] -= 1.0
    real, seen = tdc_mod.scatter_chunks, []

    def flaky(dev, idx, vals):
        seen.append(1)
        if len(seen) == 3:
            raise RuntimeError("injected scatter failure")
        real(dev, idx, vals)

    monkeypatch.setattr(tdc_mod, "scatter_chunks", flaky)
    with pytest.raises(RuntimeError, match="injected"):
        sdc.update(*arr.packed())
    monkeypatch.setattr(tdc_mod, "scatter_chunks", real)
    assert sdc._host_rep_f is None and sdc._dev_node_f is None
    bufs = sdc.update(*arr.packed())
    assert sdc.last_full_ship and _resident_equals_mirror(sdc)
    res = solve_allocate_sharded_arena(*bufs, sdc.params_device(params),
                                       D4, **FLAGS)
    fbuf, ibuf, layout = arr.packed()
    dc = PackedDeviceCache(chunk=64, device="cpu")
    f2d, i2d = dc.update(fbuf, ibuf, layout)
    ref = solve_allocate_packed2d(f2d, i2d, layout, params, **FLAGS)
    assert torch.equal(res.assigned, ref.assigned)


# ---------------------------------------------------------------------------
# the arena entry against the packed path and the JAX package
# ---------------------------------------------------------------------------

def test_arena_solve_equals_packed_and_jax_over_sessions():
    rng = np.random.default_rng(11)
    arr, params = _problem()
    sdc = ShardedDeviceCache(D4, chunk=64)
    dc = PackedDeviceCache(chunk=64, device="cpu")
    for s in range(3):
        fbuf, ibuf, layout = arr.packed()
        bufs = sdc.update(fbuf, ibuf, layout)
        assert sdc.last_full_ship == (s == 0)
        res = solve_allocate_sharded_arena(
            *bufs, sdc.params_device(params), D4, **FLAGS)
        f2d, i2d = dc.update(fbuf, ibuf, layout)
        ref = solve_allocate_packed2d(f2d, i2d, layout, params, **FLAGS)
        for k in ("assigned", "kind", "job_ready"):
            assert torch.equal(getattr(res, k), getattr(ref, k)), (s, k)
        assert int((res.assigned >= 0).sum()) > 0
        if s == 0:
            with jax.disable_jit():
                want = j_sharded(arr.numpy_dict(), params,
                                 j_make_mesh(jax.devices()[:4]), **FLAGS)
                for k in ("assigned", "kind", "job_ready", "rounds"):
                    np.testing.assert_array_equal(
                        getattr(res, k).numpy(),
                        np.asarray(getattr(want, k)), err_msg=k)
        _churn(arr, rng)
    # a D=1 arena solve calls no collective
    m1 = Mesh(["cpu"])
    sdc1 = ShardedDeviceCache(m1, chunk=64)
    bufs = sdc1.update(*arr.packed())
    for k in t_mesh.calls:
        t_mesh.calls[k] = 0
    r1 = solve_allocate_sharded_arena(*bufs, sdc1.params_device(params),
                                      m1, **FLAGS)
    assert sum(t_mesh.calls.values()) == 0
    fbuf, ibuf, layout = arr.packed()
    f2d, i2d = dc.update(fbuf, ibuf, layout)
    ref = solve_allocate_packed2d(f2d, i2d, layout, params, **FLAGS)
    assert torch.equal(r1.assigned, ref.assigned)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def _ssn(**kw):
    from types import SimpleNamespace

    base = dict(configurations=[], solver_options={}, solver_mode=None,
                sharded_byte_budget=0, device_cache=None,
                sharded_device_cache=None)
    base.update(kw)
    return SimpleNamespace(**base)


def _resolve(ssn):
    return pkg_mod("torch", "actions").AllocateAction().resolve_mode(ssn)


class _Sized:
    def __init__(self, n):
        self.n = n

    def full_upload_bytes(self):
        return self.n


def test_routing_defaults_pins_and_budget():
    from types import SimpleNamespace

    assert _resolve(_ssn()) == "solver"
    assert _resolve(_ssn(solver_mode="packed")) == "solver"
    assert _resolve(_ssn(solver_mode="sharded")) == "sharded"
    # a conf pin wins over the preference; a conf block without a mode
    # leaves the preference in charge
    pin = SimpleNamespace(name="allocate", arguments={"mode": "sequential"})
    assert _resolve(_ssn(configurations=[pin],
                         solver_mode="sharded")) == "sequential"
    free = SimpleNamespace(name="allocate", arguments={})
    assert _resolve(_ssn(configurations=[free],
                         solver_mode="sharded")) == "sharded"
    sharded = SimpleNamespace(name="allocate", arguments={"mode": "sharded"})
    assert _resolve(_ssn(configurations=[sharded])) == "sharded"
    # auto: no measurement yet, or no budget -> packed; a measured
    # footprint over the budget (either arena's) -> sharded
    assert _resolve(_ssn(solver_mode="auto",
                         sharded_byte_budget=100)) == "solver"
    assert _resolve(_ssn(solver_mode="auto",
                         device_cache=_Sized(1000))) == "solver"
    assert _resolve(_ssn(solver_mode="auto", sharded_byte_budget=100,
                         device_cache=_Sized(1000))) == "sharded"
    assert _resolve(_ssn(solver_mode="auto", sharded_byte_budget=100,
                         sharded_device_cache=_Sized(101))) == "sharded"
    assert _resolve(_ssn(solver_mode="auto", sharded_byte_budget=2000,
                         device_cache=_Sized(1000))) == "solver"
    assert _resolve(_ssn(solver_mode="sharded", solver_options={
        "force_host_allocate": True})) == "host"
    assert pkg_mod("torch", "framework").interface.UNPORTED_MODES == {}


def test_scheduler_wires_solver_mode_and_budget():
    Scheduler = pkg_mod("torch", "scheduler").Scheduler
    cache_mod = pkg_mod("torch", "cache")
    store = pkg_mod("torch", "client").ClusterStore()
    cache = cache_mod.SchedulerCache(store, device="cpu")
    assert cache.sharded_device_cache is None
    assert (cache.solver_mode, cache.sharded_byte_budget) == (None, 0)
    Scheduler(cache, solver_mode="auto", sharded_byte_budget=12345)
    assert cache.solver_mode == "auto"
    assert cache.sharded_byte_budget == 12345
    with pytest.raises(ValueError, match="solver_mode"):
        Scheduler(cache, solver_mode="mesh")


# ---------------------------------------------------------------------------
# whole Scheduler cycles
# ---------------------------------------------------------------------------

def _jax_cycle(cluster, *a, **k):
    with jax.disable_jit():
        return cluster.cycle(*a, **k)


def _sharded(cluster, mode: str = "sharded"):
    cluster.cache.sharded_device_cache = ShardedDeviceCache(D4)
    cluster.cache.solver_mode = mode
    return cluster


def _stuck_gang(cluster) -> None:
    """A gang whose pods fit no node: it stays pending, so a cycle with
    nothing else new solves an unchanged snapshot."""
    m, ann = cluster.models, cluster.ann_key
    from torch_helpers import build_pod, build_pod_group
    cluster.store.create("podgroups", build_pod_group(m, "stuck", "ns", 2,
                                                      "q0"))
    for i in range(2):
        cluster.store.create("pods", build_pod(
            m, ann, "ns", f"stuck-{i}", "", "Pending",
            {"cpu": "1000", "memory": "1Gi"}, "stuck"))


@pytest.mark.parametrize("conf", ["default", "hdrf"])
def test_sharded_cycles_match_packed_and_jax(conf):
    """A burst and two steady cycles (churn and a new wave): the sharded
    Scheduler binds what the port's packed one binds, cycle by cycle, and
    what the JAX package's binds in the burst and the first steady cycle
    (op by op every new flatten shape costs the JAX side seconds of
    compiles, so it stops there)."""
    kw = dict(n_nodes=12, zones=2) if conf == "default" else dict(
        n_nodes=6, conf=HDRF_CONF, hierarchy=EXAMPLE, node_cpu=8,
        node_mem_gi=32)
    s = _sharded(SeededCluster("torch", 41, **kw))
    p = SeededCluster("torch", 41, **kw)
    j = SeededCluster("jax", 41, **kw)
    total = 0
    for cycle in range(3):
        churn = 0.3 if cycle else 0.0
        n = 8 if cycle == 0 else 3          # a burst, then steady waves
        bs, bp = s.cycle(n, churn=churn), p.cycle(n, churn=churn)
        assert bs == bp, cycle
        if cycle < 2:
            assert bs == _jax_cycle(j, n, churn=churn), cycle
        total += len(bs)
        ts = s.sched.last_cycle_timing
        assert ts.get("arena_mode") == "sharded", ts
        assert len(ts["arena_shard_bytes"]) == 4
        assert not ts.get("host_fallback") and not ts.get("allocate_error")
        assert p.sched.last_cycle_timing.get("arena_mode") == "packed"
    assert total > 10
    # a cycle with nothing new: the pending stuck gang's snapshot repeats,
    # so the next cycle ships 0 bytes to every shard
    for c in (s, p):
        _stuck_gang(c)
        assert c.cycle(0) == [] and c.cycle(0) == []
    ts = s.sched.last_cycle_timing
    assert ts["arena_shard_bytes"] == [0.0] * 4
    assert ts["arena_bytes_shipped"] == 0.0
    # a sharded cluster's sessions never touch the packed arena
    assert s.cache.device_cache.sessions == 0
    assert s.cache.sharded_device_cache.sessions == 5
    ready = lambda c: sorted(  # noqa: E731
        (uid, job.ready()) for uid, job in c.cache.jobs.items()
        if job.pod_group is not None)
    assert ready(s) == ready(p)


def test_per_mode_arena_metrics():
    metrics = pkg_mod("torch", "metrics").metrics
    s = _sharded(SeededCluster("torch", 43, n_nodes=8))
    for _ in range(3):
        s.cycle(3)
    sdc = s.cache.sharded_device_cache
    assert s.cache.device_cache.sessions == 0 and sdc.sessions == 3
    assert metrics.arena_bytes_shipped_total.get(
        {"mode": "sharded"}) == sdc.total_shipped_bytes
    assert metrics.arena_hit_rate.get(
        {"mode": "sharded"}) == pytest.approx(sdc.arena_hit_rate)
    for d in range(4):
        assert metrics.arena_shard_bytes_shipped.get(
            {"shard": str(d)}) == sdc.last_shard_bytes[d]
    # a packed cluster's cycle afterwards exports the packed series; the
    # sharded series keep the sharded arena's totals
    p = SeededCluster("torch", 43, n_nodes=8)
    p.cycle(3)
    dc = p.cache.device_cache
    assert metrics.arena_bytes_shipped_total.get(
        {"mode": "packed"}) == dc.total_shipped_bytes
    assert metrics.arena_bytes_shipped_total.get(
        {"mode": "sharded"}) == sdc.total_shipped_bytes


def test_auto_mode_and_conf_pin_through_the_scheduler():
    """solver_mode auto with a 1-byte budget: the first session runs
    packed (nothing measured yet), every later one sharded; binds equal a
    packed twin's. A conf that pins allocate's mode wins over the
    preference."""
    a = _sharded(SeededCluster("torch", 47, n_nodes=8), mode="auto")
    a.cache.sharded_byte_budget = 1
    p = SeededCluster("torch", 47, n_nodes=8)
    modes = []
    for cycle in range(3):
        assert a.cycle(4, churn=0.2 if cycle else 0.0) == p.cycle(
            4, churn=0.2 if cycle else 0.0)
        modes.append(a.sched.last_cycle_timing.get("arena_mode"))
    assert modes == ["packed", "sharded", "sharded"]
    pinned = _sharded(SeededCluster(
        "torch", 47, n_nodes=8, conf='actions: "enqueue, allocate"\n'
        'configurations:\n- name: allocate\n  arguments:\n    mode: solver'))
    pinned.cycle(4)
    assert pinned.sched.last_cycle_timing.get("arena_mode") == "packed"


@pytest.mark.parametrize("where", ["cpu", "cuda"])
def test_failed_sharded_solve_invalidates_the_sharded_arena(where,
                                                            monkeypatch):
    """The sharded solve fails after its arena update landed: the sharded
    arena (not the packed one) is invalidated and the next sharded session
    re-ships it whole. On a CPU arena the session finishes on the host
    oracle, as the JAX package's does; on a CUDA one (the cache only
    reports a CUDA device here, which is all that decision reads) the
    failure is the action's error and nothing binds."""
    import volcano_tpu_torch.parallel as par

    c = _sharded(SeededCluster("torch", 53, n_nodes=8))
    assert c.cycle(3)
    if where == "cuda":
        c.cache.device = torch.device("cuda")
    real = par.solve_allocate_sharded_arena

    def boom(*a, **k):
        raise RuntimeError("injected failure after the arena update")

    monkeypatch.setattr(par, "solve_allocate_sharded_arena", boom)
    binds = c.cycle(3)
    t = c.sched.last_cycle_timing
    sdc = c.cache.sharded_device_cache
    assert sdc.invalidations == 1 and c.cache.device_cache.invalidations == 0
    if where == "cpu":
        assert t.get("host_fallback") == 1.0 and binds
    else:
        assert t.get("allocate_error") == 1.0 and binds == []
        assert "host_fallback" not in t
        c.cache.device = torch.device("cpu")
    monkeypatch.setattr(par, "solve_allocate_sharded_arena", real)
    c.cycle(2)
    t = c.sched.last_cycle_timing
    assert t.get("arena_full_ship") == 1.0 and t["arena_mode"] == "sharded"
    assert not t.get("host_fallback")


@pytest.mark.parametrize("failure", ["dispatch_fault", "breaker_open"])
def test_sharded_failure_on_a_cuda_mesh_is_not_absorbed(failure):
    """The cache's own device is the CPU; only the sharded arena's mesh
    names CUDA devices (it only reports them here: the failure comes
    before any solve would use it). Whether the failure comes out of the
    sharded dispatch or from an open breaker, it is the action's error:
    nothing binds through the host oracle and no host fallback is
    recorded, as for a CUDA cache."""
    faults = pkg_mod("torch", "resilience").faults
    c = _sharded(SeededCluster("torch", 59, n_nodes=8))
    assert c.cycle(3)
    sdc = c.cache.sharded_device_cache
    sdc.mesh = Mesh(["cuda"] * 4)
    breaker = c.cache.breaker
    try:
        if failure == "dispatch_fault":
            faults.arm_once("solver_dispatch")
        else:
            for _ in range(breaker.failure_threshold):
                breaker.record_failure()
            assert breaker.state_code == 2
        binds = c.cycle(3)
    finally:
        faults.reset()
    t = c.sched.last_cycle_timing
    assert binds == [] and t.get("allocate_error") == 1.0
    assert "host_fallback" not in t and breaker.fallback_cycles == 0
    if failure == "dispatch_fault":
        assert breaker._consecutive_failures == 1
        assert sdc.invalidations == 1
        assert c.cache.device_cache.invalidations == 0
