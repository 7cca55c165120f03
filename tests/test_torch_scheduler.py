"""The port's scheduling cycle (volcano_tpu_torch.scheduler.Scheduler.
run_once over the event-sourced flatten, the device-resident arena and
the Statement replay) against the JAX package's Scheduler.

- The same seeded cluster, built from each package's own models, through
  both Schedulers over churned cycles under the default conf and a
  binpack conf: FakeBinder binds identical, bind for bind, every cycle.
  The JAX Scheduler runs op by op (``jax.disable_jit``): XLA's CPU jit
  contracts FMAs, see test_torch_solver.py. The port runs on the CPU
  (``device="cpu"``, the dense path).
- ``faults.arm_once("solver_dispatch")`` gives the same host-fallback
  cycle in both packages, and the port's arena re-ships after it. On a
  CUDA arena the port has no host fallback: the failure is the allocate
  action's error.
- compile_cache_dir and prewarm (ROADMAP A10) wire the precompile
  pipeline; an unported action or mode would raise NotImplementedError
  naming its ROADMAP item (stand-ins
  registered as unported: every action and mode of the JAX package is
  ported), at conf loading or before any dispatch, never reaching the
  host fallback.
- Without a GPU, a cache (and so a Scheduler) built without
  ``device="cpu"`` raises.

Tests marked ``cuda`` run the cycle on the card (they skip without a
GPU): the async pinned readback against a blocking copy, a small
churned cluster card vs host, and small versions of chip_smoke.py's
hdrf, evict and sequential phases (every kernel launch of an hdrf burst,
the placeability prefilter's included, held against the plain version;
each eviction solve against the same solve on CPU tensors; the
sequential cycle's binds against the host's). This module imports JAX only inside the
tests that need it, so on a GPU host without JAX they run with
``python -m pytest --noconftest -m cuda tests/test_torch_scheduler.py``.
"""

from __future__ import annotations

import pytest
import torch

from torch_helpers import BINPACK_CONF, SeededCluster, pkg_mod


def _jax_cycle(cluster, *a, **k):
    import jax
    with jax.disable_jit():
        return cluster.cycle(*a, **k)


@pytest.mark.parametrize("conf", [None, BINPACK_CONF],
                         ids=["default_conf", "binpack_conf"])
def test_binds_match_jax_bind_for_bind(conf):
    t = SeededCluster("torch", 17, n_nodes=10, conf=conf, zones=2)
    j = SeededCluster("jax", 17, n_nodes=10, conf=conf, zones=2)
    total = 0
    for cycle in range(3):
        churn = 0.3 if cycle else 0.0
        bt = t.cycle(5, churn=churn)
        bj = _jax_cycle(j, 5, churn=churn)
        assert bt == bj, cycle
        total += len(bt)
        tt, jt = t.sched.last_cycle_timing, j.sched.last_cycle_timing
        for k in ("flatten_mode", "order_mode", "arena_full_ship",
                  "delta_chunks"):
            assert tt.get(k) == jt.get(k), (cycle, k)
        # the same chunks cross; a delta ships exactly its dirty chunks
        # (2052 bytes each), where the JAX package pads to its fused slots
        if tt["arena_full_ship"]:
            assert tt["arena_bytes_shipped"] == jt["arena_bytes_shipped"]
        else:
            assert tt["arena_bytes_shipped"] == tt["delta_chunks"] * 2052
            assert tt["arena_bytes_shipped"] <= jt["arena_bytes_shipped"]
        assert not tt.get("host_fallback")
        assert t.cache.breaker.state_code == 0
    assert total > 20
    # ready jobs and pod-group phases agree after the last cycle
    ready = lambda c: sorted(  # noqa: E731
        (uid, job.ready(), str(job.pod_group.status.phase))
        for uid, job in c.cache.jobs.items() if job.pod_group is not None)
    assert ready(t) == ready(j)


def test_solver_dispatch_fault_matches_jax_host_fallback():
    t = SeededCluster("torch", 23, n_nodes=8)
    j = SeededCluster("jax", 23, n_nodes=8)
    t_faults = pkg_mod("torch", "resilience").faults
    j_faults = pkg_mod("jax", "resilience").faults
    assert t_faults is not j_faults
    assert t.cycle(4) == _jax_cycle(j, 4)
    try:
        t_faults.arm_once("solver_dispatch")
        j_faults.arm_once("solver_dispatch")
        bt = t.cycle(4, churn=0.2)
        bj = _jax_cycle(j, 4, churn=0.2)
    finally:
        t_faults.reset()
        j_faults.reset()
    assert bt == bj and bt
    for c in (t, j):
        timing = c.sched.last_cycle_timing
        assert timing.get("host_fallback") == 1.0
        assert c.cache.breaker._consecutive_failures == 1
        assert c.cache.device_cache.invalidations == 1
    # the next cycle is back on the device path and re-ships the arena
    bt = t.cycle(3, churn=0.2)
    assert bt == _jax_cycle(j, 3, churn=0.2)
    for c in (t, j):
        timing = c.sched.last_cycle_timing
        assert not timing.get("host_fallback")
        assert timing.get("arena_full_ship") == 1.0


@pytest.mark.parametrize("failure", ["dispatch_fault", "breaker_open"])
def test_device_failure_on_a_cuda_arena_is_not_absorbed(failure):
    """On a CUDA arena a device failure is the allocate action's error:
    nothing binds through the host oracle and no host fallback is
    recorded, whether the failure comes out of the dispatch or from an
    open breaker. The cache runs on the CPU here and only reports a CUDA
    device, which is all that decision reads; a CPU arena still falls back
    (test_solver_dispatch_fault_matches_jax_host_fallback)."""
    c = SeededCluster("torch", 31, n_nodes=6)
    faults = pkg_mod("torch", "resilience").faults
    assert c.cycle(3)
    c.cache.device = torch.device("cuda", 0)
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
    timing = c.sched.last_cycle_timing
    assert binds == []
    assert timing.get("allocate_error") == 1.0
    assert "host_fallback" not in timing
    assert breaker.fallback_cycles == 0
    if failure == "dispatch_fault":
        assert breaker._consecutive_failures == 1
        assert c.cache.device_cache.invalidations == 1


#: confs naming an action, a mode or an option, with the ROADMAP item that
#: ports it, or None once ported (preempt and reclaim with A6, the
#: sequential mode and the drf hierarchy with A2, the sharded mode with A7,
#: reschedule, elect and reserve with A9)
UNPORTED_CONFS = {
    "preempt": ('actions: "enqueue, preempt, allocate"', None),
    "reclaim": ('actions: "enqueue, reclaim, allocate, backfill"', None),
    "reschedule": ('actions: "allocate, reschedule"', None),
    "elect": ('actions: "enqueue, elect, allocate, backfill"', None),
    "reserve": ('actions: "enqueue, elect, reserve, allocate"', None),
    "sequential": ('actions: "allocate"\nconfigurations:\n- name: allocate\n'
                   '  arguments:\n    mode: sequential', None),
    "sharded": ('actions: "allocate"\nconfigurations:\n- name: allocate\n'
                '  arguments:\n    mode: sharded', None),
    "hdrf": ('actions: "allocate"\ntiers:\n- plugins:\n  - name: drf\n'
             '    arguments:\n      drf.enableHierarchy: true', None),
}


def _cpu_cache():
    cache_mod = pkg_mod("torch", "cache")
    store = pkg_mod("torch", "client").ClusterStore()
    return cache_mod.SchedulerCache(store, device="cpu")


@pytest.mark.parametrize("name", sorted(UNPORTED_CONFS))
def test_unported_conf_raises_at_loading(name):
    """An unported conf raises at loading, naming its item; a ported one
    loads with every action it names."""
    Scheduler = pkg_mod("torch", "scheduler").Scheduler
    text, item = UNPORTED_CONFS[name]
    if item is None:
        sched = Scheduler(_cpu_cache(), scheduler_conf=text)
        names = [a.name() for a in sched.actions]
        assert names and (name in names
                          or name in ("sequential", "sharded", "hdrf"))
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        Scheduler(_cpu_cache(), scheduler_conf=text)


@pytest.mark.parametrize("kw,item", [
    ({"compile_cache_dir": "cc"}, "A10"), ({"prewarm": True}, "A10"),
])
def test_unported_scheduler_options_raise(kw, item, tmp_path, monkeypatch):
    """The options ROADMAP ``item`` ported no longer raise: they wire the
    precompile pipeline (ops.precompile) as the JAX Scheduler does."""
    from volcano_tpu_torch.ops import _build, precompile
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.setattr(precompile, "_configured_dir", None)
    kw = {k: str(tmp_path / v) if k == "compile_cache_dir" else v
          for k, v in kw.items()}
    cache = _cpu_cache()
    sched = pkg_mod("torch", "scheduler").Scheduler(cache, **kw)
    assert item == "A10"
    if "prewarm" in kw:
        assert isinstance(cache.prewarmer, precompile.BucketPrewarmer)
    else:
        assert sched.compile_cache_dir == kw["compile_cache_dir"]
        assert _build.BUILD_DIR == tmp_path / "cc"


def test_unported_mode_never_reaches_the_host_fallback(tmp_path,
                                                      monkeypatch):
    """A mode that reaches an action anyway (a session opened with its own
    configurations) raises before the breaker's scope: nothing binds, no
    device failure is counted, no host fallback runs. Every mode of the
    JAX package is ported, so a stand-in mode is registered as unported."""
    fw = pkg_mod("torch", "framework")
    conf_mod = pkg_mod("torch", "conf")
    monkeypatch.setitem(fw.interface.UNPORTED_MODES, "stand-in", "A9")
    c = SeededCluster("torch", 29, n_nodes=6)
    c.submit_gangs(3)
    for action in ("allocate", "preempt", "reclaim"):
        ssn = fw.open_session(c.cache, c.sched.tiers, [
            conf_mod.Configuration(name=action,
                                   arguments={"mode": "stand-in"})])
        try:
            with pytest.raises(NotImplementedError, match="ROADMAP A9"):
                fw.get_action(action).execute(ssn)
            assert "host_fallback" not in ssn.solver_options.get(
                "timing", {})
        finally:
            fw.close_session(ssn)
    assert c.cache.binder.binds == {}
    assert c.cache.evictor.evicts == []
    assert c.cache.breaker._consecutive_failures == 0
    assert c.cache.breaker.fallback_cycles == 0
    # a hot reload to an unported conf raises out of the cycle: every
    # action of the JAX package is ported, so a stand-in action is
    # registered as unported
    sched_mod = pkg_mod("torch", "scheduler")
    monkeypatch.setitem(sched_mod.UNPORTED_ACTIONS, "stand-in", "A9")
    path = tmp_path / "conf.yaml"
    path.write_text('actions: "allocate, stand-in"')
    c.sched.conf_path = str(path)
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        c.sched.run_once()
    assert c.cache.binder.binds == {}


def test_cache_and_scheduler_need_a_gpu_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    cache_mod = pkg_mod("torch", "cache")
    store = pkg_mod("torch", "client").ClusterStore()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cache_mod.SchedulerCache(store)
    # nothing was written before the raise
    assert store.try_get("queues", "default") is None
    cache = cache_mod.SchedulerCache(store, device="cpu")
    assert cache.device.type == "cpu"
    assert cache.device_cache.device.type == "cpu"
    pkg_mod("torch", "scheduler").Scheduler(cache)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_async_readback_matches_blocking_copy_on_card(cuda_device):
    import chip_smoke
    chip_smoke.readback_stress(cuda_device)
    c = chip_smoke.StoreCluster(cuda_device, 40, 20, tasks_per_job=4,
                                cpu="8", mem="32Gi")
    with chip_smoke.ReadbackProbe() as probe:
        row = c.run_cycle()
    assert probe.check() > 0
    assert row["binds"] == 80 and row["launches"] > 0
    c.check("card readback cycle", gangs=list(c.gangs))


@pytest.mark.cuda
def test_small_cycle_card_equals_host(cuda_device):
    import chip_smoke
    out = chip_smoke.small_cycle_pair(cuda_device)
    assert out["identical_to_host"] and out["binds"] > 0


@pytest.mark.cuda
def test_hdrf_cycles_on_card(cuda_device):
    import chip_smoke
    out = chip_smoke.phase_hdrf(cuda_device, dict(
        n_nodes=60, n_jobs=30, wave_jobs=2, steady_cycles=1))
    burst = out["rows"][0]
    assert burst["binds"] > 0 and burst["prefilter_launches"] > 0


@pytest.mark.cuda
def test_preempt_and_reclaim_on_card(cuda_device):
    import chip_smoke
    rows = chip_smoke.phase_evict(cuda_device, dict(
        n_nodes=10, low_pods=100, gang=50, a_jobs=16, b_jobs=5))
    assert [r["part"] for r in rows] == ["preempt", "reclaim"]
    assert all(r["evictions"] > 0 and r["next_cycle_claimer_binds"] > 0
               for r in rows)


@pytest.mark.cuda
def test_sequential_cycle_card_equals_host(cuda_device):
    import chip_smoke
    out = chip_smoke.phase_sequential(cuda_device, n_nodes=10, n_jobs=10)
    assert out["identical_to_host"] and out["binds"] > 0


@pytest.mark.cuda
def test_sharded_cycles_equal_packed_on_card(cuda_device):
    """The sharded Scheduler on a mesh of 4 virtual shards of the card
    binds what the packed one binds, cycle by cycle (every launch of the
    burst held against the plain version, the second quiet cycle shipping
    0 bytes to every shard)."""
    import chip_smoke
    from volcano_tpu_torch.parallel import make_mesh
    out = chip_smoke.sharded_cycles(
        cuda_device, make_mesh([cuda_device] * 4),
        dict(chip_smoke.SHARDED, n_nodes=200, n_jobs=100, steady_cycles=2))
    assert out["audit"]["launches_checked"] > 0
    assert out["rows"][0]["binds"] == 1000


@pytest.mark.cuda
def test_sharded_solve_and_evict_equal_packed_on_card(cuda_device):
    """The sharded solve over the sharded arena on 4 virtual shards of the
    card gives the packed solve's decisions exactly (digest), and the
    sharded eviction solve the D=1 solve's."""
    import chip_smoke
    from volcano_tpu_torch.parallel import make_mesh
    mesh = make_mesh([cuda_device] * 4)
    out = chip_smoke.sharded_scale(cuda_device, mesh, dict(
        chip_smoke.SHARDED, scale_tasks=4000, scale_nodes=1000))
    assert out["digest_identical"] and out["sharded_launches"] > 0
    saved = dict(chip_smoke.EVICT)
    try:
        chip_smoke.EVICT.update(n_nodes=20, low_pods=200, gang=100)
        assert chip_smoke.sharded_evict(cuda_device, mesh)["equal_to_d1"]
    finally:
        chip_smoke.EVICT.update(saved)
