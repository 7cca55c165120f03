"""Sharded solver tests through the port (volcano_tpu_torch.parallel):
tests/test_parallel.py's TestShardedD1ZeroCost, TestShardedScale,
TestShardedFused, TestShardedArenaEntry and TestRealMultiDeviceSubprocess
on meshes of CPU shards (``Mesh(["cpu"] * D)``), with the reference's own
expectations. Its TestShardedSolver, TestShardedEvict and TestShardedHDRF
are twinned, problem for problem and held to the JAX package, in
tests/test_torch_sharded.py.

- D=1 calls no collective (``parallel.mesh.calls``, the counterpart of a
  collective-free jaxpr) and decides what D=8 decides; the D=1 problem is
  also held to the JAX package's single-device solve (op by op,
  ``jax.disable_jit``: exact).
- The arena entry (``ShardedDeviceCache`` + ``solve_allocate_sharded_arena``)
  decides what the plain sharded solve and the packed arena decide, ships
  a delta only to the shard that owns it and nothing on an unchanged
  snapshot. The reference's own arena-entry tests fail on jax 0.9
  (ROADMAP Queue C); these hold the port.
- The fused kernel needs CUDA shards: ``fused="on"`` on a CPU mesh raises,
  and the ``auto`` route (the dense path on the CPU) is held here; the
  fused cases themselves (``cuda`` marker) run on the card, on 8 virtual
  shards of it.
- The reference's forced 8-device subprocess needs distinct devices,
  which one card is not: its counterpart runs over every card of a host
  with 2 or more (``cuda`` marker) and skips below that.

Tolerance: exact.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from volcano_tpu_torch.api import JobInfo, NodeInfo, TaskInfo
from volcano_tpu_torch.ops import flatten_snapshot
from volcano_tpu_torch.ops.arrays import ScoreParams
from volcano_tpu_torch.parallel import (
    Mesh, mesh as t_mesh, solve_allocate_sharded,
    solve_allocate_sharded_arena,
)

from torch_helpers import Builders

_B = Builders("torch")
RESULT_KEYS = ("assigned", "kind", "job_ready")


def make_problem(node_specs, job_specs):
    """tests/test_solver.py's make_problem over the port's models:
    node_specs [(name, cpu, mem)], job_specs [(name, min_member,
    [(cpu, mem)])] -> (jobs, nodes, tasks in order)."""
    nodes = {name: NodeInfo(_B.build_node(name, {"cpu": cpu,
                                                 "memory": mem}))
             for name, cpu, mem in node_specs}
    jobs, tasks = {}, []
    for jname, min_member, reqs in job_specs:
        job = JobInfo(f"ns/{jname}",
                      _B.build_pod_group(jname, "ns", min_member=min_member))
        for i, (cpu, mem) in enumerate(reqs):
            t = TaskInfo(_B.build_pod("ns", f"{jname}-{i}", "", "Pending",
                                      {"cpu": cpu, "memory": mem}, jname))
            job.add_task_info(t)
            tasks.append(t)
        jobs[job.uid] = job
    return jobs, nodes, tasks


def params_dict(arr, **kw):
    sp = ScoreParams(**kw).resolved(arr.R, arr.N)
    return {"binpack_weight": np.float32(sp.binpack_weight),
            "binpack_res_weights": sp.binpack_res_weights,
            "least_req_weight": np.float32(sp.least_req_weight),
            "most_req_weight": np.float32(sp.most_req_weight),
            "balanced_weight": np.float32(sp.balanced_weight),
            "node_static": sp.node_static}


def tensors(d: dict, device="cpu") -> dict:
    return {k: torch.as_tensor(np.asarray(v)).to(device)
            for k, v in d.items()}


def cpu_mesh(D: int) -> Mesh:
    return Mesh(["cpu"] * D)


def reset_calls() -> None:
    for k in t_mesh.calls:
        t_mesh.calls[k] = 0


def assert_same(a, b, keys=RESULT_KEYS) -> None:
    for k in keys:
        assert torch.equal(getattr(a, k).cpu(), getattr(b, k).cpu()), k


def _pack_problem():
    jobs, nodes, tasks = make_problem(
        [(f"n{i}", "8", "32Gi") for i in range(16)],
        [(f"j{k}", 4, [("1", "2Gi")] * 4) for k in range(8)])
    return flatten_snapshot(jobs, nodes, tasks)


PACK = dict(herd_mode="pack", score_families=("binpack",))


class TestShardedD1ZeroCost:
    """A 1-shard mesh calls no collective (the constant factor every
    multi-card deployment inherits) and decides what the 8-shard mesh
    decides."""

    def test_no_collectives_and_same_result(self):
        jobs, nodes, tasks = make_problem(
            [(f"n{i}", "8", "32Gi") for i in range(16)],
            [(f"j{k}", 4, [("1", "2Gi")] * 4) for k in range(8)])
        queues = {"default": SimpleNamespace(weight=1, capability=None)}
        arr = flatten_snapshot(jobs, nodes, tasks, queues=queues)
        arr.fill_queue_demand()
        p = params_dict(arr, binpack_weight=1.0)
        d = arr.device_dict("cpu")
        kw = dict(PACK, use_queue_cap=True)
        reset_calls()
        r1 = solve_allocate_sharded(d, tensors(p), cpu_mesh(1), **kw)
        assert sum(t_mesh.calls.values()) == 0, t_mesh.calls
        r8 = solve_allocate_sharded(d, tensors(p), cpu_mesh(8), **kw)
        assert sum(t_mesh.calls.values()) > 0
        assert_same(r1, r8)
        # the JAX package's single-device solve on the same arrays
        jax = pytest.importorskip("jax")
        import jax.numpy as jnp
        from volcano_tpu.ops import solve_allocate as j_solve
        with jax.disable_jit():
            want = j_solve({k: jnp.asarray(v)
                            for k, v in arr.numpy_dict().items()},
                           {k: jnp.asarray(v) for k, v in p.items()}, **kw)
        for k in RESULT_KEYS:
            np.testing.assert_array_equal(getattr(r1, k).numpy(),
                                          np.asarray(getattr(want, k)))

    def test_packed_arena_matches_d1(self):
        """The resident packed arena (the port's one arena path) feeds the
        single-device solve the D=1 sharded solve's decisions."""
        from volcano_tpu_torch.ops import PackedDeviceCache
        from volcano_tpu_torch.ops.solver import (
            decode_compact, solve_allocate_packed2d,
        )

        jobs, nodes, tasks = make_problem(
            [(f"n{i}", "8", "32Gi") for i in range(8)],
            [(f"j{k}", 2, [("1", "2Gi")] * 2) for k in range(6)])
        arr = flatten_snapshot(jobs, nodes, tasks)
        p = tensors(params_dict(arr, binpack_weight=1.0))
        ref = solve_allocate_sharded(arr.device_dict("cpu"), p,
                                     cpu_mesh(1), **PACK)
        fbuf, ibuf, layout = arr.packed()
        dc = PackedDeviceCache(device="cpu")
        f2d, i2d = dc.update(fbuf, ibuf, layout)
        res = solve_allocate_packed2d(f2d, i2d, layout, p, **PACK)
        assigned, kind = decode_compact(res.compact)
        np.testing.assert_array_equal(assigned, ref.assigned.numpy())
        np.testing.assert_array_equal(kind, ref.kind.numpy())
        assert torch.equal(res.job_ready, ref.job_ready)

    def test_evict_d1_no_collectives(self):
        from volcano_tpu_torch.api import TaskStatus
        from volcano_tpu_torch.api.types import POD_GROUP_ANNOTATION
        from volcano_tpu_torch.models import Pod, PodGroup, PodGroupSpec
        from volcano_tpu_torch.ops.evict import (
            pack_victim_arrays, solve_evict_uniform,
        )
        from volcano_tpu_torch.parallel import solve_evict_uniform_sharded

        jobs, nodes, tasks = make_problem(
            [(f"n{i}", "8", "32Gi") for i in range(4)], [])
        low = JobInfo("ns/low", PodGroup(name="low", namespace="ns",
                                         spec=PodGroupSpec(min_member=1)))
        victims = []
        for i in range(8):
            pod = Pod(name=f"low-{i}", namespace="ns",
                      node_name=f"n{i % 4}", phase="Running",
                      annotations={POD_GROUP_ANNOTATION: "low"},
                      containers=[{"requests": {"cpu": "1",
                                                "memory": "2Gi"}}])
            t = TaskInfo(pod)
            t.status = TaskStatus.RUNNING
            low.add_task_info(t)
            nodes[f"n{i % 4}"].add_task(t)
            victims.append(t)
        hi = JobInfo("ns/hi", PodGroup(name="hi", namespace="ns",
                                       spec=PodGroupSpec(min_member=4)))
        claimers = []
        for i in range(4):
            pod = Pod(name=f"hi-{i}", namespace="ns",
                      annotations={POD_GROUP_ANNOTATION: "hi"},
                      containers=[{"requests": {"cpu": "2",
                                                "memory": "4Gi"}}])
            t = TaskInfo(pod)
            hi.add_task_info(t)
            claimers.append(t)
        arr = flatten_snapshot({hi.uid: hi}, nodes, claimers)
        params = tensors(params_dict(arr, least_req_weight=1.0))
        varrays = tensors(pack_victim_arrays(arr, victims, 4))
        reset_calls()
        r1 = solve_evict_uniform_sharded(arr.device_dict("cpu"), varrays,
                                         params, cpu_mesh(1))
        assert sum(t_mesh.calls.values()) == 0, t_mesh.calls
        ref = solve_evict_uniform(arr.device_dict("cpu"), varrays, params,
                                  device="cpu")
        assert torch.equal(r1.assigned, ref.assigned)
        assert torch.equal(r1.evicted_by, ref.evicted_by)
        assert int((r1.assigned >= 0).sum()) == 4


class TestShardedScale:
    """The sharded solver at the shapes that motivate sharding: 10k tasks
    x 2k nodes on 8 CPU shards (256-node shards), placements and per-node
    capacity."""

    def test_10k_by_2k(self):
        rng = np.random.default_rng(7)
        T_, N_ = 10240, 2048
        R = 2
        a = {
            "task_init_req": np.zeros((T_, R), np.float32),
            "task_job": np.zeros(T_, np.int32),
            "task_rank": np.arange(T_, dtype=np.int32),
            "task_sig": np.zeros(T_, np.int32),
            "task_counts_ready": np.ones(T_, bool),
            "task_valid": np.ones(T_, bool),
        }
        n_jobs = 1024
        per = T_ // n_jobs
        for j in range(n_jobs):
            req = (float(rng.integers(1, 4)) * 1000.0,
                   float(rng.integers(1, 5)) * (1 << 30))
            a["task_init_req"][j * per:(j + 1) * per] = req
            a["task_job"][j * per:(j + 1) * per] = j
        a["task_req"] = a["task_init_req"].copy()
        a["job_min"] = np.full(n_jobs, per, np.int32)
        a["job_ready_base"] = np.zeros(n_jobs, np.int32)
        a["job_queue"] = (np.arange(n_jobs) % 3).astype(np.int32)
        a["job_valid"] = np.ones(n_jobs, bool)
        idle = np.zeros((N_, R), np.float32)
        idle[:, 0] = 32000.0
        idle[:, 1] = 128.0 * (1 << 30)
        a["node_idle"] = idle
        a["node_extra_future"] = np.zeros((N_, R), np.float32)
        a["node_used"] = np.zeros((N_, R), np.float32)
        a["node_alloc"] = idle.copy()
        a["node_npods"] = np.zeros(N_, np.int32)
        a["node_max_pods"] = np.full(N_, 110, np.int32)
        a["node_valid"] = np.ones(N_, bool)
        a["sig_masks"] = np.ones((1, N_), bool)
        a["thresholds"] = np.array([10.0, 1.0], np.float32)
        a["scalar_dim_mask"] = np.zeros(R, bool)
        a["queue_weight"] = np.array([1.0, 2.0, 3.0], np.float32)
        a["queue_capability"] = np.full((3, R), np.inf, np.float32)
        a["queue_allocated"] = np.zeros((3, R), np.float32)
        qreq = np.zeros((3, R), np.float32)
        for j in range(n_jobs):
            qreq[a["job_queue"][j]] += \
                a["task_init_req"][a["task_job"] == j].sum(axis=0)
        a["queue_request"] = qreq
        params = {"binpack_weight": np.float32(1.0),
                  "binpack_res_weights": np.ones(R, np.float32),
                  "least_req_weight": np.float32(0.0),
                  "most_req_weight": np.float32(0.0),
                  "balanced_weight": np.float32(0.0),
                  "node_static": np.zeros(N_, np.float32)}
        res = solve_allocate_sharded(tensors(a), tensors(params),
                                     cpu_mesh(8), herd_mode="pack",
                                     score_families=("binpack",),
                                     use_queue_cap=True)
        assigned = res.assigned.numpy()
        kind = res.kind.numpy()
        # cluster is unsaturated (20k avg-2cpu tasks vs 64k cpu): all place
        assert int((assigned >= 0).sum()) == T_
        used = np.zeros((N_, R), np.float32)
        np.add.at(used, assigned[(assigned >= 0) & (kind == 0)],
                  a["task_req"][(assigned >= 0) & (kind == 0)])
        assert (used <= a["node_idle"] + a["thresholds"][None, :]).all()
        assert bool(res.job_ready.all())


def _fused_problem():
    # shard-clean: 32 nodes -> 4 per shard on an 8-shard mesh
    jobs, nodes, tasks = make_problem(
        [(f"n{i}", str(4 + i % 3), f"{8 + i % 5}Gi") for i in range(32)],
        [(f"j{k}", 3, [(str(1 + k % 2), f"{1 + k % 3}Gi")] * 3)
         for k in range(12)])
    return flatten_snapshot(jobs, nodes, tasks)


def _hdrf_problem():
    from volcano_tpu_torch.api import Resource
    from volcano_tpu_torch.ops.hdrf import build_hdrf

    jobs, nodes, tasks = make_problem(
        [(f"n{i}", "2", "2G") for i in range(8)],
        [("pg1", 1, [("1", "1G")] * 10),
         ("pg21", 1, [("1", "0")] * 10),
         ("pg22", 1, [("0", "1G")] * 10)])
    for i, job in enumerate(jobs.values()):
        job.queue = ["q-sci", "q-dev", "q-prod"][i]
    queues = {
        "q-sci": SimpleNamespace(weight=1, capability=None,
                                 hierarchy="root/sci", weights="100/50"),
        "q-dev": SimpleNamespace(weight=1, capability=None,
                                 hierarchy="root/eng/dev",
                                 weights="100/50/50"),
        "q-prod": SimpleNamespace(weight=1, capability=None,
                                  hierarchy="root/eng/prod",
                                  weights="100/50/50"),
    }
    arr = flatten_snapshot(jobs, nodes, tasks, queues=queues)
    arr.drf_total = (arr.node_alloc * arr.node_valid[:, None]).sum(
        axis=0).astype(np.float32)
    build_hdrf(arr, queues, {}, Resource())
    return arr


HDRF_KW = dict(herd_mode="spread", score_families=("kube",),
               use_drf_order=True, use_hdrf_order=True)


def _fused_cases():
    out = []
    for herd, families in (("pack", ("binpack",)), ("spread", ("kube",))):
        arr = _fused_problem()
        p = params_dict(
            arr, binpack_weight=1.0 if "binpack" in families else 0.0,
            least_req_weight=1.0 if "kube" in families else 0.0)
        out.append((arr, p, dict(herd_mode=herd, score_families=families)))
    arr = _hdrf_problem()
    out.append((arr, params_dict(arr, least_req_weight=1.0), HDRF_KW))
    return out


def _assert_fused_equal(arr, r_off, r_on):
    """kind and job_ready identical, the same tasks placed, each job
    placing as many, and the same per-node occupancy (a different node
    only between equal scores)."""
    assert torch.equal(r_off.kind.cpu(), r_on.kind.cpu())
    assert torch.equal(r_off.job_ready.cpu(), r_on.job_ready.cpu())
    a_off, a_on = r_off.assigned.cpu().numpy(), r_on.assigned.cpu().numpy()
    assert ((a_off >= 0) == (a_on >= 0)).all()
    c_off = np.bincount(a_off[a_off >= 0], minlength=arr.N)
    c_on = np.bincount(a_on[a_on >= 0], minlength=arr.N)
    assert (c_off == c_on).all(), (c_off, c_on)
    tj = np.asarray(arr.task_job)
    for j in np.unique(tj):
        assert ((a_off >= 0) & (tj == j)).sum() \
            == ((a_on >= 0) & (tj == j)).sum()


class TestShardedFused:
    """The fused choice kernel per shard: each shard runs the kernel on
    its [T, N/D] block, and the sharded solve with fused="on" decides what
    the dense sharded path decides (and both what the single-device solve
    decides)."""

    @pytest.mark.parametrize("case", range(3))
    def test_auto_route_on_cpu_shards_is_the_dense_path(self, case):
        arr, p, kw = _fused_cases()[case]
        d, pt = arr.device_dict("cpu"), tensors(p)
        r_auto = solve_allocate_sharded(d, pt, cpu_mesh(8), **kw)
        r_off = solve_allocate_sharded(d, pt, cpu_mesh(8), fused="off",
                                       **kw)
        assert_same(r_auto, r_off, RESULT_KEYS + ("rounds",))
        from volcano_tpu_torch.ops import solve_allocate
        single = solve_allocate(d, pt, device="cpu", **kw)
        assert_same(r_auto, single)
        with pytest.raises(ValueError, match="CUDA"):
            solve_allocate_sharded(d, pt, cpu_mesh(8), fused="on", **kw)

    @pytest.mark.cuda
    @pytest.mark.parametrize("case", range(3))
    def test_fused_matches_dense_on_card_shards(self, case):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device")
        from volcano_tpu_torch.ops import fused_choice as fc
        arr, p, kw = _fused_cases()[case]
        mesh = Mesh([torch.device("cuda", 0)] * 8)
        d = arr.device_dict("cuda")
        pt = tensors(p, "cuda")
        r_off = solve_allocate_sharded(d, pt, mesh, fused="off", **kw)
        before = fc.fused_choice.launches
        r_on = solve_allocate_sharded(d, pt, mesh, fused="on", **kw)
        assert fc.fused_choice.launches > before
        _assert_fused_equal(arr, r_off, r_on)
        # the dense path on the card decides what it decides on the CPU
        cpu = solve_allocate_sharded(arr.device_dict("cpu"), tensors(p),
                                     cpu_mesh(8), fused="off", **kw)
        assert_same(r_off, cpu, RESULT_KEYS + ("rounds",))


class TestShardedArenaEntry:
    """solve_allocate_sharded_arena over ShardedDeviceCache buffers: the
    steady-state entry decides what the plain sharded solve and the packed
    arena decide, calls no collective at D=1, and ships per-shard deltas
    only to the shard owning the dirty rows."""

    def _problem(self):
        arr = _pack_problem()
        return arr, tensors(params_dict(arr, binpack_weight=1.0))

    def test_matches_sharded_and_packed(self):
        from volcano_tpu_torch.ops import PackedDeviceCache, ShardedDeviceCache
        from volcano_tpu_torch.ops.solver import (
            decode_compact, solve_allocate_packed2d,
        )

        arr, p = self._problem()
        mesh = cpu_mesh(8)
        fbuf, ibuf, layout = arr.packed()
        sdc = ShardedDeviceCache(mesh)
        bufs = sdc.update(fbuf, ibuf, layout)
        r = solve_allocate_sharded_arena(*bufs, sdc.params_device(p), mesh,
                                         **PACK)
        ref = solve_allocate_sharded(arr.device_dict("cpu"), p, mesh, **PACK)
        assert_same(r, ref)
        dc = PackedDeviceCache(device="cpu")
        f2d, i2d = dc.update(fbuf, ibuf, layout)
        pk = solve_allocate_packed2d(f2d, i2d, layout, p, **PACK)
        a_pk, k_pk = decode_compact(pk.compact)
        np.testing.assert_array_equal(r.assigned.numpy(), a_pk)
        np.testing.assert_array_equal(r.kind.numpy(), k_pk)

    def test_per_shard_delta_locality_and_zero_dirty(self):
        from volcano_tpu_torch.ops import ShardedDeviceCache

        arr, p = self._problem()
        mesh = cpu_mesh(8)
        fbuf, ibuf, layout = arr.packed()
        sdc = ShardedDeviceCache(mesh)
        sdc.update(fbuf, ibuf, layout)
        assert sdc.last_full_ship and all(sdc.last_shard_bytes)
        # zero-dirty: an unchanged snapshot ships 0 bytes to EVERY shard
        # and solves off the resident arena
        bufs = sdc.update(fbuf, ibuf, layout)
        assert sdc.last_shipped_bytes == 0
        assert sdc.last_shard_bytes == [0] * sdc.D
        assert not sdc.last_full_ship
        r = solve_allocate_sharded_arena(*bufs, sdc.params_device(p), mesh,
                                         **PACK)
        assert int((r.assigned >= 0).sum()) > 0
        # dirty exactly one node row: only the owning shard receives bytes
        nl = arr.N // sdc.D
        victim_shard = 5
        arr.node_idle[victim_shard * nl, 0] -= 1.0
        fbuf2, ibuf2, _ = arr.packed()
        sdc.update(fbuf2, ibuf2, layout)
        got = [d for d, b in enumerate(sdc.last_shard_bytes) if b]
        assert got == [victim_shard], sdc.last_shard_bytes

    def test_invalidate_keeps_params_then_full_reships(self):
        from volcano_tpu_torch.ops import ShardedDeviceCache

        arr, p = self._problem()
        fbuf, ibuf, layout = arr.packed()
        sdc = ShardedDeviceCache(cpu_mesh(8))
        sdc.update(fbuf, ibuf, layout)
        pinned = sdc.params_device(p)
        assert sdc.params_repins == 1
        sdc.invalidate()
        assert sdc._dev_rep_f is None and sdc._dev_node_f is None
        assert sdc._params_blob is not None
        sdc.update(fbuf, ibuf, layout)
        assert sdc.full_ships == 2 and sdc.last_full_ship
        # params re-validated in place, not re-uploaded
        assert sdc.params_device(p) is pinned
        assert sdc.params_repins == 1

    def test_split_layout_rejects_indivisible_node_axis(self):
        from volcano_tpu_torch.ops import split_packed_layout

        layout = (("node_idle", "f", 0, 20, (10, 2)),)
        with pytest.raises(ValueError):
            split_packed_layout(layout, 8)

    def test_arena_entry_d1_no_collectives(self):
        from volcano_tpu_torch.ops import ShardedDeviceCache

        arr, p = self._problem()
        fbuf, ibuf, layout = arr.packed()
        mesh1 = cpu_mesh(1)
        sdc = ShardedDeviceCache(mesh1)
        bufs = sdc.update(fbuf, ibuf, layout)
        reset_calls()
        r = solve_allocate_sharded_arena(*bufs, sdc.params_device(p), mesh1,
                                         **PACK)
        assert sum(t_mesh.calls.values()) == 0, t_mesh.calls
        ref = solve_allocate_sharded(arr.device_dict("cpu"), p, cpu_mesh(8),
                                     **PACK)
        assert_same(r, ref)


class TestRealMultiDevice:
    """The reference's forced 8-device subprocess, on distinct cards: the
    mesh over every card of the host calls collectives, and its decisions
    equal the one-card run's. Needs 2 or more cards: one card, or a CPU,
    gives no distinct devices."""

    @pytest.mark.cuda
    def test_distinct_cards_collectives_and_decisions(self):
        if torch.cuda.device_count() < 2:
            pytest.skip("needs 2 or more CUDA devices")
        n = torch.cuda.device_count()
        D = 1 << (n.bit_length() - 1)  # the mesh's power-of-two prefix
        mesh = Mesh([torch.device("cuda", i) for i in range(D)])
        arr = _pack_problem()
        p = params_dict(arr, binpack_weight=1.0)
        reset_calls()
        rD = solve_allocate_sharded(arr.device_dict("cuda:0"),
                                    tensors(p, "cuda:0"), mesh, **PACK)
        assert sum(t_mesh.calls.values()) > 0
        r1 = solve_allocate_sharded(arr.device_dict("cuda:0"),
                                    tensors(p, "cuda:0"),
                                    Mesh([torch.device("cuda", 0)]), **PACK)
        assert_same(rD, r1)
