"""The port's node-axis sharded solvers (volcano_tpu_torch.parallel) against
the JAX package's, on the CPU.

- ``solve_allocate_sharded`` on a mesh of D ``cpu`` shards, D in {1, 2, 4,
  8}, over the problems of tests/test_parallel.py (TestShardedSolver's
  pack, gang revert, spread, queue caps and drf order, TestShardedHDRF's
  hierarchy) and a score tie across a shard boundary: ``assigned``,
  ``kind``, ``job_ready`` and ``rounds`` identical to the JAX package's
  ``solve_allocate_sharded`` on its 8-device CPU mesh, and ``assigned``,
  ``kind`` and ``job_ready`` identical to the port's single-device
  ``solve_allocate`` on the same arrays. The JAX solve runs op by op
  (``jax.disable_jit``: XLA's CPU jit contracts FMAs, see
  test_torch_solver.py); op by op its shard_map compiles every primitive
  on every call (~10 s a solve here), so it runs once per problem, at the
  D given in JAX_D, which covers every D; the port runs at every D. (The
  JAX package's own tests hold its sharded result equal across D.)
- Where whole-cluster float32 sums round (chip_smoke.py's 100k x 10k
  problem, scaled down, with requests that fill each node exactly), the
  sharded solve still decides what the single-device one decides.
- A D=1 solve calls no collective (the counterpart of
  tests/test_parallel.py's collective-free D=1 program); D>1 calls some.
- ``solve_evict_uniform_sharded`` on TestShardedEvict's problem at D=4
  and D=8 against the JAX package's (fed jnp arrays) and the port's D=1
  ``solve_evict_uniform``; ``shard_victims`` equal to the JAX package's;
  where a float32 running sum over every victim rounds (decimal memory
  units), both evict the minimal victim set.
- A mesh that repeats a device, and an indivisible node axis.

Tolerance: exact.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("jax")  # the JAX reference: absent on the card's machine

import torch

import jax
import jax.numpy as jnp

from volcano_tpu.api import JobInfo, NodeInfo, Resource, TaskInfo
from volcano_tpu.ops import flatten_snapshot
from volcano_tpu.ops.hdrf import build_hdrf
from volcano_tpu.parallel import make_mesh as j_make_mesh
from volcano_tpu.parallel import solve_allocate_sharded as j_sharded
from volcano_tpu_torch.ops import solve_allocate as t_solve
from volcano_tpu_torch.parallel import (
    Mesh, arena_mesh, make_mesh, mesh as t_mesh, solve_allocate_sharded,
)

from helpers import build_node, build_pod, build_pod_group
from test_solver import make_problem, params_dict

RESULT_KEYS = ("assigned", "kind", "job_ready", "rounds")


def _pack():
    jobs, nodes, tasks = make_problem(
        [(f"n{i:02d}", "8", "32Gi") for i in range(16)],
        [(f"j{k}", 4, [("1", "2Gi")] * 4) for k in range(8)])
    arr = flatten_snapshot(jobs, nodes, tasks)
    return arr, params_dict(arr, binpack_weight=1.0), dict(
        herd_mode="pack", score_families=("binpack",))


def _gang_revert():
    # j1 needs 40 cpus (min 20) of a 32-cpu cluster: reverted; j2 still fits
    jobs, nodes, tasks = make_problem(
        [(f"n{i:02d}", "2", "8Gi") for i in range(16)],
        [("j1", 20, [("2", "1Gi")] * 20), ("j2", 4, [("1", "1Gi")] * 4)])
    arr = flatten_snapshot(jobs, nodes, tasks)
    return arr, params_dict(arr, least_req_weight=1.0), dict(
        herd_mode="spread", score_families=("kube",))


def _spread():
    jobs, nodes, tasks = make_problem(
        [(f"n{i}", "8", "32Gi") for i in range(8)],
        [(f"j{k:02d}", 1, [("1", "1Gi")]) for k in range(16)])
    arr = flatten_snapshot(jobs, nodes, tasks)
    return arr, params_dict(arr, least_req_weight=1.0), dict(
        herd_mode="spread", score_families=("kube",))


def _two_jobs(queues=None):
    """Two 8-pod jobs over 8 one-cpu nodes (jA in q1, jB in q2)."""
    nodes = {f"n{i}": NodeInfo(build_node(
        f"n{i}", {"cpu": "1", "memory": "100Gi"})) for i in range(8)}
    jobs, tasks = {}, []
    for q, jname in (("q1", "jA"), ("q2", "jB")):
        pg = build_pod_group(jname, "ns", min_member=1,
                             queue=q if queues else "default")
        job = JobInfo(f"ns/{jname}", pg)
        for i in range(8):
            t = TaskInfo(build_pod("ns", f"{jname}-{i}", "", "Pending",
                                   {"cpu": "1", "memory": "1Gi"}, jname))
            job.add_task_info(t)
            tasks.append(t)
        jobs[job.uid] = job
    return flatten_snapshot(jobs, nodes, tasks, queues=queues)


def _queue_caps():
    arr = _two_jobs({"q1": SimpleNamespace(weight=3, capability=None),
                     "q2": SimpleNamespace(weight=1, capability=None)})
    arr.fill_queue_demand()
    return arr, params_dict(arr, least_req_weight=1.0), dict(
        herd_mode="spread", score_families=("kube",), use_queue_cap=True)


def _drf_order():
    arr = _two_jobs()
    arr.drf_total[:] = 0.0
    arr.drf_total[0] = 8000.0
    arr.drf_total[1] = 800 * (1 << 30)
    return arr, params_dict(arr, least_req_weight=1.0), dict(
        herd_mode="spread", score_families=("kube",), use_drf_order=True)


def _hdrf():
    jobs, nodes, tasks = make_problem(
        [(f"n{i}", "2", "2G") for i in range(8)],
        [("pg1", 1, [("1", "1G")] * 10), ("pg21", 1, [("1", "0")] * 10),
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
    return arr, params_dict(arr, least_req_weight=1.0), dict(
        herd_mode="spread", score_families=("kube",), use_drf_order=True,
        use_hdrf_order=True)


#: nodes 07 and 08, twice the size of the rest, tie for every task's best
#: score: the last node of one shard against the first of the next at every
#: D > 1 (the boundary at 8 is a shard boundary for D = 2, 4 and 8)
TIE_NODES = (7, 8)


def _boundary_tie():
    jobs, nodes, tasks = make_problem(
        [(f"n{i:02d}", "16" if i in TIE_NODES else "8",
          "64Gi" if i in TIE_NODES else "32Gi") for i in range(16)],
        [(f"j{k}", 4, [("1", "1Gi")] * 4) for k in range(6)])
    arr = flatten_snapshot(jobs, nodes, tasks)
    # no herd targeting: every choice is the merged personal argmax
    return arr, params_dict(arr, least_req_weight=1.0), dict(
        herd_mode="personal", score_families=("kube",))


PROBLEMS = {"pack": _pack, "gang_revert": _gang_revert, "spread": _spread,
            "queue_caps": _queue_caps, "drf_order": _drf_order,
            "hdrf": _hdrf, "boundary_tie": _boundary_tie}
#: the D at which the JAX reference solves each problem (every D covered)
JAX_D = {"pack": 1, "gang_revert": 2, "spread": 4, "queue_caps": 8,
         "drf_order": 2, "hdrf": 4, "boundary_tie": 8}
_JAX_RESULTS: dict = {}


def _jax_result(name):
    if name not in _JAX_RESULTS:
        arr, p, kw = PROBLEMS[name]()
        mesh = j_make_mesh(jax.devices()[:JAX_D[name]])
        with jax.disable_jit():
            r = j_sharded(arr.device_dict(), p, mesh, **kw)
            _JAX_RESULTS[name] = {k: np.asarray(getattr(r, k))
                                  for k in RESULT_KEYS}
    return _JAX_RESULTS[name]


def cpu_mesh(D: int) -> Mesh:
    return Mesh(["cpu"] * D)


def _reset_calls():
    for k in t_mesh.calls:
        t_mesh.calls[k] = 0


@pytest.mark.parametrize("D", (1, 2, 4, 8))
@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_sharded_solve_matches_jax_and_single_device(name, D):
    arr, p, kw = PROBLEMS[name]()
    d = arr.device_dict()
    assert arr.N % D == 0
    _reset_calls()
    res = solve_allocate_sharded(d, p, cpu_mesh(D), **kw)
    calls = sum(t_mesh.calls.values())
    assert (calls == 0) if D == 1 else (calls > 0), t_mesh.calls
    for k, want in _jax_result(name).items():
        got = getattr(res, k).numpy()
        assert got.dtype == want.dtype, (k, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=k)
    single = t_solve(d, p, device="cpu", fused="off", **kw)
    for k in ("assigned", "kind", "job_ready"):
        assert torch.equal(getattr(res, k), getattr(single, k)), k
    assert (res.assigned[:arr.T] >= 0).any()


def test_boundary_tie_goes_to_the_lower_shard():
    """The tied nodes straddle a shard boundary at every D > 1: the first
    round's choices all go to the lower one (the global first-index
    argmax), which takes 16 one-cpu pods; the rest go to the upper one."""
    arr, p, kw = _boundary_tie()
    names = [n.name for n in arr.nodes_list]
    lo, hi = (names.index(f"n{i:02d}") for i in TIE_NODES)
    assert (lo, hi) == TIE_NODES
    for D in (2, 4, 8):
        res = solve_allocate_sharded(arr.device_dict(), p, cpu_mesh(D), **kw)
        a = res.assigned[:arr.T].numpy()
        assert (a >= 0).all()
        assert (a == lo).sum() == 16 and (a == hi).sum() == 8, (D, a)


def test_d1_calls_no_collective_across_flags():
    """Every flag combination at D=1: no collective call, and the result
    equals the 4-shard solve."""
    for name in ("queue_caps", "hdrf", "boundary_tie"):
        arr, p, kw = PROBLEMS[name]()
        _reset_calls()
        r1 = solve_allocate_sharded(arr.device_dict(), p, cpu_mesh(1), **kw)
        assert sum(t_mesh.calls.values()) == 0, (name, t_mesh.calls)
        r4 = solve_allocate_sharded(arr.device_dict(), p, cpu_mesh(4), **kw)
        for k in RESULT_KEYS:
            assert torch.equal(getattr(r1, k), getattr(r4, k)), (name, k)


def test_indivisible_node_axis_and_fused_on_cpu_raise():
    arr, p, kw = _pack()
    with pytest.raises(ValueError, match="does not divide"):
        solve_allocate_sharded(arr.device_dict(), p, cpu_mesh(3), **kw)
    with pytest.raises(ValueError, match="CUDA"):
        solve_allocate_sharded(arr.device_dict(), p, cpu_mesh(2),
                               fused="on", **kw)


def test_mesh_and_arena_mesh():
    m = Mesh(["cpu", "cpu", "cpu"])
    assert m.size == 3 and m.distinct == (torch.device("cpu"),)
    assert m.devices == Mesh([torch.device("cpu")] * 3).devices
    # the largest power-of-two prefix, at most 8
    for n, d in ((1, 1), (2, 2), (3, 2), (6, 4), (8, 8), (12, 8)):
        assert arena_mesh(["cpu"] * n).size == d
    assert arena_mesh(["cpu"] * 8, max_devices=2).size == 2
    with pytest.raises(ValueError):
        Mesh([])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            arena_mesh()


def test_collectives_gather_sum_and_max():
    xs = [torch.tensor([1, 5], dtype=torch.int32),
          torch.tensor([3, 2], dtype=torch.int32)]
    _reset_calls()
    cpu = torch.device("cpu")
    assert t_mesh.all_gather(xs, cpu).tolist() == [[1, 5], [3, 2]]
    assert t_mesh.all_gather_tiled(xs, cpu).tolist() == [1, 5, 3, 2]
    s = t_mesh.psum(xs, cpu)
    assert s.tolist() == [4, 7] and s.dtype == torch.int32
    assert t_mesh.pmax(xs, cpu).tolist() == [3, 5]
    assert t_mesh.calls == {"all_gather": 1, "all_gather_tiled": 1,
                            "psum": 1, "pmax": 1}


# ---------------------------------------------------------------------------
# the sharded eviction solve
# ---------------------------------------------------------------------------

def _evict_problem(n_nodes: int = 16, n_victims: int = 160,
                   n_claim: int = 80, node_mem: str = "64Gi",
                   mem: str = "2Gi", claim_mem: str = "4Gi"):
    """tests/test_parallel.py TestShardedEvict's problem by default: 160
    one-cpu victims round-robin over 16 nodes of 16 cpu, a gang of 80
    two-cpu claimers."""
    from volcano_tpu.api import TaskStatus
    from volcano_tpu.api.types import POD_GROUP_ANNOTATION
    from volcano_tpu.models import Node, Pod, PodGroup, PodGroupSpec
    from volcano_tpu.ops.evict import pack_victim_arrays

    nodes = {}
    for i in range(n_nodes):
        rl = {"cpu": "16", "memory": node_mem, "pods": 110}
        nodes[f"n{i:02d}"] = NodeInfo(Node(name=f"n{i:02d}", allocatable=rl,
                                           capacity=dict(rl)))
    low = JobInfo("ns/low", PodGroup(name="low", namespace="ns",
                                     spec=PodGroupSpec(min_member=1)))
    victims = []
    for i in range(n_victims):
        pod = Pod(name=f"low-{i}", namespace="ns",
                  node_name=f"n{i % n_nodes:02d}", phase="Running",
                  annotations={POD_GROUP_ANNOTATION: "low"},
                  containers=[{"requests": {"cpu": "1", "memory": mem}}])
        t = TaskInfo(pod)
        t.status = TaskStatus.RUNNING
        low.add_task_info(t)
        nodes[f"n{i % n_nodes:02d}"].add_task(t)
        victims.append(t)
    hi = JobInfo("ns/hi", PodGroup(name="hi", namespace="ns",
                                   spec=PodGroupSpec(min_member=n_claim)))
    claimers = []
    for i in range(n_claim):
        pod = Pod(name=f"hi-{i}", namespace="ns",
                  annotations={POD_GROUP_ANNOTATION: "hi"},
                  containers=[{"requests": {"cpu": "2",
                                            "memory": claim_mem}}])
        t = TaskInfo(pod)
        hi.add_task_info(t)
        claimers.append(t)
    arr = flatten_snapshot({hi.uid: hi}, nodes, claimers)
    return (arr, params_dict(arr, least_req_weight=1.0),
            pack_victim_arrays(arr, victims, n_claim))


EVICT_KEYS = ("assigned", "evicted_by", "job_placed")


@pytest.mark.parametrize("D", (4, 8))
def test_sharded_evict_matches_jax_and_d1(D):
    from volcano_tpu.parallel import (
        solve_evict_uniform_sharded as j_evict_sharded,
    )
    from volcano_tpu_torch.ops.evict import solve_evict_uniform
    from volcano_tpu_torch.parallel import solve_evict_uniform_sharded

    arr, p, v = _evict_problem()
    d = arr.device_dict()
    _reset_calls()
    res = solve_evict_uniform_sharded(d, v, p, cpu_mesh(D))
    assert t_mesh.calls["all_gather_tiled"] > 0
    mesh = j_make_mesh(jax.devices()[:D])
    jd = {k: jnp.asarray(x) for k, x in d.items()}
    jv = {k: jnp.asarray(x) for k, x in v.items()}
    want = j_evict_sharded(jd, jv, p, mesh)
    for k in EVICT_KEYS:
        np.testing.assert_array_equal(getattr(res, k).numpy(),
                                      np.asarray(getattr(want, k)),
                                      err_msg=k)
    single = solve_evict_uniform(d, v, p, device="cpu")
    for k in EVICT_KEYS:
        assert torch.equal(getattr(res, k), getattr(single, k)), k
    assert int((res.assigned[:80] >= 0).sum()) == 80
    assert int((res.evicted_by >= 0).sum()) > 0
    # the D=1 mesh calls no collective and equals the single-device solve
    _reset_calls()
    r1 = solve_evict_uniform_sharded(d, v, p, cpu_mesh(1))
    assert sum(t_mesh.calls.values()) == 0
    for k in EVICT_KEYS:
        assert torch.equal(getattr(r1, k), getattr(single, k)), k


def test_sharded_evict_equals_d1_where_float32_sums_round():
    """Decimal memory units: 4096 victims of 1 cpu and 1G (10^9 bytes, not
    a multiple of float32's spacing once a sum passes 8.6e9) fill 256
    nodes of 16 cpu and 16G exactly, and 1024 claimers of 2 cpu and 2G
    each need exactly two victims. A running sum over every victim (~4e12
    bytes, ~1e12 on each of 4 shards) rounds a node's victim prefix by
    far more than the fit check's tolerance (~1e3 bytes at 2G), so a
    prefix carrying the rounding of the victims sorted before it evicts
    more than needed, and differently on each shard (either solve summing
    in float32 fails this). The sharded solve evicts what the D=1 solve
    evicts: the minimal 2048."""
    from volcano_tpu_torch.ops.evict import solve_evict_uniform
    from volcano_tpu_torch.parallel import solve_evict_uniform_sharded

    arr, p, v = _evict_problem(n_nodes=256, n_victims=4096, n_claim=1024,
                               node_mem="16G", mem="1G", claim_mem="2G")
    d = arr.device_dict()
    single = solve_evict_uniform(d, v, p, device="cpu")
    assert int((single.assigned[:1024] >= 0).sum()) == 1024
    assert int((single.evicted_by >= 0).sum()) == 2048
    res = solve_evict_uniform_sharded(d, v, p, cpu_mesh(4))
    for k in EVICT_KEYS:
        assert torch.equal(getattr(res, k), getattr(single, k)), k


@pytest.mark.parametrize("D", (1, 2, 4, 8))
def test_shard_victims_equal_to_jax(D):
    from volcano_tpu.parallel.sharded_evict import shard_victims as j_sv
    from volcano_tpu_torch.parallel.sharded_evict import shard_victims

    arr, _, v = _evict_problem()
    # drop some victims so the shards hold unequal counts and padding
    v = dict(v)
    v["v_valid"] = v["v_valid"] & (np.arange(v["v_valid"].size) % 7 != 3)
    got, perm = shard_victims(v, arr.N, D)
    want, jperm = j_sv(v, arr.N, D)
    np.testing.assert_array_equal(perm, jperm)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_sharded_equals_single_where_float32_sums_round():
    """chip_smoke.py's 100k x 10k problem at 4000 x 1000 with every pod
    asking 1000 cpu and every node holding 12 of them (fractional memory
    left over): whole-cluster running sums of the requests leave
    float32's exact range, and each node's last pod fits with nothing to
    spare, so a prefix carrying the rounding of the other nodes' tasks, or
    a cluster total summed per shard, would decide differently. The
    sharded solve decides exactly what the single-device solve decides."""
    import chip_smoke

    arr = chip_smoke.synth_snapshot(4000, 1000)
    arr.task_init_req[:, 0] = arr.task_req[:, 0] = 1e6
    arr.node_idle[:, 0] = arr.node_alloc[:, 0] = 12e6
    arr.node_idle[:, 1] += np.float32(0.5 * 2**20)
    arr.node_alloc[:, 1] = arr.node_idle[:, 1]
    arr.queue_request[:, 0] = np.bincount(
        arr.job_queue[arr.task_job], minlength=3) * np.float32(1e6)
    d = arr.numpy_dict()
    p = {"binpack_weight": np.float32(1.0),
         "binpack_res_weights": np.ones(arr.R, np.float32),
         "least_req_weight": np.float32(0.0),
         "most_req_weight": np.float32(0.0),
         "balanced_weight": np.float32(0.0),
         "node_static": np.zeros(arr.N, np.float32)}
    kw = dict(herd_mode="pack", score_families=("binpack",),
              use_queue_cap=True)
    single = t_solve(d, p, device="cpu", fused="off", **kw)
    res = solve_allocate_sharded(d, p, cpu_mesh(4), **kw)
    for k in ("assigned", "kind", "job_ready"):
        assert torch.equal(getattr(res, k), getattr(single, k)), k
    assert int((res.assigned >= 0).sum()) > 3000
