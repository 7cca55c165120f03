"""The port's round solver (volcano_tpu_torch.ops.solver.solve_allocate on
the CPU, dense path) against the JAX package's solve_allocate(fused="off")
on the same arrays.

Reference arithmetic: the JAX solver runs op by op (``jax.disable_jit``).
Under jit, XLA's CPU compiler contracts multiply-adds of the score into
FMAs, which moves scores by an ulp and flips argmax ties between equal
nodes, after which the two trajectories part (see tests/test_solver.py's
fused-parity note). Op by op, every float operation rounds on its own, as
in PyTorch, so the rule here is exact: identical assigned, kind,
job_ready, rounds and compact — which implies the issue's weaker rule
(same fates and placed set, differences only between score-tied nodes).
"""

from __future__ import annotations

import numpy as np
import pytest

pytest.importorskip("jax")  # the JAX reference: absent on the card's machine

import torch

import jax

from volcano_tpu.ops import solve_allocate as j_solve
from volcano_tpu_torch.ops import decode_compact, flatten_snapshot
from volcano_tpu_torch.ops import solve_allocate as t_solve
from volcano_tpu_torch.ops import solver as ts

from test_torch_flatten import build_cluster, cluster_spec, flatten


def params_dict(arr, binpack=0.0, least=0.0, most=0.0, balanced=0.0):
    return {
        "binpack_weight": np.float32(binpack),
        "binpack_res_weights": np.ones(arr.R, np.float32),
        "least_req_weight": np.float32(least),
        "most_req_weight": np.float32(most),
        "balanced_weight": np.float32(balanced),
        "node_static": np.zeros(arr.N, np.float32),
    }


def jax_reference(d, p, **kw):
    with jax.disable_jit():
        r = j_solve(d, p, fused="off", **kw)
        return {k: np.asarray(getattr(r, k)) for k in
                ("assigned", "kind", "job_ready", "rounds", "compact")}


def assert_identical(ref, res):
    for k, v in ref.items():
        got = getattr(res, k).cpu().numpy()
        assert got.dtype == v.dtype, (k, got.dtype, v.dtype)
        np.testing.assert_array_equal(got, v, err_msg=k)


def assert_solution_valid(d, res):
    """Capacity and gang invariants of one solution, from the host
    arrays: no node debited past its idle (beyond the fit threshold); no
    node past its pod limit; every job with an allocation is ready."""
    assigned = res.assigned.numpy()
    kind = res.kind.numpy()
    tj = d["task_job"]
    alloc = (assigned >= 0) & (kind == 0)
    N = d["node_idle"].shape[0]
    debit = np.zeros_like(d["node_idle"], dtype=np.float64)
    np.add.at(debit, assigned[alloc], d["task_req"][alloc])
    slack = d["thresholds"] + 5e-7 * np.abs(d["node_idle"])
    assert (debit <= d["node_idle"] + slack).all()
    pods = np.bincount(assigned[alloc], minlength=N)
    assert (d["node_npods"] + pods <= d["node_max_pods"]).all()
    jobs_with_alloc = np.unique(tj[alloc])
    assert res.job_ready.numpy()[jobs_with_alloc].all()


def run_both(arr, p, **kw):
    d = arr.device_dict()                 # the JAX flatten's numpy arrays
    ref = jax_reference(d, p, **kw)
    res = t_solve(d, p, device="cpu", fused="off", **kw)
    assert_identical(ref, res)
    assert_solution_valid(d, res)
    return d, res


@pytest.mark.parametrize("seed,spec_kw,p_kw,kw", [
    (1, {}, {"binpack": 1.0},
     {"herd_mode": "pack", "score_families": ("binpack",)}),
    (2, {"gpu": True}, {"least": 1.0, "balanced": 1.0},
     {"herd_mode": "spread", "score_families": ("kube",)}),
    (3, {"n_nodes": 16}, {"binpack": 1.0, "least": 1.0},
     {"herd_mode": "pack", "score_families": ("binpack", "kube"),
      "use_queue_cap": True}),
    (4, {"n_jobs": 8}, {"binpack": 1.0, "most": 1.0},
     {"herd_mode": "none", "score_families": ("binpack", "kube"),
      "per_node_cap": 1}),
])
def test_matches_jax(seed, spec_kw, p_kw, kw):
    """pack/binpack, spread/kube with a gpu dim, queue caps, and the
    dense per_node_cap fidelity mode."""
    arr = flatten("jax", cluster_spec(seed, **spec_kw))
    _, res = run_both(arr, params_dict(arr, **p_kw), **kw)
    assert (res.assigned.numpy() >= 0).any()


def test_drf_order_with_prerank_matches_jax():
    arr = flatten("jax", cluster_spec(21, n_nodes=16, n_jobs=14))
    nj = len(arr.jobs_list)
    arr.drf_total = (arr.node_alloc
                     * arr.node_valid[:, None]).sum(axis=0).astype(
        np.float32)
    # priority tiers ahead of drf: three classes, ties broken by shares
    arr.job_drf_prerank[:nj] = np.arange(nj) % 3
    arr.job_drf_allocated[:nj, 0] = 1000.0 * (np.arange(nj) % 4)
    p = params_dict(arr, binpack=1.0)
    run_both(arr, p, herd_mode="pack", score_families=("binpack",),
             use_queue_cap=True, use_drf_order=True)


def contended_gangs(pkg: str, seed: int = 7):
    """BASELINE config 2's size, 500 pods over 50 nodes: 50 gangs of 10
    (min_member 10) asking ~3x the cluster, so gangs revert."""
    from test_torch_flatten import PACKAGES
    api, models, _ = PACKAGES[pkg]
    rng = np.random.default_rng(seed)
    nodes = {}
    for i in range(50):
        rl = {"cpu": "4", "memory": "8Gi", "pods": 110}
        nodes[f"n{i}"] = api.NodeInfo(models.Node(
            name=f"n{i}", allocatable=rl, capacity=dict(rl)))
    jobs, tasks = {}, []
    for k in range(50):
        pg = models.PodGroup(name=f"j{k}", namespace="c",
                             spec=models.PodGroupSpec(min_member=10))
        job = api.JobInfo(f"c/j{k}", pg)
        for i in range(10):
            req = {"cpu": str(int(rng.integers(1, 3))),
                   "memory": f"{int(rng.integers(1, 3))}Gi"}
            pod = models.Pod(name=f"j{k}-{i}", namespace="c",
                             annotations={api.POD_GROUP_ANNOTATION: f"j{k}"},
                             containers=[{"requests": req}])
            t = api.TaskInfo(pod)
            job.add_task_info(t)
            tasks.append(t)
        jobs[job.uid] = job
    return jobs, nodes, tasks


def test_contended_gang_revert_matches_jax():
    from volcano_tpu.ops import flatten_snapshot as j_flatten
    arr = j_flatten(*contended_gangs("jax"))
    assert (arr.T, arr.N) == (512, 56)
    d, res = run_both(arr, params_dict(arr, binpack=1.0),
                      herd_mode="pack", score_families=("binpack",))
    ready = res.job_ready.numpy()[:50]
    assert 0 < ready.sum() < 50           # contended: some gangs lose
    placed = res.assigned.numpy()[:500] >= 0
    assert placed.sum() == 10 * ready.sum()  # all-or-nothing


def test_whole_slice_flatten_solve_decode():
    """The slice end to end in each package from the same seeded cluster:
    flatten -> solve -> decode of the compact result, with constraints,
    releasing pods (the pipeline phase) and queue caps."""
    spec = cluster_spec(47, n_nodes=12, n_jobs=10, tasks_per_job=5)
    jobs, nodes, tasks, queues = build_cluster("torch", spec)
    arr_t = flatten_snapshot(jobs, nodes, tasks, queues=queues)
    arr_t.fill_queue_demand()
    arr_j = flatten("jax", spec)
    p = params_dict(arr_t, binpack=1.0, least=1.0)
    kw = dict(herd_mode="spread", score_families=("binpack", "kube"),
              use_queue_cap=True)
    ref = jax_reference(arr_j.device_dict(), p, **kw)
    res = t_solve(arr_t.device_dict(device="cpu"), p, device="cpu", **kw)
    assert_identical(ref, res)
    assigned, kind = decode_compact(res.compact)
    np.testing.assert_array_equal(assigned, res.assigned.numpy())
    np.testing.assert_array_equal(kind, res.kind.numpy())
    # the bindings by name agree too
    names_t = {arr_t.tasks_list[i].name: arr_t.nodes_list[n].name
               for i, n in enumerate(assigned[:len(arr_t.tasks_list)])
               if n >= 0}
    names_j = {arr_j.tasks_list[i].name: arr_j.nodes_list[n].name
               for i, n in enumerate(ref["assigned"][:len(arr_j.tasks_list)])
               if n >= 0}
    assert names_t == names_j and names_t
    assert (kind == 1).any()    # something pipelined onto releasing room


def test_auto_on_cpu_takes_the_dense_path():
    arr = flatten("torch", cluster_spec(8, n_nodes=12, n_jobs=6))
    p = params_dict(arr, binpack=1.0)
    d = arr.device_dict(device="cpu")
    a = t_solve(d, p, device="cpu", fused="auto", score_families=("binpack",))
    b = t_solve(d, p, device="cpu", fused="off", score_families=("binpack",))
    for k in ("assigned", "kind", "job_ready", "compact"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k


@pytest.mark.parametrize("herd", ["pack", "spread"])
@pytest.mark.parametrize("families", [("binpack",), ("kube",),
                                      ("binpack", "kube")])
def test_fused_round_equals_dense_round(herd, families):
    """One admission round through the fused choice (its plain version on
    the CPU) equals the dense round exactly, from a mid-solve state: some
    tasks placed, nodes part-debited, some pods-full nodes."""
    from volcano_tpu_torch.ops import fused_choice as fc
    from volcano_tpu_torch.ops.convert import to_torch_params

    arr = flatten("torch", cluster_spec(9, n_nodes=20, n_jobs=10,
                                        tasks_per_job=5))
    a = arr.device_dict(device="cpu")
    p = to_torch_params(params_dict(arr, binpack=1.0, least=1.0,
                                    balanced=1.0), "cpu")
    rng = np.random.default_rng(len(families))
    T, N = arr.T, arr.N
    idle = a["node_idle"] * torch.from_numpy(
        rng.integers(1, 5, (N, 1)).astype(np.float32) / 4)
    npods = a["node_npods"] + torch.from_numpy(
        rng.integers(0, 2, N).astype(np.int32))
    max_pods = torch.where(torch.arange(N) % 7 == 0, npods,
                           a["node_max_pods"])
    a["node_max_pods"] = max_pods
    eligible = a["task_valid"] & torch.from_numpy(rng.random(T) < 0.8)
    sig = a["sig_masks"][a["task_sig"].long()] & a["node_valid"][None, :]
    used_now = a["node_used"] + (a["node_idle"] - idle)
    rank = a["task_rank"]
    thr, sm = a["thresholds"], a["scalar_dim_mask"]
    sig_i8, inv_alloc, pars, nstat = fc.fused_setup(
        sig, a["node_alloc"], p, arr.R)
    fused = ts._admission_round_fused(
        eligible, a, idle, used_now, sig, sig_i8, inv_alloc, nstat, pars,
        a["task_req"], rank, thr, sm, npods, herd, families)
    feas = ts.fits_matrix(a["task_init_req"], idle, thr, sm) & sig
    score = ts.score_matrix(a["task_init_req"], idle, used_now,
                            a["node_alloc"], p, families)
    dense = ts._admission_round(
        eligible, feas, score, a["task_init_req"], a["task_req"], idle,
        rank, thr, sm, npods, max_pods, 0, herd)
    assert (dense[0] >= 0).any()
    for f, d in zip(fused, dense):
        assert torch.equal(f, d)


def headline_problem(pkg: str):
    """bench.py headline()'s problem: 1000 gangs x 10 pods (cpu 1+k%3,
    memory (1+k%4)Gi) over 2000 nodes of 32 cpu / 128Gi / 110 pods, three
    queues weighted 1:2:3."""
    from types import SimpleNamespace

    from test_torch_flatten import PACKAGES
    api, models, ops = PACKAGES[pkg]
    nodes = {}
    for i in range(2000):
        rl = {"cpu": "32", "memory": "128Gi", "pods": 110}
        nodes[f"n{i}"] = api.NodeInfo(models.Node(
            name=f"n{i}", allocatable=rl, capacity=dict(rl)))
    jobs, tasks = {}, []
    for k in range(1000):
        pg = models.PodGroup(name=f"j{k}", namespace="bench",
                             spec=models.PodGroupSpec(min_member=10,
                                                      queue=f"q{k % 3}"))
        job = api.JobInfo(f"bench/j{k}", pg)
        for i in range(10):
            pod = models.Pod(
                name=f"j{k}-{i}", namespace="bench",
                annotations={api.POD_GROUP_ANNOTATION: f"j{k}"},
                containers=[{"requests": {"cpu": str(1 + k % 3),
                                          "memory": f"{1 + k % 4}Gi"}}])
            t = api.TaskInfo(pod)
            job.add_task_info(t)
            tasks.append(t)
        jobs[job.uid] = job
    queues = {f"q{i}": SimpleNamespace(weight=i + 1, capability=None)
              for i in range(3)}
    arr = ops.flatten_snapshot(jobs, nodes, tasks, queues=queues)
    arr.fill_queue_demand()
    return arr


@pytest.mark.slow
def test_headline_shape_matches_jax():
    """The full headline (T=10240, N=2048): each package flattens its own
    copy of the problem and solves it; identical results."""
    arr_j, arr_t = headline_problem("jax"), headline_problem("torch")
    assert (arr_t.T, arr_t.N, arr_t.R, arr_t.J) == (10240, 2048, 2, 1024)
    p = params_dict(arr_t, binpack=1.0)
    kw = dict(herd_mode="pack", score_families=("binpack",),
              use_queue_cap=True)
    ref = jax_reference(arr_j.device_dict(), p, **kw)
    res = t_solve(arr_t.device_dict(device="cpu"), p, device="cpu", **kw)
    assert_identical(ref, res)
    assert int((res.assigned >= 0).sum()) == 10000
