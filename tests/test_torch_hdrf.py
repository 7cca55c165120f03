"""The port's hierarchical DRF (volcano_tpu_torch.ops.hdrf and the hdrf
path of ops.solver.solve_allocate) against the JAX package's, on the CPU.

- ``build_hdrf``: the same queue tree arrays from the same flatten, on
  uniform and ragged hierarchies.
- ``hdrf_rank_state`` / ``hdrf_state``: the same ranks and the same capped
  eligibility on the corpora of tests/test_fairshare.py (TestHDRF's
  rescaling tree, TestHDRFRaggedParity's ragged trees), from seeded
  allocations, live job resources and eligibility.
- the dense ``solve_allocate(use_drf_order=True, use_hdrf_order=True)``:
  identical ``assigned``, ``kind``, ``job_ready``, ``rounds``.
- whole Scheduler cycles under ``drf.enableHierarchy``: the same binds,
  bind for bind; and the burst of chip_smoke.py's ``hdrf`` phase at its
  full scale (5000 pods over 1000 nodes), against the jitted JAX
  Scheduler.

The JAX reference runs op by op (``jax.disable_jit``): XLA's CPU jit
contracts FMAs, see test_torch_solver.py. Tolerance: exact.
"""

from __future__ import annotations

import numpy as np
import pytest

pytest.importorskip("jax")  # the JAX reference: absent on the card's machine

import torch

import jax
import jax.numpy as jnp

from volcano_tpu.ops import hdrf as j_hdrf
from volcano_tpu.ops import solve_allocate as j_solve
from volcano_tpu_torch.ops import hdrf as t_hdrf
from volcano_tpu_torch.ops import solve_allocate as t_solve

from test_torch_solver import assert_identical, params_dict
from torch_helpers import (
    EXAMPLE, RAGGED, RESCALING, SeededCluster, build_node, build_pod,
    build_pod_group, build_queue, hdrf_flatten, hierarchy_annotations,
    pkg_mod,
)

def _jnp(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


HDRF_KEYS = ("hdrf_parent", "hdrf_weight", "hdrf_depth", "hdrf_is_leaf",
             "hdrf_leaf_req", "hdrf_job_leaf", "hdrf_ancestors",
             "hdrf_total_allocated")


@pytest.mark.parametrize("tree", [RESCALING, RAGGED, EXAMPLE],
                         ids=["rescaling", "ragged", "example"])
def test_build_hdrf_arrays_match_jax(tree):
    aj = hdrf_flatten("jax", 3, tree, n_queues=7)
    at = hdrf_flatten("torch", 3, tree, n_queues=7)
    dj, dt = aj.device_dict(), at.numpy_dict()
    assert sorted(dj) == sorted(dt)
    for k in HDRF_KEYS:
        assert dj[k].dtype == dt[k].dtype, k
        np.testing.assert_array_equal(dj[k], dt[k], err_msg=k)
    # the tree reaches the depth of the deepest path (leaves included)
    depth = max(len(p.split("/")) for p, _ in tree)
    assert dt["hdrf_ancestors"].shape[1] == depth


def _state_inputs(arr, seed: int):
    rng = np.random.default_rng(seed)
    J, R, T = arr.J, arr.R, arr.T
    jobres = np.zeros((J, R), np.float32)
    jobres[:len(arr.jobs_list), 0] = 1000.0 * rng.integers(0, 3,
                                                           len(arr.jobs_list))
    eligible = arr.task_valid & (rng.random(T) < 0.8)
    return jobres, eligible


@pytest.mark.parametrize("tree,seed", [(RESCALING, 0), (RAGGED, 1),
                                       (RAGGED, 2), (EXAMPLE, 3)])
def test_rank_and_cap_match_jax(tree, seed):
    """hdrf_rank_state's ranks at zero and at live job resources, and
    hdrf_state's (rank, capped eligibility) pair."""
    arr = hdrf_flatten("torch", seed, tree, n_queues=len(tree),
                       n_nodes=8, n_jobs=10, tasks_per_job=3)
    d = arr.numpy_dict()
    jobres, eligible = _state_inputs(arr, seed)
    dt = arr.device_dict(device="cpu")
    zero = np.zeros_like(jobres)
    with jax.disable_jit():
        dj = _jnp(d)
        rank_j = j_hdrf.hdrf_rank_state(dj, None)
        want_r = [np.asarray(rank_j(jnp.asarray(x))) for x in (zero, jobres)]
        rc = j_hdrf.hdrf_state(dj, None)
        want_rc = [np.asarray(x) for x in rc(jnp.asarray(eligible),
                                             jnp.asarray(jobres))]
    rank_t = t_hdrf.hdrf_rank_state(dt, None)
    for x, want in zip((zero, jobres), want_r):
        got = rank_t(torch.from_numpy(x)).numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    got_rc = t_hdrf.hdrf_state(dt, None)(torch.from_numpy(eligible),
                                         torch.from_numpy(jobres))
    for g, w in zip(got_rc, want_rc):
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)
    # the cap binds somewhere (the test is not vacuous)
    assert want_rc[1].sum() < eligible.sum()


@pytest.mark.parametrize("tree,seed,kw", [
    (EXAMPLE, 4, {"herd_mode": "pack", "score_families": ("binpack",)}),
    (RAGGED, 5, {"herd_mode": "spread", "score_families": ("kube",)}),
], ids=["example_pack", "ragged_spread"])
def test_dense_solve_with_hdrf_matches_jax(tree, seed, kw):
    arr = hdrf_flatten("torch", seed, tree, n_queues=len(tree), n_nodes=8,
                       n_jobs=10, tasks_per_job=3)
    d = arr.numpy_dict()
    p = params_dict(arr, binpack=1.0, least=1.0)
    kw = dict(kw, use_drf_order=True, use_hdrf_order=True)
    with jax.disable_jit():
        r = j_solve(_jnp(d), _jnp(p), fused="off", **kw)
        ref = {k: np.asarray(getattr(r, k)) for k in
               ("assigned", "kind", "job_ready", "rounds", "compact")}
    res = t_solve(d, p, device="cpu", fused="off", **kw)
    assert_identical(ref, res)
    assert (res.assigned.numpy() >= 0).any()


HDRF_CONF = """
actions: "enqueue, allocate, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
- plugins:
  - name: drf
    arguments:
      drf.enableHierarchy: true
  - name: predicates
  - name: nodeorder
"""


def test_hdrf_cycles_match_jax_bind_for_bind(monkeypatch):
    """The default conf with drf.enableHierarchy (proportion left out: the
    conf loader rejects it beside the hierarchy) over example/
    hierarchical-jobs.yaml's queue tree, 8-cpu nodes: the same binds
    cycle by cycle, through the port's hdrf solve (counted)."""
    calls = []
    real = t_hdrf.hdrf_state

    def counting(a, rank):
        calls.append(a["hdrf_parent"].shape[0])
        return real(a, rank)

    monkeypatch.setattr(t_hdrf, "hdrf_state", counting)
    kw = dict(n_nodes=6, conf=HDRF_CONF, hierarchy=EXAMPLE, node_cpu=8,
              node_mem_gi=32)
    t = SeededCluster("torch", 5, **kw)
    j = SeededCluster("jax", 5, **kw)
    total = 0
    for cycle in range(2):
        churn = 0.3 if cycle else 0.0
        bt = t.cycle(4, churn=churn)
        with jax.disable_jit():
            bj = j.cycle(4, churn=churn)
        assert bt == bj, cycle
        total += len(bt)
        timing = t.sched.last_cycle_timing
        assert not timing.get("host_fallback")
        assert not timing.get("allocate_error")
    assert total > 10
    assert len(calls) == 2


def hdrf_burst_cluster(pkg: str, n_nodes: int = 1000, n_jobs: int = 500):
    """chip_smoke.py's ``hdrf`` cluster through package ``pkg``'s Scheduler:
    nodes of 8 cpu / 32Gi / 8 GPUs, example/hierarchical-jobs.yaml's leaf
    queues, gangs of 10 pods round-robin over them (gang k: cpu
    1 + (k // 3) % 3, memory 1 + k % 4 Gi, 1 GPU a pod when k % 5 == 0)."""
    m, cache_mod = pkg_mod(pkg, "models"), pkg_mod(pkg, "cache")
    ann = pkg_mod(pkg, "api").POD_GROUP_ANNOTATION
    store = pkg_mod(pkg, "client").ClusterStore()
    kw = {"device": "cpu"} if pkg == "torch" else {}
    cache = cache_mod.SchedulerCache(store, **kw)
    cache.binder = cache_mod.FakeBinder()
    cache.evictor = cache_mod.FakeEvictor()
    cache.run()
    names = ["root-eng-prod", "root-eng-dev", "root-sci"]
    for name, (path, weights) in zip(names, EXAMPLE):
        store.apply("queues", build_queue(
            m, name, annotations=hierarchy_annotations(path, weights)))
    for i in range(n_nodes):
        store.create("nodes", build_node(m, f"n{i}", {
            "cpu": "8", "memory": "32Gi", "nvidia.com/gpu": "8"}))
    for k in range(n_jobs):
        store.create("podgroups", build_pod_group(m, f"j{k}", "bench", 10,
                                                  names[k % 3]))
        req = {"cpu": str(1 + (k // 3) % 3), "memory": f"{1 + k % 4}Gi"}
        if k % 5 == 0:
            req["nvidia.com/gpu"] = "1"
        for i in range(10):
            store.create("pods", build_pod(m, ann, "bench", f"j{k}-{i}", "",
                                           "Pending", req, f"j{k}"))
    sched = pkg_mod(pkg, "scheduler").Scheduler(cache,
                                                scheduler_conf=HDRF_CONF)
    return sched, cache


def test_full_scale_hdrf_burst_matches_jax():
    """The burst of chip_smoke.py's hdrf phase: the port on the CPU binds
    the pods the JAX Scheduler binds. The JAX solve runs jitted here (op
    by op it would take minutes at T=5120, N=1024), and XLA's CPU jit
    contracts FMAs, which flips score ties between nodes: the nodes may
    differ, the pods may not. Both runs reach the solver's 64-round cap,
    which leaves sci under its weighted share in this cycle."""
    pods = {}
    for pkg in ("torch", "jax"):
        sched, cache = hdrf_burst_cluster(pkg)
        sched.run_once()
        pods[pkg] = sorted(cache.binder.binds)
    assert pods["torch"] == pods["jax"]
    per_queue = {}
    for key in pods["torch"]:
        q = int(key.split("/")[1][1:].split("-")[0]) % 3
        per_queue[q] = per_queue.get(q, 0) + 1
    # prod and sci each hold far more than dev, the tree's lightest leaf
    assert per_queue[1] < min(per_queue[0], per_queue[2])
