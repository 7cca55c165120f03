"""The hdrf rank and cap replayed from a CUDA graph
(``volcano_tpu_torch.ops.hdrf.RankCapGraph``), on the card, in the
sharded solve's loop (``parallel.solve_allocate_sharded`` on a one-card
mesh), its user: the single-device solve replays whole rounds
(``ops.round_graph``, tests/test_torch_round_graph.py).

- A seeded hdrf solve gives the same ``assigned``, ``kind``,
  ``job_ready`` and ``rounds``, bit for bit, as the same solve whose
  capture raises (before it begins, or inside it on a host read), which
  then runs eagerly to its end.
- Seeded (eligible, jobres) pairs through the replayed rank and cap equal
  eager calls exactly, and a replay leaves earlier results as they were.
- The solve's ``vc.round.order`` spans read one "eager", one "capture" and
  "replay" for the rest.
- Solve after solve reuses one memory pool: the allocator's reserved
  bytes stay put.

Every test needs a CUDA card (the ``cuda`` marker) and skips without one.
No JAX: the reference is the port's own eager call.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from torch_helpers import EXAMPLE, RAGGED, hdrf_flatten
from volcano_tpu_torch.metrics import tracing
from volcano_tpu_torch.ops import hdrf
from volcano_tpu_torch.parallel import make_mesh, solve_allocate_sharded

RESULT_KEYS = ("assigned", "kind", "job_ready", "rounds")

#: (tree, seed): at SOLVE_SIZE a few dozen rounds each (50 and 45 on the
#: CPU's dense path); at PAIR_SIZE (test_torch_hdrf.py's rank and cap
#: corpus) the cap binds on most pairs
PROBLEMS = [(EXAMPLE, 4), (RAGGED, 6)]
SOLVE_SIZE = dict(n_nodes=24, n_jobs=60, tasks_per_job=4)
PAIR_SIZE = dict(n_nodes=8, n_jobs=10, tasks_per_job=3)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _problem(tree, seed: int, size=SOLVE_SIZE):
    arr = hdrf_flatten("torch", seed, tree, n_queues=len(tree), **size)
    params = {
        "binpack_weight": np.float32(1.0),
        "binpack_res_weights": np.ones(arr.R, np.float32),
        "least_req_weight": np.float32(1.0),
        "most_req_weight": np.float32(0.0),
        "balanced_weight": np.float32(0.0),
        "node_static": np.zeros(arr.N, np.float32),
    }
    return arr, params


def _solve(arr, params, device):
    res = solve_allocate_sharded(arr.numpy_dict(), params,
                                 make_mesh([device]), use_drf_order=True,
                                 use_hdrf_order=True)
    return {k: getattr(res, k).cpu().numpy() for k in RESULT_KEYS}


def _order_modes(arr, params, device) -> list:
    """The ``graph`` attribute of each ``vc.round.order`` span of one
    solve, in order."""
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        _solve(arr, params, device)
    spans = sorted((s for s in tracing.spans()
                    if s.name == "vc.round.order"),
                   key=lambda s: s.start_ns)
    tracing.clear()
    return [s.attrs["graph"] for s in spans]


def _capture_begin_raises(monkeypatch):
    def refuse(self, *args, **kw):
        raise RuntimeError("capture refused")

    monkeypatch.setattr(torch.cuda.CUDAGraph, "capture_begin", refuse)


def _capture_reads_the_host(monkeypatch):
    """A rank and cap that reads a value back to the host while its
    stream captures: the capture is invalidated, its end raises."""
    real = hdrf.hdrf_state

    def reading(a, rank):
        fn = real(a, rank)

        def rank_and_cap(eligible, jobres):
            if torch.cuda.is_current_stream_capturing():
                eligible.sum().item()
            return fn(eligible, jobres)

        return rank_and_cap

    monkeypatch.setattr(hdrf, "hdrf_state", reading)


@pytest.mark.cuda
@pytest.mark.parametrize("tree,seed", PROBLEMS, ids=["example", "ragged"])
@pytest.mark.parametrize("refuse", [_capture_begin_raises,
                                    _capture_reads_the_host],
                         ids=["begin", "inside"])
def test_graphed_solve_equals_the_eager_fallback(tree, seed, refuse,
                                                 cuda_device, monkeypatch,
                                                 caplog):
    arr, params = _problem(tree, seed)
    graphed = _solve(arr, params, cuda_device)
    assert _order_modes(arr, params, cuda_device).count("replay") > 0
    with monkeypatch.context() as m:
        refuse(m)
        eager = _solve(arr, params, cuda_device)
        modes = _order_modes(arr, params, cuda_device)
    assert set(modes) == {"eager"} and len(modes) == int(graphed["rounds"])
    assert "CUDA graph capture failed" in caplog.text
    for k in RESULT_KEYS:
        assert graphed[k].dtype == eager[k].dtype, k
        np.testing.assert_array_equal(graphed[k], eager[k], err_msg=k)
    assert (graphed["assigned"] >= 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("tree,seed", PROBLEMS, ids=["example", "ragged"])
def test_replayed_rank_and_cap_equals_eager_calls(tree, seed, cuda_device):
    arr, _ = _problem(tree, seed, PAIR_SIZE)
    a = arr.device_dict(device=cuda_device)
    fn = hdrf.hdrf_state(a, None)
    graph = hdrf.RankCapGraph(fn)
    rng = np.random.default_rng(seed)
    nj = len(arr.jobs_list)
    pairs = []
    for _ in range(10):
        jobres = np.zeros((arr.J, arr.R), np.float32)
        jobres[:nj, 0] = 1000.0 * rng.integers(0, 3, nj)
        eligible = arr.task_valid & (rng.random(arr.T) < 0.8)
        pairs.append((torch.from_numpy(eligible).to(cuda_device),
                      torch.from_numpy(jobres).to(cuda_device)))
    got, modes = [], []
    for eligible, jobres in pairs:
        got.append(graph(eligible, jobres))
        modes.append(graph.mode)
    assert modes == ["eager", "capture"] + ["replay"] * 8
    for (eligible, jobres), (r_rank, still) in zip(pairs, got):
        want_rank, want_still = fn(eligible, jobres)
        assert r_rank.dtype == want_rank.dtype == torch.int32
        assert still.dtype == want_still.dtype == torch.bool
        assert torch.equal(r_rank, want_rank)
        assert torch.equal(still, want_still)
    # the cap binds somewhere, and the pairs differ (not vacuous)
    assert any(bool((s != e).any()) for (e, _), (_, s) in zip(pairs, got))
    assert len({tuple(r.tolist()) for r, _ in got}) > 1
    graph.close()
    assert graph.graph is None


@pytest.mark.cuda
@pytest.mark.parametrize("tree,seed", PROBLEMS, ids=["example", "ragged"])
def test_order_spans_read_eager_capture_then_replay(tree, seed, cuda_device):
    arr, params = _problem(tree, seed)
    modes = _order_modes(arr, params, cuda_device)
    assert len(modes) >= 3
    assert modes == ["eager", "capture"] + ["replay"] * (len(modes) - 2)


@pytest.mark.cuda
def test_solves_reuse_one_memory_pool(cuda_device):
    arr, params = _problem(EXAMPLE, 4)
    _solve(arr, params, cuda_device)
    pools = [p for d, p, *_ in hdrf._POOLS.free if d == cuda_device]
    reserved = torch.cuda.memory_reserved(cuda_device)
    for _ in range(4):
        _solve(arr, params, cuda_device)
    assert [p for d, p, *_ in hdrf._POOLS.free
            if d == cuda_device] == pools
    assert len(pools) == 1
    assert torch.cuda.memory_reserved(cuda_device) == reserved
