"""Eviction-kernel fuzz through the port: tests/test_evict_fuzz.py's 60
seeded uniform-gang problems (its own generator, invariants and bound)
through the port's solve_evict (per-claimer scan) and
solve_evict_uniform (per-job closed form) on CPU tensors. Every solve is
also held to the JAX package's on the same inputs: assignments and
evictions equal (exact; the JAX solves run jitted, and on these problems
no score tie parts the two arithmetics)."""

from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("jax")  # the JAX reference: absent on the card's machine

import torch  # noqa: E402

import test_evict_fuzz as ref  # noqa: E402  (the generator and invariants)
from volcano_tpu.ops import evict as j_evict  # noqa: E402
from volcano_tpu_torch.ops.evict import (  # noqa: E402
    solve_evict, solve_evict_uniform,
)

SOLVES = (("scan", solve_evict, j_evict.solve_evict),
          ("uniform", solve_evict_uniform, j_evict.solve_evict_uniform))


def tensors(d: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


def test_uniform_vs_scan_parity():
    rng = np.random.default_rng(20260731)
    p, fam = ref.params()
    sat = {"scan": 0, "uniform": 0}
    for case in range(ref.CASES):
        a, v = ref.random_problem(rng)
        v_scan = {k: val for k, val in v.items()
                  if k not in ("job_req", "job_acct", "job_count")}
        for name, port_solve, jax_solve in SOLVES:
            vv = v_scan if name == "scan" else v
            res = port_solve(tensors(a), tensors(vv), tensors(p),
                             score_families=fam, device="cpu")
            got = SimpleNamespace(assigned=res.assigned.numpy(),
                                  evicted_by=res.evicted_by.numpy())
            want = jax_solve(a, vv, p, score_families=fam)
            np.testing.assert_array_equal(got.assigned,
                                          np.asarray(want.assigned))
            np.testing.assert_array_equal(got.evicted_by,
                                          np.asarray(want.evicted_by))
            sat[name] += len(ref.check_invariants(a, v, got,
                                                  f"{name}#{case}"))
    # the closed form computes global per-node capacity; in aggregate it
    # must not lose to the per-claimer greedy on uniform inputs
    assert sat["uniform"] >= sat["scan"] * 0.9, sat
