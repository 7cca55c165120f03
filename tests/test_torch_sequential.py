"""The port's sequential parity solver (volcano_tpu_torch.ops.solver.
solve_allocate_sequential) and the allocate action's ``mode: sequential``
against the JAX package's, on the CPU.

- ``solve_allocate_sequential`` on seeded flattens: binpack, binpack+kube
  with queue caps, and the work-conserving ``overflow_pass``: identical
  ``assigned``, ``kind``, ``job_ready``, ``rounds`` and ``compact``.
- Scheduler cycles with allocate in ``mode: sequential``: the same binds,
  bind for bind, through the port's sequential solve (counted).

The JAX reference runs op by op (``jax.disable_jit``): XLA's CPU jit
contracts FMAs, see test_torch_solver.py (here too, jitted, one seed's
pipeline choice moves). Tolerance: exact.
"""

from __future__ import annotations

import numpy as np
import pytest

pytest.importorskip("jax")  # the JAX reference: absent on the card's machine

import jax
import jax.numpy as jnp

from volcano_tpu.ops import solver as js
from volcano_tpu_torch.ops import solver as ts

from test_torch_flatten import cluster_spec, flatten
from test_torch_solver import assert_identical, params_dict
from torch_helpers import SeededCluster

KEYS = ("assigned", "kind", "job_ready", "rounds", "compact")


@pytest.mark.parametrize("seed,p_kw,kw", [
    (1, {"binpack": 1.0}, {"score_families": ("binpack",)}),
    (2, {"binpack": 1.0, "least": 1.0},
     {"score_families": ("binpack", "kube"), "use_queue_cap": True}),
    (3, {"least": 1.0, "balanced": 1.0},
     {"score_families": ("kube",), "use_queue_cap": True,
      "overflow_pass": True}),
], ids=["binpack", "qcap", "qcap_overflow"])
def test_sequential_solve_matches_jax(seed, p_kw, kw):
    arr = flatten("jax", cluster_spec(seed, n_nodes=10, n_jobs=8))
    d = arr.device_dict()
    p = params_dict(arr, **p_kw)
    with jax.disable_jit():
        r = js.solve_allocate_sequential(
            {k: jnp.asarray(v) for k, v in d.items()},
            {k: jnp.asarray(v) for k, v in p.items()}, **kw)
        ref = {k: np.asarray(getattr(r, k)) for k in KEYS}
    res = ts.solve_allocate_sequential(d, p, device="cpu", **kw)
    assert_identical(ref, res)
    assigned = res.assigned.numpy()
    assert (assigned >= 0).any()
    # gangs all-or-nothing: a job holding an allocation is ready
    alloc = (assigned >= 0) & (res.kind.numpy() == 0)
    assert res.job_ready.numpy()[np.unique(d["task_job"][alloc])].all()


def test_overflow_pass_places_what_the_caps_left():
    """The overflow pass only adds: every strict-pass placement stays, and
    on a capped queue it places more."""
    arr = flatten("torch", cluster_spec(3, n_nodes=10, n_jobs=8))
    d = arr.numpy_dict()
    p = params_dict(arr, least=1.0, balanced=1.0)
    kw = dict(score_families=("kube",), use_queue_cap=True)
    strict = ts.solve_allocate_sequential(d, p, device="cpu", **kw)
    over = ts.solve_allocate_sequential(d, p, device="cpu",
                                        overflow_pass=True, **kw)
    a0, a1 = strict.assigned.numpy(), over.assigned.numpy()
    kept = a0 >= 0
    np.testing.assert_array_equal(a1[kept], a0[kept])
    assert (a1 >= 0).sum() >= kept.sum()


SEQUENTIAL_CONF = """
actions: "enqueue, allocate, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
configurations:
- name: allocate
  arguments:
    mode: sequential
"""


def test_sequential_cycles_match_jax_bind_for_bind(monkeypatch):
    calls = []
    real = ts.solve_allocate_sequential

    def counting(*a, **k):
        calls.append(k.get("device"))
        return real(*a, **k)

    monkeypatch.setattr(ts, "solve_allocate_sequential", counting)
    t = SeededCluster("torch", 41, n_nodes=6, conf=SEQUENTIAL_CONF, zones=2)
    j = SeededCluster("jax", 41, n_nodes=6, conf=SEQUENTIAL_CONF, zones=2)
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
    assert total > 8
    assert len(calls) == 2
