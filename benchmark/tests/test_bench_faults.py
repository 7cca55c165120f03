"""A run whose timed path is broken underneath comes out not correct.

Each test drives a whole run of a tiny cell on the CPU (past the
harness's look for a card), with one fault planted in the program once
the set-up is done:
- a cycle that returns the state unchanged (``run_once`` does nothing);
- half of the batch left out (the allocate action sees every other job);
- an answer altered where it is produced (one task of the solve's result
  moved to the next node).
The fourth fault the contract names, the exchange between chips left
out, has no place in a one-chip cell."""

import sys

import numpy as np
import pytest

from tiny import REPO, make_root

sys.path.insert(0, REPO)

from benchmark.core import run_cell  # noqa: E402

#: the tiny cell's set-up cycles: the burst and two warm-up waves
SETUP_CYCLES = 3


def _after_setup(wrapped, faulty):
    """Call ``wrapped`` for the set-up cycles, ``faulty`` after."""
    calls = {"n": 0}

    def fn(*args, **kw):
        calls["n"] += 1
        f = faulty if calls["n"] > SETUP_CYCLES else wrapped
        return f(*args, **kw)
    return fn


def plant_noop_cycle(monkeypatch):
    from volcano_tpu_torch.scheduler import Scheduler
    orig = Scheduler.run_once
    monkeypatch.setattr(Scheduler, "run_once",
                        _after_setup(orig, lambda self: None))


def plant_half_batch(monkeypatch):
    from volcano_tpu_torch.actions.allocate import AllocateAction
    from volcano_tpu_torch.scheduler import Scheduler
    orig_collect = AllocateAction._collect
    state = {"on": False}

    def collect(self, ssn):
        got = orig_collect(self, ssn)
        return got[::2] if state["on"] else got

    def turn_on(self):
        state["on"] = True
        return orig_run(self)

    orig_run = Scheduler.run_once
    monkeypatch.setattr(AllocateAction, "_collect", collect)
    monkeypatch.setattr(Scheduler, "run_once",
                        _after_setup(orig_run, turn_on))


def plant_altered_answer(monkeypatch):
    import volcano_tpu_torch.ops.solver as solver
    from volcano_tpu_torch.scheduler import Scheduler
    orig_decode = solver.decode_compact
    state = {"on": False}

    def decode(compact):
        assigned, kind = orig_decode(compact)
        hit = np.flatnonzero(assigned >= 0)
        if state["on"] and hit.size:
            assigned = assigned.copy()
            assigned[hit[0]] = (assigned[hit[0]] + 1) % 40
        return assigned, kind

    def turn_on(self):
        state["on"] = True
        return orig_run(self)

    orig_run = Scheduler.run_once
    monkeypatch.setattr(solver, "decode_compact", decode)
    monkeypatch.setattr(Scheduler, "run_once",
                        _after_setup(orig_run, turn_on))


@pytest.mark.parametrize("plant", [plant_noop_cycle, plant_half_batch,
                                   plant_altered_answer],
                         ids=["state_unchanged", "half_batch",
                              "answer_altered"])
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, plant):
    root, cell = make_root(tmp_path, "default-2k")
    plant(monkeypatch)
    out = run_cell(cell, 977, 1.0, False, device="cpu", root=root)
    assert out["attempted"] > 0
    assert out["checks"]["bind_mismatches"]["value"] > 0
    assert out["correct"] is False
