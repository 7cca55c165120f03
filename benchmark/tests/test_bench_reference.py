"""The plain reference gives the port's binds, cycle for cycle.

Tiny cells of both configurations run through the whole harness on the
CPU (the port's CPU route: its dense solve), and every window cycle's
binds are held against the reference's; the reference's control (its
scores in bfloat16) must not pass."""

import sys

import pytest
import torch

from tiny import REPO, make_root

sys.path.insert(0, REPO)

from benchmark.core import run_cell  # noqa: E402


@pytest.mark.parametrize("which", ["default-2k", "hdrf-1k"])
def test_reference_matches_the_port_cycle_for_cycle(tmp_path, which):
    root, cell = make_root(tmp_path, which)
    out = run_cell(cell, 2**33 + 7, 1.5, False, device="cpu", root=root,
                   control_dtype=torch.bfloat16)
    assert out["failed"] == 0
    assert out["compared_cycles"] == out["attempted"] > 0
    assert out["checks"]["bind_mismatches"]["value"] == 0
    assert out["checks"]["start_violations"]["value"] == 0
    assert out["correct"] is True
    e2e = "pods_bound_per_s" if which == "hdrf-1k" else "pod_latency_p95_ms"
    assert out["metrics"][e2e]["value"] > 0
    # the control: the same cycles judged with bfloat16 scores fail
    assert out["control_bind_mismatches"] > 0


def test_the_same_seed_gives_the_same_binds(tmp_path):
    from benchmark.traffic.steady_waves import SteadyWaves
    import json
    import os
    root, cell = make_root(tmp_path, "default-2k")
    with open(os.path.join(root, "benchmark", "workloads",
                           f"{cell}.json")) as f:
        spec = json.load(f)
    with open(os.path.join(root, "benchmark", "configs",
                           "default-2k-tiny.json")) as f:
        cfg = json.load(f)
    a, b, c = (SteadyWaves(cfg, spec["traffic"], s) for s in (5, 5, 6))
    ga = [a.next_spec() for _ in range(60)]
    gb = [b.next_spec() for _ in range(60)]
    gc = [c.next_spec() for _ in range(60)]
    assert ga == gb
    assert ga != gc
    # another seed: the same shapes, in another order
    def shapes(gs):
        return sorted(str(sorted(g.request.items())) for g in gs)
    assert shapes(ga[:30]) == shapes(gc[:30])
    assert shapes(ga[30:54]) == shapes(gc[30:54])


def test_arrivals_wait_while_the_backlog_is_full():
    from benchmark.traffic.steady_waves import SteadyWaves
    import json
    import os
    with open(os.path.join(REPO, "benchmark", "configs",
                           "hdrf-1k.json")) as f:
        cfg = json.load(f)

    class Backlog:
        """A world that binds nothing: its pending gangs are set by hand."""

        def __init__(self):
            self.gangs, self.pending, self.submitted = {}, 0, []

        def bound_gangs(self, shape=None):
            return []

        def n_pending(self):
            return self.pending

        def submit(self, g):
            self.submitted.append(g.name)
            self.pending += 1

    params = {"setup_gangs": 0, "wave": 2, "warm_waves": 0,
              "max_pending": 3}
    mix, world = SteadyWaves(cfg, params, 11), Backlog()
    world.pending = 3
    mix.intake(world)
    assert world.submitted == [] and len(mix.waiting) == 2
    world.pending = 1
    mix.intake(world)
    # two places free: the two oldest arrivals go in, in order
    assert world.submitted == ["j0", "j1"]
    assert [g.name for g in mix.waiting] == ["j2", "j3"]
    params.pop("max_pending")
    mix.intake(world)
    assert world.submitted == ["j0", "j1", "j2", "j3", "j4", "j5"]
