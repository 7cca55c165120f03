"""A deployment that evicts comes in as files and entries only: a copy of
the benchmark gains an evicting configuration (the conf enqueue,
allocate, preempt, reclaim, backfill over 8 nodes, two priority classes,
one reclaimable queue), a reference of its own sized to that case
(``evict_fixture/reference_evict_tiny.py``), a traffic kind that places
low-priority elastic jobs Running, submits high-priority gangs, reports
binds Running and releases evicted pods at the next intake
(``evict_churn.py``), and two readers; its run.py, core.py, check.py and
world.py stay byte for byte the repo's. The program's evictions, of both
reasons, are held to the reference's; a reference that drops one
eviction fails the run, and so does an error planted in the preempt
action, as a failed cycle."""

import json
import os
import shutil
import subprocess
import sys

from tiny import REPO, make_root

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "evict_fixture")
CELL = "evict-tiny.churn"

DROP = '''"""The tiny evicting reference, less one eviction a cycle."""
from benchmark.reference_evict_tiny import parse  # noqa: F401
from benchmark.reference_evict_tiny import cycle_decisions as _decisions


def cycle_decisions(state, conf, score_dtype=None, device="cpu"):
    binds, evictions = _decisions(state, conf, score_dtype, device)
    for key in sorted(evictions)[:1]:
        del evictions[key]
    return binds, evictions
'''


def evict_root(tmp_path, reference="reference_evict_tiny"):
    """The copy with the evicting cell added; returns its root."""
    root, _ = make_root(tmp_path, "default-2k")
    b = os.path.join(root, "benchmark")
    for src, dst in [
            ("reference_evict_tiny.py", "reference_evict_tiny.py"),
            ("evict_churn.py", "traffic/evict_churn.py"),
            ("evictions_per_cycle.py", "metrics/evictions_per_cycle.py"),
            ("reclaims_per_cycle.py", "metrics/reclaims_per_cycle.py"),
            ("evict-tiny.json", "configs/evict-tiny.json"),
            (f"{CELL}.json", f"workloads/{CELL}.json")]:
        shutil.copy(os.path.join(FIXTURE, src), os.path.join(b, dst))
    with open(os.path.join(b, "reference_evict_drop.py"), "w") as f:
        f.write(DROP)
    cfg_path = os.path.join(b, "configs", "evict-tiny.json")
    with open(cfg_path) as f:
        cfg = json.load(f)
    cfg["reference"] = reference
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "evict-tiny", "source": cfg["source"],
                             "file": "benchmark/configs/evict-tiny.json",
                             "reduced": ["nodes"], "why": "tests"})
    bench["workloads"].append({"name": CELL, "config": "evict-tiny",
                               "traffic": "churn", "chips": 1,
                               "why": "tests"})
    for m in bench["end_to_end"]:
        if m["name"] == "pods_bound_per_s":
            m["workloads"].append(CELL)
    for name in ("evictions_per_cycle", "reclaims_per_cycle"):
        bench["per_layer"].append({
            "name": name, "unit": "pods", "better": "lower",
            "source": "host_clock", "layer": "evict",
            "moves": "pods_bound_per_s", "workloads": [CELL]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    for name in ("run.py", "core.py", "check.py", "world.py"):
        with open(os.path.join(b, name), "rb") as f1, \
                open(os.path.join(REPO, "benchmark", name), "rb") as f2:
            assert f1.read() == f2.read()
    return root


#: plants, after the set-up's two warm-up cycles, an error in the preempt
#: action (the scheduler contains it and records ``preempt_error``)
PLANT_PREEMPT_ERROR = """
from volcano_tpu_torch.actions.preempt import PreemptAction
from volcano_tpu_torch.scheduler import Scheduler
orig, calls = Scheduler.run_once, []
def run_once(self):
    calls.append(1)
    if len(calls) == 3:
        def broken(action, ssn):
            raise RuntimeError("planted")
        PreemptAction.execute = broken
    return orig(self)
Scheduler.run_once = run_once
"""


def run(root, seed, trace, prelude=""):
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
            f"{prelude}\n"
            "from benchmark.core import run_cell; "
            f"print(json.dumps(run_cell(sys.argv[2], {seed}, 1.5, {trace}, "
            "device='cpu', root=sys.argv[1])))")
    out = subprocess.run([sys.executable, "-c", code, root, CELL],
                         capture_output=True, text=True, timeout=300,
                         check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_an_evicting_cell_comes_as_files(tmp_path):
    root = evict_root(tmp_path)
    res = run(root, 2**33 + 19, True)
    assert res["failed"] == 0 and res["attempted"] > 0
    assert res["compared_cycles"] == res["attempted"]
    for name in ("bind_mismatches", "eviction_mismatches",
                 "start_violations", "failed_cycles"):
        assert res["checks"][name]["value"] == 0, name
    assert res["correct"] is True
    ev = res["metrics"]["evictions_per_cycle"]["value"]
    rc = res["metrics"]["reclaims_per_cycle"]["value"]
    # both reasons: reclaim's and, the rest, preempt's
    assert ev > rc > 0
    res = run(root, 5, False)
    assert res["correct"] is True
    assert res["metrics"]["pods_bound_per_s"]["value"] > 0


def test_a_dropped_eviction_is_not_correct(tmp_path):
    root = evict_root(tmp_path, reference="reference_evict_drop")
    res = run(root, 2**33 + 19, False)
    assert res["checks"]["bind_mismatches"]["value"] == 0
    assert res["checks"]["eviction_mismatches"]["value"] > 0
    assert res["correct"] is False


def test_a_planted_preempt_error_fails_the_run(tmp_path):
    root = evict_root(tmp_path)
    res = run(root, 2**33 + 19, False, prelude=PLANT_PREEMPT_ERROR)
    assert res["failures"] == ["preempt_error"]
    assert res["failed"] == res["checks"]["failed_cycles"]["value"] > 0
    assert res["correct"] is False
