"""A later change adds a cell, a configuration, a traffic kind or a
per-layer metric by adding files and entries only: here a copy of the
benchmark gains all four, and runs them with its run.py and core.py
byte for byte as they are."""

import json
import os
import subprocess
import sys

from tiny import REPO, make_root

TRAFFIC = '''"""Traffic kind ``double_waves``: steady_waves with twice the wave."""
from benchmark.traffic.steady_waves import SteadyWaves


def build(config, params, seed):
    return SteadyWaves(config, dict(params, wave=2 * params["wave"]), seed)
'''

METRIC = '''"""Pods bound a window cycle."""


def read(run):
    return len(run.binds) / len(run.cycles) if run.cycles else None
'''


def test_a_cell_kind_and_metric_come_as_files(tmp_path):
    root, cell = make_root(tmp_path, "default-2k")
    b = os.path.join(root, "benchmark")
    with open(os.path.join(b, "traffic", "double_waves.py"), "w") as f:
        f.write(TRAFFIC)
    with open(os.path.join(b, "metrics", "binds_per_cycle.double.py"),
              "w") as f:
        f.write(METRIC)
    with open(os.path.join(b, "workloads", f"{cell}.json")) as f:
        spec = json.load(f)
    spec["traffic"]["kind"] = "double_waves"
    new = "default-2k-tiny.double"
    with open(os.path.join(b, "workloads", f"{new}.json"), "w") as f:
        json.dump(spec, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": new, "config": "default-2k-tiny",
                               "traffic": "double", "chips": 1,
                               "why": "tests"})
    for m in bench["end_to_end"]:
        if m["name"] == "pods_bound_per_s":
            m["workloads"].append(new)
    bench["per_layer"].append({
        "name": "binds_per_cycle.double", "unit": "pods", "better": "higher",
        "source": "host_clock", "layer": "scheduler cycle",
        "moves": "pods_bound_per_s", "workloads": [new]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    for name in ("run.py", "core.py"):
        with open(os.path.join(b, name), "rb") as f1, \
                open(os.path.join(REPO, "benchmark", name), "rb") as f2:
            assert f1.read() == f2.read()
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
            "from benchmark.core import run_cell; "
            "print(json.dumps(run_cell(sys.argv[2], 11, 1.0, True, "
            "device='cpu', root=sys.argv[1])))")
    out = subprocess.run([sys.executable, "-c", code, root, new],
                         capture_output=True, text=True, timeout=300,
                         check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["metrics"]["binds_per_cycle.double"]["value"] == 60.0
    assert res["metrics"]["binds_per_cycle.double"]["unit"] == "pods"
    code = code.replace("1.0, True", "1.0, False")
    out = subprocess.run([sys.executable, "-c", code, root, new],
                         capture_output=True, text=True, timeout=300,
                         check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["metrics"]["pods_bound_per_s"]["value"] > 0
