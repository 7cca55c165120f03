"""BENCHMARK.json keeps to the benchmark's contract, and every name in it
has its files."""

import json
import os
import re
import sys

import pytest

from tiny import REPO

sys.path.insert(0, REPO)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_and_limits(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert bench["command"] == ["python3", "benchmark/run.py"]
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    # a full check of 24 cells fits its 43200 seconds
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert 1 <= len(bench["workloads"]) <= 24
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= 1


def test_names_units_and_files(bench):
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert os.path.exists(os.path.join(REPO, c["file"]))
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
        spec_path = os.path.join(REPO, "benchmark", "workloads",
                                 f"{w['name']}.json")
        with open(spec_path) as f:
            spec = json.load(f)
        assert spec["config"] == w["config"]
        assert os.path.exists(os.path.join(
            REPO, "benchmark", "traffic", f"{spec['traffic']['kind']}.py"))
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert m["name"] not in names
        names.add(m["name"])
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert os.path.exists(os.path.join(REPO, "benchmark", "metrics",
                                           f"{m['name']}.py"))
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in bench["workloads"]}
    for cell in cells:
        got = [m for m in bench["end_to_end"]
               if cell in m.get("workloads", [cell])]
        assert "setup_s" in {m["name"] for m in got} and len(got) >= 2
        assert any(cell in m.get("workloads", [cell])
                   for m in bench["per_layer"])
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        for cell in m.get("workloads", cells):
            assert cell in e2e[m["moves"]].get("workloads", cells)
        if m["name"].split(".")[0].endswith("_roofline"):
            assert m["unit"] == "%"


def test_configs_conf_is_the_deployments(bench):
    from benchmark.check import reference_module
    from volcano_tpu_torch.conf import load_scheduler_conf
    with open(os.path.join(REPO, "installer_torch",
                           "scheduler-conf.yaml")) as f:
        installer = f.read()
    for c in bench["configs"]:
        with open(os.path.join(REPO, c["file"])) as f:
            cfg = json.load(f)
        port = load_scheduler_conf(cfg["conf"])
        ref = reference_module(cfg).parse(cfg["conf"])
        assert [[p.name for p in t.plugins] for t in port.tiers] == ref.tiers
        if c["name"] == "default-2k":
            assert load_scheduler_conf(installer).tiers == port.tiers
