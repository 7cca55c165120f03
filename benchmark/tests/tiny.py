"""Tiny cells for the benchmark's CPU tests: a copy of the benchmark in a
scratch root with one more configuration and cell, sized for the host."""

from __future__ import annotations

import json
import os
import shutil

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: (nodes, set-up gangs, wave) of each configuration's tiny cell
SIZES = {"default-2k": (40, 30, 3), "hdrf-1k": (40, 20, 2)}


def make_root(tmp, which: str) -> tuple:
    """A scratch root holding BENCHMARK.json, benchmark/ and the port (a
    link), with the cell ``<which>-tiny.steady`` added as data files
    only. Returns (root, cell)."""
    root = os.path.join(str(tmp), "root")
    shutil.copytree(os.path.join(REPO, "benchmark"),
                    os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(os.path.join(REPO, "volcano_tpu_torch"),
               os.path.join(root, "volcano_tpu_torch"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    nodes, setup, wave = SIZES[which]
    with open(os.path.join(REPO, "benchmark", "configs",
                           f"{which}.json")) as f:
        cfg = json.load(f)
    name = f"{which}-tiny"
    cfg["name"] = name
    cfg["nodes"]["count"] = nodes
    with open(os.path.join(root, "benchmark", "configs",
                           f"{name}.json"), "w") as f:
        json.dump(cfg, f)
    cell = f"{name}.steady"
    src = next(w for w in bench["workloads"] if w["config"] == which)
    bench["configs"].append({"name": name, "source": cfg["source"],
                             "file": f"benchmark/configs/{name}.json",
                             "reduced": ["nodes"], "why": "tests"})
    bench["workloads"].append(dict(src, name=cell, config=name))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if src["name"] in m.get("workloads", ()):
            m["workloads"].append(cell)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    with open(os.path.join(REPO, "benchmark", "workloads",
                           f"{src['name']}.json")) as f:
        spec = json.load(f)
    spec["config"] = name
    spec["traffic"].update(setup_gangs=setup, wave=wave, warm_waves=2)
    if "max_pending" in spec["traffic"]:
        spec["traffic"]["max_pending"] = setup // 5
    with open(os.path.join(root, "benchmark", "workloads",
                           f"{cell}.json"), "w") as f:
        json.dump(spec, f)
    return root, cell
