"""One run of one cell: set-up, the measured window, the traced window,
the correctness check and the result line.

Everything that belongs to a cell is data found by name: the cell's entry
in ``BENCHMARK.json``, its file ``workloads/<cell>.json`` (its config and
its traffic kind with that kind's parameters), the config's file (its
conf, nodes, queues with their optional ``capability`` and
``reclaimable``, optional ``priority_classes``, and optional
``reference``: the module under ``benchmark/`` that the check holds the
cell to, ``check.reference_module``), the traffic kind's module
``traffic/<kind>.py`` (which drives the store through ``World``'s
methods) and, for each metric ``BENCHMARK.json`` gives the cell, the
reader ``metrics/<metric>.py``, which reads the run's cycles, binds and
evictions (``readers.RunData``).
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import time
from . import check
from .readers import RunData
from .world import World

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_cell(root: str, cell: str):
    """(BENCHMARK.json, its workload entry, the cell's file, the config)."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    entry = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json")
    with open(os.path.join(root, "benchmark", "workloads",
                           f"{cell}.json")) as f:
        spec = json.load(f)
    cfg = next(c for c in bench["configs"] if c["name"] == entry["config"])
    with open(os.path.join(root, cfg["file"])) as f:
        config = json.load(f)
    if spec["config"] != entry["config"]:
        raise ValueError(f"{cell}: the cell's file names config "
                         f"{spec['config']!r}, BENCHMARK.json "
                         f"{entry['config']!r}")
    return bench, entry, spec, config


def reader(root: str, name: str):
    """The metric's reader module, ``metrics/<name>.py``."""
    path = os.path.join(root, "benchmark", "metrics", f"{name}.py")
    mod_spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", root: str = ROOT,
             setup_clock=None, control_dtype=None) -> dict:
    """Run the cell once; the result (without the JAX check, which the
    caller makes once the window has closed). ``setup_clock()`` gives the
    seconds since the process started (default: since this call).
    ``control_dtype``: also count, over the same cycles, the mismatches of
    the reference computed with its scores in that precision
    (``control_bind_mismatches``, ``control_eviction_mismatches``;
    ``control.py``)."""
    import torch

    t_call = time.perf_counter()
    if setup_clock is None:
        setup_clock = lambda: time.perf_counter() - t_call  # noqa: E731
    bench, entry, spec, config = load_cell(root, cell)
    traffic = importlib.import_module(
        f"benchmark.traffic.{spec['traffic']['kind']}")
    build_dir = os.path.join(root, "build", "bench-kernels")
    world = World(config, device, build_dir)
    mix = traffic.build(config, spec["traffic"], seed)
    mix.setup(world)
    on_card = device.startswith("cuda")
    if on_card:
        torch.cuda.synchronize()
    gc.collect()
    start = world.snapshot()
    first = len(world.cycles)
    setup_s = setup_clock()

    # -- the measured window ------------------------------------------------
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        c = world.begin()
        mix.intake(world)
        world.run(c)
    t1 = time.perf_counter()
    n_window = len(world.cycles) - first
    n_records = len(world.binder.records)
    n_evictions = len(world.evictor.records)

    summary = None
    if trace and on_card:
        from .trace import run_traced
        summary = run_traced(world, mix, spec["trace_cycles"],
                             os.path.join(root, "build", "bench-trace",
                                          "trace.json"))
    peak = int(torch.cuda.max_memory_allocated()) if on_card else 0
    kind = torch.cuda.get_device_name(0) if on_card else "cpu"

    cycles = world.cycles[first:]
    run = RunData(cell=cell, window_s=t1 - t0, setup_s=setup_s,
                  cycles=cycles[:n_window],
                  binds=[r for r in world.binder.records[:n_records]
                         if r[0] >= first],
                  evictions=[r for r in world.evictor.records[:n_evictions]
                             if r[0] >= first],
                  submit_t=world.submit_t, trace=summary)
    metrics = {}
    for m in cell_metrics(bench, cell, trace):
        v = reader(root, m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    # -- correctness, once the program's state is freed ----------------------
    binds_by_cycle: dict = {}
    for cyc, key, node, _ in world.binder.records:
        if cyc >= first:
            binds_by_cycle.setdefault(cyc, {})[key] = node
    evictions_by_cycle: dict = {}
    for cyc, key, reason, _ in world.evictor.records:
        if cyc >= first:
            evictions_by_cycle.setdefault(cyc, {})[key] = reason
    records = world.records
    conf_text = config["conf"]
    del world, mix
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    ref = check.reference_module(config)
    got = check.compare(start, cycles, binds_by_cycle, evictions_by_cycle,
                        records, conf_text, ref, device=device)
    checks = {
        "bind_mismatches": got["bind_mismatches"],
        "eviction_mismatches": got["eviction_mismatches"],
        "failed_cycles": sum(c.failure is not None for c in cycles),
        "start_violations": check.start_violations(start),
    }
    correct = all(checks[k] <= check.LIMITS[k] for k in checks)
    out = {
        "correct": correct,
        "attempted": len(cycles),
        "failed": checks["failed_cycles"],
        "metrics": metrics,
        "device": {"platform": "gpu" if on_card else "cpu", "kind": kind,
                   "count": 1 if on_card else 0,
                   "memory_peak_bytes": peak},
    }
    if summary:
        out["device"]["busy_s"] = summary["busy_s"]
        out["device"]["window_s"] = summary["window_s"]
        out["breakdown"] = {"device_ops": summary["device_ops"],
                            "idle_gaps": summary["idle_gaps"]}
    out["compared_cycles"] = got["compared_cycles"]
    out["check_s"] = time.perf_counter() - t_check
    if control_dtype is not None:
        ctl = check.compare(start, cycles, binds_by_cycle,
                            evictions_by_cycle, records, conf_text, ref,
                            score_dtype=control_dtype, device=device)
        out["control_bind_mismatches"] = ctl["bind_mismatches"]
        out["control_eviction_mismatches"] = ctl["eviction_mismatches"]
    out["failures"] = sorted({c.failure for c in cycles if c.failure})[:5]
    out["checks"] = {k: {"value": v, "limit": check.LIMITS[k]}
                     for k, v in checks.items()}
    return out
