"""The traced window: a fixed number of cycles under ``torch.profiler``.

Run after the measured window closes, so that tracing costs the
end-to-end numbers nothing. The benchmark names its own host spans with
``record_function`` (``intake``, ``run_once``); inside a ``run_once`` span
the layers are laid out from that cycle's ``last_cycle_timing`` keys, and
``gc`` spans the loop's collection after it. From
the trace (chrome format, read once and deleted) come:

- ``window_s``: first intake start to last ``run_once`` end;
- ``busy_s``: the union of kernel, memcpy and memset intervals in it;
- ``launches``: kernel events (one per launch), less the one reduction a
  call that the shape recorder itself launches;
- the time of each kernel by name, that of the ``fused_choice`` kernels,
  and the least time their calls could take (``yardstick``, at each
  call's T, N, R, families and eligible rows, recorded by a wrapper
  around the solver's ``fused_choice``);
- the idle time between device intervals, by the host layer it fell in.
"""

from __future__ import annotations

import bisect
import json
import os
from typing import Dict, List

from .yardstick import bound_ms, fused_choice_cost

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: layers of one cycle in the order run_once runs them (timing keys);
#: flatten_ms covers the allocate action's ordering pass as well
ALLOCATE_KEYS = ("flatten_ms", "pack_ms", "delta_plan_ms", "dispatch_ms",
                 "overlap_ms", "readback_ms", "replay_ms")


class ShapeRecorder:
    """Wraps the solver's ``fused_choice`` while active: each call's (T, N,
    R, families) and its eligible rows (a device sum, read afterwards)."""

    def __enter__(self):
        from volcano_tpu_torch.ops import solver
        self._solver, self._orig, self.calls = solver, solver.fused_choice, []

        def recorded(init_req, avail, used_now, inv_alloc, node_static,
                     eligible, *args, **kw):
            self.calls.append((init_req.shape[0], avail.shape[0],
                               init_req.shape[1], tuple(args[3]),
                               eligible.sum()))
            return self._orig(init_req, avail, used_now, inv_alloc,
                              node_static, eligible, *args, **kw)

        solver.fused_choice = recorded
        return self

    def __exit__(self, *exc):
        self._solver.fused_choice = self._orig

    def bound_s(self) -> float:
        total = 0.0
        for T, N, R, fam, e in self.calls:
            nbytes, ops = fused_choice_cost(T, N, R, fam, int(e.item()))
            total += bound_ms(nbytes, ops)[0] / 1e3
        return total


def _union(intervals: List[tuple]) -> float:
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        busy += e - max(s, end)
        end = e
    return busy


def _layers(t0: float, t1: float, timing: dict) -> List[tuple]:
    """(name, start, end) in trace microseconds for one run_once span."""
    out, t = [], t0
    for key in ("open_ms", "enqueue_ms"):
        d = timing.get(key, 0.0) * 1e3
        out.append((key[:-3], t, t + d))
        t += d
    a_end = t + timing.get("allocate_ms", 0.0) * 1e3
    for key in ALLOCATE_KEYS:
        d = timing.get(key, 0.0) * 1e3
        out.append((key[:-3], t, min(t + d, a_end)))
        t += d
    out.append(("backfill", a_end, a_end + timing.get("backfill_ms", 0.0)
                * 1e3))
    out.append(("close", t1 - timing.get("close_ms", 0.0) * 1e3, t1))
    return out


def run_traced(world, mix, cycles: int, path: str) -> dict:
    """``cycles`` more cycles under the profiler; the trace's summary."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    os.makedirs(os.path.dirname(path), exist_ok=True)
    first = len(world.cycles)
    with ShapeRecorder() as shapes, profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(cycles):
            c = world.begin()
            with record_function("intake"):
                mix.intake(world)
            world.run(c, span=record_function)
        torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return summarize(events, world.cycles[first:], shapes)


def summarize(events, cycles, shapes) -> dict:
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0.0), e["name"])
                   for e in events if e.get("cat") == "user_annotation"
                   and e.get("name") in ("intake", "run_once", "gc"))
    runs = [s for s in spans if s[2] == "run_once"]
    if not spans or len(runs) != len(cycles):
        return {}
    w0, w1 = spans[0][0], runs[-1][1]
    dev = [(max(e["ts"], w0), min(e["ts"] + e.get("dur", 0.0), w1), e)
           for e in events if e.get("cat") in DEVICE_CATS]
    dev = [d for d in dev if d[1] > d[0]]
    if not dev:
        return {}
    by_name: Dict[str, float] = {}
    launches = 0
    fused_s = 0.0
    for s, e, ev in dev:
        if ev["cat"] == "kernel":
            launches += 1
            by_name[ev["name"]] = by_name.get(ev["name"], 0.0) + (e - s) / 1e6
            if "fused_choice" in ev["name"]:
                fused_s += (e - s) / 1e6
    # idle time between device intervals, shared out over the host layers
    # each gap overlaps (run_once time no timing key covers, and time
    # outside every span, under names of their own)
    layers = [(s, e, n) for s, e, n in spans if n != "run_once"]
    for (s, e, _), c in zip(runs, cycles):
        layers.extend((ls, le, n) for n, ls, le in _layers(s, e, c.timing))
    layers.sort()
    starts = [ls for ls, _, _ in layers]
    gaps: Dict[str, float] = {}

    def share_out(g0: float, g1: float) -> None:
        covered = 0.0
        i = max(bisect.bisect_right(starts, g0) - 1, 0)
        while i < len(layers) and layers[i][0] < g1:
            ls, le, n = layers[i]
            d = min(le, g1) - max(ls, g0)
            if d > 0:
                gaps[n] = gaps.get(n, 0.0) + d / 1e6
                covered += d
            i += 1
        inside = sum(max(min(e, g1) - max(s, g0), 0.0) for s, e, _ in runs
                     if s < g1 and e > g0)
        rest = (g1 - g0) - covered
        if rest > 0:
            name = "run_once, no timing key" if inside >= rest \
                else "between cycles"
            gaps[name] = gaps.get(name, 0.0) + rest / 1e6

    end = w0
    for s, e, _ in sorted(dev, key=lambda d: d[0]):
        if s > end:
            share_out(end, s)
        end = max(end, e)
    if w1 > end:
        share_out(end, w1)
    return {
        "cycles": len(cycles),
        "window_s": (w1 - w0) / 1e6,
        "busy_s": _union([(s, e) for s, e, _ in dev]) / 1e6,
        "launches": launches - len(shapes.calls),
        "fused_choice_s": fused_s,
        "fused_choice_bound_s": shapes.bound_s() if fused_s > 0 else 0.0,
        "fused_choice_calls": len(shapes.calls),
        "device_ops": sorted(([n[:160], t] for n, t in by_name.items()),
                             key=lambda x: -x[1])[:10],
        "idle_gaps": sorted(([n, t] for n, t in gaps.items()),
                            key=lambda x: -x[1])[:10],
    }
