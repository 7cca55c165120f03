"""The port's own spans (``volcano_tpu_torch.metrics.tracing``).

- With no profiler a cycle records nothing and ``last_cycle_timing`` keeps
  its phase keys.
- Under ``torch.profiler`` (CPU activity), on the drf conf and on an hdrf
  conf: every span but ``vc.cycle``, ``vc.gc`` and ``vc.store.write`` lies
  inside its parent; each cycle has its open, actions and close; each
  phase key equals its span's duration exactly; the ``vc.round`` spans
  count the solve's rounds; the exported spans sit on their
  ``user_annotation`` events in the torch trace.
- Every ``vc.round.order`` and ``vc.round`` span of a CPU solve ran
  eagerly (``graph`` "eager": the CUDA graphs are for the card); with the
  round graphs' stand-in (tests/test_torch_round_graph.py) a replayed
  round opens no ``vc.round.order`` span, and every other round one.
- The benchmark's span readers (``benchmark/metrics``, ``benchmark/spans.py``)
  read positive numbers from spans recorded here, and nothing where the
  port has no recorder; ``order_graph_share.hdrf`` and the two
  ``round_graph_share`` readers read 0.0 from the CPU's spans, the
  replayed share from spans marked as replayed, and nothing from spans
  without the ``graph`` attribute.
"""

from __future__ import annotations

import importlib.util
import json
import statistics
import sys
import threading
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from torch_helpers import SeededCluster
from volcano_tpu_torch.metrics import tracing

REPO = Path(__file__).resolve().parents[1]

DRF_CONF = """
actions: "enqueue, allocate, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: conformance
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
  - name: binpack
"""

HDRF_CONF = """
actions: "enqueue, allocate, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
- plugins:
  - name: drf
    arguments:
      drf.enableHierarchy: true
  - name: predicates
  - name: nodeorder
"""

HIERARCHY = [("root/eng/prod", "1/2/8"), ("root/eng/dev", "1/2/2"),
             ("root/sci", "1/2")]

#: last_cycle_timing's phase keys and the span each is the duration of
PHASE_SPANS = {
    "open_ms": "vc.open", "close_ms": "vc.close", "total_ms": "vc.cycle",
    "order_ms": "vc.order", "flatten_ms": "vc.flatten", "pack_ms": "vc.pack",
    "delta_plan_ms": "vc.delta_plan", "dispatch_ms": "vc.dispatch",
    "overlap_ms": "vc.overlap", "readback_ms": "vc.readback",
    "solve_ms": "vc.solve", "replay_ms": "vc.replay",
}
ACTIONS = ("enqueue", "allocate", "backfill")
#: spans that may start or end outside their parent: the cycle is a root,
#: collections and store writes fall between cycles or on other threads
UNNESTED = ("vc.cycle", "vc.gc", "vc.store.write")

CONFS = {
    "drf": dict(conf=DRF_CONF),
    "hdrf": dict(conf=HDRF_CONF, hierarchy=HIERARCHY, node_cpu=8),
}


def _cluster(kind: str, seed: int = 7) -> SeededCluster:
    c = SeededCluster("torch", seed, n_nodes=8, n_queues=3, **CONFS[kind])
    c.submit_gangs(6)
    c.sched.run_once()
    return c


def _cycle(c: SeededCluster) -> dict:
    c.complete_some(0.3)
    c.submit_gangs(4)
    c.sched.run_once()
    c.sched._maybe_gc()
    return dict(c.sched.last_cycle_timing)


def _reader(name: str):
    path = REPO / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"test_tracing_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def repo_on_path():
    # the readers import ``benchmark.spans``
    sys.path.insert(0, str(REPO))
    yield
    sys.path.remove(str(REPO))


def _trace(kind: str, tmp: Path) -> dict:
    """Three churned cycles under the profiler: their spans, timings, the
    solves' round counts, the exported torch trace and the spans as
    chrome events on its timebase."""
    from volcano_tpu_torch.ops import solver

    c = _cluster(kind)
    real = solver.solve_allocate_packed2d
    rounds = []

    def counted(*args, **kw):
        res = real(*args, **kw)
        rounds.append(int(res.rounds))
        return res

    solver.solve_allocate_packed2d = counted
    tracing.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            timings = [_cycle(c) for _ in range(3)]
    finally:
        solver.solve_allocate_packed2d = real
    path = tmp / f"{kind}.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    spans = tracing.spans()
    events = tracing.chrome_events(int(trace["baseTimeNanoseconds"]))
    tracing.clear()
    return dict(kind=kind, spans=spans, timings=timings, rounds=rounds,
                trace=trace, events=events)


@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    """Each conf's traced cycles, made on first use."""
    made: dict = {}

    def get(kind: str) -> dict:
        if kind not in made:
            made[kind] = _trace(kind, tmp_path_factory.mktemp("trace"))
        return made[kind]

    return get


@pytest.fixture(params=sorted(CONFS))
def traced(request, traces):
    return traces(request.param)


def _inside(by_id: dict, s, name: str) -> bool:
    p = by_id.get(s.parent)
    while p is not None and p.name != name:
        p = by_id.get(p.parent)
    return p is not None


def _cycles(t):
    return [s for s in t["spans"] if s.name == "vc.cycle"]


def _children(t, parent):
    return [s for s in t["spans"] if s.parent == parent.id]


@pytest.mark.parametrize("kind", sorted(CONFS))
def test_no_profiler_records_no_span_and_keeps_the_phase_keys(kind):
    c = _cluster(kind)
    tracing.clear()
    timings = [_cycle(c) for _ in range(3)]
    assert tracing.current() is None
    assert tracing.spans() == [] and tracing.dropped() == 0
    for t in timings:
        assert set(PHASE_SPANS) | {f"{a}_ms" for a in ACTIONS} <= set(t)
        assert t["flatten_ms"] >= t["order_ms"] > 0
        assert t["total_ms"] >= t["open_ms"] + t["allocate_ms"] \
            + t["close_ms"]


def test_spans_nest_inside_their_parents(traced):
    spans = traced["spans"]
    by_id = {s.id: s for s in spans}
    assert len(_cycles(traced)) == 3
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.name in UNNESTED:
            continue
        p = by_id[s.parent]
        assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns, (s, p)
        assert s.cycle == p.cycle
    for cyc in _cycles(traced):
        kids = _children(traced, cyc)
        names = [k.name for k in sorted(kids, key=lambda k: k.start_ns)]
        assert names == ["vc.open", "vc.action", "vc.action", "vc.action",
                         "vc.close"]
        assert [k.attrs["name"] for k in kids
                if k.name == "vc.action"] == list(ACTIONS)
    # the collection and the intake's store writes count towards a cycle
    assert {s.cycle for s in spans if s.name == "vc.gc"} \
        == {c.id for c in _cycles(traced)}
    assert sum(s.name == "vc.store.write" for s in spans) > 0


def test_phase_keys_equal_their_spans(traced):
    for cyc, timing in zip(_cycles(traced), traced["timings"]):
        mine = [s for s in traced["spans"] if s.cycle == cyc.id]
        for key, name in PHASE_SPANS.items():
            (s,) = [s for s in mine if s.name == name]
            assert timing[key] == s.ms, key
        for action in ACTIONS:
            (s,) = [s for s in mine if s.name == "vc.action"
                    and s.attrs["name"] == action]
            assert timing[f"{action}_ms"] == s.ms


def test_round_spans_count_the_solve_rounds(traced):
    spans = traced["spans"]
    by_id = {s.id: s for s in spans}
    per_cycle = []
    for cyc in _cycles(traced):
        (dispatch,) = [s for s in spans
                       if s.cycle == cyc.id and s.name == "vc.dispatch"]
        rounds = [s for s in spans if s.name == "vc.round"
                  and s.parent == dispatch.id]
        per_cycle.append(len(rounds))
        assert [r.attrs["round"] for r in
                sorted(rounds, key=lambda r: r.start_ns)] \
            == list(range(len(rounds)))
        for r in rounds:
            kids = [s for s in spans if s.parent == r.id]
            assert [k.name for k in kids].count("vc.round.order") == 1
            assert [k.name for k in kids].count("vc.sync") == 1
            assert kids[0].attrs["kind"] == \
                ("hdrf" if traced["kind"] == "hdrf" else "drf")
    assert per_cycle == traced["rounds"] and sum(per_cycle) > 0
    # every sync of the solve is taken under its dispatch
    syncs = [s for s in spans if s.name == "vc.sync"]
    assert syncs and all(_inside(by_id, s, "vc.dispatch") for s in syncs)


def test_exported_spans_sit_on_their_annotations(traced):
    """Every span of the scheduling thread, once mapped to the torch
    trace's timebase, lies on its ``user_annotation`` event to within
    1 ms: the two stamps are taken inside the annotation, so the span lies
    inside the event widened by 1 ms at each end (a stall of the thread
    between the profiler's stamp and the span's only narrows the span),
    and the median distance of the starts and of the ends is under
    1 ms."""
    trace = traced["trace"]
    main = threading.get_ident()
    mine = {}
    for s, e in zip(traced["spans"], traced["events"]):
        if s.thread == main:
            mine.setdefault(e["name"], []).append(e)
    cycle_tid = {e["tid"] for e in trace["traceEvents"]
                 if e.get("name") == "vc.cycle"}
    theirs = {}
    for e in trace["traceEvents"]:
        if e.get("cat") == "user_annotation" and e["tid"] in cycle_tid \
                and e["name"].startswith("vc."):
            theirs.setdefault(e["name"], []).append(e)
    assert set(mine) == set(theirs)
    starts, ends = [], []
    for name, evs in mine.items():
        a = sorted(evs, key=lambda e: e["ts"])
        b = sorted(theirs[name], key=lambda e: e["ts"])
        assert len(a) == len(b), name
        for x, y in zip(a, b):
            assert y["ts"] - 1000.0 <= x["ts"], (name, x, y)
            assert x["ts"] + x["dur"] <= y["ts"] + y["dur"] + 1000.0, \
                (name, x, y)
            starts.append(abs(x["ts"] - y["ts"]))
            ends.append(abs(x["ts"] + x["dur"] - y["ts"] - y["dur"]))
    assert statistics.median(starts) <= 1000.0
    assert statistics.median(ends) <= 1000.0


STEADY_READERS = ("snapshot_ms.steady", "plugin_open_ms.steady",
                  "rounds_per_cycle.steady", "fair_order_ms.steady",
                  "round_sync_ms.steady", "close_ms.steady", "gc_ms.steady",
                  "store_write_ms.steady")
HDRF_READERS = ("rounds_per_cycle.hdrf", "fair_order_ms.hdrf",
                "round_sync_ms.hdrf")


@pytest.mark.parametrize("kind,name", [("drf", n) for n in STEADY_READERS]
                         + [("hdrf", n) for n in HDRF_READERS])
def test_span_readers_read_positive_numbers(kind, name, traces,
                                            repo_on_path, monkeypatch):
    traced = traces(kind)
    monkeypatch.setattr(tracing, "spans", lambda: list(traced["spans"]))
    got = _reader(name).read(None)
    assert got is not None and got > 0
    if name.startswith("round_sync_ms"):
        dispatch = statistics.median(t["dispatch_ms"]
                                     for t in traced["timings"])
        assert got <= dispatch
    if name.startswith("rounds_per_cycle"):
        assert got == statistics.median(traced["rounds"])


def test_order_spans_run_eagerly_on_the_cpu(traced):
    """The rank and cap's graph is for the card: every order span of a
    CPU solve, drf or hdrf, ran eagerly."""
    orders = [s for s in traced["spans"] if s.name == "vc.round.order"]
    assert orders and all(s.attrs["graph"] == "eager" for s in orders)


def _as_replayed(spans, name: str = "vc.round.order"):
    """The spans with every ``name`` span of a cycle but its first two
    marked "replay" (a solve on the card); the median share of replays a
    cycle that the reader should then read."""
    seen, out, shares = {}, [], {}
    for s in sorted(spans, key=lambda s: s.start_ns):
        if s.name == name:
            k = seen[s.cycle] = seen.get(s.cycle, 0) + 1
            s = s._replace(attrs=dict(s.attrs,
                                      graph="replay" if k > 2 else "eager"))
            shares.setdefault(s.cycle, []).append(k > 2)
        out.append(s)
    return out, statistics.median(sum(v) / len(v) for v in shares.values())


@pytest.mark.parametrize("form", ["cpu", "replayed", "no_attribute"])
def test_order_graph_share_reads_the_replayed_share(form, traces,
                                                    repo_on_path,
                                                    monkeypatch):
    """0.0 on the CPU's eager hdrf trace; the median share of replays
    where rounds replayed; nothing where the order spans carry no
    ``graph`` attribute, as a program without the graph records them."""
    spans = list(traces("hdrf")["spans"])
    want = 0.0
    if form == "replayed":
        spans, want = _as_replayed(spans)
        assert 0.0 < want < 1.0
    elif form == "no_attribute":
        spans = [s._replace(attrs={k: v for k, v in s.attrs.items()
                                   if k != "graph"}) for s in spans]
        want = None
    monkeypatch.setattr(tracing, "spans", lambda: spans)
    assert _reader("order_graph_share.hdrf").read(None) == want


ROUND_GRAPH_READERS = {"drf": "round_graph_share.steady",
                       "hdrf": "round_graph_share.hdrf"}


def test_round_spans_run_eagerly_on_the_cpu(traced):
    rounds = [s for s in traced["spans"] if s.name == "vc.round"]
    assert rounds and all(s.attrs["graph"] == "eager" for s in rounds)


@pytest.mark.parametrize("kind", sorted(CONFS))
def test_a_replayed_round_opens_no_order_span(kind, monkeypatch):
    """Cycles whose solves run through the round graphs' stand-in: each
    ``vc.round`` says how it ran; a replayed one holds no
    ``vc.round.order`` span (its Python did not run), every other one
    holds one."""
    from test_torch_round_graph import StandIn
    from volcano_tpu_torch.ops import round_graph

    monkeypatch.setattr(round_graph, "GRAPHS",
                        round_graph.RoundGraphs(StandIn()))
    c = _cluster(kind)
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            _cycle(c)
    spans = tracing.spans()
    tracing.clear()
    rounds = {s.id: s for s in spans if s.name == "vc.round"}
    modes = [s.attrs["graph"] for s in rounds.values()]
    assert modes.count("replay") > 0 and modes.count("capture") > 0
    orders = {}
    for s in spans:
        if s.name == "vc.round.order":
            orders[s.parent] = orders.get(s.parent, 0) + 1
    for rid, r in rounds.items():
        want = 0 if r.attrs["graph"] == "replay" else 1
        assert orders.get(rid, 0) == want, r


@pytest.mark.parametrize("form", ["cpu", "replayed", "no_attribute"])
@pytest.mark.parametrize("kind", sorted(ROUND_GRAPH_READERS))
def test_round_graph_share_reads_the_replayed_share(kind, form, traces,
                                                    repo_on_path,
                                                    monkeypatch):
    """0.0 on the CPU's eager trace; the median share of replayed rounds
    where rounds replayed; nothing where the round spans carry no
    ``graph`` attribute, as a program without the round graphs records
    them."""
    spans = list(traces(kind)["spans"])
    want = 0.0
    if form == "replayed":
        spans, want = _as_replayed(spans, "vc.round")
        assert 0.0 < want < 1.0
    elif form == "no_attribute":
        spans = [s._replace(attrs={k: v for k, v in s.attrs.items()
                                   if k != "graph"}) for s in spans]
        want = None
    monkeypatch.setattr(tracing, "spans", lambda: spans)
    assert _reader(ROUND_GRAPH_READERS[kind]).read(None) == want


@pytest.mark.parametrize("name", STEADY_READERS + HDRF_READERS
                         + ("order_graph_share.hdrf",)
                         + tuple(sorted(ROUND_GRAPH_READERS.values())))
def test_span_readers_read_nothing_without_the_recorder(name, repo_on_path,
                                                        monkeypatch):
    monkeypatch.setitem(sys.modules, "volcano_tpu_torch.metrics.tracing",
                        None)
    assert _reader(name).read(None) is None


def test_buffer_is_capped_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(tracing, "CAP", 3)
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(5):
            with tracing.traced("vc.gc", full=0):
                pass
    assert len(tracing.spans()) == 3 and tracing.dropped() == 2
    tracing.clear()
    assert tracing.spans() == [] and tracing.dropped() == 0


def test_off_spans_still_time_and_record_nothing():
    tracing.clear()
    with tracing.span("vc.open") as s, tracing.traced("vc.gc") as t:
        torch.ones(4).sum()
        t.set(full=1)
    assert s.ms > 0 and tracing.current() is None
    assert tracing.spans() == [] and tracing.chrome_events() == []


def test_watchdog_and_effector_threads_name_their_parents():
    """An action run under the deadline watchdog, and binds dispatched to
    the effector pool, open their spans under the span that handed them
    over."""
    c = SeededCluster("torch", 3, n_nodes=8, conf=DRF_CONF)
    c.sched = type(c.sched)(c.cache, scheduler_conf=DRF_CONF,
                            action_deadline_s=60.0)
    c.submit_gangs(6)
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        c.sched.run_once()
    spans = tracing.spans()
    tracing.clear()
    by_id = {s.id: s for s in spans}
    (flatten,) = [s for s in spans if s.name == "vc.flatten"]
    assert flatten.thread != threading.get_ident()
    parent = by_id[flatten.parent]
    assert parent.name == "vc.action" and parent.attrs["name"] == "allocate"
    assert parent.start_ns <= flatten.start_ns <= flatten.end_ns \
        <= parent.end_ns

    from volcano_tpu_torch.cache import SchedulerCache
    from volcano_tpu_torch.client import ClusterStore

    cache = SchedulerCache(ClusterStore(), device="cpu",
                           async_effectors=True)
    obj = SimpleNamespace(name="probe", namespace="ns")
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("vc.replay") as replay:
            cache._dispatch_effect(
                lambda: cache.cluster.create("configmaps", obj),
                lambda: None, "probe write")
        cache.wait_for_effects()
    spans = tracing.spans()
    tracing.clear()
    (write,) = [s for s in spans if s.name == "vc.store.write"]
    assert write.parent == replay.id and write.cycle == replay.cycle
    assert write.thread != threading.get_ident()
