"""The round solve's rounds replayed from CUDA graphs kept across solves
(``volcano_tpu_torch.ops.round_graph``).

On the CPU, through ``StandIn`` (a capture runs the body once, records
what it reads and undoes what it wrote; a replay runs it again, spans
off, into the captured outputs):
- per key and variant the first call runs eagerly, the second captures,
  in the same solve or a later one, and later calls replay; a key seen
  once is never captured;
- one solve at a time holds a key: another solve at the key runs eagerly
  while it is held;
- past the bound the least recently used key that no solve holds is
  dropped and its pool handed back; a held key is never dropped;
- a capture that raises leaves the key eager, with a warning;
- ``solve_allocate`` through the stand-in equals the eager solve, on the
  default conf's flags and on hdrf's, over consecutive solves at one key
  with different data and across the arena's ``invalidate()``, a solve
  nested inside another at the same key included; no capture reads a
  tensor that its key does not own.

On the card (the ``cuda`` marker; each skips without one), against the
eager solve bit for bit (``assigned``, ``kind``, ``job_ready``,
``rounds``, ``compact``): the default flags, the hdrf flags and
``fused="off"``; consecutive solves at one key with different data,
across ``PackedDeviceCache.invalidate()``; two interleaved solves at one
key; a capture that raises, before it begins or inside it. A wrapper of
the solver's ``fused_choice`` sees a graphed solve's calls as an eager
solve makes them. A replayed round opens no ``vc.round.order`` span.

No JAX: the reference is the port's own eager solve.
"""

from __future__ import annotations

import logging
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from torch_helpers import EXAMPLE, hdrf_flatten
from volcano_tpu_torch.metrics import tracing
from volcano_tpu_torch.ops import PackedDeviceCache, round_graph, solver
from volcano_tpu_torch.ops.fused_choice import fused_choice
from volcano_tpu_torch.ops.round_graph import RoundGraphs, SolveGraphs
from volcano_tpu_torch.ops.solver import _State

RESULT_KEYS = ("assigned", "kind", "job_ready", "rounds", "compact")

#: the solve flags of the benchmark's two configurations, and the dense
#: path of the first
FLAGS = {
    "default": dict(use_drf_order=True, use_queue_cap=True,
                    score_families=("binpack", "kube")),
    "hdrf": dict(use_drf_order=True, use_hdrf_order=True,
                 score_families=("binpack", "kube")),
    "fused_off": dict(use_drf_order=True, use_queue_cap=True,
                      score_families=("binpack", "kube"), fused="off"),
}
SIZE = dict(n_nodes=24, n_jobs=60, tasks_per_job=4)


# ---------------------------------------------------------------------------
# the stand-in for capture and replay
# ---------------------------------------------------------------------------

def _ptr(t) -> int:
    return t.untyped_storage().data_ptr()


class Audit(TorchDispatchMode):
    """Every tensor storage an op reads that no earlier op of the block
    made (``reads``), the ones the block's ops made (``made``), and the
    values of the storages it writes that were there before, to put
    back (``undo``); ``poison`` overwrites what the block made."""

    def __init__(self):
        super().__init__()
        self.reads, self.made, self.saved = set(), set(), {}
        self.outputs = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        for i, arg in enumerate(func._schema.arguments):
            v = args[i] if i < len(args) else kwargs.get(arg.name)
            for t in tree_flatten(v)[0]:
                if not isinstance(t, torch.Tensor) or t.numel() == 0:
                    continue
                p = _ptr(t)
                if p in self.made:
                    continue
                self.reads.add(p)
                written = arg.alias_info is not None \
                    and arg.alias_info.is_write
                if written and p not in self.saved:
                    self.saved[p] = (t, t.clone())
        out = func(*args, **kwargs)
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor) and t.numel() \
                    and _ptr(t) not in self.reads:
                self.made.add(_ptr(t))
                self.outputs.append(t)
        return out

    def undo(self) -> None:
        for t, was in self.saved.values():
            t.copy_(was)

    def poison(self) -> None:
        for t in self.outputs:
            t.fill_(float("nan") if t.is_floating_point()
                    else True if t.dtype == torch.bool else -7)
        self.outputs = []


class StandIn:
    """``round_graph.CudaGraphs``' methods on the CPU. A capture runs the
    body once under an ``Audit``, undoes its writes and poisons what it
    made (a CUDA capture runs nothing); a replay runs it again with spans
    off (a replay runs no Python) and writes what it returns into the
    captured outputs."""

    def __init__(self, refuse: bool = False):
        self.refuse = refuse
        self.taken, self.given, self.runs = [], [], []

    @staticmethod
    def serves(device) -> bool:
        return True

    def take_pool(self, device):
        pool = object()
        self.taken.append(pool)
        return pool, None, None

    def give_pool(self, device, pool, graph) -> None:
        self.given.append(pool[0])

    def capture(self, fn, device, pool):
        if self.refuse:
            raise RuntimeError("capture refused")
        graph = SimpleNamespace(fn=fn, out=None, pool=pool[0])
        with Audit() as audit:
            graph.out = fn()
        audit.undo()
        audit.poison()
        self.runs.append((graph, audit))
        return graph, graph.out

    def replay(self, graph, device) -> None:
        with Audit() as audit, \
                mock.patch.object(tracing, "traced",
                                  lambda *a, **k: tracing._OFF):
            new = graph.fn()
        audit.outputs = []
        self.runs.append((graph, audit))
        if isinstance(graph.out, torch.Tensor):
            graph.out.copy_(new)
        else:
            vars(graph.out).update(vars(new))

    @staticmethod
    def mark(device):
        return None

    @staticmethod
    def wait(device, mark) -> None:
        pass

    def foreign_reads(self, cache: RoundGraphs, foreign=()) -> set:
        """The storages some run read that its key owns not: neither a
        static input or carry of a kept key nor made by a run of that
        key's graphs; and any of ``foreign``'s storages read at all."""
        owned = set()
        for e in cache.keys.values():
            for d in (e.inputs or {}, e.state or {}):
                owned.update(_ptr(t) for t in d.values() if t.numel())
        made = set().union(*(a.made for _, a in self.runs))
        bad = set()
        for _, audit in self.runs:
            bad |= audit.reads - owned - made
            bad |= audit.reads & {_ptr(t) for t in foreign}
        return bad


# ---------------------------------------------------------------------------
# the policy, on a toy body
# ---------------------------------------------------------------------------

class Toy:
    """A round body: adds the derived ``2 * w`` to idle, one to each
    assigned row; admits the rows whose assigned count is odd."""

    def __init__(self, inp):
        self.w2 = inp["w"] * 2

    def run(self, st, variant):
        st.idle = st.idle + self.w2
        st.assigned = st.assigned + (1 if variant[1] else 2)
        return st.assigned % 2 == 1


def _carry(n: int) -> _State:
    z = torch.zeros
    return _State(idle=z(n), pipe=z(n), npods=z(n, dtype=torch.int32),
                  qalloc=z(1, 2), jobres=z(1, 2),
                  assigned=z(2, dtype=torch.int32),
                  kind=z(2, dtype=torch.int32),
                  excluded=z(2, dtype=torch.bool), rounds=0)


def _toy_solve(cache, w, variants, hold: bool = False):
    """Rounds of ``variants`` in one toy solve: (modes, carry, the solve's
    SolveGraphs, left open when ``hold``)."""
    inputs = {"w": w}
    sg = SolveGraphs(torch.device("cpu"), ("toy",), inputs, Toy,
                     cache=cache)
    st = _carry(len(w))
    modes = []
    for v in variants:
        got, mode = sg.round(v, st, lambda v=v: Toy(inputs).run(st, v))
        modes.append(mode)
        assert torch.equal(got, st.assigned % 2 == 1)
    if not hold:
        sg.close(st)
    return modes, st, sg


def _expect(w, variants) -> tuple:
    st = _carry(len(w))
    for v in variants:
        Toy({"w": w}).run(st, v)
    return st.idle, st.assigned


A, B = (False, True), (True, False)


def test_eager_then_capture_then_replay_per_key_and_variant():
    be = StandIn()
    cache = RoundGraphs(be)
    w1, w2 = torch.tensor([1.0, 2.0, 3.0]), torch.tensor([5.0, 0.0, -1.0])
    modes, st, _ = _toy_solve(cache, w1, [A, A, A, B])
    assert modes == ["eager", "capture", "replay", "eager"]
    want = _expect(w1, [A, A, A, B])
    assert torch.equal(st.idle, want[0])
    assert torch.equal(st.assigned, want[1])
    # a later solve at the key, on other data: the graph of A replays at
    # once, B's second call captures
    modes, st, _ = _toy_solve(cache, w2, [A, B, B, A])
    assert modes == ["replay", "capture", "replay", "replay"]
    want = _expect(w2, [A, B, B, A])
    assert torch.equal(st.idle, want[0])
    assert torch.equal(st.assigned, want[1])
    # the carry is cut loose from the key's static carry
    (e,) = cache.keys.values()
    assert all(getattr(st, f) is not e.state[f] for f in e.state)
    assert len(be.taken) == 1 and be.given == []
    assert be.foreign_reads(cache, [w1, w2]) == set()


def test_a_key_seen_once_is_never_captured():
    be = StandIn()
    cache = RoundGraphs(be)
    for n in range(2, 6):
        modes, _, _ = _toy_solve(cache, torch.ones(n), [A, B])
        assert modes == ["eager", "eager"]
    assert be.taken == [] and be.runs == []


def test_one_solve_at_a_time_holds_a_key():
    be = StandIn()
    cache = RoundGraphs(be)
    w = torch.tensor([1.0, 2.0, 3.0])
    held, st1, sg1 = _toy_solve(cache, w, [A, A], hold=True)
    assert held == ["eager", "capture"]
    # held: the other solve runs eagerly, to the right answer
    modes, st2, _ = _toy_solve(cache, w * 3, [A, A, A])
    assert modes == ["eager"] * 3
    want = _expect(w * 3, [A, A, A])
    assert torch.equal(st2.idle, want[0])
    sg1.close(st1)
    modes, _, _ = _toy_solve(cache, w, [A])
    assert modes == ["replay"]


def test_past_the_bound_the_least_recent_key_is_dropped():
    be = StandIn()
    cache = RoundGraphs(be, bound=2)
    k1, k2, k3, k4 = (torch.ones(n) for n in (3, 4, 5, 6))
    for w in (k1, k2, k1):
        _toy_solve(cache, w, [A, A])
    pool2 = be.taken[1]
    # k2 is the least recently used: k3 takes its place, its pool back
    modes, _, _ = _toy_solve(cache, k3, [A, A])
    assert modes == ["eager", "capture"]
    assert be.given == [pool2] and len(cache.keys) == 2
    _, st, sg = _toy_solve(cache, k1, [A], hold=True)
    _, st3, sg3 = _toy_solve(cache, k3, [A], hold=True)
    # both kept keys held: a new key is not kept, and runs eagerly
    modes, _, _ = _toy_solve(cache, k4, [A, A, A])
    assert modes == ["eager"] * 3 and len(cache.keys) == 2
    sg.close(st)
    sg3.close(st3)
    # a dropped key starts over
    modes, _, _ = _toy_solve(cache, k2, [A, A])
    assert modes == ["eager", "capture"]
    assert be.given == [pool2, be.taken[0]]


def test_a_capture_that_raises_leaves_the_key_eager(caplog):
    be = StandIn(refuse=True)
    cache = RoundGraphs(be)
    w = torch.tensor([1.0, 2.0, 3.0])
    with caplog.at_level(logging.WARNING, logger=round_graph.__name__):
        modes, st, _ = _toy_solve(cache, w, [A, A, A])
        modes2, _, _ = _toy_solve(cache, w, [A, B, B])
    assert modes == modes2 == ["eager"] * 3
    assert "CUDA graph capture failed" in caplog.text
    assert torch.equal(st.idle, _expect(w, [A, A, A])[0])
    assert be.given == []


def test_a_kernel_call_inside_a_capture_stays_out_of_the_graph(
        monkeypatch):
    """``solver._fused_choice`` inside a capture hands the call to the
    capture (``round_graph.outside``) with output tensors of the kernel's
    shapes; a replay makes the call as an eager round makes it, so a
    wrapper that takes the arguments by position alone still works, and
    copies its results into those tensors. Outside a capture it calls the
    kernel's wrapper as it stands when called."""
    arr, params = _arrays(4)
    a = arr.device_dict("cpu")
    p = {k: torch.as_tensor(v) for k, v in params.items()}
    fair = solver._Fairness(a, None, False, False, False)
    body = solver._RoundBody(a, p, fair, True, "pack", ("binpack", "kube"),
                             0)
    args = (body.init_req, a["node_idle"], a["node_used"],
            1.0 / a["node_alloc"], p["node_static"],
            a["task_valid"].to(torch.float32),
            torch.ones(arr.N), body.sig_feas.to(torch.int8),
            solver.pack_pars(p, arr.R), ("binpack", "kube"))
    want = solver.fused_choice(*args)
    seen = []

    def counting(*x):
        seen.append(len(x))
        return fused_choice(*x)

    monkeypatch.setattr(solver, "fused_choice", counting)
    kept = []

    def split(call, call_args, kw, outputs):
        outs = outputs()
        kept.append((call, call_args, kw, outs))
        return outs

    monkeypatch.setattr(round_graph._local, "split", split, raising=False)
    outs = solver._fused_choice(*args)
    assert seen == [] and len(kept) == 1 and kept[0][3] is outs
    round_graph.run_kept(*kept[0])
    assert seen == [len(args)]
    monkeypatch.setattr(round_graph._local, "split", None)
    for o, w in zip(outs, want):
        assert o.dtype == w.dtype and torch.equal(o, w)
    for o, w in zip(solver._fused_choice(*args), want):
        assert torch.equal(o, w)
    assert seen == [len(args)] * 2


# ---------------------------------------------------------------------------
# solve_allocate through the stand-in, on the CPU
# ---------------------------------------------------------------------------

def _arrays(seed: int):
    arr = hdrf_flatten("torch", seed, EXAMPLE, n_queues=len(EXAMPLE),
                       **SIZE)
    params = {
        "binpack_weight": np.float32(1.0),
        "binpack_res_weights": np.ones(arr.R, np.float32),
        "least_req_weight": np.float32(1.0),
        "most_req_weight": np.float32(0.0),
        "balanced_weight": np.float32(0.0),
        "node_static": np.zeros(arr.N, np.float32),
    }
    return arr, params


def _result(res) -> dict:
    return {k: getattr(res, k).cpu().numpy() for k in RESULT_KEYS}


def _assert_equal(got: dict, want: dict) -> None:
    for k in RESULT_KEYS:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (want["assigned"] >= 0).any()


def _eager(arr, params, device, kw) -> dict:
    with mock.patch.object(round_graph.GRAPHS, "serves", lambda d: False):
        return _result(solver.solve_allocate(arr.numpy_dict(), params,
                                             device=device, **kw))


class ModeLog:
    """The modes of each solve's rounds, by solve (``SolveGraphs``)."""

    def __init__(self, monkeypatch):
        self.by_solve: dict = {}
        real = SolveGraphs.round

        def logged(sg, variant, st, eager):
            got, mode = real(sg, variant, st, eager)
            self.by_solve.setdefault(id(sg), []).append(mode)
            return got, mode

        monkeypatch.setattr(SolveGraphs, "round", logged)

    def modes(self) -> list:
        return [m for ms in self.by_solve.values() for m in ms]


def _assert_graphed(log: ModeLog) -> None:
    """The first solve's first phase ran eagerly, then captured; every
    later solve replayed its first round, and replayed most of its rounds
    (a phase seen once in the first solve captures in the second)."""
    first, *later = log.by_solve.values()
    assert first[:2] == ["eager", "capture"]
    assert later and all(ms[0] == "replay" for ms in later)
    assert all(ms.count("replay") * 2 > len(ms) for ms in later[1:])


@pytest.mark.parametrize("kind", ["default", "hdrf"])
def test_stand_in_solves_equal_the_eager_solves(kind, monkeypatch):
    """Three solves at one key through the packed arena: two seeds, then
    the first again after ``invalidate()``; the first solve captures, the
    later ones replay from their first round."""
    kw = FLAGS[kind]
    be = StandIn()
    cache = RoundGraphs(be)
    cpu = torch.device("cpu")
    problems = [_arrays(seed) for seed in (4, 5, 4)]
    want = [_eager(arr, p, cpu, kw) for arr, p in problems]
    monkeypatch.setattr(round_graph, "GRAPHS", cache)
    log = ModeLog(monkeypatch)
    dc = PackedDeviceCache(device=cpu)
    arenas = []
    for i, (arr, params) in enumerate(problems):
        if i == 2:
            dc.invalidate()
        fbuf, ibuf, layout = arr.packed()
        f2d, i2d = dc.update(fbuf, ibuf, layout)
        arenas += [f2d, i2d]
        res = solver.solve_allocate_packed2d(
            f2d, i2d, layout, dc.params_device(params), **kw)
        _assert_equal(_result(res), want[i])
    assert len(cache.keys) == 1
    _assert_graphed(log)
    assert be.foreign_reads(cache, arenas) == set()


def test_a_solve_nested_in_another_at_its_key_runs_eagerly(monkeypatch):
    kw = FLAGS["hdrf"]
    cpu = torch.device("cpu")
    outer, inner = _arrays(4), _arrays(5)
    want_outer = _eager(*outer, cpu, kw)
    want_inner = _eager(*inner, cpu, kw)
    monkeypatch.setattr(round_graph, "GRAPHS", RoundGraphs(StandIn()))
    log = ModeLog(monkeypatch)
    real = solver.host_flag
    nested = {}

    def flag(x, site):
        if site == "round" and not nested and len(log.modes()) >= 3:
            nested["res"] = None
            nested["res"] = _result(solver.solve_allocate(
                inner[0].numpy_dict(), inner[1], device=cpu, **kw))
        return real(x, site)

    monkeypatch.setattr(solver, "host_flag", flag)
    got = _result(solver.solve_allocate(outer[0].numpy_dict(), outer[1],
                                        device=cpu, **kw))
    _assert_equal(got, want_outer)
    _assert_equal(nested["res"], want_inner)
    outer_modes, inner_modes = log.by_solve.values()
    assert "replay" in outer_modes and set(inner_modes) == {"eager"}


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cache = RoundGraphs()
    monkeypatch.setattr(round_graph, "GRAPHS", cache)
    yield torch.device("cuda", 0)
    cache.clear()


def _graphed(arr, params, device, kw) -> dict:
    return _result(solver.solve_allocate(arr.numpy_dict(), params,
                                         device=device, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(FLAGS))
def test_graphed_solve_equals_the_eager_solve(kind, cuda_device,
                                              monkeypatch):
    """Three solves of one problem: each equals the eager solve, and each
    launches the fused kernel (from Python, between the graph's pieces)
    as often as the eager solve does."""
    kw = FLAGS[kind]
    arr, params = _arrays(4)
    n0 = fused_choice.launches
    want = _eager(arr, params, cuda_device, kw)
    eager_launches = fused_choice.launches - n0
    log = ModeLog(monkeypatch)
    for _ in range(3):
        n0 = fused_choice.launches
        _assert_equal(_graphed(arr, params, cuda_device, kw), want)
        assert fused_choice.launches - n0 == eager_launches
    assert (eager_launches > 0) == (kind != "fused_off")
    _assert_graphed(log)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["default", "hdrf"])
def test_a_wrapper_of_the_kernel_sees_the_eager_calls(kind, cuda_device,
                                                      monkeypatch):
    """A wrapper over the solver's ``fused_choice`` (as the smoke run's
    and the benchmark's are) sees every call of a graphed solve, made with
    the arguments an eager solve makes it with: no keyword of the
    graph's own."""
    kw = FLAGS[kind]
    arr, params = _arrays(4)
    real, calls = solver.fused_choice, []

    def wrapper(*args, **call_kw):
        calls.append((len(args), tuple(sorted(call_kw))))
        return real(*args, **call_kw)

    monkeypatch.setattr(solver, "fused_choice", wrapper)
    want = _eager(arr, params, cuda_device, kw)
    eager_calls, calls[:] = list(calls), []
    assert eager_calls
    if kind == "default":
        assert set(eager_calls) == {(10, ())}
    log = ModeLog(monkeypatch)
    for _ in range(3):
        _assert_equal(_graphed(arr, params, cuda_device, kw), want)
        assert calls == eager_calls
        calls[:] = []
    _assert_graphed(log)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["default", "hdrf"])
def test_consecutive_solves_at_one_key_on_other_data(kind, cuda_device,
                                                     monkeypatch):
    """Through the card's arena: seeds 4, 5, 6, then 5 after
    ``invalidate()`` (the arena's buffers move); each equals its eager
    twin, and every solve after the first replays from its first round."""
    kw = FLAGS[kind]
    problems = [_arrays(seed) for seed in (4, 5, 6, 5)]
    want = [_eager(arr, p, cuda_device, kw) for arr, p in problems]
    assert len({str(w["assigned"]) for w in want}) == 3
    log = ModeLog(monkeypatch)
    dc = PackedDeviceCache(device=cuda_device)
    for i, (arr, params) in enumerate(problems):
        if i == 3:
            dc.invalidate()
        fbuf, ibuf, layout = arr.packed()
        f2d, i2d = dc.update(fbuf, ibuf, layout)
        res = solver.solve_allocate_packed2d(
            f2d, i2d, layout, dc.params_device(params), **kw)
        _assert_equal(_result(res), want[i])
    assert len(round_graph.GRAPHS.keys) == 1
    _assert_graphed(log)


@pytest.mark.cuda
def test_interleaved_solves_at_one_key(cuda_device, monkeypatch):
    """A solve started inside another's round loop, at the same key: the
    inner one runs eagerly while the outer holds the graphs."""
    kw = FLAGS["hdrf"]
    outer, inner = _arrays(4), _arrays(5)
    want_outer = _eager(*outer, cuda_device, kw)
    want_inner = _eager(*inner, cuda_device, kw)
    _graphed(*outer, cuda_device, kw)          # captured
    log = ModeLog(monkeypatch)
    real = solver.host_flag
    nested = {}

    def flag(x, site):
        if site == "round" and not nested and len(log.modes()) >= 3:
            nested["res"] = None
            nested["res"] = _graphed(*inner, cuda_device, kw)
        return real(x, site)

    monkeypatch.setattr(solver, "host_flag", flag)
    _assert_equal(_graphed(*outer, cuda_device, kw), want_outer)
    _assert_equal(nested["res"], want_inner)
    outer_modes, inner_modes = log.by_solve.values()
    assert set(outer_modes) == {"replay"} and set(inner_modes) == {"eager"}


def _capture_begin_raises(monkeypatch):
    def refuse(self, *args, **kw):
        raise RuntimeError("capture refused")

    monkeypatch.setattr(torch.cuda.CUDAGraph, "capture_begin", refuse)


def _capture_reads_the_host(monkeypatch):
    """A round that reads a value back to the host while its stream
    captures: the capture is invalidated, its end raises."""
    real = solver._admit_prefix

    def reading(choice, *args):
        if torch.cuda.is_current_stream_capturing():
            choice.sum().item()
        return real(choice, *args)

    monkeypatch.setattr(solver, "_admit_prefix", reading)


@pytest.mark.cuda
@pytest.mark.parametrize("refuse", [_capture_begin_raises,
                                    _capture_reads_the_host],
                         ids=["begin", "inside"])
@pytest.mark.parametrize("kind", ["default", "hdrf"])
def test_a_capture_that_raises_leaves_the_solve_eager(kind, refuse,
                                                      cuda_device,
                                                      monkeypatch, caplog):
    kw = FLAGS[kind]
    arr, params = _arrays(4)
    want = _eager(arr, params, cuda_device, kw)
    log = ModeLog(monkeypatch)
    with monkeypatch.context() as m:
        refuse(m)
        got = [_graphed(arr, params, cuda_device, kw) for _ in range(2)]
    for g in got:
        _assert_equal(g, want)
    assert set(log.modes()) == {"eager"}
    assert "CUDA graph capture failed" in caplog.text
    # the key stays eager once its capture failed
    _assert_equal(_graphed(arr, params, cuda_device, kw), want)
    assert set(log.modes()) == {"eager"}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["default", "hdrf"])
def test_replayed_rounds_open_no_order_span(kind, cuda_device):
    kw = FLAGS[kind]
    arr, params = _arrays(4)
    for _ in range(2):
        _graphed(arr, params, cuda_device, kw)
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        _graphed(arr, params, cuda_device, kw)
    spans = tracing.spans()
    tracing.clear()
    rounds = {s.id: s for s in spans if s.name == "vc.round"}
    orders = [s for s in spans if s.name == "vc.round.order"]
    replayed = [s for s in rounds.values() if s.attrs["graph"] == "replay"]
    assert replayed and len(replayed) * 2 > len(rounds)
    assert len(orders) == len(rounds) - len(replayed)
    assert all(rounds[o.parent].attrs["graph"] != "replay" for o in orders)
