"""The World's books and the replay's state stay what the store holds.

A World on the tiny evicting configuration (``evict_fixture/``) places
low-priority jobs Running, submits a high-priority gang, and runs cycles
that evict; then the traffic's kubelet and job controller calls
(``release`` with and without ``recreate``, ``report_running``) and a
completion. After each step the World's bound-gang books, its binding and
releasing pods and its ``ClusterState`` agree with the store, and the
state replayed from the recorded events (``apply_event``) and decisions
(``apply_decisions``), as the check replays it, equals the World's.
Beside: the default reference refuses what it does not write out, and
``start_violations`` holds a placed gang between its ``min_member`` and
its size."""

import copy
import json
import os
import sys

import pytest

from tiny import REPO

sys.path.insert(0, REPO)

from benchmark import check  # noqa: E402
from benchmark import reference  # noqa: E402
from benchmark.reference.resource import parse_request  # noqa: E402
from benchmark.world import (  # noqa: E402
    GangSpec, World, apply_decisions, apply_event,
)

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "evict_fixture")
LOW = {"cpu": "1024m", "memory": "4Gi"}
WHOLE = {"cpu": "4096m", "memory": "16Gi"}


def evict_config() -> dict:
    with open(os.path.join(FIXTURE, "evict-tiny.json")) as f:
        return json.load(f)


def assert_books(w: World) -> None:
    """The World's books and state against the store."""
    st = w.state
    stored = {p.name: p for p in w.store.list("pods", namespace=w.ns)}
    pods = {pod: uid for g in st.gangs.values()
            for pod, uid in zip(g.pods, g.pod_uids)}
    assert {n: p.uid for n, p in stored.items()} == pods
    # an evicted pod runs on in the store (the evictor writes nothing)
    # until it is released
    on = st.running | st.releasing
    assert {n: p.node_name for n, p in stored.items()
            if p.phase == "Running"} == {p: st.placed[p] for p in on}
    assert all(p.node_name == "" and p.phase == "Pending"
               for n, p in stored.items() if n not in on)
    assert set(w.binding) == set(st.placed) - st.running - st.releasing
    assert set(w.releasing) == st.releasing
    assert st.running.isdisjoint(st.releasing)
    assert set(w.gangs) == set(st.gangs)
    for name, g in st.gangs.items():
        n = sum(p in st.placed for p in g.pods)
        assert w._nbound.get(name, 0) == n, name
        assert (name in w.bound_gangs()) == (n == len(g.pods)), name
    assert {p.name for p in w.store.list("podgroups", namespace=w.ns)} \
        == set(st.gangs)


def assert_replay(w: World, start, first: int) -> None:
    """The check's replay from ``start`` over cycles ``first``.. equals
    the World's state."""
    state = copy.deepcopy(start)
    for c in w.cycles[first:]:
        for ev in c.events:
            apply_event(state, ev, w.records)
        binds = {k: n for cyc, k, n, _ in w.binder.records if cyc == c.index}
        evicted = [k for cyc, k, _, _ in w.evictor.records if cyc == c.index]
        apply_decisions(state, binds, evicted)
    def gangs(st):
        return {n: (g.queue, g.min_member, g.pods, g.pod_uids,
                    (g.req.cpu, g.req.mem, g.req.sc), g.ct, g.priority)
                for n, g in st.gangs.items()}

    assert gangs(state) == gangs(w.state)
    for field in ("placed", "running", "releasing"):
        assert getattr(state, field) == getattr(w.state, field), field


def test_release_and_report_keep_the_books(tmp_path):
    w = World(evict_config(), "cpu", str(tmp_path / "build"))
    for j in range(8):
        w.place(GangSpec(f"low{j}", "batch", 4, 1, dict(LOW), 1.0 + j,
                         "low-priority"), [f"n{j}"] * 4)
    assert_books(w)
    start, first = w.snapshot(), len(w.cycles)
    c = w.begin()
    w.submit(GangSpec("h0", "batch", 2, 2, dict(WHOLE), 100.0,
                      "high-priority"))
    w.run(c)
    assert c.failure is None
    evicted = [k for cyc, k, _, _ in w.evictor.records if cyc == c.index]
    assert len(evicted) == 8 and len(w.releasing) == 8
    assert_books(w)
    # a kubelet's end of the evicted pods: one gone for good, the rest
    # remade Pending under their gangs
    c = w.begin()
    gone, *remade = list(w.releasing)
    w.release(gone, recreate=False)
    for pod in remade:
        w.release(pod)
    assert_books(w)
    assert gone not in w.state.gangs[gone.rsplit("-", 1)[0]].pods
    w.run(c)
    assert c.failure is None and w.binding
    assert_books(w)
    # the binds reported Running, then a placed gang finishes
    c = w.begin()
    w.report_running(list(w.binding))
    assert not w.binding
    assert_books(w)
    done = next(g for g in w.bound_gangs() if g.startswith("low"))
    w.complete(done)
    assert_books(w)
    w.run(c)
    assert_books(w)
    assert_replay(w, start, first)
    # what the World refuses: a report of a pod that is not binding
    with pytest.raises(ValueError):
        w.report_running([next(iter(w.state.running))])


def test_the_default_reference_refuses_what_it_leaves_out():
    cfg = evict_config()
    with pytest.raises(reference.Unsupported):
        reference.parse(cfg["conf"])
    with open(os.path.join(REPO, "benchmark", "configs",
                           "default-2k.json")) as f:
        conf = reference.parse(json.load(f)["conf"])
    alloc = parse_request({"cpu": "4", "memory": "16Gi", "pods": "110"})
    req = parse_request({"cpu": "1", "memory": "1Gi"})

    def state():
        st = reference.ClusterState(
            "bench", [reference.Node("n0", alloc, 110)],
            [reference.Queue("q0", 1)])
        st.gangs["g"] = reference.Gang("g", "q0", 2, ["g-0", "g-1"],
                                       ["g-0000", "g-0001"], req, 1.0)
        return st

    assert len(reference.cycle_decisions(state(), conf)[0]) == 2
    st = state()
    st.queues[0].capability = parse_request({"cpu": "2"})
    with pytest.raises(reference.Unsupported):
        reference.cycle_decisions(st, conf)
    st = state()
    st.placed["g-0"] = "n0"
    st.releasing.add("g-0")
    with pytest.raises(reference.Unsupported):
        reference.cycle_decisions(st, conf)


@pytest.mark.parametrize("placed,bad", [(0, 0), (1, 1), (2, 0), (4, 0)])
def test_start_violations_hold_a_gang_to_min_member(placed, bad):
    alloc = parse_request({"cpu": "64", "memory": "64Gi", "pods": "110"})
    st = reference.ClusterState("bench", [reference.Node("n0", alloc, 110)],
                                [reference.Queue("q0", 1)])
    pods = [f"g-{i}" for i in range(4)]
    st.gangs["g"] = reference.Gang("g", "q0", 2, pods, list(pods),
                                   parse_request({"cpu": "1"}), 1.0)
    for p in pods[:placed]:
        st.placed[p] = "n0"
    assert check.start_violations(st) == bad
