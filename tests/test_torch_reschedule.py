"""The port's global rescheduler (volcano_tpu_torch.reschedule) and its
elect / reserve actions against the JAX package's, on the CPU.

- Plan bounding: the scenarios of tests/test_reschedule.py::
  TestPlanBounding through both packages' ``build_plan``: equal plans
  (summary and selected moves) and equal stranded fractions.
- The action: the scenarios of TestRescheduleAction through both
  packages' Schedulers on the same fragmented store: the same evicted
  pods with the same eviction messages, the same ``reschedule_log``
  record (apart from its wall-clock ``solve_ms``), the same
  ``reschedule_*`` timing keys and skip reasons. The JAX Scheduler runs op
  by op (``jax.disable_jit``: XLA's CPU jit contracts FMAs, see
  test_torch_solver.py); the port runs on a CPU cache (``device="cpu"``).
- The chip phase's layout (chip_smoke.defrag_store) cut to 60 nodes: the
  JAX package executes 3 moves off the hole, fragmentation 1.0 -> 0.9333,
  and the port does the same.
- The migration-intent journal: TestMigrationIntentJournal through both
  packages' journals and reconciliation, and TestKillTheLeaderMidMigration
  (a leader crashing between its journaled wave and its evictions; a
  deposed leader's journal fenced) through both packages' elector, bind
  journal and fencing.
- elect then reserve (tests/test_preempt_reclaim.py::TestElectReserve)
  through both packages.
- Failures on a CPU arena: an armed ``reschedule_dispatch`` and a solve
  that fails after the arena's scatter each count one breaker failure,
  invalidate the action's arena, skip the pass with ``solve_failed`` and
  evict nothing, with no host solve; an open breaker skips with
  ``skipped_breaker`` before any device work; the action's arena sits on
  the cache's device.

Tolerance: exact — plans and evictions are integer decisions. The tests
marked ``cuda`` run chip_smoke.py's reschedule phase at a small size on
the card (they skip without a GPU); this module imports JAX only inside
the tests that need it, so there they run with ``python -m pytest
--noconftest -m cuda tests/test_torch_reschedule.py``.
"""

from __future__ import annotations

import pytest
import torch

import chip_smoke
from torch_helpers import (
    build_node, build_pod, build_pod_group, build_queue, pkg_mod,
)

PKGS = ("jax", "torch")
GiB = 1 << 30


@pytest.fixture(autouse=True)
def _clean_faults():
    for pkg in PKGS:
        pkg_mod(pkg, "resilience").faults.reset()
    yield
    for pkg in PKGS:
        pkg_mod(pkg, "resilience").faults.reset()


def _run(pkg, fn):
    """fn() for the port; under ``jax.disable_jit`` for the JAX package."""
    if pkg == "torch":
        return fn()
    import jax
    with jax.disable_jit():
        return fn()


# ---------------------------------------------------------------------------
# plan bounding (pure host)
# ---------------------------------------------------------------------------

def mk(pkg, key, job, frm, to, cpu, mem=1.0):
    ns, name = key.split("/")
    return pkg_mod(pkg, "reschedule").MoveCandidate(
        key=key, namespace=ns, name=name, job_uid=job, from_node=frm,
        to_node=to, cpu=cpu, mem=mem)


FREE = {"n0": (4000.0, 64 * GiB), "n1": (4000.0, 64 * GiB),
        "n2": (4000.0, 64 * GiB)}
PAIR = [("t/a-0", "ja", "n0", "n1", 2000.0), ("t/b-0", "jb", "n0", "n2",
                                              2000.0)]
WITH_LONG = [("t/long-0", "jl", "n0", "n1", 4000.0)] + PAIR
BASE = dict(max_moves=8, max_disruption_per_job=1, min_improvement=0.01,
            ref_cpu=8000.0)

#: TestPlanBounding's build_plan scenarios: a list of (candidates, free,
#: keyword overrides) calls each
PLAN_SCENARIOS = {
    "hole_punched_within_budget_and_caps": [(PAIR, FREE, {})],
    "budget_exhausted_rejects_whole_plan": [(PAIR, FREE,
                                             {"max_moves": 1})],
    "per_job_cap_blocks_gang_shredding": [
        (cands, FREE, {"max_disruption_per_job": cap})
        for cands in ([("t/a-0", "ja", "n0", "n1", 2000.0),
                       ("t/a-1", "ja", "n0", "n2", 2000.0)],)
        for cap in (1, 2)],
    "noop_churn_rejected_by_min_improvement": [
        (PAIR, FREE, {"min_improvement": 1.5})],
    "healthy_cluster_rejected_as_fits": [
        (PAIR, dict(FREE, n2=(9000.0, 64 * GiB)), {})],
    "empty_and_zero_budget": [([], FREE, {}),
                              (PAIR, FREE, {"max_moves": 0})],
    "landing_feasibility_prevents_boomerang": [
        (PAIR, {"n0": (4000.0, 64 * GiB), "n1": (1000.0, 64 * GiB),
                "n2": (1000.0, 64 * GiB)}, {})],
    "smallest_movers_preferred": [(WITH_LONG, FREE, {})],
    "biggest_fallback_when_budget_starves_small_movers": [
        (WITH_LONG, FREE, {"max_moves": 1})],
    "unpinned_site_choice_is_cheapest": [
        ([("t/a-0", "ja", "n0", "n2", 2000.0),
          ("t/b-0", "jb", "n0", "n2", 2000.0),
          ("t/c-0", "jc", "n1", "n2", 2000.0)],
         {"n0": (4000.0, 64 * GiB), "n1": (6000.0, 64 * GiB),
          "n2": (6000.0, 64 * GiB)}, {})],
}


def _plan(pkg, cands, free, kw):
    plan = pkg_mod(pkg, "reschedule").build_plan(
        [mk(pkg, *c) for c in cands], free, **dict(BASE, **kw))
    return plan.summary(), [(m.key, m.to_node) for m in plan.moves], \
        plan.improvement


@pytest.mark.parametrize("name", sorted(PLAN_SCENARIOS))
def test_build_plan_equals_jax(name):
    for cands, free, kw in PLAN_SCENARIOS[name]:
        t = _plan("torch", cands, free, kw)
        assert t == _plan("jax", cands, free, kw), (name, kw)
    # the scenario's own verdict, as tests/test_reschedule.py states it
    verdict = {"budget_exhausted_rejects_whole_plan": "no_hole",
               "noop_churn_rejected_by_min_improvement": "no_gain",
               "healthy_cluster_rejected_as_fits": "fits",
               "empty_and_zero_budget": "budget",
               "landing_feasibility_prevents_boomerang": "no_hole"}
    assert t[0]["rejected"] == verdict.get(name), t


def test_stranded_fraction_equals_jax():
    cases = [([4000, 4000], 8000), ([8000, 0], 8000), ([], 8000),
             ([4000, 4000], 0), ([6000, 2000], 4000)]
    t, j = pkg_mod("torch", "reschedule"), pkg_mod("jax", "reschedule")
    got = [t.stranded_fraction(f, r) for f, r in cases]
    assert got == [j.stranded_fraction(f, r) for f, r in cases]
    assert got == [1.0, 0.0, 0.0, 0.0, 0.25]
    assert t.largest_free_slot([3.0, 9.0]) == j.largest_free_slot(
        [3.0, 9.0]) == 9.0
    assert t.largest_free_slot([]) == j.largest_free_slot([]) == 0.0
    assert t.MIGRATION_REASON == j.MIGRATION_REASON


# ---------------------------------------------------------------------------
# the action on a small fragmented cluster, through both Schedulers
# ---------------------------------------------------------------------------

RESCHED_CONF = chip_smoke.RESCHED_CONF


def fragmented_store(pkg, same_job_pairs: bool = False):
    """tests/test_reschedule.py's _fragmented_store from ``pkg``'s models:
    3 x 8cpu nodes, each holding 2 x 2cpu running tasks (free 4cpu
    everywhere), plus one pending 8cpu job. With ``same_job_pairs`` each
    node's two tasks belong to ONE gang job."""
    m = pkg_mod(pkg, "models")
    ann = pkg_mod(pkg, "api").POD_GROUP_ANNOTATION
    store = pkg_mod(pkg, "client").ClusterStore()
    store.apply("queues", build_queue(m, "q0", weight=1))
    for i in range(3):
        store.create("nodes", build_node(m, f"n{i}", {"cpu": "8",
                                                      "memory": "32Gi"}))
    pairs = [("a", "b"), ("c", "d"), ("e", "f")]
    if same_job_pairs:
        pairs = [("a", "a"), ("c", "c"), ("e", "e")]
    for i, (j1, j2) in enumerate(pairs):
        for k, jn in enumerate((j1, j2)):
            pg_name = f"j{jn}"
            if store.try_get("podgroups", pg_name, "t") is None:
                members = 2 if j1 == j2 else 1
                store.create("podgroups", build_pod_group(
                    m, pg_name, "t", members, "q0",
                    phase=m.PodGroupPhase.RUNNING))
            store.create("pods", build_pod(
                m, ann, "t", f"{jn}-{k}" if j1 == j2 else f"{jn}-0",
                f"n{i}", "Running", {"cpu": "2", "memory": "4Gi"},
                pg_name))
    store.create("podgroups", build_pod_group(
        m, "jg", "t", 1, "q0", phase=m.PodGroupPhase.INQUEUE))
    store.create("pods", build_pod(
        m, ann, "t", "g-0", "", "Pending", {"cpu": "8", "memory": "8Gi"},
        "jg"))
    return store


def resched_scheduler(pkg, store, moves=8, cap=1, imp=0.01, interval=1):
    kw = {"device": "cpu"} if pkg == "torch" else {}
    cache = pkg_mod(pkg, "cache").SchedulerCache(store, **kw)
    cache.run()
    conf = RESCHED_CONF.format(moves=moves, cap=cap, imp=imp).replace(
        "reschedule.interval: 1", f"reschedule.interval: {interval}")
    sched = pkg_mod(pkg, "scheduler").Scheduler(cache, scheduler_conf=conf)
    return cache, sched


def outcome(pkg, cache, sched, store, namespace="t"):
    """What a pass decided: evicted pods with their eviction messages,
    the plan records without their wall-clock solve_ms, and the
    reschedule_* timing keys with the values of those that are not
    wall-clock times."""
    evicted = []
    for p in store.list("pods", namespace=namespace):
        if p.deletion_timestamp is not None:
            msgs = [c.get("message") for c in p.conditions
                    if c.get("reason") == "Evict"]
            evicted.append((p.name, p.node_name, msgs[-1]))
    records = [{k: v for k, v in r.items() if k != "solve_ms"}
               for r in cache.reschedule_log]
    timing = {k: (None if k.endswith("_ms") else v)
              for k, v in sched.last_cycle_timing.items()
              if k.startswith("reschedule_")}
    return sorted(evicted), records, timing


#: TestRescheduleAction's scenarios: (store options, conf knobs, cycles)
ACTION_SCENARIOS = {
    "hole_punched_on_device_and_evictions_fenced_off": ({}, {}, 1),
    "budget_too_small_rejects_whole_plan": ({}, {"moves": 1}, 1),
    "per_job_cap_skips_pass_without_device_work": (
        {"same_job_pairs": True}, {"cap": 1}, 1),
    "min_improvement_rejects_noop_churn": ({}, {"imp": 1.5}, 1),
    "healthy_cluster_skips_before_the_solve": ({"extra_node": True}, {},
                                               1),
    "interval_gates_passes": ({}, {"interval": 3}, 2),
}


@pytest.mark.parametrize("name", sorted(ACTION_SCENARIOS))
def test_reschedule_action_equals_jax(name):
    store_kw, knobs, cycles = ACTION_SCENARIOS[name]
    got = {}
    for pkg in PKGS:
        store = fragmented_store(pkg, store_kw.get("same_job_pairs", False))
        if store_kw.get("extra_node"):
            store.create("nodes", build_node(
                pkg_mod(pkg, "models"), "n3", {"cpu": "8",
                                               "memory": "32Gi"}))
        cache, sched = resched_scheduler(pkg, store, **knobs)
        per_cycle = []
        for _ in range(cycles):
            _run(pkg, sched.run_once)
            per_cycle.append(outcome(pkg, cache, sched, store))
        got[pkg] = per_cycle
    assert got["torch"] == got["jax"]
    evicted, records, timing = got["torch"][0]
    # the scenario's verdict, as tests/test_reschedule.py states it
    if name.startswith("hole_punched") or name == "interval_gates_passes":
        assert [e[0] for e in evicted] == ["a-0", "b-0"]
        assert all(e[2].startswith("reschedule") for e in evicted)
        assert records[-1]["hole_node"] == "n0"
        assert records[-1]["executed"] == 2
        assert timing["reschedule_moves_executed"] == 2.0
    else:
        assert evicted == []
    if name == "interval_gates_passes":
        assert got["torch"][1][2]["reschedule_skipped"] == "interval"
        assert got["torch"][1][0] == evicted
    skip = {"per_job_cap_skips_pass_without_device_work": "no_hole",
            "healthy_cluster_skips_before_the_solve": "fits"}.get(name)
    assert timing.get("reschedule_skipped") == skip
    if skip:
        assert records == []
    rejected = {"budget_too_small_rejects_whole_plan": "no_hole",
                "min_improvement_rejects_noop_churn": "no_gain"}.get(name)
    if rejected:
        assert records[-1]["rejected"] == rejected


def test_chip_layout_cut_to_60_nodes_equals_jax():
    """chip_smoke.py's reschedule layout at 60 nodes (420 pods of 4 cpu in
    42 gangs of 10, pod p on node p % 60 and in gang p % 42, one pending
    16-cpu pod), maxMoves 8, maxDisruptionPerJob 2, minImprovement 0.01:
    both packages execute the same 3 moves off the hole n00000."""
    sc = dict(chip_smoke.RESCHED, **chip_smoke.RESCHED["small"])
    got = {}
    for pkg in PKGS:
        store = pkg_mod(pkg, "client").ClusterStore()
        chip_smoke.defrag_store(store, pkg_mod(pkg, "models"),
                                pkg_mod(pkg, "api").POD_GROUP_ANNOTATION,
                                sc["n_nodes"], sc["n_gangs"])
        cache, sched = resched_scheduler(
            pkg, store, moves=sc["max_moves"], cap=sc["max_disruption"],
            imp=sc["min_improvement"])
        _run(pkg, sched.run_once)
        got[pkg] = outcome(pkg, cache, sched, store, namespace="defrag")
    assert got["torch"] == got["jax"]
    evicted, (rec,), timing = got["torch"]
    assert len(evicted) == 3 and {e[1] for e in evicted} == {"n00000"}
    assert rec["hole_node"] == "n00000" and rec["executed"] == 3
    assert rec["frag_before"] == 1.0 and rec["frag_after"] == 0.933333
    assert rec["max_disruption"] <= 2 and rec["rejected"] is None
    assert "reschedule_skipped" not in timing


# ---------------------------------------------------------------------------
# migration-intent journal + takeover reconciliation
# ---------------------------------------------------------------------------

def _journal_moves(pkg):
    return [mk(pkg, "t/a-0", "ja", "n0", "n1", 2000.0),
            mk(pkg, "t/b-0", "jb", "n0", "n2", 2000.0)]


def _land_eviction(store, name):
    pod = store.get("pods", name, "t")
    pod.deletion_timestamp = 1.0
    store.update("pods", pod)


def _journal_scenario(pkg, scenario):
    store = fragmented_store(pkg)
    rs = pkg_mod(pkg, "reschedule")
    journal = rs.MigrationIntentJournal(store, identity="A")
    intent = journal.record(_journal_moves(pkg))
    out = [store.get("migrationintents", intent.name).moves]
    if scenario == "record_then_sweep_confirms_once_pods_gone":
        out.append(journal.sweep())
        for name in ("a-0", "b-0"):
            _land_eviction(store, name)
        out.append(journal.sweep())
    elif scenario == "stale_intent_swept_after_two_generations":
        out += [journal.sweep(), journal.sweep()]
    else:
        _land_eviction(store, "a-0")
        out.append(rs.reconcile_migration_intents(store))
        out.append(store.get("pods", "b-0", "t").deletion_timestamp)
    out.append(store.try_get("migrationintents", intent.name))
    out.append(store.list("migrationintents"))
    return out


@pytest.mark.parametrize("scenario", [
    "record_then_sweep_confirms_once_pods_gone",
    "stale_intent_swept_after_two_generations",
    "reconcile_settles_and_abandons_against_pod_truth"])
def test_migration_intent_journal_equals_jax(scenario):
    got = _journal_scenario("torch", scenario)
    assert got == _journal_scenario("jax", scenario)
    assert got[0] == [["t", "a-0", "n0", "n1"], ["t", "b-0", "n0", "n2"]]
    assert got[-2] is None and got[-1] == []
    if scenario.startswith("record"):
        assert got[1:3] == [0, 1]
    elif scenario.startswith("stale"):
        assert got[1:3] == [0, 1]
    else:
        assert got[1] == {"intents": 1, "settled": 1, "abandoned": 1}
        assert got[2] is None   # the abandoned eviction is not re-driven


# ---------------------------------------------------------------------------
# elect then reserve
# ---------------------------------------------------------------------------

def _elect_reserve(pkg):
    m = pkg_mod(pkg, "models")
    reservation = pkg_mod(pkg, "utils.scheduler_helper").reservation
    conf = pkg_mod(pkg, "conf")
    fw = pkg_mod(pkg, "framework")
    reservation.reset()
    store = pkg_mod(pkg, "client").ClusterStore()
    kw = {"device": "cpu"} if pkg == "torch" else {}
    cache_mod = pkg_mod(pkg, "cache")
    cache = cache_mod.SchedulerCache(store, **kw)
    cache.binder = cache_mod.FakeBinder()
    cache.evictor = cache_mod.FakeEvictor()
    cache.run()
    store.apply("queues", build_queue(m, "default"))
    for name, cpu, mem in (("n1", "4", "8Gi"), ("n2", "8", "16Gi")):
        store.create("nodes", build_node(m, name, {"cpu": cpu,
                                                   "memory": mem}))
    store.create("podgroups", build_pod_group(
        m, "pg1", "c1", 1, "default", phase=m.PodGroupPhase.PENDING))
    store.create("pods", build_pod(
        m, pkg_mod(pkg, "api").POD_GROUP_ANNOTATION, "c1", "p1", "",
        "Pending", {"cpu": "1", "memory": "1Gi"}, "pg1"))
    tiers = [conf.Tier(plugins=[conf.PluginOption(name="reservation"),
                                conf.PluginOption(name="gang")])]
    ssn = fw.open_session(cache, tiers)
    try:
        fw.get_action("elect").execute(ssn)
        target = reservation.target_job
        elected = target.name if target is not None else None
        fw.get_action("reserve").execute(ssn)
        return elected, sorted(reservation.locked_nodes)
    finally:
        fw.close_session(ssn)
        reservation.reset()


def test_elect_then_reserve_locks_node_equals_jax():
    got = _elect_reserve("torch")
    assert got == _elect_reserve("jax")
    assert got == ("pg1", ["n2"])   # the max-idle node is locked


# ---------------------------------------------------------------------------
# kill the leader mid-migration (tests/test_reschedule.py::
# TestKillTheLeaderMidMigration)
# ---------------------------------------------------------------------------

class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _evicted(store):
    return sorted(p.name for p in store.list("pods", namespace="t")
                  if p.deletion_timestamp is not None)


def _leader(pkg, store, identity, clock):
    le = pkg_mod(pkg, "utils.leader_election")
    elector = le.LeaderElector(le.LeaseLock(store, "volcano"),
                               identity=identity, lease_duration=10.0,
                               clock=clock)
    assert elector.step()
    return elector


def _fenced_scheduler(pkg, store, elector, clock):
    """A scheduler whose writes carry ``elector``'s token and whose binds
    are journaled, as Scheduler.run_with_leader_election wires it."""
    cache, sched = resched_scheduler(pkg, store)
    cache.install_fencing(elector.fencing_token)
    cache.bind_journal = pkg_mod(pkg, "resilience").BindIntentJournal(
        cache.fenced_cluster, identity=elector.identity, clock=clock)
    return sched


def _crash_between_journal_and_evictions(pkg):
    """The leader crashes after the wave's migration intent is durable
    and before any eviction dispatches: the successor abandons the wave
    (never re-drives a stale eviction), pod truth is untouched — zero
    lost, zero duplicate binds — and its own pass re-solves."""
    clock = FakeClock()
    store = fragmented_store(pkg)
    store.clock = clock
    binds_before = {p.name: p.node_name
                    for p in store.list("pods", namespace="t")}
    faults = pkg_mod(pkg, "resilience").faults
    sched_a = _fenced_scheduler(pkg, store, _leader(pkg, store, "A", clock),
                                clock)
    faults.arm("migration_commit", at=(1,))
    try:
        _run(pkg, sched_a.run_once)   # FaultError contained by the action
    finally:
        faults.reset()
    out = [len(store.list("migrationintents")), _evicted(store)]
    clock.t += 11   # A crashes; B takes over past lease expiry
    eb = _leader(pkg, store, "B", clock)
    out.append(pkg_mod(pkg, "reschedule").reconcile_migration_intents(
        store, eb.fencing_token))
    out += [store.list("migrationintents"),
            {p.name: p.node_name
             for p in store.list("pods", namespace="t")} == binds_before,
            _evicted(store)]
    _run(pkg, _fenced_scheduler(pkg, store, eb, clock).run_once)
    out += [_evicted(store), len(store.list("migrationintents"))]
    return out


def _deposed_leader_cannot_journal(pkg):
    clock = FakeClock()
    store = fragmented_store(pkg)
    store.clock = clock
    ea = _leader(pkg, store, "A", clock)
    client = pkg_mod(pkg, "client")
    journal = pkg_mod(pkg, "reschedule").MigrationIntentJournal(
        client.FencedStore(store, ea.fencing_token), identity="A",
        clock=clock)
    clock.t += 11
    _leader(pkg, store, "B", clock)
    with pytest.raises(client.FencedError):
        journal.record([mk(pkg, "t/a-0", "ja", "n0", "n1", 2000.0)])
    return store.list("migrationintents")


def test_crash_between_journal_and_evictions_abandons_cleanly_equals_jax():
    got = _crash_between_journal_and_evictions("torch")
    assert got == _crash_between_journal_and_evictions("jax")
    assert got == [1, [], {"intents": 1, "settled": 0, "abandoned": 2},
                   [], True, [], ["a-0", "b-0"], 1]


def test_deposed_leader_cannot_journal_new_waves_equals_jax():
    assert _deposed_leader_cannot_journal("torch") == []
    assert _deposed_leader_cannot_journal("jax") == []


# ---------------------------------------------------------------------------
# the Scheduler's reschedule flags
# ---------------------------------------------------------------------------

def test_reschedule_interval_flag_appends_the_action():
    ts = pkg_mod("torch", "scheduler")
    assert ts.UNPORTED_ACTIONS == {}
    store = fragmented_store("torch")
    cache = pkg_mod("torch", "cache").SchedulerCache(store, device="cpu")
    cache.run()
    sched = ts.Scheduler(cache, reschedule_interval=1,
                         reschedule_max_disruption=1,
                         reschedule_min_improvement=0.01)
    names = [a.name() for a in sched.actions]
    assert names[-1] == "reschedule" and names.count("reschedule") == 1
    assert cache.reschedule_opts == {"interval": 1,
                                     "max_disruption_per_job": 1,
                                     "min_improvement": 0.01}
    sched.run_once()
    assert cache.reschedule_log[-1]["executed"] == 2
    # a conf that names the action keeps its own placement
    conf = 'actions: "reschedule, allocate"'
    sched = ts.Scheduler(cache, scheduler_conf=conf, reschedule_interval=5)
    assert [a.name() for a in sched.actions] == ["reschedule", "allocate"]
    assert cache.reschedule_opts["interval"] == 5


# ---------------------------------------------------------------------------
# failures on a CPU arena: no host solve, the arena invalidated
# ---------------------------------------------------------------------------

class _SolveSpy:
    """Counts the defrag solve's packed solves and records, per call,
    whether the arena had just scattered a delta (dirty chunks, no full
    ship); ``fail`` makes each call raise after that scatter landed."""

    def __init__(self, monkeypatch, fail=False, cache=None):
        self.calls, self.after_delta = 0, []
        solver = pkg_mod("torch", "ops.solver")
        real = solver.solve_allocate_packed2d

        def spy(*a, **k):
            self.calls += 1
            if cache is not None:
                dc = cache.reschedule_state.device_cache
                self.after_delta.append(
                    not dc.last_full_ship and dc.last_shipped_chunks > 0)
            if fail:
                raise RuntimeError("injected device failure after the "
                                   "scatter")
            return real(*a, **k)

        monkeypatch.setattr(solver, "solve_allocate_packed2d", spy)


@pytest.mark.parametrize("failure", ["dispatch_fault", "after_scatter"])
def test_failed_solve_skips_without_host_solve(failure, monkeypatch):
    """A good pass (full ship, a-0 and b-0 evicted), then a pass whose
    solve fails: before the dispatch (an armed ``reschedule_dispatch``)
    or after the arena scattered that pass's delta in place. Either way:
    one breaker failure, the arena invalidated, the pass skipped with
    ``solve_failed``, no record, no eviction and no second solve. The
    next pass re-ships the arena whole."""
    store = fragmented_store("torch")
    cache, sched = resched_scheduler("torch", store)
    sched.run_once()
    dc = cache.reschedule_state.device_cache
    first = outcome("torch", cache, sched, store)[0]
    assert [e[0] for e in first] == ["a-0", "b-0"] and dc.full_ships == 1
    spy = _SolveSpy(monkeypatch, fail=failure == "after_scatter",
                    cache=cache)
    if failure == "dispatch_fault":
        pkg_mod("torch", "resilience").faults.arm_once(
            "reschedule_dispatch")
    sched.run_once()
    t = sched.last_cycle_timing
    assert t["reschedule_skipped"] == "solve_failed"
    assert "reschedule_error" not in t
    assert cache.breaker._consecutive_failures == 1
    assert dc.invalidations == 1 and dc._dev_f is None
    assert len(cache.reschedule_log) == 1
    assert outcome("torch", cache, sched, store)[0] == first
    # the fault fires before the dispatch; the failure after the scatter
    # reached the one solve, and nothing ran a second (host) solve
    assert spy.after_delta == ([True] if failure == "after_scatter"
                               else [])
    monkeypatch.undo()
    sched.run_once()
    assert "reschedule_skipped" not in sched.last_cycle_timing
    assert dc.last_full_ship and dc.full_ships == 2
    assert cache.breaker._consecutive_failures == 0


def test_open_breaker_skips_before_device_work(monkeypatch):
    store = fragmented_store("torch")
    cache, sched = resched_scheduler("torch", store)
    spy = _SolveSpy(monkeypatch)
    for _ in range(cache.breaker.failure_threshold):
        cache.breaker.record_failure()
    assert not cache.breaker.allow()
    sched.run_once()
    assert sched.last_cycle_timing["reschedule_skipped"] == \
        "skipped_breaker"
    assert spy.calls == 0
    assert cache.reschedule_state.device_cache is None
    assert cache.reschedule_state.flatten_cache is None
    assert outcome("torch", cache, sched, store)[0] == []


def test_action_arena_sits_on_the_cache_device():
    store = fragmented_store("torch")
    cache, sched = resched_scheduler("torch", store)
    sched.run_once()
    dc = cache.reschedule_state.device_cache
    assert dc is not cache.device_cache
    assert dc.device == cache.device and dc.device.type == "cpu"
    assert dc._dev_f.device.type == "cpu" and dc.full_ships == 1
    assert cache.reschedule_state.rounds >= 1


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_defrag_solve_launches_equal_plain_on_card(cuda_device):
    """chip_smoke.py's reschedule phase on the 60-node layout: every
    fused_choice launch of the defrag solve held bit for bit against the
    plain version, the plan executed, and the same pass on the host
    evicting the same pods."""
    sc = dict(chip_smoke.RESCHED["small"], expect=None,
              proposed_reference=None, small=dict(n_nodes=30, n_gangs=21))
    out = chip_smoke.phase_reschedule(cuda_device, sc)
    first = out["first"]
    assert first["launches"] > 0
    assert first["record"]["executed"] == 3
    assert first["arena_device"] == str(cuda_device)
