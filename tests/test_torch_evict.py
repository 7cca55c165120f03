"""The port's eviction path (volcano_tpu_torch.ops.evict, actions/
evict_solver.py and the preempt and reclaim actions) against the JAX
package's, on the CPU.

- ``solve_evict`` (one step per claimer task) and ``solve_evict_uniform``
  (one step per claimer job) on the corpus of tests/test_evict_fuzz.py,
  each with preempt's and with reclaim's flags: identical ``assigned``,
  ``evicted_by``, ``job_placed`` and ``compact``. The corpus holds valid
  nodes with no victim row at all (empty segments); a hand-built problem
  puts the only fitting node there.
- ``absorb_counts`` and ``spread_counts`` on seeded vectors with tied
  scores; ``pack_victim_arrays`` and the uniform solve on
  tests/test_preempt_reclaim.py's minimality cluster.
- The scenarios of tests/test_preempt_reclaim.py through each package's
  preempt or reclaim action, in solver and in host mode: the same
  evictions in the same order and the same pipelines.
- Scheduler cycles under ``enqueue, allocate, preempt, reclaim,
  backfill``: the same evictions, pipelines and binds cycle by cycle, the
  evicted pods deleted between cycles as a kubelet would.
- On a CUDA-typed session a failing eviction solve or an open breaker is
  the action's error and no host loop runs; a CPU arena degrades to the
  host loop, as the JAX package does.

The corpus runs against the jitted JAX solves (op by op, the reference's
scan takes seconds a solve); the hand-built problem, the vector functions,
the scenarios and the cycles run JAX op by op (``jax.disable_jit``: XLA's
CPU jit contracts FMAs, see test_torch_solver.py). Tolerance: exact.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest

pytest.importorskip("jax")  # the JAX reference: absent on the card's machine

import torch

import jax
import jax.numpy as jnp

from volcano_tpu.ops import evict as je
from volcano_tpu_torch.ops import evict as te

from test_evict_fuzz import CASES, N, params, random_problem
from torch_helpers import (
    build_node, build_pod, build_pod_group, build_queue,
    hierarchy_annotations, pkg_mod,
)

EVICT_KEYS = ("assigned", "evicted_by", "job_placed", "compact")
#: tests/test_evict_fuzz.py's corpus seed
CORPUS_SEED = 20260731
SCAN_FLAGS = {
    "preempt": {},
    "reclaim": dict(require_freed_covers=True, allow_revert=False,
                    stop_at_need=False),
}
UNIFORM_FLAGS = {
    "preempt": {},
    "covers": dict(require_freed_covers=True, stop_at_need=False),
}
UNIFORM_ONLY = ("job_req", "job_acct", "job_count")


def _jnp(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _ref(fn, a, v, p, **kw):
    r = fn(_jnp(a), _jnp(v), _jnp(p), **kw)
    return {k: np.asarray(getattr(r, k)) for k in EVICT_KEYS}


def assert_same(ref, res, label: str) -> None:
    for k in EVICT_KEYS:
        got = getattr(res, k).numpy()
        assert got.dtype == ref[k].dtype, (label, k)
        np.testing.assert_array_equal(got, ref[k], err_msg=f"{label} {k}")


@functools.lru_cache(maxsize=1)
def corpus():
    rng = np.random.default_rng(CORPUS_SEED)
    return [random_problem(rng) for _ in range(CASES)]


def _scan_victims(v):
    return {k: x for k, x in v.items() if k not in UNIFORM_ONLY}


def _empty_segments(a, v) -> int:
    """Valid nodes that no victim row names (an empty segment)."""
    named = set(v["v_node"].tolist())
    return sum(1 for n in np.nonzero(a["node_valid"])[0] if n not in named)


CHUNKS = 6


@pytest.mark.parametrize("chunk", range(CHUNKS))
def test_solves_match_jax_on_the_fuzz_corpus(chunk):
    p, fam = params()
    cases = corpus()
    step = len(cases) // CHUNKS
    placed = 0
    for case in range(chunk * step, (chunk + 1) * step):
        a, v = cases[case]
        for name, kw in SCAN_FLAGS.items():
            ref = _ref(je.solve_evict, a, _scan_victims(v), p,
                       score_families=fam, **kw)
            res = te.solve_evict(a, _scan_victims(v), p, score_families=fam,
                                 device="cpu", **kw)
            assert_same(ref, res, f"scan {name} #{case}")
            placed += int((ref["assigned"] >= 0).sum())
        for name, kw in UNIFORM_FLAGS.items():
            ref = _ref(je.solve_evict_uniform, a, v, p, score_families=fam,
                       **kw)
            res = te.solve_evict_uniform(a, v, p, score_families=fam,
                                         device="cpu", **kw)
            assert_same(ref, res, f"uniform {name} #{case}")
    assert placed > 0


def test_corpus_has_nodes_without_victims():
    """The empty-segment reads (``cut`` = INT32_MAX, ``has_v`` False) are
    exercised by the corpus: 28 of its 60 cases hold such a valid node."""
    assert sum(_empty_segments(a, v) > 0 for a, v in corpus()) >= CASES // 4


def _no_victim_node_problem():
    """One claimer job of 4 one-cpu tasks over three nodes: node 1 has no
    victim row and room for 2 claimers; nodes 0 and 2 are full and hold
    two victims each. T=8, J=2, V=8, N=4 (node 3 invalid)."""
    T, Nn, J, V, R = 8, 4, 2, 8, 2
    gi = float(1 << 30)
    idle = np.zeros((Nn, R), np.float32)
    idle[1] = (2000.0, 8 * gi)
    a = {"node_idle": idle,
         "node_extra_future": np.zeros((Nn, R), np.float32),
         "node_used": np.zeros((Nn, R), np.float32),
         "node_alloc": np.tile(np.float32([4000.0, 16 * gi]), (Nn, 1)),
         "node_valid": np.arange(Nn) < 3,
         "sig_masks": (np.arange(Nn) < 3)[None, :],
         "task_init_req": np.zeros((T, R), np.float32),
         "task_job": np.full(T, J - 1, np.int32),
         "task_rank": np.arange(T, dtype=np.int32),
         "task_sig": np.zeros(T, np.int32),
         "task_valid": np.arange(T) < 4,
         "job_min": np.array([4, 0], np.int32),
         "job_ready_base": np.zeros(J, np.int32),
         "job_queue": np.zeros(J, np.int32),
         "job_valid": np.array([True, False]),
         "thresholds": np.array([10.0, 1.0], np.float32),
         "scalar_dim_mask": np.zeros(R, bool)}
    a["task_init_req"][:4] = (1000.0, gi)
    a["task_job"][:4] = 0
    a["task_req"] = a["task_init_req"].copy()
    a["task_counts_ready"] = a["task_valid"].copy()
    v_req = np.zeros((V, R), np.float32)
    v_node = np.zeros(V, np.int32)
    v_valid = np.zeros(V, bool)
    for i, n in enumerate((0, 0, 2, 2)):
        v_req[i] = (2000.0, 2 * gi)
        v_node[i] = n
        v_valid[i] = True
    elig = np.zeros((J, V), bool)
    elig[0] = v_valid
    v = {"v_req": v_req, "v_node": v_node, "v_valid": v_valid,
         "elig": elig, "job_need": np.array([4, 0], np.int32),
         "job_req": np.float32([[1000.0, gi], [0.0, 0.0]]),
         "job_acct": np.float32([[1000.0, gi], [0.0, 0.0]]),
         "job_count": np.array([4, 0], np.int32)}
    assert _empty_segments(a, v) == 1
    return a, v


def test_node_without_victims_matches_jax_op_by_op():
    a, v = _no_victim_node_problem()
    p, fam = params()
    p = dict(p, node_static=np.zeros(4, np.float32))
    got = {}
    with jax.disable_jit():
        for name, kw in SCAN_FLAGS.items():
            ref = _ref(je.solve_evict, a, _scan_victims(v), p,
                       score_families=fam, **kw)
            got[name] = te.solve_evict(a, _scan_victims(v), p,
                                       score_families=fam, device="cpu",
                                       **kw)
            assert_same(ref, got[name], f"scan {name}")
        ref = _ref(je.solve_evict_uniform, a, v, p, score_families=fam)
        got["uniform"] = te.solve_evict_uniform(a, v, p, score_families=fam,
                                                device="cpu")
        assert_same(ref, got["uniform"], "uniform")
    # the per-task scan considers a node only when it holds an eligible
    # victim (validate_victims), so it never takes the victimless node;
    # the closed form spends its free capacity first
    scan = got["preempt"].assigned.numpy()
    uniform = got["uniform"].assigned.numpy()
    assert (scan >= 0).any() and (scan != 1).all()
    assert (uniform == 1).any()


def _vector_inputs(seed: int):
    """One uniform claimer job of a corpus problem: absorb_counts' inputs,
    with the scores rounded so that nodes tie."""
    a, v = corpus()[seed]
    rng = np.random.default_rng(seed)
    j = 0
    r = v["job_req"][j]
    sm = a["scalar_dim_mask"]
    sig = np.where(sm, r > 10.0, r > 0.0)
    r_fit = np.where(sig, r, 0.0).astype(np.float32)
    elig = v["elig"][j] & v["v_valid"]
    ptot = np.zeros((N, r.shape[0]), np.float32)
    np.add.at(ptot, v["v_node"][elig], v["v_req"][elig])
    has_v = np.zeros(N, bool)
    has_v[v["v_node"][elig]] = True
    base = (a["node_idle"] + a["node_extra_future"]).astype(np.float32)
    feas_n = a["node_valid"] & (rng.random(N) < 0.9)
    score = rng.integers(0, 3, N).astype(np.float32)
    count = np.int32(rng.integers(0, 3 * N))
    return dict(r=r, r_fit=r_fit, sig=sig, base=base, ptot=ptot,
                has_v=has_v, feas_n=feas_n, thr=a["thresholds"], sm=sm), \
        score, count


@pytest.mark.parametrize("seed", range(6))
def test_absorb_and_spread_counts_match_jax(seed):
    kw, score, count = _vector_inputs(seed)
    t_cap = 64.0
    with jax.disable_jit():
        want = je.absorb_counts(**{k: jnp.asarray(x) for k, x in kw.items()},
                                t_cap=t_cap)
        m_all, f_n, cap = want
        score_j = jnp.where(m_all > 0, jnp.asarray(score), je.NEG)
        want_s = je.spread_counts(jnp.asarray(count), score_j, m_all, f_n,
                                  cap)
    got = te.absorb_counts(**{k: torch.from_numpy(np.asarray(x))
                              for k, x in kw.items()}, t_cap=t_cap)
    for g, w in zip(got, want):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    got_s = te.spread_counts(torch.tensor(count), torch.where(
        got[0] > 0, torch.from_numpy(score), te.NEG), *got[:2], got[2])
    for g, w in zip(got_s, want_s):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _minimality_cluster(pkg: str):
    """tests/test_preempt_reclaim.py TestEvictionMinimality's cluster: 20
    nodes of 16 cpu holding 10 one-cpu victims each, 100 two-cpu
    claimers of one gang."""
    api, m, ops = (pkg_mod(pkg, s) for s in ("api", "models", "ops"))
    nodes = {}
    for i in range(20):
        rl = {"cpu": "16", "memory": "64Gi", "pods": 110}
        nodes[f"n{i}"] = api.NodeInfo(m.Node(name=f"n{i}", allocatable=rl,
                                             capacity=dict(rl)))
    low = api.JobInfo("ns/low", m.PodGroup(
        name="low", namespace="ns", spec=m.PodGroupSpec(min_member=1)))
    victims = []
    for i in range(200):
        pod = m.Pod(name=f"low-{i}", namespace="ns", node_name=f"n{i % 20}",
                    phase="Running",
                    annotations={api.POD_GROUP_ANNOTATION: "low"},
                    containers=[{"requests": {"cpu": "1", "memory": "2Gi"}}])
        t = api.TaskInfo(pod)
        t.status = api.TaskStatus.RUNNING
        low.add_task_info(t)
        nodes[f"n{i % 20}"].add_task(t)
        victims.append(t)
    hi = api.JobInfo("ns/hi", m.PodGroup(
        name="hi", namespace="ns", spec=m.PodGroupSpec(min_member=100)))
    claimers = []
    for i in range(100):
        t = api.TaskInfo(m.Pod(
            name=f"hi-{i}", namespace="ns",
            annotations={api.POD_GROUP_ANNOTATION: "hi"},
            containers=[{"requests": {"cpu": "2", "memory": "4Gi"}}]))
        hi.add_task_info(t)
        claimers.append(t)
    arr = ops.flatten_snapshot({hi.uid: hi}, nodes, claimers)
    sp = ops.ScoreParams(least_req_weight=1.0).resolved(arr.R, arr.N)
    p = {"binpack_weight": np.float32(sp.binpack_weight),
         "binpack_res_weights": sp.binpack_res_weights,
         "least_req_weight": np.float32(sp.least_req_weight),
         "most_req_weight": np.float32(sp.most_req_weight),
         "balanced_weight": np.float32(sp.balanced_weight),
         "node_static": sp.node_static}
    return arr, victims, p


def test_pack_victim_arrays_and_uniform_solve_match_jax():
    arr_j, vic_j, p = _minimality_cluster("jax")
    arr_t, vic_t, _ = _minimality_cluster("torch")
    vj = je.pack_victim_arrays(arr_j, vic_j, 100)
    vt = te.pack_victim_arrays(arr_t, vic_t, 100)
    assert sorted(vj) == sorted(vt)
    for k in vj:
        assert vj[k].dtype == vt[k].dtype, k
        np.testing.assert_array_equal(vj[k], vt[k], err_msg=k)
    # jitted: op by op its per-job steps take seconds; every node scores
    # the same, so the ties are exact either way
    ref = _ref(je.solve_evict_uniform, arr_j.device_dict(), vj, p)
    res = te.solve_evict_uniform(arr_t.numpy_dict(), vt, p, device="cpu")
    assert_same(ref, res, "minimality")
    assigned, evicted_by = te.decode_evict_compact(res.compact, arr_t.T)
    assert (assigned[:100] >= 0).all()
    assert (evicted_by >= 0).sum() <= 88     # the analytic minimum is 80


# ---------------------------------------------------------------------------
# tests/test_preempt_reclaim.py's scenarios, action by action
# ---------------------------------------------------------------------------

@pytest.fixture
def solves(monkeypatch):
    """Each package's completed eviction solves, by name, in call order.
    The JAX package's evict_solver passes numpy dicts, on which its solves
    run only traced: op by op (``jax.disable_jit``) their ``.at[]`` updates
    would meet numpy arrays and the action would degrade to its host loop.
    So the JAX solves are fed jnp arrays here."""
    calls = {"jax": [], "torch": []}
    for pkg, mod in (("jax", je), ("torch", te)):
        for name in ("solve_evict", "solve_evict_uniform"):
            real = getattr(mod, name)

            def wrapped(arrays, victims, score_params, _real=real,
                        _name=name, _pkg=pkg, **kw):
                if _pkg == "jax":
                    arrays, victims, score_params = (
                        _jnp(arrays), _jnp(victims), _jnp(score_params))
                res = _real(arrays, victims, score_params, **kw)
                calls[_pkg].append(_name)
                return res

            monkeypatch.setattr(mod, name, wrapped)
    return calls


HIGH, LOW = ("high-priority", 1000), ("low-priority", 1)
TIER_PGC = [("priority", {}), ("gang", {}), ("conformance", {})]
TIER_PN = [("predicates", {}), ("nodeorder", {})]
HDRF_TIER = [("drf", {"arguments": {"drf.enableHierarchy": True}}),
             ("gang", {"enabled_reclaimable": False}),
             ("predicates", {}), ("nodeorder", {})]


def _pod(ns, name, node, group, cpu, mem="1Gi"):
    phase = "Running" if node else "Pending"
    return (ns, name, node, phase, {"cpu": cpu, "memory": mem}, group)


def _gang_preempt(n_nodes, per_node, min_member):
    pods = [_pod("c1", f"low-{n}-{i}", f"n{n}", "low", "1")
            for n in range(n_nodes) for i in range(per_node)]
    pods += [_pod("c1", f"high-{i}", "", "high", "1")
             for i in range(min_member)]
    return dict(action="preempt", pcs=[HIGH],
                nodes=[(f"n{n}", "2", "8Gi") for n in range(n_nodes)],
                pgs=[("low", "c1", 1, "default", None),
                     ("high", "c1", min_member, "default", HIGH[0])],
                pods=pods, tiers=[TIER_PGC, TIER_PN])


def _reclaim_one_node(tiers, pg1_class=None, pg2_class=None, pcs=(),
                      q1_reclaimable=None):
    return dict(action="reclaim", pcs=list(pcs),
                queues=[("q1", 1, q1_reclaimable, None),
                        ("q2", 1, None, None)],
                nodes=[("n1", "4", "4Gi")],
                pgs=[("pg1", "c1", 1, "q1", pg1_class),
                     ("pg2", "c1", 1, "q2", pg2_class)],
                pods=[_pod("c1", f"a{i}", "n1", "pg1", "1")
                      for i in range(4)]
                + [_pod("c1", "b0", "", "pg2", "1")],
                tiers=tiers)


def _hdrf_reclaim(node, heavy_running, light_running, light_pending):
    q = [("q-heavy", 1, None, hierarchy_annotations("root/heavy", "10/8")),
         ("q-light", 1, None, hierarchy_annotations("root/light", "10/2"))]
    pods = ([_pod("c1", f"h{i}", "n1", "pgh", "1")
             for i in range(heavy_running)]
            + [_pod("c1", f"l{i}", "n1", "pgl", "1")
               for i in range(light_running)]
            + [_pod("c1", f"{g}p{i}", "", f"pg{g}", c, c + "Gi")
               for i, (g, c) in enumerate(light_pending)])
    return dict(action="reclaim", queues=q, nodes=[("n1",) + node],
                pgs=[("pgl", "c1", 1, "q-light", None),
                     ("pgh", "c1", 1, "q-heavy", None)],
                pods=pods, tiers=[HDRF_TIER])


SCENARIOS = {
    # TestPreempt
    "preempt_within_queue": dict(
        action="preempt", pcs=[HIGH], nodes=[("n1", "2", "4Gi")],
        pgs=[("low", "c1", 1, "default", None),
             ("high", "c1", 1, "default", HIGH[0])],
        pods=[_pod("c1", "low-1", "n1", "low", "1"),
              _pod("c1", "low-2", "n1", "low", "1"),
              _pod("c1", "high-1", "", "high", "1")],
        tiers=[TIER_PGC, TIER_PN]),
    "no_preempt_equal_priority": dict(
        action="preempt", nodes=[("n1", "2", "4Gi")],
        pgs=[("a", "c1", 1, "default", None), ("b", "c1", 1, "default", None)],
        pods=[_pod("c1", "a-1", "n1", "a", "2"),
              _pod("c1", "b-1", "", "b", "1")],
        tiers=[TIER_PGC]),
    "conformance_protects_kube_system": dict(
        action="preempt", pcs=[HIGH], nodes=[("n1", "2", "4Gi")],
        pgs=[("sys", "kube-system", 1, "default", None),
             ("high", "c1", 1, "default", HIGH[0])],
        pods=[_pod("kube-system", "sys-1", "n1", "sys", "2"),
              _pod("c1", "high-1", "", "high", "1")],
        tiers=[TIER_PGC]),
    # TestGangPreempt
    "gang_preempts_across_nodes": _gang_preempt(2, 2, 3),
    "gang_unsatisfiable_reverts": _gang_preempt(2, 2, 5),
    "nonuniform_gang_scan": dict(
        action="preempt", pcs=[HIGH], nodes=[("n1", "4", "8Gi")],
        pgs=[("low", "c1", 1, "default", None),
             ("high", "c1", 2, "default", HIGH[0])],
        pods=[_pod("c1", f"low-{i}", "n1", "low", "1") for i in range(4)]
        + [_pod("c1", "high-big", "", "high", "2"),
           _pod("c1", "high-small", "", "high", "1")],
        tiers=[TIER_PGC, TIER_PN]),
    # TestReclaim
    "cross_queue_reclaim": _reclaim_one_node(
        [[("conformance", {}), ("gang", {})]], "low-priority",
        "high-priority", [("high-priority", 100), ("low-priority", 1)]),
    "equal_priority_no_reclaim": _reclaim_one_node(
        [[("gang", {}), ("conformance", {})],
         [("proportion", {}), ("predicates", {})]]),
    "non_reclaimable_queue": _reclaim_one_node(
        [[("gang", {})], [("proportion", {}), ("predicates", {})]],
        q1_reclaimable=False),
    # TestHierarchicalReclaim
    "hdrf_reclaim_follows_tree": _hdrf_reclaim(("4", "4Gi"), 0, 4,
                                               [("h", "1")]),
    "hdrf_over_share_claimer": _hdrf_reclaim(("10", "10Gi"), 8, 1,
                                             [("l", "2")]),
}


class PipelineRecorder:
    """A session's pipelined tasks, read at close (the cache's decision
    recorder seam, present in both packages)."""

    def __init__(self, pkg: str):
        self.status = pkg_mod(pkg, "api").TaskStatus.PIPELINED
        self.sessions = []

    def observe_session(self, ssn) -> None:
        self.sessions.append(sorted(
            (t.namespace, t.name, t.node_name)
            for job in ssn.jobs.values()
            for t in job.task_status_index.get(self.status, {}).values()))


def _cache(pkg: str):
    cache_mod, client = pkg_mod(pkg, "cache"), pkg_mod(pkg, "client")
    store = client.ClusterStore()
    kw = {"device": "cpu"} if pkg == "torch" else {}
    cache = cache_mod.SchedulerCache(store, **kw)
    cache.binder = cache_mod.FakeBinder()
    cache.evictor = cache_mod.FakeEvictor()
    cache.decision_recorder = PipelineRecorder(pkg)
    cache.run()
    return store, cache


def run_scenario(pkg: str, spec: dict, mode: str):
    m, conf, fw = (pkg_mod(pkg, s) for s in ("models", "conf", "framework"))
    ann = pkg_mod(pkg, "api").POD_GROUP_ANNOTATION
    store, cache = _cache(pkg)
    for name, value in spec.get("pcs", ()):
        store.create("priorityclasses", m.PriorityClass(name, value))
    for name, weight, reclaimable, annotations in spec.get("queues", ()):
        store.apply("queues", build_queue(m, name, weight, annotations,
                                          reclaimable))
    for name, cpu, mem in spec["nodes"]:
        store.create("nodes", build_node(m, name, {"cpu": cpu,
                                                   "memory": mem}))
    for name, ns, min_member, queue, pclass in spec["pgs"]:
        pg = build_pod_group(m, name, ns, min_member, queue,
                             phase=m.PodGroupPhase.INQUEUE)
        pg.spec.priority_class_name = pclass or ""
        store.create("podgroups", pg)
    for ns, name, node, phase, req, group in spec["pods"]:
        store.create("pods", build_pod(m, ann, ns, name, node, phase, req,
                                       group))
    tiers = [conf.Tier(plugins=[conf.PluginOption(name=n, **kw)
                                for n, kw in tier])
             for tier in spec["tiers"]]
    ssn = fw.open_session(cache, tiers, [
        conf.Configuration("preempt", {"mode": mode}),
        conf.Configuration("reclaim", {"mode": mode})])
    try:
        fw.get_action(spec["action"]).execute(ssn)
    finally:
        fw.close_session(ssn)
    return list(cache.evictor.evicts), cache.decision_recorder.sessions[-1]


#: scenarios with no eviction by design (the test is vacuous otherwise)
NO_EVICTION = {"no_preempt_equal_priority", "conformance_protects_kube_system",
               "gang_unsatisfiable_reverts", "equal_priority_no_reclaim",
               "non_reclaimable_queue", "hdrf_over_share_claimer"}


@pytest.mark.parametrize("mode", ["solver", "host"])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_jax(name, mode, solves):
    spec = SCENARIOS[name]
    got = run_scenario("torch", spec, mode)
    with jax.disable_jit():
        want = run_scenario("jax", spec, mode)
    assert got == want
    # the same solves ran to their end in both packages (none in host mode)
    assert solves["torch"] == solves["jax"]
    if mode == "host" or got[0]:
        assert bool(solves["torch"]) == (mode == "solver")
    evicts, pipelined = got
    assert bool(evicts) == (name not in NO_EVICTION), evicts
    if evicts:
        assert pipelined


# ---------------------------------------------------------------------------
# Scheduler cycles with preempt and reclaim
# ---------------------------------------------------------------------------

EVICT_CONF = """
actions: "enqueue, allocate, preempt, reclaim, backfill"
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
configurations:
- name: allocate
  arguments:
    mode: host
- name: preempt
  arguments:
    mode: {mode}
- name: reclaim
  arguments:
    mode: {mode}
"""


class EvictCluster:
    """One package's Scheduler over 4 nodes of 8 cpu / 32Gi, with the
    priority classes high (100) and low (1), low-priority running pods
    that fill every node, and high-priority claimers. Allocate runs its
    host loop here (op by op, the JAX round solve costs seconds a cycle;
    its parity is test_torch_scheduler.py's), preempt and reclaim the
    ``mode`` given."""

    def __init__(self, pkg: str, mode: str, queues=(("qa", True),)):
        self.pkg = pkg
        self.m = m = pkg_mod(pkg, "models")
        self.ann = pkg_mod(pkg, "api").POD_GROUP_ANNOTATION
        self.store, self.cache = _cache(pkg)
        for name, value in (("high", 100), ("low", 1)):
            self.store.create("priorityclasses", m.PriorityClass(name, value))
        for q, reclaimable in queues:
            self.store.apply("queues", build_queue(m, q, 1,
                                                   reclaimable=reclaimable))
        for n in range(4):
            self.store.create("nodes", build_node(
                m, f"n{n}", {"cpu": "8", "memory": "32Gi"}))
        self.sched = pkg_mod(pkg, "scheduler").Scheduler(
            self.cache, scheduler_conf=EVICT_CONF.format(mode=mode))
        self.seen_evicts = 0

    def job(self, name, queue, prio, min_member, pods, cpu, mem,
            nodes=None, phase=None):
        """A job of ``pods`` pods; ``nodes`` places them Running, one per
        listed node, else they are Pending."""
        m = self.m
        pg = build_pod_group(m, name, "ns", min_member, queue,
                             phase=phase or m.PodGroupPhase.PENDING)
        pg.spec.priority_class_name = prio
        self.store.create("podgroups", pg)
        for i in range(pods):
            node = nodes[i] if nodes else ""
            self.store.create("pods", build_pod(
                m, self.ann, "ns", f"{name}-{i}", node,
                "Running" if node else "Pending",
                {"cpu": cpu, "memory": mem}, name))

    def cycle(self):
        """One cycle: (its evictions, its pipelines, its binds); then the
        evicted pods are deleted, as a kubelet would."""
        before = dict(self.cache.binder.binds)
        self.sched.run_once()
        evicts = self.cache.evictor.evicts[self.seen_evicts:]
        self.seen_evicts = len(self.cache.evictor.evicts)
        for key in evicts:
            ns, name = key.split("/")
            self.store.delete("pods", name, ns)
        binds = sorted((k, v) for k, v in self.cache.binder.binds.items()
                       if before.get(k) != v)
        return (list(evicts), self.cache.decision_recorder.sessions[-1],
                binds)


def _preempt_cluster(pkg, mode):
    """A low job of 24 one-cpu pods (6 a node) and a high gang of 8
    two-cpu pods in one queue: 2 cpu idle a node, so the gang needs
    evictions."""
    c = EvictCluster(pkg, mode)
    running = c.m.PodGroupPhase.RUNNING
    c.job("low", "qa", "low", 1, 24, "1", "2Gi",
          nodes=[f"n{i % 4}" for i in range(24)], phase=running)
    c.job("high", "qa", "high", 8, 8, "2", "4Gi")
    return c


def _reclaim_cluster(pkg, mode):
    """Queue qa (reclaimable) fills every node with 8 low jobs of 4
    one-cpu pods; queue qb submits 3 high jobs of 2 two-cpu pods."""
    c = EvictCluster(pkg, mode, queues=(("qa", True), ("qb", None)))
    running = c.m.PodGroupPhase.RUNNING
    for j in range(8):
        c.job(f"low{j}", "qa", "low", 1, 4, "1", "2Gi",
              nodes=[f"n{(4 * j + i) % 4}" for i in range(4)], phase=running)
    for j in range(3):
        c.job(f"high{j}", "qb", "high", 1, 2, "2", "4Gi")
    return c


@pytest.mark.parametrize("mode", ["solver", "host"])
@pytest.mark.parametrize("build", [_preempt_cluster, _reclaim_cluster],
                         ids=["preempt", "reclaim"])
def test_evict_cycles_match_jax(build, mode, solves):
    t, j = build("torch", mode), build("jax", mode)
    rows = []
    for cycle in range(2):
        got = t.cycle()
        with jax.disable_jit():
            want = j.cycle()
        assert got == want, cycle
        timing = t.sched.last_cycle_timing
        assert not any(k.endswith("_error") for k in timing), timing
        rows.append(got)
    (ev0, pipe0, _), (ev1, _, binds1) = rows
    # cycle 0 evicts for the claimers and pipelines them; cycle 1, the
    # victims gone, binds them
    assert ev0 and pipe0 and not ev1
    assert {(ns + "/" + name) for ns, name, _ in pipe0} <= \
        {k for k, _ in binds1}
    assert solves["torch"] == solves["jax"]
    assert bool(solves["torch"]) == (mode == "solver")


@pytest.mark.parametrize("failure", ["dispatch_fault", "breaker_open"])
@pytest.mark.parametrize("action", ["preempt", "reclaim"])
def test_evict_failure_on_a_cuda_session_raises(action, failure,
                                                monkeypatch):
    """On a CUDA arena a failed eviction solve (an injected dispatch
    fault) or an open breaker is the action's error: nothing is evicted
    or pipelined and the host loop never runs. The cache runs on the CPU
    and only reports a CUDA device, which is all that decision reads. The
    same fault on a CPU arena degrades to the host loop, which evicts."""
    actions = pkg_mod("torch", "actions")
    cls = {"preempt": actions.PreemptAction,
           "reclaim": actions.ReclaimAction}[action]
    faults = pkg_mod("torch", "resilience").faults
    build = _preempt_cluster if action == "preempt" else _reclaim_cluster
    host_runs = []
    real = cls._execute_host

    def spy(self, ssn, only_jobs=None):
        host_runs.append(only_jobs)
        return real(self, ssn, only_jobs=only_jobs)

    monkeypatch.setattr(cls, "_execute_host", spy)
    for on_card in (True, False):
        c = build("torch", "solver")
        if on_card:
            c.cache.device = torch.device("cuda", 0)
        breaker = c.cache.breaker
        try:
            if failure == "dispatch_fault":
                # every eviction solve of the cycle fails: preempt's
                # runs before reclaim's
                faults.arm("evict_dispatch", every=1)
            else:
                for _ in range(breaker.failure_threshold):
                    breaker.record_failure()
            evicts, pipelined, _ = c.cycle()
        finally:
            faults.reset()
        timing = c.sched.last_cycle_timing
        if on_card:
            assert timing.get(f"{action}_error") == 1.0
            assert evicts == [] and pipelined == [] and host_runs == []
            assert breaker.fallback_cycles == 0
        else:
            assert f"{action}_error" not in timing
            assert evicts and host_runs == [None]
