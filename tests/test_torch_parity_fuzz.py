"""High-contention parity fuzz: rounds solver vs sequential reference,
tests/test_parity_fuzz.py through the port on the CPU (``device="cpu"``),
plus the fuzz corpus held to the JAX package's solvers (op by op,
``test_fuzz_problems_equal_jax``: exact).

VERDICT r1 item 7: property-test ``solve_allocate`` (the round-based
production kernel, both herd modes, with and without in-kernel queue caps)
against ``solve_allocate_sequential`` (the reference's greedy order) on
random contended snapshots — gangs that must revert, pipeline-able nodes,
random feasibility masks.

Hard invariants (must hold exactly, both solvers):
- per-node capacity respect: allocated fits idle, allocated+pipelined fits
  idle+future-extra (threshold-tolerant, like resource_info.go LessEqual);
- gang atomicity: a job that is not ready has ZERO committed allocations
  (Statement.Discard semantics);
- job_ready consistency: ready == (ready_base + counted allocations >= min).

Quality (documented greedy-order deviation, not bit-identical placement):
under contention the two solvers may satisfy different job subsets; the
rounds solver must place at least PLACEMENT_SLACK of the sequential
reference's placements on every case, and at least as many in aggregate.
"""

import numpy as np
import pytest

pytest.importorskip("jax")  # the JAX reference: absent on the card's machine

import jax

from volcano_tpu.ops import solver as j_solver
from volcano_tpu_torch.ops.solver import (
    solve_allocate, solve_allocate_sequential,
)

# fixed padded buckets so the whole fuzz compiles each kernel variant once
T, N, J, Q, R, S = 64, 16, 16, 4, 2, 4

#: per-case floor on rounds-solver placements relative to the sequential
#: reference. With the deferred-retry gang queue (doubly-reverted jobs
#: retry one at a time in rank order) and near-best-score striping, the
#: observed worst case across 160 seeds is 0.667 — and those cases are
#: job-SUBSET choices under extreme contention (e.g. 4-vs-6 placements
#: with identical job_ready counts), not placements lost to heuristic
#: scatter; the aggregate is >1.0 (the rounds solver places MORE).
#: A regression below this floor means a real bug, not noise.
PLACEMENT_SLACK = 0.65

CASES = 40


def random_problem(rng):
    n_nodes = int(rng.integers(2, N + 1))
    n_jobs = int(rng.integers(1, 12))
    arrays = {}
    # nodes: capacity tuned for ~1.5x contention
    idle = np.zeros((N, R), np.float32)
    idle[:n_nodes, 0] = rng.integers(1, 9, n_nodes) * 1000.0   # millicores
    idle[:n_nodes, 1] = rng.integers(1, 17, n_nodes) * (1 << 30)  # bytes
    extra = np.zeros((N, R), np.float32)
    releasing = rng.random(n_nodes) < 0.3
    extra[:n_nodes][releasing] = idle[:n_nodes][releasing] * 0.5
    arrays["node_idle"] = idle
    arrays["node_extra_future"] = extra.astype(np.float32)
    arrays["node_used"] = np.zeros((N, R), np.float32)
    arrays["node_alloc"] = np.where(idle > 0, idle, 1.0).astype(np.float32)
    arrays["node_npods"] = np.zeros(N, np.int32)
    arrays["node_max_pods"] = np.full(N, 110, np.int32)
    arrays["node_valid"] = np.arange(N) < n_nodes

    # sigs: sig 0 unconstrained; others mask off random nodes
    sig_masks = np.zeros((S, N), bool)
    sig_masks[:, :n_nodes] = True
    for s in range(1, S):
        sig_masks[s, :n_nodes] &= rng.random(n_nodes) < 0.7
    arrays["sig_masks"] = sig_masks

    # jobs/tasks, grouped contiguously
    task_job = np.full(T, J - 1, np.int32)
    init_req = np.zeros((T, R), np.float32)
    valid = np.zeros(T, bool)
    job_min = np.zeros(J, np.int32)
    job_valid = np.zeros(J, bool)
    job_queue = np.zeros(J, np.int32)
    task_sig = np.zeros(T, np.int32)
    off = 0
    for j in range(n_jobs):
        k = int(rng.integers(1, 9))
        k = min(k, T - off)
        if k == 0:
            break
        cpu = float(rng.integers(1, 4)) * 1000.0
        mem = float(rng.integers(1, 5)) * (1 << 30)
        init_req[off:off + k] = (cpu, mem)
        task_job[off:off + k] = j
        task_sig[off:off + k] = int(rng.integers(0, S))
        valid[off:off + k] = True
        job_min[j] = int(rng.integers(1, k + 1))
        job_valid[j] = True
        job_queue[j] = int(rng.integers(0, 3))
        off += k
    arrays["task_init_req"] = init_req
    arrays["task_req"] = init_req.copy()
    arrays["task_job"] = task_job
    arrays["task_rank"] = np.arange(T, dtype=np.int32)
    arrays["task_sig"] = task_sig
    arrays["task_counts_ready"] = valid.copy()
    arrays["task_valid"] = valid
    arrays["job_min"] = job_min
    arrays["job_ready_base"] = np.zeros(J, np.int32)
    arrays["job_queue"] = job_queue
    arrays["job_valid"] = job_valid

    # queues: weights 1..3, request = per-queue demand, no caps
    qw = np.zeros(Q, np.float32)
    qw[:3] = rng.integers(1, 4, 3)
    qreq = np.zeros((Q, R), np.float32)
    for j in range(n_jobs):
        qreq[job_queue[j]] += init_req[task_job == j].sum(axis=0)
    arrays["queue_weight"] = qw
    arrays["queue_capability"] = np.full((Q, R), np.inf, np.float32)
    arrays["queue_allocated"] = np.zeros((Q, R), np.float32)
    arrays["queue_request"] = qreq

    arrays["thresholds"] = np.array([10.0, 1.0], np.float32)
    arrays["scalar_dim_mask"] = np.zeros(R, bool)
    # DRF inputs: a third of jobs start with some allocation
    drf_alloc = np.zeros((J, R), np.float32)
    for j in range(n_jobs):
        if rng.random() < 0.33:
            drf_alloc[j, 0] = float(rng.integers(1, 4)) * 1000.0
            drf_alloc[j, 1] = float(rng.integers(1, 4)) * (1 << 30)
    arrays["job_drf_allocated"] = drf_alloc
    arrays["drf_total"] = idle[:n_nodes].sum(axis=0) + drf_alloc.sum(axis=0)
    return arrays


def params_for(mode):
    if mode == "pack":
        return {"binpack_weight": np.float32(1.0),
                "binpack_res_weights": np.ones(R, np.float32),
                "least_req_weight": np.float32(0.0),
                "most_req_weight": np.float32(0.0),
                "balanced_weight": np.float32(0.0),
                "node_static": np.zeros(N, np.float32)}, ("binpack",)
    return {"binpack_weight": np.float32(0.0),
            "binpack_res_weights": np.ones(R, np.float32),
            "least_req_weight": np.float32(1.0),
            "most_req_weight": np.float32(0.0),
            "balanced_weight": np.float32(0.0),
            "node_static": np.zeros(N, np.float32)}, ("kube",)


def check_invariants(a, res, label):
    assigned = np.asarray(res.assigned)
    kind = np.asarray(res.kind)
    ready = np.asarray(res.job_ready)
    valid = a["task_valid"]
    # assignments only for valid tasks, onto valid nodes
    assert (assigned[~valid] < 0).all(), label
    placed = assigned >= 0
    assert a["node_valid"][assigned[placed]].all(), label
    # per-node capacity
    alloc_used = np.zeros((N, R), np.float32)
    pipe_used = np.zeros((N, R), np.float32)
    for i in np.nonzero(placed)[0]:
        if kind[i] == 0:
            alloc_used[assigned[i]] += a["task_req"][i]
        else:
            pipe_used[assigned[i]] += a["task_req"][i]
    thr = a["thresholds"]
    assert (alloc_used <= a["node_idle"] + thr).all(), \
        f"{label}: allocations exceed idle"
    # NOTE: no joint alloc+pipe <= idle+extra check — the reference itself
    # doesn't guarantee it: allocate fits against Idle only, and a pipeline
    # fit FutureIdle at its decision time; a later allocation may eat into
    # a pipeline's promised resources (allocate.go:230-254 checks Idle, no
    # pipeline re-validation). The per-kind bounds below are what hold.
    assert (pipe_used <= a["node_idle"] + a["node_extra_future"]
            + thr).all(), f"{label}: pipelines exceed total future idle"
    # gang atomicity + job_ready consistency
    for j in range(J):
        if not a["job_valid"][j]:
            continue
        mask = (a["task_job"] == j) & placed & (kind == 0)
        n_alloc = int((mask & a["task_counts_ready"]).sum())
        expect_ready = (a["job_ready_base"][j] + n_alloc
                        >= a["job_min"][j])
        assert bool(ready[j]) == bool(expect_ready), \
            f"{label}: job_ready inconsistent for job {j}"
        if not ready[j]:
            assert n_alloc == 0, \
                f"{label}: unready job {j} kept {n_alloc} allocations"
    return int(placed.sum())


@pytest.mark.parametrize("herd", ["pack", "spread"])
@pytest.mark.parametrize("queue_cap", [False, True])
def test_contended_parity(herd, queue_cap):
    rng = np.random.default_rng(20260730 + (herd == "pack")
                                + 2 * queue_cap)
    params, families = params_for(herd)
    total_rounds = total_seq = 0
    for case in range(CASES):
        a = random_problem(rng)
        r1 = solve_allocate(a, params, herd_mode=herd,
                            score_families=families,
                            use_queue_cap=queue_cap, device="cpu")
        r2 = solve_allocate_sequential(a, params,
                                       score_families=families,
                                       use_queue_cap=queue_cap,
                                       device="cpu")
        p1 = check_invariants(a, r1, f"rounds/{herd}/q{queue_cap}/#{case}")
        p2 = check_invariants(a, r2, f"seq/{herd}/q{queue_cap}/#{case}")
        total_rounds += p1
        total_seq += p2
        # per-case quality floor vs the reference greedy
        assert p1 >= PLACEMENT_SLACK * p2, \
            (f"case {case} ({herd}, qcap={queue_cap}): rounds placed {p1} "
             f"vs sequential {p2}")
    # in aggregate the production solver stays within a few percent of the
    # reference greedy per config (observed floor 0.972 on pack/no-cap;
    # summed across all four herd/queue-cap configs it places MORE than
    # the reference, ratio ~1.035)
    assert total_rounds >= total_seq * 0.95, (total_rounds, total_seq)


@pytest.mark.parametrize("queue_cap", [False, True])
def test_drf_order_invariants(queue_cap):
    """Live DRF ordering deviates from the sequential reference BY DESIGN
    (that is its job), so only the hard invariants are asserted: capacity
    respect, gang atomicity, job_ready consistency — plus everything
    places that the static-order solver places (fair ordering must not
    lose work in aggregate)."""
    rng = np.random.default_rng(20260801 + queue_cap)
    params, families = params_for("spread")
    tot_drf = tot_static = 0
    for case in range(CASES):
        a = random_problem(rng)
        r_drf = solve_allocate(a, params, herd_mode="spread",
                               score_families=families,
                               use_queue_cap=queue_cap,
                               use_drf_order=True, device="cpu")
        r_static = solve_allocate(a, params, herd_mode="spread",
                                  score_families=families,
                                  use_queue_cap=queue_cap, device="cpu")
        tot_drf += check_invariants(a, r_drf,
                                    f"drf/q{queue_cap}/#{case}")
        tot_static += check_invariants(a, r_static,
                                       f"static/q{queue_cap}/#{case}")
    assert tot_drf >= tot_static * 0.9, (tot_drf, tot_static)


def test_sequential_kernel_matches_host_action():
    """Drive the sequential kernel and the host action (the true oracle)
    through real sessions on random clusters. One documented deviation
    separates them: the host loop REQUEUES a job once it reaches
    min_available (allocate.go:160-166), interleaving beyond-min tasks
    with other jobs, while the kernel's pre-collected order finishes each
    job contiguously — under contention the host can occasionally satisfy
    one more job. Exact parity is required on most cases, and the
    aggregate gap must stay within a few binds."""
    from torch_helpers import Builders

    _B = Builders("torch")
    build_node, build_pod, build_pod_group = _B.build_node, _B.build_pod, _B.build_pod_group

    from volcano_tpu_torch.cache import FakeBinder, FakeEvictor, SchedulerCache
    from volcano_tpu_torch.client import ClusterStore
    from volcano_tpu_torch.conf import Configuration, PluginOption, Tier
    from volcano_tpu_torch.framework import close_session, get_action, open_session

    rng = np.random.default_rng(20260802)
    tiers = [Tier(plugins=[PluginOption(name="priority"),
                           PluginOption(name="gang")]),
             Tier(plugins=[PluginOption(name="predicates"),
                           PluginOption(name="nodeorder")])]

    def build_world(seed_case):
        store = ClusterStore()
        cache = SchedulerCache(store, device="cpu")
        cache.binder = FakeBinder()
        cache.evictor = FakeEvictor()
        cache.run()
        for n in range(int(seed_case["nodes"])):
            store.create("nodes", build_node(
                f"n{n}", {"cpu": str(seed_case["node_cpu"][n]),
                          "memory": f"{seed_case['node_mem'][n]}Gi"}))
        for j, (k, mn, cpu, mem) in enumerate(seed_case["jobs"]):
            store.create("podgroups",
                         build_pod_group(f"pg{j}", "c1", min_member=mn))
            for i in range(k):
                store.create("pods", build_pod(
                    "c1", f"pg{j}-{i}", "", "Pending",
                    {"cpu": str(cpu), "memory": f"{mem}Gi"}, f"pg{j}"))
        return store, cache

    equal_cases = binds_host = binds_seq = 0
    for case in range(12):
        spec = {
            "nodes": int(rng.integers(2, 6)),
            "jobs": [(int(rng.integers(1, 5)), 0,
                      int(rng.integers(1, 3)), int(rng.integers(1, 3)))
                     for _ in range(int(rng.integers(1, 5)))],
        }
        spec["jobs"] = [(k, int(rng.integers(1, k + 1)), c, m)
                        for k, _, c, m in spec["jobs"]]
        spec["node_cpu"] = rng.integers(2, 7, spec["nodes"])
        spec["node_mem"] = rng.integers(2, 9, spec["nodes"])
        results = {}
        for mode in ("host", "sequential"):
            store, cache = build_world(spec)
            ssn = open_session(cache, tiers,
                               [Configuration("allocate", {"mode": mode})])
            get_action("allocate").execute(ssn)
            ready = {j.uid for j in ssn.jobs.values() if j.ready()}
            close_session(ssn)
            results[mode] = (len(cache.binder.binds), ready)
        equal_cases += results["host"] == results["sequential"]
        binds_host += results["host"][0]
        binds_seq += results["sequential"][0]
    assert equal_cases >= 10, (equal_cases, binds_host, binds_seq)
    assert binds_seq >= binds_host - 3, (binds_host, binds_seq)


def test_overflow_pass_parity():
    """The work-conserving overflow (rounds kernel, capped -> capability
    phases) against its sequential oracle (strict pass + relaxed second
    pass over leftovers): hard invariants exact, placements within the
    same tolerance as the strict parity, and in aggregate neither solver
    strands capacity the other claims."""
    rng = np.random.default_rng(20260803)
    params, families = params_for("spread")
    tot_rounds = tot_seq = 0
    for case in range(CASES):
        a = random_problem(rng)
        # give queue 0 a FINITE capability (~60% of its request) so the
        # overflow pass's "hard capability quotas still bind" rule is
        # genuinely exercised, not vacuously true at +inf
        cap = a["queue_request"][0] * 0.6
        a["queue_capability"][0] = np.where(cap > 0, cap, np.inf)
        r1 = solve_allocate(a, params, herd_mode="spread",
                            score_families=families, use_queue_cap=True,
                            device="cpu")
        r2 = solve_allocate_sequential(a, params, score_families=families,
                                       use_queue_cap=True,
                                       overflow_pass=True, device="cpu")
        p1 = check_invariants(a, r1, f"rounds/overflow/#{case}")
        p2 = check_invariants(a, r2, f"seq/overflow/#{case}")
        # the overflow pass must never push a queue past its capability
        thr = a["thresholds"]
        for res, label in ((r1, "rounds"), (r2, "seq")):
            assigned = np.asarray(res.assigned)
            qalloc = a["queue_allocated"].copy()
            for i in np.nonzero(assigned >= 0)[0]:
                qalloc[a["job_queue"][a["task_job"][i]]] += a["task_req"][i]
            assert (qalloc[0] <= a["queue_capability"][0] + thr
                    + 1e-3).all(), f"{label} case {case}: capability burst"
        tot_rounds += p1
        tot_seq += p2
        # finite-capability stress is harsher than the strict corpus: the
        # observed worst case is 0.59 (identical job_ready sets, fewer
        # beyond-min placements for jobs the gang queue excluded)
        assert p1 >= 0.55 * p2, (case, p1, p2)
    assert tot_rounds >= tot_seq * 0.95, (tot_rounds, tot_seq)


def test_strict_mode_matches_strict_oracle():
    """work_conserving=False drops the overflow phases and the unrequested
    -dim easing (ADVICE r2 #1): the rounds solver must then respect the
    same strict deserved caps as the strict sequential oracle — neither
    places more into a queue than its water-filled deserved."""
    rng = np.random.default_rng(20260804)
    params, families = params_for("spread")
    from volcano_tpu_torch.ops.convert import to_torch_arrays
    from volcano_tpu_torch.ops.solver import queue_cap_state
    for case in range(10):
        a = random_problem(rng)
        r1 = solve_allocate(a, params, herd_mode="spread",
                            score_families=families, use_queue_cap=True,
                            work_conserving=False, device="cpu")
        check_invariants(a, r1, f"strict/#{case}")
        # recompute strict deserved (no easing) and check per-queue totals
        total = (a["node_alloc"]
                 * a["node_valid"][:, None].astype(np.float32)).sum(axis=0)
        # the port's queue_cap_state takes tensors (the reference's, jnp
        # arrays)
        t = to_torch_arrays({**a, "total": total}, device="cpu")
        _, deserved, _, _, _ = queue_cap_state(
            t, t["task_rank"], t["thresholds"], t["total"],
            ease_unrequested=False)
        deserved = deserved.numpy()
        assigned = np.asarray(r1.assigned)
        qalloc = a["queue_allocated"].copy()
        for i in np.nonzero(assigned >= 0)[0]:
            qalloc[a["job_queue"][a["task_job"][i]]] += a["task_req"][i]
        thr = a["thresholds"]
        assert (qalloc <= deserved + thr[None, :] + 1e-3).all(), \
            f"strict case {case}: queue exceeded strict deserved"


class TestMultiCycleStarvation:
    """VERDICT r3 weak #3: the rounds solver's like-for-like job swaps in
    one snapshot must not compound into starvation across cycles. Churn
    model: each cycle, every gang the solver completed runs and vacates;
    the remainder re-contend. Asserts (a) every job completes within the
    ideal cycle count + 1 slack cycle — a job on the losing side of a
    swap cannot lose repeatedly; (b) per-cycle completed jobs >= the
    sequential reference oracle on the identical state (the reference's
    stable order, allocate.go:124-166, is the structural floor)."""

    def _build(self, job_ids, n_nodes, node_cpu, tpj):
        from volcano_tpu_torch.api import JobInfo, NodeInfo, TaskInfo
        from volcano_tpu_torch.api.types import POD_GROUP_ANNOTATION
        from volcano_tpu_torch.models import Node, Pod, PodGroup, PodGroupSpec

        nodes = {}
        for i in range(n_nodes):
            rl = {"cpu": str(node_cpu), "memory": "64Gi", "pods": 110}
            nodes[f"n{i}"] = NodeInfo(Node(name=f"n{i}", allocatable=rl,
                                           capacity=dict(rl)))
        jobs, tasks = {}, []
        for k in job_ids:
            pg = PodGroup(name=f"j{k}", namespace="s",
                          spec=PodGroupSpec(min_member=tpj))
            job = JobInfo(f"s/j{k}", pg)
            for i in range(tpj):
                pod = Pod(name=f"j{k}-{i}", namespace="s",
                          annotations={POD_GROUP_ANNOTATION: f"j{k}"},
                          containers=[{"requests": {"cpu": "1",
                                                    "memory": "1Gi"}}])
                t = TaskInfo(pod)
                job.add_task_info(t)
                tasks.append(t)
            jobs[job.uid] = job
        return jobs, nodes, tasks

    def test_all_jobs_complete_within_bound(self):
        import math

        from volcano_tpu_torch.ops import flatten_snapshot

        n_jobs, tpj, n_nodes, node_cpu = 20, 5, 10, 5
        # capacity 50 one-cpu slots per cycle vs 100 demanded: 2x
        # contention, all jobs identical (the pure like-for-like regime)
        pending = list(range(n_jobs))
        waits = {}
        cycle = 0
        per_cycle = []
        while pending and cycle < 10:
            jobs, nodes, tasks = self._build(pending, n_nodes, node_cpu,
                                             tpj)
            arr = flatten_snapshot(jobs, nodes, tasks)
            from volcano_tpu_torch.ops import ScoreParams
            sp = ScoreParams(least_req_weight=1.0).resolved(arr.R, arr.N)
            p = {"binpack_weight": np.float32(0.0),
                 "binpack_res_weights": sp.binpack_res_weights,
                 "least_req_weight": np.float32(1.0),
                 "most_req_weight": np.float32(0.0),
                 "balanced_weight": np.float32(0.0),
                 "node_static": sp.node_static}
            d = arr.device_dict("cpu")
            ready_r = np.asarray(
                solve_allocate(d, p, herd_mode="spread",
                               score_families=("kube",),
                               device="cpu").job_ready)
            ready_s = np.asarray(
                solve_allocate_sequential(
                    d, p, score_families=("kube",),
                    device="cpu").job_ready)
            done_rounds = int(ready_r[:len(pending)].sum())
            done_seq = int(ready_s[:len(pending)].sum())
            # (b) the rounds solver completes at least the oracle's jobs
            assert done_rounds >= done_seq, (cycle, done_rounds, done_seq)
            assert done_rounds > 0, "no progress: live-lock"
            survivors = []
            for idx, k in enumerate(pending):
                if ready_r[idx]:
                    waits[k] = cycle
                else:
                    survivors.append(k)
            per_cycle.append(done_rounds)
            pending = survivors
            cycle += 1

        assert not pending, f"starved jobs: {pending} (waits={waits})"
        # (a) ideal = ceil(jobs / first-cycle throughput); +1 slack cycle
        ideal = math.ceil(n_jobs / per_cycle[0])
        max_wait = max(waits.values())
        assert max_wait <= ideal, (
            f"job waited {max_wait} cycles (ideal completion "
            f"{ideal - 1}): starvation. waits={waits}")


@pytest.mark.parametrize("herd", ["pack", "spread"])
def test_fuzz_problems_equal_jax(herd):
    """The first fuzz problems of a seed through both packages' round and
    sequential solvers: identical assigned, kind and job_ready. The JAX
    side runs op by op (jitted XLA contracts the score's multiply-adds and
    flips ties); the requests are whole millicores and Gi, so the port's
    exact admission prefix sums as the JAX float32 one does."""
    rng = np.random.default_rng(20260805 + (herd == "pack"))
    params, families = params_for(herd)
    for case in range(3):
        a = random_problem(rng)
        for name, kw in (("rounds", dict(herd_mode=herd,
                                          use_queue_cap=True)),
                         ("sequential", dict(use_queue_cap=True))):
            port = (solve_allocate if name == "rounds"
                    else solve_allocate_sequential)
            ref = (j_solver.solve_allocate if name == "rounds"
                   else j_solver.solve_allocate_sequential)
            got = port(a, params, score_families=families, device="cpu",
                       **kw)
            with jax.disable_jit():
                want = ref(a, params, score_families=families, **kw)
            for key in ("assigned", "kind", "job_ready"):
                np.testing.assert_array_equal(
                    getattr(got, key).numpy(),
                    np.asarray(getattr(want, key)),
                    err_msg=f"{name}/{herd}/#{case}: {key}")
