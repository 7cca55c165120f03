"""Eviction solve: batched preempt/reclaim victim selection in PyTorch.

The counterpart of the JAX package's ``ops/evict.py`` (volcano_tpu), with
the same semantics. It replaces the reference's per-preemptor victim loops
(actions/preempt/preempt.go:186-262, actions/reclaim/reclaim.go:40-192)
with one pass over the preemptor tasks:

- victims are flattened once, sorted by (node, cheapest-first) — the order
  the reference pops its per-node victim priority queue in;
- per step, each node's minimal victim prefix that makes the preemptor fit
  is found with segment prefix-sums ("evict cheapest-first until FutureIdle
  fits", preempt.go:219-240 / "until the request is covered",
  reclaim.go:91-100);
- the preemptor pipelines onto the best feasible node (score order, like the
  host loop's node_order_fn sort) and the chosen victims die for later steps;
- preempt's gang atomicity (Statement commit iff JobPipelined) runs as a
  job-boundary revert, like solve_allocate_sequential's.

The JAX package's ``lax.scan`` over tasks (``solve_evict``) and over jobs
(``solve_evict_uniform``) become Python loops of device steps. Job
boundaries are read from a host copy of ``task_job``, so no step waits on
the device; every decision on device values is a ``torch.where``.
``segment_min`` / ``segment_max`` start from JAX's empty-segment values
(INT32_MAX / INT32_MIN), so a node with no victims reads the same ``cut``
and ``has_v`` as there.

Accepted greedy-order deviations vs the host oracle (documented contract):
plugin eligibility (drf share deltas, proportion deserved) is frozen at
solve start rather than re-evaluated after every eviction, and claimer
queues are visited in snapshot order rather than re-sorted per placement.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .convert import resolve_device, to_torch_arrays, to_torch_params
from .solver import (
    COMPACT_UNAVAILABLE, INF, INT32_MAX, NEG, _host_array, _scatter_set,
    _segment_any, _segment_min, _segment_prefix, _segment_sum, le_fits,
    score_matrix,
)


class EvictResult(NamedTuple):
    assigned: torch.Tensor    # [T] int32: node the task pipelines on, or -1
    evicted_by: torch.Tensor  # [V] int32: claimer JOB index, or -1
    job_placed: torch.Tensor  # [J] int32: pipelined placements per job
    compact: torch.Tensor = None  # [T+V] int16: assigned ++ evicted_by —
                                  # one readback instead of two;
                                  # sentinel-filled when indices overflow


def _evict_compact(assigned, evby, n_nodes: int, n_jobs: int):
    if max(n_nodes, n_jobs) >= (1 << 15):
        # indices don't fit int16: sentinel so decode fails loudly
        return torch.full((assigned.shape[0] + evby.shape[0],),
                          COMPACT_UNAVAILABLE, dtype=torch.int16,
                          device=assigned.device)
    return torch.cat([assigned, evby]).to(torch.int16)


def decode_evict_compact(compact, n_tasks: int):
    """host-side: compact int16 -> (assigned [T], evicted_by [V]) int32
    numpy. Raises when the solve emitted the overflow sentinel — read
    res.assigned / res.evicted_by instead."""
    if isinstance(compact, torch.Tensor):
        compact = compact.cpu().numpy()
    c = np.asarray(compact).astype(np.int32)
    if c.size and c[0] == COMPACT_UNAVAILABLE:
        raise ValueError(
            "compact evict result unavailable (node/job count exceeds the "
            "int16 packing); read res.assigned / res.evicted_by instead")
    return c[:n_tasks], c[n_tasks:]


def _prepare(arrays, victims, score_params, device):
    dev = resolve_device(device)
    task_job_h = _host_array(arrays["task_job"])
    a = to_torch_arrays(arrays, dev)
    v = to_torch_arrays(victims, dev)
    params = to_torch_params(score_params, dev)
    return dev, task_job_h, a, v, params


def solve_evict(arrays: Dict[str, object],
                victims: Dict[str, object],
                score_params: Dict[str, object],
                score_families: Tuple[str, ...] = ("kube",),
                require_freed_covers: bool = False,
                allow_revert: bool = True,
                stop_at_need: bool = True,
                device: Optional[object] = None) -> EvictResult:
    """One step per preemptor task, in (queue, job, task) rank order.

    arrays: a flatten of the *pending preemptor tasks* (ops.flatten_snapshot).
    victims: v_req [V,R] accounting resreq sorted by (node, cheapest-first);
      v_node [V] int32; v_valid [V] bool; elig [J,V] bool per preemptor job
      (tier-intersected Preemptable/Reclaimable verdicts + queue scoping);
      job_need [J] int32 pipelines still needed for JobPipelined.
    Both go to ``device`` (CUDA when None — raises without one;
    ``device="cpu"`` runs on the host).

    require_freed_covers: reclaim semantics — the freed victim resources
      alone must cover the claimer's request (reclaim.go:91-101), vs preempt
      where FutureIdle + freed must fit (preempt.go:219-240).
    allow_revert / stop_at_need: preempt's gang statement semantics; off for
      reclaim (evictions are immediate, jobs aren't capped at min).
    """
    dev, task_job_h, a, vic, params = _prepare(arrays, victims,
                                               score_params, device)
    v_req = vic["v_req"]
    v_node = vic["v_node"].long()
    v_valid = vic["v_valid"]
    elig = vic["elig"]
    need = vic["job_need"]
    T = a["task_init_req"].shape[0]
    N = a["node_idle"].shape[0]
    J = a["job_min"].shape[0]
    V = v_req.shape[0]
    thr = a["thresholds"]
    sm = a["scalar_dim_mask"]
    sig_feas = a["sig_masks"][a["task_sig"].long()] & a["node_valid"][None, :]
    future0 = a["node_idle"] + a["node_extra_future"]
    # node ordering scores, frozen at solve start: one [T,N] batch
    score_all = score_matrix(a["task_init_req"], future0, a["node_used"],
                             a["node_alloc"], params, score_families)
    seg_start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                           v_node[1:] != v_node[:-1]])
    vidx = torch.arange(V, device=dev)
    no_fit = torch.zeros(N, dtype=torch.bool, device=dev)

    st = {"future": future0, "alive": v_valid,
          "evby": torch.full((V,), -1, dtype=torch.int32, device=dev),
          "assigned": torch.full((T,), -1, dtype=torch.int32, device=dev),
          "jalloc": torch.zeros(J, dtype=torch.int32, device=dev)}

    def snapshot() -> None:
        st["s_future"], st["s_alive"], st["s_evby"] = \
            st["future"], st["alive"], st["evby"]
        st["s_assigned"] = st["assigned"].clone()

    def finalize(jidx: int) -> None:
        """Job boundary: revert this job's evictions and placements unless
        it reached JobPipelined (Statement.Discard, preempt.go:252-257)."""
        if not allow_revert:
            return
        jalloc = st["jalloc"]
        done = jalloc[jidx] >= need[jidx]
        for k in ("future", "alive", "evby", "assigned"):
            st[k] = torch.where(done, st[k], st["s_" + k])
        jalloc[jidx] = torch.where(done, jalloc[jidx], 0)

    cur_job = int(task_job_h[0])
    snapshot()
    for i in range(T):
        jidx = int(task_job_h[i])
        if jidx != cur_job:
            finalize(cur_job)
            snapshot()      # fresh snapshots for the job now starting
        cur_job = jidx
        future, alive, jalloc = st["future"], st["alive"], st["jalloc"]

        active = a["task_valid"][i]
        if stop_at_need:
            # a job stops preempting once pipelined (preempt.go:200-207)
            active = active & (jalloc[jidx] < need[jidx])

        elig_v = elig[jidx] & alive & v_valid
        vreq_m = v_req * elig_v[:, None]
        # exact: a node's victim prefix is independent of the victims
        # sorted before it (the sharded solve sums each shard's alone)
        prefix_incl = _segment_prefix(vreq_m, seg_start,
                                      exact=True) + vreq_m          # [V,R]
        p_fit = a["task_init_req"][i][None, :]
        if require_freed_covers:
            fit_at = le_fits(p_fit, prefix_incl, thr, sm) & elig_v
            fit_now = no_fit
        else:
            fit_at = le_fits(p_fit, future[v_node] + prefix_incl,
                             thr, sm) & elig_v
            fit_now = le_fits(p_fit, future, thr, sm)
        # minimal victim prefix per node ("cheapest-first until it fits")
        cut = _segment_min(torch.where(fit_at, vidx, V), v_node, N,
                           INT32_MAX)   # [N]
        # a node is only considered when it holds >= 1 eligible victim
        # (validate_victims errs on an empty victim list)
        has_v = _segment_any(elig_v, v_node, N)
        node_ok = has_v & (fit_now | (cut < V)) & sig_feas[i] & active
        got = torch.any(node_ok)
        choice = torch.argmax(torch.where(node_ok, score_all[i], NEG))
        c = torch.where(got, choice, 0)

        ev = (elig_v & (v_node == c) & (vidx <= cut[c])
              & got & ~fit_now[c])
        freed = torch.sum(v_req * ev[:, None], dim=0)
        # evictions raise the node's future idle; the pipelined preemptor
        # holds it back down (node_info.go:57-59 FutureIdle accounting)
        delta = torch.where(got, freed - a["task_req"][i], 0.0)
        st["future"] = future.index_add(0, c.view(1), delta[None, :])
        st["alive"] = alive & ~ev
        st["evby"] = torch.where(ev, jidx, st["evby"])
        st["assigned"][i] = torch.where(got, choice, -1)
        jalloc[jidx] += got.to(torch.int32)
    finalize(cur_job)
    assigned, evby = st["assigned"], st["evby"]
    return EvictResult(assigned=assigned, evicted_by=evby,
                       job_placed=st["jalloc"],
                       compact=_evict_compact(assigned, evby, N, J))


def absorb_counts(r, r_fit, sig, base, ptot, has_v, feas_n, thr, sm,
                  t_cap: float):
    """Per-node claimer-absorption counts for one uniform job: (m_all,
    f_n, cap_extra) where f_n = claimers fitting with NO eviction, m_all =
    max with all eligible victims freed, cap_extra = slots costing
    evictions. Floor + one-step le_fits-validated backoff, so the chosen
    count always fits and a victim cut always exists."""

    def fits_m(mm, av):
        return le_fits(mm[:, None] * r_fit[None, :], av, thr, sm,
                       ignore_req=r[None, :])

    def validated(av):
        per_dim = torch.where(sig[None, :],
                              torch.floor(av / torch.clamp(r, min=1e-9)),
                              INF)
        m = torch.amin(per_dim, dim=1)
        m = torch.clamp(torch.nan_to_num(m, nan=0.0, posinf=t_cap),
                        0.0, t_cap)
        back = torch.clamp(m - 1.0, min=0.0)
        return torch.where(fits_m(m, av), m,
                           torch.where(fits_m(back, av), back, 0.0))

    avail = base + ptot
    m = torch.where(feas_n & has_v, validated(avail), 0.0)
    f_n = torch.where(feas_n, validated(base), 0.0)
    m_all = torch.where(has_v, torch.maximum(m, f_n), f_n)
    return m_all, f_n, torch.clamp(m_all - f_n, min=0.0)


def spread_counts(count, score_j, m_all, f_all, cap_extra):
    """Eviction-minimal spread of `count` claimers over nodes: fill free
    capacity first in score order, then waterfill the remainder evenly
    across nodes (trimming the surplus from the lowest-scoring at-level
    nodes). Returns (c [N] int32, order [N] int32, cum [N] float32):
    order/cum drive the claimer-position -> node mapping. Sorts are stable, as
    JAX's are: ties between equal-score nodes decide which node evicts."""
    N = m_all.shape[0]
    dev = m_all.device
    count_f = count.to(torch.float32)
    order = torch.argsort(-score_j, stable=True)
    f_o = f_all[order]
    cum_f = torch.cumsum(f_o, dim=0)
    c_free_o = torch.minimum(
        torch.clamp(count_f - (cum_f - f_o), min=0.0), f_o)
    c_free = _scatter_set(order, c_free_o)
    D = torch.clamp(count_f - torch.sum(c_free), min=0.0)
    # waterfill level l* = smallest l with sum(min(cap_extra, l)) >= D
    srt = torch.sort(cap_extra, stable=True).values
    csum = torch.cumsum(srt, dim=0)
    S = csum + srt * (N - 1 - torch.arange(N, dtype=torch.float32,
                                           device=dev))
    hit = (S >= D).to(torch.int32)
    found = torch.any(S >= D)
    i0 = torch.argmax(hit)
    csum_prev = torch.where(i0 > 0, csum[torch.clamp(i0 - 1, min=0)], 0.0)
    seg = torch.clamp((N - i0).to(torch.float32), min=1.0)
    lvl = torch.ceil((D - csum_prev) / seg)
    lvl = torch.where(found, torch.clamp(lvl, min=0.0),
                      torch.clamp(torch.amax(cap_extra), min=0.0))
    c_extra = torch.minimum(cap_extra, lvl)
    surplus = torch.clamp(torch.sum(c_extra) - D, min=0.0)
    at_level = (c_extra >= lvl) & (lvl > 0)
    trim_order = torch.argsort(torch.where(at_level, score_j, INF),
                               stable=True)
    trim_pos = _scatter_set(trim_order,
                            torch.arange(N, dtype=torch.int32, device=dev))
    c_extra = c_extra - (at_level & (trim_pos < surplus)).to(torch.float32)
    c = (c_free + c_extra).to(torch.int32)
    cum = torch.cumsum(c[order], dim=0).to(torch.float32)
    return c, order.to(torch.int32), cum


def pack_victim_arrays(arr, victims, n_claim: int) -> Dict[str, np.ndarray]:
    """Build the solve_evict_uniform victim/job arrays for the common
    single-claiming-gang shape (job slot 0 claims ``n_claim`` uniform
    tasks; every ``victims`` TaskInfo is eligible)."""
    from .arrays import bucket

    node_index = {n.name: i for i, n in enumerate(arr.nodes_list)}
    ordered = sorted(victims, key=lambda t: node_index[t.node_name])
    V = bucket(max(len(ordered), 1))
    J = arr.job_min.shape[0]
    R = arr.R
    v_req = np.zeros((V, R), np.float32)
    v_node = np.zeros(V, np.int32)
    v_valid = np.zeros(V, bool)
    for i, t in enumerate(ordered):
        v_req[i] = t.resreq.to_vector(arr.vocab)
        v_node[i] = node_index[t.node_name]
        v_valid[i] = True
    elig = np.zeros((J, V), bool)
    elig[0, :len(ordered)] = True
    need = np.zeros(J, np.int32)
    need[0] = n_claim
    job_req = np.zeros((J, R), np.float32)
    job_req[0] = arr.task_init_req[0]
    job_acct = np.zeros((J, R), np.float32)
    job_acct[0] = arr.task_req[0]
    job_count = np.zeros(J, np.int32)
    job_count[0] = n_claim
    return {"v_req": v_req, "v_node": v_node, "v_valid": v_valid,
            "elig": elig, "job_need": need, "job_req": job_req,
            "job_acct": job_acct, "job_count": job_count}


def solve_evict_uniform(arrays: Dict[str, object],
                        victims: Dict[str, object],
                        score_params: Dict[str, object],
                        score_families: Tuple[str, ...] = ("kube",),
                        require_freed_covers: bool = False,
                        stop_at_need: bool = True,
                        device: Optional[object] = None) -> EvictResult:
    """Per-JOB closed-form eviction solve for uniform claimers.

    When every pending claimer of a job has the same request (the gang
    case), the whole job places in one step: per node, the candidate count
    floor((future + total-freeable) / request) is validated by le_fits
    (one-step backoff, zero fallback); claimers spread across nodes in
    score order; the minimal cheapest-first victim prefix covering each
    node's count is evicted. Gang all-or-nothing is exact — a job whose
    total placeable count misses its need places (and evicts) nothing, so
    no revert pass exists. One step per job instead of per claimer.

    PREEMPT ONLY: reclaim's per-claimer coverage rule is not a per-node
    divisibility, so reclaim stays on the per-task solve
    (require_freed_covers is accepted for kernel-level tests only).

    victims: as solve_evict, plus job_req [J,R] (the per-job uniform FIT
    request / init_resreq), job_acct [J,R] (the uniform accounting resreq
    debited from future, node_info.go AddTask), and job_count [J].
    """
    dev, _, a, vic, params = _prepare(arrays, victims, score_params, device)
    v_req = vic["v_req"]
    v_node = vic["v_node"].long()
    v_valid = vic["v_valid"]
    elig = vic["elig"]
    need = vic["job_need"]
    job_req = vic["job_req"]          # [J,R] fit request
    job_acct = vic["job_acct"]        # [J,R] accounting request
    job_count = vic["job_count"]      # [J]
    T = a["task_init_req"].shape[0]
    N = a["node_idle"].shape[0]
    V = v_req.shape[0]
    J = a["job_min"].shape[0]
    thr = a["thresholds"]
    sm = a["scalar_dim_mask"]
    tj = a["task_job"].long()
    future = a["node_idle"] + a["node_extra_future"]
    # requests are uniform per job: score [J,N] directly instead of [T,N]
    job_score = score_matrix(job_req, future, a["node_used"],
                             a["node_alloc"], params, score_families)
    seg_start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                           v_node[1:] != v_node[:-1]])
    vidx = torch.arange(V, device=dev)
    # per-job node feasibility mask (claimers of one job share a signature
    # in the uniform case; take the AND over the job's tasks to stay safe)
    sig_feas_t = a["sig_masks"][a["task_sig"].long()] \
        | ~a["task_valid"][:, None]
    job_feas = torch.ones((J, N), dtype=torch.int32, device=dev) \
        .scatter_reduce(0, tj[:, None].expand(T, N),
                        sig_feas_t.to(torch.int32), "amin",
                        include_self=True) > 0
    # position of each task within its job (contiguous grouping)
    arange_t = torch.arange(T, dtype=torch.int32, device=dev)
    first_task = torch.full((J,), T - 1, dtype=torch.int32, device=dev) \
        .scatter_reduce(0, tj, arange_t, "amin", include_self=True)
    task_pos = arange_t - first_task[tj]
    zeros_nr = torch.zeros_like(future)

    alive = v_valid
    evby = torch.full((V,), -1, dtype=torch.int32, device=dev)
    assigned = torch.full((T,), -1, dtype=torch.int32, device=dev)
    jalloc = torch.zeros(J, dtype=torch.int32, device=dev)
    for j in range(J):
        r = job_req[j]                                             # [R]
        # per-dim significance mirrors le_fits' per-task rule: scalar dims
        # requesting <= 10 milli are ignored for FIT (r_fit zeroed) but
        # still debited for accounting, like the per-task solve
        sig = torch.where(sm, r > 10.0, r > 0.0)                   # [R]
        r_fit = torch.where(sig, r, 0.0)
        count = (torch.minimum(job_count[j], need[j]) if stop_at_need
                 else job_count[j])
        active = a["job_valid"][j] & (count > 0)

        elig_v = elig[j] & alive & v_valid
        vreq_m = v_req * elig_v[:, None]
        prefix_incl = _segment_prefix(vreq_m, seg_start,
                                      exact=True) + vreq_m        # [V,R]
        ptot = _segment_sum(vreq_m, v_node, N)                     # [N,R]
        has_v = _segment_any(elig_v, v_node, N)
        base = zeros_nr if require_freed_covers else future
        # per-node absorption counts (free-capacity slots included —
        # eviction minimality means spending idle capacity before killing
        # anything)
        feas_n = job_feas[j] & a["node_valid"]
        m_all, f_n, cap_extra = absorb_counts(
            r, r_fit, sig, base, ptot, has_v, feas_n, thr, sm, float(T))

        total = torch.sum(m_all).to(torch.int32)
        # gang: need `need[j]` pipelines; if unreachable place nothing
        do = active & (total > 0)
        if stop_at_need:
            do = do & (total >= need[j])
        count = torch.where(do, torch.minimum(count, total), 0)

        # eviction-minimal spread: fill free capacity first, then
        # waterfill the remainder evenly so no node over-evicts while
        # another sits on idle victims
        score_j = torch.where(m_all > 0, job_score[j], NEG)
        c, order, cum = spread_counts(count, score_j, m_all, f_n,
                                      cap_extra)

        # task -> node: claimer position p lands on the node where the
        # score-ordered cumulative count first exceeds p
        is_mine = (tj == j) & a["task_valid"]
        node_for_p = order[torch.clamp(
            torch.searchsorted(cum, task_pos.to(cum.dtype), right=True),
            0, N - 1)]
        placed_t = is_mine & (task_pos < count)
        assigned = torch.where(placed_t, node_for_p.to(torch.int32),
                               assigned)

        # minimal victim prefix per node covering c_n * r beyond future;
        # demand_fit drops the insignificant dims, accounting debits the
        # RUNNING request (node_info.go AddTask subtracts Resreq)
        c_f = c.to(torch.float32)[:, None]
        demand_fit = c_f * r_fit[None, :]
        demand_acct = c_f * job_acct[j][None, :]
        fit_now_n = le_fits(demand_fit, base, thr, sm,
                            ignore_req=demand_fit)
        need_evict_n = (c > 0) & ~fit_now_n
        fit_at = le_fits(demand_fit[v_node], base[v_node] + prefix_incl,
                         thr, sm, ignore_req=demand_fit[v_node]) & elig_v
        cut = _segment_min(torch.where(fit_at, vidx, V), v_node, N,
                           INT32_MAX)
        # cut < V is guaranteed by the conservative m; the guard keeps a
        # never-satisfiable fit from mass-evicting the whole node
        ev = (elig_v & need_evict_n[v_node] & (vidx <= cut[v_node])
              & (cut[v_node] < V))
        freed = _segment_sum(v_req * ev[:, None], v_node, N)
        future = future + freed - demand_acct
        alive = alive & ~ev
        evby = torch.where(ev, j, evby)
        jalloc[j] += count.to(torch.int32)
    return EvictResult(assigned=assigned, evicted_by=evby,
                       job_placed=jalloc,
                       compact=_evict_compact(assigned, evby, N, J))
