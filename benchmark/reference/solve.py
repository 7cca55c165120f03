"""The allocate solve as plain PyTorch on the host: a frozen copy.

This is the arithmetic of Volcano's round-based allocate solver as the
program under test states it (its ops/solver.py, dense path, and the
score of its fused choice kernel), copied here so that a later change to
the program cannot change the yardstick: each round every unassigned
task picks its best feasible node (waterfall herd targeting), nodes admit
by priority-ordered prefix sums, a gang fixpoint reverts jobs that cannot
reach minMember, proportion caps each queue at its water-filled deserved
share, and drf (or the drf hierarchy, ``hdrf.py``) re-ranks jobs every
round. Float sums that the device orders freely run in float64 and round
once, as the program's do.

``score_dtype`` computes the node scores in another precision: the
control that a lower-precision score must fail the comparison.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

NEG = -1e30
REL_FIT_TOL = float(np.float32(5e-7))
BIG_KEY = 2**31 - 1
INF = float("inf")
INT32_MAX = 2**31 - 1


class Solution(NamedTuple):
    assigned: torch.Tensor   # [T] node index or -1
    kind: torch.Tensor       # [T] 0 allocate, 1 pipeline, -1 none
    job_ready: torch.Tensor  # [J] bool


def _stable_argsort(x):
    return torch.argsort(x, stable=True)


def _lexsort(keys):
    """The LAST key is the primary one; stable throughout."""
    perm = _stable_argsort(keys[0])
    for k in keys[1:]:
        perm = perm[_stable_argsort(k[perm])]
    return perm


def _segment_sum(vals, idx, n: int):
    acc = torch.float64 if vals.is_floating_point() else vals.dtype
    out = torch.zeros((n,) + tuple(vals.shape[1:]), dtype=acc,
                      device=vals.device)
    return out.index_add_(0, idx, vals.to(acc)).to(vals.dtype)


def _exact_sum(vals, dim: int):
    return torch.sum(vals.to(torch.float64), dim=dim).to(vals.dtype)


def _segment_min(vals, idx, n: int, fill):
    out = torch.full((n,), fill, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(0, idx, vals, "amin", include_self=True)


def _segment_any(flags, idx, n: int):
    out = torch.full((n,), -INT32_MAX - 1, dtype=torch.int32,
                     device=flags.device)
    return out.scatter_reduce_(0, idx, flags.to(torch.int32), "amax",
                               include_self=True) > 0


def _scatter_set(perm, vals):
    out = torch.empty_like(vals)
    out[perm] = vals
    return out


def _segment_prefix(sorted_vals, seg_start_mask, exact: bool = False):
    """Exclusive prefix sum within segments (``exact``: in float64)."""
    if exact:
        vals_t = sorted_vals.to(torch.float64).t().contiguous()
        csum = torch.cumsum(vals_t, dim=1).t()
        vals = vals_t.t()
    else:
        vals = sorted_vals
        csum = torch.cumsum(vals, dim=0)
    excl = csum - vals
    idx = torch.arange(sorted_vals.shape[0], device=sorted_vals.device)
    start_idx = torch.where(seg_start_mask, idx, -1)
    start_idx = torch.cummax(start_idx, dim=0).values
    base = excl[torch.clamp(start_idx, min=0)]
    return (excl - base).to(sorted_vals.dtype)


def le_fits(lhs, avail, thr, scalar_mask, ignore_req=None):
    """Threshold-tolerant LessEqual over the trailing resource axis."""
    dim_ok = (lhs < avail + (thr + REL_FIT_TOL * torch.abs(avail))) \
        | (lhs <= avail)
    req = lhs if ignore_req is None else ignore_req
    return torch.all(dim_ok | (scalar_mask & (req <= 10.0)), dim=-1)


def pack_pars(params, R: int):
    """[binpack, least, most, balanced, 100 / sum(w), w_0..w_{R-1}]."""
    w = params["binpack_res_weights"].to(torch.float32)
    wsum = torch.clamp(torch.sum(w), min=1e-9)
    head = torch.stack([
        params["binpack_weight"].to(torch.float32).reshape(()),
        params["least_req_weight"].to(torch.float32).reshape(()),
        params["most_req_weight"].to(torch.float32).reshape(()),
        params["balanced_weight"].to(torch.float32).reshape(()),
        torch.full_like(wsum, 100.0) / wsum,
    ])
    return torch.cat([head, w[:R]])


def score(init_req, used, inv_alloc, node_static, pars, families,
          dtype=torch.float32):
    """[T,N] node scores: binpack (task and node sums kept apart per
    dimension), then least-requested, most-requested and balanced
    allocation; this float operation order decides argmax ties."""
    if dtype != torch.float32:
        init_req, used, inv_alloc, node_static, pars = (
            x.to(dtype) for x in (init_req, used, inv_alloc, node_static,
                                  pars))
    T, R = init_req.shape
    N = used.shape[0]
    dev = init_req.device
    out = torch.zeros((T, N), dtype=dtype, device=dev)
    if "binpack" in families:
        bp_task = torch.zeros((T, N), dtype=dtype, device=dev)
        bp_node = torch.zeros((N,), dtype=dtype, device=dev)
        for r in range(R):
            w_r = pars[5 + r]
            bp_task = bp_task + init_req[:, r:r + 1] * (w_r * inv_alloc[:, r])
            bp_node = bp_node + (used[:, r] * w_r) * inv_alloc[:, r]
        out = out + pars[0] * (bp_task + bp_node) * pars[4]
    if "kube" in families:
        f0 = (used[:, 0] + init_req[:, 0:1]) * inv_alloc[:, 0]
        f1 = (used[:, 1] + init_req[:, 1:2]) * inv_alloc[:, 1]
        least = ((torch.clamp(1.0 - f0, 0.0, 1.0)
                  + torch.clamp(1.0 - f1, 0.0, 1.0)) / 2.0) * 100.0
        most = ((torch.clamp(f0, 0.0, 1.0)
                 + torch.clamp(f1, 0.0, 1.0)) / 2.0) * 100.0
        balanced = (1.0 - torch.abs(f0 - f1)) * 100.0
        out = out + (pars[1] * least + pars[2] * most + pars[3] * balanced)
    return (out + node_static).to(torch.float32)


def water_fill_deserved(total, weight, cap, request, thr, max_iters: int):
    deserved = torch.zeros_like(request)
    meet = weight <= 0
    remaining = total
    it = 0
    while it < max_iters:
        live_w = torch.where(meet, torch.zeros_like(weight), weight)
        tw = torch.sum(live_w)
        if not bool((tw > 0) & torch.any(remaining >= thr)):
            break
        frac = live_w / torch.clamp(tw, min=1e-9)
        old = deserved
        grown = deserved + frac[:, None] * remaining[None, :]
        cap_viol = torch.any(grown > cap, dim=1)
        req_less = torch.all(request < grown, dim=1)
        clamped = torch.where(
            cap_viol[:, None],
            torch.minimum(torch.minimum(grown, cap), request),
            torch.where(req_less[:, None], torch.minimum(grown, request),
                        grown))
        deserved = torch.where(meet[:, None], deserved, clamped)
        meet = meet | cap_viol | req_less
        remaining = torch.clamp(
            remaining - _exact_sum(deserved - old, 0), min=0.0)
        it += 1
    return deserved


def drf_state(a, rank):
    """(jobres0, drf_rank, drf_cap): live dominant-share re-rank and the
    progressive-filling cap."""
    tj = a["task_job"].long()
    T = a["task_rank"].shape[0]
    J = a["job_min"].shape[0]
    dev = tj.device
    rank = a["task_rank"] if rank is None else rank
    first_rank = torch.full((J,), T, dtype=rank.dtype, device=dev) \
        .scatter_reduce(0, tj, rank, "amin", include_self=True)
    within_rank = rank - first_rank[tj]
    drf_total = torch.clamp(a["drf_total"], min=1e-9)
    has_total = a["drf_total"] > 0.0
    incr_t = torch.amax(
        torch.where(has_total[None, :], a["task_req"] / drf_total[None, :],
                    0.0), dim=1)
    j_seg_start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                             tj[1:] != tj[:-1]])

    def drf_share(jobres):
        s = torch.amax(
            torch.where(has_total[None, :], jobres / drf_total[None, :],
                        0.0), dim=1)
        return torch.where(a["job_valid"], s, INF)

    prerank = a["job_drf_prerank"]
    arange_j = torch.arange(J, dtype=torch.int32, device=dev)
    arange_t = torch.arange(T, dtype=torch.int32, device=dev)

    def drf_rank(jobres):
        order_j = _lexsort((drf_share(jobres), prerank))
        job_pos = _scatter_set(order_j, arange_j)
        order_t = _lexsort((within_rank, job_pos[tj]))
        return _scatter_set(order_t, arange_t)

    def drf_cap(eligible, jobres):
        s = drf_share(jobres)
        elig_job = torch.zeros(J, dtype=torch.int32, device=dev).scatter_reduce(
            0, tj, eligible.to(torch.int32), "amax", include_self=True) > 0
        n_elig = torch.clamp(torch.sum(elig_job), min=1)
        grp = torch.clamp(prerank, 0, J - 1).long()
        m_grp = torch.full((J,), INF, dtype=torch.float32, device=dev).scatter_reduce(
            0, grp, torch.where(elig_job, s, INF), "amin",
            include_self=True)
        m = m_grp[grp]
        max_incr = torch.amax(torch.where(eligible, incr_t, 0.0))
        step = torch.maximum(max_incr, 1.0 / (8.0 * n_elig))
        allowed = torch.maximum(s, m) + step
        cum = _segment_prefix((incr_t * eligible)[:, None], j_seg_start,
                              exact=True)[:, 0] + incr_t
        return eligible & (s[tj] + cum <= allowed[tj] + 1e-6)

    return a["job_drf_allocated"], drf_rank, drf_cap


def queue_cap_state(a, rank, thr, total, ease_unrequested: bool = True):
    q = a["queue_weight"].shape[0]
    deserved = water_fill_deserved(
        total, a["queue_weight"], a["queue_capability"],
        a["queue_request"], thr, max_iters=q + 1)
    if ease_unrequested:
        deserved = torch.where(a["queue_request"] > thr[None, :],
                               deserved, INF)
    task_queue = a["job_queue"].long()[a["task_job"].long()]
    t = task_queue.shape[0]
    q_perm = _stable_argsort(task_queue * (t + 1) + rank.long())
    s_q = task_queue[q_perm]
    dev = s_q.device
    q_seg_start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                             s_q[1:] != s_q[:-1]])
    return q, deserved, task_queue, q_perm, q_seg_start


def _queue_cap_mask(eligible, task_queue, req, qrem, thr, scalar_mask,
                    q_perm, q_seg_start):
    s_q = task_queue[q_perm]
    s_req_raw = req[q_perm]
    s_act = eligible[q_perm]
    s_rem = qrem[s_q]
    s_fits_alone = le_fits(s_req_raw, s_rem, thr, scalar_mask,
                           ignore_req=s_req_raw) & s_act
    s_req = s_req_raw * s_fits_alone[:, None]
    prefix = _segment_prefix(s_req, q_seg_start, exact=True)
    ok_sorted = le_fits(prefix + s_req, s_rem, thr, scalar_mask,
                        ignore_req=s_req) & s_fits_alone
    return _scatter_set(q_perm, ok_sorted)


def _herd_target(eligible, node_score, fit_req, avail, npods, max_pods,
                 thr, scalar_mask, mode: str):
    """Pre-assign eligible task positions to nodes in herd desirability
    order: pack fills each node to its slots of the mean request, spread
    stripes over the nodes tied for best."""
    T = eligible.shape[0]
    N = node_score.shape[0]
    n_elig = torch.clamp(torch.sum(eligible), min=1)
    mean_req = _exact_sum(fit_req * eligible[:, None], 0) / n_elig
    sig = mean_req > torch.where(scalar_mask, 10.0, 0.0)
    slots_dim = torch.where(
        sig[None, :],
        torch.floor((avail + thr[None, :])
                    / torch.clamp(mean_req[None, :], min=1e-9)),
        INF)
    slots = torch.amin(slots_dim, dim=1)
    slots = torch.minimum(slots, (max_pods - npods).to(torch.float32))
    slots = torch.clamp(slots, 0.0, float(T))
    has_slot = slots > 0
    masked_score = torch.where(has_slot, node_score, NEG)
    order = _stable_argsort(-masked_score)
    pos = torch.cumsum(eligible.to(torch.int32), dim=0) - 1
    if mode == "spread":
        best_s = torch.amax(masked_score)
        eps = 1e-5 * torch.clamp(torch.abs(best_s), min=1.0)
        near = has_slot & (masked_score >= best_s - eps)
        m = torch.clamp(torch.sum(near), min=1)
        return order[torch.remainder(torch.clamp(pos, min=0), m)]
    cum = torch.cumsum(slots[order], dim=0)
    idx = torch.searchsorted(cum, pos.to(torch.float32), right=True)
    return order[torch.clamp(idx, 0, N - 1)]


def _admit_prefix(choice, fit_req, acct_req, avail, rank, thr, scalar_mask,
                  npods, max_pods):
    """Per node, in priority order, admit while the prefix of requests
    fits the node's idle and its pod count."""
    T = choice.shape[0]
    N = avail.shape[0]
    dev = choice.device
    key = torch.where(choice >= 0, choice * (T + 1) + rank.long(), BIG_KEY)
    perm = _stable_argsort(key)
    s_choice = choice[perm]
    s_active = s_choice >= 0
    s_fit = fit_req[perm] * s_active[:, None]
    seg_start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                           s_choice[1:] != s_choice[:-1]])
    prefix = _segment_prefix(s_fit, seg_start, exact=True)
    s_node = torch.clamp(s_choice, min=0)
    fits = le_fits(prefix + s_fit, avail[s_node], thr, scalar_mask,
                   ignore_req=s_fit) & s_active
    ones = torch.ones((T, 1), dtype=torch.float32, device=dev)
    pos = _segment_prefix(ones, seg_start)[:, 0]
    pods_fit = (npods[s_node] + pos) < max_pods[s_node]
    admit = _scatter_set(perm, fits & pods_fit)
    new_assign = torch.where(admit, choice, -1)
    node = torch.clamp(choice, min=0)
    debit = _segment_sum(acct_req * admit[:, None], node, N)
    pod_inc = _segment_sum(admit.to(torch.int32), node, N)
    return new_assign, debit, pod_inc


def _admission_round(eligible, feas, sc, fit_req, acct_req, avail, rank,
                     thr, scalar_mask, npods, max_pods, herd_mode: str):
    pods_ok = (npods < max_pods)[None, :]
    feas = feas & pods_ok & eligible[:, None]
    masked = torch.where(feas, sc, NEG)
    personal = torch.argmax(masked, dim=1)
    if herd_mode in ("pack", "spread"):
        node_score = torch.amax(masked, dim=0)
        target = _herd_target(eligible, node_score, fit_req, avail, npods,
                              max_pods, thr, scalar_mask, herd_mode)
        t_ok = feas.gather(1, target[:, None])[:, 0]
        choice = torch.where(t_ok, target, personal)
    else:
        choice = personal
    has = feas.gather(1, choice[:, None])[:, 0]
    choice = torch.where(has, choice, -1)
    return _admit_prefix(choice, fit_req, acct_req, avail, rank, thr,
                         scalar_mask, npods, max_pods)


class _State:
    __slots__ = ("idle", "pipe", "npods", "qalloc", "jobres", "assigned",
                 "kind", "excluded", "rounds")

    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)


def solve(arrays: Dict[str, np.ndarray], params: Dict[str, np.ndarray],
          herd_mode: str, score_families: Tuple[str, ...],
          use_queue_cap: bool, use_drf_order: bool, use_hdrf_order: bool,
          work_conserving: bool = True, max_rounds: int = 64,
          max_gang_iters: int = 12, score_dtype=torch.float32,
          device="cpu") -> Solution:
    """The round-based allocate + pipeline solve with gang semantics, on
    ``device``."""
    dev = torch.device(device)
    a = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
         for k, v in arrays.items()}
    p = {k: torch.from_numpy(np.asarray(v)).to(dev)
         for k, v in params.items()}
    T = a["task_init_req"].shape[0]
    N = a["node_idle"].shape[0]
    R = a["task_init_req"].shape[1]
    J = a["job_min"].shape[0]
    thr = a["thresholds"]
    scalar_mask = a["scalar_dim_mask"]
    tj = a["task_job"].long()
    rank0 = a["task_rank"]
    sig_feas = a["sig_masks"][a["task_sig"].long()] & a["node_valid"][None, :]
    task_req = a["task_req"]
    init_req = a["task_init_req"]
    inv_alloc = 1.0 / a["node_alloc"]
    pars = pack_pars(p, R)
    node_static = p["node_static"].to(torch.float32)

    # per-queue deserved caps (proportion)
    if use_queue_cap:
        total = torch.sum(a["node_alloc"]
                          * a["node_valid"][:, None].to(torch.float32), dim=0)
        Q, deserved, task_queue, q_perm, q_seg_start = queue_cap_state(
            a, rank0, thr, total, ease_unrequested=work_conserving)
        qalloc0 = a["queue_allocated"]
    else:
        qalloc0 = torch.zeros((1, R), dtype=torch.float32, device=dev)
    use_hdrf = use_drf_order and use_hdrf_order
    if use_drf_order:
        jobres0, drf_rank, drf_cap = drf_state(a, rank0)
        if use_hdrf:
            from .hdrf import hdrf_state
            hdrf_rank_cap = hdrf_state(a, rank0)
    else:
        jobres0 = torch.zeros((1, R), dtype=torch.float32, device=dev)

    def queue_cap(eligible, qalloc, bound, order=None):
        qrem = torch.clamp(bound - qalloc, min=0.0)
        qp = q_perm if order is None else _lexsort((order, task_queue))
        return _queue_cap_mask(eligible, task_queue, task_req, qrem, thr,
                               scalar_mask, qp, q_seg_start)

    def fair_order(st, eligible, capped, placeable):
        if use_hdrf:
            r_rank, eligible = hdrf_rank_cap(eligible & placeable, st.jobres)
        elif use_drf_order:
            r_rank = drf_rank(st.jobres)
            eligible = drf_cap(eligible, st.jobres)
        else:
            r_rank = rank0
        if use_queue_cap:
            bound = deserved if capped else a["queue_capability"]
            eligible = eligible & queue_cap(
                eligible, st.qalloc, bound,
                r_rank if use_drf_order else None)
        return r_rank, eligible

    def account(st, tasks, sign: int):
        req = task_req * tasks[:, None]
        if use_queue_cap:
            q = _segment_sum(req, task_queue, Q)
            st.qalloc = st.qalloc + q if sign > 0 else st.qalloc - q
        if use_drf_order:
            j = _segment_sum(req, tj, J)
            st.jobres = st.jobres + j if sign > 0 else st.jobres - j

    def job_ready(st):
        placed = (st.assigned >= 0) & (st.kind == 0)
        counts = _segment_sum(
            placed.to(torch.int32) * a["task_counts_ready"].to(torch.int32),
            tj, J)
        return ((a["job_ready_base"] + counts) >= a["job_min"]) \
            & a["job_valid"]

    def phase_rounds(st, use_future: bool, capped: bool = True, gate=None):
        any_eligible = torch.any(a["task_valid"] & (st.assigned < 0)
                                 & ~st.excluded[tj])
        if gate is not None:
            any_eligible = any_eligible & gate
        changed = bool(any_eligible)
        while changed and st.rounds < max_rounds:
            avail = (st.idle + a["node_extra_future"] - st.pipe) \
                if use_future else st.idle
            eligible = (a["task_valid"] & (st.assigned < 0)
                        & ~st.excluded[tj])
            used_now = a["node_used"] + (a["node_idle"] - st.idle)
            feas = le_fits(init_req[:, None, :], avail[None, :, :], thr,
                           scalar_mask) & sig_feas
            placeable = None
            if use_hdrf:
                placeable = torch.any(
                    feas & (st.npods < a["node_max_pods"])[None, :], dim=1)
            r_rank, eligible = fair_order(st, eligible, capped, placeable)
            sc = score(init_req, used_now, inv_alloc, node_static, pars,
                       score_families, score_dtype)
            new_assign, debit, pod_inc = _admission_round(
                eligible, feas, sc, init_req, task_req, avail, r_rank, thr,
                scalar_mask, st.npods, a["node_max_pods"], herd_mode)
            got = new_assign >= 0
            st.assigned = torch.where(got, new_assign.to(torch.int32),
                                      st.assigned)
            st.kind = torch.where(got, 1 if use_future else 0, st.kind)
            account(st, got, 1)
            if use_future:
                st.pipe = st.pipe + debit
            else:
                st.idle = st.idle - debit
                st.npods = st.npods + pod_inc
            st.rounds += 1
            changed = bool(torch.any(got))

    has_future = torch.any(a["node_extra_future"] > 0.0)

    def run_phases(excluded):
        st.excluded = excluded
        phase_rounds(st, use_future=False)
        phase_rounds(st, use_future=True, gate=has_future)
        if use_queue_cap and work_conserving:
            if use_drf_order:
                phase_rounds(st, use_future=False, capped=False)
                phase_rounds(st, use_future=True, capped=False,
                             gate=has_future)
            else:
                rem = (a["task_valid"] & (st.assigned < 0)
                       & ~st.excluded[tj])
                capped_out = torch.any(
                    rem & ~queue_cap(rem, st.qalloc, deserved))
                phase_rounds(st, use_future=False, capped=False,
                             gate=capped_out)
                phase_rounds(st, use_future=True, capped=False,
                             gate=capped_out & has_future)

    def credit(revert_task):
        node = torch.clamp(st.assigned, min=0).long()
        st.idle = st.idle + _segment_sum(task_req * revert_task[:, None],
                                         node, N)
        st.npods = st.npods - _segment_sum(revert_task.to(torch.int32),
                                           node, N)

    st = _State(idle=a["node_idle"], pipe=torch.zeros_like(a["node_idle"]),
                npods=a["node_npods"], qalloc=qalloc0, jobres=jobres0,
                assigned=torch.full((T,), -1, dtype=torch.int32, device=dev),
                kind=torch.full((T,), -1, dtype=torch.int32, device=dev),
                excluded=~a["job_valid"], rounds=0)

    # the gang fixpoint: run the phases, revert jobs that got allocations
    # but are not ready (their freed resources may admit others); a job
    # reverted twice is deferred to a solo retry in rank order, and a solo
    # retry that reverts again excludes it for good
    job_first_rank = torch.full((J,), T, dtype=rank0.dtype, device=dev).scatter_reduce(
        0, tj, torch.where(a["task_valid"], rank0, T), "amin",
        include_self=True)
    arange_j = torch.arange(J, device=dev)
    excluded = ~a["job_valid"]
    revert_count = torch.zeros(J, dtype=torch.int32, device=dev)
    deferred = torch.zeros(J, dtype=torch.bool, device=dev)
    processed = torch.zeros(J, dtype=torch.bool, device=dev)
    any_more = True
    it = 0
    while any_more and it < max_gang_iters:
        unproc = deferred & ~processed & ~excluded
        cur = torch.argmin(torch.where(unproc, job_first_rank, BIG_KEY))
        solo = unproc & (arange_j == cur)
        barred = deferred & ~solo
        run_phases(excluded | barred)
        placed = (st.assigned >= 0) & (st.kind == 0)
        has_alloc = _segment_sum(placed.to(torch.int32), tj, J) > 0
        revert_job = ~job_ready(st) & a["job_valid"] & ~excluded \
            & ~barred & has_alloc
        revert_task = revert_job[tj] & placed
        credit(revert_task)
        account(st, revert_task, -1)
        st.assigned = torch.where(revert_task, -1, st.assigned)
        st.kind = torch.where(revert_task, -1, st.kind)
        revert_count = revert_count + revert_job.to(torch.int32)
        excluded = excluded | (solo & revert_job)
        processed = processed | (solo & torch.any(unproc))
        deferred = deferred | (revert_job & (revert_count >= 2))
        any_more = bool(torch.any(revert_job)
                        | torch.any(deferred & ~processed & ~excluded))
        it += 1
    return Solution(st.assigned, st.kind, job_ready(st))
