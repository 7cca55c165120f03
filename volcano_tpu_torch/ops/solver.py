"""Allocate solver: batched task x node constraint satisfaction in PyTorch.

The round-based parallel solver of the JAX package (volcano_tpu's
``ops/solver.py::solve_allocate``), with the same semantics: each round
every unassigned task picks its best feasible node, per-node admission
happens by priority-ordered prefix sums, resources are debited with
segment sums, and a gang fixpoint loop reverts jobs that can't reach
min_available (the Statement.Discard semantics). Tasks that fit Idle
nowhere may pipeline onto FutureIdle = Idle + Releasing - Pipelined.

The JAX version runs as one jitted program with ``lax.while_loop``s. Here
the loops are Python loops over device tensors, bounded by the same
``max_rounds`` / ``max_gang_iters``; each round's "anything changed" flag
is read back to the host (one sync per round).

Each round's [T,N] choice runs either densely (``fits_matrix`` +
``score_matrix`` + argmax, the ``fused="off"`` path) or through the fused
CUDA kernel (``ops.fused_choice``), which never writes the [T,N] matrices
to device memory.

Semantics notes (mirroring the Go data model):
- fit check uses the launch request (InitResreq <= Idle, LessEqual with
  per-dim thresholds: l < r + thr; scalar dims with request <= 10 milli are
  ignored) — resource_info.go LessEqual.
- accounting debits the running request (NodeInfo.AddTask subtracts Resreq).
- gang: a job commits only if ready_base + newly_allocated >= min_available;
  pipelined tasks do not count toward readiness (job_info.go:317-377).

Sorts are stable (``torch.argsort(stable=True)``), as JAX's are: tied keys
keep index order, and tied node scores decide placements.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .convert import resolve_device, to_torch_arrays, to_torch_params
from .fused_choice import (
    NEG, REL_FIT_TOL, _score, fused_choice, fused_setup, pack_pars,
)

BIG_KEY = 2**31 - 1
INF = float("inf")
INT32_MAX = 2**31 - 1


class SolveResult(NamedTuple):
    assigned: torch.Tensor   # [T] int32 node index or -1
    kind: torch.Tensor       # [T] int32: 0 = allocate, 1 = pipeline, -1 = none
    job_ready: torch.Tensor  # [J] bool: job committed (gang-satisfied)
    rounds: torch.Tensor     # [] int32 diagnostic
    compact: torch.Tensor = None  # [T] int16: node | (kind << 14), -1 = none


COMPACT_KIND_SHIFT = 14        # node index < 2^14; kind bit above it
COMPACT_UNAVAILABLE = -2       # whole-array sentinel: N too large to pack


def _compact(assigned, kind, n_nodes: int):
    if n_nodes > (1 << COMPACT_KIND_SHIFT):
        # node indices don't fit 14 bits: a detectable sentinel, so a
        # consumer that forgets the N guard fails in decode_compact
        return torch.full(assigned.shape, COMPACT_UNAVAILABLE,
                          dtype=torch.int16, device=assigned.device)
    packed = (assigned + kind * (1 << COMPACT_KIND_SHIFT)).to(torch.int16)
    return torch.where(assigned < 0,
                       torch.full_like(packed, -1), packed)


def decode_compact(compact):
    """host-side: compact int16 -> (assigned int32, kind int32) numpy."""
    if isinstance(compact, torch.Tensor):
        compact = compact.cpu().numpy()
    c = np.asarray(compact).astype(np.int32)
    if c.size and c[0] == COMPACT_UNAVAILABLE:
        raise ValueError(
            "compact result unavailable (node count exceeds the int16 "
            "packing); read res.assigned / res.kind instead")
    none = c < 0
    kind = np.where(none, -1, c >> COMPACT_KIND_SHIFT)
    assigned = np.where(none, -1, c & ((1 << COMPACT_KIND_SHIFT) - 1))
    return assigned, kind


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def _stable_argsort(x):
    return torch.argsort(x, stable=True)


def _lexsort(keys):
    """jnp.lexsort: the LAST key is the primary one; stable throughout.
    Successive stable argsorts, least significant key first."""
    perm = _stable_argsort(keys[0])
    for k in keys[1:]:
        perm = perm[_stable_argsort(k[perm])]
    return perm


def _segment_sum(vals, idx, n: int):
    out = torch.zeros((n,) + tuple(vals.shape[1:]), dtype=vals.dtype,
                      device=vals.device)
    return out.index_add_(0, idx, vals)


def _segment_min(vals, idx, n: int, fill):
    """jax.ops.segment_min: an empty segment reads ``fill``, JAX's value
    for it (+inf for floats, INT32_MAX for int32)."""
    out = torch.full((n,), fill, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(0, idx, vals, "amin", include_self=True)


def _segment_any(flags, idx, n: int):
    """jax.ops.segment_max(flags.astype(int32)) > 0: an empty segment reads
    INT32_MIN, so it is False."""
    out = torch.full((n,), -INT32_MAX - 1, dtype=torch.int32,
                     device=flags.device)
    return out.scatter_reduce_(0, idx, flags.to(torch.int32), "amax",
                               include_self=True) > 0


def _scatter_set(perm, vals):
    """zeros_like(vals).at[perm].set(vals)."""
    out = torch.empty_like(vals)
    out[perm] = vals
    return out


def le_fits(lhs, avail, thr, scalar_mask, ignore_req=None):
    """Threshold-tolerant LessEqual reduced over the trailing resource axis
    (resource_info.go LessEqual): a dim fits iff lhs < avail + thr OR
    lhs <= avail — the <= disjunct keeps exact fits feasible, because at
    memory magnitudes the threshold vanishes in float32. Scalar dims whose
    request (ignore_req, default lhs) is <= 10 milli are ignored entirely.
    All inputs broadcast against [..., R]."""
    dim_ok = (lhs < avail + (thr + REL_FIT_TOL * torch.abs(avail))) \
        | (lhs <= avail)
    req = lhs if ignore_req is None else ignore_req
    return torch.all(dim_ok | (scalar_mask & (req <= 10.0)), dim=-1)


def fits_matrix(req, avail, thr, scalar_mask):
    """LessEqual(req, avail) per (task, node): [T,N] bool."""
    return le_fits(req[:, None, :], avail[None, :, :], thr, scalar_mask)


def score_matrix(init_req, idle, used, alloc, params,
                 families: Tuple[str, ...] = ("binpack", "kube")):
    """Plugin scoring families as dense tensors: [T,N] float32.

    binpack  (binpack.go:111-260):  100 * sum_r w_r (used_r+req_r)/alloc_r / sum_w
    least-requested (k8s scorer):   100 * mean_r (alloc-used-req)/alloc over cpu,mem
    most-requested:                 100 * mean_r (used+req)/alloc over cpu,mem
    balanced-allocation:            100 * (1 - |cpu_frac - mem_frac|)

    The float operation order is shared with the fused kernel (``_score``)
    so both paths score a pair to the same bits."""
    inv_alloc = 1.0 / alloc
    pars = pack_pars(params, init_req.shape[1])
    return _score(init_req, used, inv_alloc,
                  params["node_static"].to(torch.float32), pars, families)


def water_fill_deserved(total, weight, cap, request, thr, max_iters: int):
    """Iterative weighted water-filling of per-queue deserved resources
    (proportion.go:137-197), vectorized over queues. Each pass hands every
    unmet queue its weight-proportional slice of the remaining pool; queues
    clamp at capability or request and stop participating. At most Q+1
    passes (an all-unmet pass drains the pool)."""
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
            remaining - torch.sum(deserved - old, dim=0), min=0.0)
        it += 1
    return deserved


def drf_state(a, rank):
    """Shared prelude for live DRF ordering: returns (jobres0, drf_rank,
    drf_cap).

    drf_rank(jobres): dense per-task priority from live dominant shares
    (lower-share jobs first, original order within a job and among ties).
    drf_cap(eligible, jobres): progressive-filling headroom — per round a
    job may only grow its dominant share to (the minimum competing share)
    + one step, at least one task and at least 1/(8 x competing jobs)."""
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
    j_seg_start = torch.cat(
        [torch.ones(1, dtype=torch.bool, device=dev), tj[1:] != tj[:-1]])

    def drf_share(jobres):
        share = torch.amax(
            torch.where(has_total[None, :], jobres / drf_total[None, :],
                        0.0), dim=1)                                 # [J]
        return torch.where(a["job_valid"], share, INF)

    # static MAJOR key from the job-order providers preceding drf in the
    # tiers (priority/gang): live shares only break its ties
    prerank = a.get("job_drf_prerank")
    if prerank is None:
        prerank = torch.zeros(J, dtype=torch.int32, device=dev)
    arange_j = torch.arange(J, dtype=torch.int32, device=dev)
    arange_t = torch.arange(T, dtype=torch.int32, device=dev)

    def drf_rank(jobres):
        order_j = _lexsort((drf_share(jobres), prerank))
        job_pos = _scatter_set(order_j, arange_j)
        order_t = _lexsort((within_rank, job_pos[tj]))
        return _scatter_set(order_t, arange_t)

    def drf_cap(eligible, jobres):
        share = drf_share(jobres)
        elig_job = torch.zeros(J, dtype=torch.int32, device=dev) \
            .scatter_reduce(0, tj, eligible.to(torch.int32), "amax",
                            include_self=True) > 0
        n_elig = torch.clamp(torch.sum(elig_job), min=1)
        # progressive filling competes WITHIN a prerank group
        grp = torch.clamp(prerank, 0, J - 1).long()
        m_grp = torch.full((J,), INF, dtype=torch.float32, device=dev) \
            .scatter_reduce(0, grp, torch.where(elig_job, share, INF),
                            "amin", include_self=True)
        m = m_grp[grp]                                           # [J]
        max_incr = torch.amax(torch.where(eligible, incr_t, 0.0))
        step = torch.maximum(max_incr, 1.0 / (8.0 * n_elig))
        allowed = torch.maximum(share, m) + step                 # [J]
        # the within-job prefix of dominant-share increments sums exactly
        # (float64, rounded once): in float32 its rounding depends on the
        # scan's order, which differs between the card's parallel cumsum
        # and the host's sequential one, so the two devices could cap a
        # job a task apart (ROADMAP Queue C)
        cum = _segment_prefix((incr_t * eligible)[:, None], j_seg_start,
                              exact=True)[:, 0] + incr_t
        # absolute comparison (share + cum vs allowed): subtracting share
        # from allowed first loses a float32 ulp and starves exact steps
        return eligible & (share[tj] + cum <= allowed[tj] + 1e-6)

    return a["job_drf_allocated"], drf_rank, drf_cap


def queue_cap_state(a, rank, thr, total, ease_unrequested: bool = True):
    """Prelude for per-queue fair share: water-filled deserved, the
    task->queue map, and the static (queue, rank) sort for per-round
    prefix caps."""
    q = a["queue_weight"].shape[0]
    deserved = water_fill_deserved(
        total, a["queue_weight"], a["queue_capability"],
        a["queue_request"], thr, max_iters=q + 1)
    if ease_unrequested:
        # dims a queue never requested must not bind its cap
        deserved = torch.where(a["queue_request"] > thr[None, :],
                               deserved, INF)
    task_queue = a["job_queue"].long()[a["task_job"].long()]
    t = task_queue.shape[0]
    q_perm = _stable_argsort(task_queue * (t + 1) + rank.long())
    s_q = task_queue[q_perm]
    q_seg_start = torch.cat(
        [torch.ones(1, dtype=torch.bool, device=s_q.device),
         s_q[1:] != s_q[:-1]])
    return q, deserved, task_queue, q_perm, q_seg_start


def _queue_cap_mask(eligible, task_queue, req, qrem, thr, scalar_mask,
                    q_perm, q_seg_start, s_q=None, s_req_raw=None):
    """Per-round queue admission cap: among eligible tasks in (queue, rank)
    order, a task passes iff its queue's running prefix of eligible
    requests + its own request still fits the queue's remaining deserved.
    s_q/s_req_raw are the sorted task_queue/req gathers, hoisted by callers
    whose q_perm is static."""
    if s_q is None:
        s_q = task_queue[q_perm]
    if s_req_raw is None:
        s_req_raw = req[q_perm]
    s_act = eligible[q_perm]
    s_rem = qrem[s_q]
    # a task whose own request can never fit the queue's remaining deserve
    # must not hold budget in the prefix
    s_fits_alone = le_fits(s_req_raw, s_rem, thr, scalar_mask,
                           ignore_req=s_req_raw) & s_act
    s_req = s_req_raw * s_fits_alone[:, None]
    prefix = _segment_prefix(s_req, q_seg_start)
    ok_sorted = le_fits(prefix + s_req, s_rem, thr, scalar_mask,
                        ignore_req=s_req) & s_fits_alone
    return _scatter_set(q_perm, ok_sorted)


def _segment_prefix(sorted_vals, seg_start_mask, exact: bool = False):
    """Exclusive prefix-sum of sorted_vals [T,R] within segments delimited by
    seg_start_mask [T] bool.

    The sum runs over the whole array and each segment subtracts its start,
    so in float32 a segment's prefix carries the rounding of everything
    before it. ``exact`` accumulates in float64 and rounds once: the
    prefix then depends on the segment alone (exact for the flatten's
    requests, integers in milli-units and bytes), which lets a shard that
    sorts only its own nodes' tasks admit what the whole-cluster sort
    admits. Sums that are exact do not depend on their order, so the exact
    form scans along the innermost axis of an [R, T] copy: on the card a
    cumsum down axis 0 of a [T, R] tensor runs one thread per column
    through all T rows, where the innermost scan is parallel."""
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


def _herd_mean(eligible, fit_req, scalar_mask):
    """The eligible tasks' mean request [R], and the dims where it is
    significant."""
    n_elig = torch.clamp(torch.sum(eligible), min=1)
    mean_req = torch.sum(fit_req * eligible[:, None], dim=0) / n_elig  # [R]
    return mean_req, mean_req > torch.where(scalar_mask, 10.0, 0.0)


def _herd_slots(mean_req, sig, avail, npods, max_pods, thr, T: int):
    """Each node's estimated capacity [N] in tasks of the mean request."""
    slots_dim = torch.where(
        sig[None, :],
        torch.floor((avail + thr[None, :])
                    / torch.clamp(mean_req[None, :], min=1e-9)),
        INF)
    slots = torch.amin(slots_dim, dim=1)                            # [N]
    slots = torch.minimum(slots, (max_pods - npods).to(torch.float32))
    return torch.clamp(slots, 0.0, float(T))


def _herd_target(eligible, node_score, slots, mode: str):
    """Pre-assign the eligible tasks' positions to nodes [T]: in herd
    desirability order (``node_score``), pack mode fills each node to its
    ``slots``, spread mode stripes over the nodes tied for best."""
    N = node_score.shape[0]
    has_slot = slots > 0
    masked_score = torch.where(has_slot, node_score, NEG)
    order = _stable_argsort(-masked_score)                          # [N]
    pos = torch.cumsum(eligible.to(torch.int32), dim=0) - 1         # [T]
    if mode == "spread":
        # stripe only across nodes whose herd score ties the best
        best_s = torch.amax(masked_score)
        eps = 1e-5 * torch.clamp(torch.abs(best_s), min=1.0)
        near = has_slot & (masked_score >= best_s - eps)
        m = torch.clamp(torch.sum(near), min=1)
        return order[torch.remainder(torch.clamp(pos, min=0), m)]
    cum = torch.cumsum(slots[order], dim=0)
    idx = torch.searchsorted(cum, pos.to(torch.float32), right=True)
    return order[torch.clamp(idx, 0, N - 1)]


def _waterfall_choice(eligible, node_score, fit_req, avail, npods,
                      max_pods, thr, scalar_mask, mode: str):
    """Spread a herd across nodes in one round: order nodes by their herd
    desirability (``node_score`` = per-node max of the masked score) and
    pre-assign task positions to nodes (``_herd_target``). Tasks whose
    pre-assigned node is infeasible fall back to their personal argmax;
    prefix admission corrects slot overestimates."""
    mean_req, sig = _herd_mean(eligible, fit_req, scalar_mask)
    slots = _herd_slots(mean_req, sig, avail, npods, max_pods, thr,
                        eligible.shape[0])
    return _herd_target(eligible, node_score, slots, mode)


def _admission_round(eligible, feas, score, fit_req, acct_req, avail,
                     rank, thr, scalar_mask, npods, max_pods,
                     per_node_cap: int = 0, herd_mode: str = "pack"):
    """One parallel round on the dense matrices: choose best node per task
    (waterfall-corrected), admit by priority prefix within each node,
    return (new_assign[T] node/-1, debit[N,R], pod_inc[N])."""
    pods_ok = (npods < max_pods)[None, :]
    feas = feas & pods_ok & eligible[:, None]
    masked = torch.where(feas, score, NEG)
    personal = torch.argmax(masked, dim=1)                          # [T]
    if herd_mode in ("pack", "spread") and per_node_cap == 0:
        node_score = torch.amax(masked, dim=0)                      # [N]
        target = _waterfall_choice(eligible, node_score, fit_req, avail,
                                   npods, max_pods, thr, scalar_mask,
                                   herd_mode)
        t_ok = feas.gather(1, target[:, None])[:, 0]
        choice = torch.where(t_ok, target, personal)
    else:
        choice = personal
    has = feas.gather(1, choice[:, None])[:, 0]
    choice = torch.where(has, choice, -1)
    return _admit_prefix(choice, fit_req, acct_req, avail, rank, thr,
                         scalar_mask, npods, max_pods, per_node_cap)


def _admission_round_fused(eligible, a, avail, used_now, sig_feas, sig_i8,
                           inv_alloc, node_static, pars, acct_req, rank,
                           thr, scalar_mask, npods, herd_mode: str,
                           score_families):
    """The fused form of _admission_round: the [T,N] feasibility/score/
    argmax/node-max pass is one ``fused_choice`` call; the feasibility of
    the chosen target node is re-derived pointwise. Only the waterfall herd
    modes take this path."""
    fit_req = a["task_init_req"]
    max_pods = a["node_max_pods"]
    pods_ok = npods < max_pods
    best_s, best_i, node_score = fused_choice(
        fit_req, avail.contiguous(), used_now.contiguous(), inv_alloc,
        node_static, eligible.to(torch.float32), pods_ok.to(torch.float32),
        sig_i8, pars, score_families)
    has_any = best_s > NEG * 0.5
    personal = best_i.long()

    target = _waterfall_choice(eligible, node_score, fit_req, avail,
                               npods, max_pods, thr, scalar_mask,
                               herd_mode)
    # feasibility of (task, target[task]): the dense feas rule at one node
    fit = le_fits(fit_req, avail[target], thr, scalar_mask)
    sig = sig_feas.gather(1, target[:, None])[:, 0]
    t_ok = fit & sig & pods_ok[target] & eligible
    choice = torch.where(t_ok, target, torch.where(has_any, personal, -1))
    return _admit_prefix(choice, fit_req, acct_req, avail, rank, thr,
                         scalar_mask, npods, max_pods, 0)


def hdrf_placeable(init_req, avail, used_now, inv_alloc, node_static,
                   eligible, pods_ok, sig_i8, pars, score_families):
    """The hdrf round's placeability prefilter on the fused path: one
    ``fused_choice`` pass over this round's eligible rows and pods_ok
    nodes; a row is placeable iff some node is feasible for it (its best
    score is not NEG). Only ``best_s`` is read."""
    best_s, _, _ = fused_choice(
        init_req, avail.contiguous(), used_now.contiguous(), inv_alloc,
        node_static, eligible.to(torch.float32), pods_ok.to(torch.float32),
        sig_i8, pars, score_families, prefilter=True)
    return best_s > NEG * 0.5


def _admit_prefix(choice, fit_req, acct_req, avail, rank, thr,
                  scalar_mask, npods, max_pods, per_node_cap: int):
    """Priority-prefix admission for a round's per-task node choices
    (shared by the dense and fused choice paths). choice: int64 [T]."""
    T = choice.shape[0]
    N = avail.shape[0]
    # sort by (node, rank); inactive last
    key = torch.where(choice >= 0, choice * (T + 1) + rank.long(), BIG_KEY)
    perm = _stable_argsort(key)
    s_choice = choice[perm]
    s_active = s_choice >= 0
    s_fit = fit_req[perm] * s_active[:, None]
    seg_start = torch.cat(
        [torch.ones(1, dtype=torch.bool, device=choice.device),
         s_choice[1:] != s_choice[:-1]])
    # exact: per node, independent of the other nodes' tasks (the sharded
    # solve admits per shard and must admit the same)
    prefix = _segment_prefix(s_fit, seg_start, exact=True)         # [T,R]

    s_node = torch.clamp(s_choice, min=0)
    fits = le_fits(prefix + s_fit, avail[s_node], thr, scalar_mask,
                   ignore_req=s_fit) & s_active
    # pod-count prefix: position within segment
    ones = torch.ones((T, 1), dtype=torch.float32, device=choice.device)
    pos = _segment_prefix(ones, seg_start)[:, 0]
    pods_fit = (npods[s_node] + pos) < max_pods[s_node]
    admit_sorted = fits & pods_fit
    if per_node_cap > 0:
        # fidelity mode: at most cap admissions per node per round
        admit_sorted = admit_sorted & (pos < per_node_cap)

    # prefix admission is conservative: a blocked task waits for the next
    # round, after the node's idle has been debited for real
    admit = _scatter_set(perm, admit_sorted)
    new_assign = torch.where(admit, choice, -1)

    node = torch.clamp(choice, min=0)
    debit = _segment_sum(acct_req * admit[:, None], node, N)
    pod_inc = _segment_sum(admit.to(torch.int32), node, N)
    return new_assign, debit, pod_inc


# ---------------------------------------------------------------------------
# fast round-based solver
# ---------------------------------------------------------------------------

class _State:
    """The solve's carry (the JAX version's while_loop tuple). The node
    state (idle, pipe, npods) is one tensor, or one per shard in the
    sharded solve."""

    __slots__ = ("idle", "pipe", "npods", "qalloc", "jobres", "assigned",
                 "kind", "excluded", "rounds")

    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)


class _Fairness:
    """A solve's replicated job-side state, shared by the single-device
    and the sharded solves: per-queue deserved caps (``use_queue_cap``,
    water-filled from ``total``, the cluster's valid allocatable [R]), the
    live DRF or hierarchical-DRF ranks and caps, each round's admission
    order under them, and the per-queue / per-job accounting of the
    round's admissions and the gang reverts."""

    def __init__(self, a, total, use_queue_cap: bool, use_drf_order: bool,
                 use_hdrf: bool, ease_unrequested: bool = True):
        dev = a["task_rank"].device
        R = a["task_init_req"].shape[1]
        self.a, self.rank = a, a["task_rank"]
        self.tj = a["task_job"].long()
        self.J = a["job_min"].shape[0]
        self.use_queue_cap, self.use_drf_order = use_queue_cap, use_drf_order
        self.use_hdrf = use_hdrf
        if use_queue_cap:
            (self.Q, self.deserved, self.task_queue, self.q_perm,
             self.q_seg_start) = queue_cap_state(
                a, self.rank, a["thresholds"], total,
                ease_unrequested=ease_unrequested)
            self.qalloc0 = a["queue_allocated"]
            # static-sort gathers hoisted out of the round loop
            self.qs_q = self.task_queue[self.q_perm]
            self.qs_req = a["task_req"][self.q_perm]
        else:
            self.qalloc0 = torch.zeros((1, R), dtype=torch.float32,
                                       device=dev)
        if use_drf_order:
            self.jobres0, self.drf_rank, self.drf_cap = drf_state(
                a, self.rank)
            if use_hdrf:
                # hierarchical mode: the comparator AND the progressive
                # cap both come from the weighted tree — one tree
                # recursion per round feeds the re-rank and the
                # per-ancestor-level gate
                from .hdrf import hdrf_state
                self.hdrf_rank_cap = hdrf_state(a, self.rank)
        else:
            self.jobres0 = torch.zeros((1, R), dtype=torch.float32,
                                       device=dev)

    def queue_cap(self, eligible, qalloc, bound, order=None):
        """The eligible tasks whose queue's running prefix of eligible
        requests still fits ``bound`` less ``qalloc``, in (queue, rank)
        order (``order``: a live rank, else the static one)."""
        a = self.a
        qrem = torch.clamp(bound - qalloc, min=0.0)
        if order is not None:
            qp = _lexsort((order, self.task_queue))
            return _queue_cap_mask(eligible, self.task_queue, a["task_req"],
                                   qrem, a["thresholds"],
                                   a["scalar_dim_mask"], qp,
                                   self.q_seg_start)
        return _queue_cap_mask(eligible, self.task_queue, a["task_req"],
                               qrem, a["thresholds"], a["scalar_dim_mask"],
                               self.q_perm, self.q_seg_start, self.qs_q,
                               self.qs_req)

    def order(self, st: _State, eligible, capped: bool, placeable=None):
        """This round's admission priority [T] and the eligible tasks left
        under the DRF / hdrf caps and the queue caps. ``capped=False`` is
        the work-conserving overflow pass: it relaxes deserved but NEVER
        the hard capability quota. ``placeable`` (hdrf only): the rows
        some node can take this round, so that a task no node can take
        does not hold its sibling group's min key or pin its subtree's
        budget."""
        if self.use_hdrf:
            r_rank, eligible = self.hdrf_rank_cap(eligible & placeable,
                                                  st.jobres)
        elif self.use_drf_order:
            r_rank = self.drf_rank(st.jobres)
            eligible = self.drf_cap(eligible, st.jobres)
        else:
            r_rank = self.rank
        if self.use_queue_cap:
            bound = self.deserved if capped else self.a["queue_capability"]
            eligible = eligible & self.queue_cap(
                eligible, st.qalloc, bound,
                r_rank if self.use_drf_order else None)
        return r_rank, eligible

    def account(self, st: _State, tasks, sign: int) -> None:
        """Add (sign 1) or take back (sign -1) ``tasks``' requests in the
        per-queue and per-job totals; pipelined tasks count toward queue
        allocated too."""
        req = self.a["task_req"] * tasks[:, None]
        if self.use_queue_cap:
            q = _segment_sum(req, self.task_queue, self.Q)
            st.qalloc = st.qalloc + q if sign > 0 else st.qalloc - q
        if self.use_drf_order:
            j = _segment_sum(req, self.tj, self.J)
            st.jobres = st.jobres + j if sign > 0 else st.jobres - j

    def record(self, st: _State, new_assign, use_future: bool):
        """Record a round's admissions (``new_assign`` [T] node or -1);
        returns the admitted rows."""
        got = new_assign >= 0
        st.assigned = torch.where(got, new_assign.to(torch.int32),
                                  st.assigned)
        st.kind = torch.where(got, 1 if use_future else 0, st.kind)
        self.account(st, got, 1)
        return got

    def job_ready(self, st: _State):
        """Gang check [J]: ready base + allocated (kind 0, counts_ready)
        tasks reach min_available."""
        a = self.a
        placed = (st.assigned >= 0) & (st.kind == 0)
        alloc_counts = _segment_sum(
            placed.to(torch.int32) * a["task_counts_ready"].to(torch.int32),
            self.tj, self.J)
        return ((a["job_ready_base"] + alloc_counts) >= a["job_min"]) \
            & a["job_valid"]

    def gang_fixpoint(self, st: _State, run_phases, credit,
                      max_gang_iters: int) -> None:
        """The bounded gang fixpoint: ``run_phases(excluded)`` runs the
        admission phases with the jobs in ``excluded`` [J] sitting out;
        then every job that got allocations but is not ready is reverted
        (Statement.Discard: ``credit(revert_task)`` gives its tasks' nodes
        back; pipelined tasks are not statement ops and survive). Reruns
        while a job got reverted (its freed resources may admit others) or
        deferred jobs await their solo retry: a first revert leaves a job
        eligible, a second defers it to a one-at-a-time queue in rank
        order, and a solo retry that reverts again excludes it for good."""
        a, tj, J = self.a, self.tj, self.J
        rank = self.rank
        T = rank.shape[0]
        dev = rank.device
        # job order position for the gang-exclusion tie-break: first valid
        # task's rank (static snapshot order)
        job_first_rank = torch.full((J,), T, dtype=rank.dtype, device=dev) \
            .scatter_reduce(0, tj, torch.where(a["task_valid"], rank, T),
                            "amin", include_self=True)
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
            revert_job = ~self.job_ready(st) & a["job_valid"] & ~excluded \
                & ~barred & has_alloc
            revert_task = revert_job[tj] & placed
            credit(revert_task)
            self.account(st, revert_task, -1)
            st.assigned = torch.where(revert_task, -1, st.assigned)
            st.kind = torch.where(revert_task, -1, st.kind)
            revert_count = revert_count + revert_job.to(torch.int32)
            excluded = excluded | (solo & revert_job)
            processed = processed | (solo & torch.any(unproc))
            deferred = deferred | (revert_job & (revert_count >= 2))
            any_more = bool(torch.any(revert_job)
                            | torch.any(deferred & ~processed & ~excluded))
            it += 1


def solve_allocate(arrays: Dict[str, object],
                   score_params: Dict[str, object],
                   max_rounds: int = 64,
                   max_gang_iters: int = 12,
                   per_node_cap: int = 0,
                   herd_mode: str = "pack",
                   score_families: Tuple[str, ...] = ("binpack", "kube"),
                   use_queue_cap: bool = False,
                   use_drf_order: bool = False,
                   use_hdrf_order: bool = False,
                   work_conserving: bool = True,
                   fused: str = "auto",
                   device: Optional[object] = None) -> SolveResult:
    """Round-based allocate+pipeline solve with gang semantics.

    ``arrays`` / ``score_params``: the flatten's solver arrays and the
    score weights, as numpy arrays or torch tensors; they are moved to
    ``device`` (CUDA when None — raises without one; ``device="cpu"`` runs
    on the host).

    With ``use_queue_cap`` (proportion plugin active) per-queue deserved is
    water-filled from queue_weight/capability/request and each round's
    admissions are capped at deserved per queue. With ``use_drf_order``
    (drf plugin active) the admission priority is recomputed every round
    from live dominant shares.

    With ``use_hdrf_order`` as well (drf with its hierarchy; the arrays
    carry ``ops.hdrf.build_hdrf``'s tree) the re-rank and the progressive
    cap come from the weighted queue tree (``ops.hdrf.hdrf_state``), fed
    each round by a placeability prefilter: the fused path launches the
    fused choice kernel once more per round for it.

    ``fused``: "auto" takes the fused kernel on CUDA in the waterfall herd
    modes (``herd_mode`` pack/spread, ``per_node_cap`` 0); "on" forces it
    (CUDA tensors only; other herd modes stay dense); "off" runs the dense
    path.
    """
    if use_hdrf_order and use_drf_order and "hdrf_parent" not in arrays:
        raise ValueError("use_hdrf_order needs the hdrf arrays "
                         "(ops.hdrf.build_hdrf)")
    if fused not in ("auto", "on", "off"):
        raise ValueError(f"fused must be 'auto', 'on' or 'off': {fused!r}")
    dev = resolve_device(device)
    a = to_torch_arrays(arrays, dev)
    params = to_torch_params(score_params, dev)

    T = a["task_init_req"].shape[0]
    N = a["node_idle"].shape[0]
    R = a["task_init_req"].shape[1]
    thr = a["thresholds"]
    scalar_mask = a["scalar_dim_mask"]
    tj = a["task_job"].long()
    sig_feas = a["sig_masks"][a["task_sig"].long()] \
        & a["node_valid"][None, :]                                  # [T,N]
    task_req = a["task_req"]
    init_req = a["task_init_req"].contiguous()

    herd_ok = herd_mode in ("pack", "spread") and per_node_cap == 0
    if fused == "on" and dev.type != "cuda":
        raise ValueError("fused='on' needs CUDA tensors; use 'off' or "
                         "'auto' on the CPU")
    use_fused = fused != "off" and dev.type == "cuda" and herd_ok
    if use_fused:
        sig_i8, inv_alloc, fused_pars, node_static = fused_setup(
            sig_feas, a["node_alloc"], params, R)

    total = torch.sum(
        a["node_alloc"] * a["node_valid"][:, None].to(torch.float32),
        dim=0) if use_queue_cap else None
    use_hdrf = use_drf_order and use_hdrf_order
    fair = _Fairness(a, total, use_queue_cap, use_drf_order, use_hdrf,
                     ease_unrequested=work_conserving)

    def phase_rounds(st: _State, use_future: bool, capped: bool = True,
                     gate=None) -> None:
        """Run admission rounds to fixpoint against idle (allocate) or
        future-idle (pipeline), updating ``st`` in place. capped=False is
        the work-conserving overflow pass."""
        # skip the phase outright when no task is still eligible; `gate`
        # adds a caller-side cheap impossibility check
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
            feas0 = placeable = None
            if use_hdrf:
                # placeability prefilter: the dense path reuses this
                # round's feasibility matrix; the fused path pays one
                # extra kernel pass
                if use_fused:
                    placeable = hdrf_placeable(
                        init_req, avail, used_now, inv_alloc, node_static,
                        eligible, st.npods < a["node_max_pods"], sig_i8,
                        fused_pars, score_families)
                else:
                    feas0 = fits_matrix(init_req, avail, thr,
                                        scalar_mask) & sig_feas
                    placeable = torch.any(
                        feas0 & (st.npods < a["node_max_pods"])[None, :],
                        dim=1)
            r_rank, eligible = fair.order(st, eligible, capped, placeable)
            if use_fused:
                new_assign, debit, pod_inc = _admission_round_fused(
                    eligible, a, avail, used_now, sig_feas, sig_i8,
                    inv_alloc, node_static, fused_pars, task_req,
                    r_rank, thr, scalar_mask, st.npods, herd_mode,
                    score_families)
            else:
                feas = feas0 if feas0 is not None else (
                    fits_matrix(init_req, avail, thr, scalar_mask)
                    & sig_feas)
                score = score_matrix(init_req, avail, used_now,
                                     a["node_alloc"], params,
                                     score_families)
                new_assign, debit, pod_inc = _admission_round(
                    eligible, feas, score, init_req, task_req, avail,
                    r_rank, thr, scalar_mask, st.npods,
                    a["node_max_pods"], per_node_cap, herd_mode)
            got = fair.record(st, new_assign, use_future)
            if use_future:
                st.pipe = st.pipe + debit
            else:
                st.idle = st.idle - debit
                st.npods = st.npods + pod_inc
            st.rounds += 1
            changed = bool(torch.any(got))

    # loop-invariant: pipeline phases only matter when some node's
    # FutureIdle can exceed its Idle
    has_future = torch.any(a["node_extra_future"] > 0.0)

    def run_phases(excluded) -> None:
        st.excluded = excluded
        phase_rounds(st, use_future=False)
        phase_rounds(st, use_future=True, gate=has_future)
        if use_queue_cap and work_conserving:
            # work-conserving overflow: leftovers no competing queue could
            # take under its cap go to whoever still wants them
            if use_drf_order:
                phase_rounds(st, use_future=False, capped=False)
                phase_rounds(st, use_future=True, capped=False,
                             gate=has_future)
            else:
                # run only when some leftover task is BLOCKED by the capped
                # mask (the mask is monotone in the queue bound)
                rem = (a["task_valid"] & (st.assigned < 0)
                       & ~st.excluded[tj])
                capped_out = torch.any(
                    rem & ~fair.queue_cap(rem, st.qalloc, fair.deserved))
                phase_rounds(st, use_future=False, capped=False,
                             gate=capped_out)
                phase_rounds(st, use_future=True, capped=False,
                             gate=capped_out & has_future)

    def credit(revert_task) -> None:
        node = torch.clamp(st.assigned, min=0).long()
        st.idle = st.idle + _segment_sum(task_req * revert_task[:, None],
                                         node, N)
        st.npods = st.npods - _segment_sum(revert_task.to(torch.int32),
                                           node, N)

    st = _State(idle=a["node_idle"], pipe=torch.zeros_like(a["node_idle"]),
                npods=a["node_npods"], qalloc=fair.qalloc0,
                jobres=fair.jobres0,
                assigned=torch.full((T,), -1, dtype=torch.int32, device=dev),
                kind=torch.full((T,), -1, dtype=torch.int32, device=dev),
                excluded=~a["job_valid"], rounds=0)
    fair.gang_fixpoint(st, run_phases, credit, max_gang_iters)
    return SolveResult(
        assigned=st.assigned, kind=st.kind, job_ready=fair.job_ready(st),
        rounds=torch.tensor(st.rounds, dtype=torch.int32, device=dev),
        compact=_compact(st.assigned, st.kind, N))


# ---------------------------------------------------------------------------
# sequential parity solver (reference greedy semantics)
# ---------------------------------------------------------------------------

def _host_array(v) -> np.ndarray:
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def solve_allocate_sequential(arrays: Dict[str, object],
                              score_params: Dict[str, object],
                              score_families: Tuple[str, ...] = (
                                  "binpack", "kube"),
                              use_queue_cap: bool = False,
                              overflow_pass: bool = False,
                              work_conserving: bool = True,
                              device: Optional[object] = None) -> SolveResult:
    """One pass over the tasks in rank order: task k's allocation is
    visible to task k+1, and the job-boundary gang revert mirrors
    Statement.Discard (the JAX package's ``lax.scan`` solver, here a
    Python loop of device steps).

    Requires tasks grouped by job in rank order (flatten_snapshot
    guarantees this). O(T) sequential steps — the parity oracle for small
    problems. Job boundaries are read from a host copy of ``task_job``
    (and queue indices from one of ``job_queue``), so a step never waits
    on the device; every decision on device values is a ``torch.where``.

    overflow_pass (with use_queue_cap): after the strict deserved-capped
    pass, a second pass over the leftover tasks with the caps relaxed to
    hard capability — the sequential oracle for the round solver's
    work-conserving overflow phases.
    """
    dev = resolve_device(device)
    task_job_h = _host_array(arrays["task_job"])
    job_queue_h = _host_array(arrays["job_queue"])
    a = to_torch_arrays(arrays, dev)
    params = to_torch_params(score_params, dev)
    T = a["task_init_req"].shape[0]
    N = a["node_idle"].shape[0]
    J = a["job_min"].shape[0]
    R = a["task_init_req"].shape[1]
    thr = a["thresholds"]
    scalar_mask = a["scalar_dim_mask"]
    tj = a["task_job"].long()
    sig_feas_all = a["sig_masks"][a["task_sig"].long()] \
        & a["node_valid"][None, :]
    init_req = a["task_init_req"]
    task_req = a["task_req"]
    max_pods = a["node_max_pods"]
    counts_ready = a["task_counts_ready"].to(torch.int32)
    # score_matrix's per-call prelude, hoisted out of the task loop
    inv_alloc = 1.0 / a["node_alloc"]
    pars = pack_pars(params, R)
    node_static = params["node_static"].to(torch.float32)
    arange_n = torch.arange(N, device=dev)

    if use_queue_cap:
        total = torch.sum(
            a["node_alloc"] * a["node_valid"][:, None].to(torch.float32),
            dim=0)
        Q, deserved, _, _, _ = queue_cap_state(
            a, a["task_rank"], thr, total, ease_unrequested=work_conserving)
        qalloc0 = a["queue_allocated"]
        arange_q = torch.arange(Q, device=dev)
    else:
        deserved = None
        qalloc0 = torch.zeros((1, R), dtype=torch.float32, device=dev)

    def finalize_job(st, jidx: int, base_alloc) -> None:
        """Job boundary: keep the job's allocations if it is ready, else
        restore the snapshot taken at its first task. Only this pass's
        allocations revert (a prior pass's are already dispatched), and
        pipelined tasks survive, as ssn.Pipeline is outside the
        Statement."""
        ready = (a["job_ready_base"][jidx] + base_alloc[jidx]
                 + st["jalloc"]) >= a["job_min"][jidx]
        revert = ((tj == jidx) & (st["assigned"] >= 0) & (st["kind"] == 0)
                  & ~ready & (st["snap_assigned"] < 0))
        st["idle"] = torch.where(ready, st["idle"], st["snap_idle"])
        st["npods"] = torch.where(ready, st["npods"], st["snap_npods"])
        if use_queue_cap:
            amt = torch.sum(task_req * revert[:, None], dim=0)
            jq = int(job_queue_h[jidx])
            st["qalloc"] = st["qalloc"] - (arange_q == jq)[:, None] \
                * amt[None, :]
        st["assigned"] = torch.where(revert, -1, st["assigned"])
        st["kind"] = torch.where(revert, -1, st["kind"])

    def snapshot(st) -> None:
        st["jalloc"] = torch.zeros((), dtype=torch.int32, device=dev)
        st["snap_idle"], st["snap_npods"] = st["idle"], st["npods"]
        st["snap_assigned"] = st["assigned"].clone()

    def run_pass(bound, base_alloc, st) -> None:
        cur_job = int(task_job_h[0])
        snapshot(st)
        for i in range(T):
            jidx = int(task_job_h[i])
            if jidx != cur_job:
                finalize_job(st, cur_job, base_alloc)
                snapshot(st)
            cur_job = jidx
            idle, pipe, npods = st["idle"], st["pipe"], st["npods"]
            assigned, kind = st["assigned"], st["kind"]
            # the overflow pass only visits leftovers
            valid = a["task_valid"][i] & (assigned[i] < 0)
            req_fit = init_req[i]
            req_acct = task_req[i]
            pods_ok = npods < max_pods
            if use_queue_cap:
                jq = int(job_queue_h[jidx])
                valid = valid & le_fits(st["qalloc"][jq] + req_acct,
                                        bound[jq], thr, scalar_mask,
                                        ignore_req=req_acct)
            base = sig_feas_all[i] & pods_ok & valid
            feas_idle = le_fits(req_fit[None, :], idle, thr,
                                scalar_mask) & base
            future = idle + a["node_extra_future"] - pipe
            feas_fut = le_fits(req_fit[None, :], future, thr,
                               scalar_mask) & base
            used_now = a["node_used"] + (a["node_idle"] - idle)
            score = _score(req_fit[None, :], used_now, inv_alloc,
                           node_static, pars, score_families)[0]
            pick_idle = torch.any(feas_idle)
            pick_fut = ~pick_idle & torch.any(feas_fut)
            feas = torch.where(pick_idle, feas_idle, feas_fut)
            node = torch.argmax(torch.where(feas, score, NEG))
            got = pick_idle | pick_fut
            node = torch.where(got, node, -1)
            debit = torch.where(got, req_acct, 0.0)
            onehot = (arange_n == node)[:, None]
            st["idle"] = idle - torch.where(pick_idle,
                                            debit[None, :] * onehot, 0.0)
            st["pipe"] = pipe + torch.where(pick_fut,
                                            debit[None, :] * onehot, 0.0)
            st["npods"] = npods + torch.where(
                pick_idle, onehot[:, 0].to(torch.int32), 0)
            if use_queue_cap:
                q_onehot = (arange_q == jq)[:, None]
                st["qalloc"] = st["qalloc"] + q_onehot * debit[None, :]
            # never clobber a prior pass's assignment
            prev_a, prev_k = assigned[i].clone(), kind[i].clone()
            assigned[i] = torch.where(prev_a >= 0, prev_a, node)
            kind[i] = torch.where(
                prev_a >= 0, prev_k,
                torch.where(pick_idle, 0, torch.where(pick_fut, 1, -1)))
            st["jalloc"] = st["jalloc"] + (
                pick_idle & a["task_counts_ready"][i]).to(torch.int32)
        finalize_job(st, cur_job, base_alloc)

    st = {"idle": a["node_idle"], "pipe": torch.zeros_like(a["node_idle"]),
          "npods": a["node_npods"], "qalloc": qalloc0,
          "assigned": torch.full((T,), -1, dtype=torch.int32, device=dev),
          "kind": torch.full((T,), -1, dtype=torch.int32, device=dev)}
    run_pass(deserved, torch.zeros(J, dtype=torch.int32, device=dev), st)
    if overflow_pass and use_queue_cap:
        placed = (st["assigned"] >= 0) & (st["kind"] == 0)
        base1 = _segment_sum(placed.to(torch.int32) * counts_ready, tj, J)
        run_pass(a["queue_capability"], base1, st)
    assigned, kind = st["assigned"], st["kind"]
    alloc_counts = _segment_sum(
        ((assigned >= 0) & (kind == 0)).to(torch.int32) * counts_ready,
        tj, J)
    job_ready = ((a["job_ready_base"] + alloc_counts) >= a["job_min"]) \
        & a["job_valid"]
    return SolveResult(
        assigned=assigned, kind=kind, job_ready=job_ready,
        rounds=torch.tensor(T, dtype=torch.int32, device=dev),
        compact=_compact(assigned, kind, N))


# ---------------------------------------------------------------------------
# packed-transfer entry points
# ---------------------------------------------------------------------------

def _unpack(fbuf, ibuf, layout) -> Dict[str, torch.Tensor]:
    """The solver arrays as views into the packed buffers (``kind`` "f"
    float32, "i" int32; "b" is the one copy, int32 -> bool). The solve
    never writes its input arrays, so views of a resident arena stay
    intact across sessions."""
    d = {}
    for k, kind, off, size, shape in layout:
        if kind == "f":
            d[k] = fbuf[off:off + size].view(shape)
        else:
            v = ibuf[off:off + size].view(shape)
            d[k] = v != 0 if kind == "b" else v
    return d


def _packed_len(layout, f: bool) -> int:
    return max(off + size for k, kind, off, size, shape in layout
               if (kind == "f") == f)


def solve_allocate_packed2d(f2d, i2d, layout, score_params,
                            max_rounds: int = 64,
                            max_gang_iters: int = 12,
                            per_node_cap: int = 0,
                            herd_mode: str = "pack",
                            score_families: Tuple[str, ...] = ("binpack",),
                            use_queue_cap: bool = False,
                            use_drf_order: bool = False,
                            use_hdrf_order: bool = False,
                            work_conserving: bool = True,
                            fused: str = "auto") -> SolveResult:
    """solve_allocate over the chunked device-resident buffers kept by
    ops.device_cache.PackedDeviceCache (``[C, chunk]`` tensors); runs on
    their device. The first solve at a (layout, flags, device) key in the
    process counts as one compile in ``ops.precompile.watcher``."""
    from .precompile import solve_key, watcher

    fbuf = f2d.reshape(-1)[:_packed_len(layout, True)]
    ibuf = i2d.reshape(-1)[:_packed_len(layout, False)]
    key = solve_key("packed2d", (f2d.device,), layout, dict(
        herd_mode=herd_mode, score_families=tuple(score_families),
        use_queue_cap=use_queue_cap, use_drf_order=use_drf_order,
        use_hdrf_order=use_hdrf_order, work_conserving=work_conserving))
    with watcher.first_solve(key):
        return solve_allocate(_unpack(fbuf, ibuf, layout), score_params,
                              max_rounds, max_gang_iters, per_node_cap,
                              herd_mode, score_families, use_queue_cap,
                              use_drf_order, use_hdrf_order,
                              work_conserving, fused, device=f2d.device)
