"""The drf hierarchy's per-round re-rank and cap: a frozen copy.

The queue-path tree as parent-pointer arrays (``session._hdrf_arrays``);
each round the weighted, saturation-scaled shares (drf.go
updateHierarchicalShare) are recomputed bottom-up over the live
allocations, jobs re-ranked by the per-level (saturated, share/weight)
key (drf.go _compareQueues), and each ancestor level's growth capped at
the least competing sibling's key plus one step. This is the arithmetic
the program under test states for its hierarchy mode, copied so that the
yardstick stays fixed.
"""

from __future__ import annotations

import torch

from .solve import (
    INF, INT32_MAX, _exact_sum, _lexsort, _scatter_set, _segment_any,
    _segment_min, _segment_prefix, _segment_sum,
)


def _hdrf_core(a, rank):
    """Shared device-side state for the hierarchical rank and cap.

    Returns (tree_state, tree_state_pair, rank_from, cap_from):
    - tree_state(jobres) -> (share[H], sat[H]): the reference's bottom-up
      weighted recursion (drf.go updateHierarchicalShare) over the live
      allocations a["job_drf_allocated"] + jobres.
    - tree_state_pair(jobres, jobres_full) -> (share, sat, share_full):
      tree_state at both allocations in one doubled-id recursion.
    - rank_from(share, sat) -> (r_rank[T], job_pos[J]): jobs sorted by the
      per-level (saturated, share/weight) lexicographic key, tasks
      inheriting their job's position.
    - cap_from(share, sat, share_full, job_pos, eligible) -> eligible'[T]:
      the hierarchy-aware progressive-filling cap (see hdrf_state).
    """
    T = a["task_rank"].shape[0]
    J = a["job_min"].shape[0]
    H = a["hdrf_parent"].shape[0]
    D = a["hdrf_ancestors"].shape[1]
    parent = a["hdrf_parent"].long()
    weight = torch.clamp(a["hdrf_weight"], min=1.0)
    depth = a["hdrf_depth"]
    is_leaf = a["hdrf_is_leaf"]
    leaf_req = a["hdrf_leaf_req"]
    job_leaf = a["hdrf_job_leaf"].long()
    ancestors = a["hdrf_ancestors"].long()
    total = a["drf_total"]
    tj = a["task_job"].long()
    dev = tj.device
    rank = a["task_rank"] if rank is None else rank
    first_rank = torch.full((J,), T, dtype=rank.dtype, device=dev) \
        .scatter_reduce(0, tj, rank, "amin", include_self=True)
    within_rank = rank - first_rank[tj]

    prerank = a.get("job_drf_prerank")
    if prerank is None:
        prerank = torch.zeros(J, dtype=torch.int32, device=dev)
    # per-node prerank: leaves carry their job's, internal nodes neutral
    pr_node = torch.full((H,), INT32_MAX, dtype=torch.int32, device=dev)
    pr_node[job_leaf] = prerank.to(torch.int32)

    # per-task increment in global dominant-share units (matches
    # ops.solver.drf_state's incr_t; accounting uses task_req)
    drf_total_c = torch.clamp(total, min=1e-9)
    incr_t = torch.amax(
        torch.where(total[None, :] > 0.0,
                    a["task_req"] / drf_total_c[None, :], 0.0), dim=1)
    j_seg_start = torch.cat(
        [torch.ones(1, dtype=torch.bool, device=dev), tj[1:] != tj[:-1]])
    arange_j = torch.arange(J, dtype=torch.int32, device=dev)
    arange_t = torch.arange(T, dtype=torch.int32, device=dev)

    def share_of(alloc):  # [H,R] -> [H]
        s = torch.where(total[None, :] > 0.0,
                        alloc / torch.clamp(total[None, :], min=1e-9),
                        torch.where(alloc > 0.0, 1.0, 0.0))
        return torch.amax(s, dim=1)

    def recursion(alloc, demanding, parent_, depth_, is_leaf_, leaf_req_,
                  n: int):
        """The bottom-up weighted recursion over ``n`` segment ids."""
        share = torch.where(is_leaf_, share_of(alloc), 0.0)
        sat_dim = (((alloc != 0.0) & (leaf_req_ != 0.0)
                    & (alloc >= leaf_req_))
                   | (~demanding & (leaf_req_ != 0.0)))
        sat = is_leaf_ & torch.any(sat_dim, dim=1)
        for d in range(D - 1, -1, -1):  # static depth, small
            child = depth_ == (d + 1)
            live = child & (share > 0.0) & ~sat
            mdr = _segment_min(torch.where(live, share, INF), parent_, n, INF)
            scale = torch.where(
                sat, 1.0, mdr[parent_] / torch.clamp(share, min=1e-12))
            contrib = torch.where((child & (share > 0.0))[:, None],
                                  alloc * scale[:, None], 0.0)
            alloc_p = _segment_sum(contrib, parent_, n)
            sat_p = _segment_min(torch.where(child, sat.to(torch.int32), 1),
                             parent_, n, INT32_MAX) > 0
            has_child = _segment_any(child.to(torch.int32), parent_, n)
            tgt = (depth_ == d) & ~is_leaf_ & has_child
            alloc = torch.where(tgt[:, None], alloc_p, alloc)
            share = torch.where(tgt, share_of(alloc_p), share)
            sat = torch.where(tgt, sat_p, sat)
        return share, sat

    def tree_state(jobres):
        """(share[H], sat[H]) after the bottom-up weighted recursion."""
        alloc = _segment_sum(a["job_drf_allocated"] + jobres, job_leaf, H)
        total_alloc = a["hdrf_total_allocated"] + _exact_sum(jobres, 0)
        demanding = (total_alloc < total)[None, :]            # [1,R]
        return recursion(alloc, demanding, parent, depth, is_leaf,
                         leaf_req, H)

    # doubled-id tree recursion: the progressive cap needs the live state
    # AND the all-eligible-placed endpoint every round; stacking the two
    # problems on disjoint segment-id ranges [0,H) / [H,2H) runs both
    # through one pass of segment reductions (same per-segment element
    # sets, so the results match the separate recursions)
    parent2 = torch.cat([parent, parent + H])
    depth2 = torch.cat([depth, depth])
    is_leaf2 = torch.cat([is_leaf, is_leaf])
    leaf_req2 = torch.cat([leaf_req, leaf_req], dim=0)

    def tree_state_pair(jobres, jobres_full):
        """(share[H], sat[H], share_full[H]) — tree_state evaluated at both
        allocations in one fused recursion."""
        R_ = total.shape[0]
        alloc = _segment_sum(
            torch.cat([a["job_drf_allocated"] + jobres,
                       a["job_drf_allocated"] + jobres_full]),
            torch.cat([job_leaf, job_leaf + H]), 2 * H)
        ta_a = a["hdrf_total_allocated"] + _exact_sum(jobres, 0)
        ta_b = a["hdrf_total_allocated"] + _exact_sum(jobres_full, 0)
        demanding = torch.cat([
            (ta_a < total)[None, :].expand(H, R_),
            (ta_b < total)[None, :].expand(H, R_)])
        share, sat = recursion(alloc, demanding, parent2, depth2, is_leaf2,
                               leaf_req2, 2 * H)
        return share[:H], sat[:H], share[H:]

    def rank_from(share, sat):
        # per-level lexicographic job key: level 1 is most significant;
        # within a level saturation dominates share/weight
        # (drf.go _compareQueues). The pre-drf provider rank (priority/
        # gang) tops even that — see job_drf_prerank.
        keys = [arange_j]  # final tie: static order
        for lvl in range(D - 1, -1, -1):
            anc = ancestors[:, lvl]                           # [J]
            ok = anc >= 0
            anc_c = torch.clamp(anc, min=0)
            keys.append(torch.where(ok, share[anc_c] / weight[anc_c], 0.0))
            keys.append((ok & sat[anc_c]).to(torch.int32))
        keys.append(prerank)
        order_j = _lexsort(keys)
        job_pos = _scatter_set(order_j, arange_j)
        order_t = _lexsort((within_rank, job_pos[tj]))
        r_rank = _scatter_set(order_t, arange_t)
        return r_rank, job_pos

    def cap_from(share, sat, share_full, job_pos, eligible):
        """Hierarchy-aware progressive-filling cap (the JAX package's
        ``ops/hdrf.py::cap_from``): per round, for every ancestor level
        (leaf-most first), a subtree may grow its (scaled share)/weight key
        only to (min competing sibling key) + step, converted to a budget
        in raw increment units through the subtree's linearization toward
        ``share_full`` and charged in live job-rank order; the min-key
        subtree always admits at least one task, saturated subtrees wait
        while an unsaturated competing sibling exists, and leaf siblings
        compete within their parent's best prerank group."""
        key = share / weight                                    # [H]
        key_full = share_full / weight                          # [H]
        still = eligible
        max_incr = torch.amax(torch.where(eligible, incr_t, 0.0))
        # full (round-entry) backlog per job: the SAME quantity share_full
        # was evaluated with, so grow/slope stays dimensionally consistent
        contrib_full = torch.where(eligible, incr_t, 0.0)
        job_full = _segment_sum(contrib_full, tj, J)
        for lvl in range(D - 1, -1, -1):
            anc_j = ancestors[:, lvl]                           # [J]
            present_j = anc_j >= 0
            anc_jc = torch.clamp(anc_j, min=0)
            # within-job cumulative eligible increment (static task order
            # == live order within a job)
            contrib = torch.where(still, incr_t, 0.0)
            within_cum = _segment_prefix(
                contrib[:, None], j_seg_start)[:, 0] + contrib
            job_incr = _segment_sum(contrib, tj, J)
            still_job = job_incr > 0.0
            elig_j = still_job & present_j
            node_elig = torch.zeros(H, dtype=torch.int32, device=dev) \
                .scatter_reduce(0, anc_jc, elig_j.to(torch.int32), "amax",
                                include_self=True) > 0
            competing = node_elig & ~sat
            # leaf prerank gate: only the best-prerank eligible leaves of a
            # parent set the pace
            minpr_p = _segment_min(
                torch.where(competing, pr_node, INT32_MAX), parent, H,
                INT32_MAX)
            competing = competing & (~is_leaf
                                     | (pr_node == minpr_p[parent]))
            m_p = _segment_min(torch.where(competing, key, INF), parent, H,
                               INF)
            cws_p = _segment_sum(torch.where(competing, weight, 0.0), parent,
                                 H)
            m_j = m_p[parent[anc_jc]]
            cws_j = cws_p[parent[anc_jc]]
            has_comp = torch.isfinite(m_j)
            w_j = weight[anc_jc]
            step_j = torch.maximum(
                max_incr / w_j,
                1.0 / (8.0 * torch.clamp(cws_j, min=1e-9)))
            grow_j = torch.where(
                has_comp,
                torch.clamp(m_j + step_j - key[anc_jc], min=0.0), INF)
            grow_j = torch.where(present_j & sat[anc_jc] & has_comp,
                                 0.0, grow_j)
            # allowed key growth -> raw-units budget via the subtree's
            # mean slope over its whole round-entry backlog
            node_full = _segment_sum(torch.where(present_j, job_full, 0.0),
                                     anc_jc, H)
            denom_j = key_full[anc_jc] - key[anc_jc]
            full_j = node_full[anc_jc]
            budget_j = torch.where(
                denom_j > 1e-12,
                torch.clamp(grow_j / torch.clamp(denom_j, min=1e-12),
                            0.0, 1.0) * full_j,
                torch.where(grow_j > 0.0, full_j, 0.0))          # [J]
            # min-key floor: the comparator's lowest-key queue always
            # places at least one task per re-sort in the reference
            is_min_j = (present_j & has_comp & ~sat[anc_jc]
                        & (key[anc_jc]
                           <= m_j + 1e-7 + 1e-5 * torch.abs(m_j)))
            budget_j = torch.where(
                is_min_j, torch.maximum(budget_j, max_incr), budget_j)
            # budget charged in live job-rank order: jobs under the same
            # ancestor sorted by job_pos, exclusive prefix of their
            # (post-refinement) eligible increments
            sort_key = torch.where(present_j,
                                   anc_jc.to(torch.int32) * (J + 1)
                                   + job_pos, INT32_MAX)
            p_j = torch.argsort(sort_key, stable=True)
            s_anc = anc_jc[p_j]
            s_present = present_j[p_j]
            s_seg = torch.cat(
                [torch.ones(1, dtype=torch.bool, device=dev),
                 (s_anc[1:] != s_anc[:-1])
                 | (~s_present[1:] | ~s_present[:-1])])
            s_incr = torch.where(s_present, job_incr[p_j], 0.0)
            s_base = _segment_prefix(s_incr[:, None], s_seg)[:, 0]
            job_base = _scatter_set(p_j, s_base)
            cum_t = job_base[tj] + within_cum                   # [T]
            ok = cum_t <= budget_j[tj] + 1e-6
            still = still & (~present_j[tj] | ok)
        return still

    return tree_state, tree_state_pair, rank_from, cap_from


def hdrf_state(a, rank):
    """Device-side: returns rank_and_cap(eligible, jobres) ->
    (r_rank[T], eligible'[T]) — one tree recursion per round feeding both
    the hierarchical re-rank and the progressive-filling cap (the round
    solver's hdrf analog of ops.solver.drf_state's drf_rank/drf_cap)."""
    _, tree_state_pair, rank_from, cap_from = _hdrf_core(a, rank)
    J = a["job_min"].shape[0]
    tj = a["task_job"].long()

    def rank_and_cap(eligible, jobres):
        # live state + the every-eligible-increment-placed endpoint (the
        # cap's linearization, see cap_from), fused into one doubled-id
        # tree recursion instead of two separate passes per round
        pending = _segment_sum(a["task_req"] * eligible[:, None], tj, J)
        share, sat, share_full = tree_state_pair(jobres, jobres + pending)
        r_rank, job_pos = rank_from(share, sat)
        still = cap_from(share, sat, share_full, job_pos, eligible)
        return r_rank, still

    return rank_and_cap
