"""Hierarchical DRF ordering + progressive-filling cap in the solver.

The reference's hdrf mode (plugins/drf/drf.go:527-633) keeps a queue-path
tree whose nodes carry weighted, saturation-scaled shares, re-sorted after
every placement. Here the tree is flattened to parent-pointer arrays once
per session (``build_hdrf``, host side, numpy) and the share recursion runs
as per-depth segment reductions on the arrays' device, so the round solver
can re-rank jobs by the hierarchical comparator every round — the hdrf
analog of the plain dominant-share re-rank in ops.solver.drf_state — AND
gate each round's growth per ancestor level so weighted trees converge to
the reference's weighted split (drf.go's one-placement-then-resort loop,
in round-sized bites).

The counterpart of the JAX package's ``ops/hdrf.py`` (volcano_tpu), with
the same semantics:
- the depth recursion is a Python loop over the static tree depth ``D``;
- ``segment_min`` / ``segment_max`` become ``scatter_reduce`` (``amin`` /
  ``amax``, ``include_self=True``) starting from the reduction's identity
  (``+inf`` for floats, the int32 extremes for ints), as JAX's do, so an
  empty segment reads the same value; ``segment_sum`` becomes
  ``index_add_`` (float sums accumulated in float64 and rounded once, so
  the card and the host round alike: ROADMAP Queue C);
- sorts are stable (``jnp.lexsort`` / ``jnp.argsort`` are);
- where the JAX package's solve compiles each round's rank and cap into
  its jitted loop, on the card the sharded solve's ``RankCapGraph``
  captures it once per solve into a CUDA graph and replays it (the
  single-device solve replays whole rounds, ``ops.round_graph``).

Contract notes (as in the JAX package):
- the comparator walk (drf.go _compareQueues) compares (saturated,
  share/weight) level by level down the two queues' paths; the key here
  is a fixed-depth lexicographic key, exact for uniform-depth hierarchies.
  Paths shorter than the deepest are padded with neutral (unsaturated,
  share 0) levels, so on ragged hierarchies the key refines the host
  order: pairs the host comparator decides order identically, padding
  only breaks pairs the host leaves tied.
- saturation (_resource_saturated, drf.go:93-109): a leaf saturates when
  some dimension's allocation covers its request, or it requests a
  dimension the cluster has exhausted (not "demanding").
- internal-node shares use the reference's rescaling recursion
  (drf.go updateHierarchicalShare): unsaturated children are scaled to
  the minimum dominant share before summing into the parent.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, Tuple

import numpy as np
import torch

from .arrays import bucket
from .solver import (
    INF, INT32_MAX, _exact_sum, _lexsort, _scatter_set, _segment_any,
    _segment_min, _segment_prefix, _segment_sum,
)

log = logging.getLogger(__name__)


def build_hdrf(arr, queues, job_attrs, total_allocated) -> None:
    """Fill arr.hdrf_* from the jobs' queue hierarchy annotations.

    queues: ssn.queues (QueueInfo with .hierarchy "root/eng/dev" and
    .weights "100/50/50"); job_attrs: drf plugin job attrs (unused beyond
    presence — leaf allocations ride arr.job_drf_allocated);
    total_allocated: cluster-wide allocated Resource (drf plugin's
    total_allocated) for the demanding-dimension flags.
    """
    vocab = arr.vocab
    R = arr.R
    J = arr.job_min.shape[0]

    # tree build: internal nodes keyed by path prefix, one leaf per job
    index: Dict[Tuple[str, ...], int] = {("root",): 0}
    parent = [0]        # root's parent is itself (never read)
    weight = [1.0]
    depth = [0]
    max_depth = 1
    job_path_nodes = []  # per job: list of internal node ids, depth 1..
    for j, job in enumerate(arr.jobs_list):
        q = queues.get(job.queue)
        hierarchy = getattr(q, "hierarchy", "") or "root"
        weights_s = getattr(q, "weights", "") or ""
        paths = hierarchy.split("/")
        wparts = weights_s.split("/")
        node_ids = []
        prefix = ("root",)
        for i in range(1, len(paths)):
            prefix = prefix + (paths[i],)
            nid = index.get(prefix)
            if nid is None:
                try:
                    w = float(wparts[i])
                except (IndexError, ValueError):
                    w = 1.0
                nid = len(parent)
                index[prefix] = nid
                parent.append(index[prefix[:-1]])
                weight.append(max(w, 1.0))
                depth.append(i)
            node_ids.append(nid)
        job_path_nodes.append(node_ids)
        # levels used by this job: internal 1..len(paths)-1 + leaf at
        # index len(paths)-1 => len(paths) columns suffice
        max_depth = max(max_depth, len(paths))

    n_internal = len(parent)
    # leaves: one per job slot (padded jobs get an inert leaf under root)
    H = bucket(n_internal + J)
    h_parent = np.zeros(H, np.int32)
    h_weight = np.ones(H, np.float32)
    h_depth = np.zeros(H, np.int32)
    h_is_leaf = np.zeros(H, bool)
    h_parent[:n_internal] = parent
    h_weight[:n_internal] = weight
    h_depth[:n_internal] = depth
    leaf_req = np.zeros((H, R), np.float32)
    job_leaf = np.zeros(J, np.int32)
    D = max_depth  # deepest level that can hold a node (leaves included)
    ancestors = np.full((J, D), -1, np.int32)
    for j in range(J):
        leaf = n_internal + j
        job_leaf[j] = leaf
        h_is_leaf[leaf] = True
        nodes = job_path_nodes[j] if j < len(job_path_nodes) else []
        h_parent[leaf] = nodes[-1] if nodes else 0
        h_depth[leaf] = len(nodes) + 1
        if j < len(arr.jobs_list):
            leaf_req[leaf] = arr.jobs_list[j].total_request.to_vector(vocab)
        for lvl, nid in enumerate(nodes):
            ancestors[j, lvl] = nid
        ancestors[j, len(nodes)] = leaf
    # unused leaf rows for padded job slots stay inert: depth 1 under
    # root, zero request, zero allocation -> share 0, never saturated
    arr.hdrf_parent = h_parent
    arr.hdrf_weight = h_weight
    arr.hdrf_depth = h_depth
    arr.hdrf_is_leaf = h_is_leaf
    arr.hdrf_leaf_req = leaf_req
    arr.hdrf_job_leaf = job_leaf
    arr.hdrf_ancestors = ancestors
    arr.hdrf_total_allocated = np.asarray(
        total_allocated.to_vector(vocab), np.float32)


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


class _PoolShelf:
    """Memory pools for the solves' CUDA graphs (the rank and cap's here,
    the round bodies' in ``ops.round_graph``), reused from graph to
    graph. A graph's private pool that PyTorch releases is only marked
    freeable: its segments stay reserved until the allocator's cache is
    emptied. So a graph captures into a pool that an earlier graph used,
    and hands it back when its holder is done with it (outputs dropped)
    with an event after its last replay; the next borrower's
    stream waits on that event, so no replay of its own can touch the
    blocks before the last one's ended. The shelf keeps the last graph of
    each pool (never replayed again), because PyTorch's allocators let a
    capture share a pool only while another graph holds it, and the
    pool's capture stream, because the allocator reuses a free block only
    on the stream it was allocated on. At most as many pools as graph
    holders (sharded hdrf solves, kept round-graph keys) that ever held
    one at once on a card."""

    def __init__(self):
        self.lock = threading.Lock()
        #: (device, pool handle, capture stream, its last graph, event
        #: after that graph's last replay)
        self.free: list = []

    def take(self, device) -> tuple:
        """(pool handle, its capture stream, the graph that holds the pool
        or None for a new pool)."""
        with self.lock:
            for i, (dev, pool, stream, graph, done) in enumerate(self.free):
                if dev == device:
                    del self.free[i]
                    torch.cuda.current_stream(device).wait_event(done)
                    return pool, stream, graph
        # a high-priority pool stream: pool streams are handed out round
        # robin, and the readbacks take the default priority's
        return (torch.cuda.graph_pool_handle(),
                torch.cuda.Stream(device, priority=-1), None)

    def give(self, device, pool, stream, graph) -> None:
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(device))
        with self.lock:
            self.free.append((device, pool, stream, graph, done))


#: the process's pools: a card's memory is the process's, not a solve's
_POOLS = _PoolShelf()


class RankCapGraph:
    """``hdrf_state``'s ``rank_and_cap`` replayed from one CUDA graph for
    the rest of a sharded solve on the card.

    A round's rank and cap is ~800 small kernels with no host read among
    them, on shapes fixed for the whole solve (T, J, H, D, R): the host's
    launches, not the card, set its pace. The first call runs eagerly and
    doubles as the warm-up. The second captures the chain into a graph
    that reads its two inputs (eligible [T] bool, jobres [J, R] float32)
    from static buffers and writes its two outputs (r_rank [T] int32,
    still [T] bool) to static ones, then replays it; every later call
    copies its inputs in and replays. The kernels, their order and their
    data are the eager call's, so every output is the eager one bit for
    bit. A capture that raises leaves the solve eager, with a warning
    saying why: a wrong answer is never the fallback.

    ``mode`` says how the last call ran: "eager", "capture" or "replay".
    ``close()`` releases the graph and hands its memory pool back."""

    def __init__(self, rank_and_cap):
        self.fn = rank_and_cap
        self.calls = 0
        self.mode = "eager"
        self.graph = self.pool = None
        self.inputs = self.outputs = None

    def __call__(self, eligible, jobres):
        self.calls += 1
        if self.calls == 2:
            self.mode = "capture" if self._capture(eligible, jobres) \
                else "eager"
        elif self.mode != "eager":
            self.mode = "replay"
            self.inputs[0].copy_(eligible)
            self.inputs[1].copy_(jobres)
        if self.mode == "eager":
            return self.fn(eligible, jobres)
        # a replay launches on the current device's stream
        with torch.cuda.device(eligible.device):
            self.graph.replay()
        # the static outputs are overwritten by the next replay
        return self.outputs[0].clone(), self.outputs[1].clone()

    def _capture(self, eligible, jobres) -> bool:
        """Capture ``fn`` on this round's inputs; False if it raised.

        The capture runs on a side stream, its pool's (``_PoolShelf``):
        the job updater's workers and the bind effectors launch on the
        ambient stream during a cycle, and what another thread queues on a
        capturing stream lands in the graph. ``thread_local``: those
        threads' own CUDA calls do not invalidate this thread's capture.
        Not ``torch.cuda.graph``, whose entry synchronises the device and
        empties the allocator's cache."""
        dev = eligible.device
        pool, side, holder = _POOLS.take(dev)
        self.inputs = (eligible.clone(), jobres.clone())
        graph = torch.cuda.CUDAGraph()
        side.wait_stream(torch.cuda.current_stream(dev))
        try:
            with torch.cuda.stream(side):
                graph.capture_begin(pool=pool,
                                    capture_error_mode="thread_local")
                try:
                    outputs = self.fn(*self.inputs)
                finally:
                    graph.capture_end()
        except RuntimeError as e:
            # the pool is not handed back: the next solve takes a new one
            log.warning("hdrf rank and cap: CUDA graph capture failed, "
                        "the solve runs eagerly: %s: %s",
                        type(e).__name__, e)
            self.inputs = None
            return False
        del holder      # the new graph holds the pool now
        self.graph, self.outputs = graph, outputs
        self.pool = (dev, pool, side)
        return True

    def close(self) -> None:
        self.inputs = self.outputs = None
        if self.pool is not None:
            _POOLS.give(*self.pool, self.graph)
        self.graph = self.pool = None


def hdrf_rank_state(a, rank):
    """Device-side: returns hdrf_rank(jobres) -> [T] int32 dense ranks
    (the re-rank alone, no cap)."""
    tree_state, _, rank_from, _ = _hdrf_core(a, rank)

    def hdrf_rank(jobres):
        share, sat = tree_state(jobres)
        r_rank, _ = rank_from(share, sat)
        return r_rank

    return hdrf_rank
