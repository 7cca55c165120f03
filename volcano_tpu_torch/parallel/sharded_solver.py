"""Node-axis sharded allocate solver over a single-controller device mesh.

The counterpart of the JAX package's ``parallel/sharded_solver.py``
(volcano_tpu), with the same semantics and the same layout (SURVEY.md
§5.7-5.8: the TPU build shards the node axis of the task x node problem
instead of sampling nodes):

- node arrays ([N,R] idle/used/alloc, [N] npods/valid, sig_masks [S,N])
  are split along the node axis, one block of N/D nodes per shard, each on
  its shard's device;
- task/job arrays ([T,*], [J]) are replicated, one copy per distinct
  device;
- each shard computes feasibility and scores for its own nodes only (the
  [T, N/D] work: on a CUDA shard one ``fused_choice`` launch per round, on
  a CPU shard the dense ``fits_matrix`` / ``score_matrix`` path), admits
  the choices that land on its nodes by node-local prefix sums, and only
  [T] and [N/D] vectors cross shards (``parallel.mesh``'s all_gather /
  psum / pmax).

Where the JAX package runs one ``shard_map`` program, this is one Python
loop: replicated state (queue caps, DRF and hierarchical-DRF ranks,
eligibility, the herd targeting over the gathered [N] vectors, the gang
fixpoint) is computed once, on the mesh's first device; per-shard state
(idle, pipelined, pod counts) is a list with one tensor per shard. The
round loop's conditions are replicated values, read once per round, as in
the single-device ``ops.solver.solve_allocate``. A D=1 mesh calls no
collective.

A task's global node index is its shard's base (d * N/D) plus the local
index. The personal-best merge takes the first shard holding the maximum
score, then that shard's first maximum: the global first-index argmax.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from ..metrics import tracing
from ..ops.convert import to_torch_arrays, to_torch_params
from ..ops.fused_choice import NEG, fused_choice, fused_setup
from ..ops.hdrf import RankCapGraph
from ..ops.solver import (
    SolveResult, _admit_prefix, _Fairness, _herd_mean, _herd_slots,
    _herd_target, _segment_sum, _State, _unpack, fits_matrix, le_fits,
    host_flag, score_matrix,
)
from . import mesh as _mesh
from .mesh import Mesh

#: arrays whose node axis is split over the shards: the leading axis, and
#: sig_masks' second
NODE_ROW_KEYS = ("node_idle", "node_extra_future", "node_used", "node_alloc",
                 "node_npods", "node_max_pods", "node_valid")
NODE_KEYS = NODE_ROW_KEYS + ("sig_masks",)


def _on(x, dev):
    return x.to(dev, non_blocking=True)


class _Shard:
    """One shard's inputs (views, never written) and per-solve setup."""

    def __init__(self, dev, base: int, rep, nodes, params, use_fused: bool,
                 R: int):
        self.dev, self.base = dev, base
        self.r, self.nd, self.params = rep, nodes, params
        self.n = nodes["node_idle"].shape[0]
        self.init_req = rep["task_init_req"].contiguous()
        self.sig_feas = (nodes["sig_masks"][rep["task_sig"].long()]
                         & nodes["node_valid"][None, :])       # [T, N/D]
        self.fused = use_fused
        if use_fused:
            self.sig_i8, self.inv_alloc, self.pars, self.node_static = \
                fused_setup(self.sig_feas, nodes["node_alloc"], params, R)


def _solve(reps: Sequence[Dict[str, torch.Tensor]],
           nodes: Sequence[Dict[str, torch.Tensor]],
           params: Sequence[Dict[str, torch.Tensor]], mesh: Mesh,
           max_rounds: int, max_gang_iters: int, herd_mode: str,
           score_families: Tuple[str, ...], use_queue_cap: bool,
           use_drf_order: bool, use_hdrf_order: bool,
           fused: str) -> SolveResult:
    """The sharded solve over per-shard tensors: ``reps[d]`` the replicated
    arrays on shard d's device, ``nodes[d]`` its node block ([N/D, ...],
    sig_masks [S, N/D]), ``params[d]`` its score params (node_static [N/D])."""
    if fused not in ("auto", "on", "off"):
        raise ValueError(f"fused must be 'auto', 'on' or 'off': {fused!r}")
    if use_hdrf_order and not use_drf_order:
        raise ValueError("use_hdrf_order requires use_drf_order")
    if use_hdrf_order and "hdrf_parent" not in reps[0]:
        raise ValueError("use_hdrf_order needs the hdrf arrays "
                         "(ops.hdrf.build_hdrf)")
    if fused == "on" and any(d.type != "cuda" for d in mesh.devices):
        raise ValueError("fused='on' needs CUDA shards; use 'off' or 'auto' "
                         "on the CPU")
    D = mesh.size
    D1 = D == 1
    dev0 = mesh.devices[0]
    a = reps[0]
    T, R = a["task_init_req"].shape
    n_loc = nodes[0]["node_idle"].shape[0]
    tj = a["task_job"].long()
    herd = herd_mode in ("pack", "spread")
    shards = [_Shard(dev, d * n_loc, reps[d], nodes[d], params[d],
                     fused != "off" and dev.type == "cuda" and herd, R)
              for d, dev in enumerate(mesh.devices)]

    total = None
    if use_queue_cap:
        # fairness is global: the queue state is replicated and the only
        # cross-shard input is the cluster total. The [N/D, R] blocks are
        # gathered and summed as the single-device solve sums [N, R] (the
        # JAX package psums per-shard sums, whose float32 rounding differs
        # from the whole sum's once the total is inexact)
        valid_alloc = [s.nd["node_alloc"]
                       * s.nd["node_valid"][:, None].to(torch.float32)
                       for s in shards]
        total = torch.sum(valid_alloc[0] if D1 else _mesh.all_gather_tiled(
            valid_alloc, dev0), dim=0)
    fair = _Fairness(a, total, use_queue_cap, use_drf_order, use_hdrf_order)
    if use_hdrf_order and dev0.type == "cuda":
        # the hdrf rank and cap replayed from one graph for the rest of
        # the solve (ops.hdrf.RankCapGraph; closed by fair.close())
        fair.prepare()
        fair.hdrf_rank_cap = RankCapGraph(fair.hdrf_rank_cap)

    def used_now(s, idle):
        return s.nd["node_used"] + (s.nd["node_idle"] - idle)

    def local_choice(s, elig, avail, idle, npods, feas0):
        """Shard s's best node per task over its own nodes: (best score
        [T], global index [T] int32, per-node max [N/D], feasibility
        matrix or None on the fused path)."""
        un = used_now(s, idle)
        if s.fused:
            pods_ok = npods < s.nd["node_max_pods"]
            val, idx, node_score = fused_choice(
                s.init_req, avail.contiguous(), un.contiguous(),
                s.inv_alloc, s.node_static, elig.to(torch.float32),
                pods_ok.to(torch.float32), s.sig_i8, s.pars, score_families)
            return val, idx + s.base, node_score, None
        if feas0 is None:
            pods_ok = (npods < s.nd["node_max_pods"])[None, :]
            feas0 = (fits_matrix(s.init_req, avail, s.r["thresholds"],
                                 s.r["scalar_dim_mask"])
                     & s.sig_feas & pods_ok)
        feas = feas0 & elig[:, None]
        score = score_matrix(s.init_req, avail, un, s.nd["node_alloc"],
                             s.params, score_families)
        masked = torch.where(feas, score, NEG)
        idx = torch.argmax(masked, dim=1).to(torch.int32) + s.base
        return (torch.amax(masked, dim=1), idx, torch.amax(masked, dim=0),
                feas)

    def target_ok(s, elig, avail, npods, feas, target):
        """Whether each task's (possibly remote) herd target is feasible
        on shard s: False where the target is another shard's."""
        t_loc = target.to(s.dev, non_blocking=True) - s.base
        mine = (t_loc >= 0) & (t_loc < s.n)
        tl = torch.clamp(t_loc, 0, s.n - 1).long()
        if feas is not None:
            return feas.gather(1, tl[:, None])[:, 0] & mine
        fit = le_fits(s.init_req, avail[tl], s.r["thresholds"],
                      s.r["scalar_dim_mask"])
        sig = s.sig_feas.gather(1, tl[:, None])[:, 0]
        pods = (npods < s.nd["node_max_pods"])[tl]
        return fit & sig & pods & elig & mine

    def choose(eligible, avails, idles, npods, feas0s):
        """The global choice per task: each shard's local best, merged
        across shards, then the herd target where it is feasible."""
        el = [_on(eligible, s.dev) for s in shards]
        loc = [local_choice(s, el[d], avails[d], idles[d], npods[d],
                            feas0s[d]) for d, s in enumerate(shards)]
        if D1:
            val, personal = loc[0][0], loc[0][1]
        else:
            # +0.0 turns a -0.0 best score into +0.0, so equal scores
            # compare equal across shards; argmax takes the first shard
            vals = _mesh.all_gather([x[0] + 0.0 for x in loc], dev0)
            idxs = _mesh.all_gather([x[1] for x in loc], dev0)
            best_dev = torch.argmax(vals, dim=0)
            personal = idxs.gather(0, best_dev[None, :])[0]
            val = torch.amax(vals, dim=0)
        personal = torch.where(val > NEG / 2, personal, -1)
        if not herd:
            return personal
        mean_req, sig = _herd_mean(eligible, a["task_init_req"],
                                   a["scalar_dim_mask"])
        slots_loc = [_herd_slots(_on(mean_req, s.dev), _on(sig, s.dev),
                                 avails[d], npods[d], s.nd["node_max_pods"],
                                 s.r["thresholds"], T)
                     for d, s in enumerate(shards)]
        if D1:
            node_score, slots = loc[0][2], slots_loc[0]
        else:
            node_score = _mesh.all_gather_tiled([x[2] for x in loc], dev0)
            slots = _mesh.all_gather_tiled(slots_loc, dev0)
        target = _herd_target(eligible, node_score, slots, herd_mode) \
            .to(torch.int32)
        oks = [target_ok(s, el[d], avails[d], npods[d], loc[d][3], target)
               for d, s in enumerate(shards)]
        t_ok = oks[0] if D1 else _mesh.psum(
            [o.to(torch.int32) for o in oks], dev0) > 0
        return torch.where(t_ok, target, personal)

    def admit_local(s, choice, avail, npods, r_rank):
        """Shard s's admission of the choices landing on its nodes, by
        priority prefix sums per node (``_admit_prefix`` on the local
        indices): (new global assignment [T], debit [N/D,R], pod
        increments [N/D])."""
        c_loc = choice.to(s.dev, non_blocking=True).long() - s.base
        c_loc = torch.where((c_loc >= 0) & (c_loc < s.n), c_loc, -1)
        new_loc, debit, pod_inc = _admit_prefix(
            c_loc, s.init_req, s.r["task_req"], avail, r_rank,
            s.r["thresholds"], s.r["scalar_dim_mask"], npods,
            s.nd["node_max_pods"], 0)
        new_assign = torch.where(new_loc >= 0, new_loc + s.base, -1)
        return new_assign.to(torch.int32), debit, pod_inc

    def phase_rounds(excluded, use_future: bool, capped: bool = True):
        changed = True
        phase = "future" if use_future else "idle"
        while changed and st.rounds < max_rounds:
            with tracing.traced("vc.round", round=st.rounds, phase=phase,
                                capped=int(capped), T=T, N=n_loc * D):
                avails = [(st.idle[d] + s.nd["node_extra_future"] - st.pipe[d])
                          if use_future else st.idle[d]
                          for d, s in enumerate(shards)]
                eligible = (a["task_valid"] & (st.assigned < 0)
                            & ~excluded[tj])
                feas0s = [None] * D
                placeable = None
                if use_hdrf_order:
                    # placeability prefilter over every shard's nodes. The
                    # dense path hands its [T, N/D] matrix to choose(); the
                    # fused path pays one more kernel pass
                    hits = []
                    for d, s in enumerate(shards):
                        pods_ok = st.npods[d] < s.nd["node_max_pods"]
                        el = _on(eligible, s.dev)
                        if s.fused:
                            best_s, _, _ = fused_choice(
                                s.init_req, avails[d].contiguous(),
                                used_now(s, st.idle[d]).contiguous(),
                                s.inv_alloc, s.node_static,
                                el.to(torch.float32),
                                pods_ok.to(torch.float32),
                                s.sig_i8, s.pars, score_families,
                                prefilter=True)
                            hit = best_s > NEG * 0.5
                        else:
                            feas0s[d] = (fits_matrix(s.init_req, avails[d],
                                                     s.r["thresholds"],
                                                     s.r["scalar_dim_mask"])
                                         & s.sig_feas & pods_ok[None, :])
                            hit = torch.any(feas0s[d], dim=1)
                        hits.append(hit.to(torch.int32))
                    placeable = (hits[0] if D1 else _mesh.psum(hits, dev0)) > 0
                r_rank, eligible = fair.order(st, eligible, capped, placeable)
                choice = choose(eligible, avails, st.idle, st.npods, feas0s)
                outs = [admit_local(s, choice, avails[d], st.npods[d],
                                    _on(r_rank, s.dev))
                        for d, s in enumerate(shards)]
                # each task is admitted by at most one shard
                got = fair.record(st, outs[0][0] if D1 else _mesh.pmax(
                    [o[0] for o in outs], dev0), use_future)
                for d, (_, debit, pod_inc) in enumerate(outs):
                    if use_future:
                        st.pipe[d] = st.pipe[d] + debit
                    else:
                        st.idle[d] = st.idle[d] - debit
                        st.npods[d] = st.npods[d] + pod_inc
                st.rounds += 1
                changed = host_flag(torch.any(got), "round")

    def run_phases(excluded) -> None:
        # every phase runs at least one round, as in the JAX package's
        # sharded solve; the overflow phases always run under queue caps
        phase_rounds(excluded, False)
        phase_rounds(excluded, True)
        if use_queue_cap:
            phase_rounds(excluded, False, capped=False)
            phase_rounds(excluded, True, capped=False)

    def credit(revert_task) -> None:
        # each shard credits back its own nodes only
        for d, s in enumerate(shards):
            rv_loc = torch.where(_on(revert_task, s.dev),
                                 _on(st.assigned, s.dev).long() - s.base, -1)
            rv_mine = (rv_loc >= 0) & (rv_loc < s.n)
            node = torch.where(rv_mine, rv_loc, 0)
            st.idle[d] = st.idle[d] + _segment_sum(
                s.r["task_req"] * rv_mine[:, None], node, s.n)
            st.npods[d] = st.npods[d] - _segment_sum(
                rv_mine.to(torch.int32), node, s.n)

    # the carry: per-shard lists for the node state, replicated tensors
    # on the first device for the rest
    st = _State(idle=[s.nd["node_idle"] for s in shards],
                pipe=[torch.zeros_like(s.nd["node_idle"]) for s in shards],
                npods=[s.nd["node_npods"] for s in shards],
                qalloc=fair.qalloc0, jobres=fair.jobres0,
                assigned=torch.full((T,), -1, dtype=torch.int32, device=dev0),
                kind=torch.full((T,), -1, dtype=torch.int32, device=dev0),
                rounds=0)
    try:
        fair.gang_fixpoint(st, run_phases, credit, max_gang_iters)
    finally:
        fair.close()
    return SolveResult(assigned=st.assigned, kind=st.kind,
                       job_ready=fair.job_ready(st),
                       rounds=torch.tensor(st.rounds, dtype=torch.int32,
                                           device=dev0))


def _check_divides(N: int, D: int) -> int:
    if N % D:
        raise ValueError(f"node axis {N} does not divide {D} shards")
    return N // D


def _rep_by_device(rep, mesh: Mesh) -> List[Dict[str, torch.Tensor]]:
    """The replicated arrays once per distinct device, listed per shard."""
    by_dev = {dev: to_torch_arrays(rep, dev) for dev in mesh.distinct}
    return [by_dev[dev] for dev in mesh.devices]


def shard_params(score_params, mesh: Mesh) -> List[Dict[str, torch.Tensor]]:
    """The score params per shard: the scalars and resource weights once
    per distinct device, ``node_static`` split along the node axis."""
    scalars = {k: v for k, v in score_params.items() if k != "node_static"}
    by_dev = {dev: to_torch_params(scalars, dev) for dev in mesh.distinct}
    ns = score_params["node_static"]
    nl = _check_divides(ns.shape[0], mesh.size)
    out = []
    for d, dev in enumerate(mesh.devices):
        blk = to_torch_params({"node_static": ns[d * nl:(d + 1) * nl]}, dev)
        out.append(dict(by_dev[dev], node_static=blk["node_static"]))
    return out


def solve_allocate_sharded(arrays: Dict[str, object],
                           score_params: Dict[str, object], mesh: Mesh,
                           max_rounds: int = 64,
                           max_gang_iters: int = 12,
                           herd_mode: str = "pack",
                           score_families: Tuple[str, ...] = ("binpack",),
                           use_queue_cap: bool = False,
                           use_drf_order: bool = False,
                           use_hdrf_order: bool = False,
                           fused: str = "auto") -> SolveResult:
    """The sharded allocate solve over whole-problem arrays (numpy or
    tensors): the node arrays are split over ``mesh``'s shards (a
    sig_masks column block is made contiguous once per solve), the rest
    copied once per distinct device. ``fused``: "auto" launches the fused
    kernel on CUDA shards in the waterfall herd modes; "on" forces it
    (CUDA shards only); "off" runs the dense path. The result lives on the
    mesh's first device."""
    D = mesh.size
    N = arrays["node_idle"].shape[0]
    nl = _check_divides(N, D)
    dev0 = mesh.devices[0]
    reps = _rep_by_device({k: v for k, v in arrays.items()
                           if k not in NODE_KEYS}, mesh)
    whole = to_torch_arrays({k: arrays[k] for k in NODE_KEYS}, dev0)
    nodes = []
    for d, dev in enumerate(mesh.devices):
        blk = slice(d * nl, (d + 1) * nl)
        nodes.append({k: (v[:, blk] if k == "sig_masks" else v[blk])
                      .to(dev).contiguous() for k, v in whole.items()})
    return _solve(reps, nodes, shard_params(score_params, mesh), mesh,
                  max_rounds, max_gang_iters, herd_mode, score_families,
                  use_queue_cap, use_drf_order, use_hdrf_order, fused)


def solve_allocate_sharded_arena(f_rep, i_rep, f_node, i_node, rep_layout,
                                 node_layout, score_params, mesh: Mesh,
                                 max_rounds: int = 64,
                                 max_gang_iters: int = 12,
                                 herd_mode: str = "pack",
                                 score_families=("binpack",),
                                 use_queue_cap: bool = False,
                                 use_drf_order: bool = False,
                                 use_hdrf_order: bool = False,
                                 fused: str = "auto") -> SolveResult:
    """The sharded solve over ``ops.device_cache.ShardedDeviceCache``'s
    resident buffers, as its ``update()`` returns them: ``f_rep`` /
    ``i_rep`` the replicated chunked buffers per shard (one tensor per
    distinct device, listed per shard), ``f_node`` / ``i_node`` each
    shard's node slab. Every array is a view of those buffers (bool
    columns excepted): the node arrays are never re-assembled, and each
    shard's sig_masks is read straight from its [S, N/D] slab.
    ``score_params``: ``ShardedDeviceCache.params_device``'s per-shard
    list, or one whole-problem dict. The first solve at a (layouts,
    flags, mesh) key in the process counts as one compile in
    ``ops.precompile.watcher``."""
    from ..ops.precompile import solve_key, watcher

    key = solve_key("sharded_arena", mesh.devices,
                    tuple(rep_layout) + tuple(node_layout), dict(
                        herd_mode=herd_mode,
                        score_families=tuple(score_families),
                        use_queue_cap=use_queue_cap,
                        use_drf_order=use_drf_order,
                        use_hdrf_order=use_hdrf_order))
    with watcher.first_solve(key):
        return _solve_arena(f_rep, i_rep, f_node, i_node, rep_layout,
                            node_layout, score_params, mesh, max_rounds,
                            max_gang_iters, herd_mode, score_families,
                            use_queue_cap, use_drf_order, use_hdrf_order,
                            fused)


def _solve_arena(f_rep, i_rep, f_node, i_node, rep_layout, node_layout,
                 score_params, mesh, max_rounds, max_gang_iters, herd_mode,
                 score_families, use_queue_cap, use_drf_order,
                 use_hdrf_order, fused) -> SolveResult:
    views: dict = {}
    reps = []
    for fr, ir in zip(f_rep, i_rep):
        key = (id(fr), id(ir))
        if key not in views:
            views[key] = _unpack(fr.reshape(-1), ir.reshape(-1), rep_layout)
        reps.append(views[key])
    nodes = [_unpack(fn.reshape(-1), im.reshape(-1), node_layout)
             for fn, im in zip(f_node, i_node)]
    if isinstance(score_params, dict):
        score_params = shard_params(score_params, mesh)
    return _solve(reps, nodes, score_params, mesh, max_rounds,
                  max_gang_iters, herd_mode, score_families, use_queue_cap,
                  use_drf_order, use_hdrf_order, fused)
