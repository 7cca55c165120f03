"""Node-axis sharded eviction solve (preempt at mesh scale).

The counterpart of the JAX package's ``parallel/sharded_evict.py``
(volcano_tpu). Victims partition by the node that hosts them, so the victim
axis shards exactly like the node axis of the allocate solver
(``parallel.sharded_solver``): the host re-lays the victims out per node
shard (``shard_victims``), each shard runs the per-job closed-form
eviction-minimal solve (``ops.evict.solve_evict_uniform``) over its own
nodes and victims, and the only cross-shard traffic per job is the
tiled all_gather of four [N/D] vectors for the score-ordered spread. The
JAX package's ``lax.scan`` over jobs becomes a Python loop of device steps,
one per job, as in ``ops.evict.solve_evict_uniform``.

Only tests and ``chip_smoke.py`` call it, as only the JAX package's tests
and bench call its counterpart.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, Tuple

import numpy as np
import torch

from ..ops.convert import to_torch_arrays
from ..ops.evict import EvictResult, absorb_counts, spread_counts
from ..ops.solver import (
    INT32_MAX, NEG, _segment_any, _segment_min, _segment_prefix,
    _segment_sum, le_fits, score_matrix,
)
from . import mesh as _mesh
from .mesh import Mesh
from .sharded_solver import NODE_KEYS, _check_divides, shard_params

#: victim arrays split over the shards (the victim axis; elig's second)
VICTIM_ROW_KEYS = ("v_req", "v_node", "v_valid")


def _on(x, dev):
    return x.to(dev, non_blocking=True)


def shard_victims(victims: Dict[str, np.ndarray], N: int, D: int):
    """Re-lay victim arrays so each shard's slice holds exactly the victims
    of its node shard (cheapest-first order per node preserved). Returns
    (sharded victims dict, perm) where perm[i] = original victim index at
    sharded slot i (-1 for padding)."""
    v_node = np.asarray(victims["v_node"])
    v_valid = np.asarray(victims["v_valid"])
    n_loc = N // D
    shard_of = np.where(v_valid, v_node // n_loc, -1)
    per_shard = [np.nonzero(shard_of == d)[0] for d in range(D)]
    v_cap = max((len(p) for p in per_shard), default=1)
    v_cap = max(v_cap, 1)
    V2 = v_cap * D
    R = victims["v_req"].shape[1]
    J = victims["elig"].shape[0]
    out = {
        "v_req": np.zeros((V2, R), np.float32),
        "v_node": np.zeros(V2, np.int32),
        "v_valid": np.zeros(V2, bool),
        "elig": np.zeros((J, V2), bool),
        "job_need": np.asarray(victims["job_need"]),
        "job_req": np.asarray(victims["job_req"]),
        "job_acct": np.asarray(victims["job_acct"]),
        "job_count": np.asarray(victims["job_count"]),
    }
    perm = np.full(V2, -1, np.int32)
    for d, idxs in enumerate(per_shard):
        sl = slice(d * v_cap, d * v_cap + len(idxs))
        out["v_req"][sl] = victims["v_req"][idxs]
        out["v_node"][sl] = v_node[idxs]
        out["v_valid"][sl] = True
        out["elig"][:, sl] = np.asarray(victims["elig"])[:, idxs]
        perm[d * v_cap:d * v_cap + len(idxs)] = idxs
    return out, perm


def _solve_sharded(arrays, victims, score_params, mesh: Mesh,
                   score_families, require_freed_covers: bool,
                   stop_at_need: bool):
    """The per-shard solve over shard_victims' layout: (assigned [T],
    evicted_by [V2] in the sharded victim order, job_placed [J]), on the
    mesh's first device."""
    D = mesh.size
    D1 = D == 1
    dev0 = mesh.devices[0]
    N = arrays["node_idle"].shape[0]
    n_loc = _check_divides(N, D)
    V2 = victims["v_req"].shape[0]
    v_loc = V2 // D
    by_dev = {dev: (to_torch_arrays({k: v for k, v in arrays.items()
                                     if k not in NODE_KEYS}, dev),
                    to_torch_arrays({k: victims[k] for k in
                                     ("job_need", "job_req", "job_acct",
                                      "job_count")}, dev))
              for dev in mesh.distinct}
    a, jv = by_dev[dev0]
    whole = to_torch_arrays({k: arrays[k] for k in NODE_KEYS}, dev0)
    vwhole = to_torch_arrays({k: victims[k] for k in
                              VICTIM_ROW_KEYS + ("elig",)}, dev0)
    params = shard_params(score_params, mesh)
    T = a["task_init_req"].shape[0]
    J = a["job_min"].shape[0]
    sm = a["scalar_dim_mask"]
    tj = a["task_job"].long()

    shards = []
    for d, dev in enumerate(mesh.devices):
        s = SimpleNamespace(dev=dev, base=d * n_loc)
        s.a, s.jv = by_dev[dev]
        nb, vb = slice(d * n_loc, (d + 1) * n_loc), slice(d * v_loc,
                                                         (d + 1) * v_loc)
        s.nd = {k: (v[:, nb] if k == "sig_masks" else v[nb]).to(dev)
                for k, v in whole.items()}
        s.v_req = vwhole["v_req"][vb].to(dev)
        s.v_valid = vwhole["v_valid"][vb].to(dev)
        s.elig = vwhole["elig"][:, vb].to(dev)
        s.vl = torch.clamp(vwhole["v_node"][vb].to(dev).long() - s.base,
                           0, n_loc - 1)                   # local node
        v_node_loc = vwhole["v_node"][vb].to(dev).long() - s.base
        future0 = s.nd["node_idle"] + s.nd["node_extra_future"]
        s.job_score = score_matrix(s.jv["job_req"], future0,
                                   s.nd["node_used"], s.nd["node_alloc"],
                                   params[d], score_families)   # [J, N/D]
        s.seg_start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                                 v_node_loc[1:] != v_node_loc[:-1]])
        s.vidx = torch.arange(v_loc, device=dev)
        sig_feas_t = (s.nd["sig_masks"][s.a["task_sig"].long()]
                      | ~s.a["task_valid"][:, None])
        tjd = s.a["task_job"].long()
        s.job_feas = torch.ones((J, n_loc), dtype=torch.int32, device=dev) \
            .scatter_reduce(0, tjd[:, None].expand(T, n_loc),
                            sig_feas_t.to(torch.int32), "amin",
                            include_self=True) > 0
        s.future = future0
        s.alive = s.v_valid
        s.evby = torch.full((v_loc,), -1, dtype=torch.int32, device=dev)
        s.zeros = torch.zeros_like(future0)
        shards.append(s)

    arange_t = torch.arange(T, dtype=torch.int32, device=dev0)
    first_task = torch.full((J,), T - 1, dtype=torch.int32, device=dev0) \
        .scatter_reduce(0, tj, arange_t, "amin", include_self=True)
    task_pos = arange_t - first_task[tj]
    need, job_req = jv["job_need"], jv["job_req"]
    job_count = jv["job_count"]
    assigned = torch.full((T,), -1, dtype=torch.int32, device=dev0)
    jalloc = torch.zeros(J, dtype=torch.int32, device=dev0)

    def gather(xs):
        return xs[0] if D1 else _mesh.all_gather_tiled(xs, dev0)

    for j in range(J):
        r = job_req[j]
        sig = torch.where(sm, r > 10.0, r > 0.0)
        r_fit = torch.where(sig, r, 0.0)
        count = (torch.minimum(job_count[j], need[j]) if stop_at_need
                 else job_count[j])
        active = a["job_valid"][j] & (count > 0)
        parts = []
        for s in shards:
            rd, sigd = _on(r, s.dev), _on(sig, s.dev)
            r_fit_d = _on(r_fit, s.dev)
            s.elig_v = s.elig[j] & s.alive & s.v_valid
            vreq_m = s.v_req * s.elig_v[:, None]
            s.prefix_incl = _segment_prefix(vreq_m, s.seg_start,
                                            exact=True) + vreq_m
            ptot = _segment_sum(vreq_m, s.vl, n_loc)
            has_v = _segment_any(s.elig_v, s.vl, n_loc)
            s.basis = s.zeros if require_freed_covers else s.future
            feas_n = s.job_feas[j] & s.nd["node_valid"]
            m_all, f_n, cap = absorb_counts(
                rd, r_fit_d, sigd, s.basis, ptot, has_v, feas_n,
                s.a["thresholds"], s.a["scalar_dim_mask"], float(T))
            parts.append((s.job_score[j], m_all, f_n, cap))
        score_all, m_all, f_all, cap_extra = (
            gather([p[k] for p in parts]) for k in range(4))
        total = torch.sum(m_all).to(torch.int32)
        do = active & (total > 0)
        if stop_at_need:
            do = do & (total >= need[j])
        count = torch.where(do, torch.minimum(count, total), 0)
        score_j = torch.where(m_all > 0, score_all, NEG)
        c, order, cum = spread_counts(count, score_j, m_all, f_all,
                                      cap_extra)
        is_mine = (tj == j) & a["task_valid"]
        node_for_p = order[torch.clamp(
            torch.searchsorted(cum, task_pos.to(cum.dtype), right=True),
            0, N - 1)]
        placed_t = is_mine & (task_pos < count)
        assigned = torch.where(placed_t, node_for_p.to(torch.int32),
                               assigned)
        # each shard evicts for its own slice of the spread
        for s in shards:
            c_loc = _on(c[s.base:s.base + n_loc], s.dev).to(torch.float32)
            r_fit_d = _on(r_fit, s.dev)
            thr_d, sm_d = s.a["thresholds"], s.a["scalar_dim_mask"]
            demand_fit = c_loc[:, None] * r_fit_d[None, :]
            demand_acct = c_loc[:, None] * s.jv["job_acct"][j][None, :]
            fit_now_n = le_fits(demand_fit, s.basis, thr_d, sm_d,
                                ignore_req=demand_fit)
            need_evict_n = (c_loc > 0) & ~fit_now_n
            vl = s.vl
            fit_at = le_fits(demand_fit[vl], s.basis[vl] + s.prefix_incl,
                             thr_d, sm_d, ignore_req=demand_fit[vl]) \
                & s.elig_v
            cut = _segment_min(torch.where(fit_at, s.vidx, v_loc), vl,
                               n_loc, INT32_MAX)
            ev = (s.elig_v & need_evict_n[vl] & (s.vidx <= cut[vl])
                  & (cut[vl] < v_loc))
            freed = _segment_sum(s.v_req * ev[:, None], vl, n_loc)
            s.future = s.future + freed - demand_acct
            s.alive = s.alive & ~ev
            s.evby = torch.where(ev, j, s.evby)
        jalloc[j] += count.to(torch.int32)
    return assigned, gather([s.evby for s in shards]), jalloc


def solve_evict_uniform_sharded(arrays, victims, score_params, mesh: Mesh,
                                score_families: Tuple[str, ...] = ("kube",),
                                require_freed_covers: bool = False,
                                stop_at_need: bool = True) -> EvictResult:
    """``ops.evict.solve_evict_uniform`` over ``mesh``: shard the victims by
    node shard, run the per-shard solve, scatter the verdicts back to the
    caller's victim order. Tensors on the mesh's first device."""
    N = arrays["node_idle"].shape[0]
    D = mesh.size
    _check_divides(N, D)
    sharded, perm = shard_victims(
        {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
         for k, v in victims.items()}, N, D)
    assigned, evby_s, jalloc = _solve_sharded(
        arrays, sharded, score_params, mesh, score_families,
        require_freed_covers, stop_at_need)
    V = victims["v_req"].shape[0]
    live = np.nonzero(perm >= 0)[0]
    evby = torch.full((V,), -1, dtype=torch.int32, device=evby_s.device)
    evby[torch.from_numpy(perm[live]).long().to(evby.device)] = \
        evby_s[torch.from_numpy(live).to(evby.device)]
    return EvictResult(assigned=assigned, evicted_by=evby,
                       job_placed=jalloc)
