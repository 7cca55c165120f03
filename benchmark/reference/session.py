"""One scheduling session's decision problem, rebuilt from the cluster state.

The state is what the benchmark handed the store: nodes, queues, gangs
(podgroup and pods, in submission order) and where each bound pod runs.
From it this module works out what Volcano's session open and allocate
action decide before the solve, under the configuration's conf:

- enqueue: every Pending podgroup without minResources goes Inqueue;
- proportion (when configured): per-queue allocated / request, the
  water-filled deserved, queue shares, overused queues;
- drf: job dominant shares; with ``drf.enableHierarchy`` the weighted
  queue tree (drf.go updateHierarchicalShare, _compareQueues);
- the allocate order: queues by the queue-order plugins (then creation
  time and uid), jobs by priority, gang readiness, drf share (then
  creation time and uid), tasks by priority (then creation time and uid);
- the padded solver arrays, score weights and solve flags.

Only the parts of those rules that a state of this benchmark can reach
are written out; ``Unsupported`` is raised where a state leaves them.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

import numpy as np
import yaml

from .resource import Res, dominant_share, min_res, share

#: enqueue's default overcommit factor (enqueue.go)
OVERCOMMIT = 1.2


class Unsupported(Exception):
    """The state needs a rule this reference does not write out."""


@dataclass
class Gang:
    """A podgroup and its pods, as submitted: every pod asks ``req``."""

    name: str
    queue: str
    min_member: int
    pods: List[str]            # pod names, in index order
    pod_uids: List[str]
    req: Res
    ct: float                  # creation timestamp of podgroup and pods
    priority: int = 0          # the priority class's value (job and pods)


@dataclass
class Node:
    name: str
    alloc: Res
    max_pods: int


@dataclass
class Queue:
    name: str
    weight: int
    hierarchy: str = ""
    weights: str = ""
    ct: float = 0.0
    capability: Optional[Res] = None     # None: no capability (unbounded)
    reclaimable: Optional[bool] = None   # None: Volcano's default (true)


@dataclass
class ClusterState:
    """What the store holds: ``gangs`` in submission order, ``placed``
    pod name -> node name for every pod bound or placed on a node;
    ``running``: the placed pods reported Running (the others are still
    binding); ``releasing``: the placed pods evicted and not yet released
    (an evicted pod leaves ``running``)."""

    namespace: str
    nodes: List[Node]
    queues: List[Queue]
    gangs: Dict[str, Gang] = field(default_factory=dict)
    placed: Dict[str, str] = field(default_factory=dict)
    running: Set[str] = field(default_factory=set)
    releasing: Set[str] = field(default_factory=set)
    #: values that depend on a gang's shape and count alone, kept across
    #: cycles (read-only once made)
    memo: Dict[tuple, object] = field(default_factory=dict, repr=False,
                                      compare=False)


@dataclass
class Conf:
    """The scheduler conf as the reference reads it."""

    tiers: List[List[str]]
    args: Dict[str, dict]

    @classmethod
    def parse(cls, text: str) -> "Conf":
        raw = yaml.safe_load(text)
        actions = [a.strip() for a in raw["actions"].split(",")]
        if actions != ["enqueue", "allocate", "backfill"]:
            raise Unsupported(f"actions {actions}")
        tiers, args = [], {}
        for tier in raw["tiers"]:
            names = []
            for p in tier["plugins"]:
                if set(p) - {"name", "arguments"}:
                    raise Unsupported(f"plugin options {sorted(p)}")
                names.append(p["name"])
                args[p["name"]] = dict(p.get("arguments") or {})
            tiers.append(names)
        known = {"priority", "gang", "conformance", "drf", "predicates",
                 "proportion", "nodeorder", "binpack"}
        plugins = [n for t in tiers for n in t]
        if set(plugins) - known:
            raise Unsupported(f"plugins {sorted(set(plugins) - known)}")
        for name in ("priority", "gang", "drf", "predicates", "nodeorder"):
            if name not in plugins:
                raise Unsupported(f"a conf without {name}")
        conf = cls(tiers=tiers, args=args)
        if conf.hierarchy and "proportion" in plugins:
            raise Unsupported("proportion beside the drf hierarchy")
        extra = {k for a, v in args.items() if a != "drf"
                 for k in v} | (set(args.get("drf", {}))
                                - {"drf.enableHierarchy"})
        if extra:
            raise Unsupported(f"plugin arguments {sorted(extra)}")
        return conf

    @property
    def plugins(self) -> List[str]:
        return [n for t in self.tiers for n in t]

    @property
    def hierarchy(self) -> bool:
        return bool(self.args.get("drf", {}).get("drf.enableHierarchy"))


# -- the drf hierarchy (drf.go:41-633) -----------------------------------

class _HNode:
    def __init__(self, name: str, weight: float, alloc: Res = None,
                 request: Res = None, leaf: bool = False):
        self.name = name
        self.weight = weight
        self.alloc = alloc if alloc is not None else Res()
        self.share = 0.0
        self.request = request if request is not None else Res()
        self.saturated = False
        self.children: Optional[Dict[str, "_HNode"]] = None if leaf else {}


def _saturated(alloc: Res, request: Res, demanding: Dict[str, bool]) -> bool:
    for rn in alloc.names():
        a, r = alloc.get(rn), request.get(rn)
        if a != 0 and r != 0 and a >= r:
            return True
        if not demanding.get(rn, False) and r != 0:
            return True
    return False


def _recurse(node: _HNode, demanding, total: Res) -> None:
    if node.children is None:
        node.saturated = _saturated(node.alloc, node.request, demanding)
        return
    mdr = 1.0
    for child in node.children.values():
        _recurse(child, demanding, total)
        if child.share != 0 and not child.saturated:
            s = dominant_share(child.alloc, total)
            if s < mdr:
                mdr = s
    node.alloc = Res()
    saturated = True
    for child in node.children.values():
        if not child.saturated:
            saturated = False
        if child.share != 0:
            if child.saturated:
                node.alloc.add(child.alloc)
            else:
                node.alloc.add(child.alloc.clone().multi(mdr / child.share))
    node.share = dominant_share(node.alloc, total)
    node.saturated = saturated


def _hierarchy_tree(jobs, queues: Dict[str, Queue], total: Res) -> _HNode:
    """The queue-path tree over every job, leaves in job order, shares
    from the final allocations (each session-open update re-runs the whole
    recursion, so only the last one counts)."""
    root = _HNode("root", 1.0)
    total_allocated = Res()
    for j in jobs:
        q = queues[j.queue]
        total_allocated.add(j.allocated)
        paths = q.hierarchy.split("/")
        wparts = q.weights.split("/")
        inode = root
        for i in range(1, len(paths)):
            child = inode.children.get(paths[i])
            if child is None:
                try:
                    w = float(wparts[i])
                except (IndexError, ValueError):
                    w = 1.0
                child = _HNode(paths[i], max(w, 1.0))
                inode.children[paths[i]] = child
            inode = child
        leaf = _HNode(j.uid, 1.0, j.allocated.clone(),
                      j.total_request.clone(), leaf=True)
        leaf.share = dominant_share(leaf.alloc, total)
        inode.children[j.uid] = leaf
    demanding = {rn: True for rn in total.names()
                 if total_allocated.get(rn) < total.get(rn)}
    _recurse(root, demanding, total)
    return root


def _compare_queues(root: _HNode, lq: Queue, rq: Queue) -> float:
    lnode = rnode = root
    lpaths, rpaths = lq.hierarchy.split("/"), rq.hierarchy.split("/")
    depth = min(len(lpaths), len(rpaths))
    for i in range(depth):
        if not lnode.saturated and rnode.saturated:
            return -1
        if lnode.saturated and not rnode.saturated:
            return 1
        lkey = lnode.share / lnode.weight
        rkey = rnode.share / rnode.weight
        if lkey == rkey:
            if i < depth - 1:
                lnode = (lnode.children or {}).get(lpaths[i + 1])
                rnode = (rnode.children or {}).get(rpaths[i + 1])
                if lnode is None or rnode is None:
                    return 0
        else:
            return lkey - rkey
    return 0


# -- proportion (proportion.go:75-326) ------------------------------------

class _QueueAttr:
    def __init__(self, q: Queue):
        self.name = q.name
        self.weight = max(int(q.weight or 1), 1)
        self.deserved = Res()
        self.allocated = Res()
        self.request = Res()
        self.share = 0.0


def _queue_share(attr: _QueueAttr) -> float:
    res = 0.0
    for rn in attr.deserved.names():
        res = max(res, share(attr.allocated.get(rn), attr.deserved.get(rn)))
    return res


def _proportion(jobs, queues: Dict[str, Queue], total: Res):
    attrs: Dict[str, _QueueAttr] = {}
    for j in jobs:
        attr = attrs.get(j.queue)
        if attr is None:
            attr = attrs[j.queue] = _QueueAttr(queues[j.queue])
        attr.allocated.add(j.allocated)
        attr.request.add(j.allocated)
        attr.request.add(j.pending)
    remaining = total.clone()
    meet = set()
    while True:
        total_weight = sum(a.weight for n, a in attrs.items()
                           if n not in meet)
        if total_weight == 0:
            break
        increased, decreased = Res(), Res()
        for n, attr in attrs.items():
            if n in meet:
                continue
            old = attr.deserved.clone()
            attr.deserved.add(remaining.clone().multi(
                attr.weight / total_weight))
            if attr.request.less(attr.deserved):
                attr.deserved = min_res(attr.deserved, attr.request)
                meet.add(n)
            attr.share = _queue_share(attr)
            inc, dec = attr.deserved.diff(old)
            increased.add(inc)
            decreased.add(dec)
        try:
            remaining.sub(increased)
        except ValueError:
            remaining = Res()
        remaining.add(decreased)
        if remaining.is_empty():
            break
    return attrs


# -- the session ------------------------------------------------------------

@dataclass
class _Job:
    uid: str
    gang: Gang
    queue: str
    allocated: Res
    pending: Res
    total_request: Res
    ready_num: int
    pending_pods: List[int]   # pod indices, in task order


def bucket(n: int, floor: int = 8) -> int:
    """The flatten's padded sizes: quarter steps between powers of two."""
    b = floor
    while b < n:
        for frac in (1.25, 1.5, 1.75, 2.0):
            cand = int(b * frac)
            if cand >= n:
                return cand
        b *= 2
    return b


@dataclass
class Problem:
    """A session's solve: the arrays, score parameters, flags, and the
    mapping of task rows to pods and node columns to node names."""

    arrays: Dict[str, np.ndarray]
    params: Dict[str, np.ndarray]
    flags: Dict[str, object]
    tasks: List[str]           # pod keys of the task rows
    nodes: List[str]


def _times(r: Res, n: int) -> Res:
    """n pods' worth of r: an integer-valued sum, exact in float64 in any
    order, so one product stands for the scheduler's n additions (with no
    addition, no scalar dimension appears)."""
    return Res(r.cpu * n, r.mem * n,
               {k: v * n for k, v in r.sc.items()} if n else None)


def _jobs(state: ClusterState) -> List[_Job]:
    out = []
    placed = state.placed
    memo = state.memo
    for g in state.gangs.values():
        pending = [i for i, pod in enumerate(g.pods) if pod not in placed]
        ready = len(g.pods) - len(pending)
        key = ("job", g.name, ready)
        agg = memo.get(key)
        if agg is None:
            agg = memo[key] = (_times(g.req, ready),
                               _times(g.req, len(pending)),
                               _times(g.req, len(g.pods)))
        out.append(_Job(f"{state.namespace}/{g.name}", g, g.queue, *agg,
                        ready, pending))
    return out


def _vocab(state: ClusterState) -> List[str]:
    names: List[str] = []
    for n in state.nodes:
        for k in n.alloc.sc:
            if k not in names:
                names.append(k)
    for g in state.gangs.values():
        for k in g.req.sc:
            if k not in names:
                names.append(k)
    return names


def _vec64(r: Res, scalars: List[str]) -> np.ndarray:
    v = np.zeros(2 + len(scalars), dtype=np.float64)
    v[0] = r.cpu
    v[1] = r.mem
    for i, k in enumerate(scalars):
        v[2 + i] = r.sc.get(k, 0.0)
    return v


def _vec(r: Res, scalars: List[str]) -> np.ndarray:
    v = np.zeros(2 + len(scalars), dtype=np.float32)
    v[0] = r.cpu
    v[1] = r.mem
    for i, k in enumerate(scalars):
        v[2 + i] = r.sc.get(k, 0.0)
    return v


def build_problem(state: ClusterState, conf: Conf) -> Optional[Problem]:
    """The session's solve, or None when no task is pending."""
    if any(q.capability is not None for q in state.queues):
        raise Unsupported("a queue capability (proportion's clamp)")
    if state.releasing:
        raise Unsupported("releasing pods (the future idle they free)")
    plugins = conf.plugins
    queues = {q.name: q for q in state.queues}
    jobs = [j for j in _jobs(state) if j.queue in queues]
    total = Res()
    for n in state.nodes:
        total.add(n.alloc)
    # what runs where: per node the bound pods' requests, summed exactly
    scalars = _vocab(state)
    node_ix = {n.name: i for i, n in enumerate(state.nodes)}
    rows, reqs = [], []
    for j in jobs:
        if j.ready_num:
            v = _vec64(j.gang.req, scalars)
            for pod in j.gang.pods:
                node = state.placed.get(pod)
                if node is not None:
                    rows.append(node_ix[node])
                    reqs.append(v)
    node_used = np.zeros((len(state.nodes), 2 + len(scalars)), np.float64)
    if rows:
        np.add.at(node_used, np.asarray(rows), np.asarray(reqs))
    node_pods = np.bincount(np.asarray(rows, np.int64),
                            minlength=len(state.nodes))
    tot = node_used.sum(axis=0)
    used = Res(tot[0], tot[1], {k: tot[2 + i] for i, k in
                                enumerate(scalars) if tot[2 + i]})
    # enqueue: no podgroup carries minResources, so each goes Inqueue
    # unless the overcommitted idle is empty
    idle = total.clone().multi(OVERCOMMIT)
    try:
        idle.sub(used)
    except ValueError:
        idle = Res()
    if idle.is_empty():
        raise Unsupported("enqueue with an empty overcommitted idle")

    attrs = _proportion(jobs, queues, total) \
        if "proportion" in plugins else None
    tree = _hierarchy_tree(jobs, queues, total) if conf.hierarchy else None

    def queue_cmp(a: Queue, b: Queue) -> int:
        if attrs is not None:
            la, ra = attrs.get(a.name), attrs.get(b.name)
            if la is not None and ra is not None and la.share != ra.share:
                return -1 if la.share < ra.share else 1
        if tree is not None:
            ret = _compare_queues(tree, a, b)
            if ret != 0:
                return -1 if ret < 0 else 1
        if a.ct != b.ct:
            return -1 if a.ct < b.ct else 1
        return -1 if a.name < b.name else (1 if a.name > b.name else 0)

    # the allocate order: jobs with pending tasks, valid (all pods there),
    # in queues not overused; queues by queue order, each exhausted in
    # job order (priority, gang readiness, drf share, creation, uid)
    by_queue: Dict[str, List[_Job]] = {}
    for j in jobs:
        if not j.pending_pods or j.gang.min_member > len(j.gang.pods):
            continue
        if attrs is not None:
            a = attrs.get(j.queue)
            if a is not None and not a.allocated.less_equal(a.deserved):
                continue
        by_queue.setdefault(j.queue, []).append(j)

    def job_key(j: _Job):
        ready = j.ready_num >= j.gang.min_member
        return ((-j.gang.priority, ready, dominant_share(j.allocated, total)),
                True, j.gang.ct, j.uid)

    order_q = sorted((queues[q] for q in by_queue),
                     key=functools.cmp_to_key(queue_cmp))
    job_order: List[_Job] = []
    for q in order_q:
        job_order.extend(sorted(by_queue[q.name], key=job_key))
    if not job_order:
        return None

    ns = state.namespace
    R = 2 + len(scalars)
    n_nodes = len(state.nodes)
    tasks, lens = [], []
    for j in job_order:
        g = j.gang
        idx = sorted(j.pending_pods, key=lambda i: (g.ct, g.pod_uids[i]))
        tasks.extend(f"{ns}/{g.pods[i]}" for i in idx)
        lens.append(len(idx))
    n_tasks = len(tasks)
    nJ = len(job_order)
    N, T, J = bucket(max(n_nodes, 1)), bucket(max(n_tasks, 1)), \
        bucket(nJ + 1)

    a: Dict[str, np.ndarray] = {}
    init = np.zeros((T, R), np.float32)
    off = 0
    for j, k in zip(job_order, lens):
        init[off:off + k] = _vec(j.gang.req, scalars)
        off += k
    a["task_init_req"] = init
    a["task_req"] = init.copy()
    a["task_job"] = np.full(T, J - 1, np.int32)
    a["task_job"][:n_tasks] = np.repeat(np.arange(nJ, dtype=np.int32), lens)
    a["task_rank"] = np.arange(T, dtype=np.int32)
    a["task_sig"] = np.zeros(T, np.int32)
    a["task_valid"] = np.zeros(T, bool)
    a["task_valid"][:n_tasks] = True
    a["task_counts_ready"] = a["task_valid"] & (
        (init[:, 0] >= 10.0) | (init[:, 1] >= 1.0)
        | np.any(init[:, 2:] >= 10.0, axis=1))
    a["job_min"] = np.zeros(J, np.int32)
    a["job_ready_base"] = np.zeros(J, np.int32)
    a["job_queue"] = np.zeros(J, np.int32)
    a["job_valid"] = np.zeros(J, bool)
    flat_queues: List[str] = []
    for jx, j in enumerate(job_order):
        a["job_min"][jx] = j.gang.min_member
        a["job_ready_base"][jx] = j.ready_num
        a["job_valid"][jx] = True
        if j.queue not in flat_queues:
            flat_queues.append(j.queue)
        a["job_queue"][jx] = flat_queues.index(j.queue)

    a["node_idle"] = np.zeros((N, R), np.float32)
    a["node_used"] = np.zeros((N, R), np.float32)
    a["node_alloc"] = np.ones((N, R), np.float32)
    a["node_extra_future"] = np.zeros((N, R), np.float32)
    a["node_npods"] = np.zeros(N, np.int32)
    a["node_max_pods"] = np.zeros(N, np.int32)
    a["node_valid"] = np.zeros(N, bool)
    a["node_valid"][:n_nodes] = True
    key = ("nodes", tuple(scalars))
    if key not in state.memo:
        state.memo[key] = (
            np.array([_vec64(n.alloc, scalars) for n in state.nodes]),
            np.array([n.max_pods for n in state.nodes], np.int32))
    alloc, max_pods = state.memo[key]
    a["node_idle"][:n_nodes] = alloc - node_used
    a["node_used"][:n_nodes] = node_used
    a["node_alloc"][:n_nodes] = np.where(alloc > 0, alloc, 1.0)
    a["node_npods"][:n_nodes] = node_pods
    a["node_max_pods"][:n_nodes] = max_pods
    a["sig_masks"] = np.zeros((1, N), bool)
    a["sig_masks"][0, :n_nodes] = True

    # queue tables: proportion's attrs over every queue with jobs, the
    # flatten's queues first
    Qn = flat_queues + ([q for q in attrs if q not in flat_queues]
                        if attrs is not None else [])
    Q = bucket(max(len(Qn), 1))
    a["queue_weight"] = np.zeros(Q, np.float32)
    a["queue_capability"] = np.full((Q, R), np.inf, np.float32)
    a["queue_allocated"] = np.zeros((Q, R), np.float32)
    a["queue_request"] = np.zeros((Q, R), np.float32)
    for i, qn in enumerate(Qn):
        if attrs is not None:
            at = attrs[qn]
            a["queue_weight"][i] = at.weight
            a["queue_allocated"][i] = _vec(at.allocated, scalars)
            a["queue_request"][i] = _vec(at.request, scalars)
        else:
            a["queue_weight"][i] = queues[qn].weight or 1

    # drf: job allocations, the cluster total, and the static major rank
    # of the providers before drf (priority, gang readiness)
    a["job_drf_allocated"] = np.zeros((J, R), np.float32)
    for jx, j in enumerate(job_order):
        a["job_drf_allocated"][jx] = _vec(j.allocated, scalars)
    a["drf_total"] = _vec(total, scalars)
    keys = [(-j.gang.priority, j.ready_num >= j.gang.min_member)
            for j in job_order]
    rank_of = {k: r for r, k in enumerate(sorted(set(keys)))}
    a["job_drf_prerank"] = np.zeros(J, np.int32)
    for jx, k in enumerate(keys):
        a["job_drf_prerank"][jx] = rank_of[k]
    a["thresholds"] = np.full(R, 10.0, np.float32)
    a["thresholds"][1] = 1.0
    a["scalar_dim_mask"] = np.zeros(R, bool)
    a["scalar_dim_mask"][2:] = True
    if conf.hierarchy:
        total_allocated = Res()
        for j in jobs:
            total_allocated.add(j.allocated)
        _hdrf_arrays(a, job_order, queues, J, R, scalars, total_allocated)

    # score weights: binpack and nodeorder at their default arguments
    binpack = "binpack" in plugins
    w = np.zeros(R, np.float32) if binpack else np.ones(R, np.float32)
    if binpack:
        w[0] = w[1] = 1.0
    params = {"binpack_weight": np.float32(1.0 if binpack else 0.0),
              "binpack_res_weights": w,
              "least_req_weight": np.float32(1.0),
              "most_req_weight": np.float32(0.0),
              "balanced_weight": np.float32(1.0),
              "node_static": np.zeros(N, np.float32)}
    families = ("binpack", "kube") if binpack else ("kube",)
    # herd mode: the first of nodeorder (spread, when most-requested does
    # not outweigh the others) or binpack (pack) to open its session
    herd = None
    for name in plugins:
        if name == "nodeorder":
            herd = "spread"
            break
        if name == "binpack":
            herd = "pack"
            break
    flags = dict(herd_mode=herd, score_families=families,
                 use_queue_cap=attrs is not None,
                 use_drf_order=True, use_hdrf_order=conf.hierarchy,
                 work_conserving=True)
    return Problem(a, params, flags, tasks, [n.name for n in state.nodes])


def _hdrf_arrays(a, job_order, queues, J, R, scalars, total_allocated):
    """The queue-path tree as parent-pointer arrays (the solver's hdrf
    inputs): internal nodes by path prefix, one leaf per job slot."""
    index = {("root",): 0}
    parent, weight, depth = [0], [1.0], [0]
    max_depth = 1
    paths_of = []
    for j in job_order:
        q = queues[j.queue]
        paths = (q.hierarchy or "root").split("/")
        wparts = (q.weights or "").split("/")
        ids, prefix = [], ("root",)
        for i in range(1, len(paths)):
            prefix = prefix + (paths[i],)
            nid = index.get(prefix)
            if nid is None:
                try:
                    wv = float(wparts[i])
                except (IndexError, ValueError):
                    wv = 1.0
                nid = index[prefix] = len(parent)
                parent.append(index[prefix[:-1]])
                weight.append(max(wv, 1.0))
                depth.append(i)
            ids.append(nid)
        paths_of.append(ids)
        max_depth = max(max_depth, len(paths))
    n_int = len(parent)
    H = bucket(n_int + J)
    h_parent = np.zeros(H, np.int32)
    h_weight = np.ones(H, np.float32)
    h_depth = np.zeros(H, np.int32)
    h_leaf = np.zeros(H, bool)
    h_parent[:n_int] = parent
    h_weight[:n_int] = weight
    h_depth[:n_int] = depth
    leaf_req = np.zeros((H, R), np.float32)
    job_leaf = np.zeros(J, np.int32)
    anc = np.full((J, max_depth), -1, np.int32)
    for jx in range(J):
        leaf = n_int + jx
        job_leaf[jx] = leaf
        h_leaf[leaf] = True
        ids = paths_of[jx] if jx < len(paths_of) else []
        h_parent[leaf] = ids[-1] if ids else 0
        h_depth[leaf] = len(ids) + 1
        if jx < len(job_order):
            leaf_req[leaf] = _vec(job_order[jx].total_request, scalars)
        for lvl, nid in enumerate(ids):
            anc[jx, lvl] = nid
        anc[jx, len(ids)] = leaf
    a.update(hdrf_parent=h_parent, hdrf_weight=h_weight, hdrf_depth=h_depth,
             hdrf_is_leaf=h_leaf, hdrf_leaf_req=leaf_req,
             hdrf_job_leaf=job_leaf, hdrf_ancestors=anc,
             hdrf_total_allocated=_vec(total_allocated, scalars))
