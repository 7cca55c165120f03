"""Snapshot flattening: ClusterInfo -> padded device arrays.

The counterpart of the reference's parallel snapshot clone
(cache.go:693-742): each session the host flattens the cluster into
fixed-shape float32/int32 numpy arrays (padded to size buckets so shapes
repeat across cycles) and ships them to the device in one transfer
(``SnapshotArrays.device_dict``). Mapping tables (tasks_list / nodes_list /
jobs_list) translate solver outputs back into TaskInfo/NodeInfo objects for
Statement replay.

Predicate masks are precomputed host-side per unique constraint signature
(node selector + affinity + tolerations hash) so the device matrix is a
cheap gather: sig_masks[S, N] with S = number of distinct signatures, which
is tiny in practice even when T is 10k.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..api import (
    JobInfo, NodeInfo, NodePhase, Resource, ResourceVocab, TaskInfo,
    TaskStatus, MIN_MEMORY, MIN_MILLI_CPU, MIN_MILLI_SCALAR,
)

#: compile-bucket sizes: quarter-steps between powers of two, floor 8 —
#: keeps the number of distinct compiled shapes logarithmic in cluster size
#: while capping padding overhead at 25%
def bucket(n: int, floor: int = 8) -> int:
    b = floor
    while b < n:
        for frac in (1.25, 1.5, 1.75, 2.0):
            cand = int(b * frac)
            if cand >= n:
                return cand
        b *= 2
    return b


def _match_node_selector(selector: Dict[str, str], node) -> bool:
    labels = node.labels or {}
    return all(labels.get(k) == v for k, v in selector.items())


def taint_tolerated(taint: dict, tolerations: List[dict]) -> bool:
    for tol in tolerations or []:
        op = tol.get("operator", "Equal")
        if tol.get("key") and tol["key"] != taint.get("key"):
            continue
        if op == "Equal" and tol.get("value") != taint.get("value"):
            continue
        if tol.get("effect") and tol["effect"] != taint.get("effect"):
            continue
        return True
    return False


def _tolerates(tolerations: List[dict], node) -> bool:
    """NoSchedule/NoExecute taints must be tolerated (predicates plugin)."""
    for taint in node.taints or []:
        if taint.get("effect") not in ("NoSchedule", "NoExecute"):
            continue
        if not taint_tolerated(taint, tolerations):
            return False
    return True


def _node_affinity_match(affinity: Optional[dict], node) -> bool:
    """requiredDuringSchedulingIgnoredDuringExecution node affinity subset:
    matchExpressions with In/NotIn/Exists/DoesNotExist operators."""
    if not affinity:
        return True
    na = affinity.get("nodeAffinity") or {}
    req = na.get("requiredDuringSchedulingIgnoredDuringExecution")
    if not req:
        return True
    labels = node.labels or {}
    for term in req.get("nodeSelectorTerms", []):
        ok = True
        for expr in term.get("matchExpressions", []):
            key, op = expr.get("key"), expr.get("operator")
            vals = expr.get("values", [])
            has = key in labels
            if op == "In":
                ok &= has and labels[key] in vals
            elif op == "NotIn":
                ok &= not (has and labels[key] in vals)
            elif op == "Exists":
                ok &= has
            elif op == "DoesNotExist":
                ok &= not has
            if not ok:
                break
        if ok:
            return True  # terms are ORed
    return False


def _signature(task: TaskInfo) -> str:
    s = task.sig_cache
    if s is not None:
        return s
    pod = task.pod
    if not pod.node_selector and pod.affinity is None and not pod.tolerations:
        ports = pod.ports()
        if not ports:
            s = ""  # unconstrained fast path (the common case)
        else:
            s = json.dumps({"ports": sorted(ports)})
    else:
        s = json.dumps({
            "sel": sorted((pod.node_selector or {}).items()),
            "aff": pod.affinity,
            "tol": pod.tolerations,
            "ports": sorted(pod.ports()),
        }, sort_keys=True, default=str)
    task.sig_cache = s
    return s


@dataclass
class ScoreParams:
    """Scalar weights feeding the on-device scoring families. Plugins set
    these during OnSessionOpen (binpack/nodeorder register here instead of
    per-(task,node) Python callbacks)."""

    binpack_weight: float = 0.0
    binpack_res_weights: Optional[np.ndarray] = None  # [R]
    least_req_weight: float = 0.0
    most_req_weight: float = 0.0
    balanced_weight: float = 0.0
    # static per-node score added for every task (e.g. node-affinity
    # preferences evaluated host-side): [N]
    node_static: Optional[np.ndarray] = None

    def resolved(self, R: int, N: int) -> "ScoreParams":
        p = ScoreParams(
            binpack_weight=self.binpack_weight,
            least_req_weight=self.least_req_weight,
            most_req_weight=self.most_req_weight,
            balanced_weight=self.balanced_weight)
        p.binpack_res_weights = (
            np.ones(R, dtype=np.float32) if self.binpack_res_weights is None
            else np.asarray(self.binpack_res_weights, dtype=np.float32))
        p.node_static = (
            np.zeros(N, dtype=np.float32) if self.node_static is None
            else np.asarray(self.node_static, dtype=np.float32))
        return p


@dataclass
class SnapshotArrays:
    """Padded array view of one session's decision problem."""

    vocab: ResourceVocab
    # -- tasks (pending tasks of schedulable jobs, in scheduling order) -----
    tasks_list: List[TaskInfo] = field(default_factory=list)
    task_init_req: np.ndarray = None    # [T,R] launch request (fit check)
    task_req: np.ndarray = None         # [T,R] running request (accounting)
    task_job: np.ndarray = None         # [T] -> job index
    task_rank: np.ndarray = None        # [T] global priority order (0 first)
    task_sig: np.ndarray = None         # [T] -> signature index
    task_counts_ready: np.ndarray = None  # [T] bool: counts toward gang
    task_valid: np.ndarray = None       # [T] bool
    # -- jobs ----------------------------------------------------------------
    jobs_list: List[JobInfo] = field(default_factory=list)
    job_min: np.ndarray = None          # [J]
    job_ready_base: np.ndarray = None   # [J] ready_task_num at snapshot
    job_queue: np.ndarray = None        # [J] -> queue index
    job_valid: np.ndarray = None        # [J] bool
    # DRF ordering inputs (filled by the allocate action from the drf
    # plugin's session-open attrs; zeros when drf is inactive)
    job_drf_allocated: np.ndarray = None  # [J,R]
    drf_total: np.ndarray = None          # [R]
    #: static MAJOR ordering key for the in-kernel drf/hdrf re-rank: dense
    #: rank from the job-order providers that precede drf in the tiers
    #: (priority/gang) — live shares only break its ties, so a strict
    #: priority is never inverted by a share re-rank
    job_drf_prerank: np.ndarray = None    # [J] int32
    # -- nodes ---------------------------------------------------------------
    nodes_list: List[NodeInfo] = field(default_factory=list)
    node_idle: np.ndarray = None        # [N,R]
    node_extra_future: np.ndarray = None  # [N,R] releasing - pipelined
    node_used: np.ndarray = None        # [N,R]
    node_alloc: np.ndarray = None       # [N,R] allocatable
    node_npods: np.ndarray = None       # [N]
    node_max_pods: np.ndarray = None    # [N]
    node_valid: np.ndarray = None       # [N] bool
    # -- predicate signatures ------------------------------------------------
    sig_masks: np.ndarray = None        # [S,N] bool
    # -- queues --------------------------------------------------------------
    queues_list: List[str] = field(default_factory=list)
    queue_weight: np.ndarray = None     # [Q] (0 = padded/absent queue)
    queue_capability: np.ndarray = None  # [Q,R] (inf where uncapped)
    queue_allocated: np.ndarray = None  # [Q,R]
    queue_request: np.ndarray = None    # [Q,R] allocated + pending requests
    # -- misc ----------------------------------------------------------------
    thresholds: np.ndarray = None       # [R]
    scalar_dim_mask: np.ndarray = None  # [R] bool: dims 2+ (ignorable)

    @property
    def T(self) -> int:
        return self.task_init_req.shape[0]

    @property
    def N(self) -> int:
        return self.node_idle.shape[0]

    @property
    def R(self) -> int:
        return self.task_init_req.shape[1]

    @property
    def J(self) -> int:
        return self.job_min.shape[0]

    def fill_queue_demand(self) -> None:
        """Fill queue_request from the flattened jobs' total requests — a
        stand-in for the proportion plugin's session-open attrs when no
        session is in the loop (benches, dryruns, kernel-level tests).
        The allocate action overwrites these from the plugin instead."""
        self.queue_request[:] = 0.0
        for j, job in enumerate(self.jobs_list):
            self.queue_request[self.job_queue[j]] += \
                job.total_request.to_vector(self.vocab)

    def device_dict(self, device=None) -> Dict[str, "torch.Tensor"]:
        """The arrays the solver consumes, as torch tensors on ``device``
        (one host->device hop). ``device=None`` means the CUDA device and
        raises when there is none; pass ``device="cpu"`` to run on the
        host. (The hierarchical-DRF arrays are not part of this package
        yet.)"""
        from .convert import to_torch_arrays
        return to_torch_arrays(self.numpy_dict(), device)

    def numpy_dict(self) -> Dict[str, np.ndarray]:
        """device_dict's arrays as the host-side numpy buffers."""
        return {
            "task_init_req": self.task_init_req,
            "task_req": self.task_req,
            "task_job": self.task_job,
            "task_rank": self.task_rank,
            "task_sig": self.task_sig,
            "task_counts_ready": self.task_counts_ready,
            "task_valid": self.task_valid,
            "job_min": self.job_min,
            "job_ready_base": self.job_ready_base,
            "job_queue": self.job_queue,
            "job_valid": self.job_valid,
            "job_drf_allocated": self.job_drf_allocated,
            "drf_total": self.drf_total,
            "job_drf_prerank": self.job_drf_prerank,
            "node_idle": self.node_idle,
            "node_extra_future": self.node_extra_future,
            "node_used": self.node_used,
            "node_alloc": self.node_alloc,
            "node_npods": self.node_npods,
            "node_max_pods": self.node_max_pods,
            "node_valid": self.node_valid,
            "sig_masks": self.sig_masks,
            "queue_weight": self.queue_weight,
            "queue_capability": self.queue_capability,
            "queue_allocated": self.queue_allocated,
            "queue_request": self.queue_request,
            "thresholds": self.thresholds,
            "scalar_dim_mask": self.scalar_dim_mask,
        }


class FlattenCache:
    """Incremental cross-session flatten state.

    The reference deep-clones the whole cluster every cycle (cache.go:693-742,
    one goroutine per job); this build instead keeps the device-ready
    columns warm across sessions and recomputes only what changed, keyed on
    ``JobInfo.flat_version`` / ``NodeInfo.flat_version`` bumps. A cold cache
    (or ``cache=None``) reproduces the full flatten; results are identical
    either way because every entry is verified against the live objects'
    versions and task-uid sequences before reuse.

    The assembly itself is delta-driven: the padded task/job/node arrays
    are persistent buffers owned by the cache, and each flatten rewrites
    only the dirty rows — the job blocks outside the common prefix/suffix
    of the (key, version, len) job layout, and the node rows whose
    (name, epoch, flat_version) triple moved. An unchanged-snapshot cycle
    re-packs nothing; a 1%-churn cycle re-packs ~1% of the rows. The
    signature and queue index tables reuse the previous session's
    first-seen order whenever the dirty blocks' signature/queue sequences
    are unchanged, so the packed buffers stay byte-identical to a cold
    flatten.

    The event-sourced ledger of the JAX package's FlattenCache
    (enable_events / feed_event and its fault seams) is not part of this
    package yet: every flatten here takes the version-checked re-diff.
    """

    def __init__(self, vocab: Optional[ResourceVocab] = None):
        self.vocab = vocab
        self.job_blocks: Dict[str, dict] = {}
        self.node_rows: Dict[str, dict] = {}
        self.sig_rows: Dict[str, tuple] = {}   # sig -> (node_key, row[N])
        self._node_key: Optional[tuple] = None
        self._node_buf: Optional[dict] = None
        #: previous task/job assembly: persistent padded buffers plus the
        #: per-position layout ((key, version, len) per job, uid sequence,
        #: per-block signature/queue sequences) the delta diff runs against
        self._asm: Optional[dict] = None
        #: cached spec-keyed signature tuple (rebuilt only when some node's
        #: spec actually changed — accounting churn must not pay for it)
        self._spec_key: Optional[tuple] = None
        #: "cold" or "incremental": which assembly the last flatten took
        self.last_flatten_mode = "cold"

    # -- per-node rows ------------------------------------------------------

    def node_row(self, ni: NodeInfo) -> dict:
        vocab = self.vocab
        R = len(vocab)
        ent = self.node_rows.get(ni.name)
        if ent is not None and ent["v"] == ni.flat_version \
                and ent["e"] == ni.flat_epoch and ent["R"] == R:
            return ent
        idle = ni.idle.to_vector(vocab)
        used = ni.used.to_vector(vocab)
        extra = ni.releasing.to_vector(vocab) - ni.pipelined.to_vector(vocab)
        alloc = ni.allocatable.to_vector(vocab)
        alloc = np.where(alloc > 0, alloc, 1.0).astype(np.float32)
        npods = sum(1 for t in ni.tasks.values()
                    if t.status != TaskStatus.PIPELINED)
        ent = {"v": ni.flat_version, "e": ni.flat_epoch, "R": R,
               "sv": ni.spec_version,
               "idle": idle, "used": used,
               "extra": extra, "alloc": alloc, "npods": npods,
               "maxp": ni.allocatable.max_task_num or 1 << 30}
        self.node_rows[ni.name] = ent
        return ent

    # -- per-job task blocks ------------------------------------------------

    def job_block(self, job: JobInfo, tasks: List[TaskInfo],
                  uids: List[str]) -> dict:
        vocab = self.vocab
        R = len(vocab)
        ent = self.job_blocks.get(job.uid)
        if (ent is not None and ent["v"] == job.flat_version
                and ent["R"] == R and ent["uids"] == uids):
            return ent
        k = len(tasks)
        # bulk cpu/mem extraction: one list-comprehension + np.array beats
        # 2k per-task to_vector calls ~5x (the all-cold burst flatten is
        # this loop); scalar resources overlay the rare rows after
        init = np.zeros((k, R), dtype=np.float32)
        req = np.zeros((k, R), dtype=np.float32)
        init[:, :2] = np.array(
            [(t.init_resreq.milli_cpu, t.init_resreq.memory)
             for t in tasks], dtype=np.float32).reshape(k, 2)
        req[:, :2] = np.array(
            [(t.resreq.milli_cpu, t.resreq.memory)
             for t in tasks], dtype=np.float32).reshape(k, 2)
        any_scalar = np.zeros(k, dtype=bool)
        for i, t in enumerate(tasks):
            if t.init_resreq.scalars or t.resreq.scalars:
                for name, v in t.init_resreq.scalars.items():
                    if v >= MIN_MILLI_SCALAR:
                        # vocab-independent, like Resource.is_empty
                        any_scalar[i] = True
                    idx = vocab.index(name)
                    if idx is not None:
                        init[i, idx] = v
                for name, v in t.resreq.scalars.items():
                    idx = vocab.index(name)
                    if idx is not None:
                        req[i, idx] = v
        # not is_empty(): the api.resource thresholds
        counts = ((init[:, 0] >= MIN_MILLI_CPU)
                  | (init[:, 1] >= MIN_MEMORY) | any_scalar)
        sig_uniq: List[str] = []
        sig_reps: List[TaskInfo] = []
        sig_idx: Dict[str, int] = {}
        sig_local = np.zeros(k, dtype=np.int32)
        for i, t in enumerate(tasks):
            s = _signature(t)
            li = sig_idx.get(s)
            if li is None:
                li = sig_idx[s] = len(sig_uniq)
                sig_uniq.append(s)
                sig_reps.append(t)
            sig_local[i] = li
        ent = {"v": job.flat_version, "R": R, "uids": uids,
               "init": init, "req": req, "counts": counts,
               "sig_uniq": sig_uniq, "sig_reps": sig_reps,
               "sig_local": sig_local, "min": job.min_available,
               "ready": job.ready_task_num(), "queue": job.queue}
        self.job_blocks[job.uid] = ent
        return ent

    # -- bounded size -------------------------------------------------------

    def sweep(self, jobs_list, nodes_list, live_sigs) -> None:
        """Drop entries for departed jobs/nodes/signatures once the maps grow
        well past the live set, so a churny cluster can't grow the cache
        unboundedly (job blocks pin task arrays and Pod refs). The live sets
        are built lazily — in steady state only the size checks run."""
        if len(self.job_blocks) > 2 * len(jobs_list) + 64:
            live_jobs = {j.uid for j in jobs_list}
            self.job_blocks = {k: v for k, v in self.job_blocks.items()
                               if k in live_jobs}
        if len(self.node_rows) > 2 * len(nodes_list) + 64:
            live_nodes = {ni.name for ni in nodes_list}
            self.node_rows = {k: v for k, v in self.node_rows.items()
                              if k in live_nodes}
        if len(self.sig_rows) > 2 * len(live_sigs) + 64:
            self.sig_rows = {k: v for k, v in self.sig_rows.items()
                             if k in live_sigs}

    # -- vocab growth -------------------------------------------------------

    def ensure_names(self, resources) -> None:
        """Register any new scalar resource names (vocab only ever grows, so
        previously cached entries stay valid names-wise; width changes are
        caught by the per-entry R check)."""
        vocab = self.vocab
        for r in resources:
            for name in r.scalars:
                if vocab.index(name) is None:
                    vocab.add(name)


def flatten_snapshot(
    jobs: Dict[str, JobInfo],
    nodes: Dict[str, NodeInfo],
    tasks_in_order: List[TaskInfo],
    vocab: Optional[ResourceVocab] = None,
    queues: Optional[Dict[str, object]] = None,
    cache: Optional[FlattenCache] = None,
    grouped: Optional[List[tuple]] = None,
) -> SnapshotArrays:
    """Flatten session state into padded arrays.

    tasks_in_order: the pending tasks to place, already sorted by the
    session's namespace/queue/job/task ordering (host-side comparator pass —
    the ordering semantics stay in Python, the math goes on device).
    Tasks must be grouped by job within the order.

    Pass a persistent ``cache`` (the SchedulerCache owns one) to make the
    per-session flatten incremental: unchanged jobs reuse their cached task
    blocks, unchanged nodes their rows.

    NOTE: with a persistent cache the returned arrays alias cache-owned
    buffers that the NEXT flatten call may rewrite in place — they are valid
    for the current session only. Callers that need to retain arrays across
    sessions must copy them.
    """
    if cache is None:
        cache = FlattenCache(vocab)
    elif vocab is not None and cache.vocab is None:
        cache.vocab = vocab
    if cache.vocab is None:
        resources = []
        for ni in nodes.values():
            resources.append(ni.allocatable)
        for t in tasks_in_order:
            resources.append(t.init_resreq)
        cache.vocab = ResourceVocab.collect(resources)
    vocab = cache.vocab

    n_tasks = len(tasks_in_order)

    # group tasks by job, preserving order (callers that already hold the
    # per-job grouping — the allocate action — pass it via `grouped` and
    # skip this O(T) pass)
    jobs_seq = None
    if grouped is not None:
        job_keys = [j.uid for j, _ in grouped]
        job_tasks = [ts for _, ts in grouped]
        jobs_seq = [j for j, _ in grouped]
    else:
        job_keys: List[str] = []
        job_tasks: List[List[TaskInfo]] = []
        cur = None
        cur_list: List[TaskInfo] = []
        for t in tasks_in_order:
            if t.job != cur:
                cur = t.job
                cur_list = []
                job_keys.append(cur)
                job_tasks.append(cur_list)
            cur_list.append(t)
        if len(set(job_keys)) != len(job_keys):
            # non-contiguous job grouping (callers should not do this, the
            # sequential solver depends on contiguity): merge defensively
            merged: Dict[str, List[TaskInfo]] = {}
            for k, ts in zip(job_keys, job_tasks):
                merged.setdefault(k, []).extend(ts)
            job_keys = list(merged)
            job_tasks = list(merged.values())
            tasks_in_order = [t for ts in job_tasks for t in ts]
            n_tasks = len(tasks_in_order)

    if jobs_seq is None:
        jobs_seq = [jobs[k] for k in job_keys]

    # inline the ready check (state.phase is a slot read; the property call
    # costs ~0.2us x N on the per-cycle floor)
    _ready = NodePhase.READY
    nodes_list = [n for n in nodes.values() if n.state.phase is _ready]
    n_nodes = len(nodes_list)

    versions = [j.flat_version for j in jobs_seq]
    lens = [len(ts) for ts in job_tasks]
    nJ = len(job_keys)

    # -- delta diff against the previous assembly ---------------------------
    # P jobs of common prefix and S of common suffix (key, version and task
    # count all matching) frame the dirty middle; with ~1% churn the middle
    # is a handful of job blocks, and only those are re-packed below
    asm = cache._asm
    if asm is not None:
        ok_, ov_, ol_ = asm["job_keys"], asm["versions"], asm["lens"]
        oJ = len(ok_)
        if job_keys == ok_ and versions == ov_ and lens == ol_:
            P, S = nJ, 0  # unchanged layout: one C-speed compare, no walk
        else:
            m = min(nJ, oJ)
            P = 0
            while P < m and job_keys[P] == ok_[P] \
                    and versions[P] == ov_[P] and lens[P] == ol_[P]:
                P += 1
            S = 0
            lim = m - P
            while S < lim and job_keys[nJ - 1 - S] == ok_[oJ - 1 - S] \
                    and versions[nJ - 1 - S] == ov_[oJ - 1 - S] \
                    and lens[nJ - 1 - S] == ol_[oJ - 1 - S]:
                S += 1
        # verify the reusable regions' task identity: the caller passing
        # the same task-list OBJECT (the steady grouped path) certifies
        # the sequence unchanged for free; fresh lists fall back to a
        # per-job uid compare (C speed; version alone is trusted nowhere,
        # matching job_block). Callers must not reorder or mutate a task
        # list in place once handed to a flatten — build a new list.
        tl = asm["task_lists"]
        tu = asm["task_uids"]
        for j in range(P):
            ts = job_tasks[j]
            if ts is tl[j]:
                continue
            if [t.uid for t in ts] != tu[j]:
                P = j
                break
        if nJ != oJ or n_tasks != asm["n_tasks"]:
            # job positions / task offsets shift: the suffix cannot be
            # reused in place, rewrite everything from the prefix on
            S = 0
        for k2 in range(S):
            j = nJ - 1 - k2
            ts = job_tasks[j]
            if ts is tl[oJ - 1 - k2]:
                continue
            if [t.uid for t in ts] != tu[oJ - 1 - k2]:
                S = k2
                break
        off_P = sum(lens[:P])
    else:
        oJ = 0
        P = S = 0
        off_P = 0

    # vocab growth pre-pass: only entries about to recompute can introduce
    # new names; scanning just those (dirty-middle jobs, changed nodes)
    # keeps R stable below at O(churn) cost
    for j in range(P, nJ - S):
        ent = cache.job_blocks.get(job_keys[j])
        if ent is None or ent["v"] != versions[j]:
            cache.ensure_names(t.init_resreq for t in job_tasks[j])
            cache.ensure_names(t.resreq for t in job_tasks[j])
    # node layout key: parallel (epochs, versions) int arrays instead of a
    # tuple-of-triples — flat_epoch is unique per NodeInfo instance, so it
    # IS the position identity (names are only read for the rows that
    # actually recompute), and the dirty scan is two numpy != reductions
    node_epochs = np.array([ni.flat_epoch for ni in nodes_list],
                           dtype=np.int64)
    node_vers = np.array([ni.flat_version for ni in nodes_list],
                         dtype=np.int64)
    node_key = (node_epochs, node_vers)
    old_nk = cache._node_key
    if old_nk is not None and old_nk[0].shape[0] == n_nodes:
        dirty = np.nonzero((node_epochs != old_nk[0])
                           | (node_vers != old_nk[1]))[0].tolist()
    else:
        dirty = None  # resized/relaid layout: every row dirty
    rows = cache.node_rows
    for i in (dirty if dirty is not None else range(n_nodes)):
        ni = nodes_list[i]
        ent = rows.get(ni.name)
        if ent is None or ent["v"] != ni.flat_version:
            cache.ensure_names((ni.allocatable,))
    R = len(vocab)

    N = bucket(max(n_nodes, 1))
    T = bucket(max(n_tasks, 1))
    # +1 guarantees a padded (invalid) job slot: padded tasks point there so
    # the sequential solver's job-boundary logic never revisits a real job
    J = bucket(nJ + 1)
    shape_key = (R, T, J)

    arr = SnapshotArrays(vocab=vocab)
    arr.tasks_list = list(tasks_in_order)
    arr.nodes_list = nodes_list
    arr.jobs_list = jobs_seq

    # -- task/job side: persistent padded buffers, rewrite dirty rows only --
    if asm is not None and asm["shape"] != shape_key:
        asm = None
        P = S = 0
        oJ = 0
        off_P = 0
    if asm is not None:
        flat_mode = "incremental"
        bufs = asm["bufs"]
        blocks_list = asm["blocks"]
        mid_blocks = []
        mid_uids = []
        off = off_P
        for j in range(P, nJ - S):
            k = lens[j]
            u = [t.uid for t in job_tasks[j]]
            mid_uids.append(u)
            ent = cache.job_block(jobs_seq[j], job_tasks[j], u)
            mid_blocks.append(ent)
            if k:
                bufs["init"][off:off + k] = ent["init"]
                bufs["req"][off:off + k] = ent["req"]
                bufs["counts"][off:off + k] = ent["counts"]
            off += k
        end_mid = off
        if nJ - S > P:
            bufs["task_job"][off_P:end_mid] = np.repeat(
                np.arange(P, nJ - S, dtype=np.int32),
                np.asarray(lens[P:nJ - S], dtype=np.int64))
        jmin, jready = bufs["job_min"], bufs["job_ready"]
        jvalid = bufs["job_valid"]
        for j in range(P, nJ - S):
            ent = mid_blocks[j - P]
            jmin[j] = ent["min"]
            jready[j] = ent["ready"]
            jvalid[j] = True
        if S == 0:
            # shape is unchanged but counts may differ: restore the padding
            # invariants (rows >= n_tasks all-zero / invalid / padded-job)
            old_n = asm["n_tasks"]
            if old_n > n_tasks:
                bufs["init"][n_tasks:old_n] = 0.0
                bufs["req"][n_tasks:old_n] = 0.0
                bufs["counts"][n_tasks:old_n] = False
                bufs["sig"][n_tasks:old_n] = 0
            bufs["task_job"][n_tasks:] = J - 1
            bufs["valid"][:n_tasks] = True
            bufs["valid"][n_tasks:] = False
            if oJ > nJ:
                jmin[nJ:oJ] = 0
                jready[nJ:oJ] = 0
                jvalid[nJ:oJ] = False
                bufs["job_queue"][nJ:oJ] = 0

        # queue table: first-seen order over job blocks — unchanged when
        # the dirty middle's queue sequence is unchanged (the common case)
        new_queues = [b["queue"] for b in mid_blocks]
        old_mid_q = asm["job_queues"][P:oJ - S]
        asm["job_queues"][P:oJ - S] = new_queues
        if new_queues != old_mid_q:
            _rebuild_queue_table(asm, bufs)

        # signature table: same first-seen-order argument — if the middle's
        # per-block signature sequence is unchanged, the global table (and
        # every prefix/suffix task_sig row) is unchanged; only the middle
        # rows re-map through the existing table
        new_sig_seq = [b["sig_uniq"] for b in mid_blocks]
        old_mid_sigs = asm["block_sigs"][P:oJ - S]
        asm["block_sigs"][P:oJ - S] = new_sig_seq
        blocks_list[P:oJ - S] = mid_blocks
        if new_sig_seq == old_mid_sigs:
            sigs = asm["sigs"]
            sig_buf = bufs["sig"]
            off = off_P
            for i2, ent in enumerate(mid_blocks):
                k = lens[P + i2]
                if k:
                    uniq = ent["sig_uniq"]
                    if len(uniq) == 1:
                        sig_buf[off:off + k] = sigs[uniq[0]]
                    else:
                        remap = np.array([sigs[s] for s in uniq], np.int32)
                        sig_buf[off:off + k] = remap[ent["sig_local"]]
                off += k
        else:
            asm["sigs"], asm["sig_tasks"] = _rebuild_sigs(
                blocks_list, lens, bufs["sig"], n_tasks)
        asm["task_uids"][P:oJ - S] = mid_uids
        asm["task_lists"] = job_tasks
        asm["job_keys"] = job_keys
        asm["versions"] = versions
        asm["lens"] = lens
        asm["n_tasks"] = n_tasks
    else:
        # cold / reshaped: full assembly into fresh persistent buffers
        flat_mode = "cold"
        bufs = {
            "init": np.zeros((T, R), dtype=np.float32),
            "req": np.zeros((T, R), dtype=np.float32),
            "counts": np.zeros(T, dtype=bool),
            "sig": np.zeros(T, dtype=np.int32),
            "task_job": np.full(T, J - 1, dtype=np.int32),
            "rank": np.arange(T, dtype=np.int32),
            "valid": np.zeros(T, dtype=bool),
            "job_min": np.zeros(J, dtype=np.int32),
            "job_ready": np.zeros(J, dtype=np.int32),
            "job_queue": np.zeros(J, dtype=np.int32),
            "job_valid": np.zeros(J, dtype=bool),
        }
        blocks_list = []
        task_uids = []
        off = 0
        for j in range(nJ):
            k = lens[j]
            u = [t.uid for t in job_tasks[j]]
            task_uids.append(u)
            ent = cache.job_block(jobs_seq[j], job_tasks[j], u)
            blocks_list.append(ent)
            if k:
                bufs["init"][off:off + k] = ent["init"]
                bufs["req"][off:off + k] = ent["req"]
                bufs["counts"][off:off + k] = ent["counts"]
            off += k
        if n_tasks:
            bufs["task_job"][:n_tasks] = np.repeat(
                np.arange(nJ, dtype=np.int32),
                np.asarray(lens, dtype=np.int64))
            bufs["valid"][:n_tasks] = True
        queue_index: Dict[str, int] = {}
        queue_names: List[str] = []
        job_queues: List[str] = []
        jq = bufs["job_queue"]
        for j, ent in enumerate(blocks_list):
            bufs["job_min"][j] = ent["min"]
            bufs["job_ready"][j] = ent["ready"]
            bufs["job_valid"][j] = True
            q = ent["queue"]
            job_queues.append(q)
            qi = queue_index.get(q)
            if qi is None:
                qi = queue_index[q] = len(queue_names)
                queue_names.append(q)
            jq[j] = qi
        sigs, sig_tasks = _rebuild_sigs(blocks_list, lens, bufs["sig"],
                                        n_tasks)
        asm = {
            "shape": shape_key, "bufs": bufs, "blocks": blocks_list,
            "job_keys": job_keys, "versions": versions, "lens": lens,
            "task_uids": task_uids, "task_lists": job_tasks,
            "n_tasks": n_tasks,
            "block_sigs": [b["sig_uniq"] for b in blocks_list],
            "job_queues": job_queues,
            "sigs": sigs, "sig_tasks": sig_tasks,
            "queue_index": queue_index, "queue_names": queue_names,
        }
        cache._asm = asm

    arr.task_init_req = bufs["init"]
    arr.task_req = bufs["req"]
    arr.task_counts_ready = bufs["counts"]
    arr.task_sig = bufs["sig"]
    arr.task_job = bufs["task_job"]
    arr.task_rank = bufs["rank"]
    arr.task_valid = bufs["valid"]
    arr.job_min = bufs["job_min"]
    arr.job_ready_base = bufs["job_ready"]
    arr.job_queue = bufs["job_queue"]
    arr.job_valid = bufs["job_valid"]
    arr = _finish(arr, cache, nodes_list, n_nodes, R, N, node_key, dirty,
                  asm["sigs"], asm["sig_tasks"], asm["queue_index"],
                  asm["queue_names"], queues)
    cache.last_flatten_mode = flat_mode
    return arr


def _rebuild_sigs(blocks_list, lens, sig_buf, n_tasks):
    """Full signature-table rebuild: global first-seen indices over the
    blocks in assembly order, task_sig rows written in place. The slow path
    — the delta flatten takes it only when a dirty block changes the
    per-block signature sequence."""
    sigs: Dict[str, int] = {}
    sig_tasks: List[TaskInfo] = []
    off = 0
    for j, ent in enumerate(blocks_list):
        k = lens[j]
        uniq = ent["sig_uniq"]
        remap = np.empty(max(len(uniq), 1), dtype=np.int32)
        for li, s in enumerate(uniq):
            gi = sigs.get(s)
            if gi is None:
                gi = sigs[s] = len(sig_tasks)
                sig_tasks.append(ent["sig_reps"][li])
            remap[li] = gi
        if k:
            sig_buf[off:off + k] = remap[ent["sig_local"]]
        off += k
    sig_buf[n_tasks:] = 0
    return sigs, sig_tasks


def _rebuild_queue_table(asm, bufs) -> None:
    """Queue index/name tables: global first-seen order over the per-job
    queue sequence, job_queue rows rewritten in place. Runs only when some
    rewritten block changed the queue sequence."""
    queue_index: Dict[str, int] = {}
    queue_names: List[str] = []
    jq = bufs["job_queue"]
    for j, q in enumerate(asm["job_queues"]):
        qi = queue_index.get(q)
        if qi is None:
            qi = queue_index[q] = len(queue_names)
            queue_names.append(q)
        jq[j] = qi
    asm["queue_index"] = queue_index
    asm["queue_names"] = queue_names


def _fill_sig_masks(cache, out, sigs, sig_tasks, nodes_list, spec_key,
                    acct_key, N: int) -> None:
    """Fill the [S, N] predicate mask rows from the per-signature row cache
    (recomputing rows whose key moved). Shared by the full flatten and the
    event path's refresh-after-node-churn."""
    for s, s_idx in sigs.items():
        # (even the unconstrained "" signature must run the node loop:
        # untolerated NoSchedule taints block constraint-free pods too)
        row_key = acct_key if sig_tasks[s_idx].pod.ports() else spec_key
        cached = cache.sig_rows.get(s)
        if cached is not None and cached[0] == row_key \
                and cached[1].shape[0] == N:
            out[s_idx] = cached[1]
            continue
        pod = sig_tasks[s_idx].pod
        row = np.zeros(N, dtype=bool)
        for n_idx, ni in enumerate(nodes_list):
            node = ni.node
            ok = True
            if node is not None:
                ok = (_match_node_selector(pod.node_selector or {}, node)
                      and _tolerates(pod.tolerations, node)
                      and _node_affinity_match(pod.affinity, node))
                if ok and pod.ports():
                    taken = set()
                    for other in ni.tasks.values():
                        taken.update(other.pod.ports())
                    ok = not (set(pod.ports()) & taken)
            row[n_idx] = ok
        cache.sig_rows[s] = (row_key, row)
        out[s_idx] = row


def _apply_queue_overrides(arr, queue_index, queues, vocab) -> None:
    """Overlay weight/capability from the session's queue objects onto the
    default-initialized queue tables."""
    if not queues:
        return
    for name, q_idx in queue_index.items():
        qi = queues.get(name)
        if qi is None:
            continue
        arr.queue_weight[q_idx] = getattr(qi, "weight", 1) or 1
        cap = getattr(qi, "capability", None)
        if cap:
            cap_vec = Resource.from_resource_list(cap).to_vector(vocab)
            arr.queue_capability[q_idx] = np.where(
                cap_vec > 0, cap_vec, np.inf)


def _bulk_node_rows(cache, fast, buf, R: int) -> None:
    """Vectorized node-row recompute for scalar-free nodes: identical
    results (and cache entries) to FlattenCache.node_row, built as four
    [k,2] extractions instead of ~8 to_vector calls per node. The cached
    per-node entries view rows of the bulk arrays (standalone — NOT the
    session buffer, which is rewritten in place next flatten)."""
    k = len(fast)
    idle = np.zeros((k, R), np.float32)
    used = np.zeros((k, R), np.float32)
    extra = np.zeros((k, R), np.float32)
    alloc = np.zeros((k, R), np.float32)
    idle[:, :2] = np.array(
        [(ni.idle.milli_cpu, ni.idle.memory) for _, ni in fast],
        np.float32).reshape(k, 2)
    used[:, :2] = np.array(
        [(ni.used.milli_cpu, ni.used.memory) for _, ni in fast],
        np.float32).reshape(k, 2)
    # subtract in float32 like node_row's to_vector()-to_vector() (a
    # float64 intermediate here would round differently by an ulp and
    # break cold-vs-warm flatten identity)
    rel = np.array([(ni.releasing.milli_cpu, ni.releasing.memory)
                    for _, ni in fast], np.float32).reshape(k, 2)
    pip = np.array([(ni.pipelined.milli_cpu, ni.pipelined.memory)
                    for _, ni in fast], np.float32).reshape(k, 2)
    extra[:, :2] = rel - pip
    alloc[:, :2] = np.array(
        [(ni.allocatable.milli_cpu, ni.allocatable.memory)
         for _, ni in fast], np.float32).reshape(k, 2)
    alloc = np.where(alloc > 0, alloc, 1.0).astype(np.float32)
    npods = np.fromiter(
        (sum(1 for t in ni.tasks.values()
             if t.status != TaskStatus.PIPELINED) for _, ni in fast),
        np.int32, count=k)
    maxp = np.fromiter(
        (ni.allocatable.max_task_num or 1 << 30 for _, ni in fast),
        np.int64, count=k).astype(np.int32, copy=False)
    idxs = np.fromiter((i for i, _ in fast), np.int64, count=k)
    buf["idle"][idxs] = idle
    buf["extra"][idxs] = extra
    buf["used"][idxs] = used
    buf["alloc"][idxs] = alloc
    buf["npods"][idxs] = npods
    buf["maxp"][idxs] = maxp
    rows = cache.node_rows
    for j, (_, ni) in enumerate(fast):
        rows[ni.name] = {
            "v": ni.flat_version, "e": ni.flat_epoch, "R": R,
            "sv": ni.spec_version,
            "idle": idle[j], "used": used[j], "extra": extra[j],
            "alloc": alloc[j], "npods": int(npods[j]),
            "maxp": int(maxp[j])}


def _finish(arr, cache, nodes_list, n_nodes, R, N, node_key, dirty,
            sigs, sig_tasks, queue_index, queue_names, queues):
    vocab = arr.vocab
    # -- node side: persistent buffer, rewrite only changed rows ------------
    # node_key and the dirty positions were computed by flatten_snapshot's
    # single pre-pass over the node list (dirty is None when the previous
    # layout doesn't line up, i.e. every row is dirty)
    buf = cache._node_buf
    reusable = (buf is not None and buf["R"] == R and buf["N"] == N
                and dirty is not None)

    # spec-keyed signature tuple: rebuilt only when a changed node's spec
    # actually moved (name/epoch replacement or a spec_version bump) —
    # pure accounting churn reuses the cached tuple
    sk = cache._spec_key
    spec_stale = not reusable or sk is None or len(sk) != n_nodes
    if not spec_stale:
        # a dirty position whose epoch moved is a replaced node; one whose
        # spec_version moved is a respec'd node — either forces a rebuild,
        # pure accounting bumps (flat_version only) do not
        old_epochs = cache._node_key[0]
        rows = cache.node_rows
        for i in dirty:
            ni = nodes_list[i]
            if node_key[0][i] != old_epochs[i]:
                spec_stale = True
                break
            ent = rows.get(ni.name)
            if ent is None or ent["sv"] != ni.spec_version:
                spec_stale = True
                break
    if spec_stale:
        sk = tuple((ni.name, ni.flat_epoch, ni.spec_version)
                   for ni in nodes_list)
        cache._spec_key = sk

    if not reusable:
        buf = {
            "R": R, "N": N,
            "idle": np.zeros((N, R), dtype=np.float32),
            "extra": np.zeros((N, R), dtype=np.float32),
            "used": np.zeros((N, R), dtype=np.float32),
            "alloc": np.ones((N, R), dtype=np.float32),  # pads: avoid div 0
            "npods": np.zeros(N, dtype=np.int32),
            "maxp": np.zeros(N, dtype=np.int32),
            "valid": np.zeros(N, dtype=bool),
        }
        buf["valid"][:n_nodes] = True
        pending = list(enumerate(nodes_list))
    else:
        pending = [(i, nodes_list[i]) for i in dirty]
    # cold-path vectorization (first cycle / full reship): scalar-free
    # nodes bulk-extract cpu+mem via one list comprehension per column
    # and land in the buffer as fancy-indexed scatters — the per-node
    # to_vector path costs ~11us/node, most of a 2k-node cold flatten
    if len(pending) >= 64:
        rows = cache.node_rows

        def cached_ok(ni):
            ent = rows.get(ni.name)
            return (ent is not None and ent["v"] == ni.flat_version
                    and ent["e"] == ni.flat_epoch and ent["R"] == R)

        # bulk only the nodes node_row would actually RECOMPUTE: a node
        # whose buffer row is stale but whose cache entry is still valid
        # (bucket change, node removal) is a cheap dict hit below
        fast = [(i, ni) for i, ni in pending
                if not cached_ok(ni)
                and not (ni.idle.scalars or ni.used.scalars
                         or ni.releasing.scalars or ni.pipelined.scalars
                         or ni.allocatable.scalars)]
        if len(fast) >= 64:
            _bulk_node_rows(cache, fast, buf, R)
            done = {i for i, _ in fast}
            pending = [(i, ni) for i, ni in pending if i not in done]
    for i, ni in pending:
        row = cache.node_row(ni)
        buf["idle"][i] = row["idle"]
        buf["extra"][i] = row["extra"]
        buf["used"][i] = row["used"]
        buf["alloc"][i] = row["alloc"]
        buf["npods"][i] = row["npods"]
        buf["maxp"][i] = row["maxp"]
    cache._node_key = node_key
    cache._node_buf = buf
    arr.node_idle = buf["idle"]
    arr.node_extra_future = buf["extra"]
    arr.node_used = buf["used"]
    arr.node_alloc = buf["alloc"]
    arr.node_npods = buf["npods"]
    arr.node_max_pods = buf["maxp"]
    arr.node_valid = buf["valid"]

    # -- predicate signature masks (cached per signature x node epoch) ------
    S = max(len(sigs), 1)
    arr.sig_masks = np.zeros((S, N), dtype=bool)
    if not sig_tasks:
        arr.sig_masks[:, :] = True
    # label/taint-only masks survive resource-accounting churn: they key on
    # spec versions (the cached sk tuple); only port-aware masks key on the
    # full accounting state (epoch/version arrays serialized to bytes so
    # the cached-row compare is a memcmp, not 2k tuple compares)
    acct_key = (node_key[0].tobytes(), node_key[1].tobytes())
    _fill_sig_masks(cache, arr.sig_masks, sigs, sig_tasks, nodes_list,
                    sk, acct_key, N)

    # queues (water-filling inputs; overwritten by the allocate action from
    # the proportion plugin's session-open attrs when proportion is active —
    # those cover allocated/request across ALL jobs, not just pending ones)
    Q = bucket(max(len(queue_names), 1))
    arr.queues_list = queue_names
    arr.queue_weight = np.zeros(Q, dtype=np.float32)  # 0 = padded slot
    arr.queue_weight[:len(queue_names)] = 1.0
    arr.queue_capability = np.full((Q, R), np.inf, dtype=np.float32)
    arr.queue_allocated = np.zeros((Q, R), dtype=np.float32)
    arr.queue_request = np.zeros((Q, R), dtype=np.float32)
    _apply_queue_overrides(arr, queue_index, queues, vocab)

    # DRF ordering inputs default to zeros (drf inactive -> static rank);
    # the allocate action overwrites them from the drf plugin's attrs
    arr.job_drf_allocated = np.zeros((arr.job_min.shape[0], R),
                                     dtype=np.float32)
    arr.drf_total = np.zeros(R, dtype=np.float32)
    arr.job_drf_prerank = np.zeros(arr.job_min.shape[0], dtype=np.int32)

    arr.thresholds = vocab.thresholds()
    arr.scalar_dim_mask = np.zeros(R, dtype=bool)
    arr.scalar_dim_mask[2:] = True

    cache.sweep(arr.jobs_list, nodes_list, sigs)
    return arr
