"""Compile-and-dispatch pipeline layer: keep first-use costs off the
scheduling session thread.

PyTorch runs eagerly, so "compile" means two things here:

- the nvcc build of a kernel (``ops._build``), once per source digest and
  build directory — ``configure_compilation_cache`` points that directory
  at a persistent one, so a restarted process (or another process sharing
  the directory) finds the library built and loads it: a cache hit;
- the first solve at a new (packed layout, solve flags, device) key in the
  process: the first time the card sees a bucket's shapes it pays costs a
  warm solve at those shapes does not (the caching allocator growing its
  pool, lazily loaded kernel modules, first-use workspaces).

Three cooperating pieces:

- **configure_compilation_cache**: the kernel build directory.
- **CompileWatcher**: per-thread counts and seconds of kernel builds and
  cold first solves, plus build-cache hits, feeding ``metrics``. The
  scheduler surfaces the session-thread deltas in ``last_cycle_timing``
  (``session_compiles`` / ``session_compile_s``), so "the session paid a
  cold solve" is an observable regression, not a mystery spike.
- **BucketPrewarmer**: the flatten pads to buckets (``ops.arrays.bucket``
  quarter-steps), so the set of future solve keys is *predictable*: when
  live task/node/job occupancy crosses a threshold of the current bucket,
  the next bucket's packed layout is synthesized host-side
  (``predict_next_layout`` — byte-exact layout arithmetic, no flatten
  needed) and the solve runs there once on a daemon thread, on the live
  snapshot re-laid into that layout. The session thread's first
  post-crossing solve then finds the key warm.

The warm runs on the CUDA stream the session dispatched on: the caching
allocator keeps one pool per stream, so blocks grown by a warm on a side
stream would not serve the session's allocations.
"""

from __future__ import annotations

import logging
import os
import threading
from contextlib import contextmanager
from typing import Dict, Optional, Tuple

import numpy as np

log = logging.getLogger(__name__)

#: env override consumed when no explicit dir is configured
CACHE_DIR_ENV = "VOLCANO_COMPILE_CACHE_DIR"

_configured_dir: Optional[str] = None


def configure_compilation_cache(cache_dir: Optional[str] = None
                                ) -> Optional[str]:
    """Point the kernel build directory at ``cache_dir``.

    ``cache_dir`` falls back to $VOLCANO_COMPILE_CACHE_DIR; returns the
    directory in effect (None = the default ``build/kernels`` at the
    repository root, left unchanged). Idempotent — repeated calls with the
    same dir are no-ops; a different dir re-points the builds.
    """
    global _configured_dir
    cache_dir = cache_dir or os.environ.get(CACHE_DIR_ENV) or None
    if not cache_dir or _configured_dir == cache_dir:
        return _configured_dir
    from . import _build

    os.makedirs(cache_dir, exist_ok=True)
    _build.set_build_dir(cache_dir)
    _configured_dir = cache_dir
    return _configured_dir


# ---------------------------------------------------------------------------
# compile observability
# ---------------------------------------------------------------------------

class CompileWatcher:
    """Per-thread accounting of kernel builds and cold first solves.

    ``ops._build`` and the solve entry points report here directly
    (``record_compile`` / ``record_cache_hit`` / ``first_solve``); once
    ``install()`` ran, each report counts against the reporting thread.
    Threads registered through ``register_background`` (the prewarmer's
    workers) are labeled ``background`` in the exported metrics; everything
    else counts as ``session`` — exactly the split the cycle budget cares
    about. Which solve keys are warm is tracked whether or not the watcher
    is installed: warmth is a property of the process.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._by_thread: Dict[int, list] = {}   # ident -> [count, seconds]
        self._background: set = set()
        self._warm_keys: set = set()
        self.cache_hits = 0
        self._installed = False

    def install(self) -> bool:
        with self._lock:
            self._installed = True
        return True

    def record_compile(self, secs: float,
                       ident: Optional[int] = None) -> None:
        """One kernel build or cold first solve of ``secs`` seconds on the
        calling thread (or ``ident``)."""
        ident = threading.get_ident() if ident is None else ident
        with self._lock:
            if not self._installed:
                return
            ent = self._by_thread.setdefault(ident, [0, 0.0])
            ent[0] += 1
            ent[1] += secs
            label = "background" if ident in self._background else "session"
        from ..metrics import metrics

        metrics.solver_compile_total.inc(labels={"thread": label})
        metrics.solver_compile_seconds_total.inc(secs,
                                                 labels={"thread": label})

    def record_cache_hit(self) -> None:
        with self._lock:
            if not self._installed:
                return
            self.cache_hits += 1
        from ..metrics import metrics

        metrics.compile_cache_hits_total.inc()

    @contextmanager
    def first_solve(self, key):
        """Wrap one solve at ``key``: a solve that starts before any solve
        at its key succeeded in this process is one compile, timed, on
        the calling thread."""
        with self._lock:
            cold = key not in self._warm_keys
        if not cold:
            yield
            return
        import time

        t0 = time.perf_counter()
        yield
        with self._lock:
            self._warm_keys.add(key)
        self.record_compile(time.perf_counter() - t0)

    # -- accounting views -------------------------------------------------

    def register_background(self, ident: Optional[int] = None) -> None:
        with self._lock:
            self._background.add(
                threading.get_ident() if ident is None else ident)

    def counts(self, ident: Optional[int] = None) -> Tuple[int, float]:
        """(compiles, seconds) observed on one thread (default: caller's)."""
        ident = threading.get_ident() if ident is None else ident
        with self._lock:
            ent = self._by_thread.get(ident, (0, 0.0))
            return int(ent[0]), float(ent[1])

    def session_totals(self) -> Tuple[int, float]:
        """(compiles, seconds) summed over all non-background threads."""
        with self._lock:
            c, s = 0, 0.0
            for ident, (n, secs) in self._by_thread.items():
                if ident not in self._background:
                    c += n
                    s += secs
            return c, s


#: process-wide watcher; ``install()`` is called by the scheduler wiring
#: and the prewarmer — whoever gets there first
watcher = CompileWatcher()


def solve_key(kind: str, devices, layout, flags: dict) -> tuple:
    """The key a solve's first-use costs depend on: the entry (``kind``),
    its device(s), the packed layout's keys, kinds and shapes, and the
    solve flags (SOLVE_FLAG_NAMES)."""
    return (kind, tuple(str(d) for d in devices),
            tuple((k, knd, tuple(shape))
                  for k, knd, _off, _size, shape in layout),
            tuple(sorted((k, v) for k, v in flags.items()
                         if k in SOLVE_FLAG_NAMES)))


# ---------------------------------------------------------------------------
# packed-layout prediction
# ---------------------------------------------------------------------------

#: semantic dims of every key in SnapshotArrays._base_device_dict — the
#: packed layout for ANY bucket combination follows from these plus the
#: sorted-key offset accumulation in SnapshotArrays.packed(). hdrf keys
#: are deliberately absent: their tree dims (H, D) don't scale with the
#: buckets, so hdrf sessions skip prewarm (predict returns None).
_PACKED_DIMS: Dict[str, Tuple[str, ...]] = {
    "task_init_req": ("T", "R"), "task_req": ("T", "R"),
    "task_job": ("T",), "task_rank": ("T",), "task_sig": ("T",),
    "task_counts_ready": ("T",), "task_valid": ("T",),
    "job_min": ("J",), "job_ready_base": ("J",), "job_queue": ("J",),
    "job_valid": ("J",), "job_drf_allocated": ("J", "R"),
    "drf_total": ("R",), "job_drf_prerank": ("J",),
    "node_idle": ("N", "R"), "node_extra_future": ("N", "R"),
    "node_used": ("N", "R"), "node_alloc": ("N", "R"),
    "node_npods": ("N",), "node_max_pods": ("N",), "node_valid": ("N",),
    "sig_masks": ("S", "N"),
    "queue_weight": ("Q",), "queue_capability": ("Q", "R"),
    "queue_allocated": ("Q", "R"), "queue_request": ("Q", "R"),
    "thresholds": ("R",), "scalar_dim_mask": ("R",),
}


def layout_dims(layout) -> Optional[Dict[str, int]]:
    """Recover the padded {T,N,J,Q,S,R} from a packed layout, or None when
    the layout carries keys outside the predictable set (hdrf)."""
    dims: Dict[str, int] = {}
    for key, _kind, _off, _size, shape in layout:
        names = _PACKED_DIMS.get(key)
        if names is None:
            return None
        for name, size in zip(names, shape):
            if dims.setdefault(name, size) != size:
                return None  # inconsistent layout; refuse to predict
    return dims


def predict_next_layout(layout, dims: Dict[str, int]):
    """Rebuild a packed layout for new padded sizes ``dims`` (complete
    {T,N,J,Q,S,R} map): same keys in the same (sorted) order, shapes
    remapped per _PACKED_DIMS, offsets re-accumulated exactly like
    SnapshotArrays.packed(). Byte-exact against a real flatten at those
    sizes. None when the layout has unpredictable keys."""
    out = []
    foff = ioff = 0
    for key, kind, _off, _size, _shape in layout:
        names = _PACKED_DIMS.get(key)
        if names is None or any(n not in dims for n in names):
            return None
        shape = tuple(int(dims[n]) for n in names)
        size = 1
        for s in shape:
            size *= s
        if kind == "f":
            out.append((key, kind, foff, size, shape))
            foff += size
        else:
            out.append((key, kind, ioff, size, shape))
            ioff += size
    return tuple(out)


def dummy_packed_buffers(layout, chunk: int):
    """Zeroed chunked arena-shaped buffers (f2d, i2d) for a layout."""
    nf = max(off + size for _k, kind, off, size, _s in layout
             if kind == "f")
    ni = max(off + size for _k, kind, off, size, _s in layout
             if kind != "f")
    cf = -(-max(nf, 1) // chunk)
    ci = -(-max(ni, 1) // chunk)
    return (np.zeros((cf, chunk), np.float32),
            np.zeros((ci, chunk), np.int32))


def dummy_sharded_buffers(layout, chunk: int, mesh):
    """Zeroed host buffers of the sharded arena's dispatch inputs at a
    layout: the replicated chunked pair, the [D, C, chunk] node pair (one
    slab per shard) and the split layouts (ops.device_cache.
    split_packed_layout)."""
    from .device_cache import _part_sizes, split_packed_layout

    D = int(mesh.size)
    rep_l, node_l = split_packed_layout(layout, D)
    rf, ri = _part_sizes(rep_l)
    nf, ni = _part_sizes(node_l)
    crf = -(-max(rf, 1) // chunk)
    cri = -(-max(ri, 1) // chunk)
    cnf = -(-max(nf, 1) // chunk)
    cni = -(-max(ni, 1) // chunk)
    return (np.zeros((crf, chunk), np.float32),
            np.zeros((cri, chunk), np.int32),
            np.zeros((D, cnf, chunk), np.float32),
            np.zeros((D, cni, chunk), np.int32),
            rep_l, node_l)


def dummy_score_params(dims: Dict[str, int]) -> Dict[str, np.ndarray]:
    """Score-params dict with the shapes build_score_inputs produces for a
    problem of these padded sizes (values irrelevant)."""
    return {
        "binpack_weight": np.float32(0.0),
        "binpack_res_weights": np.ones(dims["R"], np.float32),
        "least_req_weight": np.float32(0.0),
        "most_req_weight": np.float32(0.0),
        "balanced_weight": np.float32(0.0),
        "node_static": np.zeros(dims["N"], np.float32),
    }


#: values the flatten pads with where they are not 0 (ops.arrays): an
#: unused node allocates 1 (no division by zero), an unused queue is
#: uncapped, an unused task belongs to the last (padded) job
_PAD_FILL = {"node_alloc": 1.0, "queue_capability": np.inf}


def relayout_buffers(fbuf, ibuf, layout, layout2, dims2: Dict[str, int],
                     chunk: int):
    """The packed content of ``layout`` (flat ``fbuf`` / ``ibuf``) re-laid
    into the larger ``layout2``, as ``dummy_packed_buffers(layout2)`` with
    every key's block copied into the leading corner of its new shape and
    the rest padded as the flatten pads. A solve of the result does the
    live problem's work at the next bucket's shapes."""
    f2d, i2d = dummy_packed_buffers(layout2, chunk)
    f2, i2 = f2d.reshape(-1), i2d.reshape(-1)
    old = {k: (knd, off, size, shape) for k, knd, off, size, shape in layout}
    for key, kind, off2, size2, shape2 in layout2:
        _knd, off, size, shape = old[key]
        src = (fbuf if kind == "f" else ibuf)[off:off + size].reshape(shape)
        dst = (f2 if kind == "f" else i2)[off2:off2 + size2].reshape(shape2)
        if key == "task_job":
            dst[:] = dims2["J"] - 1
        elif key in _PAD_FILL:
            dst[:] = _PAD_FILL[key]
        dst[tuple(slice(0, n) for n in shape)] = src
    return f2d, i2d


def pad_score_params(params: dict, dims2: Dict[str, int]) -> dict:
    """Host score params padded to the next bucket's node count."""
    out = dict(params)
    ns = np.asarray(params["node_static"], np.float32)
    out["node_static"] = np.zeros(dims2["N"], np.float32)
    out["node_static"][:ns.size] = ns
    return out


# ---------------------------------------------------------------------------
# background bucket pre-warm
# ---------------------------------------------------------------------------

#: static flag names shared by the packed solver entry points; the
#: sharded entry takes all but work_conserving
SOLVE_FLAG_NAMES = ("herd_mode", "score_families", "use_queue_cap",
                    "use_drf_order", "use_hdrf_order", "work_conserving")


class BucketPrewarmer:
    """Watch bucket occupancy; solve once at the next bucket's shapes on a
    daemon thread before the cluster crosses into them.

    ``observe(arr, dc, flags)`` is called by the allocate action inside
    the dispatch/collect overlap window (it only compares integers and
    maybe spawns a thread). When any of live T/N/J reaches ``threshold``
    of its current bucket, the next bucket's layout is predicted and
    ``solve_allocate_packed2d`` (and, with a ``mesh``, the sharded arena
    entry) runs off-thread on the session's last inputs re-laid into it
    (``relayout_buffers``), through a throwaway arena on the cache's
    device. Each (dims, flags) combination warms at most once per
    process. Decisions are untouched: the warm shares no buffer with the
    session.
    """

    def __init__(self, threshold: float = 0.8, mesh=None):
        self.threshold = threshold
        self.mesh = mesh
        self._lock = threading.Lock()
        self._started: Dict[tuple, str] = {}   # key -> status
        self._threads: list = []
        self.completions = 0
        self.failures = 0

    # -- occupancy watch --------------------------------------------------

    def observe(self, arr, dc, flags: Optional[dict] = None) -> bool:
        """Check occupancy against the current buckets; spawn a warm for
        the next-bucket variant when warranted. Returns True when a warm
        was scheduled."""
        from .arrays import bucket

        layout = getattr(dc, "_layout", None)
        inputs = getattr(dc, "last_solve_inputs", None)
        if layout is None or inputs is None:
            return False
        if flags is None:
            flags = getattr(dc, "last_solve_flags", None)
            if flags is None:
                return False
        flags = {k: v for k, v in flags.items() if k in SOLVE_FLAG_NAMES}
        live_t = len(arr.tasks_list)
        live_n = len(arr.nodes_list)
        live_j = len(arr.jobs_list)
        dims = layout_dims(layout)
        if dims is None:
            return False  # hdrf / unknown layout: no prediction
        crossed = []
        # J pads to bucket(nJ + 1) in the flatten, so its occupancy
        # compares live+1 against the bucket
        for name, live, pad1 in (("T", live_t, 0), ("N", live_n, 0),
                                 ("J", live_j, 1)):
            cur = dims[name]
            if live + pad1 >= self.threshold * cur and bucket(cur + 1) != cur:
                crossed.append(name)
        if not crossed:
            return False
        # an occupancy trigger says WHICH dims are near their edge, not
        # which will actually cross first (pods grow without nodes all the
        # time): warm every non-empty subset of the crossed dims, largest
        # first, so whichever combination the cluster lands on is covered
        # (≤7 combos, each deduped per process)
        fkey = tuple(sorted((k, v) for k, v in flags.items()))
        work = []
        subsets = sorted(
            (s for m in range(1, 1 << len(crossed))
             for s in [[d for i, d in enumerate(crossed) if m >> i & 1]]),
            key=len, reverse=True)
        for sub in subsets:
            nxt = dict(dims)
            for name in sub:
                nxt[name] = bucket(dims[name] + 1)
            key = (tuple(sorted(nxt.items())), fkey)
            with self._lock:
                if key in self._started:
                    continue
                self._started[key] = "running"
            layout2 = predict_next_layout(layout, nxt)
            if layout2 is None:
                with self._lock:
                    self._started[key] = "unsupported"
                continue
            work.append((key, layout2, nxt))
        if not work:
            return False
        device = dc.mesh.devices[0] if getattr(dc, "mesh", None) is not None \
            else dc.device
        stream = None
        if device.type == "cuda":
            import torch

            stream = torch.cuda.current_stream(device)
        t = threading.Thread(
            target=self._warm_many,
            args=(work, dc.chunk, flags, layout, inputs, device, stream),
            name="bucket-prewarm", daemon=True)
        with self._lock:
            self._threads.append(t)
        t.start()
        return True

    def _warm_many(self, work, chunk: int, flags: dict, layout, inputs,
                   device, stream) -> None:
        watcher.install()
        watcher.register_background()
        from . import fused_choice as fc

        with fc.counted_as_prewarm():
            if stream is None:
                for key, layout2, dims2 in work:
                    self._warm(key, layout2, dims2, chunk, flags, layout,
                               inputs, device)
                return
            import torch

            with torch.cuda.stream(stream):
                for key, layout2, dims2 in work:
                    self._warm(key, layout2, dims2, chunk, flags, layout,
                               inputs, device)

    # -- the warm itself (background thread) ------------------------------

    def _warm(self, key, layout2, dims2, chunk: int, flags: dict, layout,
              inputs, device) -> None:
        try:
            from .device_cache import PackedDeviceCache, ShardedDeviceCache
            from .solver import solve_allocate_packed2d

            fbuf, ibuf, params = inputs
            f2d, i2d = relayout_buffers(fbuf, ibuf, layout, layout2, dims2,
                                        chunk)
            params2 = pad_score_params(params, dims2)
            # a throwaway arena: the session path's own full ship at the
            # new layout, sharing nothing with the session's arena
            arena = PackedDeviceCache(chunk, device=device)
            dev_f, dev_i = arena.update(f2d.reshape(-1), i2d.reshape(-1),
                                        layout2)
            res = solve_allocate_packed2d(
                dev_f, dev_i, layout2, arena.params_device(params2),
                **flags)
            res.compact.cpu()
            if self.mesh is not None:
                from ..parallel.sharded_solver import (
                    solve_allocate_sharded_arena,
                )
                sarena = ShardedDeviceCache(self.mesh, chunk)
                bufs = sarena.update(f2d.reshape(-1), i2d.reshape(-1),
                                     layout2)
                sflags = {k: v for k, v in flags.items()
                          if k != "work_conserving"}
                rs = solve_allocate_sharded_arena(
                    *bufs, sarena.params_device(params2), self.mesh,
                    **sflags)
                rs.assigned.cpu()
            with self._lock:
                self._started[key] = "done"
                self.completions += 1
            from ..metrics import metrics

            metrics.prewarm_completions_total.inc()
            log.info("pre-warmed the solve for buckets %s", dims2)
        except Exception:  # noqa: BLE001 — a failed warm must not crash
            with self._lock:
                self._started[key] = "failed"
                self.failures += 1
            log.exception("bucket pre-warm failed for %s", dims2)

    # -- sync points (tests / shutdown) -----------------------------------

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Join outstanding warm threads; True when none remain alive."""
        with self._lock:
            threads = list(self._threads)
        for t in threads:
            t.join(timeout)
        with self._lock:
            self._threads = [t for t in self._threads if t.is_alive()]
            return not self._threads

    @property
    def pending(self) -> int:
        with self._lock:
            return sum(1 for t in self._threads if t.is_alive())
