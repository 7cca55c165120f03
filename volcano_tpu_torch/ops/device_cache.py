"""Device-resident packed solver arena with chunked delta upload.

Re-shipping the full packed snapshot (two buffers from
``SnapshotArrays.packed``) every session costs a host->device copy of the
whole problem, while a cluster typically changes a few rows per cycle.
This cache keeps the two packed buffers resident on the device ACROSS
scheduling sessions, chunked as ``[C, chunk]``, and ships only the chunks
whose bytes changed since the previous session — the counterpart of the
reference's informer deltas (client-go list-watch keeps the scheduler's
mirror warm instead of re-listing the cluster,
pkg/scheduler/cache/cache.go:319-402).

Arena contract (what survives what):

- **Chunked packed buffers** (``_dev_f``/``_dev_i``): device-resident
  across sessions; ``update`` scatters the exact dirty chunks into them
  IN PLACE (``index_copy_``) and returns them for
  ``solver.solve_allocate_packed2d``. Dropped on
  ``invalidate()``/``reset()``: after a failed dispatch the scatter has
  landed without its solve, so the next session re-ships them whole.
- **Score params** (``params_device``): device-resident across sessions,
  never written by a solve; re-validated (not re-uploaded) after
  ``invalidate()``. Only content changes re-pin them.
- **Host mirror** (``_host_f``/``_host_i``): host memory, kept so the
  per-session diff is chunk-exact. ``update`` commits it with the
  scatter, BEFORE the solve, so after a failed solve only
  ``invalidate()`` (the forced full re-ship) makes the device agree with
  it again — every caller invalidates on a device failure.

Accounting (``last_shipped_bytes``: a full ship's buffer bytes, or
``chunk * 4 + 4`` per dirty chunk of a delta — its values and its index;
``arena_hit_rate`` …) feeds the
``volcano_arena_*`` metrics and ``Scheduler.last_cycle_timing``.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from .convert import resolve_device, to_torch_params


def scatter_chunks(dev: torch.Tensor, idx: np.ndarray, vals) -> None:
    """``dev[idx] = vals`` in place over whole chunks (rows of ``dev``).
    ``idx`` is a host array of distinct chunk indices, ``vals`` a host
    array. The indices cross as int32 (the 4 bytes a chunk the accounting
    charges) and widen on the device: ``index_copy_`` takes int64 only."""
    dev.index_copy_(0, torch.from_numpy(idx.astype(np.int32)).to(
        dev.device).long(), torch.as_tensor(vals).to(dev.device, dev.dtype))


class PackedDeviceCache:
    """update(fbuf, ibuf, layout) -> (f2d, i2d) device tensors [C, chunk].

    First call (or any layout/shape change) ships everything; later calls
    diff against the previously shipped host copy chunk-wise and scatter
    exactly the dirty chunks (none when nothing changed).

    ``device``: where the arena lives — None means the CUDA device and
    raises when there is none; ``"cpu"`` keeps it on the host.
    """

    def __init__(self, chunk: int = 512, device=None):
        self.chunk = chunk
        self.device = resolve_device(device)
        self._host_f: Optional[np.ndarray] = None  # padded copy, [Cf*chunk]
        self._host_i: Optional[np.ndarray] = None
        self._dev_f: Optional[torch.Tensor] = None  # [Cf, chunk] on device
        self._dev_i: Optional[torch.Tensor] = None
        self._layout = None
        self._params_blob = None
        self._params_dev = None
        #: device buffers untrusted (a failed dispatch): next session
        #: full-ships and re-validates params
        self._params_suspect = False
        # previous mirror buffers recycled as diff scratch
        self._scratch_f: Optional[np.ndarray] = None
        self._scratch_i: Optional[np.ndarray] = None
        # -- arena accounting (diagnostics + volcano_arena_* metrics) ----
        self.last_shipped_chunks = 0
        self.last_shipped_bytes = 0     # bytes of the last delta/ship
        self.last_full_ship = False
        self.sessions = 0               # update calls
        self.full_ships = 0             # sessions that re-shipped everything
        self.delta_sessions = 0         # sessions that shipped a delta
        self.invalidations = 0          # soft resets (dispatch failures)
        self.params_repins = 0          # device params re-uploaded
        self.total_shipped_bytes = 0
        #: held across one session's update and solve (``fenced``)
        self.lock = threading.Lock()

    # -- arena introspection -------------------------------------------

    @property
    def arena_hit_rate(self) -> float:
        """Fraction of sessions served by a delta against the resident
        arena (1.0 = never re-shipped after the first session)."""
        if not self.sessions:
            return 0.0
        return self.delta_sessions / self.sessions

    def full_upload_bytes(self) -> int:
        """Bytes of one full padded-buffer upload at the current layout."""
        if self._host_f is None or self._host_i is None:
            return 0
        return int(self._host_f.nbytes + self._host_i.nbytes)

    def reset(self) -> None:
        """Hard reset: drop the mirror, the device-resident state AND the
        pinned params so the next session rebuilds everything. Used when
        the host-side mirror itself may have desynced from the device (a
        scatter that failed part-way)."""
        self._host_f = self._host_i = None
        self._dev_f = self._dev_i = None
        self._layout = None
        self._params_blob = None
        self._params_dev = None
        self._params_suspect = False

    def invalidate(self) -> None:
        """Soft reset after a failed dispatch: the in-place scatter has
        written chunks the failed solve never consumed, and ``update``
        already committed the mirror, so neither
        the device buffers nor a diff against the mirror can be trusted.
        Drop the chunked buffers — the next session full-ships them from
        its own snapshot — and keep the pinned params, re-validating them
        in place instead of re-uploading."""
        self._dev_f = self._dev_i = None
        self._layout = None  # forces the full re-ship
        self._params_suspect = True
        self.invalidations += 1

    @contextlib.contextmanager
    def fenced(self, ssn):
        """Hold the arena for one session's ``update`` and solve. The
        thread of an action the watchdog abandoned never enters once its
        epoch is contained (ActionContained), and one already inside
        finishes before the next session's update starts: the in-place
        scatters of two cycles never interleave, so the device buffers
        keep equal to the mirror."""
        from ..resilience.watchdog import ActionContained
        with self.lock:
            if ssn.action_contained():
                raise ActionContained(
                    "an abandoned action reached the device arena")
            yield

    # -- mirror maintenance --------------------------------------------

    def _full_ship(self, fbuf, ibuf, layout, cf: int, ci: int) -> None:
        """(Re)establish the host mirror and device buffers wholesale."""
        c = self.chunk
        hf = np.zeros(cf * c, np.float32)
        hf[:fbuf.size] = fbuf
        hi = np.zeros(ci * c, np.int32)
        hi[:ibuf.size] = ibuf
        self._host_f, self._host_i = hf, hi
        # copy=True: on a CPU arena from_numpy would alias the mirror, and
        # the in-place scatters would then write the mirror too
        self._dev_f = torch.from_numpy(hf.reshape(cf, c)).to(
            self.device, copy=True)
        self._dev_i = torch.from_numpy(hi.reshape(ci, c)).to(
            self.device, copy=True)
        self._layout = layout
        self._account(cf + ci, hf.nbytes + hi.nbytes, full=True)

    def _account(self, chunks: int, wire_bytes: int, full: bool) -> None:
        self.sessions += 1
        self.last_shipped_chunks = int(chunks)
        self.last_shipped_bytes = int(wire_bytes)
        self.last_full_ship = bool(full)
        self.total_shipped_bytes += int(wire_bytes)
        if full:
            self.full_ships += 1
        else:
            self.delta_sessions += 1

    def _needs_full_ship(self, layout, cf: int, ci: int) -> bool:
        c = self.chunk
        return (self._layout != layout or self._host_f is None
                or self._host_f.size != cf * c
                or self._host_i.size != ci * c)

    def _diff(self, fbuf, ibuf, cf: int, ci: int):
        """Pad new content into mirror-shaped buffers and locate dirty
        chunks: (f2, i2, df, di). Does NOT update the mirror (``update``
        does, once the scatter landed). The padded buffers come from the
        scratch pool — the previous session's mirror, recycled."""
        c = self.chunk
        f2, i2 = self._scratch_f, self._scratch_i
        if f2 is None or f2.size != cf * c:
            f2 = np.zeros(cf * c, np.float32)
        else:
            f2[fbuf.size:] = 0.0
        if i2 is None or i2.size != ci * c:
            i2 = np.zeros(ci * c, np.int32)
        else:
            i2[ibuf.size:] = 0
        self._scratch_f = self._scratch_i = None
        f2[:fbuf.size] = fbuf
        i2[:ibuf.size] = ibuf
        df = np.nonzero((f2.reshape(cf, c)
                         != self._host_f.reshape(cf, c)).any(axis=1))[0]
        di = np.nonzero((i2.reshape(ci, c)
                         != self._host_i.reshape(ci, c)).any(axis=1))[0]
        return f2, i2, df, di

    def update(self, fbuf: np.ndarray, ibuf: np.ndarray,
               layout) -> Tuple[torch.Tensor, torch.Tensor]:
        """The session entry: scatter exactly the dirty chunks into the
        resident buffers (everything on the first call or a layout change)
        and return them, ``[C, chunk]`` each, for
        ``solver.solve_allocate_packed2d``. The mirror is committed here,
        so a solve that fails afterwards must ``invalidate()``."""
        c = self.chunk
        cf = -(-max(fbuf.size, 1) // c)
        ci = -(-max(ibuf.size, 1) // c)
        if self._needs_full_ship(layout, cf, ci):
            self._full_ship(fbuf, ibuf, layout, cf, ci)
            return self._dev_f, self._dev_i
        f2, i2, df, di = self._diff(fbuf, ibuf, cf, ci)
        try:
            self._apply(self._dev_f, df, f2.reshape(cf, c))
            self._apply(self._dev_i, di, i2.reshape(ci, c))
        except Exception:
            # a partial scatter desyncs the device copy from the host
            # mirror: drop everything so the next session re-ships in full
            # instead of solving on stale data
            self.reset()
            raise
        # the diffed buffers become the mirror; the old mirror becomes the
        # next session's diff scratch
        self._scratch_f, self._scratch_i = self._host_f, self._host_i
        self._host_f, self._host_i = f2, i2
        self._account(df.size + di.size,
                      self._scatter_wire_bytes(df, di), full=False)
        return self._dev_f, self._dev_i

    def _scatter_wire_bytes(self, df, di) -> int:
        """Bytes a delta moves to the device: each dirty chunk's values
        plus its int32 index."""
        return int(df.size + di.size) * (self.chunk * 4 + 4)

    @staticmethod
    def _apply(dev, idx, host2d) -> None:
        if idx.size:
            scatter_chunks(dev, idx, host2d[idx])

    # ------------------------------------------------------------------
    # device-resident score params: a few small arrays ([N] node_static
    # dominates) that almost never change between cycles. Keep the device
    # copies and re-put only when the content bytes change, when a
    # suspect flag finds a copy unusable, or after a hard reset.
    # ------------------------------------------------------------------

    def _params_alive(self, dev_params: Optional[dict]) -> bool:
        """Whether every pinned param is still a tensor on the arena's
        device (a device reset would leave them unusable)."""
        if not dev_params:
            return False
        return all(isinstance(v, torch.Tensor) and v.device == self.device
                   for v in dev_params.values())

    def _put_params(self, params: dict) -> dict:
        """Device placement for the pinned score params."""
        return to_torch_params(params, self.device)

    def params_device(self, params: dict) -> dict:
        def _ent(k, v):
            # delimited key + dtype + shape + content: distinct params
            # dicts whose concatenated bytes happen to line up must not
            # collide and serve stale device params
            a = np.asarray(v)
            return b"\0".join((k.encode(), str(a.dtype).encode(),
                               repr(a.shape).encode(), a.tobytes())) + b"\1"

        blob = b"".join(_ent(k, v) for k, v in sorted(params.items()))
        if blob == self._params_blob:
            if not self._params_suspect:
                return self._params_dev
            # re-validate the pinned copies after a dispatch failure:
            # content unchanged AND buffers usable -> keep them resident
            if self._params_alive(self._params_dev):
                self._params_suspect = False
                return self._params_dev
        self._params_dev = self._put_params(params)
        self._params_blob = blob
        self._params_suspect = False
        self.params_repins += 1
        return self._params_dev


# ---------------------------------------------------------------------------
# node-axis sharded arena: the counterpart of the cache above for the
# sharded solver (parallel.solve_allocate_sharded_arena)
# ---------------------------------------------------------------------------

#: packed keys whose LEADING axis is the node axis: split over the shards
NODE_AXIS_KEYS = frozenset({
    "node_idle", "node_extra_future", "node_used", "node_alloc",
    "node_npods", "node_max_pods", "node_valid",
})

#: node axis SECOND: [S, N] predicate-signature masks are stored per shard
#: as [S, N/D]
NODE_COL_KEYS = frozenset({"sig_masks"})


def split_packed_layout(layout, n_shards: int):
    """Split a ``SnapshotArrays.packed()`` layout into the replicated part
    (task/job/queue/misc arrays, placed once per device) and the per-shard
    node part (node-axis arrays, one slice of N/n_shards rows per shard).
    Offsets are re-accumulated per part, so each part is its own dense flat
    buffer; per-shard shapes replace the node axis with N/n_shards. Returns
    ``(rep_layout, node_layout)`` — both in the same sorted-key order as the
    input, so byte layouts are deterministic. Pure layout arithmetic."""
    rep, node = [], []
    rf = ri = nf = ni = 0
    for key, kind, _off, _size, shape in layout:
        if key in NODE_AXIS_KEYS:
            n = shape[0]
            if n % n_shards:
                raise ValueError(
                    f"node axis {n} does not divide {n_shards} shards")
            pshape = (n // n_shards,) + tuple(shape[1:])
        elif key in NODE_COL_KEYS:
            n = shape[1]
            if n % n_shards:
                raise ValueError(
                    f"node axis {n} does not divide {n_shards} shards")
            pshape = (shape[0], n // n_shards)
        else:
            size = 1
            for s in shape:
                size *= s
            if kind == "f":
                rep.append((key, kind, rf, size, shape))
                rf += size
            else:
                rep.append((key, kind, ri, size, shape))
                ri += size
            continue
        size = 1
        for s in pshape:
            size *= s
        if kind == "f":
            node.append((key, kind, nf, size, pshape))
            nf += size
        else:
            node.append((key, kind, ni, size, pshape))
            ni += size
    return tuple(rep), tuple(node)


def _part_sizes(part_layout) -> Tuple[int, int]:
    """(flat f32 length, flat i32 length) of one split-layout part."""
    nf = max((off + size for _k, kind, off, size, _s in part_layout
              if kind == "f"), default=0)
    ni = max((off + size for _k, kind, off, size, _s in part_layout
              if kind != "f"), default=0)
    return nf, ni


class ShardedDeviceCache(PackedDeviceCache):
    """The device-resident arena of the sharded solve.

    Same contract as PackedDeviceCache — host mirror diffs, dirty-chunk
    deltas, pinned score params, soft ``invalidate()`` — laid out for
    ``parallel.solve_allocate_sharded_arena`` over ``mesh``
    (``parallel.Mesh``):

    - **node-axis arrays** live as one chunked buffer pair PER SHARD, on
      that shard's device (a mesh naming one device several times still
      gives each shard its own slabs). A dirty node row ships only to the
      shard that owns it;
    - **task/job/queue arrays** live as one chunked buffer pair per
      DISTINCT device, delta-updated in place;
    - **score params** are pinned per shard: the scalars once per distinct
      device, ``node_static`` split along the node axis.

    ``update(fbuf, ibuf, layout)`` -> ``(f_rep, i_rep, f_node, i_node,
    rep_layout, node_layout)``: the dispatch inputs of
    ``solve_allocate_sharded_arena`` (the four buffers as lists, one entry
    per shard). ``last_shard_bytes`` gives the bytes shipped to each shard
    by the last session: its node chunks plus the replicated delta (counted
    into every shard, as the JAX package does); a zero-dirty session ships
    0 bytes to every shard.
    """

    def __init__(self, mesh, chunk: int = 512):
        super().__init__(chunk, device=mesh.devices[0])
        self.mesh = mesh
        self.D = mesh.size
        self._rep_layout = None
        self._node_layout = None
        # host mirrors: rep flat [Crf*c]/[Cri*c]; node [D, Cnf*c]/[D, Cni*c]
        self._host_rep_f = self._host_rep_i = None
        self._host_node_f = self._host_node_i = None
        # device state: rep {device: [Cr, chunk]}; node [D] of [Cn, chunk]
        self._dev_rep_f = self._dev_rep_i = None
        self._dev_node_f = self._dev_node_i = None
        self.last_shard_bytes = [0] * self.D

    # -- params ---------------------------------------------------------

    def _put_params(self, params: dict) -> list:
        from ..parallel.sharded_solver import shard_params
        return shard_params(params, self.mesh)

    def _params_alive(self, dev_params) -> bool:
        if not dev_params or len(dev_params) != self.D:
            return False
        return all(isinstance(v, torch.Tensor) and v.device == dev
                   for p, dev in zip(dev_params, self.mesh.devices)
                   for v in p.values())

    # -- lifecycle ------------------------------------------------------

    def reset(self) -> None:
        super().reset()
        self._rep_layout = self._node_layout = None
        self._host_rep_f = self._host_rep_i = None
        self._host_node_f = self._host_node_i = None
        self._dev_rep_f = self._dev_rep_i = None
        self._dev_node_f = self._dev_node_i = None

    def invalidate(self) -> None:
        """Soft reset after a failed sharded session: one shard's scatter
        may have landed while another's was lost, so the resident buffers
        are dropped (the next session full-ships them) and the pinned
        params re-validated in place."""
        super().invalidate()
        self._rep_layout = self._node_layout = None
        self._dev_rep_f = self._dev_rep_i = None
        self._dev_node_f = self._dev_node_i = None

    def full_upload_bytes(self) -> int:
        if self._host_rep_f is None or self._host_node_f is None:
            return 0
        return int(self._host_rep_f.nbytes + self._host_rep_i.nbytes
                   + self._host_node_f.nbytes + self._host_node_i.nbytes)

    # -- host-side packing ---------------------------------------------

    def _pack_split(self, fbuf, ibuf, layout, rep_layout, node_layout,
                    out_rep_f, out_rep_i, out_node_f, out_node_i) -> None:
        """Scatter the global packed buffers into the split mirrors:
        replicated keys copy through; node keys slice one row-block (or
        sig_masks column-block) per shard."""
        goff = {k: (off, size, shape) for k, _kind, off, size, shape
                in layout}
        for key, kind, off, size, shape in rep_layout:
            g_off, g_size, _ = goff[key]
            src = fbuf if kind == "f" else ibuf
            dst = out_rep_f if kind == "f" else out_rep_i
            dst[off:off + size] = src[g_off:g_off + g_size]
        for key, kind, off, size, pshape in node_layout:
            g_off, g_size, g_shape = goff[key]
            src = fbuf if kind == "f" else ibuf
            dst = out_node_f if kind == "f" else out_node_i
            g = src[g_off:g_off + g_size].reshape(g_shape)
            for d in range(self.D):
                if key in NODE_COL_KEYS:
                    nl = pshape[1]
                    blk = g[:, d * nl:(d + 1) * nl]
                else:
                    nl = pshape[0]
                    blk = g[d * nl:(d + 1) * nl]
                dst[d, off:off + size] = blk.ravel()

    # -- the session entry ---------------------------------------------

    def update(self, fbuf: np.ndarray, ibuf: np.ndarray, layout):
        c, D = self.chunk, self.D
        if self._layout != layout or self._rep_layout is None:
            rep_layout, node_layout = split_packed_layout(layout, D)
        else:
            rep_layout, node_layout = self._rep_layout, self._node_layout
        rf, ri = _part_sizes(rep_layout)
        nf, ni = _part_sizes(node_layout)
        crf, cri = -(-max(rf, 1) // c), -(-max(ri, 1) // c)
        cnf, cni = -(-max(nf, 1) // c), -(-max(ni, 1) // c)
        srf = np.zeros(crf * c, np.float32)
        sri = np.zeros(cri * c, np.int32)
        snf = np.zeros((D, cnf * c), np.float32)
        sni = np.zeros((D, cni * c), np.int32)
        self._pack_split(fbuf, ibuf, layout, rep_layout, node_layout,
                         srf, sri, snf, sni)

        if (self._layout != layout or self._host_rep_f is None
                or self._dev_rep_f is None
                or self._host_rep_f.size != crf * c
                or self._host_node_f.shape != (D, cnf * c)):
            self._full_ship_split(srf, sri, snf, sni, layout, rep_layout,
                                  node_layout)
            return self._buffers()

        # delta: diff the split mirrors chunk-wise; each dirty replicated
        # chunk is scattered into every distinct device's copy, each dirty
        # node chunk into its own shard's slab only
        drf = self._dirty(srf, self._host_rep_f, crf)
        dri = self._dirty(sri, self._host_rep_i, cri)
        shard_bytes = [0] * D
        chunks = drf.size + dri.size
        try:
            for dev in self.mesh.distinct:
                self._apply(self._dev_rep_f[dev], drf, srf.reshape(crf, c))
                self._apply(self._dev_rep_i[dev], dri, sri.reshape(cri, c))
            for d in range(D):
                dnf = self._dirty(snf[d], self._host_node_f[d], cnf)
                dni = self._dirty(sni[d], self._host_node_i[d], cni)
                self._apply(self._dev_node_f[d], dnf, snf[d].reshape(cnf, c))
                self._apply(self._dev_node_i[d], dni, sni[d].reshape(cni, c))
                chunks += dnf.size + dni.size
                shard_bytes[d] = self._scatter_wire_bytes(dnf, dni)
        except Exception:
            # some shards took their chunks and others did not: nothing
            # resident can be trusted against the mirror any more
            self.reset()
            raise
        rep_bytes = self._scatter_wire_bytes(drf, dri)
        if chunks:
            self._host_rep_f, self._host_rep_i = srf, sri
            self._host_node_f, self._host_node_i = snf, sni
        self.last_shard_bytes = [int(b + (rep_bytes if chunks else 0))
                                 for b in shard_bytes]
        self._account(chunks, rep_bytes + sum(shard_bytes), full=False)
        return self._buffers()

    def _dirty(self, new, old, n_chunks: int) -> np.ndarray:
        c = self.chunk
        return np.nonzero((new.reshape(n_chunks, c)
                           != old.reshape(n_chunks, c)).any(axis=1))[0]

    def _full_ship_split(self, hrf, hri, hnf, hni, layout, rep_layout,
                         node_layout) -> None:
        """(Re)build the mirrors and place every buffer: the replicated
        pair once per distinct device, each shard's node pair on its
        device."""
        c, D = self.chunk, self.D
        self._host_rep_f, self._host_rep_i = hrf, hri
        self._host_node_f, self._host_node_i = hnf, hni

        def put(host, dev):
            # copy=True: on a CPU arena from_numpy would alias the mirror
            return torch.from_numpy(host.reshape(-1, c)).to(dev, copy=True)

        self._dev_rep_f = {dev: put(hrf, dev) for dev in self.mesh.distinct}
        self._dev_rep_i = {dev: put(hri, dev) for dev in self.mesh.distinct}
        self._dev_node_f = [put(hnf[d], dev)
                            for d, dev in enumerate(self.mesh.devices)]
        self._dev_node_i = [put(hni[d], dev)
                            for d, dev in enumerate(self.mesh.devices)]
        self._layout = layout
        self._rep_layout, self._node_layout = rep_layout, node_layout
        rep_bytes = hrf.nbytes + hri.nbytes
        self.last_shard_bytes = [int(hnf[d].nbytes + hni[d].nbytes
                                     + rep_bytes) for d in range(D)]
        self._account(hrf.size // c + hri.size // c
                      + D * (hnf.shape[1] + hni.shape[1]) // c,
                      rep_bytes + hnf.nbytes + hni.nbytes, full=True)

    def _buffers(self):
        devs = self.mesh.devices
        return ([self._dev_rep_f[d] for d in devs],
                [self._dev_rep_i[d] for d in devs],
                list(self._dev_node_f), list(self._dev_node_i),
                self._rep_layout, self._node_layout)
