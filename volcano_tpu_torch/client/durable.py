"""Durable ClusterStore: write-ahead log + compacted snapshots.

Every crash-safety layer above the store — the bind-intent journal, the
migration-intent journal, the HA lease, the watch-resume EventJournal —
persists *into the store*, so without this layer a store crash silently
voids all of them. The reference never had this hole: the k8s
API server persists every object through etcd's WAL + raft snapshots.
This module is that durability floor. Its files are the JAX package's
byte for byte: either package recovers a data directory the other wrote.

``DurableClusterStore`` is a ``ClusterStore`` whose every committed
mutation appends one fsync'd record to an append-only log BEFORE any
watcher observes it, and which periodically compacts the log into a full
snapshot. On start it recovers: newest valid snapshot (CRC-framed; a
corrupt one falls back to the previous), then the WAL tail replayed on
top (CRC-checked per record, a torn final record truncated), restoring
the buckets, the global ``resource_version`` counter, the per-kind event
rvs, AND a bounded per-kind tail of the replayed events so the server's
``EventJournal`` can seed its resume window — a watcher that was mid-
stream when the store died resumes over the restart through the normal
``since:`` path instead of the crash-only full resync.

File layout under ``data_dir``::

    snapshot-<rv>.ckpt   one CRC-framed JSON blob (tmp+rename, fsync'd)
    wal-<rv>.log         records with resource_version > <rv>; a new
                         segment opens at every snapshot (and at every
                         process start), so segments fully covered by
                         the oldest retained snapshot can be pruned

Record/snapshot framing: ``<u32 len><u32 crc32(payload)><payload>`` with
JSON payloads built from the wire codec (client/codec.py) — the WAL
speaks the same tagged-JSON dialect as the TCP protocol, inspectable
with a text editor and closed over the model registry.

fsync policy (``--store-fsync``): ``every`` (default — an acked write is
durable; one fsync per commit, batched to one per ``bulk_apply``),
``interval`` (group commit: at most one fsync per interval; a crash can
lose the last interval's acked writes), ``off`` (flush to the OS, never
fsync; survives process kill, not host power loss). The in-memory
default path is untouched: a plain ``ClusterStore`` has no WAL and pays
nothing.

Fault points: ``wal_fsync`` fires inside every fsync (arm ``delay:`` for
a slow disk, ``exc:`` for a write error surfacing to the client);
``store_crash`` fires after the WAL append and before the commit is
announced (arm ``exc:exit`` to kill -9 the store process with the record
durable but the response never sent — the ambiguous-crash case the
conditional-retry rules in client/remote.py exist for).
"""

from __future__ import annotations

import collections
import glob
import json
import logging
import os
import struct
import time
import zlib
from typing import Any, Deque, Dict, List, Optional, Tuple

from ..resilience.faultinject import faults
from .codec import decode, encode
from .store import ClusterStore

log = logging.getLogger(__name__)

_HEADER = struct.Struct("<II")  # payload length, crc32(payload)
FSYNC_POLICIES = ("every", "interval", "off")
SNAPSHOT_EVERY_RECORDS = 4096   # WAL records between compactions
KEEP_SNAPSHOTS = 2              # newest + one fallback
TAIL_CAPACITY = 4096            # per-kind recovered events kept for the
                                # EventJournal's resume window


def _frame(payload: bytes) -> bytes:
    return _HEADER.pack(len(payload), zlib.crc32(payload)) + payload


def read_frames(path: str) -> Tuple[List[dict], int, bool]:
    """All valid frames in ``path`` -> (payloads, valid_bytes, torn).

    Stops at the first torn or corrupt frame (short header, short body,
    CRC mismatch, undecodable JSON): everything before it is good,
    everything from it on is the debris of a crash mid-append. Returns
    the byte offset the file should be truncated to."""
    out: List[dict] = []
    offset = 0
    torn = False
    try:
        with open(path, "rb") as f:
            data = f.read()
    except FileNotFoundError:
        return out, 0, False
    while offset < len(data):
        if offset + _HEADER.size > len(data):
            torn = True
            break
        length, crc = _HEADER.unpack_from(data, offset)
        body = data[offset + _HEADER.size: offset + _HEADER.size + length]
        if len(body) < length or zlib.crc32(body) != crc:
            torn = True
            break
        try:
            out.append(json.loads(body))
        except ValueError:
            torn = True
            break
        offset += _HEADER.size + length
    return out, offset, torn


class WriteAheadLog:
    """One append-only WAL segment. Appends always flush to the OS;
    fsync follows the policy (see module docstring). Not thread-safe on
    its own — the owning store serializes appends under its write lock,
    exactly like the mutations they record."""

    def __init__(self, path: str, fsync: str = "every",
                 fsync_interval_s: float = 0.05,
                 metric_labels: Optional[Dict[str, str]] = None):
        if fsync not in FSYNC_POLICIES:
            raise ValueError(f"fsync policy {fsync!r} not in "
                             f"{FSYNC_POLICIES}")
        self.path = path
        self.fsync_policy = fsync
        self.fsync_interval_s = float(fsync_interval_s)
        # e.g. {"shard": "3"} on a sharded member's WAL, so the
        # volcano_store_wal_* family separates per shard lineage; the
        # unsharded store stays label-free (byte-identical exposition)
        self.metric_labels = metric_labels
        self._f = open(path, "ab")
        self.size_bytes = self._f.tell()
        self.appends = 0
        self.fsyncs = 0
        self._last_sync = 0.0

    def append(self, record: dict, sync: bool = True) -> None:
        raw = json.dumps(record, separators=(",", ":")).encode()
        frame = _frame(raw)
        self._f.write(frame)
        self._f.flush()
        self.size_bytes += len(frame)
        self.appends += 1
        if sync:
            self.maybe_sync()

    def maybe_sync(self) -> None:
        """fsync if the policy calls for one now (``every`` always,
        ``interval`` at most once per interval, ``off`` never)."""
        if self.fsync_policy == "off":
            return
        if self.fsync_policy == "interval" and \
                time.monotonic() - self._last_sync < self.fsync_interval_s:
            return
        self.sync()

    def sync(self) -> None:
        faults.fire("wal_fsync")
        os.fsync(self._f.fileno())
        self._last_sync = time.monotonic()
        self.fsyncs += 1
        try:
            from ..metrics import metrics
            metrics.store_wal_fsyncs_total.inc(labels=self.metric_labels)
        except Exception:  # noqa: BLE001 — accounting never fails a write
            pass

    def close(self) -> None:
        try:
            self._f.flush()
            if self.fsync_policy != "off":
                self.sync()
        finally:
            self._f.close()


def _snapshot_paths(data_dir: str) -> List[str]:
    return sorted(glob.glob(os.path.join(data_dir, "snapshot-*.ckpt")))


def _segment_paths(data_dir: str) -> List[str]:
    return sorted(glob.glob(os.path.join(data_dir, "wal-*.log")))


def _start_rv(path: str) -> int:
    base = os.path.basename(path)
    return int(base.split("-", 1)[1].split(".", 1)[0])


def write_snapshot(data_dir: str, state: dict,
                   metric_labels: Optional[Dict[str, str]] = None) -> str:
    """Atomically persist one snapshot blob: tmp file, fsync, rename,
    fsync the directory — a crash at any point leaves either the old
    snapshot set or the old set plus one complete new snapshot."""
    rv = int(state["rv"])
    raw = json.dumps(state, separators=(",", ":")).encode()
    path = os.path.join(data_dir, f"snapshot-{rv:016d}.ckpt")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_frame(raw))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(data_dir)
    try:
        from ..metrics import metrics
        metrics.store_wal_snapshots_total.inc(labels=metric_labels)
        metrics.store_wal_snapshot_bytes.set(os.path.getsize(path),
                                             labels=metric_labels)
        metrics.store_wal_snapshot_timestamp.set(time.time(),
                                                 labels=metric_labels)
    except Exception:  # noqa: BLE001
        pass
    return path


def load_snapshot(path: str) -> Optional[dict]:
    """The snapshot's state dict, or None when the blob is torn/corrupt
    (recovery then falls back to the previous snapshot)."""
    frames, _, torn = read_frames(path)
    if torn or not frames:
        return None
    return frames[0]


def _fsync_dir(data_dir: str) -> None:
    try:
        fd = os.open(data_dir, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class DurableClusterStore(ClusterStore):
    """See module docstring. Drop-in for ``ClusterStore`` behind
    ``--store-data-dir``; construction IS recovery (an empty directory
    recovers to an empty store)."""

    #: this store can feed a replica: it exposes the ship interface
    #: (ship_floor / add_ship_listener / newest_snapshot_state). The
    #: replica mirror sets the same flag — a replica can re-serve its
    #: applied stream to a deeper replica (client/replica.py)
    ship_capable = True

    def __init__(self, data_dir: str, fsync: str = "every",
                 fsync_interval_s: float = 0.05,
                 snapshot_every: int = SNAPSHOT_EVERY_RECORDS,
                 keep_snapshots: int = KEEP_SNAPSHOTS,
                 tail_capacity: int = TAIL_CAPACITY,
                 shard: Optional[str] = None):
        super().__init__()
        self.data_dir = data_dir
        # shard name of a sharded member (client/sharded.py): labels the
        # volcano_store_wal_* metric family so per-shard WAL lineages
        # separate; None (the unsharded store) keeps the exposition
        # byte-identical to before
        self.shard = shard
        self.metric_labels = {"shard": shard} if shard is not None else None
        self.fsync_policy = fsync
        self.fsync_interval_s = fsync_interval_s
        self.snapshot_every = int(snapshot_every)
        self.keep_snapshots = max(1, int(keep_snapshots))
        self.tail_capacity = int(tail_capacity)
        os.makedirs(data_dir, exist_ok=True)
        #: per kind: [(rv, event, obj, old)] replayed from the WAL tail,
        #: bounded; the EventJournal seeds its resume window from these
        self.recovery_tail: Dict[str, Deque] = {}
        #: per kind: rv at/below which recovered events are NOT
        #: replayable (the snapshot's per-kind event rv, advanced when
        #: the bounded tail drops its oldest entry)
        self.recovery_floors: Dict[str, int] = {}
        self.recovered_records = 0
        self.recovered_snapshot_rv = 0
        self.snapshot_fallbacks = 0
        self.recovery_ms = 0.0
        self._fence_ctx: Optional[dict] = None
        self._batch_depth = 0
        self._records_since_snapshot = 0
        self._wal: Optional[WriteAheadLog] = None  # None during recovery
        #: WAL-shipping hooks (client/replica.py): called with each
        #: committed record dict, under the store lock, AFTER the append
        #: — a ship stream's live tail sees exactly the records the WAL
        #: holds, in commit order
        self._ship_listeners: list = []
        self._recover()
        self._wal = self._open_segment()
        try:
            from ..metrics import metrics
            metrics.store_wal_recovery_ms.set(self.recovery_ms,
                                              labels=self.metric_labels)
            metrics.store_wal_recovery_records.set(
                self.recovered_records, labels=self.metric_labels)
        except Exception:  # noqa: BLE001
            pass

    # -- recovery -----------------------------------------------------------

    def _recover(self) -> None:
        t0 = time.perf_counter()
        snap_rv = 0
        kind_rv_floor: Dict[str, int] = {}
        for path in reversed(_snapshot_paths(self.data_dir)):
            state = load_snapshot(path)
            if state is None:
                log.error("store snapshot %s is corrupt; falling back to "
                          "the previous snapshot + full WAL replay", path)
                self.snapshot_fallbacks += 1
                continue
            for kind, objs in state["buckets"].items():
                bucket = self._buckets.setdefault(kind, {})
                for eobj in objs:
                    obj = decode(eobj)
                    bucket[self._obj_key(obj)] = obj
            self._rv = int(state["rv"])
            for kind, rv in state["kind_rv"].items():
                self._kind_rv[kind] = int(rv)
            snap_rv = self._rv
            kind_rv_floor = {k: int(v)
                             for k, v in state["kind_rv"].items()}
            self.recovered_snapshot_rv = snap_rv
            break
        segments = _segment_paths(self.data_dir)
        for path in segments:
            records, valid_bytes, torn = read_frames(path)
            for rec in records:
                rv = int(rec["rv"])
                if rv <= snap_rv:
                    continue  # already in the snapshot
                self._apply_recovered(rec, rv, kind_rv_floor)
            if torn:
                if path == segments[-1]:
                    # a crash mid-append left a torn record: everything
                    # before it committed, everything from it on never
                    # acked — cut it off so the next append starts on a
                    # clean frame boundary
                    log.warning("truncating torn WAL tail in %s at byte "
                                "%d", path, valid_bytes)
                    with open(path, "ab") as f:
                        f.truncate(valid_bytes)
                else:
                    # corruption in a CLOSED segment is not crash debris
                    # (rotation fsync'd it whole): keep the file for
                    # forensics, but nothing after it is trustworthy
                    log.error("WAL segment %s is corrupt at byte %d; "
                              "stopping replay there", path, valid_bytes)
                break  # nothing after a torn record is trustworthy
        self.recovery_ms = (time.perf_counter() - t0) * 1e3
        if self.recovered_records or snap_rv:
            log.info("store recovered: rv=%d (%d snapshot, %d WAL "
                     "records replayed) in %.1f ms", self._rv, snap_rv,
                     self.recovered_records, self.recovery_ms)

    def _apply_recovered(self, rec: dict, rv: int,
                         kind_rv_floor: Dict[str, int]) -> None:
        kind, event = rec["kind"], rec["event"]
        obj = decode(rec["obj"])
        bucket = self._buckets.setdefault(kind, {})
        key = self._obj_key(obj)
        old = bucket.get(key)
        if event == "delete":
            bucket.pop(key, None)
        else:
            bucket[key] = obj
        self._rv = max(self._rv, rv)
        self._kind_rv[kind] = rv
        self.recovered_records += 1
        tail = self.recovery_tail.get(kind)
        if tail is None:
            tail = self.recovery_tail[kind] = collections.deque()
            self.recovery_floors[kind] = kind_rv_floor.get(kind, 0)
        if len(tail) >= self.tail_capacity:
            self.recovery_floors[kind] = tail.popleft()[0]
        # update events without a snapshot-era predecessor replay with
        # old=obj — the in-place-update idiom the live stream already
        # exhibits, and the cache's handlers are resync-safe either way
        tail.append((rv, event, obj,
                     old if event == "update" and old is not None
                     else (obj if event == "update" else None)))

    @staticmethod
    def _obj_key(obj: Any) -> str:
        ns = getattr(obj, "namespace", None)
        return f"{ns}/{obj.name}" if ns is not None else obj.name

    # -- journaling seam ----------------------------------------------------

    def create(self, kind: str, obj, fencing: Optional[dict] = None):
        with self._lock:
            self._fence_ctx = fencing
            try:
                return super().create(kind, obj, fencing=fencing)
            finally:
                self._fence_ctx = None

    def update(self, kind: str, obj, fencing: Optional[dict] = None):
        with self._lock:
            self._fence_ctx = fencing
            try:
                return super().update(kind, obj, fencing=fencing)
            finally:
                self._fence_ctx = None

    def delete(self, kind: str, name: str, namespace: Optional[str] = None,
               fencing: Optional[dict] = None):
        with self._lock:
            self._fence_ctx = fencing
            try:
                return super().delete(kind, name, namespace,
                                      fencing=fencing)
            finally:
                self._fence_ctx = None

    def _notify(self, kind: str, event: str, obj, old=None) -> None:
        # runs under the store lock at the commit point: append (and per
        # policy fsync) BEFORE any listener — a watcher must never observe
        # a write that a crash could still lose
        if self._wal is not None:
            t0 = time.perf_counter()
            # ts: commit wall time, so a replica tailing shipped records
            # can report lag in SECONDS, not just records
            rec = {"rv": self._rv, "kind": kind, "event": event,
                   "obj": encode(obj), "ts": round(time.time(), 3)}
            if self._fence_ctx:
                rec["fencing"] = self._fence_ctx
            self._wal.append(rec, sync=self._batch_depth == 0)
            try:
                from ..metrics import metrics
                metrics.store_wal_appends_total.inc(
                    labels=self.metric_labels)
                metrics.store_wal_append_seconds.observe(
                    time.perf_counter() - t0, labels=self.metric_labels)
                metrics.store_wal_size_bytes.set(
                    self._wal.size_bytes, labels=self.metric_labels)
            except Exception:  # noqa: BLE001
                pass
            faults.fire("store_crash")
            for fn in list(self._ship_listeners):
                fn(rec)
            self._records_since_snapshot += 1
            if self._records_since_snapshot >= self.snapshot_every \
                    and self._batch_depth == 0:
                self.snapshot()
        super()._notify(kind, event, obj, old)

    def _batch_begin(self) -> None:
        self._batch_depth += 1

    def _batch_end(self, sync: bool = True) -> None:
        self._batch_depth -= 1
        if self._batch_depth == 0 and self._wal is not None:
            if sync:
                self._wal.maybe_sync()  # ONE fsync for the whole batch
            # sync=False: the sharded store owns the fsync — it runs one
            # batch per touched shard and syncs every touched WAL in
            # parallel afterwards (client/sharded.py _sync_shards)
            if self._records_since_snapshot >= self.snapshot_every:
                self.snapshot()

    # -- compaction ---------------------------------------------------------

    def snapshot(self) -> str:
        """Compact: persist the full store state as one snapshot, rotate
        the WAL onto a fresh segment, prune snapshots/segments the
        retained set no longer needs. Runs inline under the store lock
        every ``snapshot_every`` records, or on demand."""
        with self._lock:
            state = {
                "rv": self._rv,
                "kind_rv": dict(self._kind_rv),
                "buckets": {k: [encode(o) for o in b.values()]
                            for k, b in self._buckets.items()},
            }
            path = write_snapshot(self.data_dir, state,
                                  metric_labels=self.metric_labels)
            if self._wal is not None:
                self._wal.close()
                self._wal = self._open_segment()
            self._records_since_snapshot = 0
            self._prune()
            return path

    def _open_segment(self) -> WriteAheadLog:
        return WriteAheadLog(
            os.path.join(self.data_dir, f"wal-{self._rv:016d}.log"),
            fsync=self.fsync_policy,
            fsync_interval_s=self.fsync_interval_s,
            metric_labels=self.metric_labels)

    def _prune(self) -> None:
        snaps = _snapshot_paths(self.data_dir)
        keep = snaps[-self.keep_snapshots:]
        for path in snaps[:-self.keep_snapshots]:
            try:
                os.unlink(path)
            except OSError:
                pass
        if len(keep) < self.keep_snapshots:
            # no fallback snapshot yet: every segment must stay, or a
            # corrupt newest snapshot would have nothing to replay from
            return
        oldest_kept_rv = _start_rv(keep[0])
        # a segment is deletable when the NEXT segment's start rv (== the
        # last rv this one can contain; segments rotate at snapshots) is
        # covered by the oldest retained snapshot
        segments = _segment_paths(self.data_dir)
        for path, nxt in zip(segments, segments[1:]):
            if _start_rv(nxt) <= oldest_kept_rv:
                try:
                    os.unlink(path)
                except OSError:
                    pass

    def close(self) -> None:
        """Flush and fsync the WAL (clean shutdown; crash recovery does
        not depend on this running)."""
        with self._lock:
            if self._wal is not None:
                self._wal.close()
                self._wal = None

    # -- WAL shipping (read replicas, client/replica.py) --------------------

    def add_ship_listener(self, fn) -> None:
        """Subscribe to committed WAL records (called under the store
        lock with the record dict, after the append). The ship stream's
        live-tail seam."""
        with self._lock:
            self._ship_listeners.append(fn)

    def remove_ship_listener(self, fn) -> None:
        with self._lock:
            try:
                self._ship_listeners.remove(fn)
            except ValueError:
                pass

    def ship_floor(self) -> int:
        """Oldest rv a ship stream can resume AFTER: records at rv <=
        this are no longer in retained WAL segments (pruned into
        snapshots), so a replica whose applied rv fell below it has a
        HOLE it must close with a fresh snapshot bootstrap, never by
        skipping. Call under the store lock to pair it with ``_rv``."""
        segments = _segment_paths(self.data_dir)
        return _start_rv(segments[0]) if segments else self._rv

    def newest_snapshot_state(self) -> Tuple[int, Optional[dict]]:
        """The newest VALID on-disk snapshot as ``(rv, state)`` — the
        replica bootstrap payload. A corrupt newest snapshot falls back
        to the previous (same rule recovery applies); no valid snapshot
        means ``(0, None)``: the replica starts empty and the WAL (still
        fully retained — pruning requires snapshots) replays history."""
        for path in reversed(_snapshot_paths(self.data_dir)):
            state = load_snapshot(path)
            if state is not None:
                return int(state["rv"]), state
        return 0, None

    # -- introspection ------------------------------------------------------

    @property
    def wal(self) -> Optional[WriteAheadLog]:
        return self._wal
