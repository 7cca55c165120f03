"""Sharded cluster store: the partitioned front door.

Without it everything upstream of the solver funnels through ONE
single-process ClusterStore behind ONE TCP socket with ONE global
EventJournal — million-pod churn serialized before the solver ever
runs. The reference system scales exactly this layer with sharded
controller workers and a 16-worker fan-out. This module is that
partition, the JAX package's byte for byte on the wire and on disk:
either package's router, worker and client talk to the other's, and
either recovers a ``shard-NNN`` data dir the other wrote.

``ShardedClusterStore`` splits the object space across N member stores
by deterministic ``(kind, namespace/name)`` hash routing (crc32 — the
same object lands on the same shard across restarts, which is what lets
each shard own its own durable lineage). Each shard owns its own lock,
its own resource_version sequence, its own watch-resume journal window
(served per shard by the router), and — when a data dir is set — its
own ``DurableClusterStore`` WAL + snapshot lineage in
``data_dir/shard-NNN/``, recovered independently: a shard replays only
its own WAL.

Concurrency model: a single top-level mutation mutex (``locked()``)
serializes commits end-to-end, exactly like the plain store's one lock —
in-process consumers (scheduler cache, controllers) keep the
delivered-under-the-lock, never-concurrent listener contract, and
fencing checks stay atomic with the writes they guard. The sharding
win is everything AROUND that mutex: reads take only the owning shard's
lock (a list of nodes doesn't wait out a pod wave's fsync), bulk waves
fsync every touched shard's WAL in PARALLEL (fsync releases the GIL —
N shards cost one fsync's wall time), the wire layer decodes/encodes
outside it, and watch delivery batches per frame (``bulk_watch``).

``ShardRouter`` serves a ShardedClusterStore over the EXISTING wire
protocol on one endpoint — ``RemoteClusterStore`` callers are
unchanged. Events carry a ``shard`` tag and the shard's own rv; resume
high-water marks generalize from ``{kind: rv}`` to
``{kind: {shard: rv}}`` (the single store's ``since:`` machinery,
per shard). The ``bulk_watch`` op subscribes many kinds on one stream and
coalesces events into batched frames.

Fencing: the ``leases`` kind is PINNED to shard 0, and every member
shard delegates fence validation there (``_fence_arbiter``,
client/store.py) — lease arbitration stays a single-writer concern
while the fenced objects themselves spread across shards.

Fault points: ``shard_request`` fires per routed wire request in the
router (armed, it kills that connection the way a dropped shard link
would — the client's retry rules engage); ``shard_crash`` fires at the
sharded store's commit seam, once per mutation / per touched shard in a
bulk wave (arm ``exc:exit`` in a store subprocess to SIGKILL it with
some shards' sub-batches durable and others not — recovery must heal
every lineage). For in-process chaos, ``crash_shard(i)`` /
``recover_shard(i)`` kill exactly one shard: its ops raise
``ShardUnavailableError`` (in a bulk wave, only that shard's items fail)
while the other shards keep serving; recovery replays the shard's own
WAL and re-attaches every watcher.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import queue
import threading
import zlib
from typing import Any, Callable, Dict, List, Optional

from ..resilience.faultinject import faults
from .codec import encode
from .durable import DurableClusterStore
from .server import (
    WATCH_BATCH_MAX, WATCH_QUEUE_MAX, WATCH_SEND_TIMEOUT_S, DeltaEncoder,
    EventJournal, StoreServer, _Handler, pump_watch, send_frame,
)
from .store import (
    KINDS, ClusterStore, ShardUnavailableError, _key,
)

log = logging.getLogger(__name__)

#: kinds routed to shard 0 regardless of name: the lease bucket is the
#: fencing arbiter (every shard validates tokens against it), so it must
#: live in exactly one place
PINNED_KINDS = frozenset({"leases"})


def shard_for(kind: str, key: str, n_shards: int) -> int:
    """Deterministic routing: crc32 of ``kind/key`` mod N. Stable across
    processes and restarts (unlike ``hash()``, which is salted) — the
    property that lets each shard own a durable WAL lineage."""
    if n_shards <= 1 or kind in PINNED_KINDS:
        return 0
    return zlib.crc32(f"{kind}/{key}".encode()) % n_shards


class ShardedClusterStore:
    """See module docstring. Presents the full ClusterStore surface
    (create/update/apply/delete/get/try_get/list/watch/bulk_apply/
    locked/add_interceptor), so FencedStore, the webhook chain, the
    scheduler cache, the controllers and the wire dispatch all work
    against it unchanged."""

    def __init__(self, n_shards: int, data_dir: Optional[str] = None,
                 fsync: str = "every", fsync_interval_s: float = 0.05,
                 snapshot_every: int = 4096, keep_snapshots: int = 2):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.n_shards = int(n_shards)
        self.data_dir = data_dir
        self.fsync_policy = fsync
        self.fsync_interval_s = fsync_interval_s
        self.snapshot_every = snapshot_every
        self.keep_snapshots = keep_snapshots
        # top-level mutation mutex: commits (route -> shard commit ->
        # listener delivery) serialize here, preserving the plain store's
        # atomic-write / serial-listener contract; locked() hands it to
        # consumers needing a frozen multi-read view
        self._mu = threading.RLock()
        self._interceptors: List[Callable] = []
        #: consumer/watch registry, so crash_shard/recover_shard can
        #: re-attach every subscription to a rebuilt shard:
        #: {"kind", "fn", "sharded", "wrapped": {shard_idx: wrapped_fn}}
        self._watchers: List[dict] = []
        self.shards: List[ClusterStore] = [
            self._make_shard(i) for i in range(self.n_shards)]
        self._down = [False] * self.n_shards
        self._rewire_arbiters()
        #: set by the ShardRouter: called (idx, new_shard) after a shard
        #: recovery so the router rebuilds that shard's resume journal
        self.on_shard_recovered: Optional[Callable[[int, Any], None]] = None

    # -- construction -------------------------------------------------------

    def _make_shard(self, i: int) -> ClusterStore:
        if self.data_dir:
            return DurableClusterStore(
                os.path.join(self.data_dir, f"shard-{i:03d}"),
                fsync=self.fsync_policy,
                fsync_interval_s=self.fsync_interval_s,
                snapshot_every=self.snapshot_every,
                keep_snapshots=self.keep_snapshots,
                shard=str(i))
        return ClusterStore()

    def _rewire_arbiters(self) -> None:
        for i, s in enumerate(self.shards):
            s._fence_arbiter = self.shards[0] if i != 0 else None

    # -- routing ------------------------------------------------------------

    def shard_of(self, kind: str, key: str) -> int:
        return shard_for(kind, key, self.n_shards)

    def _shard(self, idx: int) -> ClusterStore:
        if self._down[idx]:
            raise ShardUnavailableError(
                f"store shard {idx} is down (crashed, not yet recovered)")
        return self.shards[idx]

    def _route(self, kind: str, key: str) -> ClusterStore:
        return self._shard(self.shard_of(kind, key))

    # -- locking / clock ----------------------------------------------------

    def locked(self):
        """The top-level mutation mutex: holding it guarantees no write
        commits anywhere (any shard) — the consistent multi-read seam
        the scheduler cache's snapshot needs."""
        return self._mu

    @property
    def clock(self):
        return self.shards[0].clock

    @clock.setter
    def clock(self, fn) -> None:
        # fencing arbitration clock (HA tests drive lease expiry): the
        # arbiter is shard 0, but keep every shard consistent
        for s in self.shards:
            s.clock = fn

    def last_event_rv(self, kind: str) -> int:
        return max(s.last_event_rv(kind) for s in self.shards)

    # -- admission ----------------------------------------------------------

    def add_interceptor(self, fn) -> None:
        with self._mu:
            self._interceptors.append(fn)
            for s in self.shards:
                s.add_interceptor(fn)

    # -- watch --------------------------------------------------------------

    def watch(self, kind: str, listener, replay: bool = True) -> None:
        """Subscribe to a kind on EVERY shard (replay in shard order,
        deterministic). Delivery runs under the mutation mutex, so a
        consumer listener is never invoked concurrently — the in-memory
        store's contract, preserved."""
        with self._mu:
            entry = {"kind": kind, "fn": listener, "sharded": False,
                     "wrapped": {}}
            self._watchers.append(entry)
            for i, s in enumerate(self.shards):
                if self._down[i]:
                    continue  # re-attached by recover_shard
                entry["wrapped"][i] = listener
                s.watch(kind, listener, replay=replay)

    def watch_sharded(self, kind: str, fn, replay: bool = True) -> None:
        """Shard-aware subscription (the router's seam): ``fn(shard_idx,
        rv, event, obj, old)`` with ``rv`` the owning shard's commit
        resource_version."""
        with self._mu:
            entry = {"kind": kind, "fn": fn, "sharded": True,
                     "wrapped": {}}
            self._watchers.append(entry)
            for i in range(self.n_shards):
                if self._down[i]:
                    continue
                wrapped = self._wrap_sharded(i, fn)
                entry["wrapped"][i] = wrapped
                self.shards[i].watch(kind, wrapped, replay=replay)

    def _wrap_sharded(self, idx: int, fn):
        shard = self.shards[idx]

        def wrapped(event, obj, old, _i=idx, _s=shard, _fn=fn):
            # runs under the shard lock: _rv is this event's commit rv
            _fn(_i, _s._rv, event, obj, old)
        return wrapped

    def _unwatch(self, kind: str, fn) -> None:
        with self._mu:
            for entry in list(self._watchers):
                if entry["kind"] == kind and entry["fn"] is fn:
                    for i, wrapped in entry["wrapped"].items():
                        self.shards[i].unwatch(kind, wrapped)
                    self._watchers.remove(entry)
                    return

    def unwatch(self, kind: str, listener) -> None:
        self._unwatch(kind, listener)

    def unwatch_sharded(self, kind: str, fn) -> None:
        self._unwatch(kind, fn)

    # -- CRUD ---------------------------------------------------------------

    def create(self, kind: str, obj, fencing: Optional[dict] = None):
        shard = self.shard_of(kind, _key(obj))
        with self._mu:
            faults.fire("shard_crash")
            return self._shard(shard).create(kind, obj, fencing=fencing)

    def update(self, kind: str, obj, fencing: Optional[dict] = None):
        shard = self.shard_of(kind, _key(obj))
        with self._mu:
            faults.fire("shard_crash")
            return self._shard(shard).update(kind, obj, fencing=fencing)

    def apply(self, kind: str, obj, fencing: Optional[dict] = None):
        shard = self.shard_of(kind, _key(obj))
        with self._mu:
            faults.fire("shard_crash")
            return self._shard(shard).apply(kind, obj, fencing=fencing)

    def delete(self, kind: str, name: str, namespace: Optional[str] = None,
               fencing: Optional[dict] = None):
        key = f"{namespace}/{name}" if namespace is not None else name
        shard = self.shard_of(kind, key)
        with self._mu:
            faults.fire("shard_crash")
            return self._shard(shard).delete(kind, name, namespace,
                                             fencing=fencing)

    def get(self, kind: str, name: str, namespace: Optional[str] = None):
        key = f"{namespace}/{name}" if namespace is not None else name
        return self._route(kind, key).get(kind, name, namespace)

    def try_get(self, kind: str, name: str, namespace: Optional[str] = None):
        from .store import NotFoundError
        try:
            return self.get(kind, name, namespace)
        except NotFoundError:
            return None

    def list(self, kind: str, namespace: Optional[str] = None,
             label_selector: Optional[Dict[str, str]] = None,
             name_glob: Optional[str] = None) -> List[Any]:
        out: List[Any] = []
        for i in range(self.n_shards):
            # a partial list during a shard outage would silently hide
            # that shard's objects from the scheduler — fail honestly
            out.extend(self._shard(i).list(kind, namespace, label_selector,
                                           name_glob))
        return out

    def bulk_apply(self, items, fencing: Optional[dict] = None) -> List[Any]:
        """Partitioned batch: items group per owning shard, each shard
        commits its sub-batch as ONE journal batch under the mutation
        mutex, and every touched durable WAL fsyncs in PARALLEL at the
        end (one fsync's wall time for N shards). Per-item containment
        is preserved — and extends to availability: a DOWN shard's items
        carry ShardUnavailableError while the other shards' items
        commit. Results reassemble in submission order."""
        items = list(items)
        results: List[Any] = [None] * len(items)
        by_shard: Dict[int, List] = collections.defaultdict(list)
        for idx, item in enumerate(items):
            try:
                by_shard[self.shard_of(item[0], _key(item[1]))].append(
                    (idx, item))
            except Exception as e:  # noqa: BLE001 — per-item containment
                results[idx] = e
        with self._mu:
            touched = []
            for shard_idx in sorted(by_shard):
                sub = by_shard[shard_idx]
                try:
                    shard = self._shard(shard_idx)
                    faults.fire("shard_crash")
                except Exception as e:  # noqa: BLE001 — shard down: its
                    for idx, _ in sub:   # items fail, the wave survives
                        results[idx] = e
                    continue
                res = shard.bulk_apply([it for _, it in sub],
                                       fencing=fencing, _sync=False)
                for (idx, _), r in zip(sub, res):
                    results[idx] = r
                touched.append(shard)
            self._sync_shards(touched)
        return results

    def _sync_shards(self, shards: List[ClusterStore]) -> None:
        """fsync every touched shard's WAL, in parallel when there is
        more than one (os.fsync releases the GIL, so N WALs on N files
        cost roughly one fsync of wall time)."""
        walled = [s for s in shards if getattr(s, "wal", None) is not None]
        if not walled:
            return
        if len(walled) == 1:
            walled[0].wal.maybe_sync()
            return
        errors: List[BaseException] = []

        def sync_one(s):
            try:
                s.wal.maybe_sync()
            except BaseException as e:  # noqa: BLE001 — surfaced below
                errors.append(e)

        threads = [threading.Thread(target=sync_one, args=(s,),
                                    name=f"shard-fsync-{i}")
                   for i, s in enumerate(walled)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]

    # -- durability ---------------------------------------------------------

    @property
    def recovered_records(self) -> int:
        return sum(getattr(s, "recovered_records", 0) for s in self.shards)

    @property
    def recovery_ms(self) -> float:
        return sum(getattr(s, "recovery_ms", 0.0) for s in self.shards)

    @property
    def _rv(self) -> int:
        # informational only (READY banners, introspection): the shards
        # own their real rv sequences
        return max(s._rv for s in self.shards)

    def snapshot(self) -> List[str]:
        with self._mu:
            return [s.snapshot() for s in self.shards
                    if hasattr(s, "snapshot")]

    def close(self) -> None:
        with self._mu:
            for i, s in enumerate(self.shards):
                if self._down[i]:
                    continue
                close = getattr(s, "close", None)
                if close is not None:
                    close()

    # -- single-shard chaos -------------------------------------------------

    def crash_shard(self, idx: int) -> None:
        """Kill one shard the way SIGKILL would: drop its in-memory
        state, abandon its WAL fd without fsync (appends were flushed to
        the OS per record, so process-kill durability semantics hold),
        and refuse its ops until recover_shard. The other shards keep
        serving."""
        with self._mu:
            if self._down[idx]:
                return
            shard = self.shards[idx]
            wal = getattr(shard, "wal", None)
            if wal is not None:
                try:
                    wal._f.close()  # raw close: no clean-shutdown fsync
                except OSError:
                    pass
                shard._wal = None
            self._down[idx] = True
            log.warning("store shard %d crashed (simulated)", idx)

    def recover_shard(self, idx: int) -> ClusterStore:
        """Rebuild a crashed shard: construction IS recovery (its own
        snapshot + WAL tail replay; in-memory shards recover empty),
        interceptors and every registered watcher re-attach, the fence
        arbiter re-wires, and the router (if any) is told to rebuild the
        shard's resume journal from the recovered tail."""
        with self._mu:
            if not self._down[idx]:
                return self.shards[idx]
            new = self._make_shard(idx)
            for fn in self._interceptors:
                new.add_interceptor(fn)
            self.shards[idx] = new
            self._rewire_arbiters()
            for entry in self._watchers:
                wrapped = (self._wrap_sharded(idx, entry["fn"])
                           if entry["sharded"] else entry["fn"])
                entry["wrapped"][idx] = wrapped
                # replay=False: everything recovered was observed before
                # the crash, and nothing committed while the shard was
                # down (its ops refused)
                new.watch(entry["kind"], wrapped, replay=False)
            self._down[idx] = False
            if self.on_shard_recovered is not None:
                self.on_shard_recovered(idx, new)
            log.info("store shard %d recovered (%d records replayed)",
                     idx, getattr(new, "recovered_records", 0))
            return new


# -- per-shard observability -------------------------------------------------


class _MeteredJournal(EventJournal):
    """EventJournal that accounts its shard's committed events and
    resume-window span (volcano_store_shard_* family)."""

    def __init__(self, store: ClusterStore, shard_label: str):
        self._labels = {"shard": shard_label}
        self._n_events = 0
        super().__init__(store)

    def _make_listener(self, kind: str):
        inner = super()._make_listener(kind)

        def listener(event, obj, old):
            inner(event, obj, old)
            self._n_events += 1
            try:
                from ..metrics import metrics
                metrics.store_shard_events_total.inc(labels=self._labels)
                if self._n_events % 64 == 0:
                    with self._lock:
                        span = sum(len(q) for q in self._events.values())
                    metrics.store_shard_journal_window.set(
                        span, labels=self._labels)
            except Exception:  # noqa: BLE001 — accounting only
                pass
        return listener


class _ShardJournals:
    """One resume journal per shard (each seeded from ITS shard's
    recovered WAL tail), plus per-shard watch-queue accounting shared by
    every stream the router serves."""

    def __init__(self, store: ShardedClusterStore):
        self.store = store
        self.journals = [_MeteredJournal(s, str(i))
                         for i, s in enumerate(store.shards)]
        self._lock = threading.Lock()
        self._pending = [0] * store.n_shards

    def since(self, shard_idx: int, kind: str, rv: int):
        return self.journals[shard_idx].since(kind, rv)

    def rebuild(self, idx: int, new_shard: ClusterStore) -> None:
        self.journals[idx].close()
        self.journals[idx] = _MeteredJournal(new_shard, str(idx))

    def close(self) -> None:
        for j in self.journals:
            j.close()

    # pending watch-queue depth, per shard, across all live streams.
    # The int bookkeeping is exact (drop accounting depends on it); the
    # GAUGE is sampled every 64th enqueue — label-key formatting per
    # event was measurable at tens of thousands of events/sec

    def _set_depth(self, idx: int) -> None:
        try:
            from ..metrics import metrics
            metrics.store_shard_watch_queue_depth.set(
                self._pending[idx], labels={"shard": str(idx)})
        except Exception:  # noqa: BLE001
            pass

    def enqueued(self, idx: int) -> None:
        with self._lock:
            self._pending[idx] += 1
            sample = self._pending[idx] % 64 == 0
        if sample:
            self._set_depth(idx)

    def sent(self, shard_idxs) -> None:
        counts = collections.Counter(shard_idxs)
        with self._lock:
            for idx, n in counts.items():
                self._pending[idx] = max(0, self._pending[idx] - n)
        for idx in counts:
            self._set_depth(idx)

    def dropped(self, counts: Dict[int, int]) -> None:
        try:
            from ..metrics import metrics
            for idx, n in counts.items():
                metrics.store_shard_dropped_total.inc(
                    n, labels={"shard": str(idx)})
        except Exception:  # noqa: BLE001
            pass
        self.sent(idx for idx, n in counts.items() for _ in range(n))


# -- the router --------------------------------------------------------------


class _WatchHub:
    """Encode once, fan out to every stream. A committed event used to
    be encoded per watch stream; with a scheduler cache, a controller
    manager and operator mirrors attached, that multiplied the commit
    path's encode cost by the watcher count. The hub subscribes ONE
    shard-aware listener per kind, encodes the event exactly once, and
    hands the same payload dict to every subscribed stream queue — the
    commit path is O(1) encodes + one queue append per stream, and zero
    encodes when nobody watches the kind."""

    def __init__(self, store: ShardedClusterStore):
        self.store = store
        #: per kind: [(enqueue, delta), ...] — one row per watch stream
        self._subs: Dict[str, List] = {k: [] for k in KINDS}
        self._attached: set = set()
        # one delta encoder per member shard, created eagerly: each owns
        # that shard's interning table + per-kind frame counters, mutated
        # only under the shard's commit notify (so no extra lock), and a
        # delta stream's synced snapshot covers every shard even before
        # the first event flows
        self.delta_encs = [DeltaEncoder() for _ in range(store.n_shards)]

    def subscribe(self, kind: str, enqueue, delta: bool = False) -> None:
        # caller holds store.locked(): the subscription is atomic with
        # the replay it just enqueued
        if kind not in self._attached:
            self._attached.add(kind)
            self.store.watch_sharded(kind, self._fan(kind), replay=False)
        self._subs[kind].append((enqueue, delta))

    def unsubscribe(self, kind: str, enqueue) -> None:
        self._subs[kind] = [s for s in self._subs[kind]
                            if s[0] is not enqueue]

    def synced_fields(self, kinds) -> dict:
        """The delta half of a stream's ``synced`` frame: per-kind,
        per-shard table snapshots + per-kind/per-shard ks baselines.
        Caller holds ``store.locked()`` so they are atomic with the
        subscription."""
        vtab: Dict[str, dict] = {}
        ks: Dict[str, Dict[str, int]] = {k: {} for k in kinds}
        for idx, enc in enumerate(self.delta_encs):
            for k in kinds:
                it = enc.interners.get(k)
                if it is not None:
                    vtab.setdefault(k, {})[str(idx)] = it.snapshot()
                ks[k][str(idx)] = enc.ks.get(k, 0)
        return {"delta": True, "vtab": vtab, "ks": ks}

    def _fan(self, kind: str):
        def fn(shard, rv, event, obj, old):
            subs = self._subs[kind]
            if not subs:
                return  # zero watchers: zero encodes
            obj_subs = [s[0] for s in subs if not s[1]]
            delta_subs = [s[0] for s in subs if s[1]]
            if obj_subs:
                payload = {"stream": "event", "kind": kind, "shard": shard,
                           "rv": rv, "event": event, "obj": encode(obj),
                           "old": encode(old) if old is not None else None}
                # serialize ONCE: every stream ships these same bytes
                # (pump_watch), so an extra watcher costs a queue append
                # and a socket write, not another encode+dumps
                payload["_raw"] = json.dumps(payload,
                                             separators=(",", ":"))
                for enq in obj_subs:
                    enq(payload)
            if delta_subs:
                dp = self.delta_encs[shard].payload(
                    kind, shard, rv, event, obj, old)
                try:
                    faults.fire("delta_frame")
                except Exception:  # noqa: BLE001 — injected drop
                    # the frame's ks was consumed but it never ships:
                    # every delta stream sees the gap and falls back
                    return
                for enq in delta_subs:
                    enq(dp)
                try:
                    faults.fire("delta_frame_dup")
                except Exception:  # noqa: BLE001 — injected dup
                    for enq in delta_subs:
                        enq(dp)  # same ks twice: typed refusal
        return fn


class _RouterHandler(_Handler):
    """The StoreServer wire protocol over a ShardedClusterStore: CRUD
    dispatch is inherited unchanged (the sharded store presents the same
    surface); watch serving is shard-aware — events carry a ``shard``
    tag and the owning shard's rv, resumes take ``{kind: {shard: rv}}``
    maps against the per-shard journals, and ``bulk_watch`` batches
    events per frame."""

    def _dispatch(self, store, op: str, req: dict) -> dict:
        # armed shard_request faults are ConnectionError-shaped: they
        # propagate out of handle()'s request loop and kill this
        # connection the way a dropped shard link would, so the client's
        # transport-retry rules (not its error handling) engage
        faults.fire("shard_request")
        return _Handler._dispatch(self, store, op, req)

    def _serve_watch(self, sock, store: ShardedClusterStore,
                     req: dict) -> None:
        kinds = req.get("kinds") or [req.get("kind")]
        bad = [k for k in kinds if k not in KINDS]
        if bad:
            send_frame(sock, {"ok": False, "error": "RuntimeError",
                              "message": f"unknown watch kinds {bad}"})
            return
        replay = bool(req.get("replay", True))
        since = req.get("since") or None
        batch_max = WATCH_BATCH_MAX if req.get("op") == "bulk_watch" else 1
        journals: _ShardJournals = self.server.journal  # type: ignore
        events: "queue.Queue" = queue.Queue(maxsize=WATCH_QUEUE_MAX)
        overflowed = threading.Event()
        sock.settimeout(WATCH_SEND_TIMEOUT_S)

        def enqueue(payload) -> None:
            if overflowed.is_set():
                return
            try:
                events.put_nowait(payload)
            except queue.Full:
                overflowed.set()
                return
            shard = payload.get("shard")
            if shard is not None:
                journals.enqueued(shard)

        def on_sent(batch) -> None:
            journals.sent(p["shard"] for p in batch)

        def drop_pending() -> None:
            # the stream is condemned: whatever is still queued will
            # never reach the watcher — account it per shard
            counts: Dict[int, int] = collections.Counter()
            while True:
                try:
                    p = events.get_nowait()
                except queue.Empty:
                    break
                if p.get("shard") is not None:
                    counts[p["shard"]] += 1
            journals.dropped(counts)

        hub: _WatchHub = self.server.hub  # type: ignore[attr-defined]
        # delta negotiation (fail-safe: object frames unless asked).
        # Replay adds below bypass the hub and stay object frames; only
        # live hub events ship delta-form with ks stamps
        delta = bool(req.get("delta"))
        hooked = []
        try:
            gap = None  # (kind, message)
            with store.locked():
                if since is not None:
                    for kind in kinds:
                        smap = since.get(kind)
                        if not isinstance(smap, dict):
                            # a scalar mark names one rv sequence; only
                            # a 1-shard store has exactly one
                            if store.n_shards == 1:
                                smap = {"0": smap}
                            else:
                                gap = (kind, "scalar resume mark against "
                                             f"{store.n_shards} shards")
                                break
                        for idx in range(store.n_shards):
                            rv = smap.get(str(idx))
                            rv = int(rv) if rv is not None else -1
                            missed = journals.since(idx, kind, rv)
                            if missed is None:
                                gap = (kind, f"shard {idx} window no "
                                             f"longer covers rv {rv}")
                                break
                            for erv, event, obj, old in missed:
                                enqueue({"stream": "event", "kind": kind,
                                         "shard": idx, "rv": erv,
                                         "event": event,
                                         "obj": encode(obj),
                                         "old": encode(old)
                                         if old is not None else None})
                        if gap is not None:
                            break
                if gap is None:
                    for kind in kinds:
                        if replay and since is None:
                            # list-then-watch: current objects as adds,
                            # shard by shard (the same order the
                            # in-process replay delivers)
                            for idx in range(store.n_shards):
                                if store._down[idx]:
                                    continue
                                sh = store.shards[idx]
                                rv = sh._rv
                                for obj in list(
                                        sh._buckets[kind].values()):
                                    enqueue({"stream": "event",
                                             "kind": kind, "shard": idx,
                                             "rv": rv, "event": "add",
                                             "obj": encode(obj),
                                             "old": None})
                        hub.subscribe(kind, enqueue, delta=delta)
                        hooked.append(kind)
                    sync_payload = {"stream": "synced", "rv": {
                        k: {str(i): store.shards[i].last_event_rv(k)
                            for i in range(store.n_shards)}
                        for k in kinds}}
                    if delta:
                        sync_payload.update(hub.synced_fields(kinds))
                    enqueue(sync_payload)
            if gap is not None:
                send_frame(sock, {
                    "ok": False, "error": "ResumeGapError",
                    "message": f"resume window for {gap[0]!r}: {gap[1]}"})
                return
            pump_watch(sock, events, overflowed, batch_max=batch_max,
                       on_sent=on_sent)
            log.warning("sharded watch stream overflowed %d events; "
                        "dropping the slow watcher", WATCH_QUEUE_MAX)
            self._count_drop()
            drop_pending()
        except OSError as e:
            import socket as _socket
            if isinstance(e, _socket.timeout):
                log.warning("sharded watch send stalled > %.0fs; dropping "
                            "the slow watcher", WATCH_SEND_TIMEOUT_S)
                self._count_drop()
            drop_pending()
        except ValueError:
            drop_pending()
        finally:
            for kind in hooked:
                hub.unsubscribe(kind, enqueue)

    @staticmethod
    def _count_drop() -> None:
        try:
            from ..metrics import metrics
            metrics.store_watch_dropped_total.inc()
        except Exception:  # noqa: BLE001 — accounting only
            pass


class ShardRouter(StoreServer):
    """A StoreServer whose backend is a ShardedClusterStore: one
    endpoint, the existing wire protocol, N shards behind it. Watchers
    get per-shard resume journals (each seeded from its shard's
    recovered WAL tail after a restart); a recovered shard's journal is
    rebuilt in place so live streams keep resuming."""

    handler_class = _RouterHandler

    def __init__(self, store: ShardedClusterStore, host: str = "127.0.0.1",
                 port: int = 0, token: Optional[str] = None,
                 tls_cert: Optional[str] = None,
                 tls_key: Optional[str] = None,
                 tls_client_ca: Optional[str] = None, gate=None):
        super().__init__(store, host=host, port=port, token=token,
                         tls_cert=tls_cert, tls_key=tls_key,
                         tls_client_ca=tls_client_ca, gate=gate)
        # encode-once event fan-out shared by every watch stream
        self.hub = _WatchHub(store)
        self._server.hub = self.hub  # type: ignore[attr-defined]
        store.on_shard_recovered = self._on_shard_recovered

    def _make_journal(self, store):
        return _ShardJournals(store)

    def _on_shard_recovered(self, idx: int, new_shard) -> None:
        self.journal.rebuild(idx, new_shard)
