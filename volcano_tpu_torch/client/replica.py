"""Read replicas: WAL-shipped followers serving the read tier.

Millions of users means the dominant control-plane traffic is reads —
CLI lists, dashboard polls, job-status watches — and without a read
tier every one of them lands on the same process the scheduler writes
through. The reference absorbs that fan-out in the apiserver tier above
etcd; this module is this package's equivalent, assembled from two
pieces: the durable store's totally-ordered, CRC-framed, rv-stamped WAL
(client/durable.py) and the router's encode-once watch fan-out
(client/sharded.py). The ship and bootstrap frames are the JAX
package's: either package's replica tails either package's primary.

``ReplicaStore`` bootstraps from the primary's newest on-disk snapshot
(the ``bootstrap`` wire op), then tails the primary's WAL over the new
``ship`` wire op — sealed segments plus the live tail, streamed as
framed record batches — applying each record to an in-process mirror
store and serving ``list``/``get``/``watch``/``bulk_watch`` over the
UNCHANGED wire protocol. Staleness is explicit, never silent:

- every read response carries ``applied_rv``, the exact primary
  resource_version(s) the answer reflects;
- ``min_rv=`` on list blocks until the replica has applied that rv (or
  fails typed with ``ReplicaLagError`` after ``wait_s``) — the
  read-your-writes bound a client that just wrote to the primary needs;
- mutations (and with them fencing, leases and conditional-write
  arbitration) fail CLOSED with ``ReplicaReadOnlyError``: every write
  belongs to the primary, so scheduler correctness is untouched.

Robustness is the design center, not a footnote:

- WAL record rvs are DENSE per shard (every committed mutation appends
  exactly one record), so ``apply_record`` refuses any record that does
  not extend ``applied_rv`` by exactly one (``ReplicaGapError``) — a
  dropped or duplicated record can never be silently absorbed; the
  tailer answers with a fresh snapshot re-bootstrap, counted in
  ``volcano_replica_bootstraps_total{reason}``.
- A replica crash loses nothing anyone was promised: restart
  re-bootstraps from the newest snapshot and re-tails; watchers resume
  through the normal ``since:`` path against the rebuilt journal (its
  floor is the snapshot's per-kind rv, so marks at or past it resume
  without a resync).
- A primary crash mid-ship leaves the replica at a consistent rv prefix
  (only complete, CRC-clean frames were ever applied); the tailer
  reconnects with backoff and resumes at its applied rv once the
  primary recovers.
- A replica that falls out of the primary's retained-segment window is
  REFUSED by the ship op (``ResumeGapError`` — the same refuse-to-seed
  rule the EventJournal keeps) and degrades to a fresh
  bootstrap instead of skipping events.

Sharded primaries ship per shard: one tailer per member WAL lineage
into a mirrored shard layout, served through the router handler
(events carry shard tags, resume marks stay per-shard maps);
``applied_rv``/``min_rv`` generalize to ``{shard: rv}`` maps.

Fan-out trees: a replica is a composable TIER, not a
leaf. Each mirror shard keeps a bounded ring of the raw records it
applied and exposes the same ship interface the durable store does
(``ship_floor``/``add_ship_listener``/``newest_snapshot_state``), so a
replica SERVES ``ship`` and ``bootstrap`` to deeper replicas: a
depth-2 replica tails a depth-1 replica with byte-identical mirrors
(the relayed records carry the primary's dense rv stamps unchanged, so
downstream gap detection works exactly as against the primary), and a
mid-tree re-bootstrap is answered from the parent's mirror state —
the primary never hears about it. ``serve()`` announces this endpoint
up the chain (``announce_read_endpoint``), so the primary's
``topology`` response grows a ``read_endpoints`` table direct-routing
clients use to prefer the nearest replica for reads.

Fault points: ``replica_apply`` (fires before each record applies; an
armed firing DROPS the record — the continuity check detects the hole
at the next record), ``replica_apply_dup`` (fires after; an armed
firing applies the record a second time — detected immediately), and
``replica_stale_read`` (fires at the head of every ``min_rv`` wait; an
armed firing expires the block typed — ReplicaLagError — without
waiting). ``wal_ship`` lives on the primary's send seam
(client/server.py); a REPLICA serving ship fires ``ship_relay`` there
instead, so chaos can drop a relayed frame mid-tree without touching
the primary's streams.
"""

from __future__ import annotations

import collections
import json
import logging
import random
import socket
import struct
import threading
import time
from typing import Dict, List, Optional

from ..resilience.faultinject import FaultError, faults
from .codec import decode, encode
from .remote import RemoteClusterStore
from .server import (
    MAX_FRAME_BYTES, EventJournal, StoreServer, _Handler, recv_exact,
    send_frame,
)
from .sharded import ShardedClusterStore, ShardRouter, _RouterHandler
from .store import (
    KINDS, ClusterStore, ReplicaLagError, ReplicaReadOnlyError, _key,
)

log = logging.getLogger(__name__)

_MUTATING_OPS = ("create", "update", "apply", "delete", "bulk_apply")
#: default block budget for an rv-bounded list before ReplicaLagError
DEFAULT_LIST_WAIT_S = 5.0
#: tailer reconnect backoff cap (same shape as the watch-resume path)
TAIL_BACKOFF_CAP_S = 2.0
#: applied records a mirror shard retains for re-shipping downstream
#: (the replica-tier analog of the primary's retained WAL segments);
#: a child below the ring's floor re-bootstraps from THIS replica's
#: mirror state, never from the primary
SHIP_RING_CAPACITY = 4096

_READONLY = ("replica is read-only: writes (and fencing/lease/"
             "conditional-update arbitration) belong to the primary")


class ReplicaGapError(Exception):
    """A shipped record does not extend the replica's applied rv by
    exactly one — a record was lost or duplicated somewhere between the
    primary's WAL and this apply. Never served around: the tailer
    re-bootstraps from a fresh snapshot."""


class _ReplicaShard(ClusterStore):
    """The replica's mirror of one primary store (or one member shard):
    a ClusterStore that is written ONLY by ``apply_record`` (preserving
    the primary's rv stamps exactly) and whose mutating surface fails
    closed. Watch listeners, the resume journal and list/get all work
    against it unchanged.

    The mirror is also a SHIP SOURCE (fan-out trees): it retains the
    raw records it applied in a bounded ring and exposes the durable
    store's ship interface, so server._serve_ship re-serves this
    lineage to deeper replicas and ``bootstrap`` is answered from the
    mirror state itself (always complete at the applied rv — unlike
    the primary's newest-on-disk snapshot, it can never be behind a
    compaction)."""

    #: this mirror can feed a deeper replica (see server._ship_source)
    ship_capable = True

    def __init__(self):
        super().__init__()
        #: raw shipped record dicts at rv in (_ship_floor_rv, _rv],
        #: appended under self._lock at the apply commit point
        self._ship_ring: "collections.deque" = collections.deque()
        self._ship_floor_rv = 0
        self._ship_listeners: List = []

    # -- the only write path ------------------------------------------------

    def apply_record(self, rv: int, kind: str, event: str, obj,
                     rec: Optional[dict] = None) -> None:
        """Apply one shipped WAL record. Refuses (ReplicaGapError) any
        record that does not extend the applied rv by exactly one —
        WAL rvs are dense, so a jump is a lost record and a repeat is a
        duplicate, and neither may be absorbed silently. ``rec`` is the
        raw wire record: when given it enters the re-ship ring and
        fires downstream ship listeners, atomically with the apply."""
        rv = int(rv)
        with self._lock:
            if rv != self._rv + 1:
                raise ReplicaGapError(
                    f"shipped record rv {rv} does not extend applied rv "
                    f"{self._rv} (lost or duplicated record)")
            bucket = self._buckets.setdefault(kind, {})
            key = _key(obj)
            old = bucket.get(key)
            if event == "delete":
                bucket.pop(key, None)
            else:
                bucket[key] = obj
            self._rv = rv
            # update events without a known predecessor carry old=obj —
            # the in-place-update idiom live streams already exhibit
            self._notify(kind, event, obj,
                         (old if old is not None else obj)
                         if event == "update" else None)
            if rec is not None:
                self._relay(rec)

    def _relay(self, rec: dict) -> None:
        # under self._lock (the apply commit point): ring append +
        # listener fire are atomic with respect to _serve_ship's
        # registration hold, so no record can fall between a child's
        # ring replay and its live tail
        self._ship_ring.append(rec)
        if len(self._ship_ring) > SHIP_RING_CAPACITY:
            self._ship_floor_rv = int(self._ship_ring.popleft()["rv"])
        for fn in list(self._ship_listeners):
            fn(rec)

    def load_state(self, rv: int, state: Optional[dict]) -> None:
        """Replace the mirror with a bootstrap snapshot (state may be
        None: an empty primary, or one that has never compacted — the
        ship stream then replays history from rv 0). Listeners stay
        subscribed; the serving layer rebuilds its journal and kicks
        live streams so no watcher silently spans the discontinuity."""
        with self._lock:
            self._buckets = {k: {} for k in KINDS}
            self._kind_rv = {k: 0 for k in KINDS}
            if state:
                rv = int(state["rv"])
                for kind, objs in state["buckets"].items():
                    bucket = self._buckets.setdefault(kind, {})
                    for eobj in objs:
                        obj = decode(eobj)
                        bucket[_key(obj)] = obj
                for kind, krv in state["kind_rv"].items():
                    self._kind_rv[kind] = int(krv)
            self._rv = int(rv)
            # the re-ship window restarts at the snapshot: a child below
            # this floor re-bootstraps from THIS mirror's state (above),
            # never from the primary
            self._ship_ring.clear()
            self._ship_floor_rv = self._rv

    # -- the ship interface (mirror as a ship source) -----------------------

    def ship_floor(self) -> int:
        """Oldest rv the ring can resume from (exclusive). Same contract
        as the durable store's retained-segment floor."""
        with self._lock:
            return self._ship_floor_rv

    def ship_records(self, since_rv: int, live_to: int) -> List[dict]:
        """Ring records with since_rv < rv <= live_to. Caller holds the
        shard lock (server._serve_ship's registration hold)."""
        return [r for r in self._ship_ring
                if since_rv < int(r["rv"]) <= live_to]

    def add_ship_listener(self, fn) -> None:
        with self._lock:
            self._ship_listeners.append(fn)

    def remove_ship_listener(self, fn) -> None:
        with self._lock:
            try:
                self._ship_listeners.remove(fn)
            except ValueError:
                pass

    def newest_snapshot_state(self):
        """Bootstrap source for a downstream replica: the mirror state
        itself, complete at the applied rv by construction (no snapshot
        cadence to lag behind)."""
        with self._lock:
            if self._rv == 0:
                return 0, None
            state = {
                "rv": self._rv,
                "kind_rv": dict(self._kind_rv),
                "buckets": {k: [encode(o) for o in b.values()]
                            for k, b in self._buckets.items()},
            }
            return self._rv, state

    # -- mutations fail closed ----------------------------------------------

    def create(self, kind, obj, fencing=None):
        raise ReplicaReadOnlyError(_READONLY)

    def update(self, kind, obj, fencing=None):
        raise ReplicaReadOnlyError(_READONLY)

    def apply(self, kind, obj, fencing=None):
        raise ReplicaReadOnlyError(_READONLY)

    def delete(self, kind, name, namespace=None, fencing=None):
        raise ReplicaReadOnlyError(_READONLY)

    def bulk_apply(self, items, fencing=None, _sync=True):
        raise ReplicaReadOnlyError(_READONLY)


class _ReplicaShardedStore(ShardedClusterStore):
    """Mirror of a sharded primary: one _ReplicaShard per member WAL
    lineage, behind the sharded store's watch/list surface so the
    router handler serves it unchanged. Mutations fail closed at the
    top (and again at every shard, defense in depth)."""

    def _make_shard(self, i: int) -> ClusterStore:
        return _ReplicaShard()

    def create(self, kind, obj, fencing=None):
        raise ReplicaReadOnlyError(_READONLY)

    def update(self, kind, obj, fencing=None):
        raise ReplicaReadOnlyError(_READONLY)

    def apply(self, kind, obj, fencing=None):
        raise ReplicaReadOnlyError(_READONLY)

    def delete(self, kind, name, namespace=None, fencing=None):
        raise ReplicaReadOnlyError(_READONLY)

    def bulk_apply(self, items, fencing=None):
        raise ReplicaReadOnlyError(_READONLY)


# -- serving ------------------------------------------------------------------


class _ReplicaHandler(_Handler):
    """The wire protocol over a replica mirror: reads pass through (list
    already stamps ``applied_rv`` via the base dispatch), ``min_rv``
    blocks-or-fails against the replica's applied rv, and every mutating
    op is refused typed before it can touch any state."""

    def _dispatch(self, store, op: str, req: dict) -> dict:
        replica = self.server.replica  # type: ignore[attr-defined]
        if op in _MUTATING_OPS:
            raise ReplicaReadOnlyError(
                f"{_READONLY} (primary: {replica.primary_address})")
        if op in ("list", "get"):
            min_rv = req.get("min_rv")
            if min_rv is not None:
                replica.wait_applied(
                    min_rv, float(req.get("wait_s", DEFAULT_LIST_WAIT_S)))
            return _Handler._dispatch(self, store, op, req)
        if op == "store_info":
            resp = _Handler._dispatch(self, store, op, req)
            # a replica IS a valid ship source: a deeper replica's
            # handshake passes the same check the durable primary does
            resp["ship_capable"] = True
            resp["depth"] = replica.depth
            resp["upstream"] = replica.primary_address
            return resp
        if op == "bootstrap":
            replica.ship_served["bootstraps"] += 1
            try:
                from ..metrics import metrics
                metrics.replica_ship_served_bootstraps_total.inc()
            except Exception:  # noqa: BLE001 — accounting only
                pass
            return _Handler._dispatch(self, store, op, req)
        if op == "replica_info":
            return replica.info()
        if op == "announce_read_endpoint":
            resp = _Handler._dispatch(self, store, op, req)
            # relay up the chain so the PRIMARY's topology table learns
            # about endpoints announced anywhere in the tree
            replica._announce_upstream(req)
            return resp
        return _Handler._dispatch(self, store, op, req)

    def _serve_watch(self, sock, store, req) -> None:
        replica = self.server.replica  # type: ignore[attr-defined]
        replica._watcher_delta(1)
        try:
            super()._serve_watch(sock, store, req)
        finally:
            replica._watcher_delta(-1)


class _ShardedReplicaHandler(_ReplicaHandler, _RouterHandler):
    """Replica dispatch rules over the router's shard-aware watch
    serving (events tagged per shard, per-shard resume marks)."""


class ReplicaServer(StoreServer):
    """Serve a replica mirror on host:port — the unchanged wire
    protocol, reads only. ``on_rebootstrap`` rebuilds the watch-resume
    journal from the fresh snapshot floor and kicks every live
    connection: a watcher must re-enter through ``since:`` (resuming if
    its mark is inside the new window, resyncing if not) rather than
    silently span a bootstrap discontinuity."""

    handler_class = _ReplicaHandler

    def __init__(self, replica: "ReplicaStore", host: str = "127.0.0.1",
                 port: int = 0, token: Optional[str] = None,
                 tls_cert: Optional[str] = None,
                 tls_key: Optional[str] = None,
                 tls_client_ca: Optional[str] = None, gate=None):
        super().__init__(replica.store, host=host, port=port, token=token,
                         tls_cert=tls_cert, tls_key=tls_key,
                         tls_client_ca=tls_client_ca, gate=gate)
        self.replica = replica
        self._server.replica = replica  # type: ignore[attr-defined]
        # a replica relaying ship fires its own chaos seam, so a test
        # can drop a mid-tree frame without touching primary streams
        self._server.ship_fault_point = "ship_relay"  # type: ignore

    def on_rebootstrap(self, shard_idx: Optional[int]) -> None:
        self.journal.close()
        self.journal = self._make_journal(self.replica.store)
        self._server.journal = self.journal  # type: ignore[attr-defined]
        self.kick_connections()

    def kick_connections(self) -> None:
        """Drop every live connection (watchers resume via ``since:``,
        requests ride the client retry rules)."""
        for sock in list(self._server.active):  # type: ignore[attr-defined]
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass


class ShardedReplicaServer(ShardRouter):
    """ReplicaServer for a sharded mirror: one endpoint, shard-tagged
    events, per-shard resume journals — the router's serving surface
    over read-only shards."""

    handler_class = _ShardedReplicaHandler

    def __init__(self, replica: "ReplicaStore", host: str = "127.0.0.1",
                 port: int = 0, token: Optional[str] = None,
                 tls_cert: Optional[str] = None,
                 tls_key: Optional[str] = None,
                 tls_client_ca: Optional[str] = None, gate=None):
        super().__init__(replica.store, host=host, port=port, token=token,
                         tls_cert=tls_cert, tls_key=tls_key,
                         tls_client_ca=tls_client_ca, gate=gate)
        self.replica = replica
        self._server.replica = replica  # type: ignore[attr-defined]
        self._server.ship_fault_point = "ship_relay"  # type: ignore

    def on_rebootstrap(self, shard_idx: Optional[int]) -> None:
        # only the re-bootstrapped shard's journal restarts from the new
        # snapshot floor; the other shards' windows are still continuous
        self.journal.rebuild(shard_idx, self.replica.store.shards[shard_idx])
        self.kick_connections()

    kick_connections = ReplicaServer.kick_connections


# -- the replica process ------------------------------------------------------


def _recv_counted(sock) -> tuple:
    """recv_frame + how many wire bytes it cost (ship accounting)."""
    (length,) = struct.unpack("<I", recv_exact(sock, 4))
    if length > MAX_FRAME_BYTES:
        raise ConnectionError(f"frame length {length} exceeds cap")
    return json.loads(recv_exact(sock, length)), 4 + length


class ReplicaStore:
    """See module docstring. Lifecycle::

        replica = ReplicaStore("127.0.0.1:7000")   # bootstraps now
        replica.serve(port=7100)                   # optional read endpoint
        replica.start()                            # tailers begin
        ...
        replica.close()

    Construction performs the handshake (``store_info``) and the initial
    snapshot bootstrap, so a constructed replica can already serve its
    (possibly stale) mirror; ``start()`` begins tailing. In-process
    consumers may also use ``replica.store`` directly (list/get/watch —
    mutations fail closed)."""

    def __init__(self, primary: str, token: Optional[str] = None,
                 tls_ca: Optional[str] = None,
                 tls_cert: Optional[str] = None,
                 tls_key: Optional[str] = None,
                 connect_timeout: float = 5.0,
                 tail_backoff_cap_s: float = TAIL_BACKOFF_CAP_S):
        self.primary_address = primary
        self.tail_backoff_cap_s = float(tail_backoff_cap_s)
        self._client = RemoteClusterStore(
            primary, connect_timeout=connect_timeout, token=token,
            tls_ca=tls_ca, tls_cert=tls_cert, tls_key=tls_key,
            retry_attempts=8, retry_cap_s=2.0)
        info = self._client._request({"op": "store_info"})
        if not (info.get("durable") or info.get("ship_capable")):
            raise RuntimeError(
                f"primary {primary} is not durable (no --store-data-dir): "
                "there is no WAL to ship, so it cannot feed a replica")
        self.n_shards = int(info.get("shards", 1))
        #: 1 when tailing the primary, parent depth + 1 down a tree
        self.depth = int(info.get("depth", 0) or 0) + 1
        self.store = (_ReplicaShard() if self.n_shards == 1
                      else _ReplicaShardedStore(self.n_shards))
        self.server: Optional[StoreServer] = None
        #: re/bootstrap count per reason (initial/out_of_window/apply_gap)
        self.bootstraps: "collections.Counter" = collections.Counter()
        #: ship/bootstrap traffic THIS replica absorbed for its children
        #: (streams/records/bootstraps — the primary never sees it)
        self.ship_served: "collections.Counter" = collections.Counter()
        self._ship_streams = 0
        #: last primary rv seen on each shard's ship stream (lag floor)
        self.primary_rv: Dict[int, int] = {}
        self.ship_bytes = 0
        self._cv = threading.Condition()
        self._closed = threading.Event()
        self._threads: List[threading.Thread] = []
        self._tail_socks: List[socket.socket] = []
        self._sock_lock = threading.Lock()
        self._watchers = 0
        self._last_applied_ts: Dict[int, float] = {}
        try:
            from ..metrics import metrics
            metrics.replica_upstream_depth.set(self.depth)
        except Exception:  # noqa: BLE001 — accounting only
            pass
        for idx in range(self.n_shards):
            self._bootstrap(idx, "initial")

    # -- shards ---------------------------------------------------------------

    def _shard(self, idx: int) -> _ReplicaShard:
        if self.n_shards == 1:
            return self.store  # type: ignore[return-value]
        return self.store.shards[idx]  # type: ignore[attr-defined]

    def applied_rv(self):
        """The primary rv(s) this mirror reflects: a scalar, or the
        per-shard map against a sharded primary."""
        if self.n_shards == 1:
            return self.store._rv
        return {str(i): s._rv
                for i, s in enumerate(self.store.shards)}  # type: ignore

    # -- rv-bounded staleness -------------------------------------------------

    def _covers(self, min_rv) -> bool:
        if isinstance(min_rv, dict):
            return all(self._shard(int(i))._rv >= int(rv)
                       for i, rv in min_rv.items())
        if self.n_shards != 1:
            raise RuntimeError(
                "scalar min_rv against a sharded replica is ambiguous "
                "(each shard owns its own rv sequence); pass a "
                "{shard: rv} map")
        return self.store._rv >= int(min_rv)

    def wait_applied(self, min_rv, wait_s: float = DEFAULT_LIST_WAIT_S):
        """Block until the mirror has applied ``min_rv`` (scalar, or
        ``{shard: rv}``); raise ReplicaLagError past ``wait_s``."""
        try:
            faults.fire("replica_stale_read")
        except FaultError:
            # injected staleness: the block expires typed immediately,
            # driving the caller's primary-fallback path
            raise ReplicaLagError(
                f"injected stale read: replica at applied_rv "
                f"{self.applied_rv()} refused min_rv {min_rv}")
        deadline = time.monotonic() + float(wait_s)
        with self._cv:
            while not self._covers(min_rv):
                left = deadline - time.monotonic()
                if left <= 0 or self._closed.is_set():
                    raise ReplicaLagError(
                        f"replica at applied_rv {self.applied_rv()} did "
                        f"not reach min_rv {min_rv} within {wait_s}s")
                self._cv.wait(min(left, 0.5))

    # -- lifecycle ------------------------------------------------------------

    def serve(self, host: str = "127.0.0.1", port: int = 0,
              token: Optional[str] = None,
              tls_cert: Optional[str] = None, tls_key: Optional[str] = None,
              tls_client_ca: Optional[str] = None,
              gate=None) -> StoreServer:
        cls = ReplicaServer if self.n_shards == 1 else ShardedReplicaServer
        self.server = cls(self, host=host, port=port, token=token,
                          tls_cert=tls_cert, tls_key=tls_key,
                          tls_client_ca=tls_client_ca, gate=gate).start()
        self._announce_self()
        return self.server

    def _announce_self(self) -> None:
        """Best-effort: register this read endpoint up the chain so the
        primary's ``topology`` table can hand it to direct-routing
        clients. Discovery is advisory — a failed announce degrades to
        clients reading the primary, never to an error."""
        if self.server is None:
            return
        self._announce_upstream({"endpoint": self.server.address,
                                 "depth": self.depth,
                                 "shards": self.n_shards})

    def _announce_upstream(self, req: dict) -> None:
        try:
            self._client._request({
                "op": "announce_read_endpoint",
                "endpoint": req["endpoint"],
                "depth": int(req.get("depth", 1)),
                "shards": int(req.get("shards", 1))})
        except Exception:  # noqa: BLE001 — discovery is advisory
            log.debug("announce_read_endpoint upstream failed",
                      exc_info=True)

    def start(self) -> "ReplicaStore":
        for idx in range(self.n_shards):
            t = threading.Thread(target=self._tail, args=(idx,),
                                 daemon=True, name=f"replica-tail-{idx}")
            t.start()
            self._threads.append(t)
        return self

    def close(self) -> None:
        self._closed.set()
        with self._cv:
            self._cv.notify_all()
        with self._sock_lock:
            socks, self._tail_socks = self._tail_socks, []
        for sock in socks:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
        if self.server is not None:
            self.server.stop()
        self._client.close()
        for t in self._threads:
            t.join(timeout=5)

    # -- bootstrap ------------------------------------------------------------

    def _bootstrap(self, idx: int, reason: str) -> None:
        """(Re)seed one shard's mirror from the primary's newest
        snapshot. Every call is counted by reason — a hole NEVER closes
        silently."""
        resp = self._client._request({"op": "bootstrap", "shard": idx})
        with self.store.locked():
            self._shard(idx).load_state(int(resp["rv"]), resp.get("state"))
        self.bootstraps[reason] += 1
        try:
            from ..metrics import metrics
            metrics.replica_bootstraps_total.inc(labels={"reason": reason})
            metrics.replica_applied_rv.set(
                self._shard(idx)._rv, labels={"shard": str(idx)})
        except Exception:  # noqa: BLE001 — accounting only
            pass
        with self._cv:
            self._cv.notify_all()
        if self.server is not None:
            self.server.on_rebootstrap(idx if self.n_shards > 1 else None)
        log.log(logging.INFO if reason == "initial" else logging.WARNING,
                "replica shard %d bootstrapped (%s) at rv %d",
                idx, reason, self._shard(idx)._rv)

    # -- the tailer -----------------------------------------------------------

    def _tail(self, idx: int) -> None:
        delay = 0.05
        while not self._closed.is_set():
            sock = None
            try:
                sock = self._client._connect()
                with self._sock_lock:
                    self._tail_socks.append(sock)
                send_frame(sock, {"op": "ship", "shard": idx,
                                  "since_rv": self._shard(idx)._rv})
                resp, _ = _recv_counted(sock)
                if resp.get("ok") is False:
                    if resp.get("error") == "ResumeGapError":
                        # fell out of the retained-segment window: the
                        # hole closes with a fresh bootstrap, never by
                        # skipping ahead
                        self._drop_sock(sock)
                        sock = None
                        self._bootstrap(idx, "out_of_window")
                        continue
                    raise ConnectionError(
                        f"ship refused: {resp.get('message')}")
                delay = 0.05
                while not self._closed.is_set():
                    msg, nbytes = _recv_counted(sock)
                    self.ship_bytes += nbytes
                    stream = msg.get("stream")
                    prv = msg.get("prv", msg.get("rv"))
                    if stream == "wal":
                        self._apply_batch(idx, msg["recs"])
                    if prv is not None:
                        self.primary_rv[idx] = int(prv)
                    self._export_lag(idx, nbytes)
            except ReplicaGapError as e:
                log.error("replica shard %d detected an rv gap: %s — "
                          "re-bootstrapping", idx, e)
                self._drop_sock(sock)
                sock = None
                if not self._closed.is_set():
                    self._bootstrap(idx, "apply_gap")
                continue
            except (ConnectionError, OSError, ValueError):
                # primary gone (or link dropped mid-segment): only
                # complete CRC-clean frames were applied, so the mirror
                # sits at a consistent rv prefix — back off, reconnect,
                # resume shipping at the applied rv
                self._drop_sock(sock)
                sock = None
                if self._closed.is_set():
                    return
                self._closed.wait(delay * (0.5 + random.random()))
                delay = min(delay * 2.0, self.tail_backoff_cap_s)
            finally:
                self._drop_sock(sock)

    def _drop_sock(self, sock) -> None:
        if sock is None:
            return
        with self._sock_lock:
            try:
                self._tail_socks.remove(sock)
            except ValueError:
                pass
        try:
            sock.close()
        except OSError:
            pass

    def _apply_batch(self, idx: int, recs: List[dict]) -> None:
        shard = self._shard(idx)
        with self.store.locked():
            for rec in recs:
                try:
                    faults.fire("replica_apply")
                except FaultError:
                    # injected drop: the record is lost between wire and
                    # mirror; the next record's continuity check refuses
                    continue
                shard.apply_record(rec["rv"], rec["kind"], rec["event"],
                                   decode(rec["obj"]), rec=rec)
                ts = rec.get("ts")
                if ts is not None:
                    self._last_applied_ts[idx] = float(ts)
                try:
                    faults.fire("replica_apply_dup")
                except FaultError:
                    # injected duplicate: refused immediately (rv repeat)
                    shard.apply_record(rec["rv"], rec["kind"],
                                       rec["event"], decode(rec["obj"]))
        with self._cv:
            self._cv.notify_all()

    # -- observability --------------------------------------------------------

    def lag_records(self, idx: int = 0) -> Optional[int]:
        prv = self.primary_rv.get(idx)
        if prv is None:
            return None
        return max(0, prv - self._shard(idx)._rv)

    def lag_seconds(self, idx: int = 0) -> Optional[float]:
        lag = self.lag_records(idx)
        if lag == 0:
            return 0.0
        ts = self._last_applied_ts.get(idx)
        if lag is None or ts is None:
            return None
        return max(0.0, time.time() - ts)

    def info(self) -> dict:
        """The ``replica_info`` wire response: this hop's place in the
        tree, its lag, and the ship traffic it absorbed downstream.
        A status client walks ``upstream`` hop by hop to print the
        chain."""
        per_shard = {}
        for idx in range(self.n_shards):
            per_shard[str(idx)] = {
                "applied_rv": self._shard(idx)._rv,
                "lag_records": self.lag_records(idx),
                "lag_seconds": self.lag_seconds(idx),
            }
        return {
            "ok": True,
            "upstream": self.primary_address,
            "depth": self.depth,
            "shards": self.n_shards,
            "applied_rv": self.applied_rv(),
            "per_shard": per_shard,
            "bootstraps": dict(self.bootstraps),
            "watchers": self._watchers,
            "ship_served": dict(self.ship_served),
        }

    def _export_lag(self, idx: int, nbytes: int) -> None:
        try:
            from ..metrics import metrics
            labels = {"shard": str(idx)}
            applied = self._shard(idx)._rv
            metrics.replica_applied_rv.set(applied, labels=labels)
            prv = self.primary_rv.get(idx)
            if prv is not None:
                metrics.replica_upstream_rv.set(prv, labels=labels)
            lag = self.lag_records(idx)
            if lag is not None:
                metrics.replica_lag_records.set(lag, labels=labels)
                ts = self._last_applied_ts.get(idx)
                metrics.replica_lag_seconds.set(
                    max(0.0, time.time() - ts) if lag > 0 and ts is not None
                    else 0.0, labels=labels)
            metrics.replica_ship_bytes_total.inc(
                nbytes, labels=labels)
        except Exception:  # noqa: BLE001 — accounting only
            pass

    def _watcher_delta(self, d: int) -> None:
        with self._cv:
            self._watchers += d
            n = self._watchers
        try:
            from ..metrics import metrics
            metrics.replica_watchers.set(n)
        except Exception:  # noqa: BLE001
            pass

    def _ship_stream_delta(self, d: int) -> None:
        with self._cv:
            self._ship_streams += d
            n = self._ship_streams
        try:
            from ..metrics import metrics
            metrics.replica_ship_served_streams.set(n)
        except Exception:  # noqa: BLE001
            pass
