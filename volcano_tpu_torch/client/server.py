"""StoreServer: the ClusterStore served over TCP.

The reference's control-plane components are separate processes meeting at
the Kubernetes API server (cmd/cli/vcctl.go:44-49 CRUDs from anywhere;
pkg/scheduler/cache/cache.go:319-402 watches ten informer streams). This
module is this package's API-server seam as an actual server: a
length-prefixed JSON protocol exposing create/update/apply/delete/get/
list/watch on one authoritative in-process ClusterStore, so remote
scheduler caches, controllers and HA standbys in other processes can
drive a deployed control plane over the wire. The protocol is the JAX
package's frame for frame: either package's client talks to either
package's server.

Protocol: 4-byte magic "VCS1", then frames of <u32 length><JSON bytes>.
Request ops mirror the ClusterStore surface; errors return their class
name and re-raise as the same class client-side. A `watch` request turns
the connection into an event stream: replayed adds, then {"stream":
"synced", "rv": {...}}, then live events (each carrying the global
resource_version it committed at) as they commit. A watch request with
"since": {kind: rv} instead resumes from that high-water mark: the
per-kind EventJournal replays exactly the missed events (client-go's
reflector re-watch at a ResourceVersion), or refuses with ResumeGapError
when its bounded window no longer covers them — the client then falls
back to its crash-only path. Frame size is capped so a corrupt or
hostile peer cannot drive unbounded allocation (same rule as the solver
sidecar, parallel/sidecar.py).
"""

from __future__ import annotations

import collections
import json
import logging
import queue
import socket
import socketserver
import struct
import threading
from typing import Dict, Optional

import hmac

from ..resilience.faultinject import faults
from ..resilience.overload import AdmissionGate, OverloadedError
from .codec import (
    Interner, decode, delta_diff, delta_value, encode, object_key,
)
from .store import (
    KINDS, AdmissionError, ClusterStore, ConflictError, FencedError,
    NotFoundError, ReplicaLagError, ReplicaReadOnlyError, ResumeGapError,
    ShardUnavailableError,
)

log = logging.getLogger(__name__)

MAGIC = b"VCS1"
MAX_FRAME_BYTES = 64 << 20  # a 10k-pod wave of Jobs is ~10 MB of JSON
WATCH_QUEUE_MAX = 65536     # pending events before a slow watcher drops
WATCH_SEND_TIMEOUT_S = 30.0
TLS_HANDSHAKE_TIMEOUT_S = 10.0
JOURNAL_CAPACITY = 4096     # per-kind resume window (events)
WATCH_BATCH_MAX = 256       # events coalesced per bulk_watch frame
SHIP_BATCH_MAX = 256        # WAL records coalesced per ship frame

_ERRORS = {
    "ConflictError": ConflictError,
    "NotFoundError": NotFoundError,
    "AdmissionError": AdmissionError,
    "ResumeGapError": ResumeGapError,
    "FencedError": FencedError,
    "ShardUnavailableError": ShardUnavailableError,
    "ReplicaReadOnlyError": ReplicaReadOnlyError,
    "ReplicaLagError": ReplicaLagError,
    "OverloadedError": OverloadedError,
}


def applied_rv_of(store) -> object:
    """The store's committed resource_version(s) for response stamping:
    the global rv scalar, or — sharded — the ``{shard: rv}`` map (each
    shard owns its own sequence). Call under ``store.locked()`` so the
    stamp is consistent with the reads it rides alongside."""
    shards = getattr(store, "shards", None)
    if shards is not None:
        return {str(i): s._rv for i, s in enumerate(shards)}
    return store._rv


def _ship_source(store, shard) -> "ClusterStore":
    """Resolve a ship/bootstrap request to the store that owns the WAL
    lineage: the store itself, or — behind a ShardRouter — the requested
    member shard. Any ``ship_capable`` store qualifies: the durable
    primary (disk segments + live tail) or a replica's mirror shard
    (bounded re-ship ring + live tail) — fan-out trees hang replicas
    off replicas through exactly this seam. A plain in-memory store has
    no lineage to ship and refuses."""
    shards = getattr(store, "shards", None)
    idx = int(shard or 0)
    if shards is None:
        if idx != 0:
            raise RuntimeError(f"unsharded store has no shard {idx}")
        target = store
    else:
        if not 0 <= idx < len(shards):
            raise RuntimeError(
                f"shard {idx} out of range (store has {len(shards)})")
        target = store._shard(idx)  # ShardUnavailableError when down
    if (getattr(target, "data_dir", None) is None
            and not getattr(target, "ship_capable", False)):
        raise RuntimeError(
            "replica bootstrap/ship requires a durable primary "
            "(--store-data-dir): an in-memory store has no WAL to ship")
    return target


class EventJournal:
    """Per-kind ring of recent committed events keyed by the store's
    global resource_version, so a reconnecting watcher resumes from its
    high-water mark instead of tearing its mirror down. Bounded: once a
    kind's ring has dropped an event (or the event predates this
    journal), resumes from before that point refuse (ResumeGapError).

    Entries hold the live store objects and encode lazily at resume time
    — the common case (no broken watchers) pays one deque append per
    write, no JSON. With the store's in-place-update idiom a replayed
    event can therefore carry a slightly newer object state than it
    committed with; the mirror still converges (level-triggered, and the
    cache's handlers are resync-safe).

    A DurableClusterStore that just recovered exposes the WAL-tail
    events it replayed (``recovery_tail``/``recovery_floors``,
    client/durable.py); they seed this journal's window, so a watcher
    that was mid-stream when the store crashed resumes through the same
    ``since:`` path over the restart — the events it missed while the
    store was down are replayed from disk instead of forcing the
    crash-only full resync."""

    def __init__(self, store: ClusterStore, capacity: int = JOURNAL_CAPACITY):
        self.store = store
        self.capacity = capacity
        self._lock = threading.Lock()
        self._events: Dict[str, collections.deque] = {}
        #: per kind: events at or below this rv are NOT replayable
        self._floor: Dict[str, int] = {}
        self._listeners = []
        seed = getattr(store, "recovery_tail", None) or {}
        floors = getattr(store, "recovery_floors", None) or {}
        with store.locked():
            for kind in KINDS:
                self._events[kind] = collections.deque()
                self._floor[kind] = store.last_event_rv(kind)
                tail = seed.get(kind)
                # trust the recovered tail only when it reaches the
                # store's PRESENT rv for this kind: a journal built some
                # time after recovery (events committed in between) has
                # a hole the tail cannot cover, and resuming across it
                # would silently skip those events — keep the floor at
                # the current rv instead (resumes from before it refuse)
                if tail and tail[-1][0] >= store.last_event_rv(kind):
                    self._floor[kind] = int(floors.get(kind, 0))
                    q = self._events[kind]
                    for entry in tail:
                        if len(q) >= self.capacity:
                            self._floor[kind] = q.popleft()[0]
                        q.append(entry)
                listener = self._make_listener(kind)
                self._listeners.append((kind, listener))
                store.watch(kind, listener, replay=False)

    def _make_listener(self, kind: str):
        def listener(event, obj, old):
            # runs under the store lock: _rv is the rv this event
            # committed at (store._notify stamps _kind_rv from it too)
            rv = self.store._rv
            with self._lock:
                q = self._events[kind]
                if len(q) >= self.capacity:
                    self._floor[kind] = q.popleft()[0]
                q.append((rv, event, obj, old))
        return listener

    def since(self, kind: str, rv: int):
        """[(rv, event, obj, old)] committed after ``rv``, or None when
        the window no longer covers that point."""
        with self._lock:
            if rv < self._floor[kind]:
                return None
            return [e for e in self._events[kind] if e[0] > rv]

    def close(self) -> None:
        """Unsubscribe (a stopped server must not keep journaling into a
        store that outlives it — the restart case builds a fresh one)."""
        for kind, listener in self._listeners:
            self.store.unwatch(kind, listener)
        self._listeners = []


def send_frame(sock: socket.socket, payload: dict) -> None:
    raw = json.dumps(payload).encode()
    if len(raw) > MAX_FRAME_BYTES:
        raise ValueError(f"frame of {len(raw)} bytes exceeds cap")
    sock.sendall(struct.pack("<I", len(raw)) + raw)


def send_frame_raw(sock: socket.socket, raw: bytes) -> None:
    """Send an already-serialized frame (the watch hub serializes each
    event once; every stream then ships the same bytes)."""
    if len(raw) > MAX_FRAME_BYTES:
        raise ValueError(f"frame of {len(raw)} bytes exceeds cap")
    sock.sendall(struct.pack("<I", len(raw)) + raw)


def recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("store connection closed mid-frame")
        buf.extend(chunk)
    return bytes(buf)


def recv_frame_sized(sock: socket.socket) -> tuple:
    """(frame, wire byte length) — the watch client's per-stream byte
    accounting (volcano_delta_stream_bytes_total) without re-encoding."""
    raw = recv_frame_raw(sock)
    return json.loads(raw), len(raw)


def recv_frame(sock: socket.socket) -> dict:
    (length,) = struct.unpack("<I", recv_exact(sock, 4))
    if length > MAX_FRAME_BYTES:
        raise ConnectionError(f"frame length {length} exceeds cap")
    return json.loads(recv_exact(sock, length))


def recv_frame_raw(sock: socket.socket) -> bytes:
    """One frame's payload bytes, unparsed — the multi-process shard
    router relays worker watch/ship frames verbatim (the workers already
    stamp shard tags), so the relay never pays a loads/dumps per event."""
    (length,) = struct.unpack("<I", recv_exact(sock, 4))
    if length > MAX_FRAME_BYTES:
        raise ConnectionError(f"frame length {length} exceeds cap")
    return recv_exact(sock, length)


def remote_error(resp: dict) -> Exception:
    """Rebuild a {"ok": false} response (or a bulk_apply per-item error
    entry) as its original exception class, without raising."""
    cls = _ERRORS.get(resp.get("error"), RuntimeError)
    if cls is OverloadedError:
        # the shed response's retry-after hint (and lane/reason) ride
        # the frame as typed fields, not prose — rebuild them so the
        # client's retry discipline can honor the hint
        return OverloadedError(
            resp.get("message", "request shed at the admission gate"),
            retry_after_ms=resp.get("retry_after_ms"),
            lane=resp.get("lane"), reason=resp.get("reason"))
    return cls(resp.get("message", "remote store error"))


def overloaded_response(e: OverloadedError) -> dict:
    """The wire form of a shed: typed error + retry-after hint."""
    resp = {"ok": False, "error": "OverloadedError", "message": str(e)}
    if e.retry_after_ms is not None:
        resp["retry_after_ms"] = e.retry_after_ms
    if e.lane is not None:
        resp["lane"] = e.lane
    if e.reason is not None:
        resp["reason"] = e.reason
    return resp


def raise_remote(resp: dict) -> None:
    """Re-raise a {"ok": false} response as its original error class."""
    raise remote_error(resp)


def since_rv(val, shard: Optional[int] = None) -> int:
    """A resume high-water mark out of a ``since:`` request: the legacy
    scalar, or the per-shard map ({shard: rv}) a shard-aware client
    sends — the unsharded server IS shard "0" (or, for a shard-worker
    process serving one member lineage, its own ``shard`` index), so it
    resumes from that entry and ignores the rest (there are none to
    ignore unless the client migrated from a sharded endpoint, in which
    case an absent entry refuses conservatively)."""
    if isinstance(val, dict):
        val = val.get(str(shard if shard is not None else 0), -1)
    return int(val if val is not None else -1)


def pump_watch(sock: socket.socket, events: "queue.Queue",
               overflowed: threading.Event, batch_max: int = 1,
               on_sent=None) -> None:
    """Drain a watch queue onto the socket until the watcher is
    condemned (overflow) or the peer goes away (raises). With
    ``batch_max`` > 1 consecutive event payloads coalesce into one
    ``{"stream": "events", "batch": [...]}`` frame — the bulk_watch
    contract: at tens of thousands of events per second, per-event
    frames spend more wall time in framing + syscalls than in the
    events themselves. Control frames (synced/heartbeat) always flush
    the pending batch first, so ordering is preserved.

    An event payload may carry ``_raw`` — its own frame bytes,
    serialized ONCE by the producer (the shard router's watch hub) —
    in which case this pump ships/concatenates those bytes instead of
    re-serializing per stream."""
    def event_bytes(p) -> str:
        raw = p.get("_raw")
        return raw if raw is not None else json.dumps(p)

    while not overflowed.is_set():
        try:
            payload = events.get(timeout=10.0)
        except queue.Empty:
            # heartbeat: an idle cluster would otherwise never touch
            # the socket, so a dead peer's listener would stay
            # subscribed forever
            payload = {"stream": "heartbeat"}
        if batch_max > 1 and payload.get("stream") == "event":
            batch = [payload]
            tail = None
            while len(batch) < batch_max:
                try:
                    nxt = events.get_nowait()
                except queue.Empty:
                    break
                if nxt.get("stream") == "event":
                    batch.append(nxt)
                else:
                    tail = nxt
                    break
            send_frame_raw(sock, (
                '{"stream":"events","batch":['
                + ",".join(event_bytes(p) for p in batch)
                + "]}").encode())
            if on_sent is not None:
                on_sent(batch)
            if tail is not None:
                send_frame(sock, tail)
            continue
        if payload.get("stream") == "event":
            send_frame_raw(sock, event_bytes(payload).encode())
            if on_sent is not None:
                on_sent([payload])
        else:
            send_frame(sock, payload)


class DeltaEncoder:
    """Shared per-serving-store builder of delta-form watch payloads
    (the ``delta: true`` negotiation — see codec.py's dialect notes).

    One instance per store lineage (a StoreServer / shard worker, or one
    per shard inside the router's watch hub); every call happens under
    that store's commit lock, so the per-kind frame-sequence counters
    (``ks``) and the interning table mutate without a lock of their own,
    and the last-event payload cache lets N delta streams share one
    diff+dumps exactly like the object path's ``_raw``.

    ``ks`` stamps EVERY live delta-stream frame (patch or object form)
    densely per kind: the client refuses a gap or repeat BEFORE applying
    anything, which is what makes the drop/dup fault ladder
    (``delta_frame``/``delta_frame_dup``) recover with zero lost or
    duplicated events — the resume replay (object form, journal-fed)
    starts from a high-water mark the bad frame never advanced."""

    def __init__(self):
        # one interning table PER KIND: a table addition must ride a
        # frame of the kind that grew it, and a stream only receives
        # the kinds it subscribed — a shared table would skew streams
        # watching a subset of kinds (their copy misses the additions
        # other kinds' frames carried)
        self.interners: Dict[str, Interner] = {}
        self.ks: Dict[str, int] = {}
        self._last_key: Optional[tuple] = None
        self._last_payload: Optional[dict] = None

    def payload(self, kind: str, shard, rv: int, event: str,
                obj, old) -> dict:
        cache_key = (kind, rv, event, id(obj))
        if cache_key == self._last_key:
            return self._last_payload  # type: ignore[return-value]
        n = self.ks.get(kind, 0) + 1
        self.ks[kind] = n
        payload: dict = {"stream": "event", "kind": kind, "rv": rv,
                         "event": event, "ks": n}
        if shard is not None:
            payload["shard"] = shard
        it = self.interners.get(kind)
        if it is None:
            it = self.interners[kind] = Interner()
        t0 = len(it.entries)
        patched = False
        if event == "update" and old is not None:
            enc_new, enc_old = encode(obj), encode(old)
            d = delta_diff(enc_new, enc_old)
            if d is not None:
                changed, cleared = d
                dk = it.intern(object_key(obj))
                if dk is not None:
                    df, dv, dx = [], [], []
                    ok = True
                    for fname, enc in changed.items():
                        fid = it.intern(fname)
                        if fid is None:
                            ok = False  # table at cap: object form
                            break
                        df.append(fid)
                        dv.append(delta_value(enc, it))
                    if ok:
                        for fname in cleared:
                            fid = it.intern(fname)
                            if fid is None:
                                ok = False
                                break
                            dx.append(fid)
                    if ok:
                        payload["dk"] = dk
                        payload["df"] = df
                        payload["dv"] = dv
                        if dx:
                            payload["dx"] = dx
                        patched = True
        if not patched:
            payload["obj"] = encode(obj)
            payload["old"] = encode(old) if old is not None else None
        added = it.entries[t0:]
        if added:
            # the table entries THIS event created ride this frame, in
            # id order — every subscribed stream needs exactly these
            # (its synced snapshot covered everything earlier)
            payload["tb"] = [t0, added]
        payload["_raw"] = json.dumps(payload, separators=(",", ":"))
        self._last_key = cache_key
        self._last_payload = payload
        return payload

    def synced_fields(self, kinds, shard) -> dict:
        """The delta half of a stream's ``synced`` frame — per-kind
        table snapshots plus per-kind ks baselines, read under the
        store lock so they are atomic with the subscription. Only the
        subscribed kinds ship: their frames are all this stream will
        see, so their tables are all it can keep aligned."""
        sh = str(shard if shard is not None else 0)
        return {"delta": True,
                "vtab": {k: {sh: self.interners[k].snapshot()}
                         for k in kinds if k in self.interners},
                "ks": {k: {sh: self.ks.get(k, 0)} for k in kinds}}


class _Handler(socketserver.BaseRequestHandler):
    def handle(self) -> None:  # noqa: D102 — socketserver contract
        sock = self.request
        store: ClusterStore = self.server.store  # type: ignore[attr-defined]
        token = self.server.token  # type: ignore[attr-defined]
        ssl_ctx = self.server.ssl_ctx  # type: ignore[attr-defined]
        # register the RAW socket first so stop() can always unblock this
        # thread, and bound the handshake: a peer that connects and goes
        # silent must not pin a handler thread forever
        self.server.active.add(sock)  # type: ignore[attr-defined]
        if ssl_ctx is not None:
            # per-connection handshake in THIS handler thread, so a slow
            # (or hostile) handshaker never blocks the accept loop
            raw = sock
            try:
                sock.settimeout(TLS_HANDSHAKE_TIMEOUT_S)
                sock = ssl_ctx.wrap_socket(sock, server_side=True)
                sock.settimeout(None)
            except (OSError, ValueError) as e:
                log.warning("store TLS handshake failed: %s", e)
                self.server.active.discard(raw)
                return
            self.request = sock
            self.server.active.discard(raw)
            self.server.active.add(sock)  # type: ignore[attr-defined]
        try:
            if recv_exact(sock, 4) != MAGIC:
                return
            if token:
                # first frame must authenticate; anything else is refused
                # before it can touch the store
                req = recv_frame(sock)
                presented = req.get("token") or ""
                # compare digests of BYTES: compare_digest on str rejects
                # non-ASCII tokens with a TypeError
                if req.get("op") != "auth" or not hmac.compare_digest(
                        str(presented).encode(), token.encode()):
                    send_frame(sock, {"ok": False, "error": "RuntimeError",
                                      "message": "store auth failed"})
                    return
                send_frame(sock, {"ok": True})
            # every request-serving surface consults the admission gate
            # before dispatch: per-lane bounded concurrency + bounded
            # queues, typed sheds with a retry-after hint (see
            # resilience/overload.py). gate=None only when explicitly
            # disabled — the old-ungated-server behavior, byte for byte.
            gate: Optional[AdmissionGate] = \
                getattr(self.server, "gate", None)
            while True:
                req = recv_frame(sock)
                op = req.get("op")
                # per-op request counters (store_info "requests"): the
                # ground truth for "the primary served zero read-lane
                # traffic while the tree absorbed the storm"
                counts = getattr(self.server, "op_counts", None)
                if counts is not None and op:
                    counts[op] += 1
                if op in ("watch", "bulk_watch", "ship"):
                    # stream setup admits through the gate too: a storm
                    # of new watchers queues/sheds at its lane instead
                    # of spawning unbounded fan-out; the stream ticket
                    # is held for the STREAM's lifetime so lanes with a
                    # max_streams bound cap live fan-out, not just setup
                    ticket = None
                    if gate is not None:
                        try:
                            ticket = gate.admit(
                                op, req, client=self._gate_client(req),
                                stream=True)
                        except OverloadedError as e:
                            send_frame(sock, overloaded_response(e))
                            continue
                    try:
                        if op == "ship":
                            # WAL shipping (read replicas): the
                            # connection becomes a one-way record
                            # stream, like watch
                            self._serve_ship(sock, store, req)
                        else:
                            self._serve_watch(sock, store, req)
                    finally:
                        if gate is not None:
                            gate.release(ticket)
                    return  # streams never go back to req/resp
                ticket = None
                try:
                    if gate is not None:
                        ticket = gate.admit(op, req,
                                            client=self._gate_client(req))
                    try:
                        resp = self._dispatch(store, op, req)
                    finally:
                        if gate is not None:
                            gate.release(ticket)
                except OverloadedError as e:
                    resp = overloaded_response(e)
                except (ConflictError, NotFoundError, AdmissionError,
                        ShardUnavailableError, ReplicaReadOnlyError,
                        ReplicaLagError) as e:
                    resp = {"ok": False, "error": type(e).__name__,
                            "message": str(e)}
                except ConnectionError:
                    # transport-shaped failure inside dispatch (the
                    # shard_request/shard_crash fault points inject
                    # these): die like the link did, so the client's
                    # retry rules engage instead of its error handling
                    raise
                except Exception as e:  # noqa: BLE001 — report, keep serving
                    log.exception("store op %s failed", op)
                    resp = {"ok": False, "error": "RuntimeError",
                            "message": str(e)}
                try:
                    send_frame(sock, resp)
                except ValueError as e:
                    # oversize response (giant list): the size check fires
                    # before any bytes hit the socket, so the connection
                    # is still clean — report instead of dying silently
                    send_frame(sock, {"ok": False, "error": "RuntimeError",
                                      "message": str(e)})
        except (ConnectionError, OSError):
            pass  # client went away
        finally:
            self.server.active.discard(sock)  # type: ignore[attr-defined]

    def _gate_client(self, req: dict) -> str:
        """Flow identity for per-client fairness inside a lane: the
        client's self-assigned id header when present (one per
        RemoteClusterStore instance, stable across its pooled
        connections), else the peer address — old clients still get a
        flow of their own."""
        client = req.get("client")
        if client:
            return str(client)
        try:
            return str(self.client_address[0])
        except Exception:  # noqa: BLE001 — fairness only
            return ""

    def _admission_info(self) -> dict:
        """Per-lane admission table (vcctl status): inflight/streams/
        queued/sheds/deadline-expirations per lane, plus the configured
        bounds. An ungated server reports enabled=False with no lanes."""
        gate: Optional[AdmissionGate] = getattr(self.server, "gate", None)
        if gate is None or not gate.enabled:
            return {"ok": True, "enabled": False, "lanes": {}}
        return {"ok": True, "enabled": True, "lanes": gate.stats()}

    def _dispatch(self, store: ClusterStore, op: str, req: dict) -> dict:
        kind = req.get("kind")
        if op == "admission_info":
            return self._admission_info()
        # fencing tokens ride the frame; the authoritative store validates
        # them against ITS lease record (the deposed writer's view of its
        # own leadership is exactly what cannot be trusted client-side)
        fencing = req.get("fencing") or None
        if op in ("create", "update", "apply"):
            obj = getattr(store, op)(kind, decode(req["obj"]),
                                     fencing=fencing)
            return {"ok": True, "obj": encode(obj),
                    "applied_rv": self._applied_stamp(store)}
        if op == "delete":
            obj = store.delete(kind, req["name"], req.get("namespace"),
                               fencing=fencing)
            return {"ok": True, "obj": encode(obj),
                    "applied_rv": self._applied_stamp(store)}
        if op == "bulk_apply":
            # one frame, many objects, one journal batch (the durable
            # store fsyncs once for the wave); per-item results so one
            # rejected object costs that object, not the wave
            items = [(it["kind"], decode(it["obj"]),
                      it.get("verb", "apply")) for it in req["items"]]
            results = store.bulk_apply(items, fencing=fencing)
            if req.get("ack"):
                # ingest-wave mode: the caller doesn't want the applied
                # objects back — respond with counts + sparse errors, so
                # a 10k-pod wave costs no result encode/decode at all
                errors = {str(i): {"error": type(r).__name__,
                                   "message": str(r)}
                          for i, r in enumerate(results)
                          if isinstance(r, Exception)}
                return {"ok": True, "n": len(results), "errors": errors,
                        "applied_rv": self._applied_stamp(store)}
            out = []
            for res in results:
                if isinstance(res, Exception):
                    out.append({"error": type(res).__name__,
                                "message": str(res)})
                else:
                    out.append({"obj": encode(res)})
            return {"ok": True, "results": out,
                    "applied_rv": self._applied_stamp(store)}
        if op == "get":
            with store.locked():
                rv = applied_rv_of(store)
                obj = store.get(kind, req["name"], req.get("namespace"))
            return {"ok": True, "obj": encode(obj), "applied_rv": rv}
        if op == "list":
            # rv stamped under the SAME lock hold as the read, so the
            # response names the exact store version it reflects — a
            # mirror can order a (possibly retried) list against the rv
            # high-water mark of its concurrent watch stream. min_rv on
            # the authoritative store is trivially satisfied: every rv
            # a client can legally hold was minted here. (A replica's
            # handler overrides this with real rv-bounded blocking.)
            with store.locked():
                rv = applied_rv_of(store)
                objs = store.list(kind, req.get("namespace"),
                                  req.get("label_selector"),
                                  req.get("name_glob"))
            return {"ok": True, "objs": [encode(o) for o in objs],
                    "applied_rv": rv}
        if op == "store_info":
            # replica handshake: shape + current rv(s) + whether a WAL
            # lineage exists to ship. recovered/pid ride along for the
            # shard-worker supervisor's liveness polls and vcctl status
            import os as _os
            shards = getattr(store, "shards", None)
            with store.locked():
                rv = applied_rv_of(store)
            counts = getattr(self.server, "op_counts", None)
            return {"ok": True, "rv": rv,
                    "shards": len(shards) if shards is not None else 1,
                    "durable": getattr(store, "data_dir", None)
                    is not None,
                    "ship_capable": getattr(store, "data_dir", None)
                    is not None or bool(getattr(store, "ship_capable",
                                                False)),
                    "requests": dict(counts) if counts is not None else {},
                    "recovered": getattr(store, "recovered_records", 0),
                    "pid": _os.getpid()}
        if op == "bootstrap":
            # newest valid on-disk snapshot (replica seed); the WAL
            # records past its rv arrive over the ship stream
            src = _ship_source(store, req.get("shard"))
            rv, state = src.newest_snapshot_state()
            return {"ok": True, "rv": rv, "state": state}
        if op == "fence_check":
            # the shard-worker fencing RPC: a worker owning a non-lease
            # shard validates a write's fencing token against the
            # arbiter worker's lease record (the ``leases`` bucket is
            # pinned to shard 0). FencedError re-raises typed
            # client-side, exactly like a fenced write would.
            store._check_fence(req.get("fencing") or None)
            return {"ok": True}
        if op == "topology":
            return self._topology(store)
        if op == "announce_read_endpoint":
            # a replica (possibly deep in a tree) registers itself so
            # topology can hand read traffic to the read tier; advisory
            # — clients that never ask keep reading here
            table = getattr(self.server, "read_endpoints", None)
            if table is not None and req.get("endpoint"):
                table[str(req["endpoint"])] = {
                    "depth": int(req.get("depth", 1)),
                    "shards": int(req.get("shards", 1)),
                }
            return {"ok": True}
        if op == "ping":
            return {"ok": True}
        if op == "replica_info":
            # a quiet typed refusal: vcctl probes every hop of an
            # upstream chain with this op to find where the tree ends,
            # and hitting the primary is the expected terminal case
            return {"ok": False, "error": "RuntimeError",
                    "message": "not a replica endpoint"}
        if op == "auth":
            return {"ok": True}  # token-less server: auth is a no-op
        raise RuntimeError(f"unknown op {op!r}")

    def _applied_stamp(self, store) -> object:
        """rv(s) as of (at least) this mutation's commit, stamped on the
        response so the writer can demand read-your-writes from a
        replica via ``min_rv`` on its next read. A shard WORKER stamps a
        ``{shard: rv}`` map keyed by its shard tag — the proc router
        relays worker responses verbatim, and a bare scalar would be
        ambiguous once it crosses that hop."""
        with store.locked():
            rv = applied_rv_of(store)
        tag = getattr(self.server, "shard_tag", None)
        if tag is not None and not isinstance(rv, dict):
            return {str(tag): rv}
        return rv

    def _topology(self, store: ClusterStore) -> dict:
        """The shard map a direct-routing client asks for once: shard
        count plus per-shard endpoints it may connect to directly. A
        single-store server (and the in-process ShardRouter, whose
        shards share its one process) advertises NO direct endpoints —
        the client then keeps router-only routing. The multi-process
        router (client/shardproc.py) overrides with real worker
        endpoints."""
        shards = getattr(store, "n_shards", 1)
        table = getattr(self.server, "read_endpoints", {}) or {}
        return {"ok": True, "n_shards": int(shards), "endpoints": [],
                "read_endpoints": [
                    {"endpoint": ep, "depth": meta.get("depth", 1),
                     "shards": meta.get("shards", 1)}
                    for ep, meta in table.items()]}

    def _serve_watch(self, sock: socket.socket, store: ClusterStore,
                     req: dict) -> None:
        """Stream events for the requested kinds until the peer leaves.

        The listener enqueues under the store lock and a writer loop
        drains, so a slow or stuck watcher never blocks store writes
        (client-go's watch buffers give the reference the same
        isolation)."""
        kinds = req.get("kinds") or [req.get("kind")]
        bad = [k for k in kinds if k not in KINDS]
        if bad:
            # refuse BEFORE subscribing anything: a partially-subscribed
            # failed request would leak listeners that enqueue forever
            send_frame(sock, {"ok": False, "error": "RuntimeError",
                              "message": f"unknown watch kinds {bad}"})
            return
        replay = bool(req.get("replay", True))
        since = req.get("since") or None  # {kind: rv} = resume request
        # bulk_watch: same subscription semantics, but events coalesce
        # into batched frames (pump_watch) — the high-churn ingest path
        batch_max = WATCH_BATCH_MAX if req.get("op") == "bulk_watch" else 1
        # a shard-worker process serving ONE member lineage stamps its
        # shard index into every event/synced frame, so the multi-process
        # router can relay frames verbatim and a direct-routed client's
        # per-shard resume marks attribute events without re-tagging
        shard = getattr(self.server, "shard_tag", None)
        journal: Optional[EventJournal] = getattr(self.server, "journal",
                                                  None)
        # delta negotiation: additive and fail-safe — the client must ask
        # (delta: true) AND this server must carry an encoder; otherwise
        # the stream is plain object frames exactly as before
        enc: Optional[DeltaEncoder] = getattr(self.server, "delta_enc",
                                              None)
        delta = bool(req.get("delta")) and enc is not None
        # replay adds (store.watch replay / journal resume) are delivered
        # synchronously under the subscribe hold, BEFORE this flips: they
        # stay object frames without ks, because the shared encoder's
        # counters must only move for live events every delta stream sees
        sync_done = [False]
        # bounded queue + send timeout: a peer that stalls without closing
        # (TCP zero window) otherwise blocks the writer in sendall forever
        # while the listeners keep enqueueing — unbounded memory per stuck
        # watcher. On overflow the watcher is dropped (client-go's watch
        # buffers terminate slow watchers the same way); the client sees
        # the close and treats it as a broken stream (resume-then-resync).
        events: "queue.Queue" = queue.Queue(maxsize=WATCH_QUEUE_MAX)
        overflowed = threading.Event()
        sock.settimeout(WATCH_SEND_TIMEOUT_S)

        def enqueue(payload) -> None:
            if overflowed.is_set():
                return  # watcher already condemned: stop buffering
            try:
                events.put_nowait(payload)
            except queue.Full:
                overflowed.set()

        def listener_for(kind):
            def listener(event, obj, old):
                # under the store lock: store._rv is this event's rv
                if delta and sync_done[0]:
                    payload = enc.payload(kind, shard, store._rv,
                                          event, obj, old)
                    try:
                        faults.fire("delta_frame")
                    except Exception:  # noqa: BLE001 — injected drop
                        # frame lost AFTER its ks was consumed: the
                        # client sees the gap on the next frame and
                        # falls back typed (delta_gap)
                        return
                    enqueue(payload)
                    try:
                        faults.fire("delta_frame_dup")
                    except Exception:  # noqa: BLE001 — injected dup
                        enqueue(payload)  # same ks twice: typed refusal
                    return
                payload = {"stream": "event", "kind": kind,
                           "rv": store._rv, "event": event,
                           "obj": encode(obj),
                           "old": encode(old) if old is not None else None}
                if shard is not None:
                    payload["shard"] = shard
                enqueue(payload)
            return listener

        listeners = []
        try:
            # subscribe (and, on resume, read the journal) under ONE hold
            # of the store lock: no event can fall between the replayed
            # window and the live stream, and the synced rv map is exact.
            # put_nowait throughout: a replay bigger than the whole queue
            # has already condemned this watcher, and a blocking put would
            # deadlock (nothing drains yet).
            gap_kind = None
            with store.locked():
                if since is not None:
                    for kind in kinds:
                        missed = journal.since(
                            kind, since_rv(since.get(kind), shard)) \
                            if journal is not None else None
                        if missed is None:
                            gap_kind = kind
                            break
                        for rv, event, obj, old in missed:
                            payload = {"stream": "event", "kind": kind,
                                       "rv": rv, "event": event,
                                       "obj": encode(obj),
                                       "old": encode(old)
                                       if old is not None else None}
                            if shard is not None:
                                payload["shard"] = shard
                            enqueue(payload)
                if gap_kind is None:
                    for kind in kinds:
                        listener = listener_for(kind)
                        listeners.append((kind, listener))
                        store.watch(kind, listener,
                                    replay=replay and since is None)
                    sync_done[0] = True
                    sync_payload = {
                        "stream": "synced",
                        "rv": {k: ({str(shard): store.last_event_rv(k)}
                                   if shard is not None
                                   else store.last_event_rv(k))
                               for k in kinds}}
                    if delta:
                        # table snapshot + per-kind ks baselines, atomic
                        # with the subscription under this same hold
                        sync_payload.update(enc.synced_fields(kinds, shard))
                    enqueue(sync_payload)
            if gap_kind is not None:
                send_frame(sock, {
                    "ok": False, "error": "ResumeGapError",
                    "message": f"resume window for {gap_kind!r} no longer "
                               f"covers rv {since.get(gap_kind)}"})
                return
            pump_watch(sock, events, overflowed, batch_max=batch_max)
            log.warning("watch stream overflowed %d events; dropping the "
                        "slow watcher", WATCH_QUEUE_MAX)
            try:
                from ..metrics import metrics
                metrics.store_watch_dropped_total.inc()
            except Exception:  # noqa: BLE001 — accounting only
                pass
        except socket.timeout:
            # the other slow-watcher shape: a peer that stalls without
            # closing (TCP zero window) blocks sendall past the timeout
            log.warning("watch send stalled > %.0fs; dropping the slow "
                        "watcher", WATCH_SEND_TIMEOUT_S)
            try:
                from ..metrics import metrics
                metrics.store_watch_dropped_total.inc()
            except Exception:  # noqa: BLE001 — accounting only
                pass
        except (ConnectionError, OSError, ValueError):
            pass  # peer went away
        finally:
            for kind, listener in listeners:
                store.unwatch(kind, listener)

    def _serve_ship(self, sock: socket.socket, store: ClusterStore,
                    req: dict) -> None:
        """Stream WAL records committed after ``since_rv`` to a replica:
        sealed segments + the already-durable tail replayed off disk
        (``read_frames``' CRC/torn-tail discipline — a torn record and
        everything after it never ships), then live records as they
        commit, coalesced into batched frames. Refuses with
        ResumeGapError when ``since_rv`` predates the retained-segment
        window — the replica must close that hole with a fresh snapshot
        bootstrap, never by skipping. The ``wal_ship`` fault point fires
        at every frame send (arm ``exc:`` to drop the link mid-segment,
        ``exc:exit`` to SIGKILL the primary there); the replica's
        record-continuity check is the backstop for anything this stream
        could lose.

        A REPLICA serving this op (fan-out trees) replays from its
        mirror shard's re-ship ring instead of disk segments, fires the
        ``ship_relay`` fault point instead of ``wal_ship``, and counts
        the absorbed traffic in its ``ship_served`` ledger — same
        protocol, same lock-hold no-gap guarantee, different source."""
        from .durable import _segment_paths, read_frames
        try:
            src = _ship_source(store, req.get("shard"))
        except Exception as e:  # noqa: BLE001 — refuse, keep the conn clean
            name = type(e).__name__
            send_frame(sock, {"ok": False,
                              "error": name if name in _ERRORS
                              else "RuntimeError", "message": str(e)})
            return
        fault_point = getattr(self.server, "ship_fault_point", "wal_ship")
        replica = getattr(self.server, "replica", None)

        def account(n: int) -> None:
            if replica is None:
                return
            replica.ship_served["records"] += n
            try:
                from ..metrics import metrics as _m
                _m.replica_ship_served_records_total.inc(n)
            except Exception:  # noqa: BLE001 — accounting only
                pass

        since_rv = int(req.get("since_rv", 0))
        events: "queue.Queue" = queue.Queue(maxsize=WATCH_QUEUE_MAX)
        overflowed = threading.Event()
        sock.settimeout(WATCH_SEND_TIMEOUT_S)

        def on_record(rec) -> None:
            if overflowed.is_set():
                return
            try:
                events.put_nowait(rec)
            except queue.Full:
                overflowed.set()

        with src._lock:
            floor = src.ship_floor()
            if since_rv < floor:
                send_frame(sock, {
                    "ok": False, "error": "ResumeGapError",
                    "message": f"retained WAL window starts after rv "
                               f"{floor}; cannot resume from {since_rv}"})
                return
            # registration + segment listing + rv capture under ONE lock
            # hold: every record <= live_from is fully flushed to these
            # segments, every record > live_from arrives via the hook —
            # no record can fall between disk replay and live tail
            live_from = src._rv
            if getattr(src, "data_dir", None) is not None:
                segments = _segment_paths(src.data_dir)
                pending: Optional[list] = None
            else:
                # mirror ship source: the bounded re-ship ring stands in
                # for disk segments, captured under the SAME lock hold
                segments = []
                pending = src.ship_records(since_rv, live_from)
            src.add_ship_listener(on_record)
        if replica is not None:
            replica.ship_served["streams"] += 1
            replica._ship_stream_delta(1)
        try:
            send_frame(sock, {"ok": True, "rv": live_from})
            batch: list = []

            def flush() -> None:
                if batch:
                    faults.fire(fault_point)
                    send_frame(sock, {"stream": "wal", "recs": batch,
                                      "prv": live_from})
                    account(len(batch))
                    del batch[:]

            for path in segments:
                records, _, _torn = read_frames(path)
                for rec in records:
                    if since_rv < int(rec["rv"]) <= live_from:
                        batch.append(rec)
                        if len(batch) >= SHIP_BATCH_MAX:
                            flush()
            for rec in pending or ():
                batch.append(rec)
                if len(batch) >= SHIP_BATCH_MAX:
                    flush()
            flush()
            send_frame(sock, {"stream": "ship_synced", "rv": live_from})
            while not overflowed.is_set():
                try:
                    rec = events.get(timeout=10.0)
                except queue.Empty:
                    # heartbeat carries the primary's current rv so an
                    # idle replica can report zero lag (and a lagging
                    # one honest lag) without any commit traffic
                    send_frame(sock, {"stream": "heartbeat",
                                      "prv": src._rv})
                    continue
                recs = [rec]
                while len(recs) < SHIP_BATCH_MAX:
                    try:
                        recs.append(events.get_nowait())
                    except queue.Empty:
                        break
                faults.fire(fault_point)
                send_frame(sock, {"stream": "wal", "recs": recs,
                                  "prv": src._rv})
                account(len(recs))
            log.warning("ship stream overflowed %d records; dropping the "
                        "slow replica (it resumes at its applied rv)",
                        WATCH_QUEUE_MAX)
        except socket.timeout:
            log.warning("ship send stalled > %.0fs; dropping the slow "
                        "replica", WATCH_SEND_TIMEOUT_S)
        except (ConnectionError, OSError, ValueError):
            pass  # replica went away; it resumes from its applied rv
        finally:
            src.remove_ship_listener(on_record)
            if replica is not None:
                replica._ship_stream_delta(-1)


class StoreServer:
    """Serve a ClusterStore on host:port (TCP, daemon threads).

    ``token``: shared-secret auth — every connection must open with an
    auth frame carrying it (the analog of the API server's bearer-token
    check). REQUIRED for non-loopback binds: the store holds Secrets and
    the leader-election lease; standalone refuses to expose it
    unauthenticated.

    ``tls_cert``/``tls_key``: serve TLS — the reference's equivalent seam
    (the k8s API server) is always TLS, and without it the token and
    every payload (ssh-keypair Secrets, the HA lease) cross the network
    in clear. ``tls_client_ca`` additionally requires client
    certificates (mTLS). Non-loopback deployments should set these (or
    run inside a network layer that encrypts, e.g. a service mesh);
    webhooks.server.generate_self_signed_cert bootstraps a dev pair.

    ``gate``: the overload-admission gate every request consults before
    dispatch (resilience/overload.py). Defaults to a gate with the
    fail-safe generous lane limits — an unloaded deployment is
    protocol-indistinguishable from an ungated one, an overloaded one
    sheds ``read`` first and ``system`` never. Pass an
    ``AdmissionGate(enabled=False)`` to run ungated (the pre-gate
    behavior, for wire-compat tests against "old" servers)."""

    #: request handler; the shard router (client/sharded.py) subclasses
    #: with shard-aware watch serving over the same wire protocol
    handler_class = _Handler

    def __init__(self, store: ClusterStore, host: str = "127.0.0.1",
                 port: int = 0, token: Optional[str] = None,
                 tls_cert: Optional[str] = None,
                 tls_key: Optional[str] = None,
                 tls_client_ca: Optional[str] = None,
                 gate: Optional[AdmissionGate] = None):
        class _Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        ssl_ctx = None
        if tls_cert and tls_key:
            import ssl

            ssl_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ssl_ctx.load_cert_chain(tls_cert, tls_key)
            if tls_client_ca:
                ssl_ctx.verify_mode = ssl.CERT_REQUIRED
                ssl_ctx.load_verify_locations(tls_client_ca)
        elif tls_cert or tls_key or tls_client_ca:
            # a half-configured pair must not silently serve plaintext
            raise ValueError(
                "store TLS needs BOTH tls_cert and tls_key "
                "(tls_client_ca additionally needs them)")

        self._server = _Server((host, port), self.handler_class)
        self._server.store = store  # type: ignore[attr-defined]
        self._server.token = token or ""  # type: ignore[attr-defined]
        self._server.ssl_ctx = ssl_ctx  # type: ignore[attr-defined]
        # overload-admission gate, on by default (generous limits); an
        # enabled=False gate serves ungated and the handler skips it
        self.gate = gate if gate is not None else AdmissionGate()
        self._server.gate = (  # type: ignore[attr-defined]
            self.gate if self.gate.enabled else None)
        # resume window for reconnecting watchers (see EventJournal;
        # the shard router builds one journal per shard instead)
        self.journal = self._make_journal(store)
        self._server.journal = self.journal  # type: ignore[attr-defined]
        # delta-watch encoder for this store lineage: one interning table
        # + per-kind frame counters shared by every delta: true stream
        # (the shard ROUTER serves watches through its hub's per-shard
        # encoders instead — _RouterHandler overrides _serve_watch)
        self._server.delta_enc = DeltaEncoder()  # type: ignore[attr-defined]
        # per-op request counters (store_info "requests") and the
        # announced read-tier endpoints (topology "read_endpoints")
        self._server.op_counts = (  # type: ignore[attr-defined]
            collections.Counter())
        self._server.read_endpoints = {}  # type: ignore[attr-defined]
        # live connection sockets, so stop() drops watch streams too
        # (daemon handler threads outlive server_close otherwise and
        # clients would never learn the server is gone)
        self._server.active = set()  # type: ignore[attr-defined]
        self.host, self.port = self._server.server_address
        self._thread: Optional[threading.Thread] = None

    def _make_journal(self, store):
        return EventJournal(store)

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def start(self) -> "StoreServer":
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="store-server")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self.journal.close()
        for sock in list(self._server.active):  # type: ignore[attr-defined]
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
        if self._thread is not None:
            self._thread.join(timeout=5)
