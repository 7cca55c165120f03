"""RemoteClusterStore: the ClusterStore surface over a StoreServer socket.

Gives every store consumer — vcctl, SchedulerCache, controllers, leader
election — the same interface against a deployed control plane that the
in-memory ClusterStore gives them in-process (the reference's client-go
clientset + informer factory against the API server,
pkg/scheduler/cache/cache.go:319-402). CRUD is synchronous request/
response on one mutex-guarded connection; each watch() opens its own
streaming connection, applies the replay inline (list-then-watch: the
caller returns with state loaded, exactly like the in-memory store), then
keeps delivering live events from a reader thread. All listener dispatch
happens under self.locked(), so a consumer holding the lock (the
scheduler cache's snapshot) sees a frozen mirror.

Optimistic concurrency travels the wire: the server compares
resource_version on update and ConflictError/NotFoundError/AdmissionError
re-raise client-side as the same classes — which is what makes the lease
CAS of utils.leader_election work across processes.

The wire is the JAX package's: this client talks to either package's
StoreServer, router, shard worker and replica. The topology and
read-tier branches route to sharded workers and read replicas when a
server announces them (client/sharded.py, shardproc.py, replica.py).
"""

from __future__ import annotations

import copy
import json
import logging
import os
import random
import socket
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ..resilience.faultinject import faults
from ..resilience.overload import (
    OverloadedError, RetryBudget, RetryBudgetExhausted, classify,
    current_lane,
)
from .codec import (
    DELTA_VOCAB_MAX, decode, delta_resolve, encode, field_default,
    known_fields, object_key,
)
from .server import (
    MAGIC, raise_remote, recv_frame, recv_frame_sized, remote_error,
    send_frame,
)
from .sharded import shard_for
from .store import ResumeGapError, ShardUnavailableError, _key

log = logging.getLogger(__name__)

#: bulk_apply chunking: an oversized wave splits into frames of at most
#: this many encoded bytes / items each (one journal batch per chunk),
#: so a 50k-pod wave can never produce a single multi-MB frame that
#: trips the server's cap or stalls every other request behind it
BULK_CHUNK_BYTES = 8 << 20
BULK_CHUNK_ITEMS = 2048

#: wire ops whose responses carry an ``applied_rv`` stamp this client
#: folds into its read-your-writes high-water mark (applied_hwm)
_MUTATING_WIRE_OPS = ("create", "update", "apply", "delete", "bulk_apply")


class DeltaFallbackError(ValueError):
    """Typed refusal of a delta watch frame (the reason is ``args[0]``:
    ``delta_gap`` / ``vocab_overflow`` / ``unknown_field`` /
    ``schema_skew``). A ValueError so the stream reader's existing
    broken-stream handling catches it: the stream resumes through the
    normal journal-replay path — with the delta ask OFF — from a
    high-water mark the refused frame never advanced, so the fallback
    loses and repeats nothing."""


class RemoteClusterStore:
    """See module docstring. Deployment-facing knobs:

    - ``token``: shared-secret auth presented on every connection
      (defaults to $VOLCANO_STORE_TOKEN so vcctl and operator scripts
      pick it up without plumbing).
    - ``on_watch_failure``: called once when a watch stream dies beyond
      repair. A broken stream first tries to RESUME in place: reconnect
      with exponential backoff + jitter and ask the server to replay from
      this client's per-kind resource_version high-water mark (the
      server's EventJournal — client-go's reflector re-watch). Only when
      that fails — server gone past ``watch_resume_window_s``, journal
      window lost (ResumeGapError), or a listener itself blew up — does
      the crash-only contract fire: log CRITICAL, set ``watch_failed``,
      call the callback once so a supervisor can restart with a fresh
      snapshot (HA standbys cover the gap).
    - ``retry_attempts``/``retry_base_s``/``retry_cap_s``: idempotent-op
      retry budget (see _request) — defaults ride out a ~3 s server
      restart.
    - ``pool_size``: request connections kept PER ENDPOINT (default 1,
      the historical single-socket behavior). With N > 1, up to N
      requests are in flight concurrently per endpoint — the seam that
      lets fanned-out controller workers ingest in parallel instead of
      queueing behind one socket, and that keeps direct shard
      connections from serializing through the router's pool.
    - ``direct_routing`` (default True): ask the server for its shard
      ``topology`` once (lazily, on first routed op) and, when it
      names per-shard worker endpoints (the multi-process router,
      client/shardproc.py), send single-key CRUD/get straight to the
      owning shard — ``crc32(kind/ns/name) % N`` is deterministic and
      client-visible, so the router hop survives only for cross-shard
      ops (list, bulk waves, bulk_watch merge). Old servers without the
      op, single-process topologies, and TLS deployments (workers are
      loopback-plaintext) all degrade gracefully to router-only
      routing; so does any direct request whose connection fails before
      it could have been applied.
    - ``direct_watch`` (default False): also open watch/bulk_watch
      streams per shard worker directly — events bypass the router
      entirely; each stream resumes against its own worker's journal.
    """

    def __init__(self, address: str, connect_timeout: float = 5.0,
                 token: Optional[str] = None,
                 on_watch_failure: Optional[Callable[[], None]] = None,
                 tls_ca: Optional[str] = None,
                 tls_cert: Optional[str] = None,
                 tls_key: Optional[str] = None,
                 retry_attempts: int = 5,
                 retry_base_s: float = 0.1,
                 retry_cap_s: float = 2.0,
                 watch_resume: bool = True,
                 watch_resume_window_s: float = 30.0,
                 watch_backoff_cap_s: float = 2.0,
                 pool_size: int = 1,
                 direct_routing: bool = True,
                 direct_watch: bool = False,
                 lane: Optional[str] = None,
                 op_deadline_ms: float = 0.0,
                 retry_budget: Optional[RetryBudget] = None,
                 delta_watch: bool = False,
                 read_from_replicas: bool = False):
        host, _, port = address.rpartition(":")
        self.host = host or "127.0.0.1"
        self.port = int(port)
        self.connect_timeout = connect_timeout
        self.token = token if token is not None \
            else os.environ.get("VOLCANO_STORE_TOKEN", "")
        # TLS to a StoreServer serving it (see its docstring): tls_ca is
        # the CA bundle the SERVER cert must verify against (also
        # $VOLCANO_STORE_CA); tls_cert/tls_key present a client
        # certificate for mTLS servers
        self.tls_ca = tls_ca if tls_ca is not None \
            else os.environ.get("VOLCANO_STORE_CA") or None
        self.tls_cert = tls_cert
        self.tls_key = tls_key
        self._ssl_ctx = None
        if self.tls_ca or self.tls_cert:
            import ssl

            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
            ctx.verify_mode = ssl.CERT_REQUIRED
            if self.tls_ca:
                # CA-pinned: the operator named the exact CA this server
                # must chain to, and cluster-internal addresses are
                # usually bare IPs — hostname matching adds nothing the
                # pin doesn't already guarantee
                ctx.check_hostname = False
                ctx.load_verify_locations(self.tls_ca)
            else:
                # client-cert-only config: falls back to the SYSTEM trust
                # store, where hostname verification is the only thing
                # stopping any public-CA cert for any host from
                # impersonating the store — keep it on (default True)
                ctx.load_default_certs()
            if self.tls_cert:
                ctx.load_cert_chain(self.tls_cert, self.tls_key)
            self._ssl_ctx = ctx
        self.on_watch_failure = on_watch_failure
        self.watch_failed = False
        self.retry_attempts = retry_attempts
        self.retry_base_s = retry_base_s
        self.retry_cap_s = retry_cap_s
        self.watch_resume = watch_resume
        self.watch_resume_window_s = watch_resume_window_s
        self.watch_backoff_cap_s = watch_backoff_cap_s
        self.watch_resumes = 0   # successful in-place stream resumes
        self._lock = threading.RLock()   # local mirror/listener lock
        # per-kind {shard: rv} high-water marks across ALL of this
        # client's watch streams — the causal floor a (possibly retried)
        # list response must not fall behind, and the catch-up target
        # wait_stream_applied blocks on
        self._kind_hwm: Dict[str, Dict[str, int]] = {}
        self._hwm_cv = threading.Condition(self._lock)
        #: applied_rv of the most recent list response (staleness at a
        #: glance for CLIs/dashboards)
        self.last_list_applied_rv = None
        # request-connection pools, one PER ENDPOINT (the router, plus —
        # direct-routed — each shard worker): idle sockets ready for
        # checkout, a live count capping concurrency at pool_size per
        # endpoint, and the full set so close() can unblock an in-flight
        # recv
        self.pool_size = max(1, int(pool_size))
        self._pool_cv = threading.Condition()
        self._default_ep = (self.host, self.port)
        self._pools: Dict[tuple, dict] = {}
        self._conns: set = set()
        # direct shard routing (see class docstring): topology is
        # fetched lazily, once; empty endpoints = router-only
        self.direct_routing = direct_routing
        self.direct_watch = direct_watch
        self._topo_lock = threading.Lock()
        self._topo_checked = False
        self._n_shards = 1
        self._shard_endpoints: List[tuple] = []
        self.direct_requests = 0    # requests sent straight to a shard
        self.direct_fallbacks = 0   # direct failures re-run via router
        # -- read-tier routing (replica fan-out trees) ------------------
        # opt-in: topology's read_endpoints table names announced
        # replicas; idempotent reads prefer the deepest one, stamped
        # min_rv=applied_hwm() so read-your-writes holds, with typed/
        # unreachable fallback to the primary
        self.read_from_replicas = bool(read_from_replicas)
        self._read_endpoints: List[dict] = []
        self._read_client: Optional["RemoteClusterStore"] = None
        self._read_cooldown = 0.0
        self.read_tier_reads = 0      # reads served by the read tier
        self.read_tier_fallbacks = 0  # reads that fell back primary-side
        # rv high-water mark across this client's OWN acked mutations
        # ({shard: rv}; "0" for an unsharded primary) — the min_rv bound
        # a read-your-writes read against a replica must demand
        self._applied_hwm: Dict[str, int] = {}
        self._applied_hwm_mapform = False
        self._watch_threads: List[threading.Thread] = []
        self._watch_socks: List[socket.socket] = []
        self._closed = False
        self._stop_event = threading.Event()  # wakes backoff sleeps
        # -- overload protection (resilience/overload.py) ---------------
        # every request carries additive prio/client headers (and, with
        # op_deadline_ms set, a deadline_ms header the server enforces);
        # old servers ignore unknown fields, so interop is unchanged.
        # ``lane`` is this client's default classification — strong
        # classifications (fenced => system, leases => system, bulk
        # waves => bulk) always win over it.
        self.lane = lane
        self.op_deadline_ms = float(op_deadline_ms or 0.0)
        self.retry_budget = retry_budget if retry_budget is not None \
            else RetryBudget()
        import uuid
        self.client_id = uuid.uuid4().hex[:12]  # flow-fairness identity
        self.overload_retries = 0      # Overloaded responses retried
        self.overload_sheds_seen = 0   # OverloadedError surfaced typed
        # -- delta watch (client/codec.py delta dialect) ----------------
        # opt-in: ask every watch stream for column-patch frames and
        # apply them straight onto the mirrored objects; any frame the
        # dialect can't express — or any consistency break — falls back
        # typed to the object path (fail-safe default: off)
        self.delta_watch = bool(delta_watch)
        self.delta_vocab_max = DELTA_VOCAB_MAX
        #: cumulative across this client's streams, read by the
        #: Scheduler's delta accounting (scheduler.py): wire frames on
        #: delta streams, patch events applied, fields written, wire
        #: bytes by mode, decode-vs-apply ms split, peak table size,
        #: and typed fallback counts by reason
        self.delta_stats: Dict[str, Any] = {
            "frames": 0, "events": 0, "fields": 0,
            "bytes_delta": 0, "bytes_object": 0,
            "decode_ms": 0.0, "apply_ms": 0.0,
            "vocab": 0, "fallbacks": {}}

    # -- plumbing -----------------------------------------------------------

    def _connect(self, endpoint: Optional[tuple] = None) -> socket.socket:
        host, port = endpoint or self._default_ep
        sock = socket.create_connection((host, port),
                                        timeout=self.connect_timeout)
        if self._ssl_ctx is not None:
            sock = self._ssl_ctx.wrap_socket(
                sock, server_hostname=host)
        sock.settimeout(None)
        sock.sendall(MAGIC)
        if self.token:
            send_frame(sock, {"op": "auth", "token": self.token})
            resp = recv_frame(sock)
            if not resp.get("ok"):
                sock.close()
                raise_remote(resp)
        return sock

    def _pool(self, ep: tuple) -> dict:
        # caller holds self._pool_cv
        pool = self._pools.get(ep)
        if pool is None:
            pool = self._pools[ep] = {"idle": [], "n": 0}
        return pool

    def _acquire_conn(self, ep: tuple) -> Optional[socket.socket]:
        """Check a request connection out of the endpoint's pool: an
        idle socket, or None with a slot reserved (the caller connects
        outside the pool lock). Blocks while pool_size requests are in
        flight TO THAT ENDPOINT — direct shard traffic never queues
        behind the router's sockets."""
        with self._pool_cv:
            while True:
                if self._closed:
                    raise ConnectionError("store client closed")
                pool = self._pool(ep)
                if pool["idle"]:
                    return pool["idle"].pop()
                if pool["n"] < self.pool_size:
                    pool["n"] += 1
                    return None
                self._pool_cv.wait(0.1)

    def _release_slot(self, ep: tuple) -> None:
        with self._pool_cv:
            self._pool(ep)["n"] -= 1
            self._pool_cv.notify()

    def _drop_conn(self, sock: socket.socket) -> None:
        """A connection died mid-request: close it, keep the slot (the
        retry loop reconnects into it)."""
        with self._pool_cv:
            self._conns.discard(sock)
        try:
            sock.close()
        except OSError:
            pass

    def _checkin_conn(self, ep: tuple, sock: socket.socket) -> None:
        with self._pool_cv:
            if self._closed:
                self._conns.discard(sock)
                self._pool(ep)["n"] -= 1
            else:
                self._pool(ep)["idle"].append(sock)
            self._pool_cv.notify()
        if self._closed:
            try:
                sock.close()
            except OSError:
                pass

    # -- direct shard routing ------------------------------------------------

    def _ensure_topology(self) -> None:
        """Fetch the server's shard topology ONCE (lazily): when it
        names per-shard worker endpoints, single-key ops route straight
        to the owning shard. Servers without the op (pre-topology), ok
        responses without endpoints (single process — the in-process
        router, a plain store, a replica), and TLS sessions (workers
        speak loopback plaintext) all leave router-only routing in
        place."""
        if self._topo_checked:
            return
        with self._topo_lock:
            if self._topo_checked:
                return
            eps: List[tuple] = []
            raw: List[str] = []
            n = 1
            if (self.direct_routing or self.read_from_replicas) \
                    and self._ssl_ctx is None:
                try:
                    resp = self._request({"op": "topology"})
                    n = int(resp.get("n_shards", 1))
                    raw = resp.get("endpoints") or []
                    with self._lock:
                        self._read_endpoints = \
                            resp.get("read_endpoints") or []
                    if self.direct_routing and n > 1 and len(raw) == n:
                        for addr in raw:
                            host, _, port = addr.rpartition(":")
                            eps.append((host or "127.0.0.1", int(port)))
                except Exception:  # noqa: BLE001 — old server: no topology
                    eps = []
            if eps:
                self._n_shards = n
                self._shard_endpoints = eps
                log.info("store topology: %d shards, direct routing to "
                         "%s", n, raw)
            self._topo_checked = True

    def _endpoint_for(self, kind: str, key: str) -> Optional[tuple]:
        self._ensure_topology()
        if not self._shard_endpoints:
            return None
        return self._shard_endpoints[
            shard_for(kind, key, self._n_shards)]

    def _routed_request(self, kind: str, key: str, payload: dict) -> dict:
        """A single-key op: straight to the owning shard worker when the
        topology names one, with graceful fallback to the router when
        the direct attempt fails without possibly having been applied
        (a send that completed on a non-idempotent, non-conditional op
        must NOT be blindly replayed through the router)."""
        ep = self._endpoint_for(kind, key)
        if ep is None:
            return self._request(payload)
        try:
            resp = self._request(payload, endpoint=ep)
        except (ConnectionError, OSError) as e:
            if getattr(e, "_sent_unsafe", False):
                raise
            self.direct_fallbacks += 1
            log.warning("direct shard request to %s failed (%s: %s); "
                        "falling back to the router", ep,
                        type(e).__name__, e)
            return self._request(payload)
        self.direct_requests += 1
        return resp

    def _classify(self, payload: dict) -> str:
        """Lane for one request: the strong classifications (fenced
        write / lease traffic => system, bulk wave => bulk) win; then
        any ambient LaneStore hint or this client's default lane; then
        op shape (see resilience/overload.classify)."""
        return classify(payload.get("op"), kind=payload.get("kind"),
                        fencing=payload.get("fencing"),
                        prio=payload.get("prio") or current_lane()
                        or self.lane)

    def _request(self, payload: dict,
                 endpoint: Optional[tuple] = None) -> dict:
        """One request with the full client-side overload discipline on
        top of the transport layer (_request_once): stamp the additive
        ``prio``/``client`` headers (and ``deadline_ms`` when a per-op
        budget is configured), and on a typed Overloaded shed HONOR the
        server's retry-after hint — but cap retries with the global
        retry budget (~10% of recent request volume) so a shedding
        server never faces a retry storm that amplifies the outage.
        ``system``-lane ops (lease renewal, fenced writes) bypass the
        budget: giving up on the lease IS the outage."""
        lane = self._classify(payload)
        payload.setdefault("prio", lane)
        payload.setdefault("client", self.client_id)
        budget_ms = self.op_deadline_ms
        t0 = time.monotonic() if budget_ms else 0.0
        delay = self.retry_base_s
        attempt = 0
        while True:
            if budget_ms:
                left = budget_ms - (time.monotonic() - t0) * 1e3
                if left <= 0:
                    raise OverloadedError(
                        f"op {payload.get('op')!r} deadline "
                        f"({budget_ms:.0f}ms) exhausted client-side "
                        "across retries", lane=lane, reason="deadline")
                payload["deadline_ms"] = round(left, 1)
            self.retry_budget.on_request()
            resp = self._request_once(payload, endpoint)
            if resp.get("ok") is False \
                    and resp.get("error") == "OverloadedError":
                err = remote_error(resp)
                attempt += 1
                with self._lock:
                    self.overload_sheds_seen += 1
                if attempt > self.retry_attempts or self._closed:
                    raise err
                if lane != "system" and not self.retry_budget.try_spend():
                    raise RetryBudgetExhausted(
                        f"retry budget exhausted after a shed "
                        f"(lane {err.lane!r}, reason {err.reason!r}): "
                        f"{err}", retry_after_ms=err.retry_after_ms,
                        lane=err.lane, reason="retry_budget")
                with self._lock:
                    self.overload_retries += 1
                wait = delay
                if err.retry_after_ms:
                    # the server's hint is the floor: it knows how long
                    # its queues need to drain better than our backoff
                    wait = max(wait, float(err.retry_after_ms) / 1000.0)
                self._stop_event.wait(wait * (0.5 + random.random()))
                delay = min(delay * 2.0, self.retry_cap_s)
                continue
            if not resp.get("ok"):
                raise_remote(resp)
            if payload.get("op") in _MUTATING_WIRE_OPS:
                self._note_applied(resp.get("applied_rv"))
            return resp

    def _note_applied(self, applied) -> None:
        """Fold a mutation response's applied_rv stamp into this
        client's high-water mark (see applied_hwm)."""
        if applied is None:
            return
        with self._lock:
            if isinstance(applied, dict):
                self._applied_hwm_mapform = True
                for sh, rv in applied.items():
                    if int(rv) > self._applied_hwm.get(str(sh), 0):
                        self._applied_hwm[str(sh)] = int(rv)
            elif int(applied) > self._applied_hwm.get("0", 0):
                self._applied_hwm["0"] = int(applied)

    def applied_hwm(self):
        """The rv high-water mark across this client's own acked
        mutations: the ``min_rv`` a read-your-writes read against a
        replica must demand. Scalar against an unsharded primary,
        ``{shard: rv}`` once any stamp arrived in map form; None before
        the first stamped mutation."""
        with self._lock:
            if not self._applied_hwm:
                return None
            if not self._applied_hwm_mapform:
                return self._applied_hwm.get("0")
            return dict(self._applied_hwm)

    # -- read-tier routing ---------------------------------------------------

    def _read_tier_client(self) -> Optional["RemoteClusterStore"]:
        """The nested client for the preferred (deepest announced)
        read-tier endpoint, built lazily from topology; None when the
        tier is disabled, undiscovered, or cooling down after a
        failure."""
        if not self.read_from_replicas:
            return None
        self._ensure_topology()
        with self._lock:
            if self._read_client is not None:
                return self._read_client
            if not self._read_endpoints \
                    or time.monotonic() < self._read_cooldown:
                return None
            ep = max(self._read_endpoints,
                     key=lambda e: int(e.get("depth", 1)))
            self._read_client = RemoteClusterStore(
                str(ep["endpoint"]), token=self.token,
                connect_timeout=self.connect_timeout,
                direct_routing=False, retry_attempts=1,
                retry_budget=self.retry_budget)
            return self._read_client

    def _read_request(self, payload: dict, fallback=None) -> dict:
        """Route one idempotent read to the read tier, demanding this
        client's own applied hwm via ``min_rv`` (read-your-writes
        holds even though the answer comes from a replica). Falls back
        to the primary on ReplicaLagError or an unreachable replica;
        other typed errors (NotFoundError, ...) are real answers and
        propagate."""
        from .store import ReplicaLagError
        fb = fallback if fallback is not None \
            else (lambda: self._request(payload))
        client = self._read_tier_client()
        if client is None:
            return fb()
        p = dict(payload)
        if p.get("min_rv") is None:
            hwm = self.applied_hwm()
            if hwm is not None:
                p["min_rv"] = hwm
        try:
            resp = client._request(p)
        except (ReplicaLagError, ConnectionError, OSError) as e:
            with self._lock:
                self.read_tier_fallbacks += 1
                if not isinstance(e, ReplicaLagError):
                    # unreachable (a lagging replica is still alive):
                    # drop the client, cool down, rediscover later
                    dead, self._read_client = self._read_client, None
                    self._read_cooldown = time.monotonic() + 5.0
                else:
                    dead = None
            if dead is not None:
                dead.close()
            log.warning("read-tier request failed (%s: %s); falling "
                        "back to the primary", type(e).__name__, e)
            return fb()
        with self._lock:
            self.read_tier_reads += 1
        return resp

    def _request_once(self, payload: dict,
                      endpoint: Optional[tuple] = None) -> dict:
        # Retry rules: a failed SEND is always safe to retry (the server
        # only acts on complete frames, and a broken connection can never
        # complete a partial one). A failure AFTER the send is ambiguous —
        # the server may have applied the op. Idempotent reads always
        # retry there. A mutating op retries only when it is CONDITIONAL:
        # create/delete land at most once (a replay of an applied-but-
        # unacked attempt surfaces ConflictError/NotFoundError instead of
        # double-applying), and update/apply carrying a nonzero
        # resource_version re-present the same precondition, so the
        # replay of an applied bind surfaces ConflictError. Unconditional
        # mutations (version-0 update/apply) surface the transport error
        # to their caller rather than risk blind double-apply. Retries
        # back off exponentially with jitter (base -> cap), so a
        # briefly-restarting server (a 2-second systemd bounce) is ridden
        # out — and a thundering herd of reconnecting clients spreads
        # instead of synchronizing. Connections come from a pool of
        # pool_size (default 1 — the historical one-socket serialization).
        op = payload.get("op")
        idempotent = op in ("get", "list", "ping", "store_info",
                            "bootstrap", "topology", "fence_check",
                            "replica_info", "admission_info",
                            "announce_read_endpoint")
        conditional = op in ("create", "delete") or (
            op in ("update", "apply")
            and bool(((payload.get("obj") or {}).get("f") or {})
                     .get("resource_version")))
        ep = endpoint or self._default_ep
        delay = self.retry_base_s
        attempt = 0
        sock = self._acquire_conn(ep)
        try:
            while True:
                sent = False
                try:
                    faults.fire("store_request")
                    if sock is None:
                        sock = self._connect(ep)
                        with self._pool_cv:
                            self._conns.add(sock)
                    send_frame(sock, payload)
                    sent = True
                    resp = recv_frame(sock)
                    break
                except (ConnectionError, OSError) as e:
                    if sock is not None:
                        self._drop_conn(sock)
                        sock = None
                    attempt += 1
                    if (sent and not (idempotent or conditional)) \
                            or attempt > self.retry_attempts \
                            or self._closed:
                        # the direct-routing fallback must know whether
                        # this op may already have been APPLIED — only a
                        # failure after a completed send on a
                        # non-retryable op is unsafe to re-run elsewhere
                        e._sent_unsafe = bool(  # type: ignore[attr-defined]
                            sent and not (idempotent or conditional))
                        raise
                    try:
                        from ..metrics import metrics
                        metrics.store_request_retries_total.inc()
                    except Exception:  # noqa: BLE001
                        pass
                    self._stop_event.wait(delay * (0.5 + random.random()))
                    delay = min(delay * 2.0, self.retry_cap_s)
        except BaseException:
            if sock is not None:
                self._drop_conn(sock)
            self._release_slot(ep)
            raise
        self._checkin_conn(ep, sock)
        return resp

    def close(self) -> None:
        self._closed = True
        self._stop_event.set()  # wake any backoff sleep immediately
        with self._lock:
            rc, self._read_client = self._read_client, None
        if rc is not None:
            rc.close()
        with self._pool_cv:
            conns = list(self._conns)
            self._conns.clear()
            for pool in self._pools.values():
                pool["idle"].clear()
            self._pool_cv.notify_all()
        for sock in conns:
            try:
                sock.close()
            except OSError:
                pass
        for sock in self._watch_socks:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
        self._watch_socks = []

    # -- ClusterStore surface ----------------------------------------------

    def locked(self):
        return self._lock

    def create(self, kind: str, obj, fencing: Optional[dict] = None):
        return decode(self._routed_request(
            kind, _key(obj),
            {"op": "create", "kind": kind, "obj": encode(obj),
             "fencing": fencing})["obj"])

    def update(self, kind: str, obj, fencing: Optional[dict] = None):
        return decode(self._routed_request(
            kind, _key(obj),
            {"op": "update", "kind": kind, "obj": encode(obj),
             "fencing": fencing})["obj"])

    def apply(self, kind: str, obj, fencing: Optional[dict] = None):
        return decode(self._routed_request(
            kind, _key(obj),
            {"op": "apply", "kind": kind, "obj": encode(obj),
             "fencing": fencing})["obj"])

    def delete(self, kind: str, name: str, namespace: Optional[str] = None,
               fencing: Optional[dict] = None):
        key = f"{namespace}/{name}" if namespace is not None else name
        return decode(self._routed_request(
            kind, key,
            {"op": "delete", "kind": kind, "name": name,
             "namespace": namespace, "fencing": fencing})["obj"])

    def bulk_apply(self, items, fencing: Optional[dict] = None,
                   chunk_bytes: int = BULK_CHUNK_BYTES,
                   chunk_items: int = BULK_CHUNK_ITEMS,
                   ack: bool = False) -> List[Any]:
        """Batch mutation (the bulk ingest op): same
        contract as ClusterStore.bulk_apply — items are (kind, obj[,
        verb]) and the result list carries the applied object or the
        rebuilt exception instance per position. An oversized wave is
        CHUNKED: frames are bounded at chunk_bytes/chunk_items each,
        every chunk commits as one journal batch server-side, and the
        per-chunk results reassemble in submission order — a 50k-pod
        wave costs a handful of bounded frames, never one giant one.
        Not retried after an unacked send (a bulk wave is not
        conditional as a unit); a failed SEND retries like every other
        op, per chunk.

        ``ack=True`` is ingest-wave mode: successful positions come
        back as None instead of the applied objects (errors still
        arrive as exception instances at their positions) — the server
        skips encoding 10k result objects and this client skips
        decoding them, roughly halving the wire cost of a pure-ingest
        wave."""
        encoded = []
        for it in items:
            d = {"kind": it[0], "obj": encode(it[1]),
                 "verb": it[2] if len(it) > 2 else "apply"}
            # sizing costs one extra dumps per item; the request frame
            # re-serializes anyway, and bounded frames are what keep a
            # mega-wave from stalling every other request on the server
            encoded.append((d, len(json.dumps(d, separators=(",", ":")))))
        results: List[Any] = []
        i = 0
        while i < len(encoded):
            size = 0
            j = i
            while j < len(encoded) and (
                    j == i or (j - i < chunk_items
                               and size + encoded[j][1] <= chunk_bytes)):
                size += encoded[j][1]
                j += 1
            payload = {"op": "bulk_apply",
                       "items": [d for d, _ in encoded[i:j]],
                       "fencing": fencing}
            if ack:
                payload["ack"] = True
            resp = self._request(payload)
            if ack:
                chunk: List[Any] = [None] * int(resp["n"])
                for idx, err in (resp.get("errors") or {}).items():
                    chunk[int(idx)] = remote_error(err)
                results.extend(chunk)
            else:
                results.extend(
                    remote_error(r) if "error" in r else decode(r["obj"])
                    for r in resp["results"])
            i = j
        return results

    def get(self, kind: str, name: str, namespace: Optional[str] = None,
            min_rv=None, wait_s: Optional[float] = None):
        key = f"{namespace}/{name}" if namespace is not None else name
        payload = {"op": "get", "kind": kind, "name": name,
                   "namespace": namespace}
        if min_rv is not None:
            payload["min_rv"] = min_rv
            if wait_s is not None:
                payload["wait_s"] = wait_s
        if self.read_from_replicas:
            return decode(self._read_request(
                payload,
                lambda: self._routed_request(kind, key, payload))["obj"])
        return decode(self._routed_request(kind, key, payload)["obj"])

    def try_get(self, kind: str, name: str, namespace: Optional[str] = None):
        from .store import NotFoundError
        try:
            return self.get(kind, name, namespace)
        except NotFoundError:
            return None

    def list(self, kind: str, namespace: Optional[str] = None,
             label_selector: Optional[Dict[str, str]] = None,
             name_glob: Optional[str] = None, min_rv=None,
             wait_s: Optional[float] = None) -> List[Any]:
        return self.list_versioned(kind, namespace, label_selector,
                                   name_glob, min_rv=min_rv,
                                   wait_s=wait_s)[0]

    def list_versioned(self, kind: str, namespace: Optional[str] = None,
                       label_selector: Optional[Dict[str, str]] = None,
                       name_glob: Optional[str] = None, min_rv=None,
                       wait_s: Optional[float] = None):
        """``list`` with its staleness made explicit: returns
        ``(objects, applied_rv)`` where ``applied_rv`` is the exact
        store version the response reflects (scalar, or ``{shard: rv}``
        against a sharded endpoint; None from a pre-applied_rv server).

        ``min_rv=`` is the rv-bounded read against a replica: the
        replica blocks until it has applied that rv or fails typed with
        ReplicaLagError after ``wait_s`` (the primary satisfies any rv
        it ever minted, trivially).

        Closing the retried-list hole: list is retried as idempotent,
        so a retry after an unacked response can land on a view that
        DISAGREES with what this client's own watch streams already
        delivered — most sharply, a view BEHIND the stream's rv
        high-water mark (a restarted primary that recovered short of
        its unfsynced tail, or a replica that just re-bootstrapped from
        an older snapshot). Acting on that response would regress a
        mirror the way a blind write replay used to double-apply, so a
        response behind the stream hwm is DISCARDED and re-requested;
        if the server stays behind, ReplicaLagError surfaces instead of
        stale data. (For the other direction — a list AHEAD of the
        stream — see wait_stream_applied.)"""
        from .store import ReplicaLagError
        payload = {"op": "list", "kind": kind, "namespace": namespace,
                   "label_selector": label_selector,
                   "name_glob": name_glob}
        if min_rv is not None:
            payload["min_rv"] = min_rv
            if wait_s is not None:
                payload["wait_s"] = wait_s
        applied = None
        resp = None
        for attempt in range(self.retry_attempts + 1):
            resp = (self._read_request(payload)
                    if self.read_from_replicas else self._request(payload))
            applied = resp.get("applied_rv")
            if not self._behind_stream(kind, applied):
                break
            if attempt >= self.retry_attempts:
                raise ReplicaLagError(
                    f"list({kind!r}) response at applied_rv {applied} is "
                    f"behind this client's watch high-water mark "
                    f"{self._kind_hwm.get(kind)}; refusing to serve a "
                    "view older than the stream already delivered")
            self._stop_event.wait(0.05 * (attempt + 1))
        with self._lock:
            self.last_list_applied_rv = applied
        return [decode(o) for o in resp["objs"]], applied

    def _behind_stream(self, kind: str, applied) -> bool:
        """True when a list response's applied_rv predates an event this
        client's watch streams already delivered for ``kind``."""
        if applied is None:
            return False
        with self._lock:
            hk = self._kind_hwm.get(kind)
            if not hk:
                return False
            if isinstance(applied, dict):
                return any(int(applied.get(sh, -1)) < rv
                           for sh, rv in hk.items())
            return int(applied) < hk.get("0", -1)

    def _stream_covers(self, kind: str, applied) -> bool:
        # caller holds self._lock
        hk = self._kind_hwm.get(kind, {})
        if isinstance(applied, dict):
            return all(hk.get(str(sh), -1) >= int(rv)
                       for sh, rv in applied.items())
        return hk.get("0", -1) >= int(applied)

    def wait_stream_applied(self, kind: str, applied_rv,
                            timeout: float = 5.0) -> bool:
        """Block until this client's watch stream(s) for ``kind`` have
        delivered events up to ``applied_rv`` (a list response's stamp)
        — the complement of the stale-list discard: a list AHEAD of the
        stream must not drive a mirror until the stream has caught up,
        or events older than the list would regress it. Returns False on
        timeout (e.g. no stream is watching the kind)."""
        if applied_rv is None:
            return True
        deadline = time.monotonic() + timeout
        with self._hwm_cv:
            while not self._stream_covers(kind, applied_rv):
                left = deadline - time.monotonic()
                if left <= 0 or self._closed:
                    return False
                self._hwm_cv.wait(min(left, 0.5))
        return True

    def ping(self) -> bool:
        return bool(self._request({"op": "ping"}).get("ok"))

    def admission_info(self) -> dict:
        """The server's per-lane admission table (``admission_info``
        wire op): {lane: {inflight, streams, queued, admitted, sheds,
        shed_reasons, deadline_expired, max_*}}, plus — against a
        multi-process shard router — a ``workers`` map with each
        worker's own table. Old servers raise (unknown op); vcctl
        degrades to no table."""
        return self._request({"op": "admission_info"})

    def add_interceptor(self, fn) -> None:
        raise NotImplementedError(
            "admission interceptors run in the process that OWNS the "
            "store (standalone --serve-store starts the webhook chain "
            "there); a remote client cannot install them")

    # -- watch --------------------------------------------------------------

    def watch(self, kind: str, listener, replay: bool = True) -> None:
        """Subscribe over a dedicated streaming connection. The replay is
        applied inline before returning (list-then-watch, same synchronous
        contract as the in-memory store); live events are then delivered
        from a daemon reader thread under self.locked(). A broken stream
        resumes in place when it can (see class docstring)."""
        self._start_stream({kind: [listener]}, "watch", replay)

    def bulk_watch(self, subscriptions, replay: bool = True) -> None:
        """Subscribe MANY kinds over ONE streaming connection (the
        ``bulk_watch`` wire op): ``subscriptions`` is an ordered iterable
        of ``(kind, listener)`` — a kind may appear more than once, its
        listeners fan out in subscription order. Replays land inline per
        kind, in subscription order, before this returns; live events
        then arrive BATCHED (the server coalesces up to
        WATCH_BATCH_MAX events per frame) and are applied under one
        mirror-lock hold per batch. Resume carries a per-shard
        high-water-mark map per kind ({kind: {shard: rv}}), so a stream
        against the sharded router reconnects without skipping or
        repeating any shard's events."""
        subs: Dict[str, List] = {}
        for kind, listener in subscriptions:
            subs.setdefault(kind, []).append(listener)
        self._start_stream(subs, "bulk_watch", replay)

    def _start_stream(self, subs: Dict[str, List], op: str,
                      replay: bool) -> None:
        endpoints: List[Optional[tuple]] = [None]
        descs = [""]
        if self.direct_watch:
            self._ensure_topology()
            if self._shard_endpoints:
                # one stream PER SHARD WORKER, router bypassed: each
                # worker replays its own objects (their union is the
                # full replay) and each stream resumes against its own
                # worker's journal with that shard's marks
                endpoints = list(self._shard_endpoints)
                descs = [f"@shard{i}" for i in range(len(endpoints))]
        for endpoint, suffix in zip(endpoints, descs):
            self._open_stream(subs, op, replay, endpoint, suffix)

    def _open_stream(self, subs: Dict[str, List], op: str, replay: bool,
                     endpoint: Optional[tuple], suffix: str) -> None:
        sock = self._connect(endpoint)
        # register BEFORE the replay loop: close() must be able to unblock
        # a watch() stuck mid-replay on a stalled server
        self._watch_socks.append(sock)
        kinds = list(subs)
        # bulk_watch is the controller fan-out path (control lane);
        # plain watch setup defaults to this client's lane (read for
        # dashboards/storms) — the gate can then shed a watch storm
        # without touching the control plane's own streams
        prio = "control" if op == "bulk_watch" \
            else (current_lane() or self.lane or "read")
        req = {"op": op, "kinds": kinds, "replay": replay,
               "prio": prio, "client": self.client_id}
        if self.delta_watch:
            req["delta"] = True
        send_frame(sock, req)
        # per-kind, per-shard resume high-water marks; "sharded" flips
        # once any frame carries shard structure, switching the resume
        # request from the legacy scalar form to the per-shard map.
        # The delta keys: "delta_ask" (request the mode on (re)connect —
        # cleared forever by a typed fallback, kept across transport
        # breaks), "delta_on" (this stream's synced frame granted it),
        # "vtab"/"ks" (per-shard interning tables and frame-sequence
        # baselines), "objs" (per-kind key -> live mirrored object, the
        # ledger a patch's dk resolves against)
        state: Dict[str, Any] = {
            "hwm": {}, "sharded": False,
            "delta_ask": self.delta_watch, "delta_on": False,
            "vtab": {}, "ks": {},
            "objs": {} if self.delta_watch else None}
        desc = (kinds[0] if len(kinds) == 1
                else f"bulk({','.join(kinds)})") + suffix
        try:
            try:
                self._apply_stream(sock, subs, state, until_synced=True)
            except DeltaFallbackError:
                # typed delta refusal during the open phase (a synced
                # frame's table the client can't hold or parse): retry
                # once with the ask off — fail-safe object frames. The
                # re-replayed adds land as add-as-update resyncs.
                self._drop_watch_sock(sock)
                sock = self._connect(endpoint)
                self._watch_socks.append(sock)
                req.pop("delta", None)
                send_frame(sock, req)
                state = {"hwm": {}, "sharded": False,
                         "delta_ask": False, "delta_on": False,
                         "vtab": {}, "ks": {}, "objs": None}
                self._apply_stream(sock, subs, state, until_synced=True)
        except Exception:
            # server refused the subscription (e.g. unknown kind) or died
            # mid-replay: surface it to the caller, nothing to resume yet
            self._drop_watch_sock(sock)
            raise

        def reader():
            cur = sock
            while True:
                try:
                    self._apply_stream(cur, subs, state,
                                       until_synced=False)
                except (ConnectionError, OSError, ValueError) as e:
                    self._drop_watch_sock(cur)
                    if self._closed:
                        return
                    cur = self._resume_watch(subs, op, state, desc,
                                             endpoint)
                    if cur is None:
                        # a resume abandoned because close() landed
                        # mid-attempt is a clean shutdown, not a broken
                        # mirror — don't fire the crash-only contract
                        if not self._closed:
                            self._watch_broke(desc, e)
                        return
                    continue
                except Exception as e:  # noqa: BLE001 — a listener blew up
                    # mid-handler: the mirror itself may be inconsistent,
                    # which no stream resume can repair — crash-only
                    log.exception("watch listener for %s failed", desc)
                    self._drop_watch_sock(cur)
                    if not self._closed:
                        self._watch_broke(desc, e)
                    return

        t = threading.Thread(target=reader, daemon=True,
                             name=f"store-watch-{desc}")
        t.start()
        self._watch_threads.append(t)

    def _fold_hwm(self, kind: str, sh: str, rv: int) -> None:
        # caller holds self._lock; the shared cross-stream floor only
        # ever advances (streams may individually resume from behind it)
        hk = self._kind_hwm.setdefault(kind, {})
        if int(rv) > hk.get(str(sh), -1):
            hk[str(sh)] = int(rv)

    @staticmethod
    def _advance_hwm(state: dict, kind: str, val) -> None:
        """Fold a synced-frame rv value — the legacy scalar, or the
        router's per-shard map — into the resume high-water marks."""
        hk = state["hwm"].setdefault(kind, {})
        if isinstance(val, dict):
            state["sharded"] = True
            for sh, rv in val.items():
                if rv is not None:
                    hk[str(sh)] = max(hk.get(str(sh), -1), int(rv))
        elif val is not None:
            hk["0"] = max(hk.get("0", -1), int(val))

    def _apply_stream(self, sock, subs: Dict[str, List], state: dict,
                      until_synced: bool) -> None:
        """Read frames from a watch socket, delivering events under the
        mirror lock and advancing the resume high-water marks atomically
        with each delivery (so a resume never skips or repeats an event).
        Handles per-event frames and the bulk_watch batched form (one
        lock hold per batch). Returns at the 'synced' marker when
        ``until_synced``, else loops until the connection dies."""
        while True:
            msg, nbytes = recv_frame_sized(sock)
            faults.fire("watch_stream")
            if msg.get("ok") is False:
                raise_remote(msg)
            stream = msg.get("stream")
            if stream == "synced":
                rvmap = msg.get("rv") or {}
                with self._lock:
                    for kind in subs:
                        if kind in rvmap:
                            self._advance_hwm(state, kind, rvmap[kind])
                            for sh, rv in state["hwm"][kind].items():
                                self._fold_hwm(kind, sh, rv)
                    if state.get("delta_ask"):
                        self._delta_synced(state, msg)
                    self._hwm_cv.notify_all()
                if until_synced:
                    return
                continue
            if stream == "events":
                batch = msg.get("batch") or []
            elif stream == "event":
                batch = [msg]
            else:
                continue  # heartbeat
            # under self._lock like every delivery: during the cache's
            # sequential subscriptions (nodes, then pods, ...) a LIVE
            # event on an earlier kind's stream must not mutate the
            # mirror concurrently with a later kind's replay — cache
            # handlers rely on the store serializing dispatch
            with self._lock:
                delta_on = state.get("delta_on", False)
                st = self.delta_stats
                # wire accounting for BOTH modes, so a delta client and
                # an object client measure the same thing and the bytes
                # columns compare like-for-like
                st["bytes_delta" if delta_on else "bytes_object"] += nbytes
                if delta_on:
                    st["frames"] += 1
                for ev in batch:
                    kind = ev.get("kind")
                    shard = ev.get("shard")
                    sh = str(shard) if shard is not None else "0"
                    if delta_on:
                        ksv = ev.get("ks")
                        if ksv is not None:
                            # dense per-(kind, shard) frame sequence: a
                            # gap means a frame was lost between server
                            # and here, a repeat means one applied
                            # already — refuse BEFORE touching anything
                            kmap = state["ks"].setdefault(kind, {})
                            if int(ksv) != kmap.get(sh, 0) + 1:
                                self._delta_fallback(state, "delta_gap")
                            kmap[sh] = int(ksv)
                            tb = ev.get("tb")
                            if tb is not None:
                                self._delta_extend_vtab(state, kind,
                                                        sh, tb)
                    if "dk" in ev:
                        if not delta_on:
                            # a patch outside negotiated delta mode can
                            # only be a protocol break
                            self._delta_fallback(state, "schema_skew")
                        self._apply_patch(ev, subs, state, sh)
                    else:
                        fns = subs.get(kind)
                        obj = None
                        if fns:
                            old = ev.get("old")
                            obj = decode(ev["obj"])
                            oldo = decode(old) if old is not None else None
                            for fn in fns:
                                fn(ev["event"], obj, oldo)
                        objs = state.get("objs")
                        if objs is not None and kind is not None:
                            # the delta ledger mirrors live objects by
                            # store key so later patches can resolve dk
                            if obj is None:
                                obj = decode(ev["obj"])
                            km = objs.setdefault(kind, {})
                            if ev.get("event") == "delete":
                                km.pop(object_key(obj), None)
                            else:
                                km[object_key(obj)] = obj
                    rv = ev.get("rv")
                    if rv is not None:
                        if shard is not None:
                            state["sharded"] = True
                        hk = state["hwm"].setdefault(kind, {})
                        hk[sh] = max(hk.get(sh, -1), int(rv))
                        self._fold_hwm(kind, sh, hk[sh])
                self._hwm_cv.notify_all()

    # -- delta watch application (client/codec.py delta dialect) ------------

    def _delta_synced(self, state: dict, msg: dict) -> None:
        """Fold a synced frame's delta grant into the stream state.
        Caller holds self._lock and has checked ``delta_ask``."""
        if not msg.get("delta"):
            # server (or one relay upstream) declined: fail-safe object
            # frames, and stop asking — the answer won't change
            state["delta_on"] = False
            state["delta_ask"] = False
            state["objs"] = None
            return
        try:
            vtab = {k: {str(sh): [decode(e) for e in entries]
                        for sh, entries in m.items()}
                    for k, m in (msg.get("vtab") or {}).items()}
        except Exception:  # noqa: BLE001 — unparseable table entry
            self._delta_fallback(state, "schema_skew")
        for m in vtab.values():
            for entries in m.values():
                if len(entries) > self.delta_vocab_max:
                    self._delta_fallback(state, "vocab_overflow")
        # REPLACE, never merge: each synced is a full snapshot atomic
        # with the (re)subscription it rode in on
        state["vtab"] = vtab
        state["ks"] = {k: {str(sh): int(n) for sh, n in m.items()}
                       for k, m in (msg.get("ks") or {}).items()}
        state["delta_on"] = True
        if state.get("objs") is None:
            state["objs"] = {}
        vocab = max((len(t) for m in vtab.values()
                     for t in m.values()), default=0)
        if vocab > self.delta_stats["vocab"]:
            self.delta_stats["vocab"] = vocab

    def _delta_extend_vtab(self, state: dict, kind: str, sh: str,
                           tb) -> None:
        """Apply a frame's interning-table additions ([start, entries])
        to that kind's table — tables are per (kind, shard) so a stream
        watching a subset of kinds stays id-aligned with the server.
        Caller holds self._lock; ks continuity already passed."""
        table = state["vtab"].setdefault(kind, {}).setdefault(sh, [])
        try:
            t0, entries = tb
        except (TypeError, ValueError):
            self._delta_fallback(state, "schema_skew")
        if t0 != len(table):
            # additions for a table we don't have: the streams' tables
            # are no longer id-aligned
            self._delta_fallback(state, "schema_skew")
        if t0 + len(entries) > self.delta_vocab_max:
            self._delta_fallback(state, "vocab_overflow")
        try:
            table.extend(decode(e) for e in entries)
        except Exception:  # noqa: BLE001 — unparseable entry
            self._delta_fallback(state, "schema_skew")
        if len(table) > self.delta_stats["vocab"]:
            self.delta_stats["vocab"] = len(table)

    def _delta_fallback(self, state: dict, reason: str) -> None:
        """Typed refusal: record it, clear the stream's delta state so
        the resume reconnects plain, and raise. The failed frame applied
        NOTHING and advanced no high-water mark, so the object-path
        resume replay neither loses nor repeats an event. Caller holds
        self._lock."""
        state["delta_on"] = False
        state["delta_ask"] = False
        state["vtab"] = {}
        state["ks"] = {}
        state["objs"] = None
        fb = self.delta_stats["fallbacks"]
        fb[reason] = fb.get(reason, 0) + 1
        try:
            from ..metrics import metrics
            metrics.delta_fallbacks_total.inc(labels={"reason": reason})
        except Exception:  # noqa: BLE001 — accounting only
            pass
        log.warning("delta watch stream falling back to object frames "
                    "(%s)", reason)
        raise DeltaFallbackError(reason)

    def _apply_patch(self, ev: dict, subs: Dict[str, List], state: dict,
                     sh: str) -> None:
        """Apply one column patch onto the mirrored object it names.
        Validate-then-apply: every field resolves (or the whole frame is
        refused typed) before any attribute changes, so a refusal leaves
        the mirror exactly as it was. Caller holds self._lock."""
        t0 = time.perf_counter()
        kind = ev["kind"]
        table = (state["vtab"].get(kind) or {}).get(sh) or ()
        try:
            key = table[ev["dk"]]
        except (IndexError, TypeError):
            self._delta_fallback(state, "schema_skew")
        obj = (state["objs"].get(kind) or {}).get(key)
        if obj is None:
            # a patch for a key whose add this stream never applied:
            # continuity is broken even though ks looked dense
            self._delta_fallback(state, "delta_gap")
        cls = type(obj)
        known = known_fields(cls)
        sets = []
        try:
            for fid, wv in zip(ev.get("df") or (), ev.get("dv") or ()):
                fname = table[fid]
                if fname not in known:
                    self._delta_fallback(state, "unknown_field")
                sets.append((fname, delta_resolve(wv, table)))
            for fid in ev.get("dx") or ():
                fname = table[fid]
                if fname not in known:
                    self._delta_fallback(state, "unknown_field")
                sets.append((fname, field_default(cls, fname)))
        except DeltaFallbackError:
            raise
        except IndexError:
            self._delta_fallback(state, "schema_skew")
        except (ValueError, TypeError):
            # undecodable value, or clearing a field with no default
            self._delta_fallback(state, "schema_skew")
        t1 = time.perf_counter()
        # a shallow copy is a faithful ``old``: patches REPLACE field
        # values, never mutate containers in place, so the copy keeps
        # every pre-patch reference while the live object moves on
        old = copy.copy(obj)
        for fname, val in sets:
            setattr(obj, fname, val)
        changed = [fname for fname, _ in sets]
        for fn in subs.get(kind) or ():
            if getattr(fn, "delta_aware", False):
                # delta-aware consumers (SchedulerCache._on_pod) take
                # the changed-field names and skip the full rebuild
                fn("update", obj, old, changed)
            else:
                fn("update", obj, old)
        t2 = time.perf_counter()
        st = self.delta_stats
        st["events"] += 1
        st["fields"] += len(sets)
        st["decode_ms"] += (t1 - t0) * 1000.0
        st["apply_ms"] += (t2 - t1) * 1000.0

    def _resume_watch(self, subs: Dict[str, List], op: str, state: dict,
                      desc: str, endpoint: Optional[tuple] = None):
        """Reconnect a broken watch stream with exponential backoff +
        jitter and ask the server to replay from our high-water marks.
        Returns the new streaming socket (mirror already resynced), or
        None when resume is impossible — unknown high-water mark, resume
        window lost server-side (ResumeGapError), or the server stayed
        unreachable past ``watch_resume_window_s`` — in which case the
        caller falls back to the crash-only contract. A direct per-shard
        stream resumes against its own worker ``endpoint`` (the
        supervisor restarts a dead worker on the same port, well inside
        the resume window); ShardUnavailableError from a router mid-
        worker-restart keeps backing off the same way."""
        with self._lock:
            if not self.watch_resume or any(
                    not state["hwm"].get(k) for k in subs):
                return None
        deadline = time.monotonic() + self.watch_resume_window_s
        delay = 0.05
        attempt = 0
        while not self._closed:
            attempt += 1
            sock = None
            with self._lock:
                since = ({k: dict(m) for k, m in state["hwm"].items()}
                         if state["sharded"] else
                         {k: m.get("0", -1)
                          for k, m in state["hwm"].items()})
            try:
                sock = self._connect(endpoint)
                self._watch_socks.append(sock)
                # resume is CONTROL-lane regardless of the stream's
                # original lane: keeping an already-established mirror
                # consistent outranks admitting new read traffic
                rreq = {"op": op, "kinds": list(subs),
                        "replay": False, "since": since,
                        "prio": "control", "client": self.client_id}
                if state.get("delta_ask"):
                    # transport breaks keep the delta ask (the journal
                    # replay arrives object-form either way; the fresh
                    # synced re-baselines vtab/ks); typed fallbacks
                    # cleared the ask and resume plain
                    rreq["delta"] = True
                send_frame(sock, rreq)
                # the missed-event replay lands here, inline
                self._apply_stream(sock, subs, state, until_synced=True)
            except ResumeGapError as e:
                self._drop_watch_sock(sock)
                log.error("watch stream for %r cannot resume: %s", desc, e)
                return None
            except (ConnectionError, OSError, ValueError,
                    ShardUnavailableError):
                # ShardUnavailableError: the router refused because the
                # owning worker is down — transient exactly like an
                # unreachable server; the supervisor is restarting it
                self._drop_watch_sock(sock)
                if time.monotonic() >= deadline:
                    return None
                self._stop_event.wait(delay * (0.5 + random.random()))
                delay = min(delay * 2.0, self.watch_backoff_cap_s)
                continue
            with self._lock:
                self.watch_resumes += 1
            try:
                from ..metrics import metrics
                metrics.watch_reconnects_total.inc(labels={"kind": desc})
            except Exception:  # noqa: BLE001
                pass
            log.warning("watch stream for %r resumed from %s "
                        "(attempt %d)", desc, since, attempt)
            return sock
        return None

    def _drop_watch_sock(self, sock) -> None:
        if sock is None:
            return
        try:
            self._watch_socks.remove(sock)
        except ValueError:
            pass
        try:
            sock.close()
        except OSError:
            pass

    def _watch_broke(self, kind: str, exc: Exception) -> None:
        """A watch stream died beyond repair: the local mirror is
        permanently stale (resume was either disabled, out of window, or
        the listener itself corrupted mid-delivery)."""
        with self._lock:  # streams die together when the server goes:
            first = not self.watch_failed  # fire the callback exactly once
            self.watch_failed = True
        log.critical(
            "watch stream for %r broke (%s: %s) and could not resume; "
            "this store's mirror is frozen — restart the consumer "
            "process to resync", kind, type(exc).__name__, exc)
        if first and self.on_watch_failure is not None:
            try:
                self.on_watch_failure()
            except Exception:  # noqa: BLE001 — never kill the reader hook
                log.exception("on_watch_failure callback failed")
