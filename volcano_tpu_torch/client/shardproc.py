"""Multi-process store shards: one OS process per shard, a thin router.

The sharded front door (client/sharded.py) partitions the object space,
but keeps every shard in ONE Python process — commits, watch fan-out
and wire encode all contend on one GIL. This module takes the partition
to real cores, the reference system's sharded-worker fan-out as actual
OS processes:

**Shard worker** (``python -m volcano_tpu_torch.client.shardproc``): one
process owning exactly one shard — its lock, its resource_version
sequence, its watch-resume journal window, and its
``data-dir/shard-NNN`` WAL+snapshot lineage (the SAME layout and format
the in-process sharded store writes: the two deployments are
interchangeable over one data dir). The worker is a plain
``StoreServer`` over a ``DurableClusterStore`` speaking the UNCHANGED
wire protocol, with two twists: it stamps its shard index into every
watch event/synced frame (``shard_tag``), so routers relay frames
verbatim and direct clients attribute events without re-tagging; and a
non-arbiter worker validates fencing tokens through a **fencing RPC**
(``fence_check``) to the shard-0 worker, which owns the pinned
``leases`` bucket — lease arbitration stays a single-writer concern.
Admission interceptors (the webhook chain) run IN the worker, at the
authoritative store, exactly as an in-process control plane runs
them at its store.

**Supervisor** (``ShardProcSupervisor``): spawns the workers, monitors
them, and restarts a dead worker on the SAME port and data dir with
capped exponential backoff — construction is recovery, so the restarted
worker's journal window re-seeds from its recovered WAL tail and
mid-stream watchers resume through the normal ``since:`` path. While a
worker is down its ops are contained with ``ShardUnavailableError``.
Liveness, pid, restart count, uptime and per-shard ingest events/sec
export as ``volcano_store_shard_worker_*`` metrics and in
``stats()``.

**Router** (``ProcShardRouter``): one endpoint, the existing wire
protocol, N worker processes behind it. It became what a router should
be — a proxy, not a store: single-key CRUD forwards the client's frame
verbatim to the owning worker (routing keys are extracted from the
sparse-encoded object without decoding it); ``bulk_apply`` waves split
per shard and dispatch to the workers IN PARALLEL (each worker fsyncs
its own sub-batch — N shards cost one fsync's wall time and none of the
router's); ``list``/``store_info`` fan out and merge with per-shard
``applied_rv`` stamps; watch/bulk_watch streams relay the workers'
already-shard-tagged frames byte-for-byte (one merged ``synced`` frame,
per-shard resume marks split back to each worker's own journal); and
``ship``/``bootstrap`` relay to the owning worker so replicas can ride
the router — or skip it entirely and tail a worker directly.

**Direct routing**: ``crc32(kind/ns/name) % N`` is deterministic and
client-visible (client/sharded.py ``shard_for``), so clients don't need
the router at all for single-key work. The router serves a ``topology``
op (``{n_shards, endpoints}``); ``RemoteClusterStore`` fetches it once
and opens per-shard connections (client/remote.py), sending single-key
CRUD/get — and, opted in, watch streams — straight to the owning
worker. The router hop survives only for cross-shard ops. Old servers
(no ``topology``) and failed direct connections degrade gracefully to
router-only routing.

Fault points: ``shard_proc_crash`` fires in the worker's request
dispatch (arm ``exc:exit`` via the worker's ``--faults`` to SIGKILL the
worker at the Nth op — the supervisor must restart it and every client
must ride through); ``shard_request``/``shard_crash`` fire at the
router's dispatch/commit seams exactly like the in-process router's.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import queue
import socket
import struct
import subprocess
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ..resilience.faultinject import faults
from .codec import _REGISTRY, decode, encode
from .server import (
    MAGIC, WATCH_QUEUE_MAX, WATCH_SEND_TIMEOUT_S, _Handler, StoreServer,
    raise_remote, recv_frame, recv_frame_raw, remote_error, send_frame,
    send_frame_raw,
)
from .sharded import shard_for
from .store import (
    KINDS, ClusterStore, FencedError, ShardUnavailableError, _key,
)

log = logging.getLogger(__name__)

#: idle raw request sockets the supervisor keeps per worker
_WORKER_POOL_MAX = 8
#: sentinel pushed into a relay queue when an upstream dies
_EOF = object()


# -- routing keys off the wire ------------------------------------------------

#: class tag -> (default name, default namespace or None): what an
#: absent field decodes to, so a router can compute the SAME routing key
#: ``_key(decode(obj))`` would, without decoding the object
_KEY_DEFAULTS: Dict[str, tuple] = {}


def _key_defaults(tag: str) -> tuple:
    got = _KEY_DEFAULTS.get(tag)
    if got is None:
        name_default: Any = ""
        ns_default: Any = None
        cls = _REGISTRY.get(tag)
        if cls is not None and dataclasses.is_dataclass(cls):
            for fld in dataclasses.fields(cls):
                if fld.name == "name" \
                        and fld.default is not dataclasses.MISSING:
                    name_default = fld.default
                elif fld.name == "namespace" \
                        and fld.default is not dataclasses.MISSING:
                    ns_default = fld.default
        got = _KEY_DEFAULTS[tag] = (name_default, ns_default)
    return got


def encoded_key(enc: dict) -> str:
    """The ``_key()`` of a sparse-encoded object, without decoding it:
    fields absent from the wire regain their class defaults (the codec's
    contract), so name/namespace resolve identically on both sides."""
    fields = enc.get("f") or {}
    name_default, ns_default = _key_defaults(enc.get("__t", ""))
    name = fields.get("name", name_default)
    ns = fields.get("namespace", ns_default)
    return f"{ns}/{name}" if ns is not None else str(name)


# -- the worker process -------------------------------------------------------


class _RemoteFenceArbiter:
    """Fencing delegation over the wire: a worker owning a non-lease
    shard validates every fenced write against the arbiter worker's
    lease record (shard 0 owns the pinned ``leases`` bucket). FAILS
    CLOSED: an unreachable arbiter refuses the write — a fenced writer
    that cannot prove its leadership must not commit."""

    def __init__(self, address: str, token: Optional[str] = None,
                 connect_timeout: float = 2.0):
        host, _, port = address.rpartition(":")
        self.host = host or "127.0.0.1"
        self.port = int(port)
        self.token = token or ""
        self.connect_timeout = connect_timeout
        self._lock = threading.Lock()
        self._sock: Optional[socket.socket] = None

    def _connect(self) -> socket.socket:
        sock = socket.create_connection((self.host, self.port),
                                        timeout=self.connect_timeout)
        sock.settimeout(self.connect_timeout)
        sock.sendall(MAGIC)
        if self.token:
            send_frame(sock, {"op": "auth", "token": self.token})
            resp = recv_frame(sock)
            if not resp.get("ok"):
                sock.close()
                raise_remote(resp)
        return sock

    def _check_fence(self, fencing: Optional[dict]) -> None:
        if not fencing:
            return
        resp = None
        with self._lock:
            for attempt in (0, 1):
                try:
                    if self._sock is None:
                        self._sock = self._connect()
                    send_frame(self._sock,
                               {"op": "fence_check", "fencing": fencing})
                    resp = recv_frame(self._sock)
                    break
                except (ConnectionError, OSError):
                    if self._sock is not None:
                        try:
                            self._sock.close()
                        except OSError:
                            pass
                        self._sock = None
                    if attempt:
                        raise FencedError(
                            "write fenced: fencing arbiter (shard 0 "
                            "worker) unreachable — failing closed")
        if not resp.get("ok"):
            if resp.get("error") == "FencedError":
                raise FencedError(resp.get("message", "write fenced"))
            raise_remote(resp)


class _PeerReadStore:
    """The worker's admission view of the WHOLE cluster: writes and
    same-shard reads hit the local store; a read whose key routes to
    another shard goes to the owning PEER worker over the wire (the
    jobs webhook checks its queue exists, the pods webhook checks its
    podgroup's phase, the queues webhook lists podgroups — all of which
    may live on other shards). Peers are installed by the supervisor's
    ``set_peers`` broadcast once every worker is up; until then (and on
    an unsharded deployment) every read is local. Peer reads carry a
    short timeout: a cross-shard read under the local store lock must
    degrade to a typed admission failure, never a distributed hang."""

    def __init__(self, local: ClusterStore, shard_idx: int,
                 token: Optional[str] = None, timeout_s: float = 5.0):
        self.local = local
        self.shard_idx = int(shard_idx)
        self.token = token or ""
        self.timeout_s = timeout_s
        self.n_shards = 1
        self._peers: List[tuple] = []
        self._lock = threading.Lock()
        self._socks: Dict[int, socket.socket] = {}

    def set_peers(self, endpoints: List[str], n_shards: int) -> None:
        peers = []
        for addr in endpoints:
            host, _, port = addr.rpartition(":")
            peers.append((host or "127.0.0.1", int(port)))
        with self._lock:
            self._peers = peers
            self.n_shards = int(n_shards)
            for s in self._socks.values():
                try:
                    s.close()
                except OSError:
                    pass
            self._socks.clear()

    def _peer_request(self, idx: int, payload: dict) -> dict:
        with self._lock:
            for attempt in (0, 1):
                sock = self._socks.pop(idx, None)
                fresh = sock is None
                try:
                    if sock is None:
                        host, port = self._peers[idx]
                        sock = socket.create_connection(
                            (host, port), timeout=self.timeout_s)
                        sock.settimeout(self.timeout_s)
                        sock.sendall(MAGIC)
                        if self.token:
                            send_frame(sock, {"op": "auth",
                                              "token": self.token})
                            resp = recv_frame(sock)
                            if not resp.get("ok"):
                                sock.close()
                                raise_remote(resp)
                    send_frame(sock, payload)
                    resp = recv_frame(sock)
                except (ConnectionError, OSError, socket.timeout):
                    if sock is not None:
                        try:
                            sock.close()
                        except OSError:
                            pass
                    if fresh or attempt:
                        raise
                    continue  # stale cached socket: one fresh retry
                self._socks[idx] = sock
                return resp
        raise ConnectionError("peer read failed")  # unreachable

    def _owner(self, kind: str, key: str) -> int:
        return shard_for(kind, key, self.n_shards)

    def get(self, kind: str, name: str, namespace: Optional[str] = None):
        key = f"{namespace}/{name}" if namespace is not None else name
        idx = self._owner(kind, key)
        if self.n_shards <= 1 or idx == self.shard_idx:
            return self.local.get(kind, name, namespace)
        resp = self._peer_request(idx, {"op": "get", "kind": kind,
                                        "name": name,
                                        "namespace": namespace})
        if not resp.get("ok"):
            raise_remote(resp)  # NotFoundError re-raises typed
        return decode(resp["obj"])

    def try_get(self, kind: str, name: str,
                namespace: Optional[str] = None):
        from .store import NotFoundError
        try:
            return self.get(kind, name, namespace)
        except NotFoundError:
            return None

    def list(self, kind: str, namespace: Optional[str] = None,
             label_selector: Optional[Dict[str, str]] = None,
             name_glob: Optional[str] = None) -> List[Any]:
        out = list(self.local.list(kind, namespace, label_selector,
                                   name_glob))
        for idx in range(self.n_shards):
            if idx == self.shard_idx:
                continue
            resp = self._peer_request(idx, {
                "op": "list", "kind": kind, "namespace": namespace,
                "label_selector": label_selector,
                "name_glob": name_glob})
            if not resp.get("ok"):
                raise_remote(resp)
            out.extend(decode(o) for o in resp["objs"])
        return out

    def __getattr__(self, name):
        # writes, locked(), add_interceptor, watch, ... stay LOCAL: the
        # wrapper exists only to widen admission's read horizon
        return getattr(self.local, name)


class _WorkerHandler(_Handler):
    def _dispatch(self, store, op: str, req: dict) -> dict:
        # shard_proc_crash armed exc:exit kills THIS worker process at
        # the Nth dispatched op — the deterministic worker-death chaos
        # the supervisor's restart path is tested against
        faults.fire("shard_proc_crash")
        if op == "set_peers":
            # supervisor broadcast: the full worker endpoint list, so
            # this worker's admission view can read across shards
            view = getattr(self.server, "peer_view", None)
            if view is not None:
                view.set_peers(req.get("endpoints") or [],
                               int(req.get("n_shards") or 1))
            return {"ok": True}
        return _Handler._dispatch(self, store, op, req)


class ShardWorkerServer(StoreServer):
    """A StoreServer that knows which shard it is: every watch
    event/synced frame carries ``shard`` so routers relay verbatim and
    direct clients keep per-shard resume marks, and resume requests
    read the worker's own key out of a ``{shard: rv}`` map."""

    handler_class = _WorkerHandler

    def __init__(self, store: ClusterStore, shard_idx: int, **kw):
        super().__init__(store, **kw)
        self.shard_idx = int(shard_idx)
        self._server.shard_tag = self.shard_idx  # type: ignore[attr-defined]


def main(argv=None) -> int:
    """Shard-worker entrypoint: ONE shard's store served over TCP,
    nothing else. Imports stay store-only — no torch, no scheduler — so a
    supervisor restart is fast enough for clients' transport-retry
    windows to ride out."""
    ap = argparse.ArgumentParser(prog="volcano-tpu-torch-shard-worker")
    ap.add_argument("--shard", type=int, required=True)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--data-dir", default="",
                    help="this shard's OWN lineage dir (data-dir/"
                         "shard-NNN); empty = in-memory")
    ap.add_argument("--fsync", default="every",
                    choices=["every", "interval", "off"])
    ap.add_argument("--fsync-interval", type=float, default=0.05)
    ap.add_argument("--snapshot-every", type=int, default=4096)
    ap.add_argument("--arbiter", default="",
                    help="HOST:PORT of the shard-0 worker; fenced "
                         "writes on this shard validate there (empty "
                         "for shard 0 itself)")
    ap.add_argument("--token", default="")
    ap.add_argument("--admission", action="store_true",
                    help="run the admission webhook chain in this "
                         "worker (interceptors live at the "
                         "authoritative store)")
    ap.add_argument("--scheduler-name", default="volcano")
    ap.add_argument("--default-queue", default="default")
    ap.add_argument("--faults", default=None)
    ap.add_argument("--admission-lanes", default="",
                    help="per-lane admission bounds for THIS worker's "
                         "gate (lane=inflight[:queue[:streams]],...); "
                         "each worker sheds independently, so one hot "
                         "shard never touches its siblings")
    ap.add_argument("--admission-queue-wait-ms", type=float,
                    default=None,
                    help="max milliseconds a request waits in a full "
                         "lane before it is shed typed")
    ap.add_argument("--parent-pid", type=int, default=0,
                    help="exit when this process is no longer the "
                         "parent (supervisor died; don't leak workers "
                         "holding ports)")
    args = ap.parse_args(argv)

    from ..resilience.faultinject import faults as _faults
    if args.faults:
        _faults.configure(args.faults)

    from .durable import DurableClusterStore
    if args.data_dir:
        store: ClusterStore = DurableClusterStore(
            args.data_dir, fsync=args.fsync,
            fsync_interval_s=args.fsync_interval,
            snapshot_every=args.snapshot_every,
            shard=str(args.shard))
    else:
        store = ClusterStore()
    if args.arbiter:
        store._fence_arbiter = _RemoteFenceArbiter(  # type: ignore[attr-defined]
            args.arbiter, token=args.token or None)
    peer_view = None
    if args.admission:
        # same order as an in-process store: recovery (constructor, above) runs
        # BEFORE interceptors install — recovered objects were admitted
        # when they first committed — and interceptors install before
        # the port opens, so no early write slips past the chain. The
        # chain's read horizon is the whole cluster via peer reads
        # (set_peers arrives from the supervisor once all workers are
        # up; until then reads are local)
        from ..webhooks import start_webhooks
        peer_view = _PeerReadStore(store, args.shard,
                                   token=args.token or None)
        start_webhooks(peer_view, scheduler_name=args.scheduler_name,
                       default_queue=args.default_queue)
    # each worker owns its own admission gate: one hot shard sheds
    # without touching its siblings (the router's gate fronts the
    # cross-shard ops; single-key traffic meets only this one)
    from ..resilience.overload import AdmissionGate, parse_lane_spec
    gate_kw = {}
    if args.admission_queue_wait_ms is not None:
        gate_kw["queue_wait_ms"] = args.admission_queue_wait_ms
    gate = AdmissionGate(parse_lane_spec(args.admission_lanes or None),
                         **gate_kw)
    server = ShardWorkerServer(store, args.shard, port=args.port,
                               token=args.token or None, gate=gate)
    server._server.peer_view = peer_view  # type: ignore[attr-defined]
    server.start()
    print(f"READY {server.port} shard={args.shard} rv={store._rv} "
          f"recovered={getattr(store, 'recovered_records', 0)} "
          f"pid={os.getpid()}", flush=True)
    try:
        while True:
            if args.parent_pid and os.getppid() != args.parent_pid:
                log.warning("shard worker %d: supervisor (pid %d) is "
                            "gone; exiting", args.shard, args.parent_pid)
                break
            time.sleep(0.5)
    except KeyboardInterrupt:
        pass
    server.stop()
    close = getattr(store, "close", None)
    if close is not None:
        close()
    return 0


# -- the supervisor -----------------------------------------------------------


class _Worker:
    __slots__ = ("idx", "port", "data_dir", "proc", "pid", "alive",
                 "restarts", "started_at", "restarting", "last_rv",
                 "last_poll_t", "events_per_sec", "idle_socks")

    def __init__(self, idx: int, data_dir: Optional[str]):
        self.idx = idx
        self.port = 0
        self.data_dir = data_dir
        self.proc: Optional[subprocess.Popen] = None
        self.pid: Optional[int] = None
        self.alive = False
        self.restarts = 0
        self.started_at = 0.0
        self.restarting = False
        self.last_rv: Optional[int] = None
        self.last_poll_t = 0.0
        self.events_per_sec = 0.0
        self.idle_socks: List[socket.socket] = []


class ShardProcSupervisor:
    """Spawn one worker process per shard, monitor them, restart the
    dead with capped exponential backoff on the SAME port + data dir
    (construction is recovery). See module docstring."""

    def __init__(self, n_shards: int, data_dir: Optional[str] = None,
                 fsync: str = "every", fsync_interval_s: float = 0.05,
                 snapshot_every: int = 4096,
                 token: Optional[str] = None,
                 scheduler_name: str = "volcano",
                 default_queue: str = "default",
                 admission: bool = True,
                 worker_faults=None,
                 admission_lanes: Optional[str] = None,
                 admission_queue_wait_ms: Optional[float] = None,
                 restart_backoff_base_s: float = 0.2,
                 restart_backoff_cap_s: float = 5.0,
                 ready_timeout_s: float = 60.0):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.n_shards = int(n_shards)
        self.data_dir = data_dir
        self.fsync = fsync
        self.fsync_interval_s = fsync_interval_s
        self.snapshot_every = snapshot_every
        self.token = token or ""
        self.scheduler_name = scheduler_name
        self.default_queue = default_queue
        self.admission = admission
        #: fault spec applied to every worker, or {shard_idx: spec}
        self.worker_faults = worker_faults
        #: per-lane admission bounds handed to every worker's own gate
        self.admission_lanes = admission_lanes
        self.admission_queue_wait_ms = admission_queue_wait_ms
        self.restart_backoff_base_s = restart_backoff_base_s
        self.restart_backoff_cap_s = restart_backoff_cap_s
        self.ready_timeout_s = ready_timeout_s
        #: called (idx) after a dead worker came back READY — the
        #: on_shard_recovered seam (the worker's own journal re-seeded
        #: from its recovered WAL tail during construction)
        self.on_shard_recovered: Optional[Callable[[int], None]] = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._started = False
        self.workers = [
            _Worker(i, os.path.join(data_dir, f"shard-{i:03d}")
                    if data_dir else None)
            for i in range(self.n_shards)]
        self._monitor_thread: Optional[threading.Thread] = None

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "ShardProcSupervisor":
        # shard 0 first: it is the fencing arbiter, and the other
        # workers need its (stable) endpoint at spawn time
        self._spawn(self.workers[0])
        for w in self.workers[1:]:
            self._spawn(w)
        for w in self.workers:
            self._send_peers(w)
        self._started = True
        self._monitor_thread = threading.Thread(
            target=self._monitor, daemon=True, name="shard-supervisor")
        self._monitor_thread.start()
        return self

    def _send_peers(self, w: _Worker) -> None:
        """Hand a worker the full endpoint map so its admission chain
        can read across shards (no-op for admission-less workers)."""
        if not self.admission or self.n_shards <= 1:
            return
        try:
            self.request(w.idx, {"op": "set_peers",
                                 "endpoints": self.endpoints(),
                                 "n_shards": self.n_shards})
        except Exception:  # noqa: BLE001 — reads stay local until retried
            log.exception("set_peers to shard worker %d failed", w.idx)

    def stop(self) -> None:
        self._stop.set()
        if self._monitor_thread is not None:
            self._monitor_thread.join(timeout=5)
        for w in self.workers:
            with self._lock:
                socks, w.idle_socks = w.idle_socks, []
            for s in socks:
                try:
                    s.close()
                except OSError:
                    pass
            if w.proc is not None and w.proc.poll() is None:
                w.proc.terminate()
        for w in self.workers:
            if w.proc is None:
                continue
            try:
                w.proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                w.proc.kill()
                try:
                    w.proc.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    pass

    # -- spawning -----------------------------------------------------------

    def _faults_for(self, idx: int) -> Optional[str]:
        wf = self.worker_faults
        if isinstance(wf, dict):
            return wf.get(idx)
        return wf

    def _spawn(self, w: _Worker) -> None:
        repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        cmd = [sys.executable, "-m", "volcano_tpu_torch.client.shardproc",
               "--shard", str(w.idx), "--port", str(w.port),
               "--data-dir", w.data_dir or "",
               "--fsync", self.fsync,
               "--fsync-interval", str(self.fsync_interval_s),
               "--snapshot-every", str(self.snapshot_every),
               "--scheduler-name", self.scheduler_name,
               "--default-queue", self.default_queue,
               "--parent-pid", str(os.getpid())]
        if self.token:
            cmd += ["--token", self.token]
        if self.admission:
            cmd += ["--admission"]
        if self.admission_lanes:
            cmd += ["--admission-lanes", self.admission_lanes]
        if self.admission_queue_wait_ms is not None:
            cmd += ["--admission-queue-wait-ms",
                    str(self.admission_queue_wait_ms)]
        if w.idx != 0:
            cmd += ["--arbiter", self.endpoint(0)]
        spec = self._faults_for(w.idx)
        if spec:
            cmd += ["--faults", spec]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True,
                                cwd=repo_root)
        deadline = time.time() + self.ready_timeout_s
        line = ""
        while time.time() < deadline:
            line = proc.stdout.readline()
            if line.startswith("READY"):
                break
            if proc.poll() is not None:
                break
        if not line.startswith("READY"):
            tail = proc.stdout.read() if proc.stdout else ""
            proc.kill()
            raise RuntimeError(
                f"shard worker {w.idx} failed to start "
                f"(rc={proc.poll()}): {line!r} {tail[-500:]!r}")
        w.port = int(line.split()[1])
        w.proc = proc
        w.pid = proc.pid
        w.started_at = time.time()
        w.alive = True
        # drain (and discard) the worker's remaining output so its logs
        # can never fill the pipe and block it mid-serve
        threading.Thread(target=self._drain, args=(proc,), daemon=True,
                         name=f"shard-drain-{w.idx}").start()
        self._export(w)
        log.info("shard worker %d up: pid=%d port=%d", w.idx, w.pid,
                 w.port)

    @staticmethod
    def _drain(proc: subprocess.Popen) -> None:
        try:
            for _ in proc.stdout:  # type: ignore[union-attr]
                pass
        except (OSError, ValueError):
            pass

    # -- monitoring / restart ----------------------------------------------

    def _monitor(self) -> None:
        while not self._stop.is_set():
            for w in self.workers:
                if (w.alive and not w.restarting and w.proc is not None
                        and w.proc.poll() is not None):
                    w.alive = False
                    w.restarting = True
                    self._export(w)
                    log.error("shard worker %d (pid %s) died (rc=%s); "
                              "restarting with backoff", w.idx, w.pid,
                              w.proc.poll())
                    threading.Thread(target=self._restart, args=(w,),
                                     daemon=True,
                                     name=f"shard-restart-{w.idx}").start()
            self._poll_stats()
            self._stop.wait(0.1)

    def _restart(self, w: _Worker) -> None:
        # dead worker: drop its pooled sockets (they point at a corpse)
        with self._lock:
            socks, w.idle_socks = w.idle_socks, []
        for s in socks:
            try:
                s.close()
            except OSError:
                pass
        backoff = self.restart_backoff_base_s
        while not self._stop.is_set():
            self._stop.wait(backoff)
            backoff = min(backoff * 2.0, self.restart_backoff_cap_s)
            if self._stop.is_set():
                break
            try:
                # SAME port + data dir: construction IS recovery, the
                # endpoint stays stable for direct-routed clients, and
                # the fresh journal window seeds from the recovered
                # WAL tail
                self._spawn(w)
            except Exception:  # noqa: BLE001 — keep backing off
                log.exception("shard worker %d restart failed; backing "
                              "off %.2fs", w.idx, backoff)
                continue
            w.restarts += 1
            self._send_peers(w)  # the endpoint map survives the restart
            self._export(w)
            if self.on_shard_recovered is not None:
                try:
                    self.on_shard_recovered(w.idx)
                except Exception:  # noqa: BLE001 — seam must not kill us
                    log.exception("on_shard_recovered(%d) failed", w.idx)
            break
        w.restarting = False

    def _poll_stats(self) -> None:
        now = time.time()
        for w in self.workers:
            if not w.alive or now - w.last_poll_t < 2.0:
                continue
            try:
                info = self.request(w.idx, {"op": "store_info"})
            except Exception:  # noqa: BLE001 — stats only
                continue
            rv = info.get("rv")
            if isinstance(rv, int) and w.last_rv is not None \
                    and now > w.last_poll_t:
                # each committed mutation advances the worker's rv by
                # one, so the rv delta IS the shard's ingested events
                w.events_per_sec = round(
                    max(0, rv - w.last_rv) / (now - w.last_poll_t), 1)
            if isinstance(rv, int):
                w.last_rv = rv
            w.last_poll_t = now
            self._export(w)

    def _export(self, w: _Worker) -> None:
        try:
            from ..metrics import metrics
            labels = {"shard": str(w.idx)}
            metrics.store_shard_worker_up.set(
                1.0 if w.alive else 0.0, labels=labels)
            if w.pid is not None:
                metrics.store_shard_worker_pid.set(w.pid, labels=labels)
            metrics.store_shard_worker_uptime_seconds.set(
                round(time.time() - w.started_at, 1) if w.alive else 0.0,
                labels=labels)
            # counter: export the absolute restart count once per change
            delta = w.restarts - metrics.store_shard_worker_restarts_total \
                .get(labels)
            if delta > 0:
                metrics.store_shard_worker_restarts_total.inc(
                    delta, labels=labels)
            metrics.store_shard_ingest_events_per_sec.set(
                w.events_per_sec, labels=labels)
        except Exception:  # noqa: BLE001 — accounting only
            pass

    # -- worker I/O ---------------------------------------------------------

    def endpoint(self, idx: int) -> str:
        return f"127.0.0.1:{self.workers[idx].port}"

    def endpoints(self) -> List[str]:
        return [self.endpoint(i) for i in range(self.n_shards)]

    def alive(self, idx: int) -> bool:
        return self.workers[idx].alive

    def connect(self, idx: int,
                timeout: Optional[float] = 5.0) -> socket.socket:
        """A fresh authed socket to worker ``idx`` (watch/ship relays
        own their streams)."""
        w = self.workers[idx]
        if not w.alive:
            raise ShardUnavailableError(
                f"store shard {idx} worker is down (restarting)")
        sock = socket.create_connection(("127.0.0.1", w.port),
                                        timeout=timeout)
        sock.settimeout(None)
        sock.sendall(MAGIC)
        if self.token:
            send_frame(sock, {"op": "auth", "token": self.token})
            resp = recv_frame(sock)
            if not resp.get("ok"):
                sock.close()
                raise_remote(resp)
        return sock

    def request(self, idx: int, payload: dict) -> dict:
        """One raw request/response against worker ``idx`` over a pooled
        socket. A send that never completed retries once on a fresh
        socket (stale pool entry); a failure AFTER the send propagates
        as the ConnectionError it is — the router's client then applies
        its own retry rules, exactly as if its own link had dropped."""
        w = self.workers[idx]
        for attempt in (0, 1):
            if not w.alive:
                raise ShardUnavailableError(
                    f"store shard {idx} worker is down (restarting)")
            with self._lock:
                sock = w.idle_socks.pop() if w.idle_socks else None
            fresh = sock is None
            sent = False
            try:
                if sock is None:
                    sock = self.connect(idx)
                send_frame(sock, payload)
                sent = True
                resp = recv_frame(sock)
            except (ConnectionError, OSError):
                if sock is not None:
                    try:
                        sock.close()
                    except OSError:
                        pass
                if sent or fresh or attempt:
                    raise
                continue  # stale pooled socket: one fresh-socket retry
            with self._lock:
                pooled = len(w.idle_socks) < _WORKER_POOL_MAX and w.alive
                if pooled:
                    w.idle_socks.append(sock)
            if not pooled:
                try:
                    sock.close()
                except OSError:
                    pass
            return resp
        raise ConnectionError(f"shard {idx} request failed")  # unreachable

    def topology(self) -> dict:
        now = time.time()
        return {
            "ok": True, "n_shards": self.n_shards,
            "endpoints": self.endpoints(),
            "workers": [{
                "shard": w.idx, "endpoint": self.endpoint(w.idx),
                "pid": w.pid, "alive": w.alive,
                "restarts": w.restarts,
                "uptime_s": round(now - w.started_at, 1)
                if w.alive else 0.0,
                "rv": w.last_rv,
                "events_per_sec": w.events_per_sec,
            } for w in self.workers],
        }


# -- the router-side store view ----------------------------------------------


class _WorkerBuckets:
    """Introspection shim: ``view._buckets[kind]`` as a {key: obj} dict
    fetched from the worker (tests and debugging tooling peek at shard
    contents this way on the in-process store)."""

    def __init__(self, sup: ShardProcSupervisor, idx: int):
        self._sup = sup
        self._idx = idx

    def __getitem__(self, kind: str) -> Dict[str, Any]:
        resp = self._sup.request(self._idx, {"op": "list", "kind": kind})
        if not resp.get("ok"):
            raise_remote(resp)
        objs = [decode(o) for o in resp["objs"]]
        return {_key(o): o for o in objs}


class _WorkerView:
    """One worker as seen from the router process: remote introspection
    (``_buckets``, ``_rv``, ``recovered_records``) over the supervisor's
    request pool."""

    def __init__(self, sup: ShardProcSupervisor, idx: int):
        self._sup = sup
        self.idx = idx
        self._buckets = _WorkerBuckets(sup, idx)

    def _info(self) -> dict:
        resp = self._sup.request(self.idx, {"op": "store_info"})
        if not resp.get("ok"):
            raise_remote(resp)
        return resp

    @property
    def _rv(self) -> int:
        return int(self._info()["rv"])

    @property
    def recovered_records(self) -> int:
        return int(self._info().get("recovered", 0))


class ProcShardedStore:
    """The ShardedClusterStore surface over worker PROCESSES: routing
    and fan-out happen here (in the router process), commits happen in
    the workers. ``dispatch`` is the router's wire path — it forwards
    the client's encoded frames verbatim, so the router never decodes an
    object it only needs to route."""

    def __init__(self, sup: ShardProcSupervisor):
        self.sup = sup
        self.n_shards = sup.n_shards
        self.data_dir = sup.data_dir
        self._mu = threading.RLock()
        self.shards = [_WorkerView(sup, i) for i in range(self.n_shards)]
        # forwarded to the router seam so a restarted worker's recovery
        # is observable (the worker re-seeded its own journal already)
        self.on_shard_recovered: Optional[Callable] = None
        sup.on_shard_recovered = self._on_recovered

    def _on_recovered(self, idx: int) -> None:
        if self.on_shard_recovered is not None:
            self.on_shard_recovered(idx, self.shards[idx])

    def locked(self):
        return self._mu

    def shard_of(self, kind: str, key: str) -> int:
        return shard_for(kind, key, self.n_shards)

    # -- the wire path (router dispatch) ------------------------------------

    def dispatch(self, op: str, req: dict) -> dict:
        if op in ("create", "update", "apply"):
            idx = self.shard_of(req.get("kind"),
                                encoded_key(req.get("obj") or {}))
            faults.fire("shard_crash")
            return self.sup.request(idx, req)
        if op in ("delete", "get"):
            ns = req.get("namespace")
            key = f"{ns}/{req['name']}" if ns is not None else req["name"]
            idx = self.shard_of(req.get("kind"), key)
            if op == "delete":
                faults.fire("shard_crash")
            return self.sup.request(idx, req)
        if op == "list":
            return self._list(req)
        if op == "bulk_apply":
            return self._bulk(req)
        if op == "store_info":
            rvs: Dict[str, Any] = {}
            durable = self.data_dir is not None
            recovered = 0
            for i in range(self.n_shards):
                info = self.sup.request(i, {"op": "store_info"})
                rvs[str(i)] = info.get("rv")
                recovered += int(info.get("recovered", 0))
            return {"ok": True, "rv": rvs, "shards": self.n_shards,
                    "durable": durable, "ship_capable": durable,
                    "recovered": recovered,
                    "pid": os.getpid()}
        if op == "topology":
            return self.sup.topology()
        if op == "bootstrap":
            idx = int(req.get("shard") or 0)
            if not 0 <= idx < self.n_shards:
                raise RuntimeError(
                    f"shard {idx} out of range (store has "
                    f"{self.n_shards})")
            # the worker is its own shard 0
            return self.sup.request(idx, dict(req, shard=0))
        if op == "fence_check":
            return self.sup.request(0, req)
        if op in ("ping", "auth"):
            return {"ok": True}
        raise RuntimeError(f"unknown op {op!r}")

    def _list(self, req: dict) -> dict:
        objs: List[Any] = []
        rvs: Dict[str, Any] = {}
        for i in range(self.n_shards):
            # a partial list during a worker outage would silently hide
            # that shard's objects — ShardUnavailableError refuses
            resp = self.sup.request(i, req)
            if not resp.get("ok"):
                return resp
            objs.extend(resp["objs"])
            rvs[str(i)] = resp.get("applied_rv")
        return {"ok": True, "objs": objs, "applied_rv": rvs}

    def _bulk(self, req: dict) -> dict:
        items = req.get("items") or []
        ack = bool(req.get("ack"))
        fencing = req.get("fencing")
        results: List[Any] = [None] * len(items)
        by_shard: Dict[int, List] = {}
        for i, it in enumerate(items):
            try:
                idx = self.shard_of(it.get("kind"),
                                    encoded_key(it.get("obj") or {}))
            except Exception as e:  # noqa: BLE001 — per-item containment
                results[i] = {"error": type(e).__name__, "message": str(e)}
                continue
            by_shard.setdefault(idx, []).append((i, it))
        sub_resp: Dict[int, Any] = {}

        def run(idx: int, sub: List) -> None:
            try:
                faults.fire("shard_crash")
                payload = {"op": "bulk_apply",
                           "items": [it for _, it in sub],
                           "fencing": fencing}
                if ack:
                    payload["ack"] = True
                sub_resp[idx] = self.sup.request(idx, payload)
            except Exception as e:  # noqa: BLE001 — contain the shard
                sub_resp[idx] = e

        # parallel per-shard dispatch: every worker commits (and fsyncs)
        # its sub-batch CONCURRENTLY in its own process — the wave costs
        # the slowest shard, not the sum
        if len(by_shard) > 1:
            threads = [threading.Thread(target=run, args=(idx, sub),
                                        name=f"bulk-shard-{idx}")
                       for idx, sub in by_shard.items()]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        else:
            for idx, sub in by_shard.items():
                run(idx, sub)
        for idx, sub in by_shard.items():
            resp = sub_resp.get(idx)
            if isinstance(resp, Exception):
                # a down (or mid-request-dead) worker costs ITS items,
                # not the wave; a ConnectionError here is ambiguous the
                # same way a dropped client link is — surfaced typed
                err = {"error": "ShardUnavailableError",
                       "message": f"store shard {idx}: "
                                  f"{type(resp).__name__}: {resp}"}
                for i, _ in sub:
                    results[i] = err
            elif not resp.get("ok"):
                err = {"error": resp.get("error", "RuntimeError"),
                       "message": resp.get("message", "bulk failed")}
                for i, _ in sub:
                    results[i] = err
            elif ack:
                errors = resp.get("errors") or {}
                for k, (i, _) in enumerate(sub):
                    results[i] = errors.get(str(k))
            else:
                for (i, _), r in zip(sub, resp["results"]):
                    results[i] = r
        if ack:
            return {"ok": True, "n": len(items),
                    "errors": {str(i): r for i, r in enumerate(results)
                               if r is not None}}
        return {"ok": True, "results": results}

    # -- the object surface (tests, in-process embedding) -------------------

    def _call(self, payload: dict) -> dict:
        resp = self.dispatch(payload["op"], payload)
        if not resp.get("ok"):
            raise_remote(resp)
        return resp

    def create(self, kind: str, obj, fencing: Optional[dict] = None):
        return decode(self._call({"op": "create", "kind": kind,
                                  "obj": encode(obj),
                                  "fencing": fencing})["obj"])

    def update(self, kind: str, obj, fencing: Optional[dict] = None):
        return decode(self._call({"op": "update", "kind": kind,
                                  "obj": encode(obj),
                                  "fencing": fencing})["obj"])

    def apply(self, kind: str, obj, fencing: Optional[dict] = None):
        return decode(self._call({"op": "apply", "kind": kind,
                                  "obj": encode(obj),
                                  "fencing": fencing})["obj"])

    def delete(self, kind: str, name: str, namespace: Optional[str] = None,
               fencing: Optional[dict] = None):
        return decode(self._call({"op": "delete", "kind": kind,
                                  "name": name, "namespace": namespace,
                                  "fencing": fencing})["obj"])

    def get(self, kind: str, name: str, namespace: Optional[str] = None):
        return decode(self._call({"op": "get", "kind": kind, "name": name,
                                  "namespace": namespace})["obj"])

    def try_get(self, kind: str, name: str,
                namespace: Optional[str] = None):
        from .store import NotFoundError
        try:
            return self.get(kind, name, namespace)
        except NotFoundError:
            return None

    def list(self, kind: str, namespace: Optional[str] = None,
             label_selector: Optional[Dict[str, str]] = None,
             name_glob: Optional[str] = None) -> List[Any]:
        resp = self._call({"op": "list", "kind": kind,
                           "namespace": namespace,
                           "label_selector": label_selector,
                           "name_glob": name_glob})
        return [decode(o) for o in resp["objs"]]

    def bulk_apply(self, items, fencing: Optional[dict] = None) -> List[Any]:
        enc = [{"kind": it[0], "obj": encode(it[1]),
                "verb": it[2] if len(it) > 2 else "apply"}
               for it in items]
        resp = self._call({"op": "bulk_apply", "items": enc,
                           "fencing": fencing})
        return [remote_error(r) if "error" in r else decode(r["obj"])
                for r in resp["results"]]

    @property
    def recovered_records(self) -> int:
        return sum(s.recovered_records for s in self.shards)

    @property
    def _rv(self) -> int:
        return max(s._rv for s in self.shards)

    def last_event_rv(self, kind: str) -> int:
        # informational (READY banners); workers own the real sequences
        return self._rv

    def close(self) -> None:
        self.sup.stop()


# -- the router ---------------------------------------------------------------


class _NullJournal:
    """The multi-process router keeps NO resume journals: each worker's
    own EventJournal (seeded from its recovered WAL tail) serves its
    shard's resume window, and watch relays forward resume requests to
    the owning workers."""

    def close(self) -> None:
        pass


class _ProcRouterHandler(_Handler):
    """The wire protocol over worker processes: unary ops route/fan via
    ProcShardedStore.dispatch (frames forwarded verbatim); watch/
    bulk_watch/ship relay the workers' already-shard-tagged frames
    byte-for-byte."""

    def _dispatch(self, store: ProcShardedStore, op: str,
                  req: dict) -> dict:
        # same contract as the in-process router: an armed shard_request
        # fault is ConnectionError-shaped and kills this connection so
        # the client's transport-retry rules engage
        faults.fire("shard_request")
        if op == "admission_info":
            # the router's own gate, plus each worker's (every worker
            # owns an independent gate — one hot shard sheds alone)
            resp = self._admission_info()
            workers: Dict[str, Any] = {}
            for i in range(store.n_shards):
                try:
                    wr = store.sup.request(i, {"op": "admission_info"})
                    workers[str(i)] = wr.get("lanes") \
                        if wr.get("ok") else None
                except Exception:  # noqa: BLE001 — down worker: no table
                    workers[str(i)] = None
            resp["workers"] = workers
            return resp
        if op == "announce_read_endpoint":
            # the registry lives on the router server (base handler);
            # workers never see announcements
            return _Handler._dispatch(self, store, op, req)
        resp = store.dispatch(op, req)
        if op == "topology" and resp.get("ok"):
            # merge the announced read tier into the worker endpoint map
            table = getattr(self.server, "read_endpoints", {}) or {}
            resp["read_endpoints"] = [
                {"endpoint": ep, "depth": meta.get("depth", 1),
                 "shards": meta.get("shards", 1)}
                for ep, meta in table.items()]
        elif op == "store_info" and resp.get("ok"):
            counts = getattr(self.server, "op_counts", None)
            resp["requests"] = dict(counts) if counts is not None else {}
        return resp

    def _serve_watch(self, sock: socket.socket, store: ProcShardedStore,
                     req: dict) -> None:
        kinds = req.get("kinds") or [req.get("kind")]
        bad = [k for k in kinds if k not in KINDS]
        if bad:
            send_frame(sock, {"ok": False, "error": "RuntimeError",
                              "message": f"unknown watch kinds {bad}"})
            return
        replay = bool(req.get("replay", True))
        since = req.get("since") or None
        sup = store.sup
        n = store.n_shards
        if since is not None:
            for kind in kinds:
                smap = since.get(kind)
                if not isinstance(smap, dict) and n != 1:
                    send_frame(sock, {
                        "ok": False, "error": "ResumeGapError",
                        "message": f"resume for {kind!r}: scalar resume "
                                   f"mark against {n} shards"})
                    return
        upstreams: List[socket.socket] = []
        stop = threading.Event()
        # bound every client send (replay phase included): a peer that
        # stalls without closing must not pin this handler thread
        sock.settimeout(WATCH_SEND_TIMEOUT_S)
        try:
            # one upstream stream per worker; each worker replays its
            # own objects / its own journal window and stamps its shard
            # tag, so this relay forwards frames verbatim
            for i in range(n):
                try:
                    usock = sup.connect(i)
                except Exception as e:  # noqa: BLE001 — typed refusal
                    send_frame(sock, {
                        "ok": False, "error": "ShardUnavailableError",
                        "message": f"store shard {i}: {e}"})
                    return
                upstreams.append(usock)
                ureq: dict = {"op": req.get("op", "watch"),
                              "kinds": kinds, "replay": replay}
                if req.get("delta"):
                    # forward the delta ask verbatim: workers emit the
                    # delta frames; this relay stays byte-verbatim
                    ureq["delta"] = True
                if since is not None:
                    ureq["replay"] = False
                    ureq["since"] = {
                        k: (since.get(k) if isinstance(since.get(k), dict)
                            else {"0": since.get(k)})
                        for k in kinds}
                send_frame(usock, ureq)
            # phase 1: drain each upstream to its synced marker, relaying
            # replay frames; hold the synced frames back and emit ONE
            # merged {kind: {shard: rv}} marker (the client returns from
            # its inline replay at the first synced it sees)
            synced_rv: Dict[str, Dict[str, Any]] = {k: {} for k in kinds}
            # delta merge: every worker must have negotiated delta for
            # the merged stream to be delta (fail-safe: one old worker
            # quietly demotes the whole stream to object frames — the
            # client simply sees its ask declined)
            delta_ok = bool(req.get("delta"))
            synced_vtab: Dict[str, dict] = {}
            synced_ks: Dict[str, Dict[str, int]] = {k: {} for k in kinds}
            for i, usock in enumerate(upstreams):
                while True:
                    raw = recv_frame_raw(usock)
                    msg = json.loads(raw)
                    if msg.get("ok") is False:
                        send_frame_raw(sock, raw)  # e.g. ResumeGapError
                        return
                    stream = msg.get("stream")
                    if stream == "synced":
                        for k, val in (msg.get("rv") or {}).items():
                            if isinstance(val, dict):
                                synced_rv.setdefault(k, {}).update(val)
                            else:
                                synced_rv.setdefault(k, {})[str(i)] = val
                        if delta_ok:
                            if msg.get("delta"):
                                # vtab is {kind: {shard: entries}} and
                                # workers own disjoint shards, so the
                                # per-kind inner maps merge cleanly
                                for k, m in (msg.get("vtab")
                                             or {}).items():
                                    synced_vtab.setdefault(
                                        k, {}).update(m)
                                for k, m in (msg.get("ks") or {}).items():
                                    synced_ks.setdefault(k, {}).update(m)
                            else:
                                delta_ok = False
                        break
                    if stream in ("event", "events"):
                        send_frame_raw(sock, raw)
                    # heartbeats are dropped during the open phase
            merged: dict = {"stream": "synced", "rv": synced_rv}
            if delta_ok:
                merged["delta"] = True
                merged["vtab"] = synced_vtab
                merged["ks"] = synced_ks
            send_frame(sock, merged)
            # phase 2: pure byte relay — N reader threads feed one
            # writer (this thread), which serializes frames onto the
            # client socket
            frames: "queue.Queue" = queue.Queue(maxsize=WATCH_QUEUE_MAX)

            def pump_up(us: socket.socket) -> None:
                try:
                    while not stop.is_set():
                        frames.put(recv_frame_raw(us),
                                   timeout=WATCH_SEND_TIMEOUT_S)
                except (ConnectionError, OSError, ValueError,
                        queue.Full):
                    pass
                finally:
                    stop.set()
                    try:
                        frames.put_nowait(_EOF)
                    except queue.Full:
                        pass

            readers = [threading.Thread(target=pump_up, args=(us,),
                                        daemon=True,
                                        name=f"watch-relay-{i}")
                       for i, us in enumerate(upstreams)]
            for t in readers:
                t.start()
            while True:
                try:
                    raw = frames.get(timeout=1.0)
                except queue.Empty:
                    if stop.is_set():
                        break  # an upstream died: condemn this stream;
                    continue   # the client resumes via since:
                if raw is _EOF:
                    break
                send_frame_raw(sock, raw)
        except (ConnectionError, OSError, socket.timeout, ValueError):
            pass  # peer (or a worker) went away
        finally:
            stop.set()
            for us in upstreams:
                try:
                    us.close()
                except OSError:
                    pass

    def _serve_ship(self, sock: socket.socket, store: ProcShardedStore,
                    req: dict) -> None:
        """Relay a WAL ship stream to the worker owning the requested
        shard lineage (the worker is its own shard 0) — replicas can
        ride the router, or tail the worker endpoint directly (see the
        ``topology`` op)."""
        idx = int(req.get("shard") or 0)
        if not 0 <= idx < store.n_shards:
            send_frame(sock, {"ok": False, "error": "RuntimeError",
                              "message": f"shard {idx} out of range "
                                         f"(store has {store.n_shards})"})
            return
        try:
            usock = store.sup.connect(idx)
        except Exception as e:  # noqa: BLE001 — typed refusal
            send_frame(sock, {"ok": False,
                              "error": "ShardUnavailableError",
                              "message": f"store shard {idx}: {e}"})
            return
        try:
            send_frame(usock, dict(req, shard=0))
            sock.settimeout(WATCH_SEND_TIMEOUT_S)
            while True:
                send_frame_raw(sock, recv_frame_raw(usock))
        except (ConnectionError, OSError, socket.timeout, ValueError):
            pass
        finally:
            try:
                usock.close()
            except OSError:
                pass


class ProcShardRouter(StoreServer):
    """One endpoint, the existing wire protocol, N worker PROCESSES
    behind it. Thin by construction: it supervises (via the store's
    ShardProcSupervisor), proxies cross-shard ops, relays streams, and
    serves the ``topology`` op direct-routing clients bootstrap from —
    single-key traffic can bypass it entirely."""

    handler_class = _ProcRouterHandler

    def __init__(self, store: ProcShardedStore, host: str = "127.0.0.1",
                 port: int = 0, token: Optional[str] = None,
                 tls_cert: Optional[str] = None,
                 tls_key: Optional[str] = None,
                 tls_client_ca: Optional[str] = None, gate=None):
        super().__init__(store, host=host, port=port, token=token,
                         tls_cert=tls_cert, tls_key=tls_key,
                         tls_client_ca=tls_client_ca, gate=gate)

    def _make_journal(self, store):
        return _NullJournal()


if __name__ == "__main__":
    raise SystemExit(main())
