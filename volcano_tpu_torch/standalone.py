"""Standalone dev cluster: every component in one process.

The reference deploys three binaries against a Kubernetes API server
(installer/volcano-development.yaml). This module is this package's
single-process equivalent for development and e2e use: one ClusterStore
plays the API server, and around it run

- the admission chain (in-process interceptors + optional TLS server),
- the controller manager (job/queue/podgroup/kubelet-standin/gc),
- the scheduler loop (solver on the CUDA device, or via the solver
  sidecar),
- the metrics endpoint (/metrics, /healthz, /debug/stacks).

``python -m volcano_tpu_torch.standalone [--conf scheduler.yaml]
[--period 1.0] [--serve-webhooks] [--sidecar /path/to.sock]
[--metrics-port 8080] [--device cpu]``

The scheduler's arena lives on the CUDA device unless ``device="cpu"``
(``--device cpu``) is given; without a CUDA device and without it the
constructor raises. The replica-only mode (``--store-replica-of``) builds
no scheduler and needs no device.

Jobs are submitted with the in-process CLI against the same store when
embedding, or by pointing --jobs-dir at a directory of job YAMLs (each
file is applied once; the reference's e2e suites submit via vcctl).
"""

from __future__ import annotations

import argparse
import logging
import os
import threading
import time
from typing import Optional

log = logging.getLogger(__name__)


class Standalone:
    def __init__(self, scheduler_conf: Optional[str] = None,
                 period: float = 1.0, serve_webhooks_tls: bool = False,
                 sidecar_path: Optional[str] = None,
                 metrics_port: int = 0,
                 async_effectors: bool = True,
                 serve_store: Optional[str] = None,
                 webhook_client_ca: Optional[str] = None,
                 webhook_bind: Optional[str] = None,
                 store_token: Optional[str] = None,
                 scheduler_name: str = "volcano",
                 default_queue: str = "default",
                 percentage_of_nodes_to_find: int = 100,
                 leader_elect: bool = False,
                 compile_cache_dir: Optional[str] = None,
                 prewarm: bool = False,
                 pipeline_solver: bool = True,
                 pipeline_effects: bool = False,
                 action_deadline_s: Optional[float] = None,
                 breaker_failures: int = 3,
                 breaker_cooldown_s: float = 30.0,
                 sim_record: Optional[str] = None,
                 sim_trace: Optional[str] = None,
                 solver_mode: Optional[str] = None,
                 sharded_byte_budget: int = 0,
                 reschedule_interval: int = 0,
                 reschedule_max_moves: Optional[int] = None,
                 reschedule_max_disruption: Optional[int] = None,
                 reschedule_min_improvement: Optional[float] = None,
                 store_data_dir: Optional[str] = None,
                 store_fsync: str = "every",
                 store_fsync_interval_s: float = 0.05,
                 store_snapshot_every: int = 4096,
                 store_shards: int = 1,
                 store_shard_procs: bool = False,
                 controller_shard_workers: int = 1,
                 admission_lanes: Optional[str] = None,
                 admission_queue_wait_ms: Optional[float] = None,
                 controllers_read_endpoint: Optional[str] = None,
                 device=None):
        from .cache import SchedulerCache
        from .client import ClusterStore
        from .controllers import ControllerManager
        from .metrics.server import MetricsServer
        from .scheduler import Scheduler
        from .webhooks import start_webhooks

        # overload-protected front door (resilience/overload.py): every
        # served endpoint gets an admission gate — fail-safe defaults
        # (gate on, generous limits) unless --admission-lanes tightens
        # them; shard WORKERS each get their own gate via the supervisor
        from .resilience.overload import AdmissionGate, parse_lane_spec

        def make_gate():
            kw = {}
            if admission_queue_wait_ms is not None:
                kw["queue_wait_ms"] = admission_queue_wait_ms
            return AdmissionGate(parse_lane_spec(admission_lanes), **kw)

        self._shard_supervisor = None
        if store_shard_procs:
            # every shard in its OWN OS process (the multi-process
            # front door, client/shardproc.py): workers own their
            # lock/rv/journal/WAL lineages AND run the admission chain
            # at the authoritative store; a thin ProcShardRouter in
            # this process supervises them and serves one endpoint,
            # and this process's own consumers (cache, controllers,
            # scheduler) ride a direct-routing RemoteClusterStore —
            # single-key traffic bypasses the router like any other
            # client's.
            from .client import (
                ProcShardRouter, ProcShardedStore, RemoteClusterStore,
                ShardProcSupervisor,
            )
            host, port = "127.0.0.1", 0
            if serve_store:
                h, _, p = serve_store.rpartition(":")
                host, port = (h or "127.0.0.1"), int(p)
            token = store_token if store_token is not None \
                else os.environ.get("VOLCANO_STORE_TOKEN", "")
            if not token and host not in ("127.0.0.1", "localhost",
                                          "::1"):
                raise ValueError(
                    f"--serve-store on non-loopback {host!r} requires "
                    "a shared token (set VOLCANO_STORE_TOKEN)")
            self._shard_supervisor = ShardProcSupervisor(
                max(1, store_shards),
                data_dir=store_data_dir or None,
                fsync=store_fsync,
                fsync_interval_s=store_fsync_interval_s,
                snapshot_every=store_snapshot_every,
                token=token or None,
                scheduler_name=scheduler_name,
                default_queue=default_queue,
                admission_lanes=admission_lanes,
                admission_queue_wait_ms=admission_queue_wait_ms).start()
            self.store_server = ProcShardRouter(
                ProcShardedStore(self._shard_supervisor),
                host, port, token=token or None,
                gate=make_gate()).start()
            self.store = RemoteClusterStore(
                self.store_server.address, token=token or None,
                direct_watch=True)
        elif store_shards > 1:
            # the partitioned front door: N member
            # stores behind deterministic (kind, namespace/name) hash
            # routing, each with its own lock, resume journal and —
            # with --store-data-dir — its own WAL+snapshot lineage under
            # data_dir/shard-NNN (each shard recovers from only its own
            # WAL). shards=1 keeps the exact historical code paths.
            from .client import ShardedClusterStore
            self.store = ShardedClusterStore(
                store_shards, data_dir=store_data_dir or None,
                fsync=store_fsync,
                fsync_interval_s=store_fsync_interval_s,
                snapshot_every=store_snapshot_every)
        elif store_data_dir:
            # durable control plane: WAL + snapshots under the data dir,
            # recovery (snapshot load + WAL replay) happens right here in
            # the constructor — jobs, leases and both intent journals
            # survive a store crash. The in-memory default stays untouched.
            from .client import DurableClusterStore
            self.store = DurableClusterStore(
                store_data_dir, fsync=store_fsync,
                fsync_interval_s=store_fsync_interval_s,
                snapshot_every=store_snapshot_every)
        else:
            self.store = ClusterStore()
        # admission interceptors must be installed BEFORE the store starts
        # accepting remote writes, or an early vcctl create slips past the
        # webhook chain (recovery above bypasses admission by design: the
        # recovered objects were admitted when they first committed).
        # With --store-shard-procs the chain already runs INSIDE each
        # worker process (the authoritative store); this process is just
        # another client and must not (and cannot) install interceptors.
        if self._shard_supervisor is None:
            start_webhooks(self.store, scheduler_name=scheduler_name,
                           default_queue=default_queue)
        else:
            serve_store = None  # the ProcShardRouter above IS the server
        if self._shard_supervisor is None:
            self.store_server = None
        if serve_store:
            # the API-server seam as an actual server: vcctl --server and
            # remote scheduler caches drive this store over TCP
            from .client import StoreServer
            host, _, port = serve_store.rpartition(":")
            host = host or "127.0.0.1"
            token = store_token if store_token is not None \
                else os.environ.get("VOLCANO_STORE_TOKEN", "")
            if not token and host not in ("127.0.0.1", "localhost", "::1"):
                # the store holds Secrets and the HA lease; exposing it
                # unauthenticated beyond loopback hands cluster control
                # to anything that can reach the port
                raise ValueError(
                    f"--serve-store on non-loopback {host!r} requires a "
                    "shared token (set VOLCANO_STORE_TOKEN)")
            tls_cert = os.environ.get("VOLCANO_STORE_TLS_CERT") or None
            tls_key = os.environ.get("VOLCANO_STORE_TLS_KEY") or None
            tls_ca = os.environ.get("VOLCANO_STORE_CLIENT_CA") or None
            if (tls_cert is None) != (tls_key is None):
                raise ValueError(
                    "VOLCANO_STORE_TLS_CERT and VOLCANO_STORE_TLS_KEY "
                    "must be set together")
            if not (tls_cert and tls_key) and host not in (
                    "127.0.0.1", "localhost", "::1"):
                # plaintext beyond loopback leaks the token and every
                # Secret to the network path; allow it only when the
                # operator explicitly claims link-layer encryption
                if os.environ.get(
                        "VOLCANO_STORE_ALLOW_PLAINTEXT") != "1":
                    raise ValueError(
                        f"--serve-store on non-loopback {host!r} without "
                        "TLS (set VOLCANO_STORE_TLS_CERT/"
                        "VOLCANO_STORE_TLS_KEY, or acknowledge an "
                        "encrypted network layer with "
                        "VOLCANO_STORE_ALLOW_PLAINTEXT=1)")
            server_cls = StoreServer
            if store_shards > 1:
                # same wire protocol, one endpoint, N shards behind it
                from .client import ShardRouter
                server_cls = ShardRouter
            self.store_server = server_cls(
                self.store, host, int(port), token=token,
                tls_cert=tls_cert, tls_key=tls_key,
                tls_client_ca=tls_ca, gate=make_gate()).start()
        self.webhook_server = None
        if serve_webhooks_tls:
            from .webhooks import serve_webhooks
            wh_host, wh_port = "127.0.0.1", 0
            if webhook_bind:
                h, _, p = webhook_bind.rpartition(":")
                wh_host, wh_port = (h or "127.0.0.1"), int(p)
            if wh_host not in ("127.0.0.1", "localhost", "::1") \
                    and not webhook_client_ca:
                # same fail-closed rule as the store port: an admission
                # endpoint reachable beyond loopback must authenticate
                # its clients
                raise ValueError(
                    f"--webhook-bind on non-loopback {wh_host!r} requires "
                    "--webhook-client-ca (mutual TLS)")
            self.webhook_server = serve_webhooks(
                self.store, host=wh_host, port=wh_port,
                client_ca_path=webhook_client_ca,
                scheduler_name=scheduler_name,
                default_queue=default_queue)
            self.webhook_server.start_background()
        self.cache = SchedulerCache(self.store,
                                    scheduler_name=scheduler_name,
                                    async_effectors=async_effectors,
                                    device=device)
        # --sim-record: attach the sim's decision recorder to the LIVE
        # control plane — every cycle's binds/evicts/pipelines/FitErrors
        # append to the JSONL trace (non-strict: live traces timestamp
        # with wall time; reproducibility is the virtual-clock sim's job)
        self._turn = 0
        self.sim_recorder = None
        self._sim_record_file = None
        if sim_record:
            from .cache import RecordingBinder, RecordingEvictor
            from .sim.recorder import DecisionRecorder
            self._sim_record_file = open(sim_record, "a")
            rec = DecisionRecorder(clock=lambda: time.time(),
                                   sink=self._sim_record_file,
                                   strict=False)
            self.sim_recorder = rec
            self.cache.decision_recorder = rec
            self.cache.binder = RecordingBinder(
                self.cache.binder,
                on_bind=lambda pod, h: rec.record_bind(
                    f"{pod.namespace}/{pod.name}", h))
            self.cache.evictor = RecordingEvictor(
                self.cache.evictor,
                on_evict=lambda pod, r: rec.record_evict(
                    f"{pod.namespace}/{pod.name}", r))
        # --sim-trace: drive this control plane from a recorded workload
        # trace (sim/workload.py JSONL) — each control-plane turn submits
        # the events whose arrival cycle has come due
        self._sim_events = []
        if sim_trace:
            from .sim.workload import Workload
            wl = Workload.load(sim_trace)
            self._sim_events = sorted(wl.events, key=lambda e: int(e["t"]))
            # the trace's queues/priority classes must exist before its
            # jobs are admitted (the jobs webhook rejects unknown queues),
            # and the header's node pool is materialized so the trace is
            # actually runnable — in standalone the ClusterStore IS the
            # cluster, there are no real kubelets to register nodes
            self.store.bulk_apply(
                [("queues", q) for q in wl.queue_objects()]
                + [("priorityclasses", pc)
                   for pc in wl.priority_class_objects()]
                + [("nodes", node) for node in wl.node_objects()
                   if self.store.try_get("nodes", node.name) is None])
        if sidecar_path:
            from .parallel.sidecar import SidecarSolver
            self.cache.sidecar = SidecarSolver(sidecar_path)
        self.cache.run()
        # controller traffic rides the CONTROL admission lane: when the
        # store is a remote client (shard-procs mode) the LaneStore view
        # tags every controller op so the gate can shed read storms
        # without starving the control plane's own feedback loops
        ctrl_store = self.store
        if self._shard_supervisor is not None:
            from .resilience.overload import LaneStore
            ctrl_store = LaneStore(self.store, "control")
        # --controllers-read-endpoint: serve the controllers' steady-
        # state reads (list/watch/bulk_watch) from a replica endpoint
        # while their mutations keep flowing here;
        # read-your-writes holds via the min_rv bound (client/readtier)
        self._controllers_read_client = None
        ctrl_read = None
        if controllers_read_endpoint:
            from .client import RemoteClusterStore
            self._controllers_read_client = RemoteClusterStore(
                controllers_read_endpoint,
                token=store_token if store_token is not None
                else os.environ.get("VOLCANO_STORE_TOKEN", ""),
                direct_routing=False)
            ctrl_read = self._controllers_read_client
        self.controllers = ControllerManager(
            ctrl_store, scheduler_name=scheduler_name,
            default_queue=default_queue,
            shard_workers=controller_shard_workers,
            read_store=ctrl_read)
        self.controllers.run()
        self.scheduler = Scheduler(
            self.cache, scheduler_conf=scheduler_conf, period=period,
            percentage_of_nodes_to_find=percentage_of_nodes_to_find,
            compile_cache_dir=compile_cache_dir, prewarm=prewarm,
            pipeline_solver=pipeline_solver,
            action_deadline_s=action_deadline_s,
            breaker_failures=breaker_failures,
            breaker_cooldown_s=breaker_cooldown_s,
            solver_mode=solver_mode,
            sharded_byte_budget=sharded_byte_budget,
            reschedule_interval=reschedule_interval,
            reschedule_max_moves=reschedule_max_moves,
            reschedule_max_disruption=reschedule_max_disruption,
            reschedule_min_improvement=reschedule_min_improvement)
        # pipeline_effects: don't drain the async bind effectors between
        # control-plane turns — cycle N's API writes overlap cycle N+1's
        # snapshot+flatten (see Scheduler.run). Off by default: embedding
        # tests want each run_once() deterministic and fully applied.
        self.pipeline_effects = pipeline_effects
        self.leader_elect = leader_elect
        self._elector = None
        self.metrics_server = MetricsServer(port=metrics_port).start()
        self._stop = threading.Event()

    def run_once(self, drain_effects: bool = True) -> None:
        """One control-plane turn: controllers drain, scheduler cycles.
        ``drain_effects=False`` (the run() loop under pipeline_effects)
        leaves async binds in flight so they overlap the next turn."""
        while self._sim_events and int(self._sim_events[0]["t"]) \
                <= self._turn:
            # --sim-trace arrivals due this turn, submitted as Jobs so
            # they take the full admission + job-controller path
            from .sim.workload import build_job_crd
            self.store.create("jobs",
                              build_job_crd(self._sim_events.pop(0)))
        rec = self.sim_recorder
        if rec is not None:
            rec.begin_cycle(self._turn)
        self.controllers.process_all()
        self.scheduler.run_once()
        if drain_effects:
            # land the cycle's async binds before the controllers' second
            # pass, so a drained turn ends as an inline-bind turn does.
            # Deliberately not the JAX package's order (volcano_tpu/
            # standalone.py:356-358), which drains after that pass: there
            # the pass races the effector threads, and a bind that lands
            # late leaves its job Pending for one more turn
            self.cache.wait_for_effects()
        self.controllers.process_all()
        if rec is not None:
            rec.end_cycle(self.scheduler.last_cycle_timing)
        self._turn += 1

    def run(self) -> None:
        if self.leader_elect:
            # HA mode (cmd/scheduler/app/server.go:85-145): only the
            # lease holder turns the control plane; a standby pointed at
            # the same (remote) store takes over when the lease expires
            from .utils import LeaderElector, LeaseLock

            elector = LeaderElector(LeaseLock(self.store, "volcano"))
            self._elector = elector
            # release is deferred to stop(): the SIGTERM contract hands
            # the lease over only after the async bind effectors drained
            renewer = threading.Thread(target=elector.run,
                                       args=(self._stop,),
                                       kwargs={"release_on_stop": False},
                                       name="leader-elector", daemon=True)
            renewer.start()
        while not self._stop.is_set():
            if self._elector is not None and not self._elector.is_leader:
                self._stop.wait(0.05)
                continue
            t0 = time.time()
            try:
                self.run_once(drain_effects=not self.pipeline_effects)
            except Exception:
                log.exception("control-plane turn failed")
            delay = self.scheduler.period - (time.time() - t0)
            if delay > 0:
                self._stop.wait(delay)

    def stop(self) -> None:
        self._stop.set()
        self.cache.wait_for_effects()  # land in-flight pipelined binds
        if self._elector is not None:
            # release AFTER the drain: a standby taking over mid-drain
            # would race this process's last bind writes
            self._elector.release()
        if self._sim_record_file is not None:
            self._sim_record_file.close()
            self._sim_record_file = None
        self.metrics_server.stop()
        if self.store_server is not None:
            self.store_server.stop()
        if self._shard_supervisor is not None:
            self._shard_supervisor.stop()
        if self.webhook_server is not None:
            self.webhook_server.shutdown()
        if self._controllers_read_client is not None:
            self._controllers_read_client.close()
        close = getattr(self.store, "close", None)
        if close is not None:
            close()  # flush + fsync the WAL (recovery never depends on it)

    def apply_job_yaml(self, text: str) -> None:
        import yaml

        from .cli.vcctl import _job_from_yaml

        self.store.create("jobs", _job_from_yaml(yaml.safe_load(text)))


#: seconds a replica-only process waits to apply what its upstream held
#: at its start before it gives up (and exits) without serving
REPLICA_CATCH_UP_WAIT_S = 300.0


def run_replica(primary: str, serve: str, metrics_port: int = 0,
                admission_lanes: Optional[str] = None,
                admission_queue_wait_ms: Optional[float] = None) -> int:
    """Replica-only process mode (``--store-replica-of``): no scheduler,
    no controllers, no webhooks — bootstrap from the primary's newest
    snapshot, tail its shipped WAL, and serve the read tier
    (list/get/watch/bulk_watch with explicit rv-bounded staleness;
    mutations fail closed with ReplicaReadOnlyError).

    It serves only once it has applied what the upstream held when it
    started. This deliberately deviates from the JAX package's order
    (``volcano_tpu/standalone.py:457-462``: serve, then start the
    tailers): a restarted mid-tier that serves while it still replays
    hands a resuming child records the child already holds, the child
    meets an rv gap, re-bootstraps behind its own watchers' marks, and
    they cannot resume."""
    import signal

    from .client import ReplicaStore
    from .metrics.server import MetricsServer

    host, _, port = serve.rpartition(":")
    host = host or "127.0.0.1"
    token = os.environ.get("VOLCANO_STORE_TOKEN", "")
    if not token and host not in ("127.0.0.1", "localhost", "::1"):
        # the replica mirrors Secrets and the HA lease: the same
        # fail-closed exposure rule as --serve-store applies
        raise ValueError(
            f"--serve-replica on non-loopback {host!r} requires a "
            "shared token (set VOLCANO_STORE_TOKEN)")
    tls_cert = os.environ.get("VOLCANO_STORE_TLS_CERT") or None
    tls_key = os.environ.get("VOLCANO_STORE_TLS_KEY") or None
    replica = ReplicaStore(primary, token=token or None,
                           tls_ca=os.environ.get("VOLCANO_STORE_CA")
                           or None)
    # the replica IS the read tier: its gate sheds list/watch storms
    # typed instead of letting them starve the tailer keeping it fresh
    from .resilience.overload import AdmissionGate, parse_lane_spec
    gate_kw = {}
    if admission_queue_wait_ms is not None:
        gate_kw["queue_wait_ms"] = admission_queue_wait_ms
    replica.start()
    replica.wait_applied(replica._client._request({"op": "store_info"})["rv"],
                         wait_s=REPLICA_CATCH_UP_WAIT_S)
    server = replica.serve(host, int(port), token=token or None,
                           tls_cert=tls_cert, tls_key=tls_key,
                           gate=AdmissionGate(
                               parse_lane_spec(admission_lanes),
                               **gate_kw))
    metrics_server = MetricsServer(port=metrics_port).start()
    print(f"volcano-tpu-torch replica up; following {primary}; serving reads "
          f"on {server.address}; metrics on :{metrics_server.port}",
          flush=True)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_a: stop.set())
    try:
        while not stop.is_set():
            stop.wait(1.0)
    except KeyboardInterrupt:
        pass
    finally:
        metrics_server.stop()
        replica.close()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="volcano-tpu-torch-standalone")
    ap.add_argument("--conf", help="scheduler conf YAML path")
    ap.add_argument("--period", type=float, default=1.0)
    ap.add_argument("--serve-webhooks", action="store_true",
                    help="also serve admission over TLS")
    ap.add_argument("--sidecar", help="solver sidecar socket path (the "
                    "sidecar process owns the card; this process then "
                    "needs none: pass --device cpu)")
    ap.add_argument("--device", default=None,
                    help="torch device of the scheduler's arena (default: "
                         "the CUDA device; 'cpu' runs on the host)")
    ap.add_argument("--metrics-port", type=int, default=8080)
    ap.add_argument("--jobs-dir", help="apply every .yaml job in this dir")
    ap.add_argument("--webhook-client-ca", metavar="CA_PEM",
                    help="require mutual TLS on the admission server: "
                         "only clients presenting a cert signed by this "
                         "CA may drive admission")
    ap.add_argument("--webhook-bind", metavar="[HOST:]PORT",
                    help="admission server bind address (default "
                         "loopback, ephemeral port — a deployment that "
                         "advertises a webhook Service must set this)")
    ap.add_argument("--serve-store", metavar="[HOST:]PORT",
                    help="serve the cluster store over TCP so vcctl "
                         "--server and remote components can drive this "
                         "control plane; non-loopback binds require "
                         "VOLCANO_STORE_TOKEN (shared-secret auth)")
    ap.add_argument("--store-data-dir", metavar="DIR",
                    help="make the cluster store DURABLE: every committed "
                         "mutation appends one fsync'd record to a "
                         "write-ahead log under DIR, compacted into "
                         "snapshots; on start the store recovers (newest "
                         "valid snapshot + WAL tail replay) so jobs, "
                         "leases and the bind/migration intent journals "
                         "survive a store crash. Default: in-memory, "
                         "nothing touches disk")
    ap.add_argument("--store-fsync", default="every",
                    choices=["every", "interval", "off"],
                    help="WAL durability: 'every' fsyncs each commit "
                         "(acked => durable), 'interval' group-commits "
                         "(at most one fsync per --store-fsync-interval; "
                         "a crash can lose the last interval), 'off' "
                         "never fsyncs (survives process kill, not "
                         "power loss)")
    ap.add_argument("--store-fsync-interval", type=float, default=0.05,
                    metavar="SECS",
                    help="group-commit window for --store-fsync interval")
    ap.add_argument("--store-snapshot-every", type=int, default=4096,
                    metavar="N",
                    help="WAL records between snapshot compactions "
                         "(bounds both recovery replay length and "
                         "on-disk log growth)")
    ap.add_argument("--store-shards", type=int, default=1, metavar="N",
                    help="partition the cluster store into N shards "
                         "keyed by (kind, namespace/name) hash, each "
                         "with its own lock, watch-resume journal and "
                         "(with --store-data-dir) its own WAL+snapshot "
                         "lineage; --serve-store then serves all shards "
                         "through one endpoint speaking the unchanged "
                         "wire protocol. Default 1: the exact "
                         "historical single-store code paths")
    ap.add_argument("--store-shard-procs", action="store_true",
                    help="promote each store shard to its OWN OS "
                         "process (break the GIL): shard workers own "
                         "their WAL lineages and run admission; a thin "
                         "router in this process supervises them "
                         "(capped-backoff restart on the same data "
                         "dir), serves one endpoint on --serve-store, "
                         "and publishes the shard map via the "
                         "'topology' op so clients route single-key "
                         "ops straight to the owning worker")
    ap.add_argument("--store-replica-of", metavar="HOST:PORT",
                    dest="store_replica_of",
                    help="run as a READ REPLICA of the durable store at "
                         "HOST:PORT (a --serve-store primary with "
                         "--store-data-dir): bootstrap from its newest "
                         "snapshot, tail its shipped WAL, and serve "
                         "list/watch with explicit rv-bounded staleness "
                         "on --serve-replica. Replica mode runs NO "
                         "scheduler/controllers; mutations against the "
                         "replica fail closed")
    ap.add_argument("--serve-replica", metavar="[HOST:]PORT",
                    dest="serve_replica",
                    help="bind address for the replica read endpoint "
                         "(requires --store-replica-of; same wire "
                         "protocol and auth/TLS rules as --serve-store)")
    ap.add_argument("--admission-lanes", default=None, metavar="SPEC",
                    help="per-lane overload-admission bounds for every "
                         "served store endpoint (and, with "
                         "--store-shard-procs, each worker's own gate): "
                         "lane=inflight[:queue[:streams]] comma-"
                         "separated, 0 = unbounded. Lanes: system "
                         "(fenced writes/leases — never shed), control "
                         "(controller syncs, bulk_watch/resume), bulk "
                         "(bulk_apply waves), read (lists/gets/plain "
                         "watch — sheds first). Default: gate ON with "
                         "generous fail-safe limits "
                         "(control=64:256, bulk=32:128, read=64:1024); "
                         "an unloaded deployment is protocol-"
                         "indistinguishable from an ungated one. "
                         "Example: read=16:64:32,bulk=8:32")
    ap.add_argument("--admission-queue-wait-ms", type=float,
                    default=None, metavar="MS",
                    help="max milliseconds a request waits in a full "
                         "admission lane before it is shed with a "
                         "typed OverloadedError + retry-after hint "
                         "(default 2000; requests carrying a tighter "
                         "wire deadline_ms shed at that instead)")
    ap.add_argument("--controllers-read-endpoint", metavar="HOST:PORT",
                    dest="controllers_read_endpoint",
                    help="serve the controllers' list/watch/bulk_watch "
                         "from the replica at HOST:PORT (any depth in a "
                         "fan-out tree) while their mutations keep "
                         "flowing to this process's store; read-your-"
                         "writes holds via the min_rv bound, and a "
                         "lagging/unreachable replica degrades reads "
                         "back to the primary, typed and counted")
    ap.add_argument("--controller-shard-workers", type=int, default=1,
                    metavar="N",
                    help="fan the job controller's sync drain out "
                         "across N workers partitioned by store shard "
                         "(key affinity preserved); default 1 = the "
                         "historical serial drain")
    ap.add_argument("--scheduler-name", default="volcano",
                    help="only schedule pods/jobs naming this scheduler "
                         "(options.go: --scheduler-name)")
    ap.add_argument("--default-queue", default="default",
                    help="queue assigned to jobs/podgroups that name "
                         "none (options.go: --default-queue)")
    ap.add_argument("--percentage-nodes-to-find", type=int, default=100,
                    help="adaptive node sampling target percentage "
                         "(options.go: --percentage-nodes-to-find)")
    ap.add_argument("--leader-elect", action="store_true",
                    help="contend on the 'volcano' lease; only the "
                         "holder runs control-plane turns")
    ap.add_argument("--compile-cache-dir", metavar="DIR",
                    help="kernel build directory (default "
                         "$VOLCANO_COMPILE_CACHE_DIR): a kernel library "
                         "already built there is reused, so restarts "
                         "skip the nvcc build")
    ap.add_argument("--prewarm", action="store_true",
                    help="solve the next bucket's packed layout once on "
                         "a background thread when occupancy nears the "
                         "current bucket, so its first cycle is warm")
    ap.add_argument("--serial-solver", action="store_true",
                    help="disable the allocate dispatch/collect overlap "
                         "(debug/parity; decisions are identical)")
    ap.add_argument("--pipeline-effects", action="store_true",
                    help="overlap async bind writes with the next "
                         "control-plane turn instead of draining between "
                         "turns")
    ap.add_argument("--action-deadline", type=float, default=None,
                    metavar="SECS",
                    help="contain any scheduling action exceeding this "
                         "deadline (faulthandler stack dump + statement "
                         "discard; remaining actions still run). Default: "
                         "no deadline")
    ap.add_argument("--breaker-failures", type=int, default=3,
                    help="consecutive device-solver failures that open "
                         "the circuit breaker (host-oracle fallback)")
    ap.add_argument("--breaker-cooldown", type=float, default=30.0,
                    metavar="SECS",
                    help="seconds the breaker stays open before a "
                         "half-open probe re-tries the device path")
    ap.add_argument("--sim-record", metavar="PATH",
                    help="append every cycle's decision record (binds/"
                         "evictions/pipelines/FitErrors, breaker state) "
                         "to PATH as JSONL — the live counterpart of the "
                         "simulator's golden traces")
    ap.add_argument("--sim-trace", metavar="PATH",
                    help="drive this control plane from a sim workload "
                         "trace (sim/ JSONL, either package's): arrivals "
                         "submit as Jobs when their cycle comes due")
    ap.add_argument("--solver-mode", default=None,
                    choices=["packed", "sharded", "auto"],
                    help="device-solver routing when the scheduler conf "
                         "leaves the allocate mode implicit: packed = "
                         "single-device device-resident arena, sharded = "
                         "node-axis sharded solver over the sharded "
                         "arena, auto = shard exactly when the padded "
                         "problem's device-resident footprint (one full "
                         "upload at the measured layout) exceeds "
                         "--sharded-byte-budget bytes per device")
    ap.add_argument("--sharded-byte-budget", type=int,
                    default=256 * 1024 * 1024, metavar="BYTES",
                    help="per-device resident-state budget for "
                         "--solver-mode auto (default 256 MiB; the first "
                         "session always runs packed — no layout has "
                         "been measured yet)")
    ap.add_argument("--reschedule-interval", type=int, default=0,
                    metavar="N",
                    help="enable the global rescheduler without a conf "
                         "edit: run the device-solved defrag pass every "
                         "N scheduling cycles (0 = off; a conf naming "
                         "the reschedule action places it explicitly). "
                         "Conf-file equivalent: reschedule.interval in "
                         "the action's configurations block")
    ap.add_argument("--reschedule-max-moves", type=int, default=None,
                    metavar="K",
                    help="migration budget per defrag plan (default 8; "
                         "conf: reschedule.maxMoves)")
    ap.add_argument("--reschedule-max-disruption-per-job", type=int,
                    default=None, metavar="K",
                    dest="reschedule_max_disruption",
                    help="PDB-style per-job disruption cap per plan "
                         "(default 1; conf: reschedule.maxDisruptionPerJob)")
    ap.add_argument("--reschedule-min-improvement", type=float,
                    default=None, metavar="FRAC",
                    dest="reschedule_min_improvement",
                    help="minimum stranded-fraction improvement below "
                         "which a plan is rejected as no-op churn "
                         "(default 0.01; conf: reschedule.minImprovement)")
    args = ap.parse_args(argv)

    if args.store_replica_of:
        if not args.serve_replica:
            ap.error("--store-replica-of requires --serve-replica "
                     "(a replica exists to serve reads)")
        return run_replica(
            args.store_replica_of, args.serve_replica,
            metrics_port=args.metrics_port,
            admission_lanes=args.admission_lanes,
            admission_queue_wait_ms=args.admission_queue_wait_ms)
    if args.serve_replica:
        ap.error("--serve-replica requires --store-replica-of")

    conf = None
    if args.conf:
        with open(args.conf) as f:
            conf = f.read()
    sa = Standalone(scheduler_conf=conf, period=args.period,
                    serve_webhooks_tls=args.serve_webhooks,
                    sidecar_path=args.sidecar,
                    metrics_port=args.metrics_port,
                    serve_store=args.serve_store,
                    webhook_client_ca=args.webhook_client_ca,
                    webhook_bind=args.webhook_bind,
                    scheduler_name=args.scheduler_name,
                    default_queue=args.default_queue,
                    percentage_of_nodes_to_find=args.percentage_nodes_to_find,
                    leader_elect=args.leader_elect,
                    compile_cache_dir=args.compile_cache_dir,
                    prewarm=args.prewarm,
                    pipeline_solver=not args.serial_solver,
                    pipeline_effects=args.pipeline_effects,
                    action_deadline_s=args.action_deadline,
                    breaker_failures=args.breaker_failures,
                    breaker_cooldown_s=args.breaker_cooldown,
                    sim_record=args.sim_record,
                    sim_trace=args.sim_trace,
                    solver_mode=args.solver_mode,
                    sharded_byte_budget=args.sharded_byte_budget,
                    reschedule_interval=args.reschedule_interval,
                    reschedule_max_moves=args.reschedule_max_moves,
                    reschedule_max_disruption=args.reschedule_max_disruption,
                    reschedule_min_improvement=args.reschedule_min_improvement,
                    store_data_dir=args.store_data_dir,
                    store_fsync=args.store_fsync,
                    store_fsync_interval_s=args.store_fsync_interval,
                    store_snapshot_every=args.store_snapshot_every,
                    store_shards=args.store_shards,
                    store_shard_procs=args.store_shard_procs,
                    controller_shard_workers=args.controller_shard_workers,
                    admission_lanes=args.admission_lanes,
                    admission_queue_wait_ms=args.admission_queue_wait_ms,
                    controllers_read_endpoint=args.controllers_read_endpoint,
                    device=args.device)
    if args.jobs_dir:
        import glob
        import os
        for path in sorted(glob.glob(os.path.join(args.jobs_dir, "*.yaml"))):
            with open(path) as f:
                sa.apply_job_yaml(f.read())
    print(f"volcano-tpu-torch standalone up; metrics on "
          f":{sa.metrics_server.port}"
          + (f"; store on {sa.store_server.address}"
             if sa.store_server else ""), flush=True)
    # graceful SIGTERM: stop the loop; the finally below drains the
    # async bind effectors and only then releases the HA lease, so a
    # standby's takeover never races this process's in-flight binds
    import signal
    signal.signal(signal.SIGTERM,
                  lambda *_a: sa._stop.set())
    try:
        sa.run()
    except KeyboardInterrupt:
        pass
    finally:
        sa.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
