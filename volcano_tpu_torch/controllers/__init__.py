"""Controllers (reference pkg/controllers).

ControllerManager wires every controller to a ClusterStore and drains them;
the reference runs them under leader election in controller-manager.
"""

from .apis import JobInfo, Request  # noqa: F401
from .framework import (  # noqa: F401
    Controller, ControllerOption, register_controller,
)
from .garbagecollector import GarbageCollector  # noqa: F401
from .job import JobController  # noqa: F401
from .kubelet import KubeletStandin  # noqa: F401
from .podgroup import PodGroupController  # noqa: F401
from .queue import QueueController  # noqa: F401


class _WatchCollector:
    """Stands in for the cluster while a controller's run() subscribes:
    records (kind, listener) pairs instead of opening per-kind streams,
    so the manager can open them all as ONE bulk_watch stream. Every
    other attribute forwards to the real cluster."""

    def __init__(self, inner):
        self._inner = inner
        self.subs = []

    def watch(self, kind, listener, replay: bool = True) -> None:
        self.subs.append((kind, listener))

    def __getattr__(self, name):
        return getattr(self._inner, name)


class ControllerManager:
    """cmd/controller-manager equivalent: initialize + run all controllers
    against one cluster store; process_all() drains every controller's
    queue (single-core stand-in for the per-controller worker loops).

    Scale knobs (the sharded-front-door fan-out):
    ``bulk_watch=True`` collects every controller's subscriptions and
    opens them as ONE bulk_watch stream when the cluster supports it (a
    networked store client); on the in-memory store it falls through to
    the per-controller watches.
    ``shard_workers=N`` fans the job controller's sync drain out across
    N worker threads partitioned by the job key's store shard, so
    pod-wave ingest overlaps store round trips instead of queueing
    behind one request at a time (pair with the store client's
    ``pool_size``).
    ``read_store=`` (the read tier: list/watch off a replica, mutations
    to the primary) needs the networked client's ``client.readtier``,
    which this package does not have yet: it raises
    NotImplementedError before any controller is built."""

    def __init__(self, cluster, scheduler_name: str = "volcano",
                 default_queue: str = "default", worker_num: int = 3,
                 shard_workers: int = 1, bulk_watch: bool = False,
                 read_store=None):
        if read_store is not None:
            raise NotImplementedError(
                "ControllerManager(read_store=...) needs client.readtier, "
                "which arrives with the networked client")
        self.opt = ControllerOption(cluster=cluster,
                                    scheduler_name=scheduler_name,
                                    default_queue=default_queue,
                                    worker_num=worker_num)
        self.shard_workers = max(1, int(shard_workers))
        self.bulk_watch = bool(bulk_watch)
        self.controllers = [
            JobController(),
            QueueController(),
            PodGroupController(),
            KubeletStandin(),
            GarbageCollector(),
        ]
        for ctrl in self.controllers:
            ctrl.initialize(self.opt)

    def run(self) -> None:
        if self.bulk_watch and hasattr(self.opt.cluster, "bulk_watch"):
            subs = []
            for ctrl in self.controllers:
                orig = getattr(ctrl, "cluster", None)
                if orig is None:
                    ctrl.run()
                    continue
                collector = _WatchCollector(orig)
                ctrl.cluster = collector
                try:
                    ctrl.run()
                finally:
                    ctrl.cluster = orig
                subs.extend(collector.subs)
            if subs:
                # one stream for every controller: replays land per kind
                # in subscription order (same net deliveries as the
                # sequential per-controller subscriptions), live events
                # arrive batched
                self.opt.cluster.bulk_watch(subs)
            return
        for ctrl in self.controllers:
            ctrl.run()

    def process_all(self, rounds: int = 4) -> None:
        for _ in range(rounds):
            for ctrl in self.controllers:
                if self.shard_workers > 1 and isinstance(ctrl,
                                                         JobController):
                    ctrl.process_all(parallel=self.shard_workers)
                else:
                    ctrl.process_all()

    def run_with_leader_election(self, stop, lock_name: str = "vc-controller-manager",
                                 identity: str = None) -> None:
        """HA mode (cmd/controller-manager/app/server.go:98-127): only the
        lease holder runs the controllers; a standby takes over when the
        leader's lease expires. Renewal runs on its own thread at the retry
        period; controllers subscribe their watches only once even if
        leadership is lost and regained."""
        import threading
        from ..utils import LeaderElector, LeaseLock

        # lease arbitration always runs against the primary: a standby's
        # takeover decision must never ride a replica's staleness
        write = getattr(self.opt.cluster, "write_store", self.opt.cluster)
        elector = LeaderElector(
            LeaseLock(write, lock_name), identity=identity)
        self._elector = elector
        # fencing: each controller's writes (pod create/delete, job and
        # podgroup status) carry this manager's lease token, so a deposed
        # manager's late reconcile is a FencedError instead of a
        # double-created pod (client.store.FencedStore)
        from ..client.store import FencedStore
        fenced = FencedStore(self.opt.cluster, elector.fencing_token)
        for ctrl in self.controllers:
            if getattr(ctrl, "cluster", None) is self.opt.cluster:
                ctrl.cluster = fenced
        renewer = threading.Thread(target=elector.run, args=(stop,),
                                   name="leader-elector", daemon=True)
        renewer.start()
        subscribed = False
        while not stop.is_set():
            if elector.is_leader:
                if not subscribed:
                    self.run()
                    subscribed = True
                self.process_all(rounds=1)
                stop.wait(0.05)
            else:
                stop.wait(0.05)
        renewer.join(timeout=2 * elector.retry_period)
