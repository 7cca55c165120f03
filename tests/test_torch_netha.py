"""The port's store and schedulers across processes, on the CPU (one case
on the card).

- tests/test_ha_observability.py::TestCrossProcessHA: two port
  scheduler processes (this file's ``scheduler`` entry, device="cpu")
  contend for the lease over a StoreServer; the leader is SIGKILLed
  mid-flight and the standby takes over with no double bind, binding
  nothing before the dead leader's lease expired.
- tests/test_failover.py::TestFencedDeposedLeader: a port writer process
  (the ``fenced-writer`` entry) paused past its lease; its late commit is
  refused and changes nothing, byte for byte.
- tests/test_ha_observability.py::TestMetricsServer over the port's
  registry (the read-replica families wait for the replica port; the
  networked store's families stand in their place).
- tests/test_netstore.py::TestStoreCrashSoak: the store in its own
  process (the ``store`` entry: a DurableClusterStore behind a
  StoreServer) is SIGKILLed with a wave's pods committed but unbound and
  restarted on the same port and data directory; the port's scheduler
  and controllers ride through, the decision trace bind for bind equal
  to the uninterrupted run's, no bind lost or repeated, every watch
  resumed with ``since:``.
- On the card (marker ``cuda``): chip_smoke.py's netha phase at 60
  nodes (three scheduler processes), both leader kills, warm standbys:
  no double bind, the binds of an uninterrupted run.

Child processes: ``python tests/test_torch_netha.py scheduler|store|
fenced-writer ...`` (the ``__main__`` block at the end).

Tolerance: exact (binds, bytes, counts).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _child(*argv, **kw):
    return subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             *argv], cwd=ROOT, **kw)


def _wait(cond, timeout=10.0, step=0.02):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(step)
    return cond()


def _stop(proc):
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)


# ---------------------------------------------------------------------------
# two scheduler processes, one lease
# ---------------------------------------------------------------------------

class TestCrossProcessHA:
    """Two scheduler PROCESSES contending on the lease over the networked
    store; the leader is SIGKILLed mid-flight and the standby takes over
    with no double-bind (cmd/scheduler/app/server.go:85-118)."""

    def test_failover_across_processes_no_double_bind(self):
        from volcano_tpu_torch.api.types import POD_GROUP_ANNOTATION
        from volcano_tpu_torch.client import ClusterStore, StoreServer
        from volcano_tpu_torch.models import (
            Node, Pod, PodGroup, PodGroupSpec,
        )

        store = ClusterStore()
        binds, violations, lease_renews = [], [], {}

        def audit(verb, kind, obj):
            if kind == "pods" and verb == "update" and obj.node_name:
                prev = store.try_get("pods", obj.name, obj.namespace)
                if prev is not None and prev.node_name \
                        and prev.node_name != obj.node_name:
                    violations.append(
                        (obj.name, prev.node_name, obj.node_name))
                binds.append((obj.name, obj.node_name, time.time()))
            if kind == "leases" and getattr(obj, "holder_identity", None):
                lease_renews[obj.holder_identity] = obj.renew_time
            return obj

        store.add_interceptor(audit)
        server = StoreServer(store).start()
        store.create("nodes", Node(
            name="n1", allocatable={"cpu": "32", "memory": "64Gi"},
            capacity={"cpu": "32", "memory": "64Gi"}))

        def submit(idx):
            store.create("podgroups", PodGroup(
                name=f"pg{idx}", namespace="d",
                spec=PodGroupSpec(min_member=1)))
            store.create("pods", Pod(
                name=f"p{idx}", namespace="d",
                annotations={POD_GROUP_ANNOTATION: f"pg{idx}"},
                containers=[{"requests": {"cpu": "1", "memory": "1Gi"}}]))

        submit(0)
        procs = {}
        try:
            for ident in ("alpha", "beta"):
                procs[ident] = _child(
                    "scheduler", "--server", server.address,
                    "--identity", ident, stdout=subprocess.DEVNULL,
                    stderr=subprocess.DEVNULL)
            assert _wait(lambda: binds, timeout=120), \
                "no process ever scheduled p0"
            leader = store.get("leases", "volcano").holder_identity
            assert leader in procs
            procs[leader].kill()  # SIGKILL: no clean release
            procs[leader].wait(timeout=10)
            kill_time = time.time()
            duration = store.get("leases",
                                 "volcano").lease_duration_seconds
            expiry = lease_renews[leader] + duration
            for i in range(1, 4):
                submit(i)
            assert _wait(lambda: {"p1", "p2", "p3"}
                         <= {b[0] for b in binds}, timeout=60), binds
            survivor = [i for i in procs if i != leader][0]
            assert store.get("leases", "volcano").holder_identity \
                == survivor
            assert violations == []
            post_kill = [b for b in binds if b[2] > kill_time
                         and b[0] != "p0"]
            assert post_kill
            assert min(b[2] for b in post_kill) >= expiry - 0.1
        finally:
            for p in procs.values():
                _stop(p)
            server.stop()


# ---------------------------------------------------------------------------
# a paused, deposed leader's late commit
# ---------------------------------------------------------------------------

class TestFencedDeposedLeader:
    def test_paused_leader_late_commit_rejected_byte_for_byte(self):
        from volcano_tpu_torch.client import ClusterStore, StoreServer
        from volcano_tpu_torch.client.codec import encode
        from volcano_tpu_torch.models import Pod
        from volcano_tpu_torch.utils.leader_election import (
            LeaderElector, LeaseLock,
        )

        store = ClusterStore()
        server = StoreServer(store).start()
        store.create("pods", Pod(name="warmup", namespace="d"))
        store.create("pods", Pod(name="victim", namespace="d"))
        proc = _child("fenced-writer", "--server", server.address,
                      "--identity", "old-leader", "--lease", "1.0",
                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                      text=True, bufsize=1)
        try:
            line = ""
            deadline = time.time() + 60
            while "WARMUP ok" not in line:
                assert time.time() < deadline, f"no warmup: {line!r}"
                line = proc.stdout.readline()
            assert store.get("pods", "warmup", "d").phase == "Running"

            os.kill(proc.pid, signal.SIGSTOP)  # the GC-pause stand-in
            try:
                time.sleep(1.6)  # > lease: the old leader is expired
                eb = LeaderElector(LeaseLock(store, "fence-test"),
                                   identity="new-leader",
                                   lease_duration=5.0)
                deadline = time.time() + 10
                while not eb.step():
                    assert time.time() < deadline, \
                        "takeover never happened"
                    time.sleep(0.1)
                victim_before = json.dumps(
                    encode(store.get("pods", "victim", "d")),
                    sort_keys=True)
            finally:
                os.kill(proc.pid, signal.SIGCONT)

            os.kill(proc.pid, signal.SIGUSR1)  # now the late commit
            out, _ = proc.communicate(timeout=30)
            assert proc.returncode == 42, \
                f"unexpected: rc={proc.returncode} out={out!r}"
            assert "FENCED" in out
            assert json.dumps(
                encode(store.get("pods", "victim", "d")),
                sort_keys=True) == victim_before
            assert not store.get("pods", "victim", "d").node_name
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
            server.stop()


# ---------------------------------------------------------------------------
# the metrics server
# ---------------------------------------------------------------------------

class TestMetricsServer:
    def test_serves_metrics_healthz_stacks(self):
        from volcano_tpu_torch.metrics import MetricsServer, metrics

        srv = MetricsServer(port=0).start()
        try:
            base = f"http://127.0.0.1:{srv.port}"
            metrics.schedule_attempts.inc(labels={"result": "scheduled"})
            body = urllib.request.urlopen(f"{base}/metrics").read().decode()
            assert "volcano_schedule_attempts_total" in body
            assert "volcano_e2e_scheduling_latency_milliseconds" in body
            # the networked store's families, served by the port's
            # registry (the read-replica families wait for the replicas)
            for family in ("volcano_store_admission_inflight",
                           "volcano_store_wal_appends_total",
                           "volcano_store_watch_dropped_total",
                           "volcano_delta_frames_total",
                           "volcano_watch_reconnects_total",
                           "volcano_store_request_retries_total"):
                assert family in body, family
            assert urllib.request.urlopen(f"{base}/healthz").read() \
                == b"ok\n"
            stacks = urllib.request.urlopen(
                f"{base}/debug/stacks").read().decode()
            assert "thread" in stacks
            with pytest.raises(Exception):
                urllib.request.urlopen(f"{base}/nope")
        finally:
            srv.stop()


# ---------------------------------------------------------------------------
# kill -9 the store: the port's counterpart of tests/durable_soak.py
# ---------------------------------------------------------------------------

def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def start_store_proc(port: int, data_dir: str, timeout: float = 60.0,
                     shards: int = 1, shard_procs: bool = False,
                     worker_faults=None, fsync: str = "every",
                     snapshot_every: int = 4096) -> subprocess.Popen:
    """This file's ``store`` entry; waits for its READY line.
    ``shards`` > 1 serves a ShardedClusterStore through a ShardRouter;
    ``shard_procs`` runs each shard as a worker process behind a
    ProcShardRouter (the same data-dir layout)."""
    argv = ["store", "--port", str(port), "--data-dir", data_dir,
            "--shards", str(shards), "--fsync", fsync,
            "--snapshot-every", str(snapshot_every)]
    if shard_procs:
        argv.append("--shard-procs")
    if worker_faults:
        argv += ["--worker-faults", worker_faults]
    proc = _child(*argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                  text=True)
    deadline = time.time() + timeout
    while time.time() < deadline:
        line = proc.stdout.readline()
        if line.startswith("READY"):
            return proc
        if proc.poll() is not None:
            break
    proc.kill()
    raise AssertionError(f"store proc did not come up (rc={proc.poll()})")


def run_store_crash_soak(data_dir: str, waves: int = 6, kill_at_wave=None,
                         jobs_per_wave: int = 2, tpj: int = 3,
                         n_nodes: int = 4, wait_s: float = 30.0,
                         shards: int = 1, bulk_watch: bool = False,
                         shard_procs: bool = False, kill_worker=None,
                         direct_watch: bool = False) -> dict:
    """tests/durable_soak.py's run through the port (device="cpu"): per
    wave, Jobs -> the controllers' podgroups -> enqueue -> the pods ->
    one binding cycle -> retire; ``kill_at_wave=k`` SIGKILLs and
    restarts the store process once wave k's pods exist only in the
    store. ``shards``/``shard_procs`` serve the store sharded (in one
    process or one worker process a shard); ``kill_worker=i`` aims the
    SIGKILL at shard i's worker and waits for its supervisor's restart.
    Returns the decision trace and the ride-through evidence."""
    from torch_helpers import Builders
    from volcano_tpu_torch.cache import FakeEvictor, SchedulerCache
    from volcano_tpu_torch.client import NotFoundError, RemoteClusterStore
    from volcano_tpu_torch.controllers import (
        ControllerManager, JobController,
    )
    from volcano_tpu_torch.models import (
        Job, JobSpec, PodGroupPhase, PriorityClass, TaskSpec,
    )
    from volcano_tpu_torch.scheduler import Scheduler

    b = Builders("torch")
    port = free_port()
    proc = start_store_proc(port, data_dir, shards=shards,
                            shard_procs=shard_procs)
    crash_resyncs = []
    remote = RemoteClusterStore(
        f"127.0.0.1:{port}", connect_timeout=2.0, retry_attempts=10,
        retry_base_s=0.1, retry_cap_s=1.0, watch_backoff_cap_s=0.5,
        direct_watch=direct_watch,
        on_watch_failure=lambda: crash_resyncs.append(1))
    result = {"binds_by_wave": [], "crashes": 0, "stalls": [],
              "restart_s": None}

    def wait_until(cond, pump=None, timeout=wait_s):
        deadline = time.time() + timeout
        while time.time() < deadline:
            if pump is not None:
                pump()
            if cond():
                return True
            time.sleep(0.02)
        return cond()

    def job(name, prio):
        return Job(name=name, namespace="soak", spec=JobSpec(
            min_available=tpj, queue="q0", priority_class_name=prio,
            tasks=[TaskSpec(name="task", replicas=tpj, template={
                "spec": {"containers": [{"name": "c", "requests": {
                    "cpu": "1", "memory": "1Gi"}}]}})]))

    try:
        remote.apply("queues", b.build_queue("q0", weight=1))
        # distinct per-job priorities: the cross-job order is the
        # priority plugin's, never a creation-timestamp tie
        for j in range(jobs_per_wave):
            remote.apply("priorityclasses", PriorityClass(
                name=f"soak-p{j}", value=1000 - j * 100))
        for i in range(n_nodes):
            remote.apply("nodes", b.build_node(
                f"n{i}", {"cpu": "32", "memory": "128Gi"}))
        cache = SchedulerCache(remote, device="cpu")
        cache.evictor = FakeEvictor()
        cache.run()
        cache.wait_for_cache_sync()
        controllers = ControllerManager(remote, default_queue="q0",
                                        bulk_watch=bulk_watch)
        controllers.run()
        sched = Scheduler(cache)
        jc = next(c for c in controllers.controllers
                  if isinstance(c, JobController))

        def wave_pods(names):
            return [p for n in names for p in remote.list(
                "pods", namespace="soak", name_glob=f"{n}-*")]

        for w in range(waves):
            names = [f"w{w}-j{j}" for j in range(jobs_per_wave)]
            for j, name in enumerate(names):
                remote.create("jobs", job(name, f"soak-p{j}"))
            if not wait_until(lambda: all(
                    remote.try_get("podgroups", n, "soak") is not None
                    for n in names), pump=controllers.process_all):
                result["stalls"].append((w, "podgroup"))
            if not wait_until(lambda: all(f"soak/{n}" in cache.jobs
                                          for n in names)):
                result["stalls"].append((w, "mirror_pg"))

            def pg_enqueued(name):
                pg = remote.try_get("podgroups", name, "soak")
                return pg is not None and pg.status is not None \
                    and pg.status.phase != PodGroupPhase.PENDING

            try:
                cache.process_resync_tasks()
                sched.run_once()
            except Exception:  # noqa: BLE001 — counted, asserted zero
                result["crashes"] += 1
            if not wait_until(lambda: all(pg_enqueued(n) for n in names)):
                result["stalls"].append((w, "inqueue"))
            if not wait_until(lambda: len(wave_pods(names))
                              == jobs_per_wave * tpj,
                              pump=controllers.process_all):
                result["stalls"].append((w, "pods"))
            if kill_at_wave == w:
                # the whole wave exists only in the store: kill -9
                t0 = time.time()
                if kill_worker is not None:
                    # one shard worker only: its supervisor restarts it
                    # on the same port and data dir, the others serve on
                    topo = remote._request({"op": "topology"})
                    victim = topo["workers"][kill_worker]
                    os.kill(victim["pid"], signal.SIGKILL)
                    deadline = time.time() + 30
                    while time.time() < deadline:
                        topo = remote._request({"op": "topology"})
                        ww = topo["workers"][kill_worker]
                        if ww["alive"] and ww["restarts"] \
                                > victim["restarts"]:
                            break
                        time.sleep(0.05)
                    result["worker_restarts"] = \
                        topo["workers"][kill_worker]["restarts"]
                else:
                    proc.kill()
                    proc.wait(timeout=10)
                    proc = start_store_proc(port, data_dir, shards=shards,
                                            shard_procs=shard_procs)
                result["restart_s"] = round(time.time() - t0, 2)

            def mirror_has_wave(name):
                job_info = cache.jobs.get(f"soak/{name}")
                return job_info is not None and len(job_info.tasks) == tpj

            if not wait_until(lambda: all(mirror_has_wave(n)
                                          for n in names)):
                result["stalls"].append((w, "mirror_pods"))
            try:
                cache.process_resync_tasks()
                sched.run_once()
            except Exception:  # noqa: BLE001 — counted, asserted zero
                result["crashes"] += 1
            cache.wait_for_effects()
            if not wait_until(lambda: all(p.node_name
                                          for p in wave_pods(names))):
                result["stalls"].append((w, "bind"))
            result["binds_by_wave"].append(sorted(
                (f"{p.namespace}/{p.name}", p.node_name)
                for p in wave_pods(names)))

            # retire the wave until the controller and scheduler caches
            # have seen it go (a lagging job delete would let sync_job
            # resurrect it)
            def retire_pump():
                controllers.process_all()
                for kind in ("jobs", "pods", "podgroups"):
                    for obj in remote.list(kind, namespace="soak"):
                        try:
                            remote.delete(kind, obj.name, "soak")
                        except NotFoundError:
                            pass

            def retired():
                return (not remote.list("pods", namespace="soak")
                        and not remote.list("jobs", namespace="soak")
                        and not any(k.startswith("soak/")
                                    for k in list(jc.cache.jobs))
                        and not any(k.startswith("soak/")
                                    for k in list(cache.jobs)))

            if not wait_until(retired, pump=retire_pump):
                result["stalls"].append((w, "retire"))

        all_binds = [x for wave in result["binds_by_wave"] for x in wave]
        result["total_binds"] = len(all_binds)
        result["dup_binds"] = len(all_binds) - len({p for p, _ in all_binds})
        result["lost_binds"] = sum(1 for _, node in all_binds if not node)
        result["watch_resumes"] = remote.watch_resumes
        result["watch_failed"] = remote.watch_failed
        result["crash_only_resyncs"] = len(crash_resyncs)
        return result
    finally:
        try:
            remote.close()
        except Exception:  # noqa: BLE001
            pass
        proc.kill()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            pass


class TestStoreCrashSoak:
    def test_kill9_recovery_trace_identical_to_golden(self, tmp_path):
        golden = run_store_crash_soak(str(tmp_path / "golden"), waves=6)
        crash = run_store_crash_soak(str(tmp_path / "crash"), waves=6,
                                     kill_at_wave=3)
        assert golden["crashes"] == 0 and golden["stalls"] == []
        assert crash["crashes"] == 0 and crash["stalls"] == []
        assert crash["restart_s"] is not None
        assert crash["binds_by_wave"] == golden["binds_by_wave"]
        assert crash["total_binds"] == 6 * 2 * 3
        assert crash["dup_binds"] == 0 and crash["lost_binds"] == 0
        assert crash["watch_resumes"] > 0
        assert not crash["watch_failed"]
        assert crash["crash_only_resyncs"] == 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_card_schedulers_fail_over_without_double_bind(tmp_path):
    """chip_smoke.py's netha phase at 60 nodes with warm standbys:
    scheduler processes on the card, the leader killed at bind_commit
    and by SIGKILL; every pod bound once, as the uninterrupted run."""
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    code = ("import json, torch, chip_smoke as c\n"
            "out = c.phase_netha(torch.device('cuda', 0), dict("
            "n_nodes=60, n_jobs=30, wave_jobs=2, arms=('warm',)))\n"
            "print('NETHA', json.dumps(out['arms'][0]['takeovers'][0]"
            "['takeover_ms']))\n")
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=600,
        env=dict(os.environ, PYTHONHASHSEED="0"))
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "NETHA" in proc.stdout


# ---------------------------------------------------------------------------
# child processes
# ---------------------------------------------------------------------------

def scheduler_main(args) -> int:
    """One port scheduler process on the CPU under leader election over
    a RemoteClusterStore (fencing, the bind-intent journal, takeover
    recovery, warm-standby shadows); a configmap ``faults-<identity>``
    re-arms its fault injector live. Runs until killed."""
    from volcano_tpu_torch.cache import SchedulerCache
    from volcano_tpu_torch.client import RemoteClusterStore
    from volcano_tpu_torch.resilience import faults
    from volcano_tpu_torch.scheduler import Scheduler

    # a watch stream that cannot resume ends the process (crash-only)
    remote = RemoteClusterStore(args.server,
                                on_watch_failure=lambda: os._exit(3))
    cache = SchedulerCache(remote, device="cpu")
    sched = Scheduler(cache, period=args.period)

    def on_faults_cm(event, cm, old):
        if event != "delete" and cm.name == f"faults-{args.identity}" \
                and (cm.data or {}).get("spec"):
            faults.configure(cm.data["spec"])
            print(f"armed {cm.data['spec']}", flush=True)

    remote.watch("configmaps", on_faults_cm)
    print(f"scheduler {args.identity} up", flush=True)
    sched.run_with_leader_election(
        threading.Event(), identity=args.identity,
        lease_duration=args.lease, renew_deadline=args.renew,
        retry_period=args.retry)
    return 0


def store_main(args) -> int:
    """A DurableClusterStore served by a StoreServer on ``--port`` (or,
    with ``--shards``/``--shard-procs``, a sharded store behind its
    router over the same data dir); prints READY once serving, then
    serves until killed."""
    from volcano_tpu_torch.client import (
        DurableClusterStore, ProcShardedStore, ProcShardRouter,
        ShardedClusterStore, ShardProcSupervisor, ShardRouter,
        StoreServer,
    )
    if args.shard_procs:
        sup = ShardProcSupervisor(
            max(1, args.shards), data_dir=args.data_dir, fsync=args.fsync,
            snapshot_every=args.snapshot_every, admission=False,
            worker_faults=args.worker_faults,
            restart_backoff_base_s=0.1).start()
        store = ProcShardedStore(sup)
        server = ProcShardRouter(store, port=args.port).start()
    elif args.shards > 1:
        store = ShardedClusterStore(args.shards, data_dir=args.data_dir,
                                    fsync=args.fsync,
                                    snapshot_every=args.snapshot_every)
        server = ShardRouter(store, port=args.port).start()
    else:
        store = DurableClusterStore(args.data_dir, fsync=args.fsync,
                                    snapshot_every=args.snapshot_every)
        server = StoreServer(store, port=args.port).start()
    print(f"READY {server.port} rv={store._rv} "
          f"recovered={getattr(store, 'recovered_records', 0)}",
          flush=True)
    threading.Event().wait()
    return 0


def fenced_writer_main(args) -> int:
    """Acquire the test lease, land one fenced write (WARMUP ok), wait
    for SIGUSR1 (the test pauses this process past its lease and a new
    leader takes over meanwhile), then attempt a bind with the token
    captured at acquisition: FENCED and exit 42 when refused,
    SPLIT-BRAIN and exit 1 when it lands."""
    resumed = {"go": False}
    signal.signal(signal.SIGUSR1,
                  lambda *_a: resumed.__setitem__("go", True))
    from volcano_tpu_torch.client import FencedError, RemoteClusterStore
    from volcano_tpu_torch.utils.leader_election import (
        LeaderElector, LeaseLock,
    )
    remote = RemoteClusterStore(args.server)
    elector = LeaderElector(LeaseLock(remote, "fence-test"),
                            identity=args.identity,
                            lease_duration=args.lease,
                            retry_period=args.lease / 4)
    deadline = time.time() + 30
    while not elector.step():
        if time.time() > deadline:
            print("NEVER-LED", flush=True)
            return 2
        time.sleep(0.05)
    token = elector.fencing_token()
    warm = remote.get("pods", "warmup", "d")
    warm.phase = "Running"
    remote.update("pods", warm, fencing=token)
    print("WARMUP ok", flush=True)
    deadline = time.time() + 60
    while not resumed["go"]:
        if time.time() > deadline:
            print("NEVER-RESUMED", flush=True)
            return 3
        time.sleep(0.02)
    try:
        victim = remote.get("pods", "victim", "d")
        victim.node_name = "n-old-leader"
        victim.phase = "Running"
        remote.update("pods", victim, fencing=token)
    except FencedError as e:
        print(f"FENCED {e}", flush=True)
        return 42
    print("SPLIT-BRAIN", flush=True)
    return 1


if __name__ == "__main__":
    sys.path[:0] = [ROOT, HERE]
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="role", required=True)
    sp = sub.add_parser("scheduler")
    sp.add_argument("--server", required=True)
    sp.add_argument("--identity", required=True)
    sp.add_argument("--period", type=float, default=0.2)
    sp.add_argument("--lease", type=float, default=2.0)
    sp.add_argument("--renew", type=float, default=1.5)
    sp.add_argument("--retry", type=float, default=0.5)
    st = sub.add_parser("store")
    st.add_argument("--port", type=int, required=True)
    st.add_argument("--data-dir", required=True)
    st.add_argument("--shards", type=int, default=1)
    st.add_argument("--fsync", default="every",
                    choices=["every", "interval", "off"])
    st.add_argument("--snapshot-every", type=int, default=4096)
    st.add_argument("--shard-procs", action="store_true")
    st.add_argument("--worker-faults", default=None)
    fw = sub.add_parser("fenced-writer")
    fw.add_argument("--server", required=True)
    fw.add_argument("--identity", required=True)
    fw.add_argument("--lease", type=float, default=1.0)
    ns = ap.parse_args()
    sys.exit({"scheduler": scheduler_main, "store": store_main,
              "fenced-writer": fenced_writer_main}[ns.role](ns))
