"""The single-process control plane (volcano_tpu_torch.standalone) on the
CPU, against the JAX package's volcano_tpu.standalone.

- tests/test_e2e.py's TestStandalone, TestStandaloneOptions and TestSoak
  and tests/test_shardproc.py's TestStandaloneShardProcs through the
  port (``device="cpu"``);
- tests/test_netstore.py's TestVcctlOverTcpE2E (the port's binary, ``python
  -m volcano_tpu_torch.standalone --device cpu``, driven by ``python -m
  volcano_tpu_torch.cli``) and TestVcctlTLSFlags;
- a JAX Standalone and the port's fed the same vcjob YAMLs, PVC jobs,
  affinity and shared-GPU jobs, turned in step: the same binds by name
  after every turn;
- a turn of run_once drains its async binds before the controllers' second
  pass, so slowed effector threads end each turn as inline binds do (the
  port's order, not the JAX package's: ROADMAP Queue C);
- the replica-only mode: a mid-tier replica process killed and restarted
  serves only once caught up, so its child resumes with no bootstrap
  (the port's order, not the JAX package's: ROADMAP Queue C).

Tolerance: exact (binds by pod name).
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import textwrap
import time

import pytest

pytest.importorskip("jax")  # the JAX reference: absent on the card's machine

from volcano_tpu_torch.client import (
    DurableClusterStore, RemoteClusterStore, ReplicaStore, StoreServer,
)
from volcano_tpu_torch.models import Node

from test_torch_netha import free_port
from torch_helpers import pkg_mod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = {"device": "cpu"}
CHILD_TIMEOUT_S = 120

JOB_YAML = """
apiVersion: batch.volcano.sh/v1alpha1
kind: Job
metadata:
  name: demo
  namespace: default
spec:
  minAvailable: 2
  tasks:
  - name: worker
    replicas: 2
    template:
      spec:
        containers:
        - name: c
          requests:
            cpu: "1"
            memory: 1Gi
"""


def node(name, cpu="4", mem="8Gi"):
    rl = {"cpu": cpu, "memory": mem, "pods": "110"}
    return Node(name=name, allocatable=dict(rl), capacity=dict(rl))


# ---------------------------------------------------------------------------
# tests/test_e2e.py: TestStandalone, TestStandaloneOptions, TestSoak
# ---------------------------------------------------------------------------

class TestStandalone:
    def test_standalone_schedules_a_job(self):
        """Job YAML in, pods created by the controllers, bound by the
        scheduler; the metrics endpoint is live."""
        import urllib.request

        from volcano_tpu_torch.standalone import Standalone

        sa = Standalone(period=0.01, metrics_port=0, **CPU)
        try:
            sa.store.create("nodes", node("n1"))
            sa.apply_job_yaml(JOB_YAML)
            for _ in range(6):
                sa.run_once()
            pods = sa.store.list("pods", namespace="default")
            assert len(pods) == 2
            assert all(p.node_name == "n1" for p in pods)
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{sa.metrics_server.port}/healthz",
                    timeout=5) as r:
                assert r.read() == b"ok\n"
        finally:
            sa.stop()


class TestStandaloneOptions:
    def test_default_queue_routes_queueless_jobs(self):
        from volcano_tpu_torch.models import Queue, QueueSpec
        from volcano_tpu_torch.standalone import Standalone

        s = Standalone(metrics_port=0, async_effectors=False,
                       default_queue="team-x", **CPU)
        s.store.apply("queues", Queue(name="team-x",
                                      spec=QueueSpec(weight=1)))
        s.store.create("nodes", node("n1"))
        s.apply_job_yaml(textwrap.dedent("""
        apiVersion: batch.volcano.sh/v1alpha1
        kind: Job
        metadata: {name: noq, namespace: default}
        spec:
          minAvailable: 1
          schedulerName: volcano
          tasks:
            - replicas: 2
              name: work
              template:
                spec:
                  containers:
                    - name: main
                      image: nginx
                      resources:
                        requests: {cpu: "1"}
        """))
        for _ in range(4):
            s.run_once()
        pg = s.store.get("podgroups", "noq", "default")
        assert pg.spec.queue == "team-x"
        pods = s.store.list("pods", namespace="default")
        assert len(pods) == 2 and all(p.node_name for p in pods)
        s.stop()

    def test_leader_elect_gates_turns_on_the_lease(self):
        import threading

        from volcano_tpu_torch.standalone import Standalone
        from volcano_tpu_torch.utils import LeaderElector, LeaseLock

        s = Standalone(metrics_port=0, async_effectors=False,
                       leader_elect=True, period=0.01, **CPU)
        s.scheduler.period = 0.01
        s.store.create("nodes", node("n1"))
        # a foreign holder owns the lease: the standalone must idle
        other = LeaderElector(LeaseLock(s.store, "volcano"),
                              identity="other")
        other.step()
        t = threading.Thread(target=s.run, daemon=True)
        t.start()
        s.apply_job_yaml("""
apiVersion: batch.volcano.sh/v1alpha1
kind: Job
metadata: {name: gated, namespace: default}
spec:
  minAvailable: 1
  schedulerName: volcano
  tasks:
    - replicas: 1
      name: work
      template:
        spec:
          containers:
            - name: main
              image: nginx
              resources:
                requests: {cpu: "1"}
""")
        time.sleep(0.5)
        pods = s.store.list("pods", namespace="default")
        assert all(not p.node_name for p in pods), \
            "standby scheduled while another process held the lease"
        other.release()
        deadline = time.time() + 15
        while time.time() < deadline:
            pods = s.store.list("pods", namespace="default")
            if pods and all(p.node_name for p in pods):
                break
            time.sleep(0.05)
        assert pods and all(p.node_name for p in pods)
        s.stop()
        t.join(timeout=5)
        assert not t.is_alive()

    def test_scheduler_name_scopes_the_whole_control_plane(self):
        from volcano_tpu_torch.standalone import Standalone

        s = Standalone(metrics_port=0, async_effectors=False,
                       scheduler_name="volcano-blue", **CPU)
        s.store.create("nodes", node("n1"))
        # schedulerName omitted: the mutate webhook must default it to
        # THIS control plane's name, and the cache must accept the pods
        s.apply_job_yaml(textwrap.dedent("""
        apiVersion: batch.volcano.sh/v1alpha1
        kind: Job
        metadata: {name: blue, namespace: default}
        spec:
          minAvailable: 1
          tasks:
            - replicas: 2
              name: work
              template:
                spec:
                  containers:
                    - name: main
                      image: nginx
                      resources:
                        requests: {cpu: "1"}
        """))
        for _ in range(4):
            s.run_once()
        job = s.store.get("jobs", "blue", "default")
        assert job.spec.scheduler_name == "volcano-blue"
        pods = s.store.list("pods", namespace="default")
        assert len(pods) == 2 and all(p.node_name for p in pods), \
            [p.node_name for p in pods]
        assert all(p.scheduler_name == "volcano-blue" for p in pods)
        s.stop()


class TestSoak:
    def test_churn_soak_stays_bounded(self):
        """Jobs stream in, run, complete, and are TTL-collected over many
        control-plane turns; stores and caches return to baseline."""
        from volcano_tpu_torch.controllers.garbagecollector import (
            GarbageCollector,
        )
        from volcano_tpu_torch.standalone import Standalone

        sa = Standalone(period=0.01, metrics_port=0, async_effectors=False,
                        **CPU)
        try:
            for n in range(4):
                sa.store.create("nodes", node(f"n{n}", cpu="8",
                                              mem="16Gi"))
            gc = next(c for c in sa.controllers.controllers
                      if isinstance(c, GarbageCollector))
            for wave in range(10):
                for k in range(3):
                    sa.apply_job_yaml(f"""
apiVersion: batch.volcano.sh/v1alpha1
kind: Job
metadata:
  name: wave{wave}-j{k}
  namespace: default
spec:
  minAvailable: 2
  ttlSecondsAfterFinished: 0
  plugins:
    svc: []
  tasks:
  - name: w
    replicas: 2
    template:
      spec:
        containers:
        - name: c
          requests:
            cpu: "1"
            memory: 1Gi
""")
                for _ in range(3):
                    sa.run_once()
                for p in sa.store.list("pods"):
                    if p.phase == "Running":
                        p.phase = "Succeeded"
                        sa.store.update("pods", p)
                sa.run_once()
                gc.process_all(now=time.time() + 1)  # ttl=0: collect now
                sa.run_once()
            assert sa.store.list("jobs") == []
            assert sa.store.list("pods") == []
            assert sa.store.list("podgroups") == []
            assert sa.store.list("configmaps") == []
            assert sa.store.list("networkpolicies") == []
            assert len(sa.cache.flatten_cache.job_blocks) <= 70
            assert sa.cache.volume_binder._assumed == {}
            assert len(sa.cache._pending_effects) <= 8
        finally:
            sa.stop()


class TestStandaloneShardProcs:
    def test_standalone_schedules_a_job_over_worker_procs(self, tmp_path):
        """The store broken out into shard worker processes (the port's
        ``volcano_tpu_torch.client.shardproc``): admission in the
        workers, the scheduler and controllers on a direct-routing
        client, the pods bound."""
        from volcano_tpu_torch.client import AdmissionError
        from volcano_tpu_torch.models import Job, JobSpec, TaskSpec
        from volcano_tpu_torch.standalone import Standalone

        sa = Standalone(period=0.01, metrics_port=0, store_shards=2,
                        store_shard_procs=True,
                        store_data_dir=str(tmp_path / "data"), **CPU)
        try:
            assert sa._shard_supervisor is not None
            assert isinstance(sa.store, RemoteClusterStore)
            for w in sa._shard_supervisor.workers:
                argv = open(f"/proc/{w.pid}/cmdline", "rb").read() \
                    .decode().split("\0")
                assert argv[1:3] == ["-m",
                                     "volcano_tpu_torch.client.shardproc"]
            sa.store.create("nodes", node("n1"))
            sa.apply_job_yaml(JOB_YAML)
            for _ in range(8):
                sa.run_once()
            pods = sa.store.list("pods", namespace="default")
            assert len(pods) == 2
            assert all(p.node_name == "n1" for p in pods)
            # admission runs in the workers: a job naming a queue nobody
            # created is refused AT the store
            with pytest.raises(AdmissionError):
                sa.store.create("jobs", Job(
                    name="noq", namespace="default",
                    spec=JobSpec(min_available=1, queue="ghost",
                                 tasks=[TaskSpec(
                                     name="t", replicas=1,
                                     template={"spec": {"containers": [
                                         {"name": "c", "requests":
                                          {"cpu": "1"}}]}})])))
        finally:
            sa.stop()


# ---------------------------------------------------------------------------
# tests/test_netstore.py: the binary over TCP, vcctl with TLS flags
# ---------------------------------------------------------------------------

def start_binary(argv, env=None) -> subprocess.Popen:
    """``python -m volcano_tpu_torch.standalone ARGV``; returns once it
    printed its up line."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "volcano_tpu_torch.standalone", *argv],
        cwd=REPO, env=dict(env or os.environ), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    lines = []
    deadline = time.time() + CHILD_TIMEOUT_S
    for line in proc.stdout:
        lines.append(line)
        if " up;" in line:
            break
        if time.time() > deadline:
            break
    else:
        proc.wait(timeout=CHILD_TIMEOUT_S)
    if proc.poll() is not None or not lines or " up;" not in lines[-1]:
        proc.kill()
        raise AssertionError("the standalone binary did not come up:\n"
                             + "".join(lines[-40:]))
    return proc


def stop_binary(proc) -> int:
    proc.send_signal(signal.SIGTERM)
    try:
        return proc.wait(timeout=CHILD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=30)
        raise


def vcctl_proc(*argv) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-m", "volcano_tpu_torch.cli", *argv],
        cwd=REPO, capture_output=True, text=True, timeout=CHILD_TIMEOUT_S)


class TestVcctlOverTcpE2E:
    def test_submit_via_tcp_to_separate_process(self, tmp_path):
        """A job submitted with the port's vcctl over TCP to the port's
        standalone binary (on the CPU) gets scheduled there; the CLI
        reads it back and applies a multi-document file over the wire;
        the binary exits 0 on SIGTERM."""
        from volcano_tpu_torch.models import Node

        port = free_port()
        addr = f"127.0.0.1:{port}"
        proc = start_binary(["--serve-store", addr, "--metrics-port", "0",
                             "--period", "0.2", "--device", "cpu"])
        remote = RemoteClusterStore(addr)
        try:
            argv = open(f"/proc/{proc.pid}/cmdline", "rb").read() \
                .decode().split("\0")
            assert argv[1:3] == ["-m", "volcano_tpu_torch.standalone"]
            remote.create("nodes", Node(
                name="n1", allocatable={"cpu": "8", "memory": "16Gi"},
                capacity={"cpu": "8", "memory": "16Gi"}))
            yaml_path = tmp_path / "job.yaml"
            yaml_path.write_text(textwrap.dedent("""
            apiVersion: batch.volcano.sh/v1alpha1
            kind: Job
            metadata: {name: net-job, namespace: default}
            spec:
              minAvailable: 2
              tasks:
                - replicas: 2
                  name: worker
                  template:
                    spec:
                      containers:
                        - name: main
                          image: busybox
                          resources: {requests: {cpu: "1", memory: 1Gi}}
            """))
            out = vcctl_proc("--server", addr, "job", "run", "-f",
                             str(yaml_path))
            assert "successfully" in out.stdout, (out.stdout, out.stderr)
            deadline = time.time() + 90
            bound = []
            while time.time() < deadline:
                pods = remote.list("pods", namespace="default")
                bound = [p for p in pods if p.node_name]
                if len(bound) == 2:
                    break
                time.sleep(0.3)
            assert len(bound) == 2, [
                (p.name, p.node_name, p.phase)
                for p in remote.list("pods", namespace="default")]
            out = vcctl_proc("--server", addr, "job", "list")
            assert "net-job" in out.stdout
            q_yaml = tmp_path / "q.yaml"
            q_yaml.write_text(
                "kind: Queue\nmetadata: {name: wire-q}\n"
                "spec: {weight: 3}\n"
                "---\n"
                "kind: PodGroup\n"
                "metadata: {name: wire-pg, namespace: default}\n"
                "spec: {minMember: 2}\n")
            out = vcctl_proc("--server", addr, "apply", "-f", str(q_yaml))
            assert "queue/wire-q" in out.stdout, (out.stdout, out.stderr)
            assert "podgroup/wire-pg" in out.stdout
            assert remote.get("queues", "wire-q").spec.weight == 3
            pg = remote.get("podgroups", "wire-pg", "default")
            assert pg.spec.min_member == 2 and pg.spec.queue == "default"
        finally:
            remote.close()
            rc = stop_binary(proc)
        assert rc == 0


class TestVcctlTLSFlags:
    def test_vcctl_applies_over_tls_with_flags(self, tmp_path):
        """vcctl --server --token --tls-ca drives a TLS-served store."""
        pytest.importorskip("cryptography")
        from volcano_tpu_torch.cli.vcctl import main as vcctl
        from volcano_tpu_torch.client import ClusterStore
        from volcano_tpu_torch.webhooks.server import (
            generate_self_signed_cert,
        )

        cert, key = generate_self_signed_cert(str(tmp_path))
        store = ClusterStore()
        server = StoreServer(store, token="t0k",
                             tls_cert=cert, tls_key=key).start()
        try:
            qy = tmp_path / "q.yaml"
            qy.write_text(
                "apiVersion: scheduling.volcano.sh/v1beta1\n"
                "kind: Queue\n"
                "metadata: {name: tls-q}\n"
                "spec: {weight: 3}\n")
            out = vcctl(["--server", server.address, "--token", "t0k",
                         "--tls-ca", cert, "apply", "-f", str(qy)])
            assert "queue/tls-q" in out
            assert store.get("queues", "tls-q").spec.weight == 3
        finally:
            server.stop()


# ---------------------------------------------------------------------------
# the JAX Standalone and the port's, turned in step
# ---------------------------------------------------------------------------

class MixWorld:
    """One package's Standalone (async bind effectors, as deployed) under
    chip_smoke.py's standalone conf (GPU sharing on) over
    12 nodes of 16 cpu, the first 3 with two 8-unit GPU cards and a taint
    only GPU jobs tolerate, 3 queues 1:2:3 and two priority classes; fed
    by ``feed`` and turned by ``turn``."""

    def __init__(self, pkg: str):
        from chip_smoke import STANDALONE_CONF
        self.pkg = pkg
        self.m = pkg_mod(pkg, "models")
        self.ann = pkg_mod(pkg, "api").POD_GROUP_ANNOTATION
        kw = CPU if pkg == "torch" else {}
        self.sa = pkg_mod(pkg, "standalone").Standalone(
            scheduler_conf=STANDALONE_CONF, metrics_port=0, **kw)
        st, m = self.sa.store, self.m
        for i in range(3):
            st.create("queues", m.Queue(name=f"q{i}",
                                        spec=m.QueueSpec(weight=i + 1)))
        st.create("priorityclasses", m.PriorityClass("high", 1000))
        st.create("priorityclasses", m.PriorityClass("low", -1000))
        for i in range(12):
            rl = {"cpu": "16", "memory": "32Gi", "pods": "110"}
            taints = []
            if i < 3:
                rl.update({"volcano.sh/gpu-memory": 16,
                           "volcano.sh/gpu-number": 2})
                taints = [{"key": "nvidia.com/gpu", "value": "present",
                           "effect": "NoSchedule"}]
            st.create("nodes", m.Node(name=f"n{i}", allocatable=dict(rl),
                                      capacity=dict(rl), taints=taints))

    def feed(self, docs) -> None:
        """vcjob YAMLs, and ("pvc", name, queue, priority) podgroups whose
        two pods each name their own claim."""
        m, st = self.m, self.sa.store
        for doc in docs:
            if isinstance(doc, str):
                self.sa.apply_job_yaml(doc)
                continue
            _, name, queue, prio = doc
            for i in range(2):
                claim = f"{name}-claim-{i}"
                st.create("pvcs", m.PersistentVolumeClaim(
                    name=claim, namespace="mix"))
                st.create("pods", m.Pod(
                    name=f"{name}-{i}", namespace="mix",
                    annotations={self.ann: name}, priority_class_name=prio,
                    containers=[{"name": "c", "requests": {
                        "cpu": "1", "memory": "1Gi"}}],
                    volumes=[{"name": "data", "persistentVolumeClaim": {
                        "claimName": claim}}]))
            st.create("podgroups", m.PodGroup(
                name=name, namespace="mix",
                spec=m.PodGroupSpec(min_member=2, queue=queue,
                                    priority_class_name=prio)))

    def turn(self) -> list:
        self.sa.run_once()
        return sorted((p.name, p.node_name, p.phase)
                      for p in self.sa.store.list("pods", namespace="mix"))

    def finish(self, names) -> None:
        for p in self.sa.store.list("pods", namespace="mix"):
            if p.annotations.get(self.ann) in names:
                p.phase = "Succeeded"
                self.sa.store.update("pods", p)


def test_standalone_binds_equal_jax_with_the_host_only_mix():
    """Solver vcjobs with affinity, PVC and shared-GPU jobs above and below
    their priority, then waves while jobs finish: both packages'
    Standalones bind the same pods to the same nodes after every turn,
    host-only jobs of each kind and priority among them."""
    from chip_smoke import vcjob_yaml

    def burst():
        docs = [vcjob_yaml(f"vj{k}", "mix", f"q{k % 3}", 3, 1 + k % 2, 1,
                           labels={"app": f"vj{k}"}) for k in range(12)]
        for i in range(4):
            prio = "high" if i % 2 == 0 else "low"
            docs.append(vcjob_yaml(f"aff{i}", "mix", f"q{i % 3}", 2, 1, 1,
                                   priority=prio, affinity_to=f"vj{i}"))
            docs.append(vcjob_yaml(f"gpu{i}", "mix", f"q{i % 3}", 2, 1, 1,
                                   priority=prio, gpu_mem=4))
            docs.append(("pvc", f"pvc{i}", f"q{i % 3}", prio))
        return docs

    worlds = [MixWorld(pkg) for pkg in ("jax", "torch")]
    try:
        for w in worlds:
            w.feed(burst())
        waves = [[vcjob_yaml(f"w{i}-j{k}", "mix", f"q{k}", 2, 1, 1)
                  for k in range(3)]
                 + [vcjob_yaml(f"w{i}-aff", "mix", "q0", 1, 1, 1,
                               priority="high" if i % 2 else "low",
                               affinity_to=f"vj{4 + i}")]
                 for i in range(3)]
        for step in range(4 + 3 * 3):
            if step >= 4 and (step - 4) % 3 == 0:
                i = (step - 4) // 3
                for w in worlds:
                    w.finish({f"vj{8 + i}"})
                    w.feed(waves[i])
            jax_binds, port_binds = (w.turn() for w in worlds)
            assert port_binds == jax_binds, f"turn {step}"
        bound = {n.rsplit("-", 2)[0] for n, node_name, _ in port_binds
                 if node_name}
        host_only = {f"{kind}{i}" for kind in ("aff", "gpu", "pvc")
                     for i in range(4)}
        assert host_only <= bound, sorted(host_only - bound)
        assert {"w0-aff", "w1-aff"} & bound, sorted(bound)
    finally:
        for w in worlds:
            w.sa.stop()


class _SlowBinder:
    """Delays every bind, as an effector thread starved of the CPU does."""

    def __init__(self, inner, delay_s):
        self.inner, self.delay_s = inner, delay_s

    def bind(self, pod, hostname):
        time.sleep(self.delay_s)
        self.inner.bind(pod, hostname)


def test_drained_turn_with_slow_async_binds_equals_inline_turn():
    """A turn of ``run_once`` ends with the controllers having seen every
    bind it made, however late the effector threads land them: a
    Standalone whose async binds are slowed shows, after every turn, the
    same pods bound with the same phases and the same job phases as one
    binding inline."""
    from chip_smoke import vcjob_yaml

    from volcano_tpu_torch.standalone import Standalone

    def state(sa):
        pods = sorted((p.name, p.node_name, p.phase)
                      for p in sa.store.list("pods", namespace="mix"))
        jobs = sorted((j.name, j.status.state.phase.value)
                      for j in sa.store.list("jobs", namespace="mix"))
        return pods, jobs

    sas = [Standalone(metrics_port=0, async_effectors=a, **CPU)
           for a in (False, True)]
    sas[1].cache.binder = _SlowBinder(sas[1].cache.binder, 0.01)
    try:
        for sa in sas:
            for i in range(4):
                sa.store.create("nodes", node(f"n{i}", cpu="8"))
        for step in range(8):
            for sa in sas:
                for k in range(2 if step < 6 else 0):
                    sa.apply_job_yaml(vcjob_yaml(f"s{step}-j{k}", "mix",
                                                 "default", 2, 1, 1))
            for sa in sas:
                sa.run_once()
            inline, slowed = (state(sa) for sa in sas)
            assert slowed == inline, f"turn {step}"
        assert len(inline[0]) == 24
        assert all(phase == "Running" for _, phase in inline[1])
    finally:
        for sa in sas:
            sa.stop()


# ---------------------------------------------------------------------------
# the replica-only mode: served only once caught up
# ---------------------------------------------------------------------------

def test_restarted_mid_tier_replica_child_resumes_without_bootstrap(
        tmp_path):
    """``python -m volcano_tpu_torch.standalone --store-replica-of P
    --serve-replica R`` tails a durable primary and serves a child
    replica. Killed and restarted on its port while the primary moves on,
    it serves again only once it has applied what the primary held at its
    start, so the child's ship stream resumes where it stopped: the child
    bootstrapped once, at its start, and ends equal to the primary."""
    from volcano_tpu_torch.models import Queue, QueueSpec

    store = DurableClusterStore(str(tmp_path / "primary"), fsync="off")
    server = StoreServer(store).start()

    def churn(tag, n):
        for i in range(n):
            store.create("queues", Queue(name=f"{tag}-{i}",
                                         spec=QueueSpec(weight=1 + i % 3)))

    churn("a", 40)
    port = free_port()
    argv = ["--store-replica-of", server.address,
            "--serve-replica", f"127.0.0.1:{port}", "--metrics-port", "0"]
    mid = start_binary(argv)
    child = None
    try:
        child = ReplicaStore(f"127.0.0.1:{port}").start()
        child.wait_applied(store._rv, wait_s=60)
        mid.kill()
        mid.wait(timeout=30)
        churn("b", 200)
        mid = start_binary(argv)
        churn("c", 20)
        child.wait_applied(store._rv, wait_s=60)
        assert dict(child.bootstraps) == {"initial": 1}
        assert sorted(q.name for q in child.store.list("queues")) \
            == sorted(q.name for q in store.list("queues"))
    finally:
        if child is not None:
            child.close()
        assert stop_binary(mid) == 0
        server.stop()
        store.close()
