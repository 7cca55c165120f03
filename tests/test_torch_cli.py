"""vcctl (volcano_tpu_torch.cli) on the CPU, against the JAX package's
volcano_tpu.cli.

- tests/test_admission_cli.py::TestCLI's five cases, each run through
  both packages' vcctl over their own admission world, the outputs
  compared as strings (ages masked: they read the wall clock);
- the vcjob YAML cases of tests/test_e2e.py (a job submitted with
  ``vcctl job run``, example/mpi-job.yaml, example/tensorflow-job.yaml,
  example/hierarchical-jobs.yaml through ``vcctl apply``) in both
  packages' World (tests/test_torch_e2e.py), the lifecycle records equal
  converge by converge;
- the ``vcctl status`` renderings of tests/test_overload.py,
  tests/test_shardproc.py, tests/test_replica.py and
  tests/test_read_tier.py over the port's servers, replicas and shard
  workers, and each one against the JAX package's vcctl reading the same
  endpoint;
- one command sequence through both packages' vcctl on their own stores,
  every output equal as a string.

Tolerance: exact.
"""

from __future__ import annotations

import importlib
import json
import os
import re

import pytest

pytest.importorskip("jax")  # the JAX reference: absent on the card's machine

from volcano_tpu.cli import vcctl as j_vcctl
from volcano_tpu_torch.cli import vcctl
from volcano_tpu_torch.client import (
    DurableClusterStore, OverloadedError, RemoteClusterStore, ReplicaStore,
    StoreServer,
)
from volcano_tpu_torch.resilience.faultinject import faults

from test_torch_e2e import World, both
from test_torch_overload import fast_client, gated_store  # noqa: F401
from test_torch_read_tier import chain  # noqa: F401
from test_torch_replica import caught_up, primary, wait_until  # noqa: F401
from test_torch_shardproc import proc_cluster  # noqa: F401
from torch_helpers import PACKAGES, Builders, pkg_mod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = ("jax", "torch")


@pytest.fixture(autouse=True)
def _reset_faults():
    faults.reset()
    yield
    faults.reset()


def cli_of(pkg: str):
    return importlib.import_module(f"{PACKAGES[pkg]}.cli.vcctl")


def mask_ages(out: str) -> str:
    """Ages (``3s``, ``2m``) read the wall clock; mask them."""
    return re.sub(r"(?<=\s)\d+[smh](?=\s)", "<age>", out)


# ---------------------------------------------------------------------------
# TestCLI (tests/test_admission_cli.py): both packages, outputs equal
# ---------------------------------------------------------------------------

class CLIWorld:
    """tests/test_admission_cli.py's TestCLI world in one package: a store
    with a default queue, admission and the ControllerManager."""

    def __init__(self, pkg: str):
        self.pkg = pkg
        self.store = pkg_mod(pkg, "client").ClusterStore()
        self.store.create("queues", Builders(pkg).build_queue("default"))
        pkg_mod(pkg, "webhooks").start_webhooks(self.store)
        self.cm = pkg_mod(pkg, "controllers").ControllerManager(self.store)
        self.cm.run()
        self.outs = []

    def vcctl(self, argv) -> str:
        out = cli_of(self.pkg).main(argv, cluster=self.store)
        self.outs.append(mask_ages(out))
        return out


def both_cli(script):
    """``script(world)`` in each package; the outputs must match."""
    worlds = {}
    for pkg in PKGS:
        worlds[pkg] = CLIWorld(pkg)
        script(worlds[pkg])
    assert worlds["torch"].outs == worlds["jax"].outs
    return worlds["torch"]


class TestCLI:
    def test_job_run_list_view(self):
        def script(w):
            out = w.vcctl(["job", "run", "-N", "demo", "-r", "3", "-m", "2"])
            assert "successfully" in out
            w.cm.process_all()
            out = w.vcctl(["job", "list"])
            assert "demo" in out and "Pending" in out
            out = w.vcctl(["job", "view", "-N", "demo"])
            assert "MinAvailable:2" in out
        both_cli(script)

    def test_job_suspend_creates_abort_command(self):
        def script(w):
            w.vcctl(["job", "run", "-N", "demo"])
            w.cm.process_all()
            out = w.vcctl(["job", "suspend", "-N", "demo"])
            assert "suspend" in out
            w.cm.process_all()
            job = w.store.get("jobs", "demo", "default")
            assert job.status.state.phase.value in ("Aborting", "Aborted")
        both_cli(script)

    def test_vsub_alias(self):
        def script(w):
            out = w.vcctl(["vsub", "-N", "alias-job"])
            assert "successfully" in out
            assert w.store.try_get("jobs", "alias-job",
                                   "default") is not None
        both_cli(script)

    def test_queue_lifecycle(self):
        def script(w):
            assert "successfully" in w.vcctl(
                ["queue", "create", "-n", "q1", "-w", "3"])
            out = w.vcctl(["queue", "list"])
            assert "q1" in out
            assert "close" in w.vcctl(
                ["queue", "operate", "-n", "q1", "-a", "close"])
            w.cm.process_all()
            out = w.vcctl(["queue", "get", "-n", "q1"])
            assert "Closed" in out or "Closing" in out
            assert "delete" in w.vcctl(["queue", "delete", "-n", "q1"])
        both_cli(script)

    def test_version(self):
        out = vcctl.main(["version"])
        assert "vcctl version" in out
        assert out == j_vcctl.main(["version"])


def test_command_sequence_equals_jax(tmp_path):
    """One session of vcctl through both packages on their own stores:
    apply a multi-document file, run, list, view, suspend, resume and
    delete jobs, operate and list queues, errors included; every output
    equal as a string."""
    docs = tmp_path / "docs.yaml"
    docs.write_text(
        "kind: Queue\nmetadata: {name: team-a}\nspec: {weight: 2}\n---\n"
        "kind: PodGroup\nmetadata: {name: pg-x, namespace: default}\n"
        "spec: {minMember: 2, queue: team-a}\n---\n"
        "kind: Job\nmetadata: {name: yaml-job, namespace: default}\n"
        "spec:\n  minAvailable: 1\n  queue: team-a\n  tasks:\n"
        "  - name: w\n    replicas: 2\n    template:\n      spec:\n"
        "        containers:\n        - name: c\n"
        "          requests: {cpu: \"1\", memory: 1Gi}\n")
    bad = tmp_path / "bad.yaml"
    bad.write_text("kind: Deployment\nmetadata: {name: nope}\n")
    seq = [
        ["apply", "-f", str(docs)],
        ["apply", "-f", str(bad)],
        ["job", "run", "-N", "j1", "-r", "2", "-q", "team-a",
         "--requests", "cpu=2,memory=2Gi"],
        ["vsub", "-N", "j2", "-r", "1"],
        ["job", "list"],
        ["job", "list", "-n", "default"],
        ["job", "view", "-N", "yaml-job"],
        ["job", "view", "-N", "ghost"],
        ["queue", "list"],
        ["queue", "get", "-n", "team-a"],
        ["queue", "get", "-n", "ghost"],
        ["queue", "operate", "-n", "team-a", "-w", "5"],
        ["queue", "operate", "-n", "team-a"],
        ["queue", "create", "-n", "team-b", "-w", "4"],
        ["vqueues"],
        ["vjobs"],
        ["job", "delete", "-N", "j2"],
        ["vcancel", "-N", "ghost"],
        ["queue", "delete", "-n", "team-b"],
        ["status"],
        ["version"],
    ]

    def script(w):
        for argv in seq:
            w.vcctl(argv)
            w.cm.process_all()

    world = both_cli(script)
    assert "queue/team-a, podgroup/pg-x, job/yaml-job" in world.outs[0]
    assert "nothing applied" in world.outs[1]


# ---------------------------------------------------------------------------
# vcjob YAML end to end (tests/test_e2e.py), both packages' worlds
# ---------------------------------------------------------------------------

def _example(name: str) -> str:
    return os.path.join(REPO, "example", name)


def cli_submit_schedules(L):
    """TestJobResilience::test_cli_submit_schedules: vcctl job run ->
    admission defaults -> controllers -> scheduler."""
    w = World(L)
    out = cli_of(L.pkg).main(
        ["job", "run", "--name", "cli-job", "--replicas", "2",
         "--min-available", "2", "--requests", "cpu=1,memory=1Gi"],
        cluster=w.store)
    assert "cli-job" in out
    w.converge()
    assert w.phase("cli-job") == L.m.JobPhase.RUNNING
    assert all(p.phase == "Running" for p in w.pods("cli-job"))
    assert "cli-job" in cli_of(L.pkg).main(["vjobs"], cluster=w.store)
    return w


def mpi_job_yaml_schedules(L):
    """TestMpiExample: example/mpi-job.yaml through the job plugins."""
    import yaml

    with open(_example("mpi-job.yaml")) as f:
        job = cli_of(L.pkg)._job_from_yaml(yaml.safe_load(f))
    w = World(L, nodes=2, node_cpu="2", node_mem="4Gi")
    w.store.create("jobs", job)
    w.converge(cycles=4)
    pods = w.pods("mpi-demo")
    assert sorted(p.name for p in pods) == [
        "mpi-demo-mpimaster-0", "mpi-demo-mpiworker-0",
        "mpi-demo-mpiworker-1"]
    assert all(p.node_name for p in pods)
    cm = w.store.get("configmaps", "mpi-demo-svc", "default")
    assert cm.data["mpiworker.host"] == (
        "mpi-demo-mpiworker-0.mpi-demo\nmpi-demo-mpiworker-1.mpi-demo")
    assert cm.data["mpimaster.host"] == "mpi-demo-mpimaster-0.mpi-demo"
    secret = w.store.get("secrets", "mpi-demo-ssh", "default")
    assert {"id_rsa", "id_rsa.pub", "authorized_keys"} <= set(secret.data)
    for p in pods:
        assert p.annotations["volcano.sh/svc-configmap"] == "mpi-demo-svc"
        assert p.annotations["volcano.sh/ssh-secret"] == "mpi-demo-ssh"
        envs = {e["name"]: e["value"]
                for c in p.containers for e in c.get("env", [])}
        assert envs.get("VC_TASK_INDEX") == p.name.rsplit("-", 1)[1]
    assert w.phase("mpi-demo").value == "Running"
    return w


def tensorflow_job_schedules(L):
    """TestExampleIntegrations::test_tensorflow_job_schedules_with_wiring."""
    import yaml

    with open(_example("tensorflow-job.yaml")) as f:
        job = cli_of(L.pkg)._job_from_yaml(yaml.safe_load(f))
    w = World(L, nodes=2, node_cpu="2", node_mem="4Gi")
    w.store.create("jobs", job)
    w.converge(cycles=4)
    pods = w.pods("tf-demo")
    assert sorted(p.name for p in pods) == [
        "tf-demo-ps-0", "tf-demo-worker-0", "tf-demo-worker-1"]
    assert all(p.node_name for p in pods)
    cm = w.store.get("configmaps", "tf-demo-svc", "default")
    assert cm.data["ps.host"] == "tf-demo-ps-0.tf-demo"
    assert cm.data["worker.host"] == (
        "tf-demo-worker-0.tf-demo\ntf-demo-worker-1.tf-demo")
    for p in pods:
        envs = {e["name"]: e["value"]
                for c in p.containers for e in c.get("env", [])}
        assert envs.get("VK_TASK_INDEX") == p.name.rsplit("-", 1)[1]
    assert w.phase("tf-demo").value == "Running"
    return w


HIERARCHY_CONF = """
actions: "enqueue, allocate, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: conformance
- plugins:
  - name: drf
    arguments:
      drf.enableHierarchy: true
  - name: predicates
  - name: nodeorder
"""


def hierarchical_example_applies_and_splits(L):
    """TestExampleIntegrations::test_hierarchical_example_applies_and_splits:
    6 cpu for 9 demanded, the weighted tree decides the split."""
    w = World(L, nodes=3, node_cpu="2", node_mem="8Gi", conf=HIERARCHY_CONF)
    out = cli_of(L.pkg).main(["apply", "-f",
                              _example("hierarchical-jobs.yaml")],
                             cluster=w.store)
    assert "queue/root-eng-prod" in out and "job/sci-job" in out
    w.converge(cycles=4)
    placed = {name: sum(1 for p in w.pods(name) if p.node_name)
              for name in ("eng-prod-job", "eng-dev-job", "sci-job")}
    assert sum(placed.values()) == 12, placed
    assert placed["eng-prod-job"] >= 5, placed
    assert placed["eng-dev-job"] <= 3, placed
    assert placed["eng-prod-job"] >= 2 * placed["eng-dev-job"] - 1, placed
    assert placed["sci-job"] >= 3, placed
    return w


YAML_SCENARIOS = {f.__name__: f for f in (
    cli_submit_schedules, mpi_job_yaml_schedules, tensorflow_job_schedules,
    hierarchical_example_applies_and_splits)}


@pytest.mark.parametrize("name", list(YAML_SCENARIOS))
def test_yaml_scenario_equals_jax(name):
    both(YAML_SCENARIOS[name])


# ---------------------------------------------------------------------------
# vcctl status renderings over the port's endpoints
# ---------------------------------------------------------------------------

class _Args:
    pass


class Replayed:
    """A store client whose wire answers are read once and replayed: the
    port's vcctl and the JAX package's render the same answers (a second
    live read would see the first one's requests counted)."""

    def __init__(self, client):
        self.client = client
        self.host, self.port = client.host, client.port
        self.token = getattr(client, "token", "")
        self.answers: dict = {}

    def _request(self, req):
        key = json.dumps(req, sort_keys=True)
        if key not in self.answers:
            try:
                self.answers[key] = (True, self.client._request(req))
            except Exception as e:  # noqa: BLE001 — replayed as raised
                self.answers[key] = (False, e)
        ok, ans = self.answers[key]
        if not ok:
            raise ans
        return ans


def status_both(address: str) -> str:
    """``vcctl status`` of the port and of the JAX package over the same
    wire answers: equal strings (the lag seconds of a replica chain's
    upstream hops, read live by each, masked)."""
    c = RemoteClusterStore(address)
    try:
        r = Replayed(c)
        out = vcctl.status_cmd(_Args(), r)
        ref = j_vcctl.status_cmd(_Args(), r)
    finally:
        c.close()
    lag = re.compile(r"\b\d+\.\d\b")
    assert lag.sub("<s>", ref) == lag.sub("<s>", out)
    return out


class TestStatus:
    def test_vcctl_status_admission_table(self, gated_store):  # noqa: F811
        store, server, client = gated_store
        client.create("queues", Builders("torch").build_queue("q1"))
        shed = fast_client(server.address, retry_attempts=0)
        faults.arm("admission_shed", at=(1,))
        with pytest.raises(OverloadedError):
            shed.list("queues")
        faults.reset()
        shed.close()
        out = vcctl.main(["--server", f"127.0.0.1:{server.port}",
                          "status"])
        assert "admission (front-door lanes):" in out
        assert "Lane" in out and "Sheds" in out and "DeadlineExp" in out
        for lane in ("system", "control", "bulk", "read"):
            assert lane in out
        assert "fault:1" in out
        assert "fault:1" in status_both(server.address)

    def test_vcctl_status_replica_admission_table(self, tmp_path):
        primary_store = DurableClusterStore(str(tmp_path), fsync="off")
        pserver = StoreServer(primary_store).start()
        primary_store.create("queues", Builders("torch").build_queue("q1"))
        replica = ReplicaStore(pserver.address)
        replica.start()
        try:
            replica.wait_applied(primary_store._rv, wait_s=10)
            rserver = replica.serve()
            out = vcctl.main(["--server", f"127.0.0.1:{rserver.port}",
                              "status"])
            assert "admission (front-door lanes):" in out
            assert "replica upstream chain" in out
            status_both(rserver.address)
        finally:
            replica.close()
            pserver.stop()
            primary_store.close()

    def test_vcctl_status_shows_shard_map(self, proc_cluster):  # noqa: F811
        sup, store, router, remote = proc_cluster
        out = vcctl.main(["--server", f"127.0.0.1:{router.port}",
                          "status"])
        assert "shards=4" in out
        assert "Shard" in out and "Restarts" in out
        for w in sup.workers:
            assert str(w.pid) in out
            assert sup.endpoint(w.idx) in out
        assert out.count("up") >= 4
        assert "shards=4" in status_both(f"127.0.0.1:{router.port}")

    def test_vcctl_reads_surface_applied_rv(self, primary):  # noqa: F811
        store, server, make_replica = primary
        from volcano_tpu_torch.models import Job, JobSpec, TaskSpec
        store.create("jobs", Job(name="j1", namespace="default",
                                 spec=JobSpec(min_available=1, tasks=[
                                     TaskSpec(name="t", replicas=1)])))
        rep = make_replica()
        rep.start()
        assert wait_until(lambda: caught_up(rep, store))
        rs = rep.serve()
        argv = ["--replica", rs.address, "--min-rv", str(store._rv),
                "job", "list"]
        out = vcctl.main(argv)
        assert "j1" in out
        assert f"applied_rv: {store._rv}" in out
        assert mask_ages(j_vcctl.main(argv)) == mask_ages(out)

    def test_vcctl_status_prints_upstream_chain(self, chain):  # noqa: F811
        store, server, r1, rs1, r2, rs2 = chain
        out = status_both(rs2.address)
        assert "replica upstream chain" in out
        # depth-2 -> depth-1 -> primary, with lag and bootstrap columns
        assert rs1.address in out and server.address in out
        assert "primary" in out
        assert "initial:1" in out
        assert "Bootstraps" in out and "Lag(rec)" in out


def test_status_of_an_in_process_store():
    store = pkg_mod("torch", "client").ClusterStore()
    ref = pkg_mod("jax", "client").ClusterStore()
    assert vcctl.main(["status"], cluster=store) \
        == j_vcctl.main(["status"], cluster=ref) \
        == "store: in-process, shards=1, durable=no, rv=0"


def test_flags_without_a_server_are_refused():
    with pytest.raises(SystemExit, match="require --server"):
        vcctl.main(["--token", "t", "job", "list"])
    with pytest.raises(SystemExit, match="read-only"):
        vcctl.main(["--replica", "127.0.0.1:1", "job", "run", "-N", "x"])
