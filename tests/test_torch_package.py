"""Package-level rules of the PyTorch/CUDA port (volcano_tpu_torch):

- importing any of its modules loads neither jax nor the JAX package, and
  no source file of the port imports either;
- its entry points run on CUDA unless the caller passes device="cpu", and
  raise rather than fall back to the host when there is no GPU: the
  Scheduler, the sim (VirtualCluster, run_sim, verify), the Standalone and
  the three ``-m`` entry points (sim, vcctl sim, standalone);
- every process its entry points start runs the port, never jax or the
  JAX package (shard workers, vcctl, the sim);
- the compact int16 result round-trips and packs exactly like the JAX
  package's.
"""

from __future__ import annotations

import json
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")  # the JAX reference: absent on the card's machine

import torch

import jax.numpy as jnp

import volcano_tpu_torch
from volcano_tpu.ops.solver import _compact as j_compact
from volcano_tpu_torch.ops import solver as ts
from volcano_tpu_torch.ops.convert import to_torch_arrays

from test_torch_flatten import cluster_spec, flatten
from test_torch_solver import params_dict

PORT_DIR = Path(volcano_tpu_torch.__file__).resolve().parent
REPO = PORT_DIR.parent


def port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [str(PORT_DIR)], prefix="volcano_tpu_torch."))


def test_import_leaves_jax_and_the_jax_package_out():
    mods = port_modules()
    assert "volcano_tpu_torch.ops.fused_choice" in mods
    assert "volcano_tpu_torch.api.job_info" in mods
    assert "volcano_tpu_torch.controllers.job.controller" in mods
    assert "volcano_tpu_torch.webhooks.jobs" in mods
    for mod in ("resilience.overload", "client.codec", "client.durable",
                "client.server", "client.remote", "metrics.server",
                "webhooks.server", "client.sharded", "client.shardproc",
                "client.replica", "client.readtier", "sim", "sim.__main__",
                "sim.recorder", "sim.replay", "sim.score",
                "sim.virtualcluster", "sim.workload", "cli", "cli.__main__",
                "cli.vcctl", "standalone"):
        assert f"volcano_tpu_torch.{mod}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m in ('jax', 'jaxlib', "
        "'volcano_tpu') or m.startswith(('jax.', 'jaxlib.', "
        "'volcano_tpu.'))]\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_imports_without_cryptography():
    """The card's machine has no ``cryptography``: every module imports
    without it (the webhook server's certificate generation imports it
    when called, and only then fails)."""
    code = (
        "import importlib, importlib.abc, sys\n"
        "class Hide(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path, target=None):\n"
        "        if name.split('.')[0] == 'cryptography':\n"
        "            raise ModuleNotFoundError(name)\n"
        "sys.meta_path.insert(0, Hide())\n"
        f"for m in {port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "from volcano_tpu_torch.webhooks import serve_webhooks\n"
        "from volcano_tpu_torch.webhooks.server import "
        "generate_self_signed_cert\n"
        "from volcano_tpu_torch.client import StoreServer, "
        "RemoteClusterStore, DurableClusterStore, WriteAheadLog\n"
        "try:\n"
        "    generate_self_signed_cert()\n"
        "except ModuleNotFoundError:\n"
        "    print('HIDDEN')\n"
        "assert 'cryptography' not in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "HIDDEN" in proc.stdout


IMPORT_RE = re.compile(
    r"^\s*(?:from|import)\s+(?:jax|jaxlib|volcano_tpu)(?:\.|\s|$)"
    r"|import_module\(\s*['\"](?:jax|volcano_tpu)\b(?!_torch)", re.M)


def test_port_has_every_module_of_the_jax_package():
    """File for file, the port holds every module of the JAX package but
    its Pallas kernel's, and adds only its own kernel, build, conversion,
    mesh and round-graph modules and its span recorder."""
    def tree(root):
        return {p.relative_to(root).as_posix() for p in root.rglob("*.py")}
    ref = tree(REPO / "volcano_tpu")
    port = tree(PORT_DIR)
    assert ref - port == {"ops/pallas_kernels.py"}
    assert port - ref == {"ops/_build.py", "ops/convert.py",
                          "ops/fused_choice.py", "ops/round_graph.py",
                          "parallel/mesh.py", "metrics/tracing.py"}
    assert (PORT_DIR / "csrc" / "fused_choice.cu").is_file()


#: reference suites whose classes the port's tests hold in files of other
#: names (each class named there); every other tests/test_<x>.py has a
#: tests/test_torch_<x>.py
TWIN_FILES = {
    "delta_path": ("test_torch_netstore.py",),
    "wire_delta": ("test_torch_netstore.py",),
    "admission_cli": ("test_torch_admission.py", "test_torch_cli.py",
                      "test_torch_installer.py"),
    "ha_observability": ("test_torch_failover.py", "test_torch_netha.py"),
}
#: reference classes no port test holds yet, and what they wait for
WAITING: dict = {}


def test_every_reference_suite_has_a_port_twin():
    tests = REPO / "tests"
    for ref in sorted(tests.glob("test_*.py")):
        name = ref.stem[len("test_"):]
        if name.startswith("torch_"):
            continue
        if (tests / f"test_torch_{name}.py").is_file():
            assert name not in TWIN_FILES, name
            continue
        assert name in TWIN_FILES, f"{ref.name} has no port twin"
        text = "".join((tests / f).read_text() for f in TWIN_FILES[name])
        for cls in re.findall(r"^class (Test\w+)", ref.read_text(), re.M):
            if (name, cls) in WAITING:
                assert not re.search(rf"\b{cls}\b", text), cls
                continue
            assert re.search(rf"\b{cls}\b", text), f"{ref.name}::{cls}"
    assert set(TWIN_FILES) >= {n for n, _ in WAITING}


#: the compile pipeline's families describe what the port compiles
#: (kernel builds and cold first solves), not XLA's compiles
PORT_HELP = {"volcano_solver_compile_total",
             "volcano_solver_compile_seconds_total",
             "volcano_compile_cache_hits_total"}


def test_metric_families_match_the_jax_package():
    """The port registers every metric family the JAX package does, no
    other, each of the same type; its /metrics exposition has the same
    ``# TYPE`` lines and the same ``# HELP`` lines but the compile
    pipeline's."""
    from volcano_tpu.metrics import metrics as j_metrics
    from volcano_tpu_torch.metrics import metrics as t_metrics

    def header(reg, tag):
        out = {}
        for line in reg.expose().splitlines():
            if line.startswith(f"# {tag} "):
                name, _, rest = line[len(tag) + 3:].partition(" ")
                out[name] = rest
        return out

    jreg, treg = j_metrics.registry, t_metrics.registry
    assert header(treg, "TYPE") == header(jreg, "TYPE")
    jhelp, thelp = header(jreg, "HELP"), header(treg, "HELP")
    assert set(thelp) == set(jhelp)
    assert len(jhelp) >= 100
    assert {n for n in jhelp if thelp[n] != jhelp[n]} == PORT_HELP
    for name in ("volcano_sim_cycles_total", "volcano_sim_decisions_total",
                 "volcano_sim_replay_divergences_total",
                 "volcano_pod_schedule_errors",
                 "volcano_pod_schedule_successes",
                 "volcano_queue_pod_group_inqueue_count",
                 "volcano_queue_pod_group_pending_count",
                 "volcano_queue_pod_group_running_count",
                 "volcano_queue_pod_group_unknown_count"):
        assert name in thelp
    assert volcano_tpu_torch.__version__ == "0.1.0"


def test_no_port_file_imports_jax_or_the_jax_package():
    files = [p for p in PORT_DIR.rglob("*")
             if p.suffix in (".py", ".cu", ".cuh")]
    assert len(files) >= 15
    for p in files:
        text = p.read_text()
        assert not IMPORT_RE.search(text), p
        # no compiler of the plain version stands in for a kernel
        assert "torch.compile" not in text, p


def test_entry_points_need_cuda_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    arr = flatten("torch", cluster_spec(2, n_nodes=8, n_jobs=4))
    p = params_dict(arr, binpack=1.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        arr.device_dict()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        to_torch_arrays(arr.numpy_dict())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ts.solve_allocate(arr.numpy_dict(), p)
    from volcano_tpu_torch.cache import SchedulerCache
    from volcano_tpu_torch.client import ClusterStore
    from volcano_tpu_torch.ops import PackedDeviceCache
    from volcano_tpu_torch.scheduler import Scheduler
    # the packed path starts at the arena, which needs the device
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PackedDeviceCache()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Scheduler(SchedulerCache(ClusterStore()))
    # the explicit host run works, cold and through the arena
    res = ts.solve_allocate(arr.numpy_dict(), p, device="cpu")
    assert res.assigned.device.type == "cpu"
    dc = PackedDeviceCache(device="cpu")
    assert dc.device.type == "cpu"
    fbuf, ibuf, layout = arr.packed()
    res = ts.solve_allocate_packed2d(*dc.update(fbuf, ibuf, layout), layout,
                                     p)
    assert res.assigned.device.type == "cpu"
    Scheduler(SchedulerCache(ClusterStore(), device="cpu")).run_once()
    # the simulator and the standalone control plane: the same rule
    from volcano_tpu_torch.sim import (
        VirtualCluster, Workload, WorkloadSpec, run_sim, verify,
    )
    from volcano_tpu_torch.standalone import Standalone
    wl = Workload(WorkloadSpec(seed=1, cycles=2, nodes=2))
    for fn in (lambda: VirtualCluster(wl),
               lambda: run_sim(workload=wl, cycles=2),
               lambda: verify([], workload=wl, cycles=2),
               lambda: Standalone(metrics_port=0)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn()
    assert len(run_sim(workload=wl, cycles=2, device="cpu").lines) == 2
    Standalone(metrics_port=0, device="cpu").stop()


@pytest.mark.parametrize("argv", [
    ["volcano_tpu_torch.sim", "--cycles", "2"],
    ["volcano_tpu_torch.cli", "sim", "--cycles", "2"],
    ["volcano_tpu_torch.standalone", "--metrics-port", "0"],
], ids=["sim", "vcctl-sim", "standalone"])
def test_module_entry_points_need_cuda_or_device_cpu(argv):
    """The three ``-m`` entry points without ``--device`` raise on a host
    with no CUDA device, and run with ``--device cpu`` (the standalone
    until it is up)."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-m", *argv], cwd=str(REPO),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert "device='cpu'" in proc.stderr, proc.stderr[-2000:]
    if argv[0].endswith("standalone"):
        child = subprocess.Popen([sys.executable, "-m", *argv, "--device",
                                  "cpu"], cwd=str(REPO), env=env,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
        try:
            assert "standalone up" in child.stdout.readline()
        finally:
            child.terminate()
            assert child.wait(timeout=60) == 0
    else:
        proc = subprocess.run([sys.executable, "-m", *argv, "--device",
                               "cpu"], cwd=str(REPO), env=env,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert "digest" in proc.stdout


def test_read_store_raises_before_any_controller_is_built(monkeypatch):
    """The read tier (client.readtier) is ported: ``read_store=`` no
    longer raises; the manager builds its five controllers over a
    ReadTierStore whose writes go to the primary and reads to the
    replica, and without it over the plain store."""
    import volcano_tpu_torch.controllers as ctl
    from volcano_tpu_torch.client import ClusterStore, ReadTierStore
    built = []

    class Spy:
        def __init__(self):
            built.append(self)

        def initialize(self, opt):
            pass

    for name in ("JobController", "QueueController", "PodGroupController",
                 "KubeletStandin", "GarbageCollector"):
        monkeypatch.setattr(ctl, name, Spy)
    primary, replica = ClusterStore(), ClusterStore()
    cm = ctl.ControllerManager(primary, read_store=replica)
    assert len(built) == 5
    tier = cm.opt.cluster
    assert isinstance(tier, ReadTierStore)
    assert tier.write_store is primary and tier.read_store is replica
    cm = ctl.ControllerManager(ClusterStore())
    assert len(built) == 10 and not isinstance(cm.opt.cluster,
                                               ReadTierStore)


#: a sitecustomize for the processes of one test: records each process's
#: pid, and refuses (and records) any import of jax or the JAX package
REFUSE_JAX = """
import os, sys
LOG = os.environ["PORT_IMPORT_LOG"]
open(os.path.join(LOG, f"pid-{os.getpid()}"), "w").close()


class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "volcano_tpu"):
            open(os.path.join(LOG, f"bad-{os.getpid()}-{name}"), "w").close()
            raise ImportError(f"refused: {name}")
        return None


sys.meta_path.insert(0, Refuse())
"""


def test_shard_workers_run_the_port_without_jax(tmp_path):
    """The supervisor spawns ``python -m volcano_tpu_torch.client.shardproc``
    (each worker's /proc/PID/cmdline), and a worker never imports jax or
    the JAX package: every process of the run starts under an import hook
    that refuses them, and the workers serve through it."""
    hook, log = tmp_path / "hook", tmp_path / "log"
    hook.mkdir()
    log.mkdir()
    (hook / "sitecustomize.py").write_text(REFUSE_JAX)
    code = (
        "import json, sys\n"
        "from volcano_tpu_torch.client import (ProcShardRouter, "
        "ProcShardedStore, RemoteClusterStore, ShardProcSupervisor)\n"
        "from volcano_tpu_torch.models import Pod\n"
        f"sup = ShardProcSupervisor(2, data_dir={str(tmp_path / 'd')!r}, "
        "fsync='off').start()\n"
        "router = ProcShardRouter(ProcShardedStore(sup), port=0).start()\n"
        "c = RemoteClusterStore(f'127.0.0.1:{router.port}')\n"
        "for i in range(8):\n"
        "    c.create('pods', Pod(name=f'p{i}', namespace='ns'))\n"
        "pids = [w.pid for w in sup.workers]\n"
        "argv = [open(f'/proc/{p}/cmdline', 'rb').read().decode()"
        ".split(chr(0)) for p in pids]\n"
        "print(json.dumps({'pids': pids, 'argv': argv, 'alive': "
        "[w.alive for w in sup.workers], 'pods': len(c.list('pods')), "
        "'mods': [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'volcano_tpu')]}))\n"
        "c.close(); router.stop(); sup.stop()\n")
    env = dict(os.environ, PYTHONPATH=f"{hook}{os.pathsep}{REPO}",
               PORT_IMPORT_LOG=str(log))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["alive"] == [True, True] and out["pods"] == 8
    assert out["mods"] == []
    for pid, argv in zip(out["pids"], out["argv"]):
        assert argv[1:3] == ["-m", "volcano_tpu_torch.client.shardproc"]
        assert (log / f"pid-{pid}").exists()  # the hook ran in the worker
    assert sorted(p.name for p in log.iterdir()
                  if p.name.startswith("bad-")) == []


def test_entry_point_children_run_the_port_without_jax(tmp_path):
    """``python -m volcano_tpu_torch.standalone --store-shard-procs`` and
    the ``-m`` entry points driven against it: every process of the run
    starts under an import hook that refuses jax and the JAX package, the
    standalone's shard workers are ``python -m
    volcano_tpu_torch.client.shardproc`` (their /proc/PID/cmdline), and
    the cluster schedules a job."""
    import time

    from volcano_tpu_torch.client import RemoteClusterStore
    from volcano_tpu_torch.models import Node

    from test_torch_netha import free_port
    hook, log = tmp_path / "hook", tmp_path / "log"
    hook.mkdir()
    log.mkdir()
    (hook / "sitecustomize.py").write_text(REFUSE_JAX)
    env = dict(os.environ, PYTHONPATH=f"{hook}{os.pathsep}{REPO}",
               PORT_IMPORT_LOG=str(log))
    addr = f"127.0.0.1:{free_port()}"
    sa = subprocess.Popen(
        [sys.executable, "-m", "volcano_tpu_torch.standalone",
         "--serve-store", addr, "--store-shards", "2",
         "--store-shard-procs", "--store-data-dir", str(tmp_path / "d"),
         "--metrics-port", "0", "--period", "0.1", "--device", "cpu"],
        cwd=str(REPO), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    remote = None
    try:
        line = sa.stdout.readline()
        assert "standalone up" in line, line + sa.stdout.read()[-3000:]
        remote = RemoteClusterStore(addr)
        workers = remote._request({"op": "topology"})["workers"]
        assert len(workers) == 2
        for w in workers:
            argv = open(f"/proc/{w['pid']}/cmdline", "rb").read() \
                .decode().split("\0")
            assert argv[1:3] == ["-m", "volcano_tpu_torch.client.shardproc"]
            assert (log / f"pid-{w['pid']}").exists()
        rl = {"cpu": "4", "memory": "8Gi", "pods": "110"}
        remote.create("nodes", Node(name="n1", allocatable=dict(rl),
                                    capacity=dict(rl)))
        job = tmp_path / "job.yaml"
        job.write_text(
            "kind: Job\nmetadata: {name: j, namespace: default}\n"
            "spec:\n  minAvailable: 1\n  tasks:\n  - name: w\n"
            "    replicas: 1\n    template:\n      spec:\n"
            "        containers:\n        - name: c\n"
            "          requests: {cpu: \"1\"}\n")
        cli = [sys.executable, "-m", "volcano_tpu_torch.cli", "--server",
               addr]
        for argv in (["job", "run", "-f", str(job)], ["status"]):
            out = subprocess.run(cli + argv, cwd=str(REPO), env=env,
                                 capture_output=True, text=True,
                                 timeout=300)
            assert out.returncode == 0, out.stderr[-2000:]
        deadline = time.time() + 60
        while time.time() < deadline and not all(
                p.node_name for p in remote.list("pods") or [None]):
            time.sleep(0.1)
        assert [p.node_name for p in remote.list("pods")] == ["n1"]
        out = subprocess.run(
            [sys.executable, "-m", "volcano_tpu_torch.sim", "--cycles", "3",
             "--device", "cpu", "--quiet"], cwd=str(REPO), env=env,
            capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-2000:]
    finally:
        if remote is not None:
            remote.close()
        sa.terminate()
        assert sa.wait(timeout=120) == 0
    pids = {p.name for p in log.iterdir() if p.name.startswith("pid-")}
    assert len(pids) >= 6  # standalone, 2 workers, 2 vcctl, sim
    assert sorted(p.name for p in log.iterdir()
                  if p.name.startswith("bad-")) == []


def test_solver_option_errors():
    arr = flatten("torch", cluster_spec(3, n_nodes=8, n_jobs=4))
    d, p = arr.numpy_dict(), params_dict(arr, binpack=1.0)
    with pytest.raises(ValueError, match="CUDA"):
        ts.solve_allocate(d, p, device="cpu", fused="on")
    # the hierarchy needs its tree arrays (ops.hdrf.build_hdrf)
    with pytest.raises(ValueError, match="hdrf"):
        ts.solve_allocate(d, p, device="cpu", use_drf_order=True,
                          use_hdrf_order=True)
    with pytest.raises(ValueError, match="fused"):
        ts.solve_allocate(d, p, device="cpu", fused="maybe")


@pytest.mark.parametrize("n_nodes", [56, 2048, 1 << 14])
def test_compact_round_trip_matches_jax(n_nodes):
    rng = np.random.default_rng(n_nodes)
    T = 300
    assigned = rng.integers(-1, n_nodes, T).astype(np.int32)
    kind = np.where(assigned < 0, -1, rng.integers(0, 2, T)).astype(np.int32)
    c = ts._compact(torch.from_numpy(assigned), torch.from_numpy(kind),
                    n_nodes)
    assert c.dtype == torch.int16
    np.testing.assert_array_equal(
        c.numpy(), np.asarray(j_compact(jnp.asarray(assigned),
                                        jnp.asarray(kind), n_nodes)))
    a2, k2 = ts.decode_compact(c)
    np.testing.assert_array_equal(a2, assigned)
    np.testing.assert_array_equal(k2, kind)


def test_compact_sentinel_past_the_int16_packing():
    assigned = torch.tensor([0, 5, -1], dtype=torch.int32)
    kind = torch.tensor([0, 1, -1], dtype=torch.int32)
    c = ts._compact(assigned, kind, (1 << 14) + 1)
    assert (c == ts.COMPACT_UNAVAILABLE).all()
    with pytest.raises(ValueError, match="unavailable"):
        ts.decode_compact(c)


def test_kernel_build_targets_stay_in_the_checkout():
    from volcano_tpu_torch.ops import _build
    src, so = _build._target("fused_choice")
    assert src.is_file() and src.parent == PORT_DIR / "csrc"
    assert so.parent == REPO / "build" / "kernels"
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
    assert "--fmad=false" in _build.NVCC_FLAGS
