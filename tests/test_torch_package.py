"""Package-level rules of the PyTorch/CUDA port (volcano_tpu_torch):

- importing any of its modules loads neither jax nor the JAX package, and
  no source file of the port imports either;
- its entry points run on CUDA unless the caller passes device="cpu", and
  raise rather than fall back to the host when there is no GPU;
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
                "client.replica", "client.readtier"):
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
