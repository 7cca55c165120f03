"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on first
use into ``build/kernels/<name>-<digest>.so`` at the repository root (the
digest covers the source and the flags, so an edited source rebuilds), or
into the directory ``ops.precompile.configure_compilation_cache`` named. A
library already there for the digest is a cache hit; a build on the
calling thread is one compile in ``ops.precompile.watcher``'s accounting.
Nothing here runs at import time: this module imports on hosts without a
CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
#: where built libraries go (``set_build_dir`` re-points it)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
#: sm_90a keeps Hopper-only instructions available; --fmad=false keeps every
#: fp32 add and multiply separately rounded, like the plain PyTorch versions
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
KERNELS = ("fused_choice",)

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the kernels")
    return path


def set_build_dir(path) -> None:
    """Build and look up kernel libraries under ``path`` from now on
    (libraries already loaded in this process stay loaded)."""
    global BUILD_DIR
    BUILD_DIR = Path(path)


def _target(name: str):
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return src, BUILD_DIR / f"{name}-{digest}.so"


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless it is built already. Returns
    nvcc's ptxas report (registers, shared memory, spills), or "" when the
    library was already there."""
    from .precompile import watcher
    src, so = _target(name)
    if so.exists():
        watcher.record_cache_hit()
        return ""
    t0 = time.perf_counter()
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}")
    os.replace(tmp, so)
    watcher.record_compile(time.perf_counter() - t0)
    return proc.stdout


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build(name)
            lib = ctypes.CDLL(str(_target(name)[1]))
            _libs[name] = lib
        return lib
