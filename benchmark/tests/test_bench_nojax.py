"""Nothing the benchmark runs loads JAX or the JAX package.

In a fresh interpreter: import ``benchmark/run.py``, every module under
``benchmark/`` (the metric readers by path) and the port's modules that
a run drives, then no loaded module's top-level name may be ``jax``,
``jaxlib``, ``flax`` or ``volcano_tpu`` (``volcano_tpu_torch`` is the
port). And the reference imports nothing of the program or of the repo's
scripts."""

import ast
import os
import subprocess
import sys

from tiny import REPO

BENCH = os.path.join(REPO, "benchmark")

PROBE = r"""
import importlib, importlib.util, os, pkgutil, sys
root = sys.argv[1]
sys.path.insert(0, root)
import benchmark
for m in pkgutil.walk_packages(benchmark.__path__, "benchmark."):
    if ".tests" not in m.name:
        importlib.import_module(m.name)
spec = importlib.util.spec_from_file_location(
    "bench_run", os.path.join(root, "benchmark", "run.py"))
spec.loader.exec_module(importlib.util.module_from_spec(spec))
mdir = os.path.join(root, "benchmark", "metrics")
for f in sorted(os.listdir(mdir)):
    if f.endswith(".py"):
        s = importlib.util.spec_from_file_location(f[:-3].replace(".", "_"),
                                                   os.path.join(mdir, f))
        s.loader.exec_module(importlib.util.module_from_spec(s))
for name in ("volcano_tpu_torch.scheduler", "volcano_tpu_torch.cache",
             "volcano_tpu_torch.client", "volcano_tpu_torch.ops.solver",
             "volcano_tpu_torch.ops.hdrf", "volcano_tpu_torch.ops.fused_choice",
             "volcano_tpu_torch.actions.allocate"):
    importlib.import_module(name)
print(" ".join(sorted({m.split(".", 1)[0] for m in sys.modules})))
"""


def test_no_jax_in_the_benchmark_process():
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", PROBE, REPO],
                         capture_output=True, text=True, env=env,
                         timeout=300, check=True).stdout.split()
    assert "volcano_tpu_torch" in out and "benchmark" in out
    assert not {"jax", "jaxlib", "flax", "volcano_tpu"} & set(out)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(BENCH, "reference")
    seen = 0
    for f in sorted(os.listdir(ref)):
        if f.endswith(".py"):
            seen += 1
            for name in _imports(os.path.join(ref, f)):
                top = name.split(".", 1)[0]
                assert top not in ("volcano_tpu_torch", "volcano_tpu",
                                   "chip_smoke", "bench", "benchmark",
                                   "jax"), (f, name)
    assert seen >= 4


def test_nothing_in_the_benchmark_imports_the_repo_scripts():
    for dirpath, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                for name in _imports(os.path.join(dirpath, f)):
                    top = name.split(".", 1)[0]
                    assert top not in ("chip_smoke", "bench", "volcano_tpu",
                                       "jax", "jaxlib", "flax"), (f, name)
