"""The port's compile-and-dispatch pipeline (volcano_tpu_torch.ops.
precompile + the allocate action's prewarm observation) against the JAX
package's (tests/test_precompile.py), on the CPU.

- Layout prediction: the port's predicted next-bucket layout is the JAX
  function's on the same layout and byte-exact against a real port
  flatten at those sizes; unknown keys refuse prediction; the dummy
  packed and sharded buffers and score params equal the JAX functions'
  numpy output.
- CompileWatcher: a background thread's compiles stay out of the session
  totals; a kernel library already in the build directory is a cache
  hit; the first solve at a new (layout, flags, device) key is one
  compile, the second none.
- BucketPrewarmer: a crossing starts exactly the warms the JAX prewarmer
  starts (the JAX warm thread is stubbed: its compile is not the point),
  the warm completes, and the session's first solve in the next bucket
  makes no compile on the session thread; below the threshold nothing
  starts. The prewarmer's solves count apart from the session's.
- Decisions: the Scheduler with prewarm on binds exactly what it binds
  with prewarm off, pipelined or serial, across churn, and exactly what
  the JAX Scheduler binds (op by op: ``jax.disable_jit``).
- configure_compilation_cache: with a dir, with the env fallback, and
  with neither.

Tolerance: exact (layouts, buffers, binds). Tests marked ``cuda`` run the
prewarm phase of chip_smoke.py at a small size on the card (they skip
without a GPU); this module imports JAX only inside the tests that need
it, so there they run with ``python -m pytest --noconftest -m cuda
tests/test_torch_precompile.py``.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from torch_helpers import SeededCluster, pkg_mod

FLAGS = dict(herd_mode="pack", score_families=("binpack", "kube"),
             use_queue_cap=False, use_drf_order=False,
             use_hdrf_order=False, work_conserving=True)


def _pc(pkg):
    return pkg_mod(pkg, "ops.precompile")


def _mini_problem(pkg, n_nodes, n_jobs, tasks_per_job, n_queues=1):
    """tests/test_precompile.py's _mini_problem from ``pkg``'s models."""
    api = pkg_mod(pkg, "api")
    m = pkg_mod(pkg, "models")
    nodes = {}
    for i in range(n_nodes):
        rl = {"cpu": "64", "memory": "256Gi", "pods": 110}
        nodes[f"n{i}"] = api.NodeInfo(m.Node(name=f"n{i}", allocatable=rl,
                                             capacity=dict(rl)))
    jobs, tasks = {}, []
    for k in range(n_jobs):
        pg = m.PodGroup(name=f"j{k}", namespace="t",
                        spec=m.PodGroupSpec(min_member=tasks_per_job,
                                            queue=f"q{k % n_queues}"))
        job = api.JobInfo(f"t/j{k}", pg)
        for i in range(tasks_per_job):
            pod = m.Pod(name=f"j{k}-{i}", namespace="t",
                        annotations={api.POD_GROUP_ANNOTATION: f"j{k}"},
                        containers=[{"requests": {"cpu": str(1 + k % 2),
                                                  "memory": "1Gi"}}])
            t = api.TaskInfo(pod)
            job.add_task_info(t)
            tasks.append(t)
        jobs[job.uid] = job
    return jobs, nodes, tasks


def _flatten(pkg, *shape):
    return pkg_mod(pkg, "ops").flatten_snapshot(*_mini_problem(pkg, *shape))


def _score_params(arr):
    sp = pkg_mod("torch", "ops").ScoreParams(binpack_weight=1.0).resolved(
        arr.R, arr.N)
    return {
        "binpack_weight": np.float32(sp.binpack_weight),
        "binpack_res_weights": sp.binpack_res_weights,
        "least_req_weight": np.float32(sp.least_req_weight),
        "most_req_weight": np.float32(sp.most_req_weight),
        "balanced_weight": np.float32(sp.balanced_weight),
        "node_static": sp.node_static,
    }


# ---------------------------------------------------------------------------
# layout prediction and dummy buffers
# ---------------------------------------------------------------------------

def test_predicted_layout_matches_real_flatten_and_jax():
    bucket = pkg_mod("torch", "ops").bucket
    pc, jpc = _pc("torch"), _pc("jax")
    arr = _flatten("torch", 7, 6, 1)
    _, _, layout = arr.packed()
    assert layout == _flatten("jax", 7, 6, 1).packed()[2]
    dims = pc.layout_dims(layout)
    assert dims == jpc.layout_dims(layout)
    assert dims["T"] == arr.T and dims["N"] == arr.N and dims["J"] == arr.J
    nxt = dict(dims, T=bucket(dims["T"] + 1), J=bucket(dims["J"] + 1))
    layout2 = _flatten("torch", 7, 9, 1).packed()[2]
    assert pc.predict_next_layout(layout, nxt) == layout2
    assert jpc.predict_next_layout(layout, nxt) == layout2


def test_unknown_keys_refuse_prediction():
    layout = (("task_init_req", "f", 0, 16, (8, 2)),
              ("hdrf_parent", "i", 0, 4, (4,)))
    for pkg in ("torch", "jax"):
        assert _pc(pkg).layout_dims(layout) is None
        assert _pc(pkg).predict_next_layout(layout, {"T": 8}) is None


def test_dummy_buffers_and_params_equal_jax():
    arr = _flatten("torch", 5, 4, 2)
    fbuf, ibuf, layout = arr.packed()
    pc, jpc = _pc("torch"), _pc("jax")
    f2d, i2d = pc.dummy_packed_buffers(layout, 512)
    jf, ji = jpc.dummy_packed_buffers(layout, 512)
    assert f2d.size >= fbuf.size and i2d.size >= ibuf.size
    for got, want in ((f2d, jf), (i2d, ji)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    dims = pc.layout_dims(layout)
    params, jparams = pc.dummy_score_params(dims), \
        jpc.dummy_score_params(dims)
    assert sorted(params) == sorted(jparams)
    for k in params:
        assert np.asarray(params[k]).dtype == np.asarray(jparams[k]).dtype
        assert np.array_equal(params[k], jparams[k])
    assert pc.SOLVE_FLAG_NAMES == jpc.SOLVE_FLAG_NAMES


@pytest.mark.parametrize("shards", [1, 2])
def test_dummy_sharded_buffers_equal_jax(shards):
    import jax

    from volcano_tpu_torch.parallel import Mesh
    arr = _flatten("torch", 8, 4, 2)
    layout = arr.packed()[2]
    got = _pc("torch").dummy_sharded_buffers(layout, 512,
                                             Mesh(["cpu"] * shards))
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:shards]), ("n",))
    want = _pc("jax").dummy_sharded_buffers(layout, 512, jmesh)
    for g, w in zip(got[:4], want[:4]):
        w = np.asarray(w)
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert got[4:] == want[4:]


def test_relayout_is_a_real_flatten_padded():
    """The prewarm content: the live snapshot re-laid into the next
    bucket equals a real flatten at the larger sizes wherever the real
    flatten pads (every padded row takes the flatten's pad values)."""
    pc = _pc("torch")
    bucket = pkg_mod("torch", "ops").bucket
    arr = _flatten("torch", 7, 6, 1)
    fbuf, ibuf, layout = arr.packed()
    dims = pc.layout_dims(layout)
    nxt = dict(dims, T=bucket(dims["T"] + 1), N=bucket(dims["N"] + 1))
    layout2 = pc.predict_next_layout(layout, nxt)
    f2d, i2d = pc.relayout_buffers(fbuf, ibuf, layout, layout2, nxt, 512)
    # a real flatten whose live rows are the old ones: pads equal
    old = {k: (off, size, shape) for k, _, off, size, shape in layout}
    for key, kind, off2, size2, shape2 in layout2:
        buf = (f2d if kind == "f" else i2d).reshape(-1)
        got = buf[off2:off2 + size2].reshape(shape2)
        off, size, shape = old[key]
        src = (fbuf if kind == "f" else ibuf)[off:off + size].reshape(shape)
        assert np.array_equal(got[tuple(slice(0, n) for n in shape)], src)
    vals = {k: (f2d if kind == "f" else i2d).reshape(-1)[
        off:off + size].reshape(shape)
        for k, kind, off, size, shape in layout2}
    assert (vals["node_alloc"][dims["N"]:] == 1.0).all()
    assert (vals["task_job"][dims["T"]:] == nxt["J"] - 1).all()
    assert not vals["task_valid"][dims["T"]:].any()
    assert not vals["node_valid"][dims["N"]:].any()


# ---------------------------------------------------------------------------
# compile accounting
# ---------------------------------------------------------------------------

def test_background_threads_are_excluded_from_session_totals():
    w = _pc("torch").CompileWatcher()
    w.install()
    w.record_compile(1.0)
    done = threading.Event()

    def bg():
        w.register_background()
        w.record_compile(2.0)
        done.set()

    t = threading.Thread(target=bg)
    t.start()
    t.join(timeout=10)
    assert done.is_set() and not t.is_alive()
    assert w.session_totals() == (1, 1.0)
    assert w.counts()[0] == 1


def test_first_solve_at_a_key_is_one_compile():
    w = _pc("torch").CompileWatcher()
    with w.first_solve("k"):
        pass   # not installed: warmth is tracked, nothing counted
    assert w.session_totals() == (0, 0.0)
    w.install()
    with w.first_solve("k"):
        pass
    with w.first_solve("k2"):
        pass
    with pytest.raises(RuntimeError):
        with w.first_solve("k3"):
            raise RuntimeError("a failed solve warms nothing")
    with w.first_solve("k3"):
        pass
    assert w.session_totals()[0] == 2


def test_prebuilt_library_is_a_cache_hit(tmp_path, monkeypatch):
    from volcano_tpu_torch.ops import _build
    pc = _pc("torch")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(pc, "watcher", pc.CompileWatcher())
    pc.watcher.install()
    _, so = _build._target("fused_choice")
    so.write_bytes(b"")
    assert _build.build("fused_choice") == ""
    assert pc.watcher.cache_hits == 1
    assert pc.watcher.session_totals() == (0, 0.0)


# ---------------------------------------------------------------------------
# the bucket prewarmer
# ---------------------------------------------------------------------------

def _session(dc, tpj, n_jobs=4):
    """One allocate-like session on a CPU arena: update, solve, and the
    flags and inputs snapshot the allocate action leaves for the
    prewarmer."""
    from volcano_tpu_torch.ops.solver import solve_allocate_packed2d
    arr = _flatten("torch", 5, n_jobs, tpj)
    fbuf, ibuf, layout = arr.packed()
    params = _score_params(arr)
    f2d, i2d = dc.update(fbuf, ibuf, layout)
    res = solve_allocate_packed2d(f2d, i2d, layout, dc.params_device(params),
                                  **FLAGS)
    dc.last_solve_flags = dict(layout=layout, **FLAGS)
    dc.last_solve_inputs = (fbuf, ibuf, params)
    return arr, res.assigned.numpy()


def _jax_started(arr, layout, monkeypatch):
    """The warm keys the JAX prewarmer starts on this occupancy and layout
    (its warm thread stubbed)."""
    jpc = _pc("jax")
    monkeypatch.setattr(jpc.BucketPrewarmer, "_warm_many",
                        lambda self, *a: None)
    dc = pkg_mod("jax", "ops").PackedDeviceCache()
    dc._layout = layout
    dc.last_solve_flags = dict(layout=layout, **FLAGS)
    pw = jpc.BucketPrewarmer()
    started = pw.observe(arr, dc)
    pw.wait(10)
    return started, sorted(pw._started)


def test_crossing_warms_with_zero_session_thread_compiles(monkeypatch):
    """Warm session at bucket B, the occupancy trigger warms B+1
    off-thread (the same keys the JAX prewarmer starts), then a real
    crossing into B+1 solves with no compile on the session thread."""
    from volcano_tpu_torch.ops import PackedDeviceCache, bucket
    from volcano_tpu_torch.ops import fused_choice as fc
    pc = _pc("torch")
    assert pc.watcher.install()
    dc = PackedDeviceCache(device="cpu")
    arr, _ = _session(dc, 12)          # 48 tasks: T = bucket(48) = 48
    assert arr.T == 48
    pw = pc.BucketPrewarmer()
    launches = fc.fused_choice.launches
    assert pw.observe(arr, dc)         # 48/48 >= 0.8 -> warm 56
    assert pw.wait(600)
    assert pw.completions >= 1 and pw.failures == 0
    assert fc.fused_choice.launches == launches   # CPU: the plain version
    started, jax_keys = _jax_started(arr, dc._layout, monkeypatch)
    assert started and sorted(pw._started) == jax_keys
    # dedup: the same trigger doesn't re-warm
    assert not pw.observe(arr, dc)

    c0, _ = pc.watcher.counts()
    arr2, got = _session(dc, 13)       # 52 tasks: T = bucket(52) = 56
    assert arr2.T == bucket(49)
    assert pc.watcher.counts()[0] == c0, "solve went cold on the session"
    # the warm changed nothing the session decides
    assert np.array_equal(got, _session(PackedDeviceCache(device="cpu"),
                                        13)[1])


def test_no_trigger_below_threshold(monkeypatch):
    from volcano_tpu_torch.ops import PackedDeviceCache
    dc = PackedDeviceCache(device="cpu")
    arr, _ = _session(dc, 2, n_jobs=2)     # 4 tasks in T=8
    pw = _pc("torch").BucketPrewarmer()
    assert not pw.observe(arr, dc)
    assert _jax_started(arr, dc._layout, monkeypatch) == (False, [])


def test_prewarm_counting_is_per_thread():
    """counted_as_prewarm marks only the calling thread (the wrapper
    reads the mark to count a launch in launches_prewarm instead of
    launches), and the mark is gone after the block."""
    from volcano_tpu_torch.ops import fused_choice as fc
    seen = []

    def other():
        seen.append(getattr(fc._thread, "prewarm", False))

    assert not getattr(fc._thread, "prewarm", False)
    with fc.counted_as_prewarm():
        assert fc._thread.prewarm
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=10)
        with fc.counted_as_prewarm():
            pass
        assert fc._thread.prewarm   # nested blocks restore the mark
    assert not fc._thread.prewarm and seen == [False]


# ---------------------------------------------------------------------------
# decisions: prewarm and the pipeline change nothing
# ---------------------------------------------------------------------------

def _churn(pkg, prewarm=False, pipelined=True, cycles=4):
    c = SeededCluster(pkg, 41, n_nodes=8)
    if pkg == "torch":
        sched_mod = pkg_mod("torch", "scheduler")
        c.sched = sched_mod.Scheduler(c.cache, prewarm=prewarm,
                                      pipeline_solver=pipelined)
    stream = []
    for cycle in range(cycles):
        if pkg == "jax":
            import jax
            with jax.disable_jit():
                stream.append(c.cycle(4, churn=0.3 if cycle else 0.0))
        else:
            stream.append(c.cycle(4, churn=0.3 if cycle else 0.0))
            if prewarm:
                assert c.cache.prewarmer.wait(600)
    return c, stream


def test_prewarm_and_pipeline_bind_identically_and_equal_jax():
    on, s_on = _churn("torch", prewarm=True)
    _, s_off = _churn("torch", prewarm=False)
    _, s_serial = _churn("torch", prewarm=True, pipelined=False)
    assert s_on == s_off == s_serial
    assert sum(len(b) for b in s_on) > 10
    pw = on.cache.prewarmer
    assert pw.completions >= 1 and pw.failures == 0
    t = on.sched.last_cycle_timing
    assert t["prewarm_completions"] == float(pw.completions)
    assert "session_compiles" in t and "compile_cache_hits" in t
    _, s_jax = _churn("jax")
    assert s_on == s_jax


# ---------------------------------------------------------------------------
# the kernel build directory
# ---------------------------------------------------------------------------

@pytest.fixture
def build_dir_restored(monkeypatch):
    from volcano_tpu_torch.ops import _build
    pc = _pc("torch")
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.setattr(pc, "_configured_dir", None)
    return _build


def test_configure_points_the_kernel_builds(tmp_path, build_dir_restored):
    pc = _pc("torch")
    d = tmp_path / "kernels"
    assert pc.configure_compilation_cache(str(d)) == str(d)
    assert d.is_dir() and build_dir_restored.BUILD_DIR == d
    assert build_dir_restored._target("fused_choice")[1].parent == d
    assert pc.configure_compilation_cache(str(d)) == str(d)  # idempotent


def test_env_fallback(tmp_path, monkeypatch, build_dir_restored):
    pc = _pc("torch")
    monkeypatch.setenv(pc.CACHE_DIR_ENV, str(tmp_path / "envcache"))
    assert pc.configure_compilation_cache() == str(tmp_path / "envcache")
    assert build_dir_restored.BUILD_DIR == tmp_path / "envcache"


def test_unchanged_without_dir(monkeypatch, build_dir_restored):
    pc = _pc("torch")
    before = build_dir_restored.BUILD_DIR
    monkeypatch.delenv(pc.CACHE_DIR_ENV, raising=False)
    assert pc.configure_compilation_cache() is None
    assert build_dir_restored.BUILD_DIR == before


def test_scheduler_wires_the_pipeline(tmp_path, build_dir_restored):
    cache_mod = pkg_mod("torch", "cache")
    store = pkg_mod("torch", "client").ClusterStore()
    cache = cache_mod.SchedulerCache(store, device="cpu")
    sched = pkg_mod("torch", "scheduler").Scheduler(
        cache, prewarm=True, compile_cache_dir=str(tmp_path / "cc"))
    assert sched.compile_cache_dir == str(tmp_path / "cc")
    assert isinstance(cache.prewarmer, _pc("torch").BucketPrewarmer)
    assert build_dir_restored.BUILD_DIR == tmp_path / "cc"


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_prewarm_arms_bind_identically_on_card(cuda_device):
    """chip_smoke.py's prewarm phase at a small size, both arms in this
    process: identical binds, the warm completes without failure."""
    import chip_smoke
    off = chip_smoke.prewarm_arm(cuda_device, False, chip_smoke.PREWARM_SMALL)
    on = chip_smoke.prewarm_arm(cuda_device, True, chip_smoke.PREWARM_SMALL)
    digests = [[r["binds_digest"] for r in arm["rows"]] for arm in (off, on)]
    assert digests[0] == digests[1] and len(digests[1]) == len(
        chip_smoke.PREWARM_SMALL["sizes"])
    assert on["completions"] >= 1 and on["failures"] == 0
    assert all(r["binds"] and r["launches"] for r in on["rows"])
