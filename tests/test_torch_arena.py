"""The port's device-resident arena (volcano_tpu_torch.ops.device_cache)
and its packed entry point (``PackedDeviceCache.update`` then
``ops.solver.solve_allocate_packed2d``) against the JAX package's, on the
CPU.

- ``SnapshotArrays.packed()`` gives the JAX package's (fbuf, ibuf, layout)
  bit for bit on seeded snapshots.
- ``PackedDeviceCache(device="cpu")``: full ships, exact dirty-chunk
  deltas and their bytes (``chunk * 4 + 4`` a chunk), ``invalidate`` /
  ``reset`` and zero-dirty sessions, mirroring tests/test_arena.py's unit
  contracts.
- Arena vs cold: over churned sessions the delta path (in-place scatter
  into the resident buffers, views of them into the solve) gives the same
  ``compact`` as a cold ``solve_allocate`` of the same arrays, and as the
  JAX package's ``plan_delta`` + ``solve_allocate_delta`` run op by op
  (``jax.disable_jit``: XLA's CPU jit contracts FMAs, see
  test_torch_solver.py), with the same dirty chunks. Tolerance: exact.
"""

from __future__ import annotations

import numpy as np
import pytest

pytest.importorskip("jax")  # the JAX reference: absent on the card's machine

import torch

import jax

from volcano_tpu.ops import PackedDeviceCache as JPackedDeviceCache
from volcano_tpu.ops import solver as js
from volcano_tpu_torch.ops import PackedDeviceCache
from volcano_tpu_torch.ops import solver as ts

from test_torch_flatten import cluster_spec, flatten
from test_torch_solver import params_dict


@pytest.mark.parametrize("seed,kw", [
    (0, {}),
    (1, {"gpu": True}),
    (3, {"n_nodes": 37, "n_jobs": 9, "tasks_per_job": 5, "n_queues": 2}),
])
def test_packed_bit_identical_to_jax(seed, kw):
    spec = cluster_spec(seed, **kw)
    jf, ji, jl = flatten("jax", spec).packed()
    tf, ti, tl = flatten("torch", spec).packed()
    assert tl == jl
    assert {k[1] for k in tl} == {"f", "i", "b"}
    assert (tf.dtype, ti.dtype) == (jf.dtype, ji.dtype)
    assert tf.tobytes() == jf.tobytes()
    assert ti.tobytes() == ji.tobytes()


@pytest.mark.parametrize("tree", ["example", "ragged"])
def test_packed_with_hdrf_bit_identical_to_jax(tree):
    """With the hdrf tree built the layout carries its eight arrays, and
    the bytes still equal the JAX package's; without it they are absent."""
    from test_torch_hdrf import EXAMPLE, RAGGED, hdrf_flatten
    t = {"example": EXAMPLE, "ragged": RAGGED}[tree]
    jf, ji, jl = hdrf_flatten("jax", 8, t, n_queues=len(t)).packed()
    arr = hdrf_flatten("torch", 8, t, n_queues=len(t))
    tf, ti, tl = arr.packed()
    assert tl == jl
    assert sum(k.startswith("hdrf_") for k, *_ in tl) == 8
    assert tf.tobytes() == jf.tobytes()
    assert ti.tobytes() == ji.tobytes()
    arr.hdrf_parent = None
    assert not any(k.startswith("hdrf_") for k, *_ in arr.packed()[2])


def test_hdrf_layout_change_reships_the_arena():
    """The first hdrf session after a plain one changes the packed layout:
    the arena ships whole (never a scatter into the stale layout) and the
    solve equals a cold one; the next hdrf session is a delta again."""
    from test_torch_hdrf import EXAMPLE, hdrf_flatten
    arr = hdrf_flatten("torch", 9, EXAMPLE, n_queues=3, n_nodes=10,
                       n_jobs=6)
    params = params_dict(arr, binpack=1.0)
    flags = dict(FLAGS, use_drf_order=True, use_hdrf_order=True)
    tree = {k: getattr(arr, k) for k in arr.numpy_dict()
            if k.startswith("hdrf_")}
    dc = PackedDeviceCache(device="cpu")
    arr.hdrf_parent = None
    _session(dc, arr, params, dict(FLAGS, use_drf_order=True))
    for k, v in tree.items():
        setattr(arr, k, v)
    got = _session(dc, arr, params, flags)
    assert dc.last_full_ship and dc.full_ships == 2
    cold = ts.solve_allocate(arr.numpy_dict(), params, device="cpu", **flags)
    np.testing.assert_array_equal(got, cold.compact.numpy())
    arr.node_idle[0, 0] -= 1000.0
    got = _session(dc, arr, params, flags)
    assert not dc.last_full_ship and dc.last_shipped_chunks >= 1
    cold = ts.solve_allocate(arr.numpy_dict(), params, device="cpu", **flags)
    np.testing.assert_array_equal(got, cold.compact.numpy())


def test_unpack_views_round_trip():
    arr = flatten("torch", cluster_spec(2))
    fbuf, ibuf, layout = arr.packed()
    d = ts._unpack(torch.from_numpy(fbuf), torch.from_numpy(ibuf), layout)
    host = arr.numpy_dict()
    assert sorted(d) == sorted(host)
    for k, v in d.items():
        assert v.numpy().dtype == host[k].dtype, k
        np.testing.assert_array_equal(v.numpy(), host[k], err_msg=k)


# ---------------------------------------------------------------------------
# PackedDeviceCache units
# ---------------------------------------------------------------------------

def _problem(seed=6):
    arr = flatten("torch", cluster_spec(seed, n_nodes=24, n_jobs=10))
    return arr, params_dict(arr, binpack=1.0)


def test_needs_a_device_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PackedDeviceCache()
    assert PackedDeviceCache(device="cpu").device.type == "cpu"


def test_plan_kinds_accounting_and_padding():
    """update() is the one entry: a full ship, then exact dirty-chunk
    deltas (no padding: each dirty chunk costs its values and one int32
    index), none when nothing changed."""
    C = 16
    arr, _ = _problem()
    dc = PackedDeviceCache(chunk=C, device="cpu")
    fbuf, ibuf, layout = arr.packed()
    f2d, i2d = dc.update(fbuf, ibuf, layout)
    # first session: full ship
    assert dc.last_full_ship and dc.full_ships == 1
    assert f2d is dc._dev_f and i2d is dc._dev_i
    cf, ci = dc._dev_f.shape[0], dc._dev_i.shape[0]
    assert dc.last_shipped_chunks == cf + ci
    assert dc.last_shipped_bytes == dc.full_upload_bytes() \
        == (cf + ci) * C * 4
    assert dc._dev_f.device.type == "cpu"
    # the resident buffers are copies, not views of the host mirror
    assert dc._dev_f.data_ptr() != dc._host_f.ctypes.data

    # zero-dirty: the resident buffers, nothing shipped
    payload = dc.update(fbuf, ibuf, layout)
    assert dc.last_shipped_bytes == 0 and dc.last_shipped_chunks == 0
    assert payload[0] is dc._dev_f and not dc.last_full_ship

    # three dirty float chunks: exactly those three scattered in place
    f2 = fbuf.copy()
    f2[np.array([0, 2, 5]) * C] = -3.5
    g2d, _ = dc.update(f2, ibuf, layout)
    assert g2d is f2d and not dc.last_full_ship
    assert dc.last_shipped_chunks == 3
    assert dc.last_shipped_bytes == 3 * (C * 4 + 4)
    assert np.array_equal(dc._host_f[:f2.size], f2)
    assert np.array_equal(dc._dev_f.reshape(-1).numpy(), dc._host_f)
    ts.solve_allocate_packed2d(f2d, i2d, layout,
                               params_dict(arr, binpack=1.0))
    assert np.array_equal(dc._dev_f.reshape(-1).numpy(), dc._host_f)

    # seventeen dirty chunks: the same exact scatter, seventeen chunks'
    # bytes
    f3 = f2.copy()
    n_dirty = 17
    assert cf >= n_dirty
    f3[np.arange(n_dirty) * C] = -7.25  # (an inf entry ignores += 1)
    dc.update(f3, ibuf, layout)
    assert dc.last_shipped_chunks == n_dirty
    assert dc.last_shipped_bytes == n_dirty * (C * 4 + 4)
    assert np.array_equal(dc._dev_f.reshape(-1).numpy()[:f3.size], f3)
    assert dc.sessions == 4 and dc.delta_sessions == 3
    assert dc.arena_hit_rate == 0.75

    # a layout change full-ships again
    _, _, layout2 = flatten("torch", cluster_spec(
        6, n_nodes=40, n_jobs=10)).packed()
    assert layout2 != layout
    dc.update(fbuf, ibuf, layout2)
    assert dc.last_full_ship and dc.full_ships == 2


def _session(dc, arr, params, flags):
    fbuf, ibuf, layout = arr.packed()
    p = dc.params_device(params)
    f2d, i2d = dc.update(fbuf, ibuf, layout)
    return ts.solve_allocate_packed2d(f2d, i2d, layout, p,
                                      **flags).compact.numpy()


def _packed_solve(arr, params, flags):
    """A one-off packed solve: a fresh CPU arena's full ship, then the
    solve over its buffers."""
    fbuf, ibuf, layout = arr.packed()
    f2d, i2d = PackedDeviceCache(device="cpu").update(fbuf, ibuf, layout)
    return ts.solve_allocate_packed2d(f2d, i2d, layout, params, **flags)


FLAGS = dict(herd_mode="pack", score_families=("binpack", "kube"))


def test_invalidate_keeps_params_and_reships_once():
    arr, params = _problem()
    dc = PackedDeviceCache(device="cpu")
    c1 = _session(dc, arr, params, FLAGS)
    assert dc.full_ships == 1 and dc.params_repins == 1
    pinned = dc._params_dev
    dc.invalidate()
    assert dc._dev_f is None and dc._layout is None
    assert dc._params_blob is not None
    c2 = _session(dc, arr, params, FLAGS)
    assert dc.full_ships == 2 and dc.last_full_ship
    assert dc.params_repins == 1 and dc._params_dev is pinned
    c3 = _session(dc, arr, params, FLAGS)
    assert dc.full_ships == 2 and dc.last_shipped_bytes == 0
    assert np.array_equal(c1, c2) and np.array_equal(c1, c3)


def test_invalidate_repins_params_that_became_unusable():
    arr, params = _problem()
    dc = PackedDeviceCache(device="cpu")
    _session(dc, arr, params, FLAGS)
    dc._params_dev["node_static"] = torch.empty(0, device="meta")
    dc.invalidate()
    _session(dc, arr, params, FLAGS)
    assert dc.params_repins == 2
    assert dc._params_dev["node_static"].device.type == "cpu"


def test_hard_reset_drops_everything():
    arr, params = _problem()
    dc = PackedDeviceCache(device="cpu")
    _session(dc, arr, params, FLAGS)
    dc.reset()
    assert dc._params_blob is None and dc._params_dev is None
    assert dc._host_f is None and dc._dev_f is None
    _session(dc, arr, params, FLAGS)
    assert dc.full_ships == 2 and dc.params_repins == 2


def test_failure_after_scatter_recovers_through_invalidate(monkeypatch):
    """The solve fails after its in-place scatter landed: invalidate()
    must make the next session re-ship from its own snapshot, so the
    result equals a cold solve (the mirror already holds the failed
    session's chunks and cannot be diffed against)."""
    arr, params = _problem()
    dc = PackedDeviceCache(device="cpu")
    _session(dc, arr, params, FLAGS)
    arr.node_idle[3] *= 0.5
    real = ts.solve_allocate_packed2d

    def boom(*a, **k):
        raise RuntimeError("injected device failure after the scatter")

    monkeypatch.setattr(ts, "solve_allocate_packed2d", boom)
    with pytest.raises(RuntimeError, match="after the scatter"):
        _session(dc, arr, params, FLAGS)
    monkeypatch.setattr(ts, "solve_allocate_packed2d", real)
    dc.invalidate()
    arr.node_idle[5] *= 0.5
    got = _session(dc, arr, params, FLAGS)
    assert dc.last_full_ship
    cold = ts.solve_allocate(arr.numpy_dict(), params, device="cpu",
                             **FLAGS).compact.numpy()
    assert np.array_equal(got, cold)


# ---------------------------------------------------------------------------
# arena vs cold vs the JAX package, over churned sessions
# ---------------------------------------------------------------------------

def _churn(arr, rng):
    """Mutate a session's flatten in place the way a cycle would: node
    rows lose idle to new residents, some tasks leave the pending set,
    gang sizes move. Keeps the layout (shapes) fixed."""
    n_valid = int(arr.node_valid.sum())
    for i in rng.choice(n_valid, 3, replace=False):
        take = arr.node_idle[i] * np.float32(rng.uniform(0.1, 0.6))
        arr.node_idle[i] -= take
        arr.node_used[i] += take
        arr.node_npods[i] += 1
    valid_t = np.nonzero(arr.task_valid)[0]
    arr.task_valid[rng.choice(valid_t, 2, replace=False)] = False
    valid_j = np.nonzero(arr.job_valid)[0]
    for j in rng.choice(valid_j, 2, replace=False):
        arr.job_min[j] = max(1, int(arr.job_min[j]) - 1)


@pytest.mark.parametrize("flags", [
    dict(herd_mode="spread", score_families=("kube",), use_queue_cap=True,
         use_drf_order=True),
    dict(herd_mode="pack", score_families=("binpack",),
         use_queue_cap=True),
], ids=["default_conf", "binpack_conf"])
def test_delta_sessions_equal_cold_and_jax(flags):
    rng = np.random.default_rng(11)
    arr = flatten("torch", cluster_spec(7, n_nodes=20, n_jobs=10,
                                        tasks_per_job=3))
    arr.drf_total = arr.node_alloc[arr.node_valid].sum(axis=0)
    params = params_dict(arr, binpack=1.0, least=1.0, balanced=1.0)
    tdc = PackedDeviceCache(chunk=64, device="cpu")
    jdc = JPackedDeviceCache(chunk=64)
    kinds = []
    for s in range(6):
        if s:
            _churn(arr, rng)
        fbuf, ibuf, layout = arr.packed()
        got = _session(tdc, arr, params, flags)
        kinds.append(tdc.last_full_ship)
        # the solve left the resident buffers untouched: they equal the
        # host mirror chunk for chunk
        assert np.array_equal(tdc._dev_f.reshape(-1).numpy(), tdc._host_f)
        assert np.array_equal(tdc._dev_i.reshape(-1).numpy(), tdc._host_i)
        cold = ts.solve_allocate(arr.numpy_dict(), params, device="cpu",
                                 **flags)
        assert np.array_equal(got, cold.compact.numpy()), s
        with jax.disable_jit():
            jp = jdc.params_device(params)
            kind, payload = jdc.plan_delta(fbuf, ibuf, layout)
            if kind == "updated":
                jres = js.solve_allocate_packed2d(*payload, layout, jp,
                                                  **flags)
            else:
                jres, nf, ni = js.solve_allocate_delta(*payload, layout,
                                                       jp, **flags)
                jdc.commit(nf, ni)
            jc = np.asarray(jres.compact)
        assert np.array_equal(got, jc), s
        # the same chunks cross: a full ship's bytes equal the JAX
        # package's; a delta ships exactly its dirty chunks, where the
        # JAX package pads them to its fused slots
        assert tdc.last_shipped_chunks == jdc.last_shipped_chunks, s
        assert tdc.last_full_ship == jdc.last_full_ship, s
        if tdc.last_full_ship:
            assert tdc.last_shipped_bytes == jdc.last_shipped_bytes, s
        else:
            assert tdc.last_shipped_bytes == \
                tdc.last_shipped_chunks * (64 * 4 + 4), s
        assert (got >= 0).any()
    # the first session full-shipped, every churned one was a delta
    assert kinds == [True] + [False] * 5
    assert tdc.delta_sessions == jdc.delta_sessions == 5


def test_packed_entry_point_equals_cold():
    arr, params = _problem(8)
    a = _packed_solve(arr, params, FLAGS)
    b = ts.solve_allocate(arr.numpy_dict(), params, device="cpu", **FLAGS)
    for k in ("assigned", "kind", "job_ready", "compact"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k


def test_update_scatters_the_dirty_chunks_in_place():
    arr, _ = _problem()
    dc = PackedDeviceCache(chunk=16, device="cpu")
    fbuf, ibuf, layout = arr.packed()
    f2d, i2d = dc.update(fbuf, ibuf, layout)
    assert dc.last_full_ship
    f2 = fbuf.copy()
    f2[np.array([1, 4]) * 16] = -3.5
    g2d, _ = dc.update(f2, ibuf, layout)
    assert g2d is f2d and not dc.last_full_ship
    assert dc.last_shipped_chunks == 2
    assert np.array_equal(f2d.reshape(-1).numpy()[:f2.size], f2)
    assert np.array_equal(dc._host_f[:f2.size], f2)


def test_session_pipeline_overlaps_and_collects_fifo():
    """Three packed solves through the port's SessionPipeline: session 1
    dispatches before session 0 is collected (a gate holds session 0's
    collect), results come back in submit order, each equal to a cold
    solve of its snapshot."""
    import threading

    from volcano_tpu_torch.ops import SessionPipeline, start_readback

    pipe = SessionPipeline(depth=2)
    gate = threading.Event()
    colds = []

    def make(sn):
        arr = flatten("torch", cluster_spec(9 + sn % 2, n_nodes=16,
                                            n_jobs=6))
        params = params_dict(arr, binpack=1.0)
        colds.append(ts.solve_allocate(arr.numpy_dict(), params,
                                       device="cpu", **FLAGS).compact)

        def dispatch():
            return start_readback(_packed_solve(arr, params, FLAGS).compact)

        def collect(rb):
            if sn == 0:
                gate.wait(10)
            return rb.wait()[0]

        return dispatch, collect

    for sn in range(3):
        pipe.submit(sn, *make(sn))
        if sn == 1:
            gate.set()
    done = pipe.drain(timeout=60)
    pipe.close()
    assert [t.tag for t in done] == [0, 1, 2]
    assert pipe.overlap_pairs() >= 1, pipe.events
    for t, cold in zip(done, colds):
        assert torch.equal(t.result(), cold)
    with pytest.raises(ValueError):
        SessionPipeline(depth=0)


# ---------------------------------------------------------------------------
# the arena inside the Scheduler: bind identity with the cold path
# ---------------------------------------------------------------------------

def test_scheduler_arena_vs_cold_binds_identical(monkeypatch):
    """tests/test_arena.py's churn script on the port: 14 cycles of the
    port's Scheduler with the arena and the event-sourced flatten, and
    again with neither (a cold upload every cycle), including a bucket
    crossing and two readback failures that trip the breaker. Binds are
    identical cycle by cycle; full re-ships happen only at the first
    session, the crossing and after the failures; params pin once."""
    from volcano_tpu_torch.resilience import CircuitBreaker

    from torch_helpers import SeededCluster

    crossing, trips, cooldown = 6, (8, 9), 2

    def run(arena):
        c = SeededCluster("torch", 41, n_nodes=6, node_cpu=128,
                          node_mem_gi=512)
        clock = [0.0]
        c.cache.breaker = CircuitBreaker(
            "device-solver", failure_threshold=2, cooldown_s=cooldown,
            clock=lambda: clock[0])
        if not arena:
            c.cache.device_cache = None
            c.cache.flatten_cache = None
        real = ts.decode_compact
        boom = [False]

        def maybe_boom(compact):
            if boom[0]:
                boom[0] = False
                raise RuntimeError("injected device loss at readback")
            return real(compact)

        monkeypatch.setattr(ts, "decode_compact", maybe_boom)
        dc = c.cache.device_cache
        streams, full, fallback = [], [], []
        for s in range(14):
            clock[0] = float(s)
            boom[0] = s in trips
            ships = dc.full_ships if dc is not None else 0
            n, size = (6, 4) if s == crossing else (2, 2)
            c.cycle(n, churn=0.2, tasks=size)
            streams.append(sorted(c.cache.binder.binds.items()))
            if dc is not None and dc.full_ships > ships:
                full.append(s)
            if c.sched.last_cycle_timing.get("host_fallback"):
                fallback.append(s)
        monkeypatch.setattr(ts, "decode_compact", real)
        return streams, full, fallback, dc

    a_streams, full, a_fb, dc = run(arena=True)
    c_streams, _, c_fb, _ = run(arena=False)
    assert a_fb == c_fb and set(trips) <= set(a_fb)
    assert a_streams == c_streams
    probe = trips[1] + cooldown
    assert {0, crossing, crossing + 1, trips[1], probe} == set(full), full
    assert dc.params_repins == 1 and dc.invalidations == 2
    assert np.array_equal(dc._dev_f.reshape(-1).numpy(), dc._host_f)
