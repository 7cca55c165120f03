"""The port's event-sourced flatten (FlattenCache.enable_events /
feed_event / _flatten_event) and event-sourced ordering (ops.ordering.
OrderCache) against the JAX package's on the same event stream.

Two rigs, one per package, each its own ClusterStore + SchedulerCache +
Scheduler fed the same store mutations; after every cycle the two must
agree on the flatten's assembly path (mode, rows patched, events
applied, fallback reason), the ordering pass (mode, entries patched,
fallback reason, the collected job/task order) and the packed buffers,
bit for bit. The chaos seams (``flatten_event``, ``flatten_event_dup``,
``order_event``, ``order_event_dup``) are armed in each package's own
fault injector and must degrade both the same way, mirroring
tests/test_flatten_events.py and tests/test_order_events.py. The JAX
Scheduler runs op by op (``jax.disable_jit``) as elsewhere in the port's
tests; most waves here are an unschedulable backlog, so cycles stay
cheap.
"""

from __future__ import annotations

import numpy as np
import pytest

pytest.importorskip("jax")  # the JAX reference: absent on the card's machine

import jax

from torch_helpers import (
    build_node, build_pod, build_pod_group, build_queue, pkg_mod,
)

TIMING_KEYS = ("flatten_mode", "flatten_rows_patched",
               "flatten_events_applied", "flatten_fallback_reason",
               "order_mode", "order_entries_patched",
               "order_fallback_reason", "host_fallback")


class Rig:
    """One package's store + cache + scheduler, with a spy on the
    allocate action's collected order."""

    def __init__(self, pkg: str, n_nodes: int = 12, node_cpu: str = "8"):
        self.pkg = pkg
        self.models = pkg_mod(pkg, "models")
        self.ann = pkg_mod(pkg, "api").POD_GROUP_ANNOTATION
        self.faults = pkg_mod(pkg, "resilience.faultinject").faults
        cache_mod = pkg_mod(pkg, "cache")
        self.store = pkg_mod(pkg, "client").ClusterStore()
        kw = {"device": "cpu"} if pkg == "torch" else {}
        self.cache = cache_mod.SchedulerCache(self.store, **kw)
        self.cache.binder = cache_mod.FakeBinder()
        self.cache.evictor = cache_mod.FakeEvictor()
        self.cache.run()
        for i in range(2):
            self.store.apply("queues",
                             build_queue(self.models, f"q{i}", i + 1))
        for i in range(n_nodes):
            self.store.create("nodes", build_node(
                self.models, f"n{i}", {"cpu": node_cpu, "memory": "32Gi"}))
        self.sched = pkg_mod(pkg, "scheduler").Scheduler(self.cache)
        self.orders = []
        action_cls = pkg_mod(pkg, "actions.allocate").AllocateAction
        action = self.sched.actions[[a.name() for a in
                                     self.sched.actions].index("allocate")]
        orig = action_cls._collect
        rig = self

        def spy(ssn):
            res = orig(action, ssn)
            rig.orders.append([(job.uid, [t.name for t in tasks])
                               for job, tasks in res])
            return res

        action._collect = spy   # instance attribute, dropped after
        # each test by _unspy_allocate

    def wave(self, k, cpu="20", members=2):
        """members pods of cpu each; cpu > node capacity => a stable
        unschedulable backlog (pending every cycle, no store churn)."""
        m = self.models
        self.store.create("podgroups", build_pod_group(
            m, f"j{k}", "b", members, f"q{k % 2}"))
        for i in range(members):
            self.store.create("pods", build_pod(
                m, self.ann, "b", f"j{k}-{i}", "", "Pending",
                {"cpu": cpu, "memory": "1Gi"}, f"j{k}"))

    def run(self):
        if self.pkg == "jax":
            with jax.disable_jit():
                self.sched.run_once()
        else:
            self.sched.run_once()
        t = self.sched.last_cycle_timing
        evn = self.cache.flatten_cache._evn
        packed = evn["arr"].packed() if evn else None
        return {k: t.get(k) for k in TIMING_KEYS}, packed


@pytest.fixture(autouse=True)
def _unspy_allocate():
    """Rig spies on each package's allocate action, a process-wide
    singleton; drop the spies so later tests (which may patch the class)
    see the plain action."""
    yield
    for pkg in ("jax", "torch"):
        pkg_mod(pkg, "framework").get_action("allocate") \
            .__dict__.pop("_collect", None)


def _pair(**kw):
    return Rig("jax", **kw), Rig("torch", **kw)


def _both(rigs, fn):
    for r in rigs:
        fn(r)


def _cycle_agree(rigs):
    (tj, pj), (tt, pt) = rigs[0].run(), rigs[1].run()
    assert tt == tj
    assert rigs[1].orders[-1:] == rigs[0].orders[-1:]
    assert (pj is None) == (pt is None)
    if pj is not None:
        assert pt[2] == pj[2]
        assert pt[0].tobytes() == pj[0].tobytes()
        assert pt[1].tobytes() == pj[1].tobytes()
    assert sorted(rigs[1].cache.binder.binds.items()) == \
        sorted(rigs[0].cache.binder.binds.items())
    return tt


def test_event_stream_parity_across_the_ladder():
    rigs = _pair()
    for k in range(4):
        _both(rigs, lambda r, k=k: r.wave(k))
    t = _cycle_agree(rigs)
    assert t["flatten_mode"] == "cold" and t["order_mode"] == "full"
    # condition writes from cycle 0 arrive as deltas: patched in place
    t = _cycle_agree(rigs)
    assert t["flatten_mode"] == "event" and t["order_mode"] == "event"
    # nothing changed: zero rows, the previous walk reused
    t = _cycle_agree(rigs)
    assert t["flatten_rows_patched"] == 0.0 and t["order_mode"] == "reuse"
    # a running pod joins j0 on n3: the job's block changes length, so
    # the flatten re-diffs; the ordering patches the one job
    _both(rigs, lambda r: r.store.create("pods", build_pod(
        r.models, r.ann, "b", "ghost", "n3", "Running",
        {"cpu": "4", "memory": "1Gi"}, "j0")))
    t = _cycle_agree(rigs)
    assert t["flatten_fallback_reason"] == "job_layout"
    assert t["order_mode"] == "event" and t["order_entries_patched"] == 1
    # a node respec (labels) and a gang-size flip: rows patched in place

    def respec(r):
        n = r.store.get("nodes", "n2")
        n.labels = {"zone": "b"}
        r.store.update("nodes", n)
        pg = r.store.get("podgroups", "j1", "b")
        pg.spec.min_member = 1
        r.store.update("podgroups", pg)

    _both(rigs, respec)
    t = _cycle_agree(rigs)
    assert t["flatten_mode"] == "event" and t["flatten_rows_patched"] > 0
    # a schedulable wave: pending membership moves, the flatten re-diffs,
    # the ordering stays on its event path, and the wave binds
    _both(rigs, lambda r: r.wave(10, cpu="1"))
    t = _cycle_agree(rigs)
    assert t["flatten_mode"] in ("incremental", "cold")
    assert t["flatten_fallback_reason"]
    assert t["order_mode"] == "event"
    assert len(rigs[1].cache.binder.binds) == 2
    # a node joins: the padded node axis relays out
    _both(rigs, lambda r: r.store.create("nodes", build_node(
        r.models, "n99", {"cpu": "8", "memory": "32Gi"})))
    t = _cycle_agree(rigs)
    assert t["flatten_fallback_reason"] == "node_relayout"
    assert t["order_fallback_reason"] == "key_context"
    t = _cycle_agree(rigs)
    assert t["flatten_mode"] == "event" and t["order_mode"] == "reuse"


@pytest.mark.parametrize("point,reason_key", [
    ("flatten_event", "flatten_fallback_reason"),
    ("flatten_event_dup", "flatten_fallback_reason"),
    ("order_event", "order_fallback_reason"),
    ("order_event_dup", "order_fallback_reason"),
])
def test_fault_seams_degrade_alike(point, reason_key):
    rigs = _pair()
    for k in range(3):
        _both(rigs, lambda r, k=k: r.wave(k))
    _cycle_agree(rigs)
    _cycle_agree(rigs)
    try:
        for r in rigs:
            r.faults.arm_once(point)
            r.store.create("pods", build_pod(
                r.models, r.ann, "b", "ghost", "", "Pending",
                {"cpu": "20", "memory": "1Gi"}, "j0"))
            assert r.faults.fired(point) == 1
        t = _cycle_agree(rigs)
        assert t[reason_key] == "epoch_mismatch"
        # the fallback saw the delta the ledger missed: j0 has 3 pending
        assert [len(names) for uid, names in rigs[1].orders[-1]
                if uid == "b/j0"] == [3]
        t = _cycle_agree(rigs)
        assert t["flatten_mode"] == "event"
        assert t["order_mode"] in ("event", "reuse")
    finally:
        for r in rigs:
            r.faults.reset()


def test_fallback_buffers_equal_a_cold_flatten():
    """After a dropped delta the port's re-diff is bit-identical to a
    from-scratch flatten of the same snapshot (task and node columns)."""
    ops = pkg_mod("torch", "ops")
    r = Rig("torch")
    for k in range(4):
        r.wave(k)
    r.run()
    r.run()
    try:
        r.faults.arm_once("flatten_event")
        r.store.create("pods", build_pod(
            r.models, r.ann, "b", "ghost", "n3", "Running",
            {"cpu": "4", "memory": "1Gi"}, "j0"))
        t, (wf, wi, wl) = r.run()
    finally:
        r.faults.reset()
    assert t["flatten_fallback_reason"] == "epoch_mismatch"
    fc = r.cache.flatten_cache
    arr = fc._evn["arr"]
    sn = r.cache.snapshot()
    cold = ops.flatten_snapshot(
        {j.uid: j for j in arr.jobs_list},
        {ni.name: ni for ni in arr.nodes_list},
        list(arr.tasks_list), cache=ops.FlattenCache(fc.vocab),
        queues=sn.queues)
    cf, ci, cl = cold.packed()
    assert wl == cl and wi.tobytes() == ci.tobytes()
    for k in ("task_init_req", "task_req", "node_idle", "node_used",
              "node_extra_future", "node_alloc"):
        assert np.array_equal(getattr(arr, k), getattr(cold, k)), k


def test_watch_hooks_feed_both_ledgers():
    r = Rig("torch")
    fc, oc = r.cache.flatten_cache, r.cache.order_cache
    assert fc.events_enabled
    f0, o0 = fc._ev_feed, oc._feed
    r.wave(0)
    assert fc._ev_feed > f0 and oc._feed > o0
    assert "b/j0" in fc._ev_dirty_jobs and "b/j0" in oc._dirty_jobs


def test_quiet_cluster_does_zero_flatten_work():
    metrics = pkg_mod("torch", "metrics.metrics")
    r = Rig("torch")
    for k in range(5):
        r.wave(k)
    for _ in range(3):
        r.run()
    fc = r.cache.flatten_cache
    prior = fc._evn["arr"]
    idle = fc._node_buf["idle"].copy()
    patched = metrics.flatten_rows_patched_total.get()
    rv = r.store._rv
    for _ in range(3):
        t, _ = r.run()
        assert t["flatten_mode"] == "event"
        assert t["flatten_rows_patched"] == 0.0
        assert t["flatten_events_applied"] == 0.0
        assert t["order_mode"] == "reuse"
    assert metrics.flatten_rows_patched_total.get() == patched
    assert fc._evn["arr"] is prior
    assert np.array_equal(fc._node_buf["idle"], idle)
    assert r.store._rv == rv   # no store writes at all
    expo = metrics.registry.expose()
    for name in ("volcano_flatten_cycles_total", "volcano_order_cycles_total",
                 "volcano_arena_bytes_shipped"):
        assert name in expo, name
