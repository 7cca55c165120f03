"""Resilience subsystem tests (volcano_tpu_torch/resilience + the seams it
hardens): device-path circuit breaker open/half-open/close, host-oracle
fallback parity, per-action containment (throwing AND hung actions),
last-good conf retention, the resync-safe cache handlers, and the
deterministic fault injector driving all of it: tests/test_resilience.py
through the port on the CPU (``device="cpu"``), with the reference's own
expectations. Its store-retry, watch-resume and chaos-soak classes are
twinned in tests/test_torch_netstore.py.

Where the JAX package runs the same cycles, a JAX-package Scheduler
follows the same store (``torch_helpers.JaxTwin``) with the same faults
armed in its own injector and its own breaker on the same fake clock:
each cycle's binds and breaker accounting equal the port's (exact).

Beyond the reference: an action the watchdog abandons stays out of the
device arena (the port pins the action's epoch per thread and fences the
arena; the JAX package's arrays are immutable), and on a CUDA arena a
device fault and an open breaker raise instead of degrading to the host
oracle (``cuda`` marker: these run on the card).
"""

import os
import threading
import time
import types

import pytest

from volcano_tpu_torch.cache import FakeBinder, FakeEvictor, SchedulerCache
from volcano_tpu_torch.client import ClusterStore
from volcano_tpu_torch.metrics import metrics
from volcano_tpu_torch.models import PodGroupPhase
from volcano_tpu_torch.resilience import (
    ActionContained, ActionTimeout, ActionWatchdog, CircuitBreaker,
    FaultError, FaultInjector, faults,
)
from volcano_tpu_torch.scheduler import Scheduler

from torch_helpers import Builders, JaxTwin

_B = Builders("torch")
build_node = _B.build_node
build_pod = _B.build_pod
build_pod_group = _B.build_pod_group
build_queue = _B.build_queue


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    yield
    faults.reset()


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def _build_cluster(n_nodes=4, n_jobs=3, tpj=2, device="cpu"):
    store = ClusterStore()
    cache = SchedulerCache(store, device=device)
    cache.binder = FakeBinder()
    cache.evictor = FakeEvictor()
    cache.run()
    store.apply("queues", build_queue("q0", weight=1))
    for i in range(n_nodes):
        store.create("nodes", build_node(f"n{i}",
                                         {"cpu": "16", "memory": "64Gi"}))

    def wave(k):
        pg = build_pod_group(f"j{k}", "t", min_member=tpj, queue="q0")
        pg.status.phase = PodGroupPhase.PENDING
        store.create("podgroups", pg)
        for i in range(tpj):
            store.create("pods", build_pod(
                "t", f"j{k}-{i}", "", "Pending",
                {"cpu": "1", "memory": "1Gi"}, f"j{k}"))

    for k in range(n_jobs):
        wave(k)
    return store, cache, wave


# ---------------------------------------------------------------------------
# circuit breaker state machine
# ---------------------------------------------------------------------------

class TestCircuitBreaker:
    def test_open_after_threshold_then_half_open_then_close(self):
        clock = FakeClock()
        br = CircuitBreaker("t", failure_threshold=3, cooldown_s=10.0,
                            clock=clock)
        assert br.state == "closed" and br.allow()
        br.record_failure()
        br.record_failure()
        assert br.state == "closed"  # below threshold
        br.record_failure()
        assert br.state == "open"
        assert not br.allow()  # cool-down running
        clock.t += 9.9
        assert not br.allow()
        clock.t += 0.2
        assert br.allow()  # the half-open probe
        assert br.state == "half_open"
        br.record_success()
        assert br.state == "closed"
        trace = [(frm, to) for _, frm, to in br.transitions]
        assert trace == [("closed", "open"), ("open", "half_open"),
                         ("half_open", "closed")]

    def test_failed_probe_reopens_for_a_fresh_cooldown(self):
        clock = FakeClock()
        br = CircuitBreaker("t", failure_threshold=1, cooldown_s=5.0,
                            clock=clock)
        br.record_failure()
        clock.t += 6
        assert br.allow() and br.state == "half_open"
        br.record_failure()
        assert br.state == "open"
        assert not br.allow()  # fresh cool-down, not the stale one
        clock.t += 6
        assert br.allow()

    def test_success_resets_consecutive_count(self):
        br = CircuitBreaker("t", failure_threshold=2)
        br.record_failure()
        br.record_success()
        br.record_failure()
        assert br.state == "closed"  # never 2 CONSECUTIVE failures


# ---------------------------------------------------------------------------
# fault injector
# ---------------------------------------------------------------------------

class TestFaultInjector:
    def test_counter_schedules_are_deterministic(self):
        fi = FaultInjector()
        fi.arm("p", at=(2, 4))
        hits = []
        for i in range(5):
            try:
                fi.fire("p")
                hits.append(False)
            except FaultError:
                hits.append(True)
        assert hits == [False, True, False, True, False]
        assert fi.log == [("p", 2), ("p", 4)]

    def test_every_and_times_cap(self):
        fi = FaultInjector()
        fi.arm("p", every=2, times=2)
        fired = 0
        for _ in range(10):
            try:
                fi.fire("p")
            except FaultError:
                fired += 1
        assert fired == 2

    def test_arm_once_fires_on_next_call_only(self):
        fi = FaultInjector()
        fi.fire("p")  # disarmed: free
        fi.arm_once("p")
        with pytest.raises(FaultError):
            fi.fire("p")
        fi.fire("p")  # spent

    def test_seeded_probability_replays(self):
        def run():
            fi = FaultInjector(seed=7)
            fi.arm("p", p=0.5)
            out = []
            for _ in range(20):
                try:
                    fi.fire("p")
                    out.append(0)
                except FaultError:
                    out.append(1)
            return out
        assert run() == run()
        assert 1 in run()

    def test_env_spec_parses(self):
        fi = FaultInjector(env="a=at:1-2;b=every:3,times:1;c=delay:0.5,exc:none")
        with pytest.raises(FaultError):
            fi.fire("a")
        assert fi._points["b"].every == 3
        assert fi._points["c"].exc is None
        assert fi._points["c"].delay == 0.5

    def test_injected_faults_are_connection_errors(self):
        # the store/watch retry paths must treat simulated drops like
        # real ones
        assert issubclass(FaultError, ConnectionError)


# ---------------------------------------------------------------------------
# conf hot-reload: last-good retention
# ---------------------------------------------------------------------------

GOOD_CONF = ('actions: "enqueue, allocate"\n'
             'tiers:\n- plugins:\n  - name: gang\n')


class TestConfLastGood:
    def _touch(self, path, bump):
        os.utime(path, (time.time() + bump, time.time() + bump))

    def test_bad_reload_keeps_last_good_and_counts_once(self, tmp_path,
                                                        caplog):
        conf_file = tmp_path / "scheduler.yaml"
        conf_file.write_text(GOOD_CONF)
        store, cache, wave = _build_cluster()
        sched = Scheduler(cache, conf_path=str(conf_file))
        assert [a.name() for a in sched.actions] == ["enqueue", "allocate"]

        before = metrics.conf_load_errors.get()
        conf_file.write_text("actions: [\ntiers: broken")  # invalid YAML
        self._touch(conf_file, 2)
        with caplog.at_level("ERROR"):
            sched.load_conf()
            sched.load_conf()  # same bad text: no second log/count
        assert [a.name() for a in sched.actions] == ["enqueue", "allocate"]
        assert metrics.conf_load_errors.get() == before + 1
        assert sum("keeping the last good conf" in r.message
                   for r in caplog.records) == 1

        # the scheduler keeps SCHEDULING on the last good conf
        sched.run_once()
        assert len(cache.binder.binds) == 6

        # an unknown action is a reload error too, not a crash
        conf_file.write_text('actions: "nosuch"\n')
        self._touch(conf_file, 4)
        sched.load_conf()
        assert [a.name() for a in sched.actions] == ["enqueue", "allocate"]
        assert metrics.conf_load_errors.get() == before + 2

        # a fixed file is picked up again
        conf_file.write_text('actions: "allocate, backfill"\n'
                             'tiers:\n- plugins:\n  - name: gang\n')
        self._touch(conf_file, 6)
        sched.load_conf()
        assert [a.name() for a in sched.actions] == ["allocate", "backfill"]

    def test_first_load_still_raises(self):
        store, cache, _ = _build_cluster()
        with pytest.raises(Exception):
            Scheduler(cache, scheduler_conf='actions: "nosuch"\n')


# ---------------------------------------------------------------------------
# per-action containment (throwing + hung)
# ---------------------------------------------------------------------------

from volcano_tpu_torch.framework import Action, register_action  # noqa: E402


class _ExplodingAction(Action):
    """Allocates one task through a statement, then blows up."""

    def name(self):
        return "test_explode"

    def execute(self, ssn):
        job = next(iter(ssn.jobs.values()))
        from volcano_tpu_torch.api import TaskStatus
        task = next(iter(job.task_status_index[TaskStatus.PENDING].values()))
        stmt = ssn.statement()
        stmt.allocate(task, next(iter(ssn.nodes)))
        raise RuntimeError("boom mid-statement")


class _RecordingAction(Action):
    ran = []

    def name(self):
        return "test_record"

    def execute(self, ssn):
        self.ran.append(ssn.uid)


class _HangingAction(Action):
    def name(self):
        return "test_hang"

    def execute(self, ssn):
        faults.fire("slow_action")  # armed with delay => simulated hang


register_action(_ExplodingAction())
register_action(_RecordingAction())
register_action(_HangingAction())

CONTAIN_CONF = ('actions: "test_explode, enqueue, allocate, test_record"\n'
                'tiers:\n- plugins:\n  - name: gang\n'
                '  - name: predicates\n  - name: nodeorder\n')


class TestActionContainment:
    def test_throwing_action_is_contained_and_rolled_back(self):
        store, cache, wave = _build_cluster(n_jobs=2)
        sched = Scheduler(cache, scheduler_conf=CONTAIN_CONF)
        _RecordingAction.ran.clear()
        before = metrics.action_failures_total.get(
            labels={"action": "test_explode"})
        sched.run_once()  # must NOT raise
        # the exploding action's half-done statement was discarded...
        # (its ALLOCATED task went back to PENDING, so allocate placed it)
        assert len(cache.binder.binds) == 4
        # ...and the remaining actions of the cycle still ran
        assert len(_RecordingAction.ran) == 1
        assert sched.last_cycle_timing.get("test_explode_error") == 1.0
        assert metrics.action_failures_total.get(
            labels={"action": "test_explode"}) == before + 1

    def test_hung_action_times_out_statements_discard_cycle_continues(self):
        store, cache, wave = _build_cluster(n_jobs=2)
        conf = ('actions: "test_hang, enqueue, allocate, test_record"\n'
                'tiers:\n- plugins:\n  - name: gang\n'
                '  - name: predicates\n  - name: nodeorder\n')
        sched = Scheduler(cache, scheduler_conf=conf,
                          action_deadline_s=0.4)
        _RecordingAction.ran.clear()
        faults.arm("slow_action", at=(1,), delay=2.0, exc=None)
        before = metrics.action_timeouts_total.get(
            labels={"action": "test_hang"})
        t0 = time.perf_counter()
        sched.run_once()
        dt = time.perf_counter() - t0
        assert dt < 1.9, "the hung action blocked the whole cycle"
        assert sched.last_cycle_timing.get("test_hang_timeout") == 1.0
        assert metrics.action_timeouts_total.get(
            labels={"action": "test_hang"}) == before + 1
        # the cycle went on without the hung action
        assert len(cache.binder.binds) == 4
        assert len(_RecordingAction.ran) == 1

    def test_zombie_commit_after_containment_is_discarded(self):
        """A timed-out action's thread waking up later must not push its
        statement through commit (the epoch fence in Statement.commit)."""
        store, cache, wave = _build_cluster(n_jobs=1)
        sched = Scheduler(cache)
        from volcano_tpu_torch.framework import open_session
        ssn = open_session(cache, sched.tiers, sched.configurations)
        ssn._action_epoch = 1
        stmt = ssn.statement()
        from volcano_tpu_torch.api import TaskStatus
        job = next(iter(ssn.jobs.values()))
        task = next(iter(job.task_status_index[TaskStatus.PENDING].values()))
        stmt.allocate(task, "n0")
        # the scheduler contains epoch 1 (deadline breach)
        ssn._contained_epochs.add(1)
        ssn.discard_open_statements()
        stmt.allocate(task, "n0")  # zombie keeps going
        stmt.commit()              # ...and commits late
        assert cache.binder.binds == {}  # fence turned it into a discard
        assert task.status == TaskStatus.PENDING

    def test_watchdog_raises_action_timeout(self):
        wd = ActionWatchdog(0.1, dump=False)
        with pytest.raises(ActionTimeout):
            wd.run("sleepy", lambda: time.sleep(1.0))
        # and relays the action's own exception
        with pytest.raises(ValueError):
            wd.run("thrower", lambda: (_ for _ in ()).throw(ValueError("x")))


# ---------------------------------------------------------------------------
# device-path breaker through the allocate action
# ---------------------------------------------------------------------------

class TestBreakerFallback:
    def test_open_half_open_close_through_scheduler_cycles(self):
        from volcano_tpu.resilience import CircuitBreaker as JBreaker
        from volcano_tpu.resilience import faults as j_faults

        store, cache, wave = _build_cluster(n_jobs=2)
        clock = FakeClock()
        cache.breaker = CircuitBreaker(
            "device-solver", failure_threshold=2, cooldown_s=10.0,
            clock=clock)
        sched = Scheduler(cache)
        # the JAX package on the same store, faults and clock
        twin = JaxTwin(store)
        twin.cache.breaker = JBreaker(
            "device-solver", failure_threshold=2, cooldown_s=10.0,
            clock=clock)
        faults.arm("solver_dispatch", at=(1, 2))
        j_faults.reset()
        j_faults.arm("solver_dispatch", at=(1, 2))

        port_cycle = types.SimpleNamespace(run_once=sched.run_once)

        def run_once():
            jt = twin.cycle(port_cycle)
            t = sched.last_cycle_timing
            keys = ("host_fallback", "breaker_open", "breaker_state")
            assert [t.get(k) for k in keys] == [jt.get(k) for k in keys]
            assert cache.binder.binds == twin.cache.binder.binds
            assert cache.breaker.state == twin.cache.breaker.state

        sched.run_once = run_once
        try:
            self._ladder(sched, cache, wave, clock)
        finally:
            j_faults.reset()

    def _ladder(self, sched, cache, wave, clock):
        sched.run_once()  # injected failure 1: host fallback, still closed
        assert sched.last_cycle_timing.get("host_fallback") == 1.0
        assert len(cache.binder.binds) == 4  # host oracle placed everything
        assert cache.breaker.state == "closed"

        wave(2)
        sched.run_once()  # injected failure 2: breaker opens
        assert cache.breaker.state == "open"
        assert len(cache.binder.binds) == 6

        wave(3)
        sched.run_once()  # open: no dispatch attempted, straight to host
        assert sched.last_cycle_timing.get("breaker_open") == 1.0
        assert sched.last_cycle_timing.get("breaker_state") == 2.0
        assert cache.breaker.fallback_cycles >= 1
        assert len(cache.binder.binds) == 8
        assert faults.fired("solver_dispatch") == 2  # nothing consumed

        clock.t += 11  # cool-down elapses
        wave(4)
        sched.run_once()  # half-open probe succeeds -> closed
        assert cache.breaker.state == "closed"
        assert "host_fallback" not in sched.last_cycle_timing
        assert len(cache.binder.binds) == 10
        trace = [(frm, to) for _, frm, to in cache.breaker.transitions]
        assert trace == [("closed", "open"), ("open", "half_open"),
                         ("half_open", "closed")]

    def test_garbage_readback_counts_as_device_failure(self, monkeypatch):
        """Out-of-range solver output (a sick device returning nonsense
        without raising) routes through the same containment."""
        store, cache, wave = _build_cluster(n_jobs=2)
        sched = Scheduler(cache)
        import volcano_tpu_torch.ops.solver as solver_mod
        import numpy as np

        def garbage(compact):
            n = np.asarray(compact).shape[0]
            return (np.full(n, 10 ** 6, np.int32), np.zeros(n, np.int32))

        monkeypatch.setattr(solver_mod, "decode_compact", garbage)
        sched.run_once()
        assert sched.last_cycle_timing.get("host_fallback") == 1.0
        assert len(cache.binder.binds) == 4
        # one recorded failure on the breaker
        assert cache.breaker._consecutive_failures == 1


class TestDegradedParity:
    def test_fallback_cycle_binds_match_pure_host_cycle(self):
        """The degradation ladder's first rung must be semantics-free:
        a device-fault cycle that fell back to the host oracle produces
        bind-for-bind the decisions of a cycle configured host-only."""
        host_conf = (
            'actions: "enqueue, allocate, backfill"\n'
            'tiers:\n'
            '- plugins:\n  - name: priority\n  - name: gang\n'
            '- plugins:\n  - name: drf\n  - name: predicates\n'
            '  - name: proportion\n  - name: nodeorder\n'
            'configurations:\n'
            '- name: allocate\n  arguments: {mode: host}\n')

        from volcano_tpu.resilience import faults as j_faults

        def run(conf, inject):
            faults.reset()
            j_faults.reset()
            store, cache, wave = _build_cluster(n_jobs=4)
            sched = Scheduler(cache, scheduler_conf=conf)
            twin = JaxTwin(store, scheduler_conf=conf)
            if inject:
                faults.arm_once("solver_dispatch")
                j_faults.arm_once("solver_dispatch")
            try:
                jt = twin.cycle(sched)
            finally:
                j_faults.reset()
            if inject:
                assert sched.last_cycle_timing.get("host_fallback") == 1.0
                assert jt.get("host_fallback") == 1.0
            # the JAX package degrades to the same binds
            assert cache.binder.binds == twin.cache.binder.binds
            return sorted(cache.binder.binds.items())

        degraded = run(None, inject=True)
        pure_host = run(host_conf, inject=False)
        assert degraded == pure_host


class TestResyncSafeHandlers:
    def test_replayed_add_of_known_pod_does_not_double_count(self):
        from volcano_tpu_torch.client.codec import decode, encode

        store, cache, wave = _build_cluster(n_jobs=0)
        pod = build_pod("t", "p0", "n0", "Running",
                        {"cpu": "4", "memory": "4Gi"}, "pg0")
        store.create("podgroups", build_pod_group("pg0", "t", min_member=1))
        store.create("pods", pod)
        idle_after_add = cache.nodes["n0"].idle.clone()
        assert len(cache.nodes["n0"].tasks) == 1
        # a resume/re-list replays the add as a decoded copy: accounting
        # must stay single-counted, not raise, not double-subtract
        cache._on_pod("add", decode(encode(pod)), None)
        assert len(cache.nodes["n0"].tasks) == 1
        assert cache.nodes["n0"].idle == idle_after_add
        job = cache.jobs["t/pg0"]
        assert len(job.tasks) == 1




# ---------------------------------------------------------------------------
# an abandoned action and the device arena (the port's repair)
# ---------------------------------------------------------------------------

def _arena_matches_mirror(dc) -> bool:
    import torch
    return all(torch.equal(d.reshape(-1).cpu(), torch.from_numpy(h))
               for d, h in ((dc._dev_f, dc._host_f),
                            (dc._dev_i, dc._host_i)))


class TestAbandonedActionFence:
    """The watchdog abandons a hung action's thread, which may wake after
    the scheduler moved on. In the JAX package that thread can only reach
    immutable arrays; in the port the arena's buffers are written in
    place, so a late thread must never scatter into them while (or after)
    a later cycle updates them."""

    DELAY, DEADLINE = 1.0, 0.3

    def _primed(self):
        store, cache, wave = _build_cluster(n_jobs=3)
        sched = Scheduler(cache, action_deadline_s=self.DEADLINE)
        sched.run_once()
        assert len(cache.binder.binds) == 6
        dc = cache.device_cache
        assert dc.sessions == 1
        return cache, wave, sched, dc

    def _settle(self, cache, sched, dc, sessions):
        # the next cycle binds the wave the abandoned one left pending,
        # then the late thread wakes and finds its epoch contained
        sched.run_once()
        assert len(cache.binder.binds) == 8
        assert dc.sessions == sessions + 1
        time.sleep(self.DELAY + 0.5)
        assert dc.sessions == sessions + 1  # the late thread stayed out
        assert len(cache.binder.binds) == 8
        assert _arena_matches_mirror(dc)

    def test_action_abandoned_before_it_starts_never_runs(self):
        cache, wave, sched, dc = self._primed()
        wave(3)
        # enqueue is call 1 of the cycle, allocate call 2
        faults.arm("slow_action", at=(2,), delay=self.DELAY, exc=None)
        sched.run_once()
        assert sched.last_cycle_timing.get("allocate_timeout") == 1.0
        self._settle(cache, sched, dc, sessions=1)

    def test_action_abandoned_mid_dispatch_stops_at_the_arena(self):
        cache, wave, sched, dc = self._primed()
        wave(3)
        # the dispatch sleeps past the deadline before the arena update
        faults.arm("solver_dispatch", at=(1,), delay=self.DELAY, exc=None)
        sched.run_once()
        t = sched.last_cycle_timing
        assert t.get("allocate_timeout") == 1.0
        assert "allocate_error" not in t
        self._settle(cache, sched, dc, sessions=1)
        # the late thread's stop is no device fault
        assert cache.breaker.state == "closed"
        assert dc.invalidations == 0

    def test_fence_holds_the_next_session_until_a_thread_leaves(self):
        from volcano_tpu_torch.ops.device_cache import PackedDeviceCache

        class Ssn:
            def __init__(self, contained):
                self.contained = contained

            def action_contained(self):
                return self.contained

        dc = PackedDeviceCache(device="cpu")
        inside, release = threading.Event(), threading.Event()
        order = []

        def first():
            with dc.fenced(Ssn(False)):
                inside.set()
                release.wait(5)
                order.append("first")

        def second():
            with dc.fenced(Ssn(False)):
                order.append("second")

        a = threading.Thread(target=first)
        a.start()
        assert inside.wait(5)
        b = threading.Thread(target=second)
        b.start()
        b.join(0.2)
        assert b.is_alive() and order == []  # held at the fence
        release.set()
        a.join(5)
        b.join(5)
        assert not a.is_alive() and not b.is_alive()
        assert order == ["first", "second"]
        with pytest.raises(ActionContained):
            with dc.fenced(Ssn(True)):
                pass  # pragma: no cover


# ---------------------------------------------------------------------------
# on the card: a CUDA arena raises where a CPU arena degrades
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_arena_fault_ladder_raises_then_recovers():
    """solver_dispatch armed twice on a CUDA arena, the breaker at a
    threshold of 2: each faulted cycle records allocate_error (no host
    fallback) and invalidates the arena, the open breaker's cycle raises
    "circuit-broken", and the half-open probe closes it and binds every
    pending gang with a full re-ship."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    store, cache, wave = _build_cluster(n_jobs=2, device="cuda")
    clock = FakeClock()
    cache.breaker = CircuitBreaker("device-solver", failure_threshold=2,
                                   cooldown_s=10.0, clock=clock)
    sched = Scheduler(cache)
    faults.arm("solver_dispatch", at=(1, 2))
    for n in (1, 2):
        sched.run_once()
        t = sched.last_cycle_timing
        assert t.get("allocate_error") == 1.0 and "host_fallback" not in t
        assert cache.device_cache.invalidations == n
        assert cache.binder.binds == {}
    assert cache.breaker.state == "open"
    wave(2)
    sched.run_once()
    t = sched.last_cycle_timing
    assert t.get("allocate_error") == 1.0 and "host_fallback" not in t
    assert faults.fired("solver_dispatch") == 2
    clock.t += 11
    sched.run_once()
    t = sched.last_cycle_timing
    assert "allocate_error" not in t and "host_fallback" not in t
    assert t.get("arena_full_ship") == 1.0
    assert cache.breaker.state == "closed"
    assert len(cache.binder.binds) == 6


@pytest.mark.cuda
def test_cuda_arena_abandoned_dispatch_stays_out():
    """The mid-dispatch case of TestAbandonedActionFence on a CUDA arena:
    the late thread never scatters, and the arena equals its mirror."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    store, cache, wave = _build_cluster(n_jobs=3, device="cuda")
    sched = Scheduler(cache, action_deadline_s=5.0)
    sched.run_once()  # the kernel library's first load fits the deadline
    sched._watchdog.deadline_s = 0.3
    dc = cache.device_cache
    wave(3)
    faults.arm("solver_dispatch", at=(1,), delay=1.0, exc=None)
    sched.run_once()
    assert sched.last_cycle_timing.get("allocate_timeout") == 1.0
    sched.run_once()
    assert len(cache.binder.binds) == 8
    time.sleep(1.5)
    assert dc.sessions == 2
    assert _arena_matches_mirror(dc)
