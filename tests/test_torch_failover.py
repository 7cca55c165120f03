"""The port's crash-safe failover (volcano_tpu_torch.utils.leader_election,
resilience.recovery, Scheduler.shadow_cycle / run_with_leader_election)
and its transient retry (resilience.transient) against the JAX package's,
on the CPU.

- The in-process scenarios of tests/test_failover.py (lease fencing at
  the store, the bind-intent journal, the two failover smokes, the shadow
  cycle, the standby loop, the elector's edge cases) and of
  tests/test_ha_observability.py (TestLeaderElection, TestSchedulerHA,
  TestAssertUtil):
  each scenario runs once through each package on a store of its own
  models, and what it observes (writes fenced or not, sweeps, reconcile
  summaries, binds, leadership logs) must be the same. The failover
  smokes run HOST_CONF (allocate in host mode) and a FakeClock, so they
  add no sleeps and no JAX compiles; the shadow cycle's JAX side runs op
  by op (``jax.disable_jit``).
- ``is_transient`` answers False for CUDA errors, the one that reads as a
  timeout included, where the JAX classifier would retry them.
- ``retry_transient`` around the port's sharded dispatch on a CPU mesh:
  one transient fault is re-sent and the cycle binds as an unfaulted
  twin; a second raises into the host fallback with the arena
  invalidated; a CUDA error is never re-sent. The arena's ``update()``
  runs once per cycle in every case.

Tolerance: exact (binds, counts, summaries). No test here needs a card.
"""

from __future__ import annotations

import copy
import threading
import time

import pytest
import torch

from torch_helpers import (
    SeededCluster, build_node, build_pod, build_pod_group, build_queue,
    pkg_mod,
)

PKGS = ("jax", "torch")

HOST_CONF = ('actions: "enqueue, allocate"\n'
             'tiers:\n- plugins:\n  - name: gang\n'
             '  - name: predicates\n  - name: nodeorder\n'
             'configurations:\n- name: allocate\n'
             '  arguments: {mode: host}\n')


@pytest.fixture(autouse=True)
def _clean_faults():
    for pkg in PKGS:
        pkg_mod(pkg, "resilience").faults.reset()
    yield
    for pkg in PKGS:
        pkg_mod(pkg, "resilience").faults.reset()


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


class Pkg:
    """One package's modules, by the names the scenarios use."""

    def __init__(self, pkg):
        self.pkg = pkg
        self.m = pkg_mod(pkg, "models")
        self.ann = pkg_mod(pkg, "api").POD_GROUP_ANNOTATION
        client = pkg_mod(pkg, "client")
        self.ClusterStore = client.ClusterStore
        self.FencedError = client.FencedError
        self.FencedStore = client.FencedStore
        self.ConflictError = client.ConflictError
        le = pkg_mod(pkg, "utils.leader_election")
        self.LeaderElector, self.LeaseLock = le.LeaderElector, le.LeaseLock
        res = pkg_mod(pkg, "resilience")
        self.faults = res.faults
        self.BindIntentJournal = res.BindIntentJournal
        self.reconcile_bind_intents = res.reconcile_bind_intents
        self.recovery = pkg_mod(pkg, "resilience.recovery")
        self.metrics = pkg_mod(pkg, "metrics").metrics
        self.cache_mod = pkg_mod(pkg, "cache")
        self.Scheduler = pkg_mod(pkg, "scheduler").Scheduler

    def cache(self, store):
        kw = {"device": "cpu"} if self.pkg == "torch" else {}
        return self.cache_mod.SchedulerCache(store, **kw)

    def pod(self, ns, name, group="pg", node="", phase="Pending"):
        return build_pod(self.m, self.ann, ns, name, node, phase,
                         {"cpu": "1"}, group)

    def build_cluster(self, store=None, n_nodes=4, n_jobs=2, tpj=2):
        """tests/test_failover.py's _build_cluster."""
        m = self.m
        store = store if store is not None else self.ClusterStore()
        store.apply("queues", build_queue(m, "q0", weight=1))
        for i in range(n_nodes):
            store.create("nodes", build_node(m, f"n{i}", {
                "cpu": "16", "memory": "64Gi"}))
        for k in range(n_jobs):
            store.create("podgroups", build_pod_group(m, f"j{k}", "t", tpj,
                                                      "q0"))
            for i in range(tpj):
                store.create("pods", build_pod(
                    m, self.ann, "t", f"j{k}-{i}", "", "Pending",
                    {"cpu": "1", "memory": "1Gi"}, f"j{k}"))
        return store

    def elector(self, store, identity, clock, **kw):
        return self.LeaderElector(self.LeaseLock(store, "volcano"),
                                  identity=identity, clock=clock, **kw)


def _binds(store):
    return {p.name: p.node_name for p in store.list("pods", namespace="t")}


def _op_by_op(pkg, fn):
    if pkg == "torch":
        return fn()
    import jax
    with jax.disable_jit():
        return fn()


# ---------------------------------------------------------------------------
# lease fencing at the store
# ---------------------------------------------------------------------------

def _leased_store(p):
    clock = FakeClock()
    store = p.ClusterStore()
    store.clock = clock
    ea = p.elector(store, "A", clock, lease_duration=10.0)
    assert ea.step()
    return store, ea, clock


def _fenced(p, fn) -> bool:
    try:
        fn()
    except p.FencedError:
        return True
    return False


def fencing_valid_token_writes_stale_holder_fenced(p):
    store, ea, clock = _leased_store(p)
    store.create("pods", p.pod("d", "p"))
    pod = store.get("pods", "p", "d")
    out = [_fenced(p, lambda: store.update("pods", pod,
                                           fencing=ea.fencing_token()))]
    clock.t += 11   # B takes the lease after expiry: A's token goes stale
    eb = p.elector(store, "B", clock, lease_duration=10.0)
    out.append(eb.step())
    before = p.metrics.fenced_writes_total.get(labels={"holder": "A"})
    out.append(_fenced(p, lambda: store.update(
        "pods", pod, fencing=ea.fencing_token()
        or {"lock": "volcano", "holder": "A", "epoch": 1})))
    out.append(p.metrics.fenced_writes_total.get(
        labels={"holder": "A"}) - before)
    out.append(_fenced(p, lambda: store.update(
        "pods", pod, fencing=eb.fencing_token())))
    return out, [False, True, True, 1.0, False]


def fencing_epoch_stale_after_reacquisition_by_other(p):
    store, ea, clock = _leased_store(p)
    token_a1 = ea.fencing_token()
    clock.t += 11
    eb = p.elector(store, "B", clock, lease_duration=10.0)
    out = [eb.step()]
    clock.t += 11
    out.append(ea.step())   # observes the blown renew deadline
    out.append(ea.step())   # re-acquires: epoch bumped twice since a1
    out.append(ea.fencing_token()["epoch"] != token_a1["epoch"])
    store.create("pods", p.pod("d", "p"))
    pod = store.get("pods", "p", "d")
    out.append(_fenced(p, lambda: store.update("pods", pod,
                                               fencing=token_a1)))
    out.append(_fenced(p, lambda: store.update(
        "pods", pod, fencing=ea.fencing_token())))
    return out, [True, False, True, True, True, False]


def fencing_expired_lease_fences_even_without_takeover(p):
    store, ea, clock = _leased_store(p)
    token = ea.fencing_token()
    store.create("pods", p.pod("d", "p"))
    pod = store.get("pods", "p", "d")
    clock.t += 10.5   # expired; nobody else acquired
    return [_fenced(p, lambda: store.update("pods", pod,
                                            fencing=token))], [True]


def fencing_fenced_store_fails_closed_without_a_lease(p):
    store = p.ClusterStore()
    fenced = p.FencedStore(store, lambda: None)
    out = [_fenced(p, lambda: fenced.create("pods", p.pod("d", "p"))),
           store.list("pods"), fenced.try_get("pods", "p", "d")]
    return out, [True, [], None]


# ---------------------------------------------------------------------------
# bind-intent journal lifecycle
# ---------------------------------------------------------------------------

def journal_record_then_sweep_confirms_once_bindings_visible(p):
    store = p.build_cluster()
    cache = p.cache(store)
    cache.run()
    tasks = sorted(cache.jobs["t/j0"].tasks.values(), key=lambda t: t.name)
    for i, t in enumerate(tasks):
        t.node_name = f"n{i}"
    journal = p.BindIntentJournal(store, identity="A")
    saved = p.recovery.SWEEP_GENERATIONS
    # disable the age-based fallback: isolate the settled-in-store rule
    p.recovery.SWEEP_GENERATIONS = 10 ** 6
    try:
        intent = journal.record(tasks)
        out = [store.get("bindintents", intent.name).bindings,
               journal.sweep(), journal.sweep(),
               store.try_get("bindintents", intent.name) is not None]
        for t in tasks:   # binds land -> the next sweep confirms it
            pod = store.get("pods", t.name, "t")
            pod.node_name = t.node_name
            store.update("pods", pod)
        out += [journal.sweep(), store.try_get("bindintents", intent.name)]
    finally:
        p.recovery.SWEEP_GENERATIONS = saved
    return out, [[["t", t.name, t.node_name] for t in tasks], 0, 0, True,
                 1, None]


def journal_stale_unsettled_intent_swept_after_two_generations(p):
    store = p.build_cluster()
    cache = p.cache(store)
    cache.run()
    tasks = list(cache.jobs["t/j0"].tasks.values())
    for t in tasks:
        t.node_name = "n0"
    journal = p.BindIntentJournal(store, identity="A")
    intent = journal.record(tasks)
    out = [journal.sweep(), journal.sweep(),
           store.try_get("bindintents", intent.name)]
    return out, [0, 1, None]


# ---------------------------------------------------------------------------
# single-process failover smokes: crash mid-dispatch, recover
# ---------------------------------------------------------------------------

def _golden(p, conf=HOST_CONF):
    store = p.build_cluster()
    cache = p.cache(store)
    cache.run()
    p.Scheduler(cache, scheduler_conf=conf).run_once()
    return _binds(store)


def _leader_a(p, store, clock):
    cache_a = p.cache(store)
    cache_a.run()
    ea = p.elector(store, "A", clock, lease_duration=10.0)
    assert ea.step()
    cache_a.install_fencing(ea.fencing_token)
    cache_a.bind_journal = p.BindIntentJournal(
        cache_a.fenced_cluster, identity="A", clock=clock)
    return cache_a


def failover_mid_dispatch_crash_recovers_bind_for_bind(p):
    golden = _golden(p)
    clock = FakeClock()
    store = p.ClusterStore()
    store.clock = clock
    p.build_cluster(store)
    bind_writes = []

    def audit(verb, kind, obj):
        # node-setting pod updates, so duplicates are visible
        if kind == "pods" and verb == "update" and obj.node_name:
            prev = store.try_get("pods", obj.name, obj.namespace)
            if prev is None or prev is obj or not prev.node_name:
                bind_writes.append(obj.name)
        return obj

    store.add_interceptor(audit)
    # leader A crashes at the SECOND statement commit: j0's binds land,
    # j1 is journaled but never dispatched
    cache_a = _leader_a(p, store, clock)
    p.faults.arm("bind_commit", at=(2,))
    p.Scheduler(cache_a, scheduler_conf=HOST_CONF).run_once()
    p.faults.reset()
    partial = _binds(store)
    out = [sorted(v for v in partial.values() if v), all(partial.values()),
           len(store.list("bindintents"))]
    clock.t += 11   # A "crashes"; past lease expiry, standby B takes over
    eb = p.elector(store, "B", clock, lease_duration=10.0)
    out.append(eb.step())
    cache_b = p.cache(store)
    cache_b.run()
    cache_b.install_fencing(eb.fencing_token)
    out.append(p.reconcile_bind_intents(store, eb.fencing_token))
    out += [_binds(store) == golden, sorted(bind_writes) == sorted(golden),
            store.list("bindintents")]
    # the deposed leader's late commit is fenced, a no-op on the store
    victim = store.get("pods", "j0-0", "t")
    before = repr(copy.deepcopy(victim))
    out.append(_fenced(p, lambda: cache_a.fenced_cluster.update("pods",
                                                                victim)))
    out.append(repr(store.get("pods", "j0-0", "t")) == before)
    # B's first real cycle finds nothing left to place
    cache_b.bind_journal = p.BindIntentJournal(
        cache_b.fenced_cluster, identity="B", clock=clock)
    marks = len(bind_writes)
    p.Scheduler(cache_b, scheduler_conf=HOST_CONF).run_once()
    out += [len(bind_writes) == marks, _binds(store) == golden]
    assert out[0] and not out[1] and out[2] >= 1
    assert out[4]["redriven"] >= 1 and out[4]["lost"] == 0
    return out, out[:5] + [True, True, [], True, True, True, True]


def failover_pre_commit_crash_reschedules_identically(p):
    golden = _golden(p)
    clock = FakeClock()
    store = p.ClusterStore()
    store.clock = clock
    p.build_cluster(store)
    cache_a = _leader_a(p, store, clock)
    p.faults.arm("bind_commit", at=(1,))
    p.Scheduler(cache_a, scheduler_conf=HOST_CONF).run_once()
    p.faults.reset()
    out = [any(_binds(store).values()), len(store.list("bindintents"))]
    clock.t += 11
    eb = p.elector(store, "B", clock, lease_duration=10.0)
    out.append(eb.step())
    summary = p.reconcile_bind_intents(store, eb.fencing_token)
    out += [summary["redriven"], summary["adopted"]]
    cache_b = p.cache(store)
    cache_b.run()
    cache_b.install_fencing(eb.fencing_token)
    p.Scheduler(cache_b, scheduler_conf=HOST_CONF).run_once()
    out.append(_binds(store) == golden)
    return out, [False, 1, True, 2, 0, True]


# ---------------------------------------------------------------------------
# warm standby: the write-free shadow cycle
# ---------------------------------------------------------------------------

def shadow_cycle_is_write_free_and_mirror_safe(p):
    golden = _op_by_op(p.pkg, lambda: _golden(p, conf=None))
    store = p.build_cluster()
    cache = p.cache(store)
    cache.run()
    sched = p.Scheduler(cache)
    rv_before = store._rv
    phases = {pg.name: pg.status.phase for pg in store.list("podgroups")}
    _op_by_op(p.pkg, sched.shadow_cycle)
    out = [store._rv == rv_before, any(_binds(store).values()),
           phases == {pg.name: pg.status.phase
                      for pg in store.list("podgroups")},
           all(not n.tasks and n.used.milli_cpu == 0
               for n in cache.nodes.values())]
    _op_by_op(p.pkg, sched.run_once)
    out.append(_binds(store) == golden)
    out.append(golden)
    assert all(golden.values())
    if p.pkg == "torch":
        # the shadow warmed the arena: the real cycle ships a delta
        assert not sched.last_cycle_timing["arena_full_ship"]
    return out, [True, False, True, True, True, golden]


def _await(cond, seconds):
    deadline = time.time() + seconds
    while not cond() and time.time() < deadline:
        time.sleep(0.05)
    return cond()


def shadow_standby_loop_runs_shadows_and_leader_cycles(p):
    """run_with_leader_election end-to-end: a standby shadows without
    writing; once the leader releases, takeover recovers and binds."""
    golden = _golden(p)
    store = p.build_cluster()
    other = p.LeaderElector(p.LeaseLock(store, "volcano"), identity="other",
                            lease_duration=1.0, retry_period=0.1)
    assert other.step()
    cache = p.cache(store)
    sched = p.Scheduler(cache, scheduler_conf=HOST_CONF, period=0.01)
    stop = threading.Event()
    t = threading.Thread(
        target=sched.run_with_leader_election, args=(stop,),
        kwargs={"lease_duration": 1.0, "renew_deadline": 0.75,
                "retry_period": 0.1}, daemon=True)
    t.start()
    time.sleep(0.5)
    other.step()   # keep the lease while the standby shadows
    out = [any(_binds(store).values())]
    other.release()
    out.append(_await(lambda: all(_binds(store).values()), 30))
    stop.set()
    t.join(timeout=10)
    out += [t.is_alive(), _binds(store) == golden,
            store.list("bindintents")]
    return out, [False, True, False, True, []]


# ---------------------------------------------------------------------------
# LeaderElector.step edge cases
# ---------------------------------------------------------------------------

def elector_lease_stolen_between_read_and_renew(p):
    clock = FakeClock()
    store = p.ClusterStore()
    lost = []
    stolen = {"armed": False}

    class RacingLock(p.LeaseLock):
        def get(self):
            lease = super().get()
            if stolen["armed"]:
                stolen["armed"] = False
                fresh = copy.copy(self.store.get("leases", self.name))
                fresh.holder_identity = "B"
                fresh.lease_transitions += 1
                fresh.renew_time = clock()
                self.store.update("leases", fresh)
            return lease

    ea = p.LeaderElector(RacingLock(store, "volcano"), identity="A",
                         lease_duration=10.0, retry_period=1.0,
                         on_stopped_leading=lambda: lost.append(1),
                         clock=clock)
    out = [ea.step(), ea.is_leader]
    clock.t += 2.0           # past retry_period: A will re-write
    stolen["armed"] = True   # B commits between A's read and write
    out += [ea.step(), ea.is_leader, lost, ea.fencing_token(),
            store.get("leases", "volcano").holder_identity]
    return out, [True, True, False, False, [1], None, "B"]


def elector_clock_skew_past_renew_deadline_steps_down(p):
    clock = FakeClock()
    store = p.ClusterStore()
    lost, led = [], []
    ea = p.LeaderElector(p.LeaseLock(store, "volcano"), identity="A",
                         lease_duration=30.0, renew_deadline=10.0,
                         retry_period=1.0,
                         on_started_leading=lambda: led.append(1),
                         on_stopped_leading=lambda: lost.append(1),
                         clock=clock)
    out = [ea.step()]
    epoch = ea.fence_epoch
    clock.t += 10.5   # mid-renewal skew beyond the renew deadline
    out += [ea.step(), list(lost), ea.is_leader]
    # holder unchanged: the NEXT step re-acquires without a transition
    out += [ea.step(), ea.is_leader, ea.fence_epoch == epoch, led]
    return out, [True, False, [1], False, True, True, True, [1, 1]]


def elector_two_racing_first_acquirers_both_take_create_path(p):
    clock = FakeClock()
    store = p.ClusterStore()
    creates = []

    class ObservedLock(p.LeaseLock):
        def __init__(self, store, name, stale_reads):
            super().__init__(store, name)
            self.stale_reads = stale_reads

        def get(self):
            if self.stale_reads:
                self.stale_reads.pop()
                return None   # read BEFORE the rival's create landed
            return super().get()

        def create_or_update(self, lease):
            if not lease.resource_version:
                creates.append(self.name)
            return super().create_or_update(lease)

    ea = p.LeaderElector(ObservedLock(store, "volcano", []), identity="A",
                         clock=clock)
    eb = p.LeaderElector(ObservedLock(store, "volcano", [1]), identity="B",
                         clock=clock)
    out = [ea.step(), eb.step(), creates, ea.is_leader, eb.is_leader]
    lease = store.get("leases", "volcano")
    out += [lease.holder_identity, lease.lease_transitions]
    return out, [True, False, ["volcano", "volcano"], True, False, "A", 1]


# ---------------------------------------------------------------------------
# tests/test_ha_observability.py::TestLeaderElection
# ---------------------------------------------------------------------------

def _logged(p, store, name, clock, log):
    return p.LeaderElector(
        p.LeaseLock(store, "volcano"), identity=name, clock=clock,
        on_started_leading=lambda: log.append(f"{name}+"),
        on_stopped_leading=lambda: log.append(f"{name}-"))


def election_single_leader_at_a_time(p):
    store, clock, log = p.ClusterStore(), FakeClock(0.0), []
    a = _logged(p, store, "a", clock, log)
    b = _logged(p, store, "b", clock, log)
    out = [a.step(), b.step(), list(log)]
    for _ in range(5):   # a keeps renewing: b stays standby
        clock.t += 5
        a.step()
        out.append(b.step())
    out += [a.is_leader, b.is_leader]
    return out, [True, False, ["a+"]] + [False] * 5 + [True, False]


def election_failover_on_lease_expiry(p):
    store, clock, log = p.ClusterStore(), FakeClock(0.0), []
    a = _logged(p, store, "a", clock, log)
    b = _logged(p, store, "b", clock, log)
    a.step()
    clock.t += a.lease_duration + 1   # a dies; b takes over
    out = [b.step(), "b+" in log]
    lease = store.get("leases", "volcano")
    out += [lease.holder_identity, lease.lease_transitions]
    return out, [True, True, "b", 2]


def election_release_hands_over_immediately(p):
    store, clock, log = p.ClusterStore(), FakeClock(0.0), []
    a = _logged(p, store, "a", clock, log)
    b = _logged(p, store, "b", clock, log)
    a.step()
    a.release()
    return [list(log), b.step()], [["a+", "a-"], True]


def election_deposed_leader_steps_down(p):
    store, clock, log = p.ClusterStore(), FakeClock(0.0), []
    a = _logged(p, store, "a", clock, log)
    b = _logged(p, store, "b", clock, log)
    a.step()
    clock.t += a.lease_duration + 1
    b.step()   # took over while a was wedged
    return [a.step(), log], [False, ["a+", "b+", "a-"]]


def election_interleaved_takeover_no_split_brain(p):
    store, clock, log = p.ClusterStore(), FakeClock(0.0), []
    a = _logged(p, store, "a", clock, log)
    b = _logged(p, store, "b", clock, log)
    c = _logged(p, store, "c", clock, log)
    a.step()
    clock.t += a.lease_duration + 1   # a is gone, lease expired
    stale_b, stale_c = [b.lock.get()], [c.lock.get()]
    out = [stale_b[0] is not store.get("leases", "volcano")]
    b.lock.get = lambda: stale_b.pop() if stale_b \
        else p.LeaseLock.get(b.lock)
    c.lock.get = lambda: stale_c.pop() if stale_c \
        else p.LeaseLock.get(c.lock)
    out += [b.step(), c.step(), c.is_leader,
            store.get("leases", "volcano").holder_identity, c.step()]
    return out, [True, True, False, False, "b", False]


def election_interleaved_first_acquisition_no_split_brain(p):
    store, clock, log = p.ClusterStore(), FakeClock(0.0), []
    a = _logged(p, store, "a", clock, log)
    b = _logged(p, store, "b", clock, log)
    none_b = [None]   # b's concurrent read saw no lease
    b.lock.get = lambda: none_b.pop() if none_b \
        else p.LeaseLock.get(b.lock)
    out = [a.step(), b.step(), b.is_leader,
           store.get("leases", "volcano").holder_identity, log]
    return out, [True, False, False, "a", ["a+"]]


# ---------------------------------------------------------------------------
# tests/test_ha_observability.py::TestSchedulerHA
# ---------------------------------------------------------------------------

def scheduler_standby_does_not_schedule_until_leader_dies(p):
    m = p.m
    store = p.ClusterStore()
    cache = p.cache(store)
    binder = p.cache_mod.FakeBinder()
    cache.binder = binder
    cache.add_node(m.Node(name="n1", allocatable={"cpu": "4",
                                                  "memory": "8Gi"},
                          capacity={"cpu": "4", "memory": "8Gi"}))
    cache.set_pod_group(m.PodGroup(name="pg", namespace="d",
                                   spec=m.PodGroupSpec(min_member=1)))
    cache.add_pod(m.Pod(name="p", namespace="d",
                        annotations={p.ann: "pg"},
                        containers=[{"requests": {"cpu": "1"}}]))
    other = p.LeaderElector(p.LeaseLock(store, "volcano"), identity="other")
    other.step()   # another process holds the lease: the scheduler idles
    sched = p.Scheduler(cache, scheduler_conf=HOST_CONF)
    stop = threading.Event()
    t = threading.Thread(target=sched.run_with_leader_election,
                         args=(stop,), kwargs={"warm_standby": False},
                         daemon=True)
    sched.period = 0.01
    t.start()
    time.sleep(0.3)
    out = [dict(binder.binds)]
    other.release()   # the leader exits cleanly -> takeover
    _await(lambda: binder.binds, 10)
    stop.set()
    t.join(timeout=5)
    out += [dict(binder.binds), t.is_alive()]
    return out, [{}, {"d/p": "n1"}, False]


SCENARIOS = {f.__name__: f for f in (
    fencing_valid_token_writes_stale_holder_fenced,
    fencing_epoch_stale_after_reacquisition_by_other,
    fencing_expired_lease_fences_even_without_takeover,
    fencing_fenced_store_fails_closed_without_a_lease,
    journal_record_then_sweep_confirms_once_bindings_visible,
    journal_stale_unsettled_intent_swept_after_two_generations,
    failover_mid_dispatch_crash_recovers_bind_for_bind,
    failover_pre_commit_crash_reschedules_identically,
    shadow_cycle_is_write_free_and_mirror_safe,
    shadow_standby_loop_runs_shadows_and_leader_cycles,
    elector_lease_stolen_between_read_and_renew,
    elector_clock_skew_past_renew_deadline_steps_down,
    elector_two_racing_first_acquirers_both_take_create_path,
    election_single_leader_at_a_time,
    election_failover_on_lease_expiry,
    election_release_hands_over_immediately,
    election_deposed_leader_steps_down,
    election_interleaved_takeover_no_split_brain,
    election_interleaved_first_acquisition_no_split_brain,
    scheduler_standby_does_not_schedule_until_leader_dies,
)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_equals_jax(name):
    """The scenario observes the same through both packages, and what the
    reference test asserts."""
    got = {}
    for pkg in PKGS:
        observed, expected = SCENARIOS[name](Pkg(pkg))
        assert observed == expected, pkg
        got[pkg] = observed
    assert got["torch"] == got["jax"]


def test_port_ha_modules_import_nothing_of_jax():
    import sys
    for mod in ("volcano_tpu_torch.utils.leader_election",
                "volcano_tpu_torch.resilience.recovery",
                "volcano_tpu_torch.resilience.transient"):
        src = open(sys.modules[mod].__file__).read()
        assert "import jax" not in src and "volcano_tpu." not in src


# ---------------------------------------------------------------------------
# transient retry
# ---------------------------------------------------------------------------

CUDA_ERRORS = [
    RuntimeError("CUDA error: the launch timed out and was terminated"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    RuntimeError("fused_choice kernel launch failed: CUDA error 6"),
]


@pytest.mark.parametrize("exc", CUDA_ERRORS + ["accelerator"],
                         ids=["launch_timed_out", "illegal_access",
                              "launch_failed", "accelerator_error"])
def test_cuda_errors_are_never_transient(exc):
    port = pkg_mod("torch", "resilience.transient")
    if exc == "accelerator":
        cls = getattr(torch, "AcceleratorError", None)
        if cls is None:
            cls = type("AcceleratorError", (RuntimeError,), {})
        exc = cls.__new__(cls)
        RuntimeError.__init__(exc, "device-side assert triggered")
    assert not port.is_transient(exc)
    if "timed out" in str(exc):
        # the JAX classifier would retry it: the marker the port drops
        assert pkg_mod("jax", "resilience.transient").is_transient(exc)
    calls = []

    def fail():
        calls.append(1)
        raise exc

    with pytest.raises(type(exc)):
        port.retry_transient(fail, delay_s=0.0)
    assert len(calls) == 1


def test_transport_errors_stay_transient():
    port = pkg_mod("torch", "resilience.transient")
    jx = pkg_mod("jax", "resilience.transient")
    for exc in (ConnectionError("connection reset by peer"),
                OSError("socket closed"), TimeoutError("timed out"),
                ValueError("bad shape")):
        assert port.is_transient(exc) == jx.is_transient(exc)


class _FlakySharded:
    """Wraps the sharded arena entry: raises ``faults`` (one per call)
    before delegating, and counts the calls and the arena updates."""

    def __init__(self, monkeypatch, faults):
        from volcano_tpu_torch import parallel
        from volcano_tpu_torch.ops import device_cache
        self.faults = list(faults)
        self.calls = 0
        self.updates = 0
        real = parallel.solve_allocate_sharded_arena
        real_update = device_cache.ShardedDeviceCache.update

        def solve(*a, **k):
            self.calls += 1
            if self.faults:
                raise self.faults.pop(0)
            return real(*a, **k)

        def update(arena, *a, **k):
            self.updates += 1
            return real_update(arena, *a, **k)

        monkeypatch.setattr(parallel, "solve_allocate_sharded_arena", solve)
        monkeypatch.setattr(device_cache.ShardedDeviceCache, "update",
                            update)
        monkeypatch.setattr(pkg_mod("torch", "resilience.transient").time,
                            "sleep", lambda s: None)


def _sharded_cluster():
    from volcano_tpu_torch.ops.device_cache import ShardedDeviceCache
    from volcano_tpu_torch.parallel import Mesh
    c = SeededCluster("torch", 37, n_nodes=8)
    c.cache.sharded_device_cache = ShardedDeviceCache(Mesh(["cpu"] * 2))
    c.sched = pkg_mod("torch", "scheduler").Scheduler(
        c.cache, solver_mode="sharded")
    return c


@pytest.mark.parametrize("faults,outcome", [
    ([ConnectionError("connection reset")], "retried"),
    ([ConnectionError("connection reset"),
      ConnectionError("connection reset")], "host_fallback"),
    ([RuntimeError("CUDA error: the launch timed out and was terminated")],
     "host_fallback"),
], ids=["one_transient_resent", "second_transient_raises",
        "cuda_error_not_resent"])
def test_sharded_dispatch_retry(monkeypatch, faults, outcome):
    twin = _sharded_cluster()
    want = [twin.cycle(4), twin.cycle(3, churn=0.3)]
    c = _sharded_cluster()
    assert c.cycle(4) == want[0]
    sdc = c.cache.sharded_device_cache
    flaky = _FlakySharded(monkeypatch, faults)
    got = c.cycle(3, churn=0.3)
    timing = c.sched.last_cycle_timing
    assert flaky.updates == 1   # the retry never re-scatters
    if outcome == "retried":
        assert flaky.calls == 2 and got == want[1]
        assert "host_fallback" not in timing
        assert c.cache.breaker._consecutive_failures == 0
        assert sdc.invalidations == 0
    else:
        transient = "CUDA" not in str(faults[0])
        assert flaky.calls == (2 if transient else 1)
        assert timing.get("host_fallback") == 1.0 and got
        assert c.cache.breaker._consecutive_failures == 1
        assert sdc.invalidations == 1
    # the next cycle is back on the sharded arena
    c.cycle(2, churn=0.2)
    timing = c.sched.last_cycle_timing
    assert timing["arena_mode"] == "sharded"
    assert "host_fallback" not in timing


class TestAssertUtil:
    """tests/test_ha_observability.py's TestAssertUtil through each
    package's ``utils``: the same raises and messages."""

    @pytest.mark.parametrize("pkg", ("jax", "torch"))
    def test_raises_by_default(self, pkg):
        u = pkg_mod(pkg, "utils")
        u.assert_(True, "fine")
        with pytest.raises(u.AssertionFailed, match="boom"):
            u.assert_(False, "boom")
        with pytest.raises(u.AssertionFailed, match="x=3"):
            u.assertf(False, "x=%d", 3)
