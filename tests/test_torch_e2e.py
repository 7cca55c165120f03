"""A vcjob end to end through the port against the JAX package, on the
CPU: the in-process suites of tests/test_e2e.py (jobseq error handling
and commands, schedulingbase, schedulingaction, job resilience).

``World(pkg)`` is the reference's World for either package: one store
with admission (``start_webhooks``), the ControllerManager and the
Scheduler (the port's cache on ``device="cpu"``), nodes and queues built
from that package's own models. Every ``converge`` records what the
lifecycle left in the store (``torch_helpers.lifecycle_state``: job
phases and counts, pods and their nodes, podgroup phases, queue counts,
by name). Each scenario runs once in each package, asserts the reference
test's own expectations in both, and the two records must be equal
converge by converge.

One card test (``cuda`` marker, skipped without a GPU) runs the
lifecycle twin of chip_smoke.py at 50 nodes and 20 jobs on the card and
on the CPU. This module imports no jax at top level: the card's machine
has none.

Tolerance: exact.
"""

from __future__ import annotations

import pytest
import torch

from torch_helpers import Lifecycle, build_node, build_queue, lifecycle_state

PKGS = ("jax", "torch")


class World:
    """Store + webhooks + controllers + scheduler of one package, driven
    synchronously; ``trace`` holds the store's lifecycle state after each
    converge."""

    def __init__(self, L, nodes=2, node_cpu="4", node_mem="8Gi", conf=None,
                 queues=()):
        self.L, self.m = L, L.m
        self.store = L.ClusterStore()
        L.webhooks.start_webhooks(self.store)
        self.cm = L.controllers.ControllerManager(self.store)
        self.cm.run()
        self.cache = L.cache(self.store)
        self.sched = L.scheduler(self.cache, conf)
        for name, weight, reclaimable in queues:
            self.store.apply("queues", build_queue(
                self.m, name, weight, reclaimable=reclaimable))
        for i in range(nodes):
            self.store.create("nodes", build_node(
                self.m, f"n{i}", {"cpu": node_cpu, "memory": node_mem}))
        self.trace = []

    def kubelet_finalize(self):
        for p in list(self.store.list("pods")):
            if p.deletion_timestamp is not None:
                try:
                    self.store.delete("pods", p.name, p.namespace)
                except Exception:
                    pass

    def converge(self, cycles=3):
        for _ in range(cycles):
            self.cm.process_all()
            self.kubelet_finalize()
            self.sched.run(stop_after=1)
        self.cm.process_all()
        self.trace.append(lifecycle_state(self.store))

    def job(self, name="job1", namespace="default"):
        return self.store.get("jobs", name, namespace)

    def pods(self, job_name=None):
        pods = self.store.list("pods")
        if job_name is not None:
            pods = [p for p in pods if p.name.startswith(job_name + "-")]
        return pods

    def fail_pod(self, pod, exit_code=1):
        pod.phase = "Failed"
        pod.container_statuses = [
            {"name": "c", "state": {"terminated": {"exitCode": exit_code}}}]
        self.store.update("pods", pod)

    def complete_pod(self, pod):
        pod.phase = "Succeeded"
        self.store.update("pods", pod)

    def phase(self, name="job1"):
        return self.job(name).status.state.phase


def make_job(m, name="job1", replicas=2, min_available=None, cpu="1",
             mem="1Gi", policies=None, task_policies=None, queue="default",
             priority_class=None, tasks=None):
    if tasks is None:
        tasks = [m.TaskSpec(name="task", replicas=replicas,
                            policies=task_policies or [],
                            template={"spec": {"containers": [
                                {"name": "c",
                                 "requests": {"cpu": cpu, "memory": mem}}]}})]
    spec = m.JobSpec(min_available=min_available
                     if min_available is not None else replicas,
                     tasks=tasks, policies=policies or [], queue=queue,
                     priority_class_name=priority_class or "")
    return m.Job(name=name, namespace="default", spec=spec)


def policy(m, action, event=None, exit_code=None):
    return m.LifecyclePolicy(action=getattr(m.Action, action),
                             event=getattr(m.Event, event) if event else None,
                             exit_code=exit_code)


def both(scenario):
    """Run ``scenario(L)`` (it returns its World) in each package: the
    worlds' traces must be equal converge by converge."""
    traces = {pkg: scenario(Lifecycle(pkg)).trace for pkg in PKGS}
    jax_t, port_t = traces["jax"], traces["torch"]
    assert len(port_t) == len(jax_t) > 0
    for i, (a, b) in enumerate(zip(jax_t, port_t)):
        assert b == a, f"converge {i} differs"


# -- jobseq: error handling and lifecycle policies ---------------------------

def pod_failed_restart_job(L):
    m = L.m
    w = World(L)
    w.store.create("jobs", make_job(m, policies=[
        policy(m, "RESTART_JOB", "POD_FAILED")]))
    w.converge()
    assert w.phase() == m.JobPhase.RUNNING
    w.fail_pod(w.pods("job1")[0])
    w.converge()
    assert w.job().status.retry_count >= 1
    assert w.phase() == m.JobPhase.RUNNING
    assert all(p.phase == "Running" for p in w.pods("job1"))
    return w


def pod_failed_terminate_job(L):
    m = L.m
    w = World(L)
    w.store.create("jobs", make_job(m, policies=[
        policy(m, "TERMINATE_JOB", "POD_FAILED")]))
    w.converge()
    w.fail_pod(w.pods("job1")[0])
    w.converge()
    assert w.phase() == m.JobPhase.TERMINATED
    return w


def pod_failed_abort_job(L):
    m = L.m
    w = World(L)
    w.store.create("jobs", make_job(m, policies=[
        policy(m, "ABORT_JOB", "POD_FAILED")]))
    w.converge()
    w.fail_pod(w.pods("job1")[0])
    w.converge()
    assert w.phase() == m.JobPhase.ABORTED
    return w


def task_completed_complete_job(L):
    m = L.m
    w = World(L)
    w.store.create("jobs", make_job(m, replicas=2, policies=[
        policy(m, "COMPLETE_JOB", "TASK_COMPLETED")]))
    w.converge()
    for p in w.pods("job1"):
        w.complete_pod(p)
    w.converge()
    assert w.phase() == m.JobPhase.COMPLETED
    return w


def exit_code_policy_restarts(L):
    m = L.m
    w = World(L)
    w.store.create("jobs", make_job(m, policies=[
        policy(m, "RESTART_JOB", exit_code=3)]))
    w.converge()
    assert w.phase() == m.JobPhase.RUNNING
    w.fail_pod(w.pods("job1")[0], exit_code=3)
    w.converge()
    assert w.job().status.retry_count >= 1
    assert w.phase() == m.JobPhase.RUNNING
    return w


def task_level_policy_overrides_job_level(L):
    m = L.m
    w = World(L)
    w.store.create("jobs", make_job(
        m, policies=[policy(m, "ABORT_JOB", "POD_FAILED")],
        task_policies=[policy(m, "RESTART_JOB", "POD_FAILED")]))
    w.converge()
    w.fail_pod(w.pods("job1")[0])
    w.converge()
    assert w.phase() == m.JobPhase.RUNNING
    return w


def unschedulable_gang_waits_then_runs(L):
    m = L.m
    w = World(L, nodes=1, node_cpu="2")
    w.store.create("jobs", make_job(m, replicas=4, cpu="1"))
    w.converge()
    assert w.phase() == m.JobPhase.PENDING
    assert all(not p.node_name for p in w.pods("job1"))
    w.store.create("nodes", build_node(m, "extra",
                                       {"cpu": "4", "memory": "8Gi"}))
    w.converge()
    assert w.phase() == m.JobPhase.RUNNING
    return w


# -- commands ------------------------------------------------------------------

def abort_then_resume(L):
    m = L.m
    w = World(L)
    w.store.create("jobs", make_job(m))
    w.converge()
    assert w.phase() == m.JobPhase.RUNNING
    w.store.create("commands", m.Command(
        name="abort-job1", namespace="default", action=m.Action.ABORT_JOB,
        target_object={"kind": "Job", "name": "job1"}))
    w.converge()
    assert w.phase() == m.JobPhase.ABORTED
    assert w.pods("job1") == []
    w.store.create("commands", m.Command(
        name="resume-job1", namespace="default", action=m.Action.RESUME_JOB,
        target_object={"kind": "Job", "name": "job1"}))
    w.converge()
    assert w.phase() == m.JobPhase.RUNNING
    assert len(w.pods("job1")) == 2
    return w


# -- schedulingbase: gang / binpack / fair share -------------------------------

def gang_full_occupied_second_job_waits(L):
    m = L.m
    w = World(L, nodes=1, node_cpu="4")
    w.store.create("jobs", make_job(m, "j1", replicas=4, cpu="1"))
    w.converge()
    assert w.phase("j1") == m.JobPhase.RUNNING
    w.store.create("jobs", make_job(m, "j2", replicas=4, cpu="1"))
    w.converge()
    assert all(not p.node_name for p in w.pods("j2"))
    for p in w.pods("j1"):
        w.complete_pod(p)
    w.converge(cycles=4)
    assert w.phase("j2") == m.JobPhase.RUNNING
    return w


def best_effort_mix(L):
    m = L.m
    w = World(L, nodes=1, node_cpu="2")
    tasks = [
        m.TaskSpec(name="work", replicas=2, template={"spec": {"containers": [
            {"name": "c", "requests": {"cpu": "1", "memory": "1Gi"}}]}}),
        m.TaskSpec(name="be", replicas=2, template={"spec": {"containers": [
            {"name": "c", "requests": {}}]}}),
    ]
    w.store.create("jobs", make_job(m, "mix", tasks=tasks, min_available=4))
    w.converge()
    assert w.phase("mix") == m.JobPhase.RUNNING
    assert len([p for p in w.pods("mix") if p.node_name]) == 4
    return w


BINPACK_ONLY_CONF = """
actions: "enqueue, allocate, backfill"
tiers:
- plugins:
  - name: gang
- plugins:
  - name: predicates
  - name: binpack
"""


def binpack_policy_packs_one_node(L):
    m = L.m
    w = World(L, nodes=3, node_cpu="8", conf=BINPACK_ONLY_CONF)
    w.store.create("jobs", make_job(m, replicas=4, cpu="1"))
    w.converge()
    assert len({p.node_name for p in w.pods("job1")}) == 1
    return w


FAIR_SHARE_CONF = """
actions: "enqueue, allocate, backfill"
tiers:
- plugins:
  - name: gang
- plugins:
  - name: predicates
  - name: proportion
  - name: nodeorder
"""


def queue_fair_share(L):
    m = L.m
    w = World(L, nodes=2, node_cpu="4", conf=FAIR_SHARE_CONF,
              queues=[("q3", 3, None), ("q1", 1, None)])
    w.store.create("jobs", make_job(m, "big3", replicas=16, min_available=1,
                                    queue="q3"))
    w.store.create("jobs", make_job(m, "big1", replicas=16, min_available=1,
                                    queue="q1"))
    w.converge(cycles=5)
    bound3 = len([p for p in w.pods("big3") if p.node_name])
    bound1 = len([p for p in w.pods("big1") if p.node_name])
    assert bound3 + bound1 == 8
    assert bound3 == 6 and bound1 == 2
    return w


# -- schedulingaction: preempt / reclaim ---------------------------------------

PREEMPT_CONF = """
actions: "enqueue, allocate, preempt, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: conformance
- plugins:
  - name: predicates
  - name: proportion
  - name: nodeorder
configurations:
- name: enqueue
  arguments:
    overcommit-factor: 1.8
"""

RECLAIM_CONF = """
actions: "enqueue, reclaim, allocate, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: conformance
- plugins:
  - name: predicates
  - name: proportion
  - name: nodeorder
configurations:
- name: enqueue
  arguments:
    overcommit-factor: 1.5
"""


def priority_classes(w):
    w.store.create("priorityclasses", w.m.PriorityClass(name="high",
                                                        value=100))
    w.store.create("priorityclasses", w.m.PriorityClass(name="low", value=1))


def no_preemption_when_resource_enough(L):
    m = L.m
    w = World(L, nodes=2, node_cpu="4", conf=PREEMPT_CONF)
    priority_classes(w)
    w.store.create("jobs", make_job(m, "low", replicas=2, cpu="1",
                                    priority_class="low"))
    w.converge()
    w.store.create("jobs", make_job(m, "high", replicas=2, cpu="1",
                                    priority_class="high"))
    w.converge()
    assert w.phase("low") == m.JobPhase.RUNNING
    assert w.phase("high") == m.JobPhase.RUNNING
    return w


def preempt_when_idle_not_enough(L):
    m = L.m
    w = World(L, nodes=1, node_cpu="4", conf=PREEMPT_CONF)
    priority_classes(w)
    w.store.create("jobs", make_job(m, "low", replicas=4, min_available=1,
                                    cpu="1", priority_class="low"))
    w.converge()
    assert len([p for p in w.pods("low") if p.node_name]) == 4
    w.store.create("jobs", make_job(m, "high", replicas=2, min_available=2,
                                    cpu="1", priority_class="high"))
    w.converge(cycles=6)
    assert len([p for p in w.pods("high") if p.node_name]) == 2
    return w


def reclaim_across_queues(L):
    m = L.m
    w = World(L, nodes=1, node_cpu="4", node_mem="4Gi", conf=RECLAIM_CONF,
              queues=[("qa", 1, None), ("qb", 1, None)])
    priority_classes(w)
    w.store.create("jobs", make_job(m, "greedy", replicas=4, min_available=1,
                                    cpu="1", queue="qa",
                                    priority_class="low"))
    w.converge()
    assert len([p for p in w.pods("greedy") if p.node_name]) == 4
    w.store.create("jobs", make_job(m, "claimer", replicas=2,
                                    min_available=1, cpu="1", queue="qb",
                                    priority_class="high"))
    w.converge(cycles=6)
    assert len([p for p in w.pods("claimer") if p.node_name]) >= 1
    return w


def no_reclaim_from_unreclaimable_queue(L):
    m = L.m
    w = World(L, nodes=1, node_cpu="4", node_mem="4Gi", conf=RECLAIM_CONF,
              queues=[("qa", 1, False), ("qb", 1, None)])
    priority_classes(w)
    w.store.create("jobs", make_job(m, "greedy", replicas=4, min_available=1,
                                    cpu="1", queue="qa",
                                    priority_class="low"))
    w.converge()
    w.store.create("jobs", make_job(m, "claimer", replicas=2,
                                    min_available=1, cpu="1", queue="qb",
                                    priority_class="high"))
    w.converge(cycles=6)
    assert all(not p.node_name for p in w.pods("claimer"))
    assert len([p for p in w.pods("greedy") if p.node_name]) == 4
    return w


# -- job resilience --------------------------------------------------------------

def restart_task_syncs_without_job_restart(L):
    m = L.m
    w = World(L)
    w.store.create("jobs", make_job(m, min_available=1, task_policies=[
        policy(m, "RESTART_TASK", "POD_FAILED")]))
    w.converge()
    survivor = w.pods("job1")[1].name
    w.fail_pod(w.pods("job1")[0])
    w.converge()
    assert w.phase() == m.JobPhase.RUNNING
    assert w.job().status.retry_count == 0
    assert w.job().status.failed == 1
    pods = w.pods("job1")
    assert len(pods) == 2
    assert survivor in {p.name for p in pods if p.phase == "Running"}
    return w


def max_retry_exhaustion_fails_job(L):
    m = L.m
    w = World(L)
    job = make_job(m, policies=[policy(m, "RESTART_JOB", "POD_FAILED")])
    job.spec.max_retry = 2
    w.store.create("jobs", job)
    w.converge()
    for _ in range(4):
        pods = [p for p in w.pods("job1") if p.phase == "Running"]
        if not pods:
            break
        w.fail_pod(pods[0])
        w.converge(cycles=4)
    assert w.phase() == m.JobPhase.FAILED
    assert w.job().status.retry_count >= 2
    return w


def scale_down_then_up(L):
    w = World(L)
    w.store.create("jobs", make_job(L.m, replicas=3, min_available=1))
    w.converge()
    assert len(w.pods("job1")) == 3
    job = w.job()
    job.spec.tasks[0].replicas = 1
    w.store.update("jobs", job)
    w.converge()
    w.kubelet_finalize()
    w.converge()
    live = [p for p in w.pods("job1") if p.deletion_timestamp is None]
    assert len(live) == 1
    job = w.job()
    job.spec.tasks[0].replicas = 2
    w.store.update("jobs", job)
    w.converge()
    live = [p for p in w.pods("job1") if p.deletion_timestamp is None]
    assert len(live) == 2
    assert all(p.phase == "Running" for p in live)
    return w


def deleted_pod_recreated(L):
    w = World(L)
    w.store.create("jobs", make_job(L.m, min_available=1))
    w.converge()
    victim = w.pods("job1")[0]
    w.store.delete("pods", victim.name, victim.namespace)
    w.converge()
    pods = w.pods("job1")
    assert len(pods) == 2
    assert all(p.phase == "Running" for p in pods)
    return w


def admission_denies_bad_job_in_world(L):
    w = World(L)
    bad = make_job(L.m, name="badjob", replicas=2, min_available=5)
    with pytest.raises(L.AdmissionError) as err:
        w.store.create("jobs", bad)
    assert w.store.try_get("jobs", "badjob", "default") is None
    w.converge()
    w.trace.append(str(err.value))
    return w


SCENARIOS = {f.__name__: f for f in (
    # TestJobErrorHandling
    pod_failed_restart_job, pod_failed_terminate_job, pod_failed_abort_job,
    task_completed_complete_job, exit_code_policy_restarts,
    task_level_policy_overrides_job_level,
    unschedulable_gang_waits_then_runs,
    # TestCommands
    abort_then_resume,
    # TestSchedulingBase
    gang_full_occupied_second_job_waits, best_effort_mix,
    binpack_policy_packs_one_node, queue_fair_share,
    # TestSchedulingActions
    no_preemption_when_resource_enough, preempt_when_idle_not_enough,
    reclaim_across_queues, no_reclaim_from_unreclaimable_queue,
    # TestJobResilience (all but the CLI's test_cli_submit_schedules)
    restart_task_syncs_without_job_restart, max_retry_exhaustion_fails_job,
    scale_down_then_up, deleted_pod_recreated,
    admission_denies_bad_job_in_world,
)}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_equals_jax(name):
    both(SCENARIOS[name])


@pytest.mark.cuda
def test_lifecycle_twin_on_card():
    """chip_smoke.py's lifecycle twin at 50 nodes and 20 jobs: the same
    vcjobs, waves, failures and commands through the port on the card and
    on the CPU give the same binds, job phases, podgroup phases and queue
    counts, wave by wave, and every binding cycle launched the kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import chip_smoke
    out = chip_smoke.lifecycle_twin(torch.device("cuda", 0),
                                    dict(n_nodes=50, n_jobs=20, waves=3))
    assert out["identical_to_host"] and out["waves"] == 3
    assert out["launches"] > 0
