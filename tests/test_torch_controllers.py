"""The port's controllers (volcano_tpu_torch.controllers) against the JAX
package's, on the CPU: the 13 scenarios of tests/test_controllers.py.

Each scenario runs once through each package, on a store of that
package's own models and with the port's cache on ``device="cpu"``. It
asserts the reference test's own expectations in both, and the two runs
must end with the same job phases and counts, pod names, node names,
podgroup phases and queue counts (``torch_helpers.lifecycle_state``,
which compares by name: uids differ between the packages). The backoff
scenarios also compare every deferred delay, both drawn from the same
seeded generator.

Tolerance: exact.
"""

from __future__ import annotations

import random
import time

import pytest

from torch_helpers import Lifecycle, build_node, build_queue, lifecycle_state

PKGS = ("jax", "torch")


def make_world(L):
    store = L.ClusterStore()
    cm = L.controllers.ControllerManager(store)
    cm.run()
    return store, cm


def simple_job(L, name="job1", replicas=2, min_available=2, cpu="1",
               plugins=None, policies=None, ttl=None):
    m = L.m
    return m.Job(
        name=name, namespace="default",
        spec=m.JobSpec(
            min_available=min_available,
            tasks=[m.TaskSpec(name="task", replicas=replicas, template={
                "spec": {"containers": [
                    {"name": "c", "requests": {"cpu": cpu, "memory": "1Gi"}}]},
            })],
            plugins=plugins or {},
            policies=policies or [],
            ttl_seconds_after_finished=ttl,
        ))


def admit_podgroup(L, store, name="job1"):
    """The scheduler's enqueue flips the podgroup Inqueue."""
    pg = store.get("podgroups", name, "default")
    pg.status.phase = L.m.PodGroupPhase.INQUEUE
    store.update("podgroups", pg)


def both(scenario):
    """Run ``scenario(Lifecycle)`` in each package; their returns must be
    equal."""
    got = {pkg: scenario(Lifecycle(pkg)) for pkg in PKGS}
    assert got["torch"] == got["jax"]
    return got["torch"]


# -- TestJobController -------------------------------------------------------

def sync_creates_podgroup_and_gates_pods(L):
    store, cm = make_world(L)
    store.create("jobs", simple_job(L))
    cm.process_all()
    pg = store.try_get("podgroups", "job1", "default")
    assert pg is not None
    assert pg.spec.min_member == 2
    assert float(pg.spec.min_resources["cpu"]) == 2.0
    assert store.list("pods") == []
    gated = lifecycle_state(store)
    admit_podgroup(L, store)
    cm.process_all()
    pods = store.list("pods")
    assert sorted(p.name for p in pods) == ["job1-task-0", "job1-task-1"]
    assert all(p.annotations["scheduling.k8s.io/group-name"] == "job1"
               for p in pods)
    return gated, dict(pg.spec.min_resources), lifecycle_state(store)


def job_phase_running_then_completed(L):
    store, cm = make_world(L)
    store.create("jobs", simple_job(L))
    cm.process_all()
    admit_podgroup(L, store)
    cm.process_all()
    for p in store.list("pods"):
        p.phase = "Running"
        store.update("pods", p)
    cm.process_all()
    job = store.get("jobs", "job1", "default")
    assert job.status.state.phase == L.m.JobPhase.RUNNING
    assert job.status.running == 2
    running = lifecycle_state(store)
    for p in store.list("pods"):
        p.phase = "Succeeded"
        store.update("pods", p)
    cm.process_all()
    job = store.get("jobs", "job1", "default")
    assert job.status.state.phase == L.m.JobPhase.COMPLETED
    return running, lifecycle_state(store)


def pod_failure_policy_restarts_job(L):
    m = L.m
    store, cm = make_world(L)
    store.create("jobs", simple_job(L, policies=[
        m.LifecyclePolicy(action=m.Action.RESTART_JOB,
                          event=m.Event.POD_FAILED)]))
    cm.process_all()
    admit_podgroup(L, store)
    cm.process_all()
    pods = store.list("pods")
    assert len(pods) == 2
    pods[0].phase = "Failed"
    store.update("pods", pods[0])
    cm.process_all()
    job = store.get("jobs", "job1", "default")
    assert job.status.retry_count == 1
    assert job.status.state.phase in (m.JobPhase.RESTARTING,
                                      m.JobPhase.PENDING)
    return lifecycle_state(store)


def abort_command(L):
    m = L.m
    store, cm = make_world(L)
    store.create("jobs", simple_job(L))
    cm.process_all()
    admit_podgroup(L, store)
    cm.process_all()
    store.create("commands", m.Command(
        name="abort-1", namespace="default", action=m.Action.ABORT_JOB,
        target_object={"kind": "Job", "name": "job1"}))
    cm.process_all()
    job = store.get("jobs", "job1", "default")
    assert job.status.state.phase in (m.JobPhase.ABORTING,
                                      m.JobPhase.ABORTED)
    assert store.try_get("commands", "abort-1", "default") is None
    assert store.list("pods") == []
    return lifecycle_state(store)


def scale_down_deletes_surplus_pods(L):
    store, cm = make_world(L)
    store.create("jobs", simple_job(L, replicas=3, min_available=1))
    cm.process_all()
    admit_podgroup(L, store)
    cm.process_all()
    assert len(store.list("pods")) == 3
    job = store.get("jobs", "job1", "default")
    job.spec.tasks[0].replicas = 1
    store.update("jobs", job)
    cm.process_all()
    assert sorted(p.name for p in store.list("pods")) == ["job1-task-0"]
    return lifecycle_state(store)


def svc_ssh_env_plugins(L):
    store, cm = make_world(L)
    store.create("jobs", simple_job(
        L, plugins={"svc": [], "ssh": [], "env": []}))
    cm.process_all()
    admit_podgroup(L, store)
    cm.process_all()
    cmap = store.get("configmaps", "job1-svc", "default")
    assert cmap.data["task.host"] == "job1-task-0.job1\njob1-task-1.job1"
    svc = store.get("services", "job1", "default")
    assert svc.spec["clusterIP"] == "None"
    np_obj = store.get("networkpolicies", "job1", "default")
    assert np_obj.spec["podSelector"]["matchLabels"][
        "volcano.sh/job-name"] == "job1"
    assert np_obj.spec["policyTypes"] == ["Ingress"]
    secret = store.get("secrets", "job1-ssh", "default")
    assert set(secret.data) >= {"id_rsa", "id_rsa.pub", "authorized_keys"}
    pods = {p.name: p for p in store.list("pods")}
    envs = {e["name"]: e["value"]
            for e in pods["job1-task-1"].containers[0]["env"]}
    assert envs["VC_TASK_INDEX"] == "1"
    job = store.get("jobs", "job1", "default")
    return (lifecycle_state(store), cmap.data, svc.spec, np_obj.spec,
            sorted(secret.data),
            {n: (p.containers, p.annotations, p.labels)
             for n, p in sorted(pods.items())},
            job.status.controlled_resources)


JOB_CONTROLLER = {
    "sync_creates_podgroup_and_gates_pods":
        sync_creates_podgroup_and_gates_pods,
    "job_phase_running_then_completed": job_phase_running_then_completed,
    "pod_failure_policy_restarts_job": pod_failure_policy_restarts_job,
    "abort_command": abort_command,
    "scale_down_deletes_surplus_pods": scale_down_deletes_surplus_pods,
    "svc_ssh_env_plugins": svc_ssh_env_plugins,
}


@pytest.mark.parametrize("name", sorted(JOB_CONTROLLER))
def test_job_controller_equals_jax(name):
    both(JOB_CONTROLLER[name])


# -- TestJobRetryBackoff -----------------------------------------------------

def failing_sync(L, fail_times):
    """The job controller of a fresh world with an injected clock, the
    reference test's seeded jitter generator and a sync that raises its
    first ``fail_times`` times; records each attempt's clock reading and
    each deferred retry's delay."""
    store, cm = make_world(L)
    JobController = L.job_controller.JobController
    jc = next(c for c in cm.controllers if isinstance(c, JobController))
    clock = {"t": 1000.0}
    jc.clock = lambda: clock["t"]
    jc.retry_rng = random.Random(7)
    attempts = []
    orig = jc._process

    def flaky(req):
        attempts.append(jc.clock())
        if len(attempts) <= fail_times:
            raise RuntimeError("sync blew up")
        return orig(req)

    jc._process = flaky
    return store, cm, jc, clock, attempts


def expected_delays(L, attempts, n):
    """The first ``n`` backoff delays a Random(7) draws, as the clock
    reads them: each deferred at its failed attempt's time ``t`` for
    ``t + delay``."""
    jc = L.job_controller
    rng = random.Random(7)
    return [(t + min(jc.RETRY_BASE_S * 2 ** i, jc.RETRY_CAP_S)
             * (0.5 + rng.random())) - t
            for i, t in zip(range(n), attempts)]


def backoff_is_delayed_capped_and_counted(L):
    jcm = L.job_controller
    store, cm, jc, clock, attempts = failing_sync(L, fail_times=3)
    store.create("jobs", simple_job(L))
    key = "default/job1"
    counter = L.metrics.job_retry_total
    before = counter.get(labels={"job_id": key})
    delays = []

    jc.process_all()
    assert len(attempts) == 1
    assert len(jc._deferred) == 1
    delay1 = jc._deferred[0][0] - clock["t"]
    delays.append(delay1)
    assert jcm.RETRY_BASE_S * 0.5 <= delay1 < jcm.RETRY_BASE_S * 1.5
    assert counter.get(labels={"job_id": key}) == before + 1

    jc.process_all()
    assert len(attempts) == 1

    clock["t"] += delay1 + 0.001
    jc.process_all()
    assert len(attempts) == 2
    delay2 = jc._deferred[0][0] - clock["t"]
    delays.append(delay2)
    assert jcm.RETRY_BASE_S * 2 * 0.5 <= delay2 < jcm.RETRY_BASE_S * 2 * 1.5

    clock["t"] += delay2 + 0.001
    jc.process_all()
    delays.append(jc._deferred[0][0] - clock["t"])
    clock["t"] += 10
    jc.process_all()
    assert len(attempts) == 4
    assert jc._retry_counts.get(key) is None
    assert counter.get(labels={"job_id": key}) == before + 3
    assert store.try_get("podgroups", "job1", "default") is not None
    assert jcm.MAX_RETRIES == 15
    assert delays == expected_delays(L, attempts, 3)
    # left alone, the generator is the reference's Random(0)
    assert jcm.JobController().retry_rng.random() == \
        random.Random(0).random()
    return delays, attempts, lifecycle_state(store)


def gives_up_after_max_retries(L):
    jcm = L.job_controller
    store, cm, jc, clock, attempts = failing_sync(L, fail_times=10 ** 9)
    store.create("jobs", simple_job(L))
    delays = []
    for _ in range(jcm.MAX_RETRIES + 5):
        jc.process_all()
        delays += [nb - clock["t"] for nb, _ in jc._deferred]
        clock["t"] += jcm.RETRY_CAP_S * 2
    assert len(attempts) == jcm.MAX_RETRIES + 1
    assert jc._deferred == []
    assert delays == expected_delays(L, attempts, jcm.MAX_RETRIES)
    return delays, attempts


def backoff_delay_is_capped(L):
    jcm = L.job_controller
    store, cm, jc, clock, attempts = failing_sync(L, fail_times=10 ** 9)
    store.create("jobs", simple_job(L))
    delays = []
    for _ in range(12):
        jc.process_all()
        if jc._deferred:
            delay = jc._deferred[0][0] - clock["t"]
            assert delay < jcm.RETRY_CAP_S * 1.5
            delays.append(delay)
        clock["t"] += jcm.RETRY_CAP_S * 2
    assert delays == expected_delays(L, attempts, 12)
    return delays, attempts


BACKOFF = {
    "backoff_is_delayed_capped_and_counted":
        backoff_is_delayed_capped_and_counted,
    "gives_up_after_max_retries": gives_up_after_max_retries,
    "backoff_delay_is_capped": backoff_delay_is_capped,
}


@pytest.mark.parametrize("name", sorted(BACKOFF))
def test_job_retry_backoff_equals_jax(name):
    both(BACKOFF[name])


# -- the queue, podgroup and garbage-collector controllers -------------------

def test_queue_status_counts_and_close_equals_jax():
    def scenario(L):
        m = L.m
        store, cm = make_world(L)
        store.apply("queues", build_queue(m, "q1"))
        store.create("jobs", simple_job(L))
        job2 = simple_job(L, name="job2")
        job2.spec.queue = "q1"
        store.create("jobs", job2)
        cm.process_all()
        q1 = store.get("queues", "q1")
        assert q1.status.pending == 1
        counted = lifecycle_state(store)
        store.create("commands", m.Command(
            name="close-q1", namespace="default", action=m.Action.CLOSE_QUEUE,
            target_object={"kind": "Queue", "name": "q1"}))
        cm.process_all()
        q1 = store.get("queues", "q1")
        assert q1.status.state == m.QueueState.CLOSING
        return counted, lifecycle_state(store)
    both(scenario)


def test_bare_pod_gets_podgroup_equals_jax():
    def scenario(L):
        store, cm = make_world(L)
        store.create("pods", L.m.Pod(
            name="bare", namespace="default",
            containers=[{"requests": {"cpu": "1", "memory": "1Gi"}}]))
        cm.process_all()
        pod = store.get("pods", "bare", "default")
        pg_name = pod.annotations["scheduling.k8s.io/group-name"]
        pg = store.get("podgroups", pg_name, "default")
        assert pg.spec.min_member == 1
        assert pg_name == f"podgroup-{pod.uid}"
        return lifecycle_state(store), pg.owner_references[0]["name"]
    both(scenario)


def test_ttl_expiry_cascades_equals_jax():
    def scenario(L):
        store, cm = make_world(L)
        store.create("jobs", simple_job(L, ttl=60, plugins={"svc": []}))
        cm.process_all()
        admit_podgroup(L, store)
        cm.process_all()
        for p in store.list("pods"):
            p.phase = "Succeeded"
            store.update("pods", p)
        cm.process_all()
        job = store.get("jobs", "job1", "default")
        assert job.status.state.phase == L.m.JobPhase.COMPLETED
        finished = lifecycle_state(store)
        gc = cm.controllers[-1]
        assert isinstance(gc, L.controllers.GarbageCollector)
        gc.process_all(now=time.time() + 30)
        assert store.try_get("jobs", "job1", "default") is not None
        gc.process_all(now=time.time() + 61)
        assert store.try_get("jobs", "job1", "default") is None
        assert store.try_get("podgroups", "job1", "default") is None
        assert store.try_get("configmaps", "job1-svc", "default") is None
        return finished, lifecycle_state(store)
    both(scenario)


# -- TestFullLifecycle -------------------------------------------------------

def test_submit_schedule_run_equals_jax():
    def scenario(L):
        store = L.ClusterStore()
        cm = L.controllers.ControllerManager(store)
        cm.run()
        sched = L.scheduler(L.cache(store))
        for i in range(2):
            store.create("nodes", build_node(
                L.m, f"n{i}", {"cpu": "4", "memory": "8Gi"}))
        store.create("jobs", simple_job(L, replicas=3, min_available=3))
        states = []
        cm.process_all()
        states.append(lifecycle_state(store))
        sched.run(stop_after=1)
        cm.process_all()
        assert len(store.list("pods")) == 3
        states.append(lifecycle_state(store))
        sched.run(stop_after=1)
        cm.process_all()
        job = store.get("jobs", "job1", "default")
        assert job.status.state.phase == L.m.JobPhase.RUNNING
        assert all(p.node_name for p in store.list("pods"))
        states.append(lifecycle_state(store))
        return states
    both(scenario)
