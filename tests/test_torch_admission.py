"""The port's in-process admission (volcano_tpu_torch.webhooks) against
the JAX package's, on the CPU: TestJobAdmission, TestPodGate and
TestQueueAdmission of tests/test_admission_cli.py.

Each case runs once in each package, on a store of that package's own
models with ``start_webhooks`` bound to it. Every write the case makes is
recorded as admitted (with what admission left in the store: the
mutations) or denied (with the AdmissionError's message); the reference
test's own expectations hold in both packages, and the two records must
be equal, message for message. Each package keeps its own registry of
admission services, so neither store's interceptor sees the other
package's objects.

Tolerance: exact.
"""

from __future__ import annotations

import copy

import pytest

from torch_helpers import Lifecycle, build_pod_group, build_queue, pkg_mod

PKGS = ("jax", "torch")


class Admission:
    """One package's store under admission, recording every verdict."""

    def __init__(self, L):
        self.L, self.m = L, L.m
        self.store = L.ClusterStore()
        self.store.create("queues", build_queue(self.m, "default"))
        L.webhooks.start_webhooks(self.store)
        self.verdicts = []

    def write(self, verb, kind, *args, match=None):
        """``store.<verb>(kind, *args)``; ``match``: the denial expected
        (a substring of its message), else the write must pass."""
        try:
            out = getattr(self.store, verb)(kind, *args)
        except self.L.AdmissionError as e:
            assert match is not None and match in str(e), str(e)
            self.verdicts.append((verb, kind, "denied", str(e)))
            return None
        assert match is None, f"{verb} {kind} admitted, expected {match!r}"
        self.verdicts.append((verb, kind, "admitted"))
        return out

    def saved(self, kind, name, namespace=None):
        obj = self.store.get(kind, name, namespace)
        spec = obj.spec
        if kind == "jobs":
            view = (spec.queue, spec.scheduler_name, spec.min_available,
                    [t.name for t in spec.tasks],
                    [t.replicas for t in spec.tasks])
        else:
            view = (spec.weight, spec.reclaimable)
        self.verdicts.append(("saved", kind, name, view))
        return obj


def valid_job(m, **kw):
    spec = dict(
        min_available=2,
        tasks=[m.TaskSpec(name="task", replicas=2, template={
            "spec": {"containers": [{"name": "c",
                                     "requests": {"cpu": "1"}}]}})])
    spec.update(kw)
    return m.Job(name="j1", namespace="default", spec=m.JobSpec(**spec))


# -- TestJobAdmission ------------------------------------------------------------

def valid_job_passes_and_is_defaulted(a):
    job = valid_job(a.m, min_available=0)
    job.spec.queue = ""
    a.write("create", "jobs", job)
    saved = a.saved("jobs", "j1", "default")
    assert saved.spec.queue == "default"
    assert saved.spec.min_available == 2


def min_available_exceeds_replicas_rejected(a):
    a.write("create", "jobs", valid_job(a.m, min_available=5),
            match="minAvailable")


def duplicate_task_names_rejected(a):
    job = valid_job(a.m)
    job.spec.tasks.append(a.m.TaskSpec(name="task", replicas=1, template={
        "spec": {"containers": [{"name": "c"}]}}))
    a.write("create", "jobs", job, match="duplicated task name")


def policy_event_and_exitcode_exclusive(a):
    m = a.m
    job = valid_job(m, policies=[m.LifecyclePolicy(
        action=m.Action.RESTART_JOB, event=m.Event.POD_FAILED, exit_code=3)])
    a.write("create", "jobs", job, match="simultaneously")


def no_tasks_rejected(a):
    a.write("create", "jobs", valid_job(a.m, tasks=[]), match="No task")


def closed_queue_rejected(a):
    q = build_queue(a.m, "closed-q")
    q.status.state = a.m.QueueState.CLOSED
    a.write("create", "queues", q)
    a.write("create", "jobs", valid_job(a.m, queue="closed-q"), match="Open")


def update_only_replicas_minavailable(a):
    a.write("create", "jobs", valid_job(a.m))
    job = copy.deepcopy(a.store.get("jobs", "j1", "default"))
    job.spec.tasks[0].replicas = 3
    job.spec.min_available = 1
    a.write("update", "jobs", job)
    a.saved("jobs", "j1", "default")
    job = copy.deepcopy(a.store.get("jobs", "j1", "default"))
    job.spec.queue = "other"
    a.write("update", "jobs", job, match="may not change")


def unknown_plugin_rejected(a):
    a.write("create", "jobs", valid_job(a.m, plugins={"nope": []}),
            match="job plugin")


# -- TestPodGate -----------------------------------------------------------------

def pod_rejected_while_podgroup_pending(a):
    m = a.m
    a.write("create", "podgroups", build_pod_group(
        m, "pg1", "default", 1, "default", phase=m.PodGroupPhase.PENDING))
    pod = m.Pod(name="p1", namespace="default",
                annotations={"scheduling.k8s.io/group-name": "pg1"},
                containers=[{"requests": {"cpu": "1"}}])
    a.write("create", "pods", pod, match="Pending")
    pg = a.store.get("podgroups", "pg1", "default")
    pg.status.phase = m.PodGroupPhase.INQUEUE
    a.write("update", "podgroups", pg)
    a.write("create", "pods", pod)


# -- TestQueueAdmission ----------------------------------------------------------

def weight_validated_and_defaulted(a):
    q0 = build_queue(a.m, "q0")
    q0.spec.weight = 0
    a.write("create", "queues", q0)
    assert a.saved("queues", "q0").spec.weight == 1
    qneg = build_queue(a.m, "qneg")
    qneg.spec.weight = -2
    a.write("create", "queues", qneg, match="weight")


def reclaimable_defaulted(a):
    q = build_queue(a.m, "qr")
    assert q.spec.reclaimable is None
    a.write("create", "queues", q)
    assert a.saved("queues", "qr").spec.reclaimable is True


def hierarchy_depth_mismatch_rejected(a):
    q = build_queue(a.m, "qh", annotations={
        "volcano.sh/hierarchy": "root/a/b",
        "volcano.sh/hierarchy-weights": "1/2"})
    a.write("create", "queues", q, match="depth")


def delete_with_podgroups_rejected(a):
    a.write("create", "queues", build_queue(a.m, "busy"))
    a.write("create", "podgroups", build_pod_group(
        a.m, "pg1", "default", 1, "busy", phase=a.m.PodGroupPhase.INQUEUE))
    a.write("delete", "queues", "busy", match="podgroup")


def default_queue_protected(a):
    a.write("delete", "queues", "default", match="default")


CASES = {f.__name__: f for f in (
    valid_job_passes_and_is_defaulted,
    min_available_exceeds_replicas_rejected, duplicate_task_names_rejected,
    policy_event_and_exitcode_exclusive, no_tasks_rejected,
    closed_queue_rejected, update_only_replicas_minavailable,
    unknown_plugin_rejected,
    pod_rejected_while_podgroup_pending,
    weight_validated_and_defaulted, reclaimable_defaulted,
    hierarchy_depth_mismatch_rejected, delete_with_podgroups_rejected,
    default_queue_protected,
)}


@pytest.mark.parametrize("name", list(CASES))
def test_admission_equals_jax(name):
    verdicts = {}
    for pkg in PKGS:
        a = Admission(Lifecycle(pkg))
        CASES[name](a)
        verdicts[pkg] = a.verdicts
    assert verdicts["torch"] == verdicts["jax"]


def test_each_package_keeps_its_own_admission_services():
    """Both packages registered in one process: the port's router lists
    only the port's services, each bound to a function of the port."""
    for pkg in PKGS:
        pkg_mod(pkg, "webhooks").register_all()
    port = pkg_mod("torch", "webhooks").list_services()
    ref = pkg_mod("jax", "webhooks").list_services()
    assert [s.path for s in port] == [s.path for s in ref]
    assert all(s.func.__module__.startswith("volcano_tpu_torch.webhooks.")
               for s in port)
    assert not any(s.func.__module__.startswith("volcano_tpu_torch.")
                   for s in ref)
