"""Job admission: validate + mutate (reference webhooks/admission/jobs/).

Create validation (admit_job.go:108-237): minAvailable/maxRetry/ttl >= 0,
tasks present with DNS-1123 names, no duplicate task names, policy event
and exit-code exclusivity, minAvailable <= total replicas, known plugins,
volume mount-path uniqueness, open target queue. Update validation: only
replicas and minAvailable may change. Mutation (mutate_job.go:111-160):
default queue/scheduler/task names/minAvailable.
"""

from __future__ import annotations

import re

from ..client.store import AdmissionError
from ..models import Event, Job, QueueState
from .router import (
    AdmissionOptions, AdmissionService, register_admission_service,
)

_DNS1123 = re.compile(r"^[a-z0-9]([-a-z0-9]*[a-z0-9])?$")


def _validate_policies(policies, where: str) -> None:
    seen_events = set()
    has_any = False
    for policy in policies:
        events = set(policy.events)
        if policy.event is not None:
            events.add(policy.event)
        if events and policy.exit_code is not None:
            raise AdmissionError(
                f"{where}: must not specify event and exitCode simultaneously")
        if not events and policy.exit_code is None:
            raise AdmissionError(
                f"{where}: either event or exitCode must be specified")
        if policy.exit_code is not None and policy.exit_code == 0:
            raise AdmissionError(f"{where}: 0 is not a valid error code")
        for e in events:
            if e in seen_events:
                raise AdmissionError(f"{where}: duplicate event {e.value}")
            seen_events.add(e)
        if Event.ANY in events:
            has_any = True
    if has_any and len(seen_events) > 1:
        raise AdmissionError(
            f"{where}: if there's * here, no other policy should be here")


def _validate_io(volumes) -> None:
    seen = set()
    for vol in volumes or []:
        mp = vol.get("mountPath")
        if not mp:
            raise AdmissionError("mountPath is required")
        if mp in seen:
            raise AdmissionError(f"duplicated mountPath: {mp}")
        seen.add(mp)
        if "volumeClaimName" not in vol and "volumeClaim" not in vol:
            raise AdmissionError(
                "either VolumeClaim or VolumeClaimName must be specified")


def validate_job(verb: str, job: Job, cluster,
                 opts: AdmissionOptions = None) -> Job:
    if verb == "delete":
        return job
    if verb == "update":
        old = cluster.try_get("jobs", job.name, job.namespace)
        if old is not None:
            _validate_update(old, job)
        return job

    if job.spec.min_available < 0:
        raise AdmissionError("'minAvailable' must be >= 0.")
    if job.spec.max_retry < 0:
        raise AdmissionError("'maxRetry' cannot be less than zero.")
    if job.spec.ttl_seconds_after_finished is not None \
            and job.spec.ttl_seconds_after_finished < 0:
        raise AdmissionError("'ttlSecondsAfterFinished' cannot be less than zero.")
    if not job.spec.tasks:
        raise AdmissionError("No task specified in job spec")

    total_replicas = 0
    names = set()
    for task in job.spec.tasks:
        if task.replicas < 0:
            raise AdmissionError(f"'replicas' < 0 in task: {task.name}")
        total_replicas += task.replicas
        if task.name and not _DNS1123.match(task.name):
            raise AdmissionError(
                f"task name {task.name!r} must be a valid DNS-1123 label")
        if task.name in names:
            raise AdmissionError(f"duplicated task name {task.name}")
        names.add(task.name)
        _validate_policies(task.policies, f"spec.tasks[{task.name}].policies")
        if not (task.template or {}).get("spec", {}).get("containers"):
            raise AdmissionError(
                f"task {task.name}: template must define containers")
    if total_replicas < job.spec.min_available:
        raise AdmissionError(
            "'minAvailable' should not be greater than total replicas in tasks")
    _validate_policies(job.spec.policies, "spec.policies")

    from ..controllers.job.plugins import _PLUGIN_BUILDERS
    for name in job.spec.plugins or {}:
        if name not in _PLUGIN_BUILDERS:
            raise AdmissionError(f"unable to find job plugin: {name}")

    _validate_io(job.spec.volumes)

    default_queue = opts.default_queue if opts else "default"
    queue = cluster.try_get("queues", job.spec.queue or default_queue)
    if queue is None:
        raise AdmissionError("unable to find job queue: "
                             f"{job.spec.queue or default_queue}")
    if queue.status.state != QueueState.OPEN:
        raise AdmissionError(
            f"can only submit job to queue with state `Open`, queue "
            f"`{queue.name}` status is `{queue.status.state.value}`")
    return job


def _validate_update(old: Job, new: Job) -> None:
    total = 0
    for task in new.spec.tasks:
        if task.replicas < 0:
            raise AdmissionError(f"'replicas' must be >= 0 in task: {task.name}")
        total += task.replicas
    if new.spec.min_available > total:
        raise AdmissionError(
            "'minAvailable' must not be greater than total replicas")
    if new.spec.min_available < 0:
        raise AdmissionError("'minAvailable' must be >= 0")
    if len(old.spec.tasks) != len(new.spec.tasks):
        raise AdmissionError("job updates may not add or remove tasks")
    for ot, nt in zip(old.spec.tasks, new.spec.tasks):
        if ot.name != nt.name or ot.template != nt.template:
            raise AdmissionError(
                "job updates may not change fields other than "
                "`minAvailable`, `tasks[*].replicas` under spec")
    if (old.spec.queue, old.spec.scheduler_name, old.spec.priority_class_name) \
            != (new.spec.queue, new.spec.scheduler_name,
                new.spec.priority_class_name):
        raise AdmissionError(
            "job updates may not change fields other than "
            "`minAvailable`, `tasks[*].replicas` under spec")


def mutate_job(verb: str, job: Job, cluster,
               opts: AdmissionOptions = None) -> Job:
    if verb != "create":
        return job
    if not job.spec.queue:
        job.spec.queue = opts.default_queue if opts else "default"
    if not job.spec.scheduler_name:
        job.spec.scheduler_name = opts.scheduler_name if opts \
            else "volcano"
    for i, task in enumerate(job.spec.tasks):
        if not task.name:
            task.name = f"task-{i}"
    if job.spec.min_available == 0:
        job.spec.min_available = sum(t.replicas for t in job.spec.tasks)
    return job


def register() -> None:
    # mutation runs before validation, like the reference's webhook ordering
    register_admission_service(AdmissionService(
        path="/jobs/mutate", kind="jobs", verbs=["create"], func=mutate_job))
    register_admission_service(AdmissionService(
        path="/jobs/validate", kind="jobs", verbs=["create", "update"],
        func=validate_job))
