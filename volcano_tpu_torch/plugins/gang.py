"""Gang plugin (reference plugins/gang/gang.go:50-194)."""

from __future__ import annotations

from ..api import TaskStatus
from ..framework import Plugin, ValidateResult
from ..metrics import metrics
from ..models import (
    NOT_ENOUGH_PODS_REASON, NOT_ENOUGH_RESOURCES_REASON,
    POD_GROUP_READY_REASON, POD_GROUP_SCHEDULED_TYPE,
    POD_GROUP_UNSCHEDULABLE_TYPE, PodGroupCondition,
)
from ..api.unschedule_info import FitErrors


class GangPlugin(Plugin):
    def __init__(self, arguments=None):
        self.arguments = arguments or {}

    def name(self) -> str:
        return "gang"

    def on_session_open(self, ssn) -> None:
        def valid_job_fn(job):
            vtn = job.valid_task_num()
            if vtn < job.min_available:
                return ValidateResult(
                    False, NOT_ENOUGH_PODS_REASON,
                    f"Not enough valid tasks for gang-scheduling, "
                    f"valid: {vtn}, min: {job.min_available}")
            return None

        ssn.add_job_valid_fn(self.name(), valid_job_fn)

        def preemptable_fn(preemptor, preemptees):
            """Victims only from jobs of strictly lower priority."""
            p_job = ssn.jobs.get(preemptor.job)
            victims = []
            for preemptee in preemptees:
                job = ssn.jobs.get(preemptee.job)
                if p_job is not None and job is not None \
                        and p_job.priority > job.priority:
                    victims.append(preemptee)
            return victims

        ssn.add_preemptable_fn(self.name(), preemptable_fn)
        ssn.add_reclaimable_fn(self.name(), preemptable_fn)

        def job_order_fn(l, r):
            """Unready jobs sort first."""
            l_ready, r_ready = l.ready(), r.ready()
            if l_ready and r_ready:
                return 0
            if l_ready:
                return 1
            if r_ready:
                return -1
            return 0

        ssn.add_job_order_fn(self.name(), job_order_fn)
        # key form of the comparator: unready (False) sorts before ready
        ssn.add_order_key_fn("job_order_fns", self.name(),
                             lambda j: j.ready())
        ssn.add_job_ready_fn(self.name(), lambda job: job.ready())
        ssn.add_job_pipelined_fn(self.name(), lambda job: job.pipelined())

    def on_session_close(self, ssn) -> None:
        unschedulable_count = 0
        for job in ssn.jobs.values():
            if job.pod_group is None:
                continue
            if not job.ready():
                unready = job.min_available - job.ready_task_num()
                msg = (f"{unready}/{len(job.tasks)} tasks in gang "
                       f"unschedulable: {job.fit_message()}")
                unschedulable_count += 1
                metrics.unschedule_task_count.set(
                    max(unready, 0), {"job_id": job.name})
                metrics.job_retry_counts.inc(labels={"job_id": job.name})
                ssn.update_pod_group_condition(job, PodGroupCondition(
                    type=POD_GROUP_UNSCHEDULABLE_TYPE, status="True",
                    transition_id=ssn.uid,
                    reason=NOT_ENOUGH_RESOURCES_REASON, message=msg))
                # allocated tasks follow the job fit error
                for task in job.task_status_index.get(
                        TaskStatus.ALLOCATED, {}).values():
                    if task.key not in job.nodes_fit_errors:
                        fe = FitErrors()
                        fe.set_error(msg)
                        job.nodes_fit_errors[task.key] = fe
            else:
                # steady-state fast path: when the identical Scheduled
                # condition is already posted, skip the re-post — only
                # transition_id/time would change, which the status diff
                # rule (PodGroupStatus.fingerprint) treats as
                # insignificant anyway. At 1k ready jobs per cycle the
                # per-job condition object churn was measurable.
                if not any(c.type == POD_GROUP_SCHEDULED_TYPE
                           and c.status == "True"
                           and c.reason == POD_GROUP_READY_REASON
                           and not c.message
                           for c in job.pod_group.status.conditions):
                    ssn.update_pod_group_condition(job, PodGroupCondition(
                        type=POD_GROUP_SCHEDULED_TYPE, status="True",
                        transition_id=ssn.uid,
                        reason=POD_GROUP_READY_REASON))
        metrics.unschedule_job_count.set(unschedulable_count)
