"""Elect action (reference actions/elect/elect.go:29-51): pick the target
job for resource reservation."""

from __future__ import annotations

from ..framework import Action
from ..models import PodGroupPhase
from ..utils.scheduler_helper import reservation


class ElectAction(Action):
    def name(self) -> str:
        return "elect"

    def execute(self, ssn) -> None:
        if reservation.target_job is not None:
            return
        pending_jobs = [
            job for job in ssn.jobs.values()
            if job.pod_group.status.phase == PodGroupPhase.PENDING]
        reservation.target_job = ssn.target_job(pending_jobs)
