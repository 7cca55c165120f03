"""Reserve action (reference actions/reserve/reserve.go:27-50): lock nodes
for the elected target job until it becomes ready."""

from __future__ import annotations

from ..framework import Action
from ..utils.scheduler_helper import reservation


class ReserveAction(Action):
    def name(self) -> str:
        return "reserve"

    def execute(self, ssn) -> None:
        if reservation.target_job is None:
            return
        target = ssn.jobs.get(reservation.target_job.uid)
        if target is None:
            reservation.reset()
            return
        reservation.target_job = target
        if not target.ready():
            ssn.reserved_nodes()
        else:
            reservation.reset()
