"""Backfill action (reference actions/backfill/backfill.go:40-93).

Best-effort tasks (empty launch request) are placed on the first node that
passes predicates, immediately via ssn.allocate (no statement — backfill is
not gang-protected).
"""

from __future__ import annotations

import logging

from ..api import TaskStatus
from ..api.unschedule_info import FitErrors
from ..framework import Action
from ..models import PodGroupPhase

log = logging.getLogger(__name__)


class BackfillAction(Action):
    def name(self) -> str:
        return "backfill"

    def execute(self, ssn) -> None:
        from ..plugins.predicates import PredicateError

        for job in ssn.jobs.values():
            if TaskStatus.PENDING not in job.task_status_index:
                continue  # no pending tasks -> nothing to backfill
            if job.pod_group.status.phase == PodGroupPhase.PENDING:
                continue
            vr = ssn.job_valid(job)
            if vr is not None and not vr.passed:
                continue
            for task in list(job.task_status_index.get(
                    TaskStatus.PENDING, {}).values()):
                if not task.init_resreq.is_empty():
                    continue
                fe = FitErrors()
                allocated = False
                for node in ssn.nodes.values():
                    try:
                        ssn.predicate_fn(task, node)
                    except PredicateError as e:
                        fe.set_node_error(node.name, e.fit_error)
                        continue
                    try:
                        ssn.allocate(task, node.name)
                        allocated = True
                        break
                    except (KeyError, ValueError) as e:
                        log.warning("backfill bind failed for %s on %s: %s",
                                    task.key, node.name, e)
                        continue
                if not allocated:
                    job.nodes_fit_errors[task.key] = fe
