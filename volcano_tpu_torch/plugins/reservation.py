"""Reservation plugin (reference plugins/reservation/reservation.go:44-141).

Target job = highest priority then longest-waiting Pending job; reserved
node = unlocked node with maximum idle.
"""

from __future__ import annotations

import time

from ..framework import Plugin
from ..utils.scheduler_helper import reservation


class ReservationPlugin(Plugin):
    def __init__(self, arguments=None):
        self.arguments = arguments or {}

    def name(self) -> str:
        return "reservation"

    def on_session_open(self, ssn) -> None:
        def target_job_fn(jobs):
            if not jobs:
                return None
            highest = max(j.priority for j in jobs)
            candidates = [j for j in jobs if j.priority == highest]
            # longest waiting = earliest schedule start
            def waited(job):
                start = getattr(job, "schedule_start_timestamp", None) \
                    or job.creation_timestamp or time.time()
                return time.time() - start
            return max(candidates, key=waited)

        ssn.add_target_job_fn(self.name(), target_job_fn)

        def reserved_nodes_fn():
            best = None
            for node in ssn.nodes.values():
                if node.name in reservation.locked_nodes:
                    continue
                if best is None or best.idle.less_equal(node.idle):
                    best = node
            if best is not None:
                reservation.locked_nodes[best.name] = best

        ssn.add_reserved_nodes_fn(self.name(), reserved_nodes_fn)

    def on_session_close(self, ssn) -> None:
        pass
