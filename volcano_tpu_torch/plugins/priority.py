"""Priority plugin (reference plugins/priority/priority.go:43-107)."""

from __future__ import annotations

from ..framework import Plugin


class PriorityPlugin(Plugin):
    def __init__(self, arguments=None):
        self.arguments = arguments or {}

    def name(self) -> str:
        return "priority"

    def on_session_open(self, ssn) -> None:
        def task_order_fn(l, r):
            if l.priority == r.priority:
                return 0
            return -1 if l.priority > r.priority else 1

        ssn.add_task_order_fn(self.name(), task_order_fn)
        ssn.add_order_key_fn("task_order_fns", self.name(),
                             lambda t: -t.priority)

        def job_order_fn(l, r):
            if l.priority == r.priority:
                return 0
            return -1 if l.priority > r.priority else 1

        ssn.add_job_order_fn(self.name(), job_order_fn)
        ssn.add_order_key_fn("job_order_fns", self.name(),
                             lambda j: -j.priority)
        # JobInfo.priority is resolved from the priority-class table at
        # every snapshot WITHOUT bumping the job's version, so the key is
        # not a pure function of the job clone: declare the table as the
        # key's context so cached orders go stale when a class is edited.
        # (Task priority needs no context — pods carry their admission-
        # resolved value.)
        cache = getattr(ssn, "cache", None)

        def _pclass_context():
            pcs = getattr(cache, "priority_classes", None) or {}
            return (getattr(cache, "default_priority", 0),
                    tuple(sorted((n, getattr(pc, "value", 0))
                                 for n, pc in pcs.items())))

        ssn.add_order_key_context_fn("job_order_fns", self.name(),
                                     _pclass_context)

        def preemptable_fn(preemptor, preemptees):
            """Victims must belong to strictly lower-priority jobs."""
            p_job = ssn.jobs.get(preemptor.job)
            if p_job is None:
                return []
            victims = []
            for preemptee in preemptees:
                job = ssn.jobs.get(preemptee.job)
                if job is not None and job.priority < p_job.priority:
                    victims.append(preemptee)
            return victims

        ssn.add_preemptable_fn(self.name(), preemptable_fn)

    def on_session_close(self, ssn) -> None:
        pass
