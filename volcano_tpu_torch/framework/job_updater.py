"""JobUpdater: push PodGroup status back on session close.

Reference framework/job_updater.go:16-108 fans out over 16 workers with a
skip-if-unchanged dedup. The fan-out matters when status writes go to a
remote control plane (each write is a network round trip); against the
in-memory store it degrades gracefully to near-sequential behind the
store's lock.
"""

from __future__ import annotations

import logging
from concurrent.futures import ThreadPoolExecutor

from ..metrics import tracing
from .session import job_status

log = logging.getLogger(__name__)

#: jobUpdaterWorker (job_updater.go:17)
JOB_UPDATER_WORKERS = 16

#: lazily created persistent pool shared by all sessions (daemon threads;
#: creating/joining 16 threads per session close would be pure churn)
_POOL = None


def _shared_pool() -> ThreadPoolExecutor:
    global _POOL
    if _POOL is None:
        _POOL = ThreadPoolExecutor(max_workers=JOB_UPDATER_WORKERS,
                                   thread_name_prefix="job-updater")
    return _POOL


# status comparisons use PodGroupStatus.fingerprint() tuples: equal
# fingerprints = no significant change (transition_id/time excluded)


class JobUpdater:
    def __init__(self, ssn, workers: int = JOB_UPDATER_WORKERS):
        self.ssn = ssn
        self.workers = workers

    def update_all(self) -> None:
        jobs = [j for j in self.ssn.jobs.values() if self._dirty(j)]
        # the fan-out only pays for many jobs against a slow control plane;
        # small sessions stay sequential and deterministic
        if len(jobs) <= 4 or self.workers <= 1:
            for job in jobs:
                self.update_job(job)
            return
        # consume the iterator so worker exceptions surface in the logs
        # via update_job's own try/except, not silently in futures; the
        # workers' spans name the closing session's as their parent
        parent = tracing.current()

        def update(job) -> None:
            with tracing.adopt(parent):
                self.update_job(job)

        list(_shared_pool().map(update, jobs))

    def _dirty(self, job) -> bool:
        """Skip-if-untouched: a READY job whose tasks (since the last
        successful status write — not merely since session open, so
        informer-driven changes between cycles count), conditions, fit
        errors and phase are all unchanged recomputes to an identical
        status, so neither the recompute nor the (diffed-away) write can
        have an effect. Unready jobs always process: update_job_status's
        record_job_status_event posts Unschedulable pod conditions for
        them unconditionally (cache.go:791-826), even when the cycle never
        touched the job (e.g. its queue stayed overused). The reference
        reaches the same end state by diffing before every write
        (job_updater.go:95-100); tracking dirtiness against the
        last-written version also skips the recompute, which dominates at
        thousands of untouched running jobs per cycle."""
        ssn = self.ssn
        if job.uid in ssn._conditions_touched or job.nodes_fit_errors:
            return True
        written = getattr(ssn.cache, "updater_versions", None)
        if written is None or written.get(job.uid) != job.flat_version:
            return True
        old = ssn.pod_group_status.get(job.uid)
        if (old is None or job.pod_group is None
                or old[0] != job.pod_group.status.phase):
            return True
        return not job.ready()

    def update_job(self, job) -> None:
        if job.pod_group is None:
            return
        new = job_status(self.ssn, job)
        old = self.ssn.pod_group_status.get(job.uid)
        update_pg = old is None or old != new.fingerprint()
        try:
            self.ssn.cache.update_job_status(job, update_pg)
        except Exception:
            log.exception("failed to update job status for %s", job.uid)
            return
        # record the version this write reflects: _dirty() compares the
        # next snapshot's version against it, so changes landing between
        # sessions (informer pod updates) re-dirty the job
        versions = getattr(self.ssn.cache, "updater_versions", None)
        if versions is not None:
            versions[job.uid] = job.flat_version
