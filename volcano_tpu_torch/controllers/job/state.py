"""Job state machine: 8 states x actions (reference controllers/job/state/).

Each state's execute(action) maps bus Actions onto SyncJob/KillJob calls
with a status-update closure deciding the phase transition.
"""

from __future__ import annotations

from typing import Callable, Optional, Set

from ...models import Action, JobPhase
from ...models.batch import DEFAULT_MAX_RETRY

#: pod phases retained on kill
POD_RETAIN_PHASE_NONE: Set[str] = set()
POD_RETAIN_PHASE_SOFT: Set[str] = {"Succeeded", "Failed"}

UpdateStatusFn = Callable[[object], bool]  # JobStatus -> phase changed?


class State:
    def __init__(self, job_info, controller):
        self.job = job_info
        self.controller = controller  # provides sync_job/kill_job

    def execute(self, action: Action) -> None:
        raise NotImplementedError

    # helpers
    def _kill(self, retain, fn: Optional[UpdateStatusFn]) -> None:
        self.controller.kill_job(self.job, retain, fn)

    def _sync(self, fn: Optional[UpdateStatusFn]) -> None:
        self.controller.sync_job(self.job, fn)


def _total_tasks(job) -> int:
    return sum(t.replicas for t in job.spec.tasks)


class PendingState(State):
    def execute(self, action: Action) -> None:
        if action == Action.RESTART_JOB:
            def fn(status):
                status.retry_count += 1
                status.state.phase = JobPhase.RESTARTING
                return True
            self._kill(POD_RETAIN_PHASE_NONE, fn)
        elif action == Action.ABORT_JOB:
            def fn(status):
                status.state.phase = JobPhase.ABORTING
                return True
            self._kill(POD_RETAIN_PHASE_SOFT, fn)
        elif action == Action.COMPLETE_JOB:
            def fn(status):
                status.state.phase = JobPhase.COMPLETING
                return True
            self._kill(POD_RETAIN_PHASE_SOFT, fn)
        elif action == Action.TERMINATE_JOB:
            def fn(status):
                status.state.phase = JobPhase.TERMINATING
                return True
            self._kill(POD_RETAIN_PHASE_SOFT, fn)
        else:
            def fn(status):
                if self.job.job.spec.min_available <= (
                        status.running + status.succeeded + status.failed):
                    status.state.phase = JobPhase.RUNNING
                    return True
                return False
            self._sync(fn)


class RunningState(State):
    def execute(self, action: Action) -> None:
        if action == Action.RESTART_JOB:
            def fn(status):
                status.state.phase = JobPhase.RESTARTING
                status.retry_count += 1
                return True
            self._kill(POD_RETAIN_PHASE_NONE, fn)
        elif action == Action.ABORT_JOB:
            def fn(status):
                status.state.phase = JobPhase.ABORTING
                return True
            self._kill(POD_RETAIN_PHASE_SOFT, fn)
        elif action == Action.TERMINATE_JOB:
            def fn(status):
                status.state.phase = JobPhase.TERMINATING
                return True
            self._kill(POD_RETAIN_PHASE_SOFT, fn)
        elif action == Action.COMPLETE_JOB:
            def fn(status):
                status.state.phase = JobPhase.COMPLETING
                return True
            self._kill(POD_RETAIN_PHASE_SOFT, fn)
        else:
            def fn(status):
                replicas = _total_tasks(self.job.job)
                if replicas == 0:
                    return False
                if status.succeeded + status.failed == replicas:
                    if status.succeeded >= self.job.job.spec.min_available:
                        status.state.phase = JobPhase.COMPLETED
                    else:
                        status.state.phase = JobPhase.FAILED
                    return True
                return False
            self._sync(fn)


class RestartingState(State):
    def execute(self, action: Action) -> None:
        def fn(status):
            max_retry = self.job.job.spec.max_retry or DEFAULT_MAX_RETRY
            if status.retry_count >= max_retry:
                status.state.phase = JobPhase.FAILED
                return True
            total = _total_tasks(self.job.job)
            if total - status.terminating >= status.min_available:
                status.state.phase = JobPhase.PENDING
                return True
            return False
        self._kill(POD_RETAIN_PHASE_NONE, fn)


class AbortingState(State):
    def execute(self, action: Action) -> None:
        if action == Action.RESUME_JOB:
            def fn(status):
                status.state.phase = JobPhase.RESTARTING
                status.retry_count += 1
                return True
            self._kill(POD_RETAIN_PHASE_SOFT, fn)
        else:
            def fn(status):
                if status.terminating or status.pending or status.running:
                    return False
                status.state.phase = JobPhase.ABORTED
                return True
            self._kill(POD_RETAIN_PHASE_SOFT, fn)


class AbortedState(State):
    def execute(self, action: Action) -> None:
        if action == Action.RESUME_JOB:
            def fn(status):
                status.state.phase = JobPhase.RESTARTING
                status.retry_count += 1
                return True
            self._kill(POD_RETAIN_PHASE_SOFT, fn)
        else:
            self._kill(POD_RETAIN_PHASE_SOFT, None)


class TerminatingState(State):
    def execute(self, action: Action) -> None:
        def fn(status):
            if status.terminating or status.pending or status.running:
                return False
            status.state.phase = JobPhase.TERMINATED
            return True
        self._kill(POD_RETAIN_PHASE_SOFT, fn)


class CompletingState(State):
    def execute(self, action: Action) -> None:
        def fn(status):
            if status.terminating or status.pending or status.running:
                return False
            status.state.phase = JobPhase.COMPLETED
            return True
        self._kill(POD_RETAIN_PHASE_SOFT, fn)


class FinishedState(State):
    def execute(self, action: Action) -> None:
        self._kill(POD_RETAIN_PHASE_SOFT, None)


def new_state(job_info, controller) -> State:
    phase = job_info.job.status.state.phase
    mapping = {
        JobPhase.PENDING: PendingState,
        JobPhase.RUNNING: RunningState,
        JobPhase.RESTARTING: RestartingState,
        JobPhase.TERMINATED: FinishedState,
        JobPhase.COMPLETED: FinishedState,
        JobPhase.FAILED: FinishedState,
        JobPhase.TERMINATING: TerminatingState,
        JobPhase.ABORTING: AbortingState,
        JobPhase.ABORTED: AbortedState,
        JobPhase.COMPLETING: CompletingState,
    }
    cls = mapping.get(phase, PendingState)
    return cls(job_info, controller)
