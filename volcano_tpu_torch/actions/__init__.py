"""Actions (reference pkg/scheduler/actions): enqueue, allocate, preempt,
reclaim, backfill, elect and reserve, plus the global rescheduler's
``reschedule`` (reschedule/)."""

from ..framework import register_action
from .allocate import AllocateAction  # noqa: F401
from .backfill import BackfillAction  # noqa: F401
from .elect import ElectAction  # noqa: F401
from .enqueue import EnqueueAction  # noqa: F401
from .preempt import PreemptAction  # noqa: F401
from .reclaim import ReclaimAction  # noqa: F401
from .reserve import ReserveAction  # noqa: F401


def register_all() -> None:
    register_action(EnqueueAction())
    register_action(AllocateAction())
    register_action(PreemptAction())
    register_action(ReclaimAction())
    register_action(BackfillAction())
    register_action(ElectAction())
    register_action(ReserveAction())
    # the global rescheduler lives in its own package (reschedule/) but
    # registers like any other action
    from ..reschedule import RescheduleAction
    register_action(RescheduleAction())


register_all()
