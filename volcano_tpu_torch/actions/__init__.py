"""Actions (reference pkg/scheduler/actions): the three the default conf
runs. preempt/reclaim (ROADMAP A6) and reschedule/elect/reserve (A8) are
not part of this package yet."""

from ..framework import register_action
from .allocate import AllocateAction  # noqa: F401
from .backfill import BackfillAction  # noqa: F401
from .enqueue import EnqueueAction  # noqa: F401


def register_all() -> None:
    register_action(EnqueueAction())
    register_action(AllocateAction())
    register_action(BackfillAction())


register_all()
