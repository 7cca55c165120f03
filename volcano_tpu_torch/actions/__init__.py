"""Actions (reference pkg/scheduler/actions): enqueue, allocate, preempt,
reclaim and backfill. reschedule/elect/reserve (ROADMAP A8) are not part
of this package yet."""

from ..framework import register_action
from .allocate import AllocateAction  # noqa: F401
from .backfill import BackfillAction  # noqa: F401
from .enqueue import EnqueueAction  # noqa: F401
from .preempt import PreemptAction  # noqa: F401
from .reclaim import ReclaimAction  # noqa: F401


def register_all() -> None:
    register_action(EnqueueAction())
    register_action(AllocateAction())
    register_action(PreemptAction())
    register_action(ReclaimAction())
    register_action(BackfillAction())


register_all()
