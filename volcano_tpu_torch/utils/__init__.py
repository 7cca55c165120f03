"""Scheduler utilities (reference pkg/scheduler/util)."""

from .assert_util import AssertionFailed, assert_, assertf  # noqa: F401
from .priority_queue import KeySortedQueue, PriorityQueue  # noqa: F401
from .scheduler_helper import (  # noqa: F401
    NodeSampler, ResourceReservation, reservation, validate_victims,
)
