"""Scheduler utilities (reference pkg/scheduler/util)."""

from .assert_util import AssertionFailed, assert_, assertf  # noqa: F401
from .leader_election import (  # noqa: F401
    LEASE_DURATION, RENEW_DEADLINE, RETRY_PERIOD, LeaderElector, Lease,
    LeaseLock,
)
from .priority_queue import KeySortedQueue, PriorityQueue  # noqa: F401
from .scheduler_helper import (  # noqa: F401
    NodeSampler, ResourceReservation, reservation, validate_victims,
)
