"""Session event handlers (reference framework/event.go:23-32).

Stateful plugins (drf/proportion/predicates) register Allocate/Deallocate
callbacks so their shares stay incrementally consistent with every
assign/unassign inside a session.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from ..api import TaskInfo


@dataclass
class Event:
    task: TaskInfo


@dataclass
class EventHandler:
    allocate_func: Optional[Callable[[Event], None]] = None
    deallocate_func: Optional[Callable[[Event], None]] = None
    # optional bulk form: handlers whose per-task updates are additive
    # (drf/proportion share accounting) can process a whole job's
    # assignments in one call; the session falls back to the per-task fn
    # when absent. Used by the solver-mode replay, where firing 10k
    # individual events dominated the cycle profile. (No deallocate
    # counterpart: deferred statements fire nothing on discard.)
    batch_allocate_func: Optional[Callable[[list], None]] = None
