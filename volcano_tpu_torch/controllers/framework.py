"""Controller framework (reference pkg/controllers/framework)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from ..client.store import ClusterStore


@dataclass
class ControllerOption:
    cluster: ClusterStore
    scheduler_name: str = "volcano"
    default_queue: str = "default"
    worker_num: int = 3


class Controller:
    def name(self) -> str:
        raise NotImplementedError

    def initialize(self, opt: ControllerOption) -> None:
        raise NotImplementedError

    def run(self) -> None:
        """Subscribe to watches. Single-threaded: work is drained by
        process_all()."""
        raise NotImplementedError

    def process_all(self) -> None:
        """Drain pending work items (the worker loop of the reference)."""
        raise NotImplementedError


_controllers: Dict[str, Controller] = {}


def register_controller(ctrl: Controller) -> None:
    _controllers[ctrl.name()] = ctrl


def for_each_controller(fn) -> None:
    for ctrl in _controllers.values():
        fn(ctrl)


def get_controller(name: str) -> Optional[Controller]:
    return _controllers.get(name)
