"""Queue controller (reference pkg/controllers/queue).

Aggregates podgroup phase counts into QueueStatus and runs the
{Open, Closed, Closing, Unknown} state machine driven by spec.state and
Open/CloseQueue commands.
"""

from __future__ import annotations

import logging
from typing import List, Optional

from ..client.store import ClusterStore, NotFoundError
from ..models import Action, PodGroupPhase, Queue, QueueState
from .framework import Controller, ControllerOption

log = logging.getLogger(__name__)


class QueueController(Controller):
    def __init__(self):
        self.cluster: Optional[ClusterStore] = None
        self.queue: List[str] = []  # queue names to sync

    def name(self) -> str:
        return "queue-controller"

    def initialize(self, opt: ControllerOption) -> None:
        self.default_queue = opt.default_queue
        self.cluster = opt.cluster

    def run(self) -> None:
        self.cluster.watch("queues", self._on_queue)
        self.cluster.watch("podgroups", self._on_podgroup)
        self.cluster.watch("commands", self._on_command)

    def _on_queue(self, event, queue: Queue, old) -> None:
        if event != "delete":
            self.queue.append(queue.name)

    def _on_podgroup(self, event, pg, old) -> None:
        queue = pg.spec.queue or self.default_queue
        self.queue.append(queue)

    def _on_command(self, event, cmd, old) -> None:
        if event != "add":
            return
        target = cmd.target_object or {}
        if target.get("kind") != "Queue":
            return
        try:
            self.cluster.delete("commands", cmd.name, cmd.namespace)
        except NotFoundError:
            pass
        queue = self.cluster.try_get("queues", target.get("name", ""))
        if queue is None:
            return
        if cmd.action == Action.OPEN_QUEUE:
            queue.spec.state = QueueState.OPEN
        elif cmd.action == Action.CLOSE_QUEUE:
            queue.spec.state = QueueState.CLOSED
        self.cluster.update("queues", queue)
        self.queue.append(queue.name)

    def process_all(self, max_rounds: int = 4) -> None:
        for _ in range(max_rounds):
            names, self.queue = list(dict.fromkeys(self.queue)), []
            if not names:
                return
            for name in names:
                try:
                    self.sync_queue(name)
                except Exception:
                    log.exception("failed to sync queue %s", name)

    def sync_queue(self, name: str) -> None:
        """queue_controller_action.go:35-84 + state machine."""
        queue = self.cluster.try_get("queues", name)
        if queue is None:
            return
        counts = {"pending": 0, "running": 0, "unknown": 0, "inqueue": 0}
        pgs = self.cluster.list("podgroups")
        has_pgs = False
        for pg in pgs:
            if (pg.spec.queue or self.default_queue) != name:
                continue
            has_pgs = True
            phase = pg.status.phase
            if phase == PodGroupPhase.PENDING:
                counts["pending"] += 1
            elif phase == PodGroupPhase.RUNNING:
                counts["running"] += 1
            elif phase == PodGroupPhase.INQUEUE:
                counts["inqueue"] += 1
            else:
                counts["unknown"] += 1
        desired = queue.spec.state or QueueState.OPEN
        if desired == QueueState.OPEN:
            state = QueueState.OPEN
        elif desired == QueueState.CLOSED:
            # closing while podgroups remain (queue/state machine)
            state = QueueState.CLOSING if has_pgs else QueueState.CLOSED
        else:
            state = QueueState.UNKNOWN

        st = queue.status
        if (st.pending, st.running, st.inqueue, st.unknown, st.state) \
                == (counts["pending"], counts["running"],
                    counts["inqueue"], counts["unknown"], state):
            # no-op sync: writing an identical status would churn the
            # store every controller pass (and re-enqueue this very
            # queue via our own update event — a self-perpetuating write
            # loop), which alone keeps a quiet cluster's event-sourced
            # flatten/ordering from ever reaching their zero-work paths
            return
        st.pending = counts["pending"]
        st.running = counts["running"]
        st.inqueue = counts["inqueue"]
        st.unknown = counts["unknown"]
        st.state = state
        self.cluster.update("queues", queue)
