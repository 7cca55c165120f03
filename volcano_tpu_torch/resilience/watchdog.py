"""Per-action deadline watchdog: a hung action must not hang the loop.

Python cannot preempt a thread, so the containment contract is
best-effort but explicit: with a deadline configured, each scheduling
action runs on a fresh worker thread and the session loop joins it with
a timeout. On breach the watchdog fires a ``faulthandler`` stack dump of
every thread (the post-mortem for *why* it hung goes to stderr, exactly
where an operator's crash tooling collects it) and raises
``ActionTimeout`` to the scheduler, which then

- discards the action's uncommitted statements (session state is rolled
  back to the last transaction boundary),
- marks the action's epoch contained so a zombie thread waking up later
  finds its ``Statement.commit`` turned into a discard
  (framework/statement.py), and
- runs the REMAINING actions of the cycle.

The abandoned thread is daemonic and eventually dies with its blocking
call; until then it may still read session state — the epoch guard is
what keeps it from *writing through* to the cluster. The thread pins its
epoch (``Session.pin_action_epoch``): an action abandoned before it
started never starts, and one abandoned mid-dispatch stops at the device
arena's fence (``PackedDeviceCache.fenced``), whose lock also makes the
next cycle wait for a thread already scattering into the arena. True isolation
needs a process boundary (the solver sidecar provides one for the
biggest hang source, the device dispatch); this watchdog covers the
in-process rest.

Without a deadline the scheduler runs actions inline exactly as before —
the watchdog costs nothing unless asked for.
"""

from __future__ import annotations

import faulthandler
import logging
import sys
import threading
from typing import Callable

log = logging.getLogger(__name__)


class ActionTimeout(Exception):
    """An action exceeded its deadline and was contained."""


class ActionContained(Exception):
    """The thread of a contained action reached a fence (the device
    arena): it stops there, touching nothing."""


class ActionWatchdog:
    def __init__(self, deadline_s: float, dump: bool = True):
        self.deadline_s = float(deadline_s)
        self.dump = dump
        #: contained runs whose threads may still be alive (observability)
        self.abandoned = 0

    def run(self, name: str, fn: Callable[[], None]) -> None:
        """Run ``fn`` under the deadline. Re-raises ``fn``'s own exception;
        raises ActionTimeout (after the stack dump) on breach."""
        box: dict = {}

        def runner():
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 — relayed to caller
                box["exc"] = e

        t = threading.Thread(target=runner, name=f"action-{name}",
                             daemon=True)
        t.start()
        t.join(self.deadline_s)
        if t.is_alive():
            self.abandoned += 1
            if self.dump:
                try:
                    faulthandler.dump_traceback(all_threads=True,
                                                file=sys.stderr)
                except Exception:  # noqa: BLE001 — the dump is best-effort
                    log.exception("faulthandler dump failed")
            raise ActionTimeout(
                f"action {name!r} exceeded its {self.deadline_s:.1f}s "
                "deadline; thread abandoned and statements contained")
        exc = box.get("exc")
        if exc is not None:
            raise exc
