"""Env-gated debug assertions (reference pkg/scheduler/util/assert/assert.go).

PANIC_ON_ERROR=false demotes assertion failures to logged errors with a
stack trace; the default (like the reference) raises.
"""

from __future__ import annotations

import logging
import os
import traceback

ENV_PANIC_ON_ERROR = "PANIC_ON_ERROR"

log = logging.getLogger(__name__)

_panic_on_error = os.environ.get(ENV_PANIC_ON_ERROR) != "false"


class AssertionFailed(AssertionError):
    pass


def assert_(condition: bool, message: str) -> None:
    if condition:
        return
    if _panic_on_error:
        raise AssertionFailed(message)
    log.error("%s, %s", message, "".join(traceback.format_stack()))


def assertf(condition: bool, fmt: str, *args) -> None:
    if not condition:
        assert_(condition, fmt % args if args else fmt)
