"""Transient-failure classification + one-shot retry for device dispatch.

A dispatch can fail in two distinct ways: *transient* transport hiccups —
a half-closed socket, a dropped connection, a deadline — that succeed when
simply re-sent, and *real* device faults that must count against the
circuit breaker (and, on a CPU arena, degrade to the host oracle).

``retry_transient`` gives dispatch call sites one cheap re-send for the
first kind only; anything else (and a second transient failure) raises to
the caller's breaker/fallback handling.

A CUDA error is never transient: the CUDA context is sticky once a kernel
faults, so a re-send fails the same way or, worse, runs on a broken
context. ``is_transient`` therefore answers False for any exception that
names a CUDA error, even one whose text carries a transport marker ("the
launch timed out and was terminated").
"""

from __future__ import annotations

import logging
import time
from typing import Callable, TypeVar

log = logging.getLogger(__name__)

T = TypeVar("T")

#: substrings identifying a retriable transport failure (exception type
#: name or message); deliberately conservative — an unknown error must
#: reach the breaker, not loop here
TRANSIENT_MARKERS = (
    "remote_compile", "read body", "connection", "Connection", "socket",
    "UNAVAILABLE", "DEADLINE", "timed out", "timeout", "closed",
)

#: substrings that mark a CUDA error, which is never retried
CUDA_ERROR_MARKERS = ("CUDA error", "AcceleratorError")


def is_transient(exc: BaseException) -> bool:
    msg = f"{type(exc).__name__}: {exc}"
    if any(m in msg for m in CUDA_ERROR_MARKERS):
        return False
    return any(m in msg for m in TRANSIENT_MARKERS)


def retry_transient(fn: Callable[[], T], retries: int = 1,
                    delay_s: float = 0.2, what: str = "dispatch") -> T:
    """Run ``fn``; re-run it up to ``retries`` times when it fails with a
    transient transport error. Non-transient errors (and the final
    transient one) propagate unchanged so breaker accounting still sees
    them."""
    attempt = 0
    while True:
        try:
            return fn()
        except KeyboardInterrupt:
            raise
        except Exception as e:  # noqa: BLE001 — classified below
            if attempt >= retries or not is_transient(e):
                raise
            attempt += 1
            log.warning("%s failed with a transient transport error "
                        "(attempt %d/%d, retrying in %.1fs): %s",
                        what, attempt, retries + 1, delay_s,
                        str(e).splitlines()[0][:200])
            time.sleep(delay_s)
