"""What the metric readers (``metrics/<name>.py``) share: the run's data
and a few reductions over it."""

from __future__ import annotations

import statistics
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


@dataclass
class RunData:
    """One run, as the readers see it. ``cycles``: the window's cycle
    records (world.Cycle); ``binds``: (cycle, "ns/pod", node, t) of the
    window's binds; ``evictions``: (cycle, "ns/pod", reason, t) of the
    window's evictions; ``submit_t``: gang -> when it was handed to the
    store; ``trace``: the traced window's summary (``trace.summarize``) or
    None."""

    cell: str
    window_s: float
    setup_s: float
    cycles: list
    binds: list
    submit_t: Dict[str, float]
    trace: Optional[dict] = None
    evictions: list = field(default_factory=list)


def timing_median(run: RunData, *keys: str) -> Optional[float]:
    """The median over the window's cycles of the sum of these
    ``last_cycle_timing`` keys (cycles that lack one are left out)."""
    vals = [sum(c.timing[k] for k in keys) for c in run.cycles
            if all(k in c.timing for k in keys)]
    return statistics.median(vals) if vals else None


def percentile(vals: List[float], q: float) -> Optional[float]:
    return float(np.percentile(np.asarray(vals, np.float64), q)) \
        if vals else None


def trace_value(run: RunData, key: str) -> Optional[float]:
    return None if not run.trace else run.trace.get(key)
