"""What the readers of the program's own spans share: the spans the port
recorded (``volcano_tpu_torch.metrics.tracing``), grouped by the cycle
they belong to.

The port records spans only while a profiler is active, which in a run is
the traced window alone (``trace.run_traced``), so what it holds when the
readers run is the traced window's spans. A traced cycle is one
``vc.cycle`` span. A port without the recorder, or a recorder that
dropped spans, gives nothing, and the readers return None.
"""

from __future__ import annotations

import statistics
from typing import Optional


class Traced:
    """The recorded spans: ``cycles`` the ids of the ``vc.cycle`` spans,
    ``spans`` every span."""

    def __init__(self, spans):
        self.spans = spans
        self.by_id = {s.id: s for s in spans}
        self.cycles = [s.id for s in spans if s.name == "vc.cycle"]

    def inside(self, s, name: str) -> bool:
        """Whether a span named ``name`` is an ancestor of ``s``."""
        p = self.by_id.get(s.parent)
        while p is not None:
            if p.name == name:
                return True
            p = self.by_id.get(p.parent)
        return False


def traced() -> Optional[Traced]:
    try:
        from volcano_tpu_torch.metrics import tracing
    except ImportError:
        return None
    spans = tracing.spans()
    if tracing.dropped():
        return None
    t = Traced(spans)
    return t if t.cycles else None


def cycle_median(name: str, inside: Optional[str] = None,
                 count: bool = False) -> Optional[float]:
    """The median over the traced cycles of the milliseconds of the
    ``name`` spans in each (their number, with ``count``), of those with
    a span named ``inside`` above them where that is given."""
    t = traced()
    if t is None:
        return None
    per = dict.fromkeys(t.cycles, 0.0)
    for s in t.spans:
        if s.name == name and s.cycle in per \
                and (inside is None or t.inside(s, inside)):
            per[s.cycle] += 1.0 if count else s.ms
    return statistics.median(per.values())


def window_mean(name: str) -> Optional[float]:
    """The milliseconds of every ``name`` span of the traced window (one
    inside another of the name counted once, in the outer one) over the
    number of traced cycles: work between cycles counts towards the cycle
    it precedes or follows."""
    t = traced()
    if t is None:
        return None
    total = sum(s.ms for s in t.spans
                if s.name == name and not t.inside(s, name))
    return total / len(t.cycles)
