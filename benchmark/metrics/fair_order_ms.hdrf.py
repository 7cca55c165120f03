"""The solve's fairness order: the median a traced cycle of the sum of the
program's ``vc.round.order`` spans inside its ``vc.dispatch`` (each round's
drf or hdrf rank and cap and the queue caps, as launched from the host)."""

from benchmark.spans import cycle_median


def read(run):
    return cycle_median("vc.round.order", inside="vc.dispatch")
