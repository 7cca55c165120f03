"""The collections between cycles: the program's ``vc.gc`` spans of the
traced window over its traced cycles (a mean: a full collection comes
every 20th cycle)."""

from benchmark.spans import window_mean


def read(run):
    return window_mean("vc.gc")
