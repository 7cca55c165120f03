"""The session close: the median a traced cycle of the program's
``vc.close`` span (the plugins' closes and the job updater)."""

from benchmark.spans import cycle_median


def read(run):
    return cycle_median("vc.close")
