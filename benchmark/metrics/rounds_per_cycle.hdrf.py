"""Admission rounds a cycle: the median a traced cycle of the number of
the program's ``vc.round`` spans inside its ``vc.dispatch`` (one a pass of
the round solve's loop)."""

from benchmark.spans import cycle_median


def read(run):
    return cycle_median("vc.round", inside="vc.dispatch", count=True)
