"""The session open's snapshot: the median a traced cycle of the
program's ``vc.open.snapshot`` span (the cache's lock and the clone of its
jobs and nodes)."""

from benchmark.spans import cycle_median


def read(run):
    return cycle_median("vc.open.snapshot")
