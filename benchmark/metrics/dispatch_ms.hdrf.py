"""The solve's dispatch: the median a cycle of the allocate action's
``dispatch_ms`` (the round solve, hdrf's rank and cap loops inside it)."""

from benchmark.readers import timing_median


def read(run):
    return timing_median(run, "dispatch_ms")
