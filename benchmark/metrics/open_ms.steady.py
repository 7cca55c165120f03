"""Session open (snapshot clone, plugin opens): the median a cycle of
``last_cycle_timing["open_ms"]``."""

from benchmark.readers import timing_median


def read(run):
    return timing_median(run, "open_ms")
