"""Store and cache intake: the median a cycle of the host time that the
cycle's completions and submissions take through the store's writes and
the cache's watch handlers (benchmark's clock, intake start to run_once)."""

import statistics


def read(run):
    vals = [(c.t_start - c.t_intake) * 1e3 for c in run.cycles]
    return statistics.median(vals) if vals else None
