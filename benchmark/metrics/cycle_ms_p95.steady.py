"""The scheduler cycle: the 95th percentile over the window's cycles of
the host time around ``run_once`` (it ends in a host read)."""

from benchmark.readers import percentile


def read(run):
    return percentile([(c.t_end - c.t_start) * 1e3 for c in run.cycles], 95)
