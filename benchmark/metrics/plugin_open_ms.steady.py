"""The session open's plugins: the median a traced cycle of the sum of
the program's ``vc.open.plugin`` spans (each plugin's on_session_open)."""

from benchmark.spans import cycle_median


def read(run):
    return cycle_median("vc.open.plugin")
