"""The device's idle share of the traced cycles: 1 less the union of the
kernel, memcpy and memset intervals over the traced wall time (first
intake to the last run_once's end)."""

from benchmark.readers import trace_value


def read(run):
    busy = trace_value(run, "busy_s")
    window = trace_value(run, "window_s")
    if not busy or not window:
        return None
    return 100.0 * (1.0 - busy / window)
