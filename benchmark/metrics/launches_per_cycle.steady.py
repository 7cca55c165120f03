"""Kernel launches a cycle: the kernel events of the traced cycles (one
each), less the shape recorder's own, over the traced cycles (the
workload file's ``trace_cycles``)."""

from benchmark.readers import trace_value


def read(run):
    n = trace_value(run, "launches")
    cycles = trace_value(run, "cycles")
    return n / cycles if n and cycles else None
