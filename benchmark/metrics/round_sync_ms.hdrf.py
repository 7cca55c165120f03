"""The solve's host syncs: the median a traced cycle of the sum of the
program's ``vc.sync`` spans inside its ``vc.dispatch`` (each device-to-host
read of the round solve: the host waits there for the device)."""

from benchmark.spans import cycle_median


def read(run):
    return cycle_median("vc.sync", inside="vc.dispatch")
