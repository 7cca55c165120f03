"""The store's writes: the program's ``vc.store.write`` spans of the
traced window (the create, update or delete with the watch handlers it
runs) over its traced cycles."""

from benchmark.spans import window_mean


def read(run):
    return window_mean("vc.store.write")
