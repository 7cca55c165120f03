"""Order, flatten and pack: the median a cycle of ``flatten_ms`` (which
covers the ordering pass, ``order_ms``, as well) + ``pack_ms`` +
``delta_plan_ms`` (the arena's delta)."""

from benchmark.readers import timing_median


def read(run):
    return timing_median(run, "flatten_ms", "pack_ms", "delta_plan_ms")
