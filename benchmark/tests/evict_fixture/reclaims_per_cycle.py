"""Pods evicted by reclaim a window cycle."""


def read(run):
    n = sum(r[2] == "reclaim" for r in run.evictions)
    return n / len(run.cycles) if run.cycles else None
