"""Pods evicted a window cycle."""


def read(run):
    return len(run.evictions) / len(run.cycles) if run.cycles else None
