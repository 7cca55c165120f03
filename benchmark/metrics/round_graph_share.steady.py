"""The solve's rounds replayed from a CUDA graph: the median a traced cycle
of the share of the program's ``vc.round`` spans inside its
``vc.dispatch`` whose ``graph`` attribute is "replay" (the round ran as
one replay of a graph kept across solves; the others ran eagerly or
captured it). Nothing where the round spans carry no ``graph``
attribute: a program that records none."""

import statistics

from benchmark.spans import traced


def read(run):
    t = traced()
    if t is None:
        return None
    cycles = set(t.cycles)
    per = {}
    for s in t.spans:
        if s.name == "vc.round" and "graph" in s.attrs \
                and s.cycle in cycles and t.inside(s, "vc.dispatch"):
            n = per.setdefault(s.cycle, [0, 0])
            n[0] += s.attrs["graph"] == "replay"
            n[1] += 1
    if not per:
        return None
    return statistics.median(r / n for r, n in per.values())
