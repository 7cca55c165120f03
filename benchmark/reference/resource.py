"""Resource arithmetic of the scheduler's control plane, in plain Python.

Volcano keeps resources as (milli-cpu, memory bytes, named scalars in
milli-units) in float64 and compares them with per-dimension thresholds
(resource_info.go). The fair-share plugins (proportion's water fill, the
drf hierarchy) decide queue order with these rules, so the reference
repeats them operation for operation: the same float64 sums in the same
order give the same shares, and the same shares the same order.
"""

from __future__ import annotations

from typing import Dict, Optional

MIN_MILLI_CPU = 10.0
MIN_MEMORY = 1.0
MIN_MILLI_SCALAR = 10.0

_GI = float(2 ** 30)


def parse_request(req: Dict[str, object]) -> "Res":
    """A container request as the scheduler reads it: cpu in cores (or
    "250m"), memory as "<n>Gi", every other name a scalar counted in
    milli-units; "pods" is the node's pod limit, not a resource."""
    r = Res()
    for name, q in req.items():
        s = str(q)
        if name == "cpu":
            r.cpu += float(s[:-1]) if s.endswith("m") else float(s) * 1000.0
        elif name == "memory":
            if not s.endswith("Gi"):
                raise ValueError(f"memory {s!r}: the reference reads Gi only")
            r.mem += float(s[:-2]) * _GI
        elif name == "pods":
            continue
        else:
            r.sc[name] = r.sc.get(name, 0.0) + float(s) * 1000.0
    return r


class Res:
    """cpu (milli), mem (bytes), sc {name: milli}: the arithmetic of the
    scheduler's Resource, in the same order of operations."""

    __slots__ = ("cpu", "mem", "sc")

    def __init__(self, cpu: float = 0.0, mem: float = 0.0,
                 sc: Optional[Dict[str, float]] = None):
        self.cpu = float(cpu)
        self.mem = float(mem)
        self.sc: Dict[str, float] = dict(sc) if sc else {}

    def clone(self) -> "Res":
        return Res(self.cpu, self.mem, self.sc)

    def get(self, name: str) -> float:
        if name == "cpu":
            return self.cpu
        if name == "memory":
            return self.mem
        return self.sc.get(name, 0.0)

    def names(self):
        return ["cpu", "memory"] + list(self.sc)

    def add(self, rr: "Res") -> "Res":
        self.cpu += rr.cpu
        self.mem += rr.mem
        for k, v in rr.sc.items():
            self.sc[k] = self.sc.get(k, 0.0) + v
        return self

    def sub(self, rr: "Res") -> "Res":
        if not rr.less_equal(self):
            raise ValueError("resource is not sufficient")
        self.cpu -= rr.cpu
        self.mem -= rr.mem
        for k, v in rr.sc.items():
            self.sc[k] = self.sc.get(k, 0.0) - v
        return self

    def multi(self, ratio: float) -> "Res":
        self.cpu *= ratio
        self.mem *= ratio
        for k in self.sc:
            self.sc[k] *= ratio
        return self

    def is_empty(self) -> bool:
        if not (self.cpu < MIN_MILLI_CPU and self.mem < MIN_MEMORY):
            return False
        return all(v < MIN_MILLI_SCALAR for v in self.sc.values())

    def _paired(self, rr: "Res"):
        yield ("cpu", self.cpu, rr.cpu)
        yield ("memory", self.mem, rr.mem)
        for n in sorted(set(self.sc) | set(rr.sc)):
            yield (n, self.sc.get(n, 0.0), rr.sc.get(n, 0.0))

    def diff(self, rr: "Res"):
        """(increased, decreased) against rr, dimension by dimension."""
        inc, dec = Res(), Res()
        for name, lv, rv in self._paired(rr):
            target, v = (inc, lv - rv) if lv > rv else (dec, rv - lv)
            if name == "cpu":
                target.cpu = v
            elif name == "memory":
                target.mem = v
            else:
                target.sc[name] = v
        return inc, dec

    def less(self, rr: "Res") -> bool:
        if not self.cpu < rr.cpu or not self.mem < rr.mem:
            return False
        if not self.sc:
            return all(v > MIN_MILLI_SCALAR for v in rr.sc.values())
        if not rr.sc:
            return False
        return all(v < rr.sc.get(k, 0.0) for k, v in self.sc.items())

    def less_equal(self, rr: "Res") -> bool:
        if self.cpu >= rr.cpu and abs(self.cpu - rr.cpu) >= MIN_MILLI_CPU:
            return False
        if self.mem >= rr.mem and abs(self.mem - rr.mem) >= MIN_MEMORY:
            return False
        for k, v in self.sc.items():
            if v <= MIN_MILLI_SCALAR:
                continue
            r = rr.sc.get(k, 0.0)
            if v >= r and abs(v - r) >= MIN_MILLI_SCALAR:
                return False
        return True


def min_res(l: Res, r: Res) -> Res:
    """Dimension-wise minimum over l's dimensions (proportion's)."""
    out = Res(min(l.cpu, r.cpu), min(l.mem, r.mem))
    for k, v in l.sc.items():
        out.sc[k] = min(v, r.sc.get(k, 0.0))
    return out


def share(l: float, r: float) -> float:
    if r == 0:
        return 0.0 if l == 0 else 1.0
    return l / r


def dominant_share(alloc: Res, total: Res) -> float:
    """The largest of alloc's shares of total over total's dimensions."""
    res = 0.0
    for rn in total.names():
        s = share(alloc.get(rn), total.get(rn))
        if s > res:
            res = s
    return res
