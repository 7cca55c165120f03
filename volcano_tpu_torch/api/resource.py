"""Resource algebra for the TPU-native scheduler.

Reimplements the semantics of the reference's resource model
(pkg/scheduler/api/resource_info.go:30-420) in a form designed for array
flattening: every Resource can be projected onto a fixed-width float32 vector
(``to_vector``) whose axes are [milli_cpu, memory, *scalars-in-vocab-order] so
that task x node resource math runs as dense tensor ops on TPU.

Thresholds mirror the reference (resource_info.go:70-72):
  minMilliCPU = 10, minMemory = 1, minMilliScalarResources = 10.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Mapping, Optional

import numpy as np

MIN_MILLI_CPU = 10.0
MIN_MEMORY = 1.0
MIN_MILLI_SCALAR = 10.0

GPU_RESOURCE_NAME = "nvidia.com/gpu"

# Resource-list units understood by parse_quantity (k8s resource.Quantity).
_SUFFIXES = {
    "k": 1e3, "M": 1e6, "G": 1e9, "T": 1e12, "P": 1e15, "E": 1e18,
    "Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40, "Pi": 2**50, "Ei": 2**60,
}


def parse_quantity(q) -> float:
    """Parse a k8s-style quantity ('100m', '2', '1Gi', 1.5) into a float value.

    CPU-style 'm' suffix means milli; binary/decimal suffixes scale bytes.
    """
    if isinstance(q, (int, float)):
        return float(q)
    s = str(q).strip()
    if not s:
        return 0.0
    if s.endswith("m") and s[:-1].replace(".", "", 1).replace("-", "", 1).isdigit():
        return float(s[:-1]) / 1000.0
    for suf in ("Ki", "Mi", "Gi", "Ti", "Pi", "Ei", "k", "M", "G", "T", "P", "E"):
        if s.endswith(suf):
            return float(s[: -len(suf)]) * _SUFFIXES[suf]
    return float(s)


class Resource:
    """Multi-dimensional resource amount.

    milli_cpu is in millicores, memory in bytes, scalars in milli-units
    (mirrors resource_info.go NewResource which calls MilliValue() on scalars).
    ``max_task_num`` is the pods capacity; it is excluded from arithmetic just
    as in the reference (resource_info.go:38-40).
    """

    __slots__ = ("milli_cpu", "memory", "scalars", "max_task_num")

    def __init__(self, milli_cpu: float = 0.0, memory: float = 0.0,
                 scalars: Optional[Dict[str, float]] = None,
                 max_task_num: int = 0):
        self.milli_cpu = float(milli_cpu)
        self.memory = float(memory)
        self.scalars: Dict[str, float] = dict(scalars) if scalars else {}
        self.max_task_num = int(max_task_num)

    # -- constructors -------------------------------------------------------

    @classmethod
    def empty(cls) -> "Resource":
        return cls()

    @classmethod
    def from_resource_list(cls, rl: Mapping[str, object]) -> "Resource":
        """Build from a k8s ResourceList-shaped mapping.

        {'cpu': '2', 'memory': '4Gi', 'pods': 110, 'nvidia.com/gpu': 1}
        Mirrors NewResource (resource_info.go:75-95): cpu -> millicores,
        memory -> bytes, pods -> max_task_num, other scalars -> milli-units.
        """
        r = cls()
        for name, q in rl.items():
            if name == "cpu":
                r.milli_cpu += parse_quantity(q) * 1000.0
            elif name == "memory":
                r.memory += parse_quantity(q)
            elif name == "pods":
                r.max_task_num += int(parse_quantity(q))
            else:
                r.scalars[name] = r.scalars.get(name, 0.0) + parse_quantity(q) * 1000.0
        return r

    def clone(self) -> "Resource":
        r = Resource.__new__(Resource)  # skip __init__'s re-coercions
        r.milli_cpu = self.milli_cpu
        r.memory = self.memory
        r.scalars = dict(self.scalars)
        r.max_task_num = self.max_task_num
        return r

    @classmethod
    def sum_of(cls, items: Iterable["Resource"]) -> "Resource":
        """Sum many Resources with one result object (the bulk replay/bind
        paths aggregate a job's whole wave into a single accounting delta
        instead of a Resource op per task)."""
        r = cls.__new__(cls)
        mc = mem = 0.0
        sc: Dict[str, float] = {}
        for it in items:
            mc += it.milli_cpu
            mem += it.memory
            if it.scalars:
                for k, v in it.scalars.items():
                    sc[k] = sc.get(k, 0.0) + v
        r.milli_cpu = mc
        r.memory = mem
        r.scalars = sc
        r.max_task_num = 0
        return r

    # -- predicates ---------------------------------------------------------

    def is_empty(self) -> bool:
        """True iff every dimension is below its minimum threshold."""
        if not (self.milli_cpu < MIN_MILLI_CPU and self.memory < MIN_MEMORY):
            return False
        return all(v < MIN_MILLI_SCALAR for v in self.scalars.values())

    def is_zero(self, name: str) -> bool:
        if name == "cpu":
            return self.milli_cpu < MIN_MILLI_CPU
        if name == "memory":
            return self.memory < MIN_MEMORY
        if name not in self.scalars:
            return True
        return self.scalars[name] < MIN_MILLI_SCALAR

    # -- arithmetic (in-place, returning self, like the reference) ----------

    def add(self, rr: "Resource") -> "Resource":
        self.milli_cpu += rr.milli_cpu
        self.memory += rr.memory
        for k, v in rr.scalars.items():
            self.scalars[k] = self.scalars.get(k, 0.0) + v
        return self

    def sub(self, rr: "Resource") -> "Resource":
        """Subtract; requires rr.less_equal(self) like the reference assert."""
        if not rr.less_equal(self):
            raise ValueError(
                f"resource is not sufficient to do operation: <{self}> sub <{rr}>")
        self.milli_cpu -= rr.milli_cpu
        self.memory -= rr.memory
        for k, v in rr.scalars.items():
            self.scalars[k] = self.scalars.get(k, 0.0) - v
        return self

    def multi(self, ratio: float) -> "Resource":
        self.milli_cpu *= ratio
        self.memory *= ratio
        for k in self.scalars:
            self.scalars[k] *= ratio
        return self

    scale = multi

    def set_max_resource(self, rr: "Resource") -> None:
        """Element-wise max, in place (resource_info.go SetMaxResource)."""
        self.milli_cpu = max(self.milli_cpu, rr.milli_cpu)
        self.memory = max(self.memory, rr.memory)
        for k, v in rr.scalars.items():
            if v > self.scalars.get(k, 0.0):
                self.scalars[k] = v

    def fit_delta(self, rr: "Resource") -> "Resource":
        """Availability minus request minus threshold for requested dims."""
        if rr.milli_cpu > 0:
            self.milli_cpu -= rr.milli_cpu + MIN_MILLI_CPU
        if rr.memory > 0:
            self.memory -= rr.memory + MIN_MEMORY
        for k, v in rr.scalars.items():
            if v > 0:
                self.scalars[k] = self.scalars.get(k, 0.0) - (v + MIN_MILLI_SCALAR)
        return self

    def diff(self, rr: "Resource"):
        """Returns (increased, decreased) element-wise deltas vs rr."""
        inc, dec = Resource(), Resource()
        def put(target, name, v):
            if name == "cpu":
                target.milli_cpu = v
            elif name == "memory":
                target.memory = v
            else:
                target.scalars[name] = v
        for name, l, r in self._paired(rr):
            if l > r:
                put(inc, name, l - r)
            else:
                put(dec, name, r - l)
        return inc, dec

    def min_dimension_resource(self, rr: "Resource") -> "Resource":
        """Element-wise min, in place over self's dimensions."""
        self.milli_cpu = min(self.milli_cpu, rr.milli_cpu)
        self.memory = min(self.memory, rr.memory)
        for k in self.scalars:
            self.scalars[k] = min(self.scalars[k], rr.scalars.get(k, 0.0))
        return self

    def get(self, name: str) -> float:
        if name == "cpu":
            return self.milli_cpu
        if name == "memory":
            return self.memory
        return self.scalars.get(name, 0.0)

    def set(self, name: str, value: float) -> None:
        if name == "cpu":
            self.milli_cpu = value
        elif name == "memory":
            self.memory = value
        else:
            self.scalars[name] = value

    def resource_names(self):
        return ["cpu", "memory"] + list(self.scalars)

    # -- comparisons --------------------------------------------------------

    def _paired(self, rr: "Resource"):
        names = set(self.scalars) | set(rr.scalars)
        yield ("cpu", self.milli_cpu, rr.milli_cpu)
        yield ("memory", self.memory, rr.memory)
        for n in sorted(names):
            yield (n, self.scalars.get(n, 0.0), rr.scalars.get(n, 0.0))

    def less(self, rr: "Resource") -> bool:
        """Strict less on every dimension (resource_info.go Less)."""
        if not self.milli_cpu < rr.milli_cpu:
            return False
        if not self.memory < rr.memory:
            return False
        if not self.scalars:
            # reference: empty-left passes unless some right scalar is tiny
            return all(v > MIN_MILLI_SCALAR for v in rr.scalars.values())
        if not rr.scalars:
            return False
        return all(self.scalars[k] < rr.scalars.get(k, 0.0) for k in self.scalars)

    def less_equal_strict(self, rr: "Resource") -> bool:
        if self.milli_cpu > rr.milli_cpu or self.memory > rr.memory:
            return False
        return all(v <= rr.scalars.get(k, 0.0) for k, v in self.scalars.items())

    def less_equal(self, rr: "Resource") -> bool:
        """Threshold-tolerant <= (resource_info.go LessEqual): a dimension
        passes if l < r or |l-r| < min-threshold; scalar dims below the
        threshold are ignored entirely. (Comparisons inlined — this is the
        single hottest host function at 10k tasks/cycle.)"""
        l = self.milli_cpu
        r = rr.milli_cpu
        if l >= r and abs(l - r) >= MIN_MILLI_CPU:
            return False
        l = self.memory
        r = rr.memory
        if l >= r and abs(l - r) >= MIN_MEMORY:
            return False
        if self.scalars:
            rs = rr.scalars
            for k, v in self.scalars.items():
                if v <= MIN_MILLI_SCALAR:
                    continue
                r = rs.get(k, 0.0)
                if v >= r and abs(v - r) >= MIN_MILLI_SCALAR:
                    return False
        return True

    def __eq__(self, other) -> bool:
        if not isinstance(other, Resource):
            return NotImplemented
        return all(l == r for _, l, r in self._paired(other))

    def __repr__(self) -> str:
        sc = ", ".join(f"{k}={v:g}" for k, v in sorted(self.scalars.items()))
        return f"Resource(cpu {self.milli_cpu:g}m, memory {self.memory:g}{', ' + sc if sc else ''})"

    # -- array projection (the TPU seam) ------------------------------------

    def to_vector(self, vocab: "ResourceVocab") -> np.ndarray:
        vec = np.zeros(len(vocab), dtype=np.float32)
        vec[0] = self.milli_cpu
        vec[1] = self.memory
        for k, v in self.scalars.items():
            idx = vocab.index(k)
            if idx is not None:
                vec[idx] = v
        return vec

    @classmethod
    def from_vector(cls, vec, vocab: "ResourceVocab") -> "Resource":
        r = cls(float(vec[0]), float(vec[1]))
        for i, name in enumerate(vocab.scalar_names, start=2):
            if float(vec[i]) != 0.0:
                r.scalars[name] = float(vec[i])
        return r


class ResourceVocab:
    """Fixed ordering of resource dimensions for array flattening.

    Axis 0 = cpu (millicores), axis 1 = memory (bytes), axes 2+ = named
    scalar resources in registration order. The per-dimension minimum
    thresholds (used by the device kernels for LessEqual semantics) are
    exposed as a vector too.
    """

    def __init__(self, scalar_names: Iterable[str] = ()):  # noqa: D401
        self.scalar_names: List[str] = list(dict.fromkeys(scalar_names))
        self._index = {n: i + 2 for i, n in enumerate(self.scalar_names)}

    def __len__(self) -> int:
        return 2 + len(self.scalar_names)

    def index(self, name: str) -> Optional[int]:
        return self._index.get(name)

    def add(self, name: str) -> int:
        if name not in self._index:
            self._index[name] = 2 + len(self.scalar_names)
            self.scalar_names.append(name)
        return self._index[name]

    def thresholds(self) -> np.ndarray:
        t = np.full(len(self), MIN_MILLI_SCALAR, dtype=np.float32)
        t[0] = MIN_MILLI_CPU
        t[1] = MIN_MEMORY
        return t

    @classmethod
    def collect(cls, resources: Iterable[Resource]) -> "ResourceVocab":
        v = cls()
        for r in resources:
            for name in r.scalars:
                v.add(name)
        return v
