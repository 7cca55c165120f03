"""Metrics (reference pkg/scheduler/metrics). The port keeps its own
registry; metric names are the JAX package's."""

from . import metrics  # noqa: F401
from .metrics import Counter, Gauge, Histogram, Registry, registry  # noqa: F401
