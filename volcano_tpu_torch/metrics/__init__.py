"""Metrics (reference pkg/scheduler/metrics). The port keeps its own
registry; metric names are the JAX package's. ``MetricsServer`` serves
it over HTTP (/metrics, /healthz, /debug/stacks)."""

from . import metrics  # noqa: F401
from .metrics import Counter, Gauge, Histogram, Registry, registry  # noqa: F401
from .server import DEFAULT_LISTEN_PORT, MetricsServer  # noqa: F401
