"""Cluster store: the API-server/informer seam the scheduler cache watches
and its effectors write through — in memory (with optional lease
fencing), over TCP (``StoreServer`` / ``RemoteClusterStore``, the JAX
package's wire), and behind an optional WAL/snapshot durability layer
(``DurableClusterStore``). Every server consults the overload-admission
gate (resilience/overload.py) before dispatch."""

from ..resilience.overload import (  # noqa: F401
    AdmissionGate, LaneStore, OverloadedError, RetryBudget,
    RetryBudgetExhausted,
)
from .durable import DurableClusterStore, WriteAheadLog  # noqa: F401
from .remote import RemoteClusterStore  # noqa: F401
from .server import StoreServer  # noqa: F401
from .store import (  # noqa: F401
    AdmissionError, ClusterStore, ConflictError, FencedError, FencedStore,
    NotFoundError, ReplicaLagError, ReplicaReadOnlyError, ResumeGapError,
    ShardUnavailableError,
)
