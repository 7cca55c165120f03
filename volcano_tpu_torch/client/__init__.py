"""Cluster store: the API-server/informer seam the scheduler cache watches
and its effectors write through — in memory (with optional lease
fencing), over TCP (``StoreServer`` / ``RemoteClusterStore``, the JAX
package's wire), behind an optional WAL/snapshot durability layer
(``DurableClusterStore``), the sharded front door (partitioned store,
one-endpoint router, shard-worker processes), the WAL-shipped
read-replica tier and the read-tier split. Every server consults the
overload-admission gate (resilience/overload.py) before dispatch."""

from ..resilience.overload import (  # noqa: F401
    AdmissionGate, LaneStore, OverloadedError, RetryBudget,
    RetryBudgetExhausted,
)
from .durable import DurableClusterStore, WriteAheadLog  # noqa: F401
from .readtier import ReadTierStore  # noqa: F401
from .remote import RemoteClusterStore  # noqa: F401
from .replica import (  # noqa: F401
    ReplicaGapError, ReplicaServer, ReplicaStore, ShardedReplicaServer,
)
from .server import StoreServer  # noqa: F401
from .sharded import (  # noqa: F401
    ShardedClusterStore, ShardRouter, shard_for,
)
from .shardproc import (  # noqa: F401
    ProcShardRouter, ProcShardedStore, ShardProcSupervisor,
    ShardWorkerServer,
)
from .store import (  # noqa: F401
    AdmissionError, ClusterStore, ConflictError, FencedError, FencedStore,
    NotFoundError, ReplicaLagError, ReplicaReadOnlyError, ResumeGapError,
    ShardUnavailableError,
)
