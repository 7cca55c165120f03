"""Cluster store: the API-server/informer seam the scheduler cache watches
and its effectors write through (in-memory, with optional lease fencing)."""

from .store import (  # noqa: F401
    AdmissionError, ClusterStore, ConflictError, FencedError, FencedStore,
    NotFoundError, ReplicaLagError, ReplicaReadOnlyError, ResumeGapError,
    ShardUnavailableError,
)
