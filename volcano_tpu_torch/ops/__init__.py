"""Device-side allocate solve: flatten arrays, the fused choice kernel and
the round solver."""

from .arrays import (  # noqa: F401
    FlattenCache, ScoreParams, SnapshotArrays, bucket, flatten_snapshot,
)
from .convert import resolve_device, to_torch_arrays, to_torch_params  # noqa: F401
from .solver import SolveResult, decode_compact, solve_allocate  # noqa: F401
