"""Device-side scheduling path: flatten arrays and the event-sourced
ordering, the device-resident arenas (packed, and node-axis sharded), the
fused choice kernel, the round solver (with the hierarchical-DRF tree,
ops.hdrf) and its packed entry points, the sequential parity solver, the
eviction solves (ops.evict) and the result readback."""

from .arrays import (  # noqa: F401
    FlattenCache, ScoreParams, SnapshotArrays, bucket, flatten_snapshot,
)
from .convert import resolve_device, to_torch_arrays, to_torch_params  # noqa: F401
from .device_cache import (  # noqa: F401
    PackedDeviceCache, ShardedDeviceCache, split_packed_layout,
)
from .evict import EvictResult, solve_evict, solve_evict_uniform  # noqa: F401
from .ordering import OrderCache  # noqa: F401
from .pipeline import (  # noqa: F401
    Readback, SessionPipeline, SessionTicket, start_readback,
)
from .solver import (  # noqa: F401
    SolveResult, decode_compact, solve_allocate, solve_allocate_packed2d,
    solve_allocate_sequential,
)
