"""Node-axis sharding of the solvers over a single-controller device mesh
(the scale axis of the JAX package's ``parallel/``), and the solver
sidecar: the solve served from another process that owns the card."""

from .mesh import Mesh, arena_mesh, make_mesh  # noqa: F401
from .sharded_evict import solve_evict_uniform_sharded  # noqa: F401
from .sharded_solver import (  # noqa: F401
    solve_allocate_sharded, solve_allocate_sharded_arena,
)
from .sidecar import SidecarSolver, SolverServer  # noqa: F401
