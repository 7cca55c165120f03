"""Deterministic trace-driven cluster simulator.

Runs the UNMODIFIED scheduler loop against an emulated cluster on a
virtual clock, records every decision as canonical JSONL, replays golden
traces with structured first-divergence diffs, and scores scheduling
quality (wait, makespan, utilization, Jain fairness, preemption churn).

``python -m volcano_tpu_torch.sim --cycles 500 --seed 7`` prints the trace
and a final quality-report line; same seed + config => byte-identical
trace. The trace format, the canonical record and the digest are the JAX
package's byte for byte: a trace recorded by either package verifies
under the other. The scheduler runs on the CUDA device unless the caller
passes ``device="cpu"`` (``--device cpu``).
"""

from .recorder import DecisionRecorder  # noqa: F401
from .replay import (  # noqa: F401
    SimResult, first_divergence, run_sim, verify,
)
from .score import compute as compute_score, jain_fairness  # noqa: F401
from .virtualcluster import VirtualClock, VirtualCluster, build_conf  # noqa: F401
from .workload import Workload, WorkloadSpec  # noqa: F401
