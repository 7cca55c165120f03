"""The plain reference of a scheduling cycle's binds.

Given the cluster state before a cycle (``session.ClusterState``: what the
benchmark handed the store, and where the pods bound so far run) and the
scheduler conf, ``cycle_binds`` works out which pods the cycle binds and
to which node: the session's order and fair-share inputs
(``session.py``), the round solve (``solve.py``, ``hdrf.py``), and the
replay, which binds every task the solve allocated in a job that is
ready. Plain NumPy and PyTorch (the solve on the host, or on the card where
the cell's file asks); nothing of the program under
test is imported.
"""

from __future__ import annotations

from typing import Dict

import torch

from .session import ClusterState, Conf, Gang, Node, Queue, Unsupported, \
    build_problem
from .solve import solve

__all__ = ["ClusterState", "Conf", "Gang", "Node", "Queue", "Unsupported",
           "cycle_binds"]


def cycle_binds(state: ClusterState, conf: Conf, score_dtype=torch.float32,
                device: str = "cpu") -> Dict[str, str]:
    """{pod key: node name} that one cycle binds from ``state``; the solve
    runs on ``device``."""
    prob = build_problem(state, conf)
    if prob is None:
        return {}
    sol = solve(prob.arrays, prob.params, score_dtype=score_dtype,
                device=device, **prob.flags)
    assigned = sol.assigned.tolist()
    kind = sol.kind.tolist()
    ready = sol.job_ready.tolist()
    job = prob.arrays["task_job"].tolist()
    out = {}
    for t, pod in enumerate(prob.tasks):
        if assigned[t] >= 0 and kind[t] == 0 and ready[job[t]]:
            out[pod] = prob.nodes[assigned[t]]
    return out
