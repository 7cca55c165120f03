"""The plain reference of a scheduling cycle's decisions.

Given the cluster state before a cycle (``session.ClusterState``: what the
benchmark handed the store, and where the pods bound so far run) and the
scheduler conf, ``cycle_binds`` works out which pods the cycle binds and
to which node: the session's order and fair-share inputs
(``session.py``), the round solve (``solve.py``, ``hdrf.py``), and the
replay, which binds every task the solve allocated in a job that is
ready. Plain NumPy and PyTorch (the solve on the host, or on the card where
the cell's file asks); nothing of the program under
test is imported.

A reference module is what a configuration names with ``"reference"``
(this package when it names none). The check calls two functions of it:
``parse(conf_text)`` and ``cycle_decisions(state, conf, score_dtype,
device)``, which returns ``({pod key: node}, {pod key: reason})``, the
cycle's binds and evictions. This one's confs are
``enqueue, allocate, backfill``, which evict nothing.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from .session import ClusterState, Conf, Gang, Node, Queue, Unsupported, \
    build_problem
from .solve import solve

__all__ = ["ClusterState", "Conf", "Gang", "Node", "Queue", "Unsupported",
           "cycle_binds", "cycle_decisions", "parse"]


def parse(conf_text: str) -> Conf:
    """The conf as this reference reads it (``Unsupported`` for any other
    actions than enqueue, allocate and backfill)."""
    return Conf.parse(conf_text)


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


def cycle_decisions(state: ClusterState, conf: Conf,
                    score_dtype=torch.float32, device: str = "cpu"
                    ) -> Tuple[Dict[str, str], Dict[str, str]]:
    """(binds, evictions) of one cycle from ``state``: ``cycle_binds``,
    and no eviction."""
    return cycle_binds(state, conf, score_dtype=score_dtype,
                       device=device), {}
