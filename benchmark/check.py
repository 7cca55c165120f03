"""Whether the timed cycles bound what the reference binds.

For every cycle after the set-up (the window's, and the traced ones that
follow it) the reference works the binds out again from the
cluster state before it: the state at the window's start, advanced cycle
by cycle through the recorded completions, submissions and the program's
own binds (the reference follows the program step by step; a cycle whose
binds differ counts its differing pods, and the state goes on from the
program's binds). The start state itself is checked by the invariants a
bind may never break: gangs all or nothing, and no node past its
allocatable cpu, memory, GPUs or pods.

The numbers compared, each with its limit:
- ``bind_mismatches``: pods bound by the program or the reference but not
  to the same node, over those cycles (exact: limit 0);
- ``failed_cycles``: cycles that raised, fell back to the host, or left
  the breaker open (limit 0);
- ``start_violations``: broken gangs and overcommitted nodes in the state
  the window starts from (limit 0).
"""

from __future__ import annotations

import copy
from typing import Dict

import torch

from .reference import ClusterState, Conf, cycle_binds
from .reference.resource import Res

LIMITS = {"bind_mismatches": 0, "failed_cycles": 0, "start_violations": 0}


def start_violations(state: ClusterState) -> int:
    bad = 0
    use: Dict[str, list] = {}
    for g in state.gangs.values():
        n = sum(p in state.placed for p in g.pods)
        if n not in (0, len(g.pods)):
            bad += 1
        for p in g.pods:
            node = state.placed.get(p)
            if node is not None:
                use.setdefault(node, []).append(g.req)
    for node in state.nodes:
        reqs = use.get(node.name, [])
        tot = Res()
        for r in reqs:
            tot.add(r)
        a = node.alloc
        if (tot.cpu > a.cpu or tot.mem > a.mem or len(reqs) > node.max_pods
                or any(v > a.sc.get(k, 0.0) for k, v in tot.sc.items())):
            bad += 1
    return bad


def compare(start: ClusterState, cycles, binds_by_cycle: Dict[int, dict],
            gangs: dict, conf_text: str, score_dtype=torch.float32,
            device: str = "cpu") -> dict:
    """Replay ``cycles`` (World.Cycle records, in order) from ``start``
    and count, over every one of them, the pods whose bind differs from
    the reference's. ``binds_by_cycle``: cycle index -> {"ns/pod": node}
    the program bound; ``gangs``: every submitted gang (reference.Gang)
    by name; ``device``: where the reference's solve runs."""
    conf = Conf.parse(conf_text)
    state = copy.deepcopy(start)
    mismatches = 0
    n_compared = 0
    for c in cycles:
        for name in c.completed:
            g = state.gangs.pop(name)
            for p in g.pods:
                state.placed.pop(p, None)
        for name in c.submitted:
            state.gangs[name] = gangs[name]
        got = binds_by_cycle.get(c.index, {})
        ref = cycle_binds(state, conf, score_dtype=score_dtype,
                          device=device)
        n_compared += 1
        keys = set(ref) | set(got)
        mismatches += sum(ref.get(k) != got.get(k) for k in keys)
        for key, node in got.items():
            state.placed[key.split("/", 1)[1]] = node
    return {"bind_mismatches": mismatches, "compared_cycles": n_compared}

