"""Whether the timed cycles decided what the reference decides.

For every cycle after the set-up (the window's, and the traced ones that
follow it) the reference works the cycle's binds and evictions out again
from the cluster state before it: the state at the window's start,
advanced cycle by cycle through the traffic's recorded store writes
(``world.apply_event``: submissions, placements, completions, reports of
running pods, releases) and the program's own binds and evictions (the
reference follows the program step by step; a cycle whose decisions
differ counts its differing pods, and the state goes on from the
program's). The reference is the module the configuration names with
``"reference"`` (``reference_module``; ``benchmark.reference`` when it
names none): its ``parse(conf_text)`` reads the conf and its
``cycle_decisions(state, conf, score_dtype, device)`` gives ``({pod key:
node}, {pod key: reason})``. The start state itself is checked by the
invariants a decision may never break: a gang with placed pods has at
least its ``min_member`` of them and no more than its size, and no node
is past its allocatable cpu, memory, GPUs or pods.

The numbers compared, each with its limit:
- ``bind_mismatches``: pods bound by the program or the reference but not
  to the same node, over those cycles (exact: limit 0);
- ``eviction_mismatches``: pods evicted by the program or the reference
  but not both, or for another reason, over those cycles (exact: limit 0);
- ``failed_cycles``: cycles that raised, whose timing carries an action's
  error, timeout or fault reason, that fell back to the host, or that left
  the breaker open (limit 0);
- ``start_violations``: gangs placed below their ``min_member`` or above
  their size, and overcommitted nodes, in the state the window starts
  from (limit 0).
"""

from __future__ import annotations

import copy
import importlib
from typing import Dict

import torch

from .reference import ClusterState
from .reference.resource import Res
from .world import apply_decisions, apply_event

LIMITS = {"bind_mismatches": 0, "eviction_mismatches": 0,
          "failed_cycles": 0, "start_violations": 0}


def reference_module(config: dict):
    """The configuration's reference: ``benchmark.<config["reference"]>``,
    or ``benchmark.reference``."""
    return importlib.import_module(
        f"benchmark.{config.get('reference', 'reference')}")


def start_violations(state: ClusterState) -> int:
    bad = 0
    use: Dict[str, list] = {}
    for g in state.gangs.values():
        n = sum(p in state.placed for p in g.pods)
        if n and not g.min_member <= n <= len(g.pods):
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
            evictions_by_cycle: Dict[int, dict], gangs: dict,
            conf_text: str, reference, score_dtype=torch.float32,
            device: str = "cpu") -> dict:
    """Replay ``cycles`` (World.Cycle records, in order) from ``start``
    and count, over every one of them, the pods whose bind or eviction
    differs from the reference's. ``binds_by_cycle``: cycle index ->
    {"ns/pod": node} the program bound; ``evictions_by_cycle``: cycle
    index -> {"ns/pod": reason} it evicted; ``gangs``: every submitted
    gang (reference.Gang) by name; ``reference``: the reference module
    (``reference_module``); ``device``: where its solve runs."""
    conf = reference.parse(conf_text)
    state = copy.deepcopy(start)
    binds_off = evicts_off = 0
    n_compared = 0
    for c in cycles:
        for ev in c.events:
            apply_event(state, ev, gangs)
        got = binds_by_cycle.get(c.index, {})
        got_ev = evictions_by_cycle.get(c.index, {})
        ref, ref_ev = reference.cycle_decisions(
            state, conf, score_dtype=score_dtype, device=device)
        n_compared += 1
        binds_off += sum(ref.get(k) != got.get(k) for k in set(ref) | set(got))
        evicts_off += sum(ref_ev.get(k) != got_ev.get(k)
                          for k in set(ref_ev) | set(got_ev))
        apply_decisions(state, got, list(got_ev))
    return {"bind_mismatches": binds_off, "eviction_mismatches": evicts_off,
            "compared_cycles": n_compared}
