"""A plain reference for the extension test's tiny evicting cell, and for
no other: the conf ``enqueue, allocate, preempt, reclaim, backfill``
(priority, gang, conformance; drf, predicates, nodeorder), nodes alike,
every pod asking the same share of a node's cpu and memory, and the
claimers that meet victims asking a whole node. ``Unsupported`` anywhere
else.

Binds: the benchmark's own reference (``benchmark.reference``), which
writes out the priority order. Evictions, from the state after
allocate's binds, by the program's stated rules (its ``ops/evict.py``):
- victims are Running pods; preempt's are of the claimer's queue and
  another job, reclaim's of another queue that is reclaimable, and both
  of a job of strictly lower priority (the first tier's verdict:
  priority and gang);
- preempt places each claimer gang whole or not at all, filling nodes
  that are already free first, then evicting every victim of the nodes it
  takes; where more nodes could be freed than it needs it spreads to the
  last of them (score ties: its waterfill trims the first);
- reclaim places claimer by claimer on the first node whose victims alone
  free a whole node, evicting them, with no gang rule;
- with every pod at the same share of cpu and memory, a whole-node
  claimer scores alike on every node, so node order decides.
"""

from typing import Dict, List

import yaml

from benchmark.reference import Unsupported, cycle_binds
from benchmark.reference.resource import dominant_share, Res
from benchmark.reference.session import Conf

ACTIONS = ["enqueue", "allocate", "preempt", "reclaim", "backfill"]
TIERS = [["priority", "gang", "conformance"],
         ["drf", "predicates", "nodeorder"]]


def parse(conf_text: str) -> Conf:
    raw = yaml.safe_load(conf_text)
    actions = [a.strip() for a in raw["actions"].split(",")]
    tiers = [[p["name"] for p in t["plugins"]] for t in raw["tiers"]]
    if actions != ACTIONS or tiers != TIERS or set(raw) != {"actions",
                                                           "tiers"}:
        raise Unsupported(f"conf {actions} {tiers}")
    if any(set(p) != {"name"} for t in raw["tiers"] for p in t["plugins"]):
        raise Unsupported("plugin arguments")
    return Conf(tiers=tiers, args={n: {} for t in tiers for n in t})


def _check_case(state) -> float:
    """The node's cpu (all nodes alike), after checking the case."""
    a = state.nodes[0].alloc
    for n in state.nodes:
        if (n.alloc.cpu, n.alloc.mem, n.alloc.sc) != (a.cpu, a.mem, {}):
            raise Unsupported("nodes that differ")
    for g in state.gangs.values():
        if g.req.sc or g.req.cpu / a.cpu != g.req.mem / a.mem:
            raise Unsupported(f"{g.name}: cpu and memory at other shares")
    if set(state.placed) != state.running or state.releasing:
        raise Unsupported("pods binding or releasing at a cycle's start")
    if any(q.capability is not None for q in state.queues):
        raise Unsupported("a queue capability")
    return a.cpu


def cycle_decisions(state, conf, score_dtype=None, device="cpu"):
    whole = _check_case(state)
    kw = {} if score_dtype is None else {"score_dtype": score_dtype}
    binds = cycle_binds(state, conf, device=device, **kw)
    bound = {k.split("/", 1)[1]: v for k, v in binds.items()}
    queues = {q.name: q for q in state.queues}
    names = [n.name for n in state.nodes]
    total = Res()
    for n in state.nodes:
        total.add(n.alloc)
    # each node's future idle cpu, and its victims (Running pods) by gang
    future = {n: whole for n in names}
    on_node: Dict[str, List[tuple]] = {n: [] for n in names}
    for g in state.gangs.values():
        for pod in g.pods:
            node = state.placed.get(pod) or bound.get(pod)
            if node is not None:
                future[node] -= g.req.cpu
                if pod in state.placed:
                    on_node[node].append((pod, g))
    # claimers: gangs with pending pods after allocate, queue by queue
    # (creation order), then priority, readiness, drf share, creation
    claim = []
    for g in state.gangs.values():
        placed = [p for p in g.pods if p in state.placed or p in bound]
        pending = len(g.pods) - len(placed)
        if pending and len(g.pods) >= g.min_member:
            ready = len(placed) >= g.min_member
            share = dominant_share(
                Res(g.req.cpu * len(placed), g.req.mem * len(placed)), total)
            q = queues[g.queue]
            claim.append(((q.ct, q.name, -g.priority, ready, share, g.ct,
                           g.name), g, len(placed), pending))
    claim.sort(key=lambda c: c[0])
    evicted: Dict[str, str] = {}

    def victims(node, g, same_queue):
        out = []
        for pod, v in on_node[node]:
            if pod in evicted or v.priority >= g.priority or v is g:
                continue
            if same_queue and v.queue == g.queue:
                out.append(pod)
            if not same_queue and v.queue != g.queue \
                    and queues[v.queue].reclaimable is not False:
                out.append(pod)
        return out

    def victim_cpu(pods):
        return sum(state.gangs[p.rsplit("-", 1)[0]].req.cpu for p in pods)

    pipelined = set()
    for _, g, n_placed, pending in claim:          # preempt
        if n_placed >= g.min_member:
            continue                               # already pipelined
        vic = {n: victims(n, g, True) for n in names}
        if g.req.cpu != whole:
            if any(vic.values()) or any(f >= g.req.cpu
                                        for f in future.values()):
                raise Unsupported(f"{g.name}: a claimer smaller than a node")
            continue
        need = g.min_member - n_placed
        free = [n for n in names if future[n] >= whole]
        freeable = [n for n in names if n not in free and vic[n]
                    and future[n] + victim_cpu(vic[n]) >= whole]
        count = min(pending, need)
        if len(free) + len(freeable) < need or count <= 0:
            continue
        take = free[:count]
        extra = count - len(take)
        take += freeable[len(freeable) - extra:] if extra else []
        for n in take:
            for pod in vic[n] if n not in free else ():
                evicted[pod] = "preempt"
                future[n] += state.gangs[pod.rsplit("-", 1)[0]].req.cpu
            future[n] -= whole
        pipelined.add(g.name)
    for _, g, n_placed, pending in claim:          # reclaim
        if g.name in pipelined:
            continue
        vic = {n: victims(n, g, False) for n in names}
        if g.req.cpu != whole:
            if any(vic.values()):
                raise Unsupported(f"{g.name}: a claimer smaller than a node")
            continue
        for _ in range(pending):
            vic = {n: victims(n, g, False) for n in names}
            ok = [n for n in names if vic[n] and victim_cpu(vic[n]) >= whole]
            if not ok:
                continue
            for pod in vic[ok[0]]:
                evicted[pod] = "reclaim"
            future[ok[0]] += victim_cpu(vic[ok[0]]) - whole
    ns = state.namespace
    return binds, {f"{ns}/{p}": r for p, r in evicted.items()}
