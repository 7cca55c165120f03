"""Traffic kind ``steady_waves``: a running population, then a closed loop
of gang churn.

Set-up submits ``setup_gangs`` gangs and runs one burst cycle, then
``warm_waves`` churn cycles, so the steady shapes are built and shipped
before the window and the burst's placement has churned into the steady
one. A gang's store objects are built when it is submitted (0.3 ms for
ten gangs on a host core): built ahead, a window's worth would add
~100 objects a gang to the heap that the program's full collections
walk. Before each cycle the loop submits ``wave`` new gangs
and, for each, completes one bound gang, chosen from the seed among those
of the same queue and pod request (of the same request, or any, where
none is bound): W gangs a cycle stand for W jobs a second under the
deployment's 1 s period, and departures mirror arrivals, so the running
population keeps its make-up. Where ``max_pending`` is given, arrivals
wait on the client's side and are handed to the store only while fewer
than that many gangs are pending there (none of their pods bound): the
backlog the scheduler re-examines every cycle stays at that size, however
far binds fall behind arrivals, so the work a cycle does does not grow
with the cycles run.

Gang k's shape follows the configuration's ``gangs`` entry (the slot
formulas below). The seed permutes which gang takes which slot within
blocks of ``SHUFFLE_BLOCK`` consecutive slots (blocks start at 0 and again
where the set-up ends), so every seed submits the same multiset of sizes
in the set-up and in each block, in another order, and the order varies
only locally. Queues go round-robin by submission order.

Parameters (the workload file's ``traffic``): ``setup_gangs``, ``wave``,
``warm_waves``, ``setup_must_bind`` (every set-up gang binds in the
burst), ``max_pending`` (optional: the admission cap above).
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..world import GangSpec, World, shape_of

#: the seed reorders arrivals within blocks of this many gangs: every
#: cpu and memory size of a 3 x 4 gang mix once, and only a local change
#: to the order (a global one moved the hdrf cell's backlog, and with it
#: its throughput, by a fifth from seed to seed)
SHUFFLE_BLOCK = 12


class SteadyWaves:
    def __init__(self, config: dict, params: dict, seed: int):
        self.gang = config["gangs"]
        self.queues = [q["name"] for q in config["queues"]]
        self.p = params
        # one stream for the shapes' order, one for the completions, so
        # the gangs built ahead of the window are the ones it submits
        self.rng_slots = np.random.default_rng([seed, 0])
        self.rng_done = np.random.default_rng([seed, 1])
        self.k = 0
        self.slots: List[int] = []
        self.waiting: List[GangSpec] = []   # arrivals not yet admitted

    def _slot(self) -> int:
        if not self.slots:
            # blocks of shuffle_block slots from 0 and again from the
            # set-up's end; the set-up's last block ends with the set-up
            n0, b = self.p["setup_gangs"], SHUFFLE_BLOCK
            base = self.k if self.k >= n0 else self.k // b * b
            size = b if self.k >= n0 else min(b, n0 - base)
            self.slots = list(base + self.rng_slots.permutation(size))
        return int(self.slots.pop(0))

    def next_spec(self) -> GangSpec:
        g = self.gang
        k = self.k
        s = self._slot()
        self.k += 1
        cpu = g["cpu"][(s // g.get("cpu_stride", 1)) % len(g["cpu"])]
        mem = g["memory_gi"][s % len(g["memory_gi"])]
        req = {"cpu": str(cpu), "memory": f"{mem}Gi"}
        every = g.get("gpu_every", 0)
        if every and s % every == 0:
            req["nvidia.com/gpu"] = "1"
        return GangSpec(name=f"j{k}", queue=self.queues[k % len(self.queues)],
                        size=g["size"], min_member=g["min_member"],
                        request=req, ct=1.0 + k)

    def setup(self, world: World) -> None:
        p = self.p
        for _ in range(p["setup_gangs"]):
            world.submit(self.next_spec())
        c = world.begin()
        world.run(c)
        if c.failure:
            raise RuntimeError(f"set-up burst failed: {c.failure}")
        if p.get("setup_must_bind") and world.n_pending():
            raise RuntimeError(f"set-up burst left {world.n_pending()} "
                               f"gangs unbound")
        for _ in range(p["warm_waves"]):
            c = world.begin()
            self.intake(world)
            world.run(c)
            if c.failure:
                raise RuntimeError(f"warm-up wave failed: {c.failure}")

    def intake(self, world: World) -> None:
        """Complete ``wave`` bound gangs that mirror the ``wave`` arriving
        ones, chosen from the seed (as many as are bound), then submit the
        arrivals, oldest first, as far as ``max_pending`` lets them."""
        new = [self.next_spec() for _ in range(self.p["wave"])]
        for g in new:
            shape = shape_of(g)
            pool = world.bound_gangs(shape)
            if not pool:
                # rare: nothing of that queue and request runs
                bound = world.bound_gangs()
                pool = [n for n in bound
                        if shape_of(world.gangs[n])[1] == shape[1]] or bound
            if pool:    # none bound at all: nothing finishes this time
                world.complete(pool[int(self.rng_done.integers(len(pool)))])
        self.waiting += new
        cap = self.p.get("max_pending")
        n = len(self.waiting) if cap is None \
            else max(0, min(len(self.waiting), cap - world.n_pending()))
        for g in self.waiting[:n]:
            world.submit(g)
        del self.waiting[:n]


def build(config: dict, params: dict, seed: int) -> SteadyWaves:
    return SteadyWaves(config, params, seed)
