"""Traffic kind ``evict_churn``: low-priority elastic jobs placed Running
on every node, then high-priority gangs of whole-node pods arriving while
fewer than ``max_pending`` wait, in the queues of ``high_queues`` taken in
turn from a place the seed chooses.

Each intake first does what a kubelet and a job controller report: the
pods evicted in the last cycle end and are made again Pending
(``World.release``), and the pods bound in it run
(``World.report_running``). In the program's round solve the remade low
pods take the freed nodes back before the claimer gang (its two pods
choose one node in the first round; the gang rule then reverts the one
admitted), so the gangs keep waiting and every cycle preempts and reclaims
again."""

import numpy as np

from benchmark.world import GangSpec


class EvictChurn:
    def __init__(self, config, params, seed):
        self.p = params
        self.rng = np.random.default_rng([seed, 2])
        self.k = int(self.rng.integers(len(params["high_queues"])))
        self.n = 0

    def setup(self, world):
        p = self.p
        size = p["low_size"]
        nodes = [n.name for n in world.state.nodes]
        for j in range(p["low_jobs"]):
            world.place(GangSpec(f"low{j}", p["low_queue"], size, 1,
                                 dict(p["low_request"]), 1.0 + j,
                                 "low-priority"),
                        [nodes[j % len(nodes)]] * size)
        for _ in range(p["warm_cycles"]):
            c = world.begin()
            self.intake(world)
            world.run(c)
            if c.failure:
                raise RuntimeError(f"warm-up cycle failed: {c.failure}")

    def intake(self, world):
        p = self.p
        for pod in list(world.releasing):
            world.release(pod)
        if world.binding:
            world.report_running(list(world.binding))
        bound = set(world.bound_gangs())
        if sum(g[0] == "h" and g not in bound
               for g in world.gangs) < p["max_pending"]:
            queues = p["high_queues"]
            world.submit(GangSpec(f"h{self.n}", queues[self.k % len(queues)],
                                  p["high_size"], p["high_size"],
                                  dict(p["high_request"]), 100.0 + self.n,
                                  "high-priority"))
            self.k += 1
            self.n += 1


def build(config, params, seed):
    return EvictChurn(config, params, seed)
