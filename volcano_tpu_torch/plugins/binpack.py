"""Binpack plugin (reference plugins/binpack/binpack.go:111-260).

Best-fit scoring: score = 100 * sum_r w_r * (used_r + req_r) / alloc_r / sum_w,
scaled by the plugin weight. On the solver path this sets the binpack
score family weights (the fused choice kernel evaluates it per pair); the host
node-order fn provides identical per-pair scoring for non-solver paths.
"""

from __future__ import annotations

import numpy as np

from ..framework import Arguments, Plugin


class BinpackPlugin(Plugin):
    def __init__(self, arguments=None):
        args = Arguments(arguments or {})
        self.weight = args.get_int("binpack.weight", 1)
        self.cpu_weight = args.get_int("binpack.cpu", 1)
        self.memory_weight = args.get_int("binpack.memory", 1)
        # custom scalar resources: "binpack.resources": "nvidia.com/gpu,..."
        # with per-resource "binpack.resources.nvidia.com/gpu": weight
        self.resource_weights = {}
        raw = args.get("binpack.resources", "")
        for name in str(raw).split(","):
            name = name.strip()
            if name:
                self.resource_weights[name] = args.get_int(
                    f"binpack.resources.{name}", 1)

    def name(self) -> str:
        return "binpack"

    def _weights_vector(self, vocab) -> np.ndarray:
        w = np.zeros(len(vocab), dtype=np.float32)
        w[0] = self.cpu_weight
        w[1] = self.memory_weight
        for name, wt in self.resource_weights.items():
            idx = vocab.index(name)
            if idx is not None:
                w[idx] = wt
        return w

    def on_session_open(self, ssn) -> None:
        ssn.score_params.binpack_weight = float(self.weight)
        ssn.solver_options["binpack_vocab_weights"] = self._weights_vector
        ssn.solver_options.setdefault("herd_mode", "pack")

        def node_order_fn(task, node) -> float:
            """Host-path equivalent of the kernel's binpack family."""
            names = ["cpu", "memory"] + list(self.resource_weights)
            score, wsum = 0.0, 0.0
            for name in names:
                if name == "cpu":
                    w, used, req, alloc = (self.cpu_weight,
                                           node.used.milli_cpu,
                                           task.init_resreq.milli_cpu,
                                           node.allocatable.milli_cpu)
                elif name == "memory":
                    w, used, req, alloc = (self.memory_weight,
                                           node.used.memory,
                                           task.init_resreq.memory,
                                           node.allocatable.memory)
                else:
                    w = self.resource_weights[name]
                    used = node.used.scalars.get(name, 0.0)
                    req = task.init_resreq.scalars.get(name, 0.0)
                    alloc = node.allocatable.scalars.get(name, 0.0)
                wsum += w
                if alloc > 0:
                    score += w * (used + req) * 100.0 / alloc
            if wsum <= 0:
                return 0.0
            return self.weight * score / wsum

        ssn.add_node_order_fn(self.name(), node_order_fn)

    def on_session_close(self, ssn) -> None:
        pass
