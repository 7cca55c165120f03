"""Nodeorder plugin (reference plugins/nodeorder/nodeorder.go:100-276).

Wraps the k8s scorers the reference uses: least-requested,
balanced-allocation, most-requested, node-affinity and taint-toleration
preferences. Scalar weights feed the kernel's score families; the host
node-order fn mirrors them per pair.
"""

from __future__ import annotations

from ..framework import Arguments, Plugin
from ..ops.arrays import taint_tolerated


class NodeOrderPlugin(Plugin):
    def __init__(self, arguments=None):
        args = Arguments(arguments or {})
        self.least_requested = args.get_int("leastrequested.weight", 1)
        self.most_requested = args.get_int("mostrequested.weight", 0)
        self.balanced = args.get_int("balancedresource.weight", 1)
        self.node_affinity = args.get_int("nodeaffinity.weight", 1)
        self.taint_toleration = args.get_int("tainttoleration.weight", 1)
        self.pod_affinity = args.get_int("podaffinity.weight", 1)

    def name(self) -> str:
        return "nodeorder"

    def on_session_open(self, ssn) -> None:
        ssn.score_params.least_req_weight = float(self.least_requested)
        ssn.score_params.most_req_weight = float(self.most_requested)
        ssn.score_params.balanced_weight = float(self.balanced)
        if self.most_requested <= max(self.least_requested, self.balanced):
            ssn.solver_options.setdefault("herd_mode", "spread")

        def node_order_fn(task, node) -> float:
            alloc_cpu = node.allocatable.milli_cpu or 1.0
            alloc_mem = node.allocatable.memory or 1.0
            fc = min(max((node.used.milli_cpu + task.init_resreq.milli_cpu)
                         / alloc_cpu, 0.0), 1.0)
            fm = min(max((node.used.memory + task.init_resreq.memory)
                         / alloc_mem, 0.0), 1.0)
            least = (1.0 - (fc + fm) / 2.0) * 100.0
            most = ((fc + fm) / 2.0) * 100.0
            balanced = (1.0 - abs(fc - fm)) * 100.0
            # preferredDuringScheduling node affinity terms
            affinity_score = 0.0
            pod = task.pod
            if pod.affinity and node.node is not None:
                na = (pod.affinity.get("nodeAffinity") or {})
                for pref in na.get(
                        "preferredDuringSchedulingIgnoredDuringExecution", []):
                    weight = pref.get("weight", 0)
                    sel = (pref.get("preference") or {}).get("matchLabels", {})
                    labels = node.node.labels or {}
                    if all(labels.get(k) == v for k, v in sel.items()):
                        affinity_score += weight
            # taint-toleration preference: fewer intolerable
            # PreferNoSchedule taints score higher (k8s tainttoleration
            # scorer, per-node form of its count-and-normalize reduce)
            taint_score = 0.0
            if node.node is not None:
                intolerable = 0
                for taint in node.node.taints or []:
                    if taint.get("effect") != "PreferNoSchedule":
                        continue
                    if not taint_tolerated(taint, pod.tolerations or []):
                        intolerable += 1
                taint_score = 100.0 / (1.0 + intolerable)
            # preferred inter-pod (anti-)affinity: weight per matching term
            # against pods already on the node
            pa_score = 0.0
            if pod.affinity:
                on_node = [t.pod for t in node.tasks.values()]
                for kind, sign in (("podAffinity", 1.0),
                                   ("podAntiAffinity", -1.0)):
                    spec = (pod.affinity.get(kind) or {})
                    for pref in spec.get(
                            "preferredDuringSchedulingIgnoredDuringExecution",
                            []):
                        weight = pref.get("weight", 0)
                        term = pref.get("podAffinityTerm") or {}
                        sel = (term.get("labelSelector") or {}).get(
                            "matchLabels", {})
                        if not sel:
                            # matchExpressions-only selectors are not
                            # evaluated here; an empty matchLabels must not
                            # match every pod
                            continue
                        # k8s scopes the term to its namespaces list, or
                        # the incoming pod's namespace by default, and
                        # scores weight PER matching existing pod (a node
                        # holding 3 matches outranks one holding 1)
                        namespaces = set(term.get("namespaces")
                                         or [pod.namespace])
                        matches = sum(
                            1 for p in on_node
                            if p.namespace in namespaces
                            and all((p.labels or {}).get(k) == v
                                    for k, v in sel.items()))
                        pa_score += sign * weight * matches
            return (self.least_requested * least
                    + self.most_requested * most
                    + self.balanced * balanced
                    + self.node_affinity * affinity_score
                    + self.taint_toleration * taint_score
                    + self.pod_affinity * pa_score)

        ssn.add_node_order_fn(self.name(), node_order_fn)

    def on_session_close(self, ssn) -> None:
        pass
