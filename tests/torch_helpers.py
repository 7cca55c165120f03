"""Store-level cluster builders for both packages (the port's own models
for the port, the JAX package's for the reference) plus a seeded
churning cluster that drives either package's Scheduler through the same
cycles.

``SeededCluster(pkg, spec_seed, ...)`` holds one ClusterStore, a
SchedulerCache on FakeBinder/FakeEvictor and a Scheduler of package
``pkg`` ("jax" or "torch"); ``cycle()`` submits the next seeded wave of
gangs, completes a seeded share of the running pods (churn) and runs one
cycle. Everything random comes from a numpy Generator seeded once, so two
instances with the same seed apply the same mutations in the same order.
"""

from __future__ import annotations

import importlib
from typing import Dict, Optional

import numpy as np

PACKAGES = {"jax": "volcano_tpu", "torch": "volcano_tpu_torch"}

BINPACK_CONF = """
actions: "enqueue, allocate, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: binpack
"""


def pkg_mod(pkg: str, sub: str):
    return importlib.import_module(f"{PACKAGES[pkg]}.{sub}")


def build_pod(models, ann_key, namespace: str, name: str, node_name: str,
              phase: str, req: Dict[str, str], group_name: str = "",
              priority: Optional[int] = None,
              node_selector: Optional[Dict[str, str]] = None):
    ann = {ann_key: group_name} if group_name else {}
    return models.Pod(name=name, namespace=namespace, node_name=node_name,
                      phase=phase, annotations=ann,
                      node_selector=node_selector or {},
                      containers=[{"requests": dict(req)}],
                      priority=priority)


def build_node(models, name: str, alloc: Dict[str, str],
               labels: Optional[Dict[str, str]] = None, pods: str = "110"):
    rl = dict(alloc)
    rl.setdefault("pods", pods)
    return models.Node(name=name, labels=labels or {}, allocatable=rl,
                       capacity=dict(rl))


def build_pod_group(models, name: str, namespace: str, min_member: int,
                    queue: str, phase=None):
    return models.PodGroup(
        name=name, namespace=namespace,
        spec=models.PodGroupSpec(min_member=min_member, queue=queue),
        status=models.PodGroupStatus(
            phase=phase or models.PodGroupPhase.PENDING))


def build_queue(models, name: str, weight: int = 1,
                annotations: Optional[Dict[str, str]] = None,
                reclaimable: Optional[bool] = None):
    return models.Queue(name=name, annotations=annotations or {},
                        spec=models.QueueSpec(weight=weight,
                                              reclaimable=reclaimable))


def hierarchy_annotations(path: str, weights: str) -> Dict[str, str]:
    """The drf hierarchy's queue annotations (hdrf)."""
    return {"volcano.sh/hierarchy": path,
            "volcano.sh/hierarchy-weights": weights}


class SeededCluster:
    """One package's store + cache + scheduler over a seeded cluster."""

    def __init__(self, pkg: str, seed: int, n_nodes: int = 12,
                 n_queues: int = 3, conf: Optional[str] = None,
                 device="cpu", node_cpu: int = 16, node_mem_gi: int = 64,
                 zones: int = 0, hierarchy=None):
        self.pkg = pkg
        self.models = pkg_mod(pkg, "models")
        self.ann_key = pkg_mod(pkg, "api").POD_GROUP_ANNOTATION
        cache_mod = pkg_mod(pkg, "cache")
        client = pkg_mod(pkg, "client")
        self.rng = np.random.default_rng(seed)
        self.store = client.ClusterStore()
        kw = {"device": device} if pkg == "torch" else {}
        self.cache = cache_mod.SchedulerCache(self.store, **kw)
        self.cache.binder = cache_mod.FakeBinder()
        self.cache.evictor = cache_mod.FakeEvictor()
        self.cache.run()
        m = self.models
        # hierarchy: per queue (path, weights) annotations for the drf
        # hierarchy (hdrf), cycled over the queues
        for q in range(n_queues):
            ann = (hierarchy_annotations(*hierarchy[q % len(hierarchy)])
                   if hierarchy else None)
            self.store.apply("queues", build_queue(m, f"q{q}", weight=q + 1,
                                                   annotations=ann))
        for i in range(n_nodes):
            labels = {"zone": f"z{i % zones}"} if zones else {}
            self.store.create("nodes", build_node(
                m, f"n{i:03d}", {"cpu": str(node_cpu),
                                 "memory": f"{node_mem_gi}Gi"}, labels))
        self.n_queues = n_queues
        self.zones = zones
        self.k = 0
        self.running: list = []   # (name, namespace) of bound pods
        sched_mod = pkg_mod(pkg, "scheduler")
        self.sched = sched_mod.Scheduler(self.cache, scheduler_conf=conf)

    def submit_gangs(self, n_gangs: int, tasks: int = 4) -> None:
        m = self.models
        for _ in range(n_gangs):
            k = self.k
            self.k += 1
            q = f"q{int(self.rng.integers(0, self.n_queues))}"
            size = int(self.rng.integers(1, tasks + 1))
            min_member = int(self.rng.integers(1, size + 1))
            prio = int(self.rng.integers(0, 3))
            sel = ({"zone": f"z{int(self.rng.integers(0, self.zones))}"}
                   if self.zones and k % 4 == 0 else None)
            self.store.create("podgroups", build_pod_group(
                m, f"g{k}", "ns", min_member, q))
            for i in range(size):
                req = {"cpu": str(int(self.rng.integers(1, 5))),
                       "memory": f"{int(self.rng.integers(1, 9))}Gi"}
                self.store.create("pods", build_pod(
                    m, self.ann_key, "ns", f"g{k}-{i}", "", "Pending", req,
                    f"g{k}", priority=prio, node_selector=sel))

    def complete_some(self, frac: float) -> None:
        """Delete a seeded share of the bound pods (jobs finishing)."""
        bound = sorted(self.cache.binder.binds)
        pick = [b for b in bound if self.rng.random() < frac]
        for key in pick:
            ns, name = key.split("/")
            if self.store.try_get("pods", name, ns) is not None:
                self.store.delete("pods", name, ns)
            del self.cache.binder.binds[key]

    def cycle(self, n_gangs: int, churn: float = 0.0, tasks: int = 4):
        self.complete_some(churn)
        self.submit_gangs(n_gangs, tasks)
        before = dict(self.cache.binder.binds)
        self.sched.run_once()
        after = self.cache.binder.binds
        return sorted((k, v) for k, v in after.items()
                      if before.get(k) != v)


class Lifecycle:
    """One package's job-lifecycle modules (models, store, admission,
    controllers, scheduler), by the names the lifecycle scenarios use.
    The port's cache runs on ``device="cpu"``."""

    def __init__(self, pkg: str):
        self.pkg = pkg
        self.m = pkg_mod(pkg, "models")
        self.ann = pkg_mod(pkg, "api").POD_GROUP_ANNOTATION
        client = pkg_mod(pkg, "client")
        self.ClusterStore = client.ClusterStore
        self.AdmissionError = client.AdmissionError
        self.controllers = pkg_mod(pkg, "controllers")
        self.job_controller = pkg_mod(pkg, "controllers.job.controller")
        self.webhooks = pkg_mod(pkg, "webhooks")
        self.metrics = pkg_mod(pkg, "metrics").metrics

    def cache(self, store):
        kw = {"device": "cpu"} if self.pkg == "torch" else {}
        return pkg_mod(self.pkg, "cache").SchedulerCache(store, **kw)

    def scheduler(self, cache, conf=None):
        return pkg_mod(self.pkg, "scheduler").Scheduler(
            cache, scheduler_conf=conf)


def _value(x):
    return getattr(x, "value", x)


def lifecycle_state(store) -> dict:
    """What the job lifecycle has left in ``store``, keyed by namespace
    and name (uids come from a process-wide counter per package, so they
    never compare across packages): each job's phase and status counts,
    each pod's node, phase and termination mark, each podgroup's phase
    (a bare pod's podgroup, named after the pod's uid, by its owner's
    name), each queue's state and counts, and the names of the commands
    and of the plugins' objects."""
    def pg_name(pg):
        if pg.name.startswith("podgroup-") and pg.owner_references:
            return "podgroup-of-" + pg.owner_references[0]["name"]
        return pg.name

    out = {
        "jobs": sorted(
            (j.namespace, j.name, _value(j.status.state.phase),
             j.status.retry_count, j.status.version, j.status.pending,
             j.status.running, j.status.succeeded, j.status.failed,
             j.status.terminating, j.status.min_available)
            for j in store.list("jobs")),
        "pods": sorted(
            (p.namespace, p.name, p.node_name, p.phase,
             p.deletion_timestamp is not None)
            for p in store.list("pods")),
        "podgroups": sorted(
            (pg.namespace, pg_name(pg), _value(pg.status.phase),
             pg.spec.min_member, pg.spec.queue)
            for pg in store.list("podgroups")),
        "queues": sorted(
            (q.name, _value(q.status.state), q.status.pending,
             q.status.running, q.status.inqueue, q.status.unknown)
            for q in store.list("queues")),
    }
    for kind in ("commands", "configmaps", "services", "secrets",
                 "networkpolicies", "pvcs"):
        out[kind] = sorted((o.namespace, o.name) for o in store.list(kind))
    return out
