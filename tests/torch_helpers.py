"""Store-level cluster builders for both packages (the port's own models
for the port, the JAX package's for the reference) plus a seeded
churning cluster that drives either package's Scheduler through the same
cycles.

``cluster_spec(seed, ...)`` is a seeded cluster as plain data and
``build_cluster(pkg, spec)`` its jobs, nodes, tasks and queues in either
package; ``hdrf_flatten(pkg, seed, tree, ...)`` flattens one whose queues
carry a drf hierarchy (``RESCALING``, ``RAGGED``, ``EXAMPLE``), with the
hdrf tree built. None of them needs JAX for the port.

``SeededCluster(pkg, spec_seed, ...)`` holds one ClusterStore, a
SchedulerCache on FakeBinder/FakeEvictor and a Scheduler of package
``pkg`` ("jax" or "torch"); ``cycle()`` submits the next seeded wave of
gangs, completes a seeded share of the running pods (churn) and runs one
cycle. Everything random comes from a numpy Generator seeded once, so two
instances with the same seed apply the same mutations in the same order.
"""

from __future__ import annotations

import dataclasses
import importlib
from types import SimpleNamespace
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


ZONES = ("a", "b", "c")


def cluster_spec(seed: int, n_nodes: int = 24, n_jobs: int = 12,
                 tasks_per_job: int = 4, n_queues: int = 3,
                 constraints: bool = True, releasing: bool = True,
                 gpu: bool = False):
    """A seeded cluster as plain data (numpy rng), buildable by either
    package: node sizes, labels, taints and resident pods; jobs with gang
    sizes, queues, per-task requests and placement constraints."""
    rng = np.random.default_rng(seed)
    nodes = []
    for i in range(n_nodes):
        rl = {"cpu": str(int(rng.integers(2, 9))),
              "memory": f"{int(rng.integers(4, 17))}Gi", "pods": 110}
        if gpu and i % 2 == 0:
            rl["nvidia.com/gpu"] = 4
        taints = []
        if constraints and i % 5 == 0:
            taints = [{"key": "dedicated", "value": "batch",
                       "effect": "NoSchedule"}]
        resident = []
        if releasing and i % 4 == 1:
            resident.append(("Running", {"cpu": "1", "memory": "1Gi"}))
        if releasing and i % 6 == 2:
            resident.append(("Releasing", {"cpu": "1", "memory": "2Gi"}))
        nodes.append({"name": f"n{i}", "alloc": rl,
                      "labels": {"zone": ZONES[i % 3]}, "taints": taints,
                      "resident": resident})
    jobs = []
    for k in range(n_jobs):
        tasks = []
        for _ in range(tasks_per_job):
            req = {"cpu": str(int(rng.integers(1, 4))),
                   "memory": f"{int(rng.integers(1, 5))}Gi"}
            if gpu and k % 3 == 0:
                req["nvidia.com/gpu"] = 1
            tasks.append(req)
        kind = k % 5 if constraints else 0
        jobs.append({"name": f"j{k}", "queue": f"q{k % n_queues}",
                     "min": int(rng.integers(1, tasks_per_job + 1)),
                     "reqs": tasks, "constraint": kind})
    queues = [{"name": f"q{i}", "weight": i + 1,
               "capability": {"cpu": "40"} if i == n_queues - 1 else None}
              for i in range(n_queues)]
    return {"nodes": nodes, "jobs": jobs, "queues": queues}


def build_cluster(pkg: str, spec):
    """(jobs, nodes, tasks_in_order, queues) of one package from a spec."""
    api, models = pkg_mod(pkg, "api"), pkg_mod(pkg, "models")
    ann_key = api.POD_GROUP_ANNOTATION
    nodes = {}
    for n in spec["nodes"]:
        ni = api.NodeInfo(models.Node(
            name=n["name"], labels=dict(n["labels"]),
            allocatable=dict(n["alloc"]), capacity=dict(n["alloc"]),
            taints=[dict(t) for t in n["taints"]]))
        for r, (phase, req) in enumerate(n["resident"]):
            pod = models.Pod(name=f"{n['name']}-res{r}", namespace="sys",
                             node_name=n["name"], phase="Running",
                             containers=[{"requests": dict(req)}])
            t = api.TaskInfo(pod)
            t.status = (api.TaskStatus.RELEASING if phase == "Releasing"
                        else api.TaskStatus.RUNNING)
            ni.add_task(t)
        nodes[n["name"]] = ni
    jobs, tasks = {}, []
    for j in spec["jobs"]:
        pg = models.PodGroup(name=j["name"], namespace="ns",
                             spec=models.PodGroupSpec(min_member=j["min"],
                                                      queue=j["queue"]))
        job = api.JobInfo(f"ns/{j['name']}", pg)
        for i, req in enumerate(j["reqs"]):
            kw = {}
            c = j["constraint"]
            if c == 1:
                kw["node_selector"] = {"zone": "b"}
            elif c == 2:
                kw["tolerations"] = [{"key": "dedicated", "operator": "Equal",
                                      "value": "batch",
                                      "effect": "NoSchedule"}]
            elif c == 3:
                kw["affinity"] = {"nodeAffinity": {
                    "requiredDuringSchedulingIgnoredDuringExecution": {
                        "nodeSelectorTerms": [{"matchExpressions": [
                            {"key": "zone", "operator": "In",
                             "values": ["a", "c"]}]}]}}}
            pod = models.Pod(name=f"{j['name']}-{i}", namespace="ns",
                             annotations={ann_key: j["name"]},
                             containers=[{"requests": dict(req)}], **kw)
            t = api.TaskInfo(pod)
            job.add_task_info(t)
            tasks.append(t)
        jobs[job.uid] = job
    queues = {q["name"]: SimpleNamespace(weight=q["weight"],
                                         capability=q["capability"])
              for q in spec["queues"]}
    return jobs, nodes, tasks, queues


#: the rescaling tree of tests/test_fairshare.py TestHDRF (uniform depth
#: under eng, sci one level up) and the ragged trees of its
#: TestHDRFRaggedParity
RESCALING = [("root/sci", "100/50"), ("root/eng/dev", "100/50/50"),
             ("root/eng/prod", "100/50/50")]
RAGGED = [("root/a", "100/3"), ("root/a/b", "100/3/2"),
          ("root/a/c", "100/3/1"), ("root/d", "100/2"),
          ("root/d/e/f", "100/2/4/1"), ("root/g", "100/1"),
          ("root/g/h", "100/1/2")]
#: example/hierarchical-jobs.yaml's three leaf queues
EXAMPLE = [("root/eng/prod", "1/2/8"), ("root/eng/dev", "1/2/2"),
           ("root/sci", "1/2")]


def hdrf_flatten(pkg: str, seed: int, tree, n_queues: int = 4, **spec_kw):
    """A seeded flatten of package ``pkg`` whose queues carry the drf
    hierarchy (``tree`` cycled over the queues), with seeded integral drf
    allocations, a drf total and the hdrf tree built."""
    api, ops = pkg_mod(pkg, "api"), pkg_mod(pkg, "ops")
    spec = cluster_spec(seed, n_queues=n_queues, **spec_kw)
    jobs, nodes, tasks, queues = build_cluster(pkg, spec)
    for i, q in enumerate(sorted(queues)):
        queues[q].hierarchy, queues[q].weights = tree[i % len(tree)]
    arr = ops.flatten_snapshot(jobs, nodes, tasks, queues=queues)
    rng = np.random.default_rng(seed + 1000)
    nj = len(arr.jobs_list)
    arr.drf_total = (arr.node_alloc * arr.node_valid[:, None]).sum(
        axis=0).astype(np.float32)
    # integral allocations, so saturation compares exactly
    arr.job_drf_allocated[:nj, 0] = 1000.0 * rng.integers(0, 4, nj)
    arr.job_drf_allocated[:nj, 1] = float(1 << 30) * rng.integers(0, 4, nj)
    arr.job_drf_prerank[:nj] = rng.integers(0, 2, nj)
    total = api.Resource(
        milli_cpu=float(arr.job_drf_allocated[:, 0].sum()),
        memory=float(arr.job_drf_allocated[:, 1].sum()))
    pkg_mod(pkg, "ops.hdrf").build_hdrf(arr, queues, {}, total)
    return arr


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


class Builders:
    """tests/helpers.py's builders (same signatures, same defaults) over
    one package's models, so a reference scenario reads the same
    through either package."""

    def __init__(self, pkg: str):
        self.models = pkg_mod(pkg, "models")
        self.ann_key = pkg_mod(pkg, "api").POD_GROUP_ANNOTATION

    def build_pod(self, namespace: str, name: str, node_name: str,
                  phase: str, req: Dict[str, str], group_name: str = "",
                  labels: Optional[Dict[str, str]] = None,
                  node_selector: Optional[Dict[str, str]] = None,
                  priority: Optional[int] = None):
        ann = {self.ann_key: group_name} if group_name else {}
        return self.models.Pod(
            name=name, namespace=namespace, node_name=node_name,
            phase=phase, annotations=ann, labels=labels or {},
            node_selector=node_selector or {},
            containers=[{"requests": dict(req)}], priority=priority)

    def build_node(self, name: str, alloc: Dict[str, str],
                   labels: Optional[Dict[str, str]] = None,
                   pods: str = "110"):
        return build_node(self.models, name, alloc, labels, pods)

    def build_pod_group(self, name: str, namespace: str = "default",
                        min_member: int = 1, queue: str = "default",
                        phase=None,
                        min_resources: Optional[Dict[str, str]] = None):
        m = self.models
        return m.PodGroup(
            name=name, namespace=namespace,
            spec=m.PodGroupSpec(min_member=min_member, queue=queue,
                                min_resources=min_resources or {}),
            status=m.PodGroupStatus(
                phase=phase or m.PodGroupPhase.INQUEUE))

    def build_queue(self, name: str, weight: int = 1,
                    capability: Optional[Dict[str, str]] = None,
                    reclaimable: Optional[bool] = None,
                    annotations: Optional[Dict[str, str]] = None):
        m = self.models
        return m.Queue(name=name, annotations=annotations or {},
                       spec=m.QueueSpec(weight=weight,
                                        capability=capability or {},
                                        reclaimable=reclaimable))


#: the store kinds a scheduler session reads, in the order a twin copies
#: them (queues and classes before the jobs that name them)
SESSION_KINDS = ("queues", "priorityclasses", "pvcs", "nodes", "podgroups",
                 "pods")


def _jax_copy(obj):
    """A JAX-package copy of a port object, by the wire codec the two
    packages share byte for byte, with no resource version (the copy
    takes its store's own sequence)."""
    from volcano_tpu.client.codec import decode
    from volcano_tpu_torch.client.codec import encode
    twin = decode(encode(obj))
    twin.resource_version = 0
    return twin


def jax_cache(port_store):
    """A JAX-package SchedulerCache on FakeBinder/FakeEvictor over a copy
    of ``port_store``'s session kinds."""
    from volcano_tpu.cache import FakeBinder, FakeEvictor, SchedulerCache
    from volcano_tpu.client import ClusterStore

    cache = SchedulerCache(ClusterStore())
    cache.binder, cache.evictor = FakeBinder(), FakeEvictor()
    cache.run()
    for kind in SESSION_KINDS:
        for obj in port_store.list(kind):
            cache.cluster.apply(kind, _jax_copy(obj))
    return cache


def jax_conf(tiers, configurations=()):
    """The port's ``tiers`` and ``configurations`` rebuilt from the JAX
    package's conf classes."""
    from volcano_tpu.conf import Configuration, PluginOption, Tier

    j_tiers = [Tier(plugins=[PluginOption(**{
        f.name: getattr(p, f.name) for f in dataclasses.fields(p)})
        for p in t.plugins]) for t in tiers]
    j_confs = [Configuration(c.name, dict(c.arguments))
               for c in configurations]
    return j_tiers, j_confs


def jax_open_session(port_store, tiers, configurations=()):
    """(cache, session) of the JAX package over a copy of ``port_store``,
    opened with the port's ``tiers`` and ``configurations``."""
    from volcano_tpu.framework import open_session

    cache = jax_cache(port_store)
    return cache, open_session(cache, *jax_conf(tiers, configurations))


def jax_session_binds(port_store, tiers, configurations=(),
                      actions=("allocate",)) -> dict:
    """Run ``actions`` in one JAX-package session over a copy of
    ``port_store`` (every object carried across by the wire codec the two
    packages share byte for byte) on FakeBinder/FakeEvictor, with the
    port's ``tiers`` and ``configurations``. Returns the JAX binds, keyed
    as ``FakeBinder.binds`` is. The JAX solver runs jitted: these sessions
    are small enough that no score tie parts the two arithmetics."""
    from volcano_tpu.framework import close_session, get_action

    cache, ssn = jax_open_session(port_store, tiers, configurations)
    for name in actions:
        get_action(name).execute(ssn)
    close_session(ssn)
    return dict(cache.binder.binds)


class JaxTwin:
    """A JAX-package Scheduler on FakeBinder/FakeEvictor over its own
    store, which follows every write made to the port's store outside a
    cycle (codec copies). ``cycle(sched)`` runs one cycle of the port's
    Scheduler, then one of the twin's, with the following paused, so each
    package's cycle writes only its own store; it returns the twin's
    cycle timing. ``kwargs`` go to the twin's Scheduler (its conf)."""

    def __init__(self, port_store, kinds=SESSION_KINDS, **kwargs):
        from volcano_tpu.scheduler import Scheduler

        self.cache = jax_cache(port_store)
        self.store = self.cache.cluster
        self._paused = False
        for kind in kinds:
            port_store.watch(kind, self._follower(kind), replay=False)
        self.sched = Scheduler(self.cache, **kwargs)

    def _follower(self, kind):
        def follow(event, obj, old):
            if self._paused:
                return
            if event == "delete":
                self.store.delete(kind, obj.name,
                                  getattr(obj, "namespace", None))
            else:
                self.store.apply(kind, _jax_copy(obj))
        return follow

    def cycle(self, port_sched) -> dict:
        self._paused = True
        try:
            port_sched.run_once()
            self.sched.run_once()
        finally:
            self._paused = False
        return self.sched.last_cycle_timing
