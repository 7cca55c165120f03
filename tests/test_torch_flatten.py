"""The port's snapshot flatten (volcano_tpu_torch.ops.arrays) against the
JAX package's (volcano_tpu.ops.arrays): the same seeded cluster, built once
from each package's own api/models classes, must flatten to identical
arrays — node selectors, affinity and taints (the signature masks), running
and releasing pods (idle/used/future), queues with weights and
capabilities. Tolerance: exact (both are the same numpy code)."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("jax")  # the JAX reference: absent on the card's machine

import torch

import volcano_tpu.api as j_api
import volcano_tpu.models as j_models
import volcano_tpu.ops as j_ops
import volcano_tpu_torch.api as t_api
import volcano_tpu_torch.models as t_models
import volcano_tpu_torch.ops as t_ops

PACKAGES = {"jax": (j_api, j_models, j_ops), "torch": (t_api, t_models, t_ops)}

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
    api, models, _ = PACKAGES[pkg]
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


def flatten(pkg: str, spec, cache=None):
    jobs, nodes, tasks, queues = build_cluster(pkg, spec)
    arr = PACKAGES[pkg][2].flatten_snapshot(jobs, nodes, tasks,
                                            queues=queues, cache=cache)
    arr.fill_queue_demand()
    return arr


def jax_dict(arr):
    return arr.device_dict()


def torch_np_dict(arr):
    return arr.numpy_dict()


def assert_same_arrays(dj, dt):
    assert sorted(dj) == sorted(dt)
    for k in dj:
        a, b = np.asarray(dj[k]), np.asarray(dt[k])
        assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
        assert a.shape == b.shape, (k, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("seed,kw", [
    (0, {}),
    (1, {"gpu": True}),
    (2, {"constraints": False, "releasing": False}),
    (3, {"n_nodes": 37, "n_jobs": 9, "tasks_per_job": 5, "n_queues": 2}),
])
def test_flatten_identical_to_jax(seed, kw):
    spec = cluster_spec(seed, **kw)
    aj, at = flatten("jax", spec), flatten("torch", spec)
    assert (aj.T, aj.N, aj.R, aj.J) == (at.T, at.N, at.R, at.J)
    assert aj.queues_list == at.queues_list
    assert [n.name for n in aj.nodes_list] == [n.name for n in at.nodes_list]
    assert [t.name for t in aj.tasks_list] == [t.name for t in at.tasks_list]
    assert_same_arrays(jax_dict(aj), torch_np_dict(at))
    if kw.get("constraints", True):
        # the constraints really carved the signature masks
        assert at.sig_masks.shape[0] > 1 and not at.sig_masks.all()
        assert np.isfinite(at.queue_capability).any()
    if kw.get("releasing", True):
        assert (at.node_extra_future > 0).any()


def test_incremental_flatten_matches_cold():
    """A persistent FlattenCache re-diffs a changed snapshot to the same
    arrays a cold flatten gives, in both packages."""
    spec = cluster_spec(4)
    cache = t_ops.FlattenCache()
    flatten("torch", spec, cache=cache)
    spec2 = cluster_spec(4)
    spec2["jobs"] = spec2["jobs"][1:] + [dict(spec2["jobs"][0], name="jx",
                                              queue="q9")]
    spec2["jobs"][4]["reqs"][0] = {"cpu": "3", "memory": "7Gi"}
    spec2["nodes"][3]["resident"] = [("Running", {"cpu": "2",
                                                  "memory": "2Gi"})]
    warm = flatten("torch", spec2, cache=cache)
    assert cache.last_flatten_mode == "incremental"
    cold = flatten("torch", spec2)
    assert_same_arrays(cold.numpy_dict(), warm.numpy_dict())
    assert_same_arrays(jax_dict(flatten("jax", spec2)), warm.numpy_dict())


def test_bucket_matches_jax():
    for n in (1, 7, 8, 9, 40, 100, 500, 1000, 1001, 2000, 10000, 10001):
        assert t_ops.bucket(n) == j_ops.bucket(n)
    # the headline shape: 10k tasks, 2k nodes, 1000 jobs (+1 padding slot)
    assert (t_ops.bucket(10000), t_ops.bucket(2000),
            t_ops.bucket(1001)) == (10240, 2048, 1024)


def test_device_dict_is_torch_on_the_named_device():
    arr = flatten("torch", cluster_spec(5))
    d = arr.device_dict(device="cpu")
    host = arr.numpy_dict()
    assert sorted(d) == sorted(host)
    for k, v in d.items():
        assert isinstance(v, torch.Tensor) and v.device.type == "cpu", k
        assert v.numpy().dtype == host[k].dtype, k
        np.testing.assert_array_equal(v.numpy(), host[k], err_msg=k)
    # a copy, not a view of the flatten's reusable buffers
    d["node_idle"][0, 0] = -1.0
    assert arr.node_idle[0, 0] != -1.0
