"""The port's snapshot flatten (volcano_tpu_torch.ops.arrays) against the
JAX package's (volcano_tpu.ops.arrays): the same seeded cluster, built once
from each package's own api/models classes, must flatten to identical
arrays — node selectors, affinity and taints (the signature masks), running
and releasing pods (idle/used/future), queues with weights and
capabilities. Tolerance: exact (both are the same numpy code)."""

from __future__ import annotations

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

from torch_helpers import build_cluster, cluster_spec  # noqa: F401

PACKAGES = {"jax": (j_api, j_models, j_ops), "torch": (t_api, t_models, t_ops)}


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
