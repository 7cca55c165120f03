"""Data-model tests, mirroring reference api/*_test.go tables:
tests/test_api.py through the port (its copy of ``api/``, host objects
only). Tolerance: exact."""

import pytest

from volcano_tpu_torch.api import (
    JobInfo, NodeInfo, Resource, ResourceVocab, TaskInfo, TaskStatus,
)
from volcano_tpu_torch.api.job_info import job_key_of_pod

from torch_helpers import Builders

_B = Builders("torch")
build_node, build_pod, build_pod_group = _B.build_node, _B.build_pod, _B.build_pod_group


class TestResource:
    def test_from_resource_list_units(self):
        r = Resource.from_resource_list(
            {"cpu": "2000m", "memory": "1Gi", "pods": "110", "nvidia.com/gpu": "1"})
        assert r.milli_cpu == 2000
        assert r.memory == 2**30
        assert r.max_task_num == 110
        assert r.scalars["nvidia.com/gpu"] == 1000

    def test_less_equal_thresholds(self):
        # within the minimum thresholds counts as equal
        a = Resource(milli_cpu=1009, memory=100)
        b = Resource(milli_cpu=1000, memory=100)
        assert a.less_equal(b)
        a = Resource(milli_cpu=1011, memory=100)
        assert not a.less_equal(b)
        # memory threshold is 1 byte
        a = Resource(milli_cpu=1000, memory=100.5)
        assert a.less_equal(b)
        # tiny scalar requests are ignored
        a = Resource(milli_cpu=10, scalars={"nvidia.com/gpu": 5})
        assert a.less_equal(Resource(milli_cpu=1000))
        # boundary is exclusive: |l-r| == threshold fails (reference abs(l-r) < diff)
        assert not Resource(milli_cpu=1010).less_equal(Resource(milli_cpu=1000))
        # no magnitude-scaled slack at large memory values
        assert not Resource(memory=64 * 2**30 + 2).less_equal(Resource(memory=64 * 2**30))

    def test_is_empty(self):
        assert Resource().is_empty()
        assert Resource(milli_cpu=9, memory=0.5).is_empty()
        assert not Resource(milli_cpu=100).is_empty()
        assert not Resource(scalars={"nvidia.com/gpu": 1000}).is_empty()

    def test_add_sub_clone(self):
        a = Resource(1000, 100, {"nvidia.com/gpu": 1000})
        b = a.clone()
        a.add(Resource(500, 50))
        assert a.milli_cpu == 1500 and b.milli_cpu == 1000
        a.sub(Resource(500, 50))
        assert a.milli_cpu == 1000 and a.memory == 100

    def test_sub_insufficient_raises(self):
        with pytest.raises(ValueError):
            Resource(100).sub(Resource(500))

    def test_set_max_and_min_dimension(self):
        a = Resource(1000, 100, {"nvidia.com/gpu": 1000})
        a.set_max_resource(Resource(500, 200, {"x": 5}))
        assert a.milli_cpu == 1000 and a.memory == 200 and a.scalars["x"] == 5
        a.min_dimension_resource(Resource(700, 300, {"nvidia.com/gpu": 0, "x": 9}))
        assert a.milli_cpu == 700 and a.memory == 200
        assert a.scalars["nvidia.com/gpu"] == 0

    def test_fit_delta(self):
        avail = Resource(1000, 100)
        avail.fit_delta(Resource(500, 0))
        assert avail.milli_cpu == 1000 - 500 - 10
        assert avail.memory == 100  # memory not requested

    def test_vector_roundtrip(self, vocab):
        r = Resource(1500, 2**20, {"nvidia.com/gpu": 2000})
        v = r.to_vector(vocab)
        assert v.shape == (3,)
        rt = Resource.from_vector(v, vocab)
        assert rt == r

    def test_vocab_collect(self):
        v = ResourceVocab.collect([
            Resource(scalars={"a": 1}), Resource(scalars={"b": 1, "a": 2})])
        assert v.scalar_names == ["a", "b"]
        assert list(v.thresholds()) == [10.0, 1.0, 10.0, 10.0]


class TestTaskJobInfo:
    def _pod(self, name, status="Pending", node="", group="pg1", cpu="1000m"):
        return build_pod("ns1", name, node, status, {"cpu": cpu, "memory": "100"},
                         group_name=group)

    def test_job_key_and_status(self):
        p = self._pod("p1")
        assert job_key_of_pod(p) == "ns1/pg1"
        t = TaskInfo(p)
        assert t.status == TaskStatus.PENDING
        t2 = TaskInfo(self._pod("p2", status="Running", node="n1"))
        assert t2.status == TaskStatus.RUNNING

    def test_add_delete_task_aggregates(self):
        job = JobInfo("ns1/pg1", build_pod_group("pg1", "ns1", min_member=2))
        t1 = TaskInfo(self._pod("p1", "Running", "n1"))
        t2 = TaskInfo(self._pod("p2", "Pending"))
        job.add_task_info(t1)
        job.add_task_info(t2)
        assert job.total_request.milli_cpu == 2000
        assert job.allocated.milli_cpu == 1000  # only running counts
        job.delete_task_info(t1)
        assert job.total_request.milli_cpu == 1000
        assert job.allocated.milli_cpu == 0

    def test_update_task_status_reindexes(self):
        job = JobInfo("ns1/pg1", build_pod_group("pg1", "ns1", min_member=2))
        t = TaskInfo(self._pod("p1"))
        job.add_task_info(t)
        assert len(job.task_status_index[TaskStatus.PENDING]) == 1
        job.update_task_status(t, TaskStatus.ALLOCATED)
        assert TaskStatus.PENDING not in job.task_status_index
        assert len(job.task_status_index[TaskStatus.ALLOCATED]) == 1
        assert job.allocated.milli_cpu == 1000

    def test_gang_readiness(self):
        job = JobInfo("ns1/pg1", build_pod_group("pg1", "ns1", min_member=2))
        t1, t2 = TaskInfo(self._pod("p1")), TaskInfo(self._pod("p2"))
        job.add_task_info(t1)
        job.add_task_info(t2)
        assert not job.ready()
        job.update_task_status(t1, TaskStatus.ALLOCATED)
        assert not job.ready()
        job.update_task_status(t2, TaskStatus.PIPELINED)
        assert not job.ready() and job.pipelined()
        job.update_task_status(t2, TaskStatus.ALLOCATED)
        assert job.ready()

    def test_best_effort_pending_counts_ready(self):
        job = JobInfo("ns1/pg1", build_pod_group("pg1", "ns1", min_member=1))
        p = build_pod("ns1", "be", "", "Pending", {}, group_name="pg1")
        job.add_task_info(TaskInfo(p))
        assert job.ready()  # empty InitResreq pending counts as occupied


class TestNodeInfo:
    def test_add_remove_accounting(self):
        ni = NodeInfo(build_node("n1", {"cpu": "4000m", "memory": "8Gi"}))
        assert ni.idle.milli_cpu == 4000
        running = TaskInfo(build_pod("ns1", "p1", "n1", "Running",
                                     {"cpu": "1000m", "memory": "0"}, "pg1"))
        ni.add_task(running)
        assert ni.idle.milli_cpu == 3000 and ni.used.milli_cpu == 1000
        releasing = TaskInfo(build_pod("ns1", "p2", "n1", "Running",
                                       {"cpu": "500m", "memory": "0"}, "pg1"))
        releasing.status = TaskStatus.RELEASING
        ni.add_task(releasing)
        assert ni.idle.milli_cpu == 2500
        assert ni.releasing.milli_cpu == 500
        pipelined = TaskInfo(build_pod("ns1", "p3", "", "Pending",
                                       {"cpu": "2000m", "memory": "0"}, "pg1"))
        pipelined.status = TaskStatus.PIPELINED
        ni.add_task(pipelined)
        assert ni.pipelined.milli_cpu == 2000
        # future idle = idle + releasing - pipelined
        assert ni.future_idle().milli_cpu == 2500 + 500 - 2000
        ni.remove_task(releasing)
        assert ni.idle.milli_cpu == 3000 and ni.releasing.milli_cpu == 0

    def test_add_task_insufficient(self):
        ni = NodeInfo(build_node("n1", {"cpu": "1000m", "memory": "100"}))
        big = TaskInfo(build_pod("ns1", "p", "", "Pending",
                                 {"cpu": "2000m", "memory": "0"}, "pg1"))
        big.status = TaskStatus.ALLOCATED
        with pytest.raises(ValueError):
            ni.add_task(big)
        assert ni.idle.milli_cpu == 1000  # unchanged

    def test_unready_node(self):
        n = build_node("n1", {"cpu": "1000m", "memory": "100"})
        n.unschedulable = True
        ni = NodeInfo(n)
        assert not ni.ready

    def test_unready_node_holds_tasks_without_accounting(self):
        # Tasks on an unready node are recorded but not accounted; when the
        # node turns ready, set_node replays them (reference node_info.go
        # keeps Node nil until ready).
        n = build_node("n1", {"cpu": "4000m", "memory": "100"})
        n.unschedulable = True
        ni = NodeInfo(n)
        t = TaskInfo(build_pod("ns1", "p1", "n1", "Running",
                               {"cpu": "1000m", "memory": "0"}, "pg1"))
        ni.add_task(t)  # must not raise
        assert ni.idle.milli_cpu == 0  # no accounting while unready
        n.unschedulable = False
        ni.set_node(n)
        assert ni.idle.milli_cpu == 3000 and ni.used.milli_cpu == 1000

    def test_sub_subtracts_missing_scalars(self):
        a = Resource(milli_cpu=1000)
        a.sub(Resource(milli_cpu=500, scalars={"nvidia.com/gpu": 8}))
        assert a.scalars["nvidia.com/gpu"] == -8  # no silent drift
