"""The JAX package's headline path on the port, on the CPU: churned
sessions pipelined through one arena by ``SessionPipeline``.

bench.py ``headline()`` churns its problem every session (jobs rotated out
of the pending set, node rows dirtied through NodeInfo.add_task /
remove_task), flattens through one FlattenCache, packs, diffs against one
device-resident arena and runs the sessions through
``ops.pipeline.SessionPipeline`` at depth 2, collecting each with its
readback. chip_smoke.py's ``HeadlineSessions`` is the port's counterpart;
here both run on the same seeded problem at a small size (64 nodes, 40
jobs of 5 tasks, 2 jobs and 4 node rows churned a session) and every
pipelined session's ``assigned`` and ``kind`` must equal the JAX
package's (its ``plan_delta`` + ``solve_allocate_delta`` /
``solve_allocate_packed2d`` op by op under ``jax.disable_jit``, through
its own SessionPipeline) and a cold solve of the same buffers. Tolerance:
exact.

Also held: session 0 of a gated run collects only after session 1 has
scattered into the arena and dispatched, and still equals its cold solve;
``Scheduler(pipeline_solver=False)`` (the standalone's --serial-solver)
binds as the pipelined Scheduler does and as the JAX package's serial
one, cycle by cycle. On the card, ``test_headline_phase_on_card`` runs
the chip_smoke phase at a reduced size; this module imports JAX only
inside the tests that hold the port to it (the card's machine has none).
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

import chip_smoke
from torch_helpers import SeededCluster, pkg_mod

#: the headline run at the test's size
SMALL = dict(chip_smoke.HEADLINE_RUN, n_nodes=64, n_jobs=40,
             tasks_per_job=5, churn_jobs=2, churn_nodes=4, cpu="8",
             mem="32Gi")
PIPELINED = 6
FIRST = 8 + 4 * SMALL["sessions"]   # bench.py's first pipelined session


@pytest.fixture
def jax():
    """The JAX reference (absent on the card's machine)."""
    return pytest.importorskip("jax")


class JaxHeadline:
    """bench.py headline()'s session path on the JAX package, at ``sc``:
    its make_problem and churn script (:257-285), SnapshotArrays
    .fill_queue_demand, one FlattenCache and one PackedDeviceCache,
    ``_params`` from __graft_entry__. Every device op runs under
    ``jax.disable_jit`` (XLA's CPU jit contracts FMAs, see
    test_torch_solver.py)."""

    def __init__(self, sc: dict):
        import bench
        from volcano_tpu.ops import FlattenCache, PackedDeviceCache
        self.jobs, self.nodes, tasks, self.queues = bench.make_problem(
            sc["n_nodes"], sc["n_jobs"], sc["tasks_per_job"], cpu=sc["cpu"],
            mem=sc["mem"], n_queues=3, queue_weights=[1, 2, 3])
        self.sc = sc
        self.node_list = list(self.nodes.values())
        self.tasks_by_job = {}
        for t in tasks:
            self.tasks_by_job.setdefault(t.job, []).append(t)
        self.held = {}
        self.fcache = FlattenCache()
        self.dc = PackedDeviceCache()

    def churn(self, s):
        from volcano_tpu.api import TaskInfo, TaskStatus
        from volcano_tpu.api.types import POD_GROUP_ANNOTATION
        from volcano_tpu.models import Pod
        n_jobs, n_nodes = self.sc["n_jobs"], self.sc["n_nodes"]
        cj, cn = self.sc["churn_jobs"], self.sc["churn_nodes"]
        lo = (s * cj) % n_jobs
        excl = {f"bench/j{(lo + d) % n_jobs}" for d in range(cj)}
        jobs_s = {u: j for u, j in self.jobs.items() if u not in excl}
        grouped_s = [(j, self.tasks_by_job[u]) for u, j in jobs_s.items()]
        tasks_s = [t for _, ts in grouped_s for t in ts]
        for d in range(cn):
            ni = self.node_list[(s * cn + d) % n_nodes]
            t = self.held.pop(ni.name, None)
            if t is not None:
                ni.remove_task(t)
            else:
                pod = Pod(name=f"churn-{ni.name}", namespace="bench",
                          node_name=ni.name, phase="Running",
                          annotations={POD_GROUP_ANNOTATION: "j0"},
                          containers=[{"requests": {"cpu": "1",
                                                    "memory": "1Gi"}}])
                t = TaskInfo(pod)
                t.status = TaskStatus.RUNNING
                ni.add_task(t)
                self.held[ni.name] = t
        return jobs_s, tasks_s, grouped_s

    def pack(self, s):
        from __graft_entry__ import _params
        from volcano_tpu.ops import flatten_snapshot
        jobs_s, tasks_s, grouped_s = self.churn(s)
        arr = flatten_snapshot(jobs_s, self.nodes, tasks_s,
                               cache=self.fcache, queues=self.queues,
                               grouped=grouped_s)
        arr.fill_queue_demand()
        fbuf, ibuf, layout = arr.packed()
        return fbuf, ibuf, layout, _params(arr)

    def dispatch(self, fbuf, ibuf, layout, params):
        """plan_delta, then the fused delta solve (commit) or the packed
        solve, as bench.py's sessions do."""
        from volcano_tpu.ops import solver as js
        kind, payload = self.dc.plan_delta(fbuf, ibuf, layout)
        if kind == "updated":
            return js.solve_allocate_packed2d(*payload, layout, params,
                                              use_queue_cap=True)
        res, nf, ni = js.solve_allocate_delta(*payload, layout, params,
                                              use_queue_cap=True)
        self.dc.commit(nf, ni)
        return res

    def run(self, first: int, n: int) -> list:
        """The synchronous sessions' churn, the last of them solved (host
        params) so that the arena holds its buffers, then sessions
        first .. first + n - 1 through the JAX package's
        SessionPipeline(depth), params pinned: each session's decoded
        (assigned, kind) and its (shipped chunks, full ship)."""
        import jax

        from volcano_tpu.ops.pipeline import SessionPipeline, start_readback
        from volcano_tpu.ops.solver import decode_compact
        out = []
        last = self.sc["warm"] + self.sc["sessions"] - 1
        for s in range(last):
            self.churn(s)
        with jax.disable_jit():
            self.dispatch(*self.pack(last))
            pipe = SessionPipeline(depth=self.sc["depth"])
            try:
                for i in range(n):
                    fbuf, ibuf, layout, params = self.pack(first + i)
                    pdev = self.dc.params_device(params)

                    def dispatch(fbuf=fbuf, ibuf=ibuf, layout=layout,
                                 pdev=pdev):
                        res = self.dispatch(fbuf, ibuf, layout, pdev)
                        start_readback(res.compact)
                        return res

                    pipe.submit(i, dispatch, lambda r: decode_compact(
                        np.asarray(r.compact)))
                    out.append((self.dc.last_shipped_chunks,
                                self.dc.last_full_ship))
                tickets = pipe.drain(timeout=600)
            finally:
                pipe.close()
        return [(t.result(), acct) for t, acct in zip(tickets, out)]


def port_headline(sc=SMALL):
    """The port's HeadlineSessions on the CPU, through its warm-up and
    synchronous sessions."""
    h = chip_smoke.HeadlineSessions("cpu", sc)
    for s in range(sc["warm"] + sc["sessions"]):
        h.sync(s)
    return h


def test_pipelined_sessions_equal_jax_and_cold(jax):
    h = port_headline()
    run = h.pipelined(FIRST, PIPELINED, SMALL["depth"])
    want = JaxHeadline(SMALL).run(FIRST, PIPELINED)
    assert [t.tag for t in run["tickets"]] == \
        list(range(FIRST, FIRST + PIPELINED))
    for t, ((ja, jk), jax_arena), (_, chunks, full) in zip(
            run["tickets"], want, run["arena"]):
        a, k = t.result()
        assert np.array_equal(a, ja) and np.array_equal(k, jk), t.tag
        assert (a >= 0).any(), t.tag
        # the same dirty chunks cross, and neither package re-ships
        assert (chunks, full) == jax_arena and not full, t.tag
    assert chip_smoke.headline_identical(h, run, plain=True) == 0
    assert h.dc.delta_sessions == h.dc.sessions - 1
    assert chip_smoke.arena_equals_mirror(h.dc)


def test_gated_collect_equals_cold_and_jax(jax):
    """Session 0's collect waits until session 1 has scattered its dirty
    chunks into the arena and dispatched its solve; depth 2 then admits
    session 2 only once 0 is collected. Every session equals its cold
    solve and the JAX package's solve of the same packed buffers."""
    import jax.numpy as jnp

    from volcano_tpu.ops import solver as js
    h = port_headline()
    run = h.pipelined(FIRST, 3, SMALL["depth"], gated=True)
    order = run["events"]
    assert order.index(("dispatch", 1)) < order.index(("collect", 0)) \
        < order.index(("dispatch", 2)), order
    assert h.dc.sessions - h.dc.delta_sessions == 1
    chip_smoke.headline_identical(h, run, plain=False)
    with jax.disable_jit():
        for t, (fbuf, ibuf, layout, _, params) in zip(run["tickets"],
                                                      run["refs"]):
            c = h.dc.chunk
            bufs = []
            for buf in (fbuf, ibuf):
                pad = np.zeros(-(-buf.size // c) * c, buf.dtype)
                pad[:buf.size] = buf
                bufs.append(jnp.asarray(pad.reshape(-1, c)))
            res = js.solve_allocate_packed2d(*bufs, layout, params,
                                             use_queue_cap=True)
            ja, jk = js.decode_compact(np.asarray(res.compact))
            a, k = t.result()
            assert np.array_equal(a, ja) and np.array_equal(k, jk), t.tag
    assert chip_smoke.arena_equals_mirror(h.dc)


def test_gated_session_is_released_even_when_a_submit_fails(monkeypatch):
    """A failure while the gated session 0 is held (session 1's pack
    raises) closes the pipeline without leaving its collector blocked."""
    h = port_headline()
    real = h.pack

    def pack(s):
        if s == FIRST + 1:
            raise RuntimeError("injected pack failure")
        return real(s)

    def collectors():
        return {t for t in threading.enumerate()
                if t.name == "session-collector" and t.is_alive()}

    monkeypatch.setattr(h, "pack", pack)
    before = collectors()
    with pytest.raises(RuntimeError, match="injected pack failure"):
        h.pipelined(FIRST, 3, SMALL["depth"], gated=True)
    assert collectors() <= before


def test_headline_phase_needs_cuda():
    with pytest.raises(AssertionError, match="CUDA"):
        chip_smoke.phase_headline("cpu", SMALL)


def _cycles(pkg: str, pipelined: bool, cycles: int = 4) -> list:
    import jax
    c = SeededCluster(pkg, 29, n_nodes=8)
    c.sched = pkg_mod(pkg, "scheduler").Scheduler(
        c.cache, pipeline_solver=pipelined)
    stream = []
    for cycle in range(cycles):
        churn = 0.3 if cycle else 0.0
        if pkg == "jax":
            with jax.disable_jit():
                stream.append(c.cycle(4, churn=churn))
        else:
            stream.append(c.cycle(4, churn=churn))
        assert "overlap_ms" in c.sched.last_cycle_timing or not pipelined
    if not pipelined:
        assert "overlap_ms" not in c.sched.last_cycle_timing
        assert "readback_ms" in c.sched.last_cycle_timing
    return stream


def test_serial_solver_binds_as_pipelined_and_jax(jax):
    serial = _cycles("torch", pipelined=False)
    assert serial == _cycles("torch", pipelined=True)
    assert serial == _cycles("jax", pipelined=False)
    assert sum(len(b) for b in serial) > 10


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_headline_phase_on_card(cuda_device):
    row = chip_smoke.phase_headline(cuda_device, dict(
        SMALL, cpu="32", mem="128Gi", n_nodes=200, n_jobs=100,
        tasks_per_job=10, churn_jobs=10, churn_nodes=20))
    assert row["identical_to_cold"] and row["launches"] > 0
    assert row["gated"]["launches_checked"] > 0
