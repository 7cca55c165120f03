#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (volcano_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA GPU (an H100: the kernels are built for sm_90a) and the CUDA
toolkit; exits non-zero without them. Builds the port's kernels from the
checkout, then, printing one JSON line per phase:

1. device  - nvidia-smi name and power limit, torch's device name;
2. build   - nvcc of every kernel source; ptxas's registers, shared memory
             and spills per kernel (a spill fails the run);
3. kernel  - fused_choice against its plain PyTorch version at the headline
             shape (T=10240 tasks, N=2048 nodes) with R=2 and R=3, for each
             score-family set, with 90% and with 10% of the rows eligible,
             and at the hdrf cycles' shape (T=5120, N=1024, R=3, kube)
             with every row eligible:
             best_score, best_idx (every row, ties included) and node_max
             equal bit for bit. `ms` is device time per call
             (torch.profiler, the sum of the kernels one call launches,
             over 50 calls), the median of 5 such readings (all in
             `ms_readings`); `call_ms` is CUDA events around 50
             back-to-back calls, host pace included;
4. edges   - shapes off every tile (T = 1, N = 1, 37 x 45, ...), no row or
             only the last row eligible, ties across node-tile boundaries:
             checked like the kernel phase, not timed;
5. small   - a small seeded solve on the card (fused kernel) against the
             same solve on the host (dense path): identical results;
6. solve   - the headline allocate solve (1000 gangs x 10 pods over 2000
             nodes, 3 queues weighted 1:2:3) through the port's entry
             points, fused kernel vs dense path on the card, in three arms:
             binpack/pack with queue caps, the same with live DRF order,
             and kube/spread scoring. Checks: identical kind and job_ready,
             assignment differences only between score-tied nodes, no node
             over its idle, gangs all-or-nothing, kernel launches counted
             on the fused run only. One more untimed run of the first arm
             records each launch's eligible-row count;
7. profile - one fused headline session under torch.profiler: device time
             by kernel, the fused choice's kernels summed, and the device's
             idle share;
8. cycle   - the port's Scheduler.run_once on the card at bench.py
             full_cycle()'s scale (2000 nodes of 32 cpu / 128Gi, 3 queues
             1:2:3, default conf): a warm-up burst of 1000 gangs x 10 pods,
             a measured burst on a fresh identical cluster sharing the warm
             arena, 20 warm-up waves, then 12 timed steady cycles of one
             10-gang wave each. One line per regime (cycle ms, the
             last_cycle_timing breakdown, flatten/ordering modes, arena
             bytes and chunks, kernel launches, binds). Checks: every pod
             of the burst and of each wave bound in its cycle, gangs
             all-or-nothing, no node past its allocatable, no host fallback
             or action error, breaker closed, the kernel launched every
             cycle, no full re-ship, cold flatten or ordering fallback in a
             steady cycle, the resident arena equal to its host mirror
             after the run. Every kernel launch of the warm-up burst and of
             the last warm-up wave is held bit for bit against the plain
             version on its own inputs (cycle_audit). Then: the async
             pinned readback of one steady cycle and of a producer still
             running on the device against a blocking copy
             (cycle_readback), one steady cycle under torch.profiler
             (cycle_profile), three cycles on the event-sourced flatten (a
             gang that fits no node stays pending while bound gangs
             finish: regime "event"), and a small churned cluster through
             the Scheduler on the card and on the host, binds identical
             (cycle_small);
9. hdrf    - allocate with the drf hierarchy (hdrf) at BASELINE config
             #5's scale: 1000 nodes of 8 cpu / 32Gi / 8 GPUs, the three
             leaf queues of example/hierarchical-jobs.yaml, 500 gangs of
             10 pods (every 5th asks for GPUs). A warm-up burst, a
             measured burst whose every kernel launch, the placeability
             prefilter's included, is held against the plain version,
             then 5 steady cycles (5 gangs finish, 5 arrive). Per cycle:
             the timing, binds and dominant share per queue beside the
             weights' split, and the kernel's launches with the
             prefilter's counted apart;
10. evict  - preempt (BASELINE config #4: 2000 running low-priority pods
             on 200 nodes, a high-priority gang of 1000) and reclaim (a
             reclaimable queue filling the nodes, 100 high-priority jobs
             of 10 in another queue) through the Scheduler: every
             eviction allowed, no node's future idle below zero, the gang
             pipelined whole; each eviction solve held against the same
             solve on CPU tensors; the victims deleted and the claimers
             bound the next cycle;
11. sequential - one cycle with allocate in mode: sequential (500 pods,
             50 nodes, binpack + predicates) on the card and on the host:
             the same binds;
12. sharded - the node-axis sharded solver (volcano_tpu_torch.parallel) on
             a mesh of 4 virtual shards on the card: (a) the cycle
             phase's cluster through Scheduler(solver_mode="sharded") over
             a ShardedDeviceCache, a 10k-pod burst (every kernel launch
             held against the plain version), 5 steady waves and two
             cycles with nothing new (the second ships 0 bytes to every
             shard), each cycle's binds identical to a packed twin's; on a
             host with 2+ cards, (a) again over the distinct cards; (b)
             bench.py sharded_scale()'s 100k tasks x 10k nodes, built from
             numpy, through the sharded arena and the packed arena: the
             same decision digest, then a zero-dirty session; (c) the evict
             phase's preempt solve through solve_evict_uniform_sharded,
             equal to the D=1 solve; (d) an hdrf burst (the hdrf phase's
             cluster at 128 nodes) through the sharded Scheduler, binds
             identical to a packed twin's, every launch of the round's
             choice and of the placeability prefilter held against the
             plain version; the kernel timed at the shard shape;
13. reschedule - the global rescheduler (volcano_tpu_torch.reschedule) on
             the cycle phase's 2000 nodes of 32 cpu / 128Gi, holding 1400
             running gangs of 10 pods of 4 cpu / 8Gi (7 gangs a node, 4
             cpu free on each) and one pending 16-cpu pod that fits
             nowhere, through Scheduler.run_once under a reschedule conf
             (maxMoves 8, maxDisruptionPerJob 2, minImprovement 0.001):
             the pass must execute a plan (a skip, a failed solve or a
             rejected plan fails the run) within its budget and per-job
             cap, with fragmentation down and every evicted pod carrying
             the migration reason, and equal to the JAX package's record
             on this layout (hole n00000, 3 moves, stranded fraction 1.0
             -> 0.998); every fused_choice launch of the defrag solve
             (about 14k running tasks x 2000 nodes) is held bit for bit
             against the plain version. A second pass shows the arena's
             bytes on reuse; the layout cut to 60 nodes runs through the
             same pass on the card and on the host with identical
             evictions and plan; the kernel is timed at the defrag shape;
14. prewarm - the bucket prewarmer (ops.precompile) at the cycle cell's
             cluster: waves of 10 gangs whose pods per gang grow
             10, 12, 13, 17 (each size twice, each wave completing before
             the next), so the pending task count walks the buckets 112 ->
             128 -> 160 -> 192 with N fixed; each arm in its own process
             (`--prewarm-arm off|on`), prewarm off then on. Checks: the
             binds identical cycle for cycle, the warm completing without
             a failure, no compile on the session thread in any first
             cycle past a crossing with prewarm on, the warm's launches
             counted apart. Per crossing: the first cycle at the new
             bucket beside the next cycle at it, in both arms;
15. sidecar - `python -m volcano_tpu_torch.parallel.sidecar SOCK` owns the
             card in its own process (it must name a CUDA device); this
             process's control plane runs on a CPU cache with
             cache.sidecar set: the cycle phase's burst, 12 steady waves,
             an unchanged snapshot sent twice (the second ships 0 chunks)
             and the evict phase's preempt, each held bind for bind
             (eviction for eviction) against the same seeded cluster in
             process on the card; a second server armed to fail its
             solve must make the client's cycle report allocate_error and
             bind nothing on the host. Per cycle: cycle ms, the round
             trip, the server's rounds and shipped chunks, request bytes;
16. failover - one store at the cycle cell's scale, leader A (fenced
             writes, the bind journal) through the burst and 3 waves
             while standby B runs shadow_cycle() before each of A's
             cycles; A crashes at a wave's bind_commit; the elector's
             clock passes the lease, B takes over, reconciles, and runs
             its first cycle on the next wave beside a cold standby C.
             Checks: every pod bound once, the binds equal an
             uninterrupted run's, no intent left, A's late write fenced,
             gangs whole, the shadows wrote nothing, B's arena equal to
             its mirror, B's first cycle a warm delta (no full ship, no
             cold flatten) that launches the kernel (every launch held
             against the plain version). Takeover latency, B's first
             cycle beside C's;
17. lifecycle - vcjobs (batch.volcano.sh Jobs) from admission to
             podgroup, pods and binds through the port's webhooks
             (start_webhooks), ControllerManager (job, queue and podgroup
             controllers, the kubelet stand-in, the garbage collector)
             and Scheduler on the card, at the cycle cell's scale: 2000
             nodes of 32 cpu / 128Gi, three queues 1:2:3 created through
             the queue admission, the default conf. A burst of 1000
             vcjobs of one 10-replica task (minAvailable 10, cpu
             1 + (k // 3) % 3, 1-4Gi; PodFailed -> RestartJob,
             TaskCompleted -> CompleteJob, ttlSecondsAfterFinished 0; the
             svc and env plugins on every tenth), converged as the
             reference e2e World does (controllers, the kubelet, one
             cycle, up to 6 rounds) with every kernel launch held against
             the plain version; then 12 waves: 10 jobs complete and are
             collected, one pod of each of 2 jobs fails and they restart,
             one job gets AbortJob (ResumeJob the wave after), 10 new
             jobs arrive. Checks after each: every job's phase and retry
             count as its policy or command implies, every pod bound at
             most once, no node over its allocatable, a Running job with
             minAvailable pods bound, nothing of a collected job left,
             every binding cycle launched the kernel. Then the twin: the
             same script at 200 nodes, 100 jobs and 4 waves on the card
             and on the host (device="cpu"), binds, job, podgroup and
             queue states identical wave by wave;
18. netstore - the scheduler on the card over the wire: a store process
             (this script with --role store: a StoreServer over a
             DurableClusterStore, fsync on every commit) holds the cycle
             cell; this process's Scheduler runs on the card over a
             RemoteClusterStore with the delta watch, beside the same
             script on an in-process store (the twin). The burst (1000
             gangs in one cycle), then 12 waves of 10 gangs; at wave 8
             the store process is SIGKILLed once the wave is committed,
             and restarted on the same port and data directory while the
             cycle binds (the client's retries, the watches' since:
             resume). Checks: every cycle's binds equal the twin's, every
             launch held against the plain version, every pod bound once
             (the store's audit over both store processes), gangs whole,
             no node over its allocatable. Reports the burst with its
             bind-write ms apart, steady p50 / max beside the twin's, the
             delta watch's frames, bytes (against an object-frame client
             on the same kinds), decode and apply ms, store requests per
             cycle, and the restart: WAL recovery ms and records, ms from
             the kill to the end of the next cycle, that cycle's flatten
             mode and arena ship;
19. netha  - failover across processes: a store process seeded with the
             cycle cell already bound (and a gang that fits no node, so
             every cycle solves), three scheduler processes (--role
             scheduler) on the card under run_with_leader_election with
             fenced writes and the bind-intent journal, the standbys
             (started once the first leads) running shadow cycles. The
             leader dies at an armed bind_commit (exc:exit), then by
             SIGKILL once a wave's first bind landed, a standby taking
             over each time; the same script then runs with cold
             standbys. The lease comes from the netstore phase's steady
             cycles and the store's replay of the cell's pods to a new
             watcher (four times the longer, at least 8 s: four cold
             first leader cycles). Checks per arm: every pod bound once,
             the binds equal an uninterrupted run's in this process, no
             intent left, the dead leader's token fenced, no bind between
             a kill's in-flight writes and the lease expiry, one leader
             transition a kill, each new leader's first cycle launching
             the kernel and every child's launch held against the plain
             version. Reports takeover ms (the dead leader's last audited
             renewal to the new leader's first bind) and the new leader's
             first cycle warm against cold: kernel library load, CUDA
             state, flatten mode, arena ship, cycle ms;
20. netshard - the scheduler on the card over the sharded, replicated
             store: a primary process (--role shardprimary: a
             ShardProcSupervisor of 4 worker processes, `python -m
             volcano_tpu_torch.client.shardproc`, each a durable shard
             fsyncing every commit, behind a ProcShardRouter) seeded
             through the router's bulk_apply with the cycle cell already
             bound and a gang that fits no node; replica r1 tails it (one
             tailer a shard) and r2 tails r1 (--role replica each). This
             process's Scheduler runs on the card over
             SchedulerCache(ReadTierStore(primary, leaf)): binds straight to
             the owning worker (topology direct routing), list/watch off r2
             with the delta watch and the min_rv bound; beside the same
             script on an in-process store (the twin). 12 waves of 10
             gangs: at wave 4 worker 2 is SIGKILLed once the wave is
             mirrored (its supervisor restarts it on the same port and data
             dir while the cycle binds), at wave 8 r1 is SIGKILLed and
             restarted on its port. Checks: every cycle's binds equal the
             twin's, every launch held against the plain version, every
             pod bound once (the primary's audit across both lives of the
             worker), gangs whole, no node over its allocatable, r1's and
             r2's lists of every kind equal the primary's at one applied rv,
             no replica record gap, the leaf serving the scheduler's reads
             (the primary's only PRIMARY_KINDS and counted fallbacks), each
             worker running the port's module. Reports the seed ms, steady
             p50 / max beside the twin's and netstore's, bind-write ms a
             bind beside netstore's, store requests a cycle at the router,
             each worker, r1 and r2, replica lag at each cycle's start per
             depth, the worker kill (to READY, WAL records recovered, to
             the next cycle's end, that cycle's flatten and arena ship) and
             the r1 kill (to the leaf caught up, bootstraps by reason,
             fallbacks);
21. sim    - the simulator (volcano_tpu_torch.sim) on bench.py
             sim_quality()'s workload, not cut (seed 123, 500 cycles and
             a drain of 100, 22 nodes of 32 cpu, 6710 pods): each arm a
             child process (--role simarm) at once — solver, sharded and
             host on the card, solver and the sharded arm's first 100
             cycles on the plain route (device="cpu"), and bench.py
             reschedule_defrag()'s A/B (the fragmented preset) on the card
             and on the plain route — beside a `python -m
             volcano_tpu_torch.cli sim` child checked against run_sim in
             process, then verify on the card (--role simverify) while
             the standalone phase runs. Checks: the card's solver trace
             equal to the plain route's byte for byte, verify passing, the
             sharded trace equal to the plain route's prefix, each
             fragmented arm equal to the plain route's with the rescheduler
             within its budget and caps. Per arm: the score (wait mean /
             p99, utilization, Jain fairness, churn), wall s, the first
             cycle's ms, the full-ship cycles' and the p50 / max of the
             rest, launches; the reference's defrag trio and the cycle
             where the solver and sharded arms part (the round cap) are
             reported;
22. standalone - the control plane in one process: (a) Standalone on the
             card at the cycle cell's scale (2000 nodes, 20 of them with
             GPU cards), 1000 vcjobs as YAML through apply_job_yaml with
             20 required-affinity, 20 PVC and 20 shared-GPU jobs above and
             below their priority, turned until every job runs, then 12
             waves of 10 vcjobs and one host-only job while 10 jobs
             finish; beside a CPU twin (--role standalonetwin) bind for
             bind, turn by turn; per turn the controllers' and the cycle's
             ms, the timing keys, the host-only jobs bound before and after
             the device solve, launches; (b) `python -m
             volcano_tpu_torch.standalone --serve-store` on the card with
             example/mpi-job.yaml, example/tensorflow-job.yaml and a
             generated job through `python -m volcano_tpu_torch.cli`,
             every pod bound, `job list` and `status` over the wire, exit 0
             on SIGTERM;
23. the kernels line, then the result line.

`--phases kernel,edges` runs a subset (device and build always run) and
then prints neither of the last two lines.

Any failed check raises, so the run exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
HEADLINE = dict(n_nodes=2000, n_jobs=1000, tasks_per_job=10)
KERNEL_SHAPE = (10240, 2048)  # (T, N) of the headline flatten
FAMILY_SETS = (("binpack",), ("kube",), ("binpack", "kube"))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# -- the headline problem (the shape of bench.py's make_problem) ------------

def make_problem(n_nodes, n_jobs, tasks_per_job, cpu="32", mem="128Gi",
                 n_queues=3, queue_weights=(1, 2, 3)):
    from volcano_tpu_torch.api import JobInfo, NodeInfo, TaskInfo
    from volcano_tpu_torch.api.types import POD_GROUP_ANNOTATION
    from volcano_tpu_torch.models import Node, Pod, PodGroup, PodGroupSpec

    nodes = {}
    for i in range(n_nodes):
        rl = {"cpu": cpu, "memory": mem, "pods": 110}
        nodes[f"n{i}"] = NodeInfo(Node(name=f"n{i}", allocatable=rl,
                                       capacity=dict(rl)))
    jobs, tasks = {}, []
    for k in range(n_jobs):
        pg = PodGroup(name=f"j{k}", namespace="bench",
                      spec=PodGroupSpec(min_member=tasks_per_job,
                                        queue=f"q{k % n_queues}"))
        job = JobInfo(f"bench/j{k}", pg)
        for i in range(tasks_per_job):
            req = {"cpu": str(1 + k % 3), "memory": f"{1 + k % 4}Gi"}
            pod = Pod(name=f"j{k}-{i}", namespace="bench",
                      annotations={POD_GROUP_ANNOTATION: f"j{k}"},
                      containers=[{"requests": req}])
            t = TaskInfo(pod)
            job.add_task_info(t)
            tasks.append(t)
        jobs[job.uid] = job
    queues = {f"q{i}": SimpleNamespace(weight=queue_weights[i],
                                       capability=None)
              for i in range(n_queues)}
    return jobs, nodes, tasks, queues


def score_params(arr, **weights):
    from volcano_tpu_torch.ops import ScoreParams
    sp = ScoreParams(**weights).resolved(arr.R, arr.N)
    return {
        "binpack_weight": np.float32(sp.binpack_weight),
        "binpack_res_weights": sp.binpack_res_weights,
        "least_req_weight": np.float32(sp.least_req_weight),
        "most_req_weight": np.float32(sp.most_req_weight),
        "balanced_weight": np.float32(sp.balanced_weight),
        "node_static": sp.node_static,
    }


# -- timing ----------------------------------------------------------------

def device_ms(fn, calls: int = 50, warmup: int = 3,
              attempts: int = 3) -> tuple:
    """Device time per call of fn(): the device-side events (kernels,
    memcpy, memset) of `calls` back-to-back calls under torch.profiler,
    summed and divided by `calls`. Returns (ms, {kernel name: us}).

    A profiler session now and then records no device events at all (seen
    once in some 70 back-to-back sessions on the H100); such a reading is
    taken again, up to ``attempts`` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        by_name = {e.key: e.self_device_time_total
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0}
        if by_name:
            return sum(by_name.values()) / 1e3 / calls, by_name
    raise AssertionError(f"the profiler saw no device time in {attempts} "
                         f"sessions")


def call_ms(fn, calls: int = 50, warmup: int = 3) -> float:
    """CUDA-event time of `calls` back-to-back calls of fn() over `calls`:
    the device time plus whatever the host's pace leaves between
    launches."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


# -- phases ------------------------------------------------------------------

def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    info = {"phase": "device", "nvidia_smi": smi,
            "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "capability": list(torch.cuda.get_device_capability(0)),
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit(info)
    return info


def ptxas_report(out: str) -> dict:
    """{kernel: {registers, smem_bytes, spill_bytes}} from nvcc -Xptxas -v
    (one block of lines per entry function)."""
    import re
    funcs, cur = {}, None
    for ln in out.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([A-Za-z0-9_]+)", ln)
        if m:
            cur = funcs.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            cur["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", ln)
            cur["smem_bytes"] = int(m.group(1)) if m else 0
    return funcs


def phase_build():
    from volcano_tpu_torch.ops import _build
    t0 = time.perf_counter()
    reports = {name: _build.build(name) for name in _build.KERNELS}
    for name in _build.KERNELS:
        _build.load(name)
    seconds = time.perf_counter() - t0
    ptxas = {name: ptxas_report(out) for name, out in reports.items() if out}
    emit({"phase": "build", "seconds": seconds, "kernels": list(_build.KERNELS),
          "compiled": sorted(ptxas), "ptxas": ptxas})
    spills = {f: v["spill_bytes"] for rep in ptxas.values()
              for f, v in rep.items() if v.get("spill_bytes")}
    if spills:
        raise AssertionError(f"ptxas reports spills: {spills}")


def kernel_inputs(seed: int, T: int, N: int, R: int, dev,
                  eligible: float = 0.9, variant: str = "random"):
    """Seeded kernel inputs: integer-valued requests (milli-cpu, GiB, gpu
    milli), nodes part-used, random pods_ok / signature masks, a share
    `eligible` of eligible rows, and pairs of identical nodes so that argmax
    ties occur. Variants for the edge sweep:
    - "none_eligible": no row eligible;
    - "last_row": only row T-1 eligible;
    - "split_ties": node 128k repeats node 128k-1 (ties across every
      node-tile boundary of the kernel);
    - "all_tied": every node identical and pods_ok everywhere, so every
      row's maximum is tied across all nodes and all node tiles;
    - "fit_edges": requests on the fit test's boundaries (exactly at, one
      float below and above the threshold av + (thr + tol*|av|) and av of
      some node), scalar requests of 10 and just above, and nodes with
      +inf, -inf and NaN availability;
    - "neg_zero": every score weight and node_static -0.0, so the terms
      score -0.0 where the plain version's 0 + x gives +0.0 (all tied)."""
    from volcano_tpu_torch.ops.convert import to_torch_params
    from volcano_tpu_torch.ops.fused_choice import pack_pars

    rng = np.random.default_rng(seed)
    gi = float(2 ** 30)
    req = np.zeros((T, R), np.float32)
    req[:, 0] = 1000.0 * rng.integers(1, 4, T)
    req[:, 1] = gi * rng.integers(1, 5, T)
    alloc = np.zeros((N, R), np.float32)
    alloc[:, 0] = 32000.0
    alloc[:, 1] = 128 * gi
    if R >= 3:
        req[:, 2] = np.where(rng.random(T) < 0.3, 1000.0, 0.0)
        alloc[:, 2] = 8000.0
    used = np.zeros((N, R), np.float32)
    used[:, 0] = 1000.0 * rng.integers(0, 33, N)
    used[:, 1] = gi * rng.integers(0, 129, N)
    if R >= 3:
        used[:, 2] = 1000.0 * rng.integers(0, 9, N)
    if R >= 4:   # more scalar dims: the flatten never gives a zero allocatable
        alloc[:, 3:] = 4000.0
        used[:, 3:] = 1000.0 * rng.integers(0, 5, (N, R - 3))
        req[:, 3:] = 500.0 * rng.integers(0, 3, (T, R - 3))
    used[1::2] = used[0::2][:N // 2]
    elig = (rng.random(T) < eligible).astype(np.float32)
    pods_ok = (rng.random(N) < 0.95).astype(np.float32)
    if variant == "none_eligible":
        elig[:] = 0.0
    elif variant == "all_eligible":
        elig[:] = 1.0
    elif variant == "last_row":
        elig[:] = 0.0
        elig[-1] = 1.0
    elif variant == "split_ties":
        used[128::128] = used[127:-1:128]
        pods_ok[127:] = 1.0
    elif variant == "all_tied":
        used[:] = used[0]
        pods_ok[:] = 1.0
    elif variant not in ("random", "fit_edges", "neg_zero"):
        raise ValueError(variant)
    avail = alloc - used
    if variant == "fit_edges":
        fit_edges(rng, req, avail)
    params = {"binpack_weight": 1.0,
              "binpack_res_weights": np.ones(R, np.float32),
              "least_req_weight": 1.0, "most_req_weight": 0.0,
              "balanced_weight": 1.0,
              "node_static": np.zeros(N, np.float32)}
    if variant == "neg_zero":
        for k in ("binpack_weight", "least_req_weight", "most_req_weight",
                  "balanced_weight"):
            params[k] = np.float32(-0.0)
        params["node_static"][:] = -0.0
    tp = to_torch_params(params, dev)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return [t(req), t(avail), t(used), t((1.0 / alloc).astype(np.float32)),
            tp["node_static"], t(elig), t(pods_ok),
            t((rng.random((T, N)) < 0.9).astype(np.int8)),
            pack_pars(tp, R)]


def fit_edges(rng, req, avail) -> None:
    """Put requests on the fit test's boundaries (see kernel_inputs)."""
    from volcano_tpu_torch.ops.fused_choice import REL_FIT_TOL
    T, R = req.shape
    N = avail.shape[0]
    f32 = np.float32
    special = [np.inf, -np.inf, np.nan]
    for i, v in enumerate(special[:max(N - 1, 0)]):
        avail[1 + i, rng.integers(0, R)] = v
    thr = np.array([10.0, 1.0] + [10.0] * (R - 2), f32)
    for t in range(T):
        j = rng.integers(0, N)
        a = avail[j].astype(f32)
        with np.errstate(invalid="ignore"):
            bound = (a + (thr + f32(REL_FIT_TOL) * np.abs(a))).astype(f32)
        for r in range(R):
            pick = [bound[r], np.nextafter(bound[r], f32(-np.inf)),
                    np.nextafter(bound[r], f32(np.inf)), a[r],
                    np.nextafter(a[r], f32(np.inf))][rng.integers(0, 5)]
            if np.isfinite(pick):
                req[t, r] = pick
        if R >= 3:
            req[t, 2] = [f32(10.0), np.nextafter(f32(10.0), f32(np.inf)),
                         req[t, 2]][rng.integers(0, 3)]


def same_bits(a, b) -> bool:
    """Same dtype, shape and bits (-0.0 and +0.0 differ)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def check_choice(args, fam, what: str) -> dict:
    """One kernel call against the plain version on the same inputs:
    best_score, best_idx (every row, ties included) and node_max must be
    equal bit for bit. Returns the error and tie counts."""
    from volcano_tpu_torch.ops import fused_choice as fc

    before = fc.fused_choice.launches
    got = fc.fused_choice(*args, fam)
    want = fc.fused_choice_plain(*args, fam)
    torch.cuda.synchronize()
    if fc.fused_choice.launches != before + 1:
        raise AssertionError(f"{what}: the wrapper did not launch the kernel")
    feas = fc.fused_feasible(args[0], args[1], args[5], args[6], args[7])
    score = fc._score(args[0], args[2], args[3], args[4], args[8], fam)
    masked = torch.where(feas, score, fc.NEG)
    tied = (masked == want[0][:, None]).sum(dim=1) > 1
    del feas, score, masked
    err_s = (got[0] - want[0]).abs().max().item()
    err_n = (got[2] - want[2]).abs().max().item()
    idx_diff = got[1] != want[1]
    out = {"max_abs_err": max(err_s, err_n),
           "tied_rows": int(tied.sum().item()),
           "idx_diff_tied": int((idx_diff & tied).sum().item()),
           "idx_diff": int(idx_diff.sum().item())}
    if not all(same_bits(g, w) for g, w in zip(got, want)):
        raise AssertionError(
            f"fused_choice disagrees with its plain version at {what}: "
            f"best_score err {err_s}, node_max err {err_n}, best_idx "
            f"differs at {out['idx_diff']} rows ({out['idx_diff_tied']} "
            f"tied)")
    return out


#: (T, N, R, variant), checked for every score-family set here and by the
#: card tests: shapes off every tile (the kernel's node tile is 128 or 64
#: nodes, its row ranges T / G), later-round row masks, ties across node
#: tiles, the fit test's boundaries, zero scores of either sign, the
#: steady scheduling cycle's shape (one 10-gang wave: T=112 over N=2048),
#: the hdrf burst's (T=5120 over N=1024, R=3), whose placeability
#: prefilter launches the kernel with every row eligible, then fewer, and
#: the sharded phase's shard shapes: the burst's and a wave's T over one
#: shard's 512 of 2048 nodes, the 100k x 10k solve's 2500 of 10000, and
#: the sharded hdrf burst's T=640 over one shard's 32 of 128 nodes, R=3
EDGE_CASES = (
    (5120, 1024, 3, "random"), (5120, 1024, 3, "none_eligible"),
    (5120, 1024, 3, "all_eligible"),
    (112, 2048, 2, "random"), (112, 2048, 2, "none_eligible"),
    (1, 1, 2, "random"), (1, 2048, 3, "random"), (1000, 1, 2, "random"),
    (37, 45, 3, "random"), (40, 128, 2, "random"), (333, 1001, 3, "random"),
    (500, 1001, 3, "random"), (600, 700, 5, "random"),
    (1000, 2048, 2, "none_eligible"), (10240, 2048, 2, "last_row"),
    (1001, 999, 3, "last_row"), (2000, 2048, 2, "split_ties"),
    (500, 1000, 3, "all_tied"), (10240, 2048, 2, "all_tied"),
    (700, 130, 2, "fit_edges"), (700, 257, 3, "fit_edges"),
    (777, 1000, 2, "random"), (500, 1000, 2, "all_tied"),
    (500, 1000, 5, "all_tied"), (300, 1000, 2, "neg_zero"),
    (257, 130, 3, "neg_zero"),
    (10240, 512, 2, "random"), (10240, 512, 2, "none_eligible"),
    (10240, 512, 2, "all_tied"), (112, 512, 2, "random"),
    (112, 512, 2, "none_eligible"), (112, 512, 2, "all_tied"),
    (100000, 2500, 2, "random"),
    (640, 32, 3, "random"), (640, 32, 3, "none_eligible"),
    (640, 32, 3, "all_tied"),
)


def phase_edges(dev):
    """Shapes off every tile and the later-round row masks: checked
    against the plain version, not timed."""
    cases = []
    for i, (T, N, R, variant) in enumerate(EDGE_CASES):
        args = kernel_inputs(300 + i, T, N, R, dev, variant=variant)
        for fam in FAMILY_SETS:
            res = check_choice(args, fam, f"T={T} N={N} R={R} {variant} "
                                          f"{fam}")
            cases.append({"T": T, "N": N, "R": R, "variant": variant,
                          "families": list(fam),
                          "tied_rows": res["tied_rows"],
                          "idx_diff": res["idx_diff"]})
    emit({"phase": "edges", "cases": len(cases), "equal": True,
          "tied_rows": sum(c["tied_rows"] for c in cases)})
    return cases


READINGS = 5   # device-time readings per kernel row; `ms` is their median


#: the hdrf cycles' kernel shape (T=5120 over N=1024, R=3, the hdrf conf's
#: kube scores), every row eligible: the placeability prefilter's mask in
#: a burst's first round
HDRF_KERNEL = (5120, 1024, 3, ("kube",))


def kernel_row(args, fam, what: str) -> dict:
    """One kernel row: checked against the plain version, then its device
    time (median of READINGS), host-paced call time, the plain version's
    device time and the bound, over the eligible rows."""
    from volcano_tpu_torch.ops import fused_choice as fc

    (T, R), N = args[0].shape, args[1].shape[0]
    n_elig = int((args[5] != 0).sum().item())
    res = check_choice(args, fam, what)
    readings = sorted((device_ms(lambda: fc.fused_choice(*args, fam))
                       for _ in range(READINGS)), key=lambda r: r[0])
    ms, kernels = readings[READINGS // 2]      # the median
    c_ms = call_ms(lambda: fc.fused_choice(*args, fam))
    plain_ms, _ = device_ms(lambda: fc.fused_choice_plain(*args, fam),
                            calls=10)
    nbytes, ops = fc.fused_choice_cost(T, N, R, fam, n_elig)
    b_ms, b_by = fc.bound_ms(nbytes, ops)
    row = {"phase": "kernel", "name": "fused_choice", "T": T, "N": N,
           "R": R, "families": list(fam), "eligible_rows": n_elig, **res,
           "ms": ms, "ms_readings": [r[0] for r in readings],
           "call_ms": c_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
           "bound_by": b_by, "share_of_bound": b_ms / ms, "bytes": nbytes,
           "fp32_instructions": ops,
           "device_us_per_call": {k[:60]: us / 50
                                  for k, us in kernels.items()}}
    emit(row)
    return row


def phase_kernel(dev):
    T, N = KERNEL_SHAPE
    rows = []
    for share in (0.9, 0.1):
        for R in (2, 3):
            args = kernel_inputs(100 + R, T, N, R, dev, eligible=share)
            for fam in FAMILY_SETS:
                rows.append(kernel_row(args, fam, f"R={R} {fam} eligible "
                                                  f"{share}"))
    T, N, R, fam = HDRF_KERNEL
    args = kernel_inputs(200, T, N, R, dev, variant="all_eligible")
    rows.append(kernel_row(args, fam, "the hdrf shape, all rows eligible"))
    return rows


def solve_checks(arr, d, res_f, res_p, params, families):
    """The fused-vs-plain and solution checks of one headline arm."""
    from volcano_tpu_torch.ops.solver import le_fits, score_matrix

    if not torch.equal(res_f.kind, res_p.kind):
        raise AssertionError("kind differs between fused and plain")
    if not torch.equal(res_f.job_ready, res_p.job_ready):
        raise AssertionError("job_ready differs between fused and plain")
    diff = torch.nonzero(res_f.assigned != res_p.assigned)[:, 0]
    if len(diff):
        # a different node is allowed only where the two nodes tie in
        # score for that task on the snapshot (tests/test_solver.py's rule)
        af = res_f.assigned[diff].long()
        ap = res_p.assigned[diff].long()
        req = d["task_init_req"][diff]
        sig = d["sig_masks"][d["task_sig"].long()[diff]]
        for a_n in (af, ap):
            fit = le_fits(req, d["node_idle"][a_n], d["thresholds"],
                          d["scalar_dim_mask"])
            if not bool((fit & sig.gather(1, a_n[:, None])[:, 0]).all()):
                raise AssertionError("a diverging choice is infeasible")
        score = score_matrix(req, d["node_idle"], d["node_used"],
                             d["node_alloc"], params, families)
        s1 = score.gather(1, af[:, None])[:, 0]
        s2 = score.gather(1, ap[:, None])[:, 0]
        if not bool(((s1 - s2).abs()
                     <= 1e-4 * torch.clamp(s1.abs(), min=1.0)).all()):
            raise AssertionError("a diverging choice is not score-tied")
    for res in (res_f, res_p):
        assigned = res.assigned.cpu().numpy()
        kind = res.kind.cpu().numpy()
        alloc = (assigned >= 0) & (kind == 0)
        host = arr.numpy_dict()
        debit = np.zeros(host["node_idle"].shape, np.float64)
        np.add.at(debit, assigned[alloc], host["task_req"][alloc])
        slack = host["thresholds"] + 5e-7 * np.abs(host["node_idle"])
        if not (debit <= host["node_idle"] + slack).all():
            raise AssertionError("a node is debited past its idle")
        ready = res.job_ready.cpu().numpy()
        if not ready[np.unique(host["task_job"][alloc])].all():
            raise AssertionError("a job holds allocations but is not ready")
        if not np.isfinite(debit).all():
            raise AssertionError("non-finite debit")
    return int(len(diff))


def timed_session(arr, params, kw, fused, dev):
    """One session past the flatten: upload, solve, compact readback."""
    from volcano_tpu_torch.ops import decode_compact, solve_allocate
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d = arr.device_dict(device=dev)
    res = solve_allocate(d, params, fused=fused, device=dev, **kw)
    assigned, _ = decode_compact(res.compact)
    ms = (time.perf_counter() - t0) * 1e3
    return ms, res, d, assigned


def phase_small(dev):
    """A small seeded problem: fused solve on the card == dense solve on
    the host (the host path is the one tested against the JAX package)."""
    from volcano_tpu_torch.ops import fused_choice as fc
    from volcano_tpu_torch.ops import flatten_snapshot, solve_allocate
    jobs, nodes, tasks, queues = make_problem(64, 24, 6, cpu="8",
                                              mem="32Gi")
    arr = flatten_snapshot(jobs, nodes, tasks, queues=queues)
    arr.fill_queue_demand()
    p = score_params(arr, binpack_weight=1.0)
    kw = dict(herd_mode="pack", score_families=("binpack",),
              use_queue_cap=True)
    before = fc.fused_choice.launches
    gpu = solve_allocate(arr.device_dict(device=dev), p, device=dev,
                         fused="on", **kw)
    cpu = solve_allocate(arr.device_dict(device="cpu"), p, device="cpu",
                         **kw)
    for k in ("assigned", "kind", "job_ready", "rounds", "compact"):
        if not torch.equal(getattr(gpu, k).cpu(), getattr(cpu, k)):
            raise AssertionError(f"small solve: {k} differs card vs host")
    launches = fc.fused_choice.launches - before
    if launches <= 0:
        raise AssertionError("small solve did not launch the kernel")
    emit({"phase": "small", "T": arr.T, "N": arr.N,
          "placed": int((gpu.assigned >= 0).sum().item()),
          "rounds": int(gpu.rounds.item()), "launches": launches,
          "identical_to_host": True})


def phase_solve(dev, reps: int = 5):
    from volcano_tpu_torch.ops import FlattenCache, flatten_snapshot
    from volcano_tpu_torch.ops import fused_choice as fc
    from volcano_tpu_torch.ops.convert import to_torch_params

    jobs, nodes, tasks, queues = make_problem(**HEADLINE)
    flat_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        arr = flatten_snapshot(jobs, nodes, tasks, queues=queues,
                               cache=FlattenCache())
        arr.fill_queue_demand()
        flat_ms.append((time.perf_counter() - t0) * 1e3)
    if (arr.T, arr.N) != KERNEL_SHAPE or arr.R != 2:
        raise AssertionError(f"headline shape {arr.T, arr.N, arr.R}")
    emit({"phase": "flatten", "T": arr.T, "N": arr.N, "R": arr.R,
          "J": arr.J, "Q": int(arr.queue_weight.shape[0]),
          "host_ms_median": statistics.median(flat_ms),
          "host_ms": flat_ms})
    drf_total = (arr.node_alloc * arr.node_valid[:, None]).sum(
        axis=0).astype(np.float32)
    arms = [
        ("binpack_pack_qcap", score_params(arr, binpack_weight=1.0),
         dict(herd_mode="pack", score_families=("binpack",),
              use_queue_cap=True), False),
        ("binpack_pack_qcap_drf", score_params(arr, binpack_weight=1.0),
         dict(herd_mode="pack", score_families=("binpack",),
              use_queue_cap=True, use_drf_order=True), True),
        ("kube_spread_qcap", score_params(arr, least_req_weight=1.0,
                                          balanced_weight=1.0),
         dict(herd_mode="spread", score_families=("kube",),
              use_queue_cap=True), False),
    ]
    n_real = len(tasks)
    main_launches = None
    out = []
    for name, params, kw, drf in arms:
        arr.drf_total[:] = drf_total if drf else 0.0
        # the main path's run: counts set to 0 just before, read after
        fc.fused_choice.launches = 0
        _, res_f, d, _ = timed_session(arr, params, kw, "auto", dev)
        launches_f = fc.fused_choice.launches
        if main_launches is None:
            main_launches = launches_f
        fc.fused_choice.launches = 0
        _, res_p, _, _ = timed_session(arr, params, kw, "off", dev)
        launches_p = fc.fused_choice.launches
        if launches_f <= 0 or launches_p != 0:
            raise AssertionError(f"{name}: launches fused {launches_f}, "
                                 f"plain {launches_p}")
        n_diff = solve_checks(arr, d, res_f, res_p,
                              to_torch_params(params, dev),
                              kw["score_families"])
        # timing: plain, fused, fused, plain ... after the warm-up above
        ms_f, ms_p = [], []
        for i in range(reps):
            for fused in (("off", "auto") if i % 2 == 0
                          else ("auto", "off")):
                ms, _, _, _ = timed_session(arr, params, kw, fused, dev)
                (ms_f if fused == "auto" else ms_p).append(ms)
        row = {"phase": "solve", "arm": name, "T": arr.T, "N": arr.N,
               "tasks": n_real,
               "placed": int((res_f.assigned[:n_real] >= 0).sum().item()),
               "placed_plain": int(
                   (res_p.assigned[:n_real] >= 0).sum().item()),
               "jobs_ready": int(res_f.job_ready.sum().item()),
               "rounds": int(res_f.rounds.item()),
               "rounds_plain": int(res_p.rounds.item()),
               "assigned_diff_tied": n_diff,
               "launches": launches_f,
               "session_ms_median": statistics.median(ms_f),
               "plain_session_ms_median": statistics.median(ms_p),
               "session_ms": ms_f, "plain_session_ms": ms_p}
        if name == "binpack_pack_qcap":
            row["eligible_rows_per_launch"] = eligible_counts(arr, params,
                                                              kw, dev)
        emit(row)
        out.append(row)
    arr.drf_total[:] = 0.0
    return out, main_launches


def eligible_counts(arr, params, kw, dev) -> list:
    """One untimed fused session that records the eligible-row count of
    each kernel launch (the solver's call is wrapped here, and each count
    is a host read)."""
    from volcano_tpu_torch.ops import solver
    orig = solver.fused_choice
    counts = []

    def counting(*args):
        counts.append(int((args[5] != 0).sum().item()))
        return orig(*args)

    solver.fused_choice = counting
    try:
        timed_session(arr, params, kw, "auto", dev)
    finally:
        solver.fused_choice = orig
    return counts


def phase_profile(dev):
    """One fused headline session (the first solve arm) under
    torch.profiler: device time by kernel, and the device's idle share of
    the session's wall time."""
    from torch.profiler import ProfilerActivity, profile

    from volcano_tpu_torch.ops import flatten_snapshot
    jobs, nodes, tasks, queues = make_problem(**HEADLINE)
    arr = flatten_snapshot(jobs, nodes, tasks, queues=queues)
    arr.fill_queue_demand()
    params = score_params(arr, binpack_weight=1.0)
    kw = dict(herd_mode="pack", score_families=("binpack",),
              use_queue_cap=True)
    timed_session(arr, params, kw, "auto", dev)   # warm
    # the profiler slows the host side; the idle share is taken against
    # the same session's unprofiled wall time
    plain_wall = statistics.median(
        timed_session(arr, params, kw, "auto", dev)[0] for _ in range(5))
    from torch.autograd import DeviceType
    for _ in range(3):      # a session with no device events is re-taken
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall_ms, res, _, _ = timed_session(arr, params, kw, "auto", dev)
        # device-side events only (kernels, memcpy, memset): the aten ops
        # that launched them carry the same time and would count it twice
        rows = sorted(((e.self_device_time_total, e.count, e.key)
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA
                       and e.self_device_time_total > 0), reverse=True)
        if rows:
            break
    else:
        raise AssertionError("the profiler saw no device time")
    device_ms = sum(r[0] for r in rows) / 1e3
    launches = sum(e.count for e in prof.key_averages()
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                "cudaLaunchKernelExC"))
    syncs = sum(e.count for e in prof.key_averages()
                if e.key in ("cudaStreamSynchronize", "cudaMemcpyAsync"))
    fc_rows = [r for r in rows if "fused_choice" in r[2]]
    emit({"phase": "profile", "arm": "binpack_pack_qcap",
          "wall_ms_unprofiled": plain_wall, "wall_ms_profiled": wall_ms,
          "device_ms": device_ms,
          "device_idle_share": 1.0 - device_ms / plain_wall,
          "fused_choice_device_ms": sum(r[0] for r in fc_rows) / 1e3,
          "fused_choice_kernels": [{"name": k[:80], "us": us, "count": c}
                                   for us, c, k in fc_rows],
          "kernel_launches": launches, "sync_or_copy_calls": syncs,
          "rounds": int(res.rounds.item()),
          "top_device_us": [{"name": k[:80], "us": us, "count": c}
                            for us, c, k in rows[:12]]})


# -- the scheduling cycle (bench.py full_cycle()'s scale) -------------------

CYCLE = dict(n_nodes=2000, n_jobs=1000, tasks_per_job=10, wave_jobs=10,
             warm_waves=20, steady_cycles=12)
#: timing keys of Scheduler.last_cycle_timing each cycle line reports
CYCLE_KEYS = ("open_ms", "order_ms", "flatten_ms", "pack_ms",
              "delta_plan_ms", "dispatch_ms", "overlap_ms", "readback_ms",
              "solve_ms", "replay_ms", "enqueue_ms", "allocate_ms",
              "backfill_ms", "close_ms", "total_ms")


#: the allocate action's timing keys of a solve through the sidecar
SIDECAR_KEYS = ("sidecar_rtt_ms", "sidecar_request_bytes", "sidecar_rounds",
                "sidecar_shipped_chunks", "sidecar_launches")


class StoreCluster:
    """The port's Scheduler over an in-memory store: ``n_nodes`` nodes of
    32 cpu / 128Gi / 110 pods, 3 queues weighted 1:2:3, gangs of
    ``tasks_per_job`` pods (cpu 1-3, memory 1-4Gi, minMember = size) — the
    cluster of bench.py's full_cycle(), built from the port's own models.
    ``queues`` ([(name, weight, annotations)]), ``gpus`` (nvidia.com/gpu
    per node), ``gpu_every`` (every such gang's pods ask for 1 GPU, as in
    bench.py's make_problem), ``size_stride`` (gang k's cpu request is
    1 + (k // size_stride) % 3), ``conf`` and ``solver_mode`` (the
    Scheduler's) shape other clusters.
    FakeBinder records the binds."""

    def __init__(self, dev, n_nodes: int, n_jobs: int = 0,
                 tasks_per_job: int = 10, cpu: str = "32", mem: str = "128Gi",
                 shared_arena=None, queues=None, gpus: int = 0,
                 gpu_every: int = 0, size_stride: int = 1, conf=None,
                 solver_mode=None):
        from volcano_tpu_torch.cache import (
            FakeBinder, FakeEvictor, SchedulerCache,
        )
        from volcano_tpu_torch.client import ClusterStore
        from volcano_tpu_torch.models import Node, Queue, QueueSpec
        from volcano_tpu_torch.scheduler import Scheduler

        self.tpj = tasks_per_job
        self.gpu_every = gpu_every
        self.size_stride = size_stride
        self.store = ClusterStore()
        self.cache = SchedulerCache(self.store, device=dev)
        if shared_arena is not None:
            # a long-running scheduler's arena outlives any one cluster
            # state: the measured burst starts with it warm
            self.cache.device_cache = shared_arena
        self.cache.binder = FakeBinder()
        self.cache.evictor = FakeEvictor()
        self.cache.run()
        queues = queues or [(f"q{i}", i + 1, None) for i in range(3)]
        self.queues = [name for name, _, _ in queues]
        for name, weight, ann in queues:
            self.store.apply("queues", Queue(name=name, annotations=ann or {},
                                             spec=QueueSpec(weight=weight)))
        self.alloc = {"cpu": float(cpu), "memory": _gib(mem), "pods": 110,
                      "gpu": float(gpus)}
        rl = {"cpu": cpu, "memory": mem, "pods": "110"}
        if gpus:
            rl["nvidia.com/gpu"] = str(gpus)
        for i in range(n_nodes):
            self.store.create("nodes", Node(name=f"n{i}", allocatable=rl,
                                            capacity=dict(rl)))
        self.k = 0
        self.gangs: dict = {}    # "bench/j<k>-<i>" pod keys per gang
        self.queue_of: dict = {}  # gang -> queue
        self.req: dict = {}      # pod key -> (cpu, memory bytes, gpu)
        self.submit(n_jobs)
        self.sched = Scheduler(self.cache, scheduler_conf=conf,
                               solver_mode=solver_mode)

    def submit(self, n_jobs: int, cpu_per_pod: int = 0) -> list:
        """``n_jobs`` new gangs, round-robin over the queues;
        ``cpu_per_pod`` overrides the cpu 1-3 request of their pods."""
        from volcano_tpu_torch.api.types import POD_GROUP_ANNOTATION
        from volcano_tpu_torch.models import (
            Pod, PodGroup, PodGroupPhase, PodGroupSpec, PodGroupStatus,
        )
        new = []
        for _ in range(n_jobs):
            k = self.k
            self.k += 1
            queue = self.queues[k % len(self.queues)]
            self.store.create("podgroups", PodGroup(
                name=f"j{k}", namespace="bench",
                spec=PodGroupSpec(min_member=self.tpj, queue=queue),
                status=PodGroupStatus(phase=PodGroupPhase.PENDING)))
            gpu = 1 if self.gpu_every and k % self.gpu_every == 0 else 0
            keys = []
            for i in range(self.tpj):
                cpu = cpu_per_pod or 1 + (k // self.size_stride) % 3
                mem = 1 + k % 4
                req = {"cpu": str(cpu), "memory": f"{mem}Gi"}
                if gpu:
                    req["nvidia.com/gpu"] = str(gpu)
                self.store.create("pods", Pod(
                    name=f"j{k}-{i}", namespace="bench", phase="Pending",
                    annotations={POD_GROUP_ANNOTATION: f"j{k}"},
                    containers=[{"requests": req}]))
                key = f"bench/j{k}-{i}"
                keys.append(key)
                self.req[key] = (float(cpu), mem * float(2 ** 30),
                                 float(gpu))
            self.gangs[f"j{k}"] = keys
            self.queue_of[f"j{k}"] = queue
            new.append(f"j{k}")
        return new

    def complete(self, gang: str) -> None:
        """A bound gang finishes: its pods are deleted."""
        for key in self.gangs.pop(gang):
            ns, name = key.split("/")
            self.store.delete("pods", name, ns)
            self.cache.binder.binds.pop(key)

    def run_cycle(self) -> dict:
        """One Scheduler.run_once with the kernel's count set to 0 just
        before and read just after; returns the cycle's numbers."""
        from volcano_tpu_torch.ops import fused_choice as fc
        binds = self.cache.binder.binds
        before = len(binds)
        fc.fused_choice.launches = 0
        fc.fused_choice.launches_hdrf_prefilter = 0
        t0 = time.perf_counter()
        self.sched.run_once()
        ms = (time.perf_counter() - t0) * 1e3
        launches = fc.fused_choice.launches
        prefilter = fc.fused_choice.launches_hdrf_prefilter
        t = self.sched.last_cycle_timing
        out = {"cycle_ms": ms, "binds": len(binds) - before,
               "launches": launches, "prefilter_launches": prefilter,
               **{k: t[k] for k in CYCLE_KEYS if k in t}}
        for k in ("flatten_mode", "flatten_fallback_reason", "order_mode",
                  "arena_bytes_shipped", "delta_chunks",
                  "arena_full_ship", "host_fallback", "breaker_state",
                  "allocate_error", "session_compiles", "session_compile_s",
                  "prewarm_completions", *SIDECAR_KEYS):
            if k in t:
                out[k] = t[k]
        return out

    def check(self, what: str, gangs=None) -> None:
        """Gangs all-or-nothing (``gangs``: every one fully bound), no node
        bound past its allocatable, no host fallback, breaker closed."""
        self.check_placement(what, self.cache.binder.binds, gangs)
        t = self.sched.last_cycle_timing
        if t.get("host_fallback") or t.get("allocate_error"):
            raise AssertionError(f"{what}: the cycle left the device path "
                                 f"({t.get('host_fallback')}, "
                                 f"{t.get('allocate_error')})")
        if self.cache.breaker.state_code != 0:
            raise AssertionError(f"{what}: the breaker is not closed")

    def check_placement(self, what: str, binds: dict, gangs=None) -> None:
        """Gangs all-or-nothing (``gangs``: every one fully bound) and no
        node bound past its allocatable, for ``binds`` ({pod key: node})."""
        for g in (gangs or ()):
            if not all(key in binds for key in self.gangs[g]):
                raise AssertionError(f"{what}: gang {g} not fully bound")
        for g, keys in self.gangs.items():
            n = sum(key in binds for key in keys)
            if n not in (0, len(keys)):
                raise AssertionError(f"{what}: gang {g} bound {n} of "
                                     f"{len(keys)}")
        load: dict = {}
        for key, node in binds.items():
            c, m, g = self.req[key]
            lc, lm, lg, lp = load.get(node, (0.0, 0.0, 0.0, 0))
            load[node] = (lc + c, lm + m, lg + g, lp + 1)
        a = self.alloc
        over = [n for n, (c, m, g, p) in load.items()
                if c > a["cpu"] or m > a["memory"] or g > a["gpu"]
                or p > a["pods"]]
        if over:
            raise AssertionError(f"{what}: nodes over allocatable: "
                                 f"{over[:5]}")


def _gib(q: str) -> float:
    return float(q[:-2]) * 2 ** 30


def cycle_stats(rows, key):
    vals = [r[key] for r in rows if key in r]
    return {"p50": statistics.median(vals), "max": max(vals)} if vals \
        else None


def readback_stress(dev) -> dict:
    """start_readback against a producer the device is still running: a
    GPU spin, then a fill. A copy that did not wait for the producer's
    event would read the zeros from before the fill."""
    from volcano_tpu_torch.ops.pipeline import start_readback
    y = torch.zeros(1 << 20, dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)        # ~0.1 s of device time
    y.fill_(7)
    rb = start_readback(y)
    host, = rb.wait()
    ok = bool(host.is_pinned()) and bool((host == 7).all())
    if not ok or not torch.equal(host, y.cpu()):
        raise AssertionError("async readback differs from the blocking copy")
    return {"pinned": bool(host.is_pinned()), "elements": host.numel()}


class ReadbackProbe:
    """Wraps ops.pipeline.start_readback for one cycle: keeps each
    Readback with its device tensors so the pinned result can be held
    against a blocking .cpu() of the same tensors afterwards."""

    def __enter__(self):
        import volcano_tpu_torch.ops.pipeline as pl
        self._pl, self._orig, self.seen = pl, pl.start_readback, []

        def wrapped(*tensors):
            rb = self._orig(*tensors)
            self.seen.append((tensors, rb))
            return rb

        pl.start_readback = wrapped
        return self

    def __exit__(self, *exc):
        self._pl.start_readback = self._orig

    def check(self) -> int:
        if len(self.seen) != 1:
            raise AssertionError(f"{len(self.seen)} readbacks in the cycle")
        tensors, rb = self.seen[0]
        for h, t in zip(rb.wait(), tensors):
            if t.device.type != "cuda" or not h.is_pinned() \
                    or not torch.equal(h, t.cpu()):
                raise AssertionError("the cycle's async readback differs "
                                     "from a blocking copy")
        return sum(t.numel() for t in tensors)


class KernelAudit:
    """Wraps the solvers' fused_choice (the single-device solver's and the
    sharded one's) for the cycles run inside it: the outputs of every
    launch the cycle makes, the hdrf placeability prefilter's included,
    are held, bit for bit, against fused_choice_plain on the same inputs
    (the plain call launches no kernel, so the wrapper's count is the
    cycle's own). Records each launch's (T, N, R, families, prefilter) and
    the seconds the checks took."""

    def __enter__(self):
        from volcano_tpu_torch.ops import fused_choice as fc
        from volcano_tpu_torch.ops import solver
        from volcano_tpu_torch.parallel import sharded_solver
        self._mods = (solver, sharded_solver)
        self._orig, self.shapes = fc.fused_choice, []
        self.seconds = 0.0

        def audited(*args, **kw):
            before = fc.fused_choice.launches
            got = self._orig(*args, **kw)
            t0 = time.perf_counter()
            want = fc.fused_choice_plain(*args)
            shape = (args[0].shape[0], args[1].shape[0], args[0].shape[1],
                     tuple(args[-1]), bool(kw.get("prefilter")))
            if fc.fused_choice.launches != before + 1:
                raise AssertionError(f"{shape}: the kernel was not launched")
            if not all(same_bits(g, w) for g, w in zip(got, want)):
                raise AssertionError(
                    f"fused_choice disagrees with its plain version inside "
                    f"the cycle at (T, N, R, families, prefilter) = {shape}: "
                    f"best_idx differs at {int((got[1] != want[1]).sum())} "
                    f"rows")
            self.shapes.append(shape)
            self.seconds += time.perf_counter() - t0
            return got

        for mod in self._mods:
            mod.fused_choice = audited
        return self

    def __exit__(self, *exc):
        for mod in self._mods:
            mod.fused_choice = self._orig

    def summary(self) -> dict:
        return {"launches_checked": len(self.shapes),
                "prefilter_launches_checked": sum(s[4] for s in self.shapes),
                "audit_ms": self.seconds * 1e3,
                "shapes": sorted({f"T={t} N={n} R={r} {'+'.join(f)}"
                                  + (" prefilter" if p else "")
                                  for t, n, r, f, p in self.shapes})}


def event_cycles(c, cycles: int = 3) -> dict:
    """The event-sourced flatten at full scale. A gang whose pods fit no
    node (33 cpu each) stays pending; in each following cycle one bound
    gang finishes. The pending-job layout is then unchanged, so the
    flatten patches the finished gang's node rows from its events
    (flatten_mode "event"), the ordering stays on its events, the arena
    ships only dirty chunks, and the kernel still runs for the pending
    gang's rows, which bind nowhere."""
    stuck = c.submit(1, cpu_per_pod=33)
    first = c.run_cycle()
    c.check("stuck gang submitted")
    if first["binds"] or first["launches"] <= 0:
        raise AssertionError(f"stuck gang cycle: {first}")
    done = [g for g in c.gangs if g not in stuck][:cycles]
    rows = []
    for s, gang in enumerate(done):
        c.complete(gang)
        row = c.run_cycle()
        c.check(f"event cycle {s}")
        if row.get("flatten_mode") != "event" \
                or row.get("order_mode") != "event" \
                or row.get("arena_full_ship") or row["binds"] \
                or row["launches"] <= 0:
            raise AssertionError(f"event cycle {s}: {row}")
        rows.append(row)
    return {"regime": "event", "cycles": len(rows),
            "first_cycle_flatten_mode": first.get("flatten_mode"),
            "cycle_ms": cycle_stats(rows, "cycle_ms"),
            **{k: cycle_stats(rows, k) for k in CYCLE_KEYS},
            "flatten_modes": sorted({r["flatten_mode"] for r in rows}),
            "arena_bytes_shipped": cycle_stats(rows, "arena_bytes_shipped"),
            "delta_chunks": cycle_stats(rows, "delta_chunks"),
            "launches_per_cycle": [r["launches"] for r in rows]}


def small_cycle_pair(dev, cycles: int = 3, n_nodes: int = 50,
                     n_jobs: int = 40, seed: int = 5) -> dict:
    """A small seeded cluster with churn through the port's Scheduler
    twice, on ``dev`` and on the host (``device="cpu"``, the dense path):
    the same pods bound to the same nodes and the same jobs ready, cycle
    by cycle. (The kernel's choices equal the dense path's bit for bit,
    so this holds the rule of tests/test_solver.py — differences only
    between score-tied nodes — with no difference at all.)"""
    rng_state = np.random.default_rng(seed)
    churn = [sorted(rng_state.choice(n_jobs, n_jobs // 4, replace=False))
             for _ in range(cycles)]
    out = []
    for where in (dev, "cpu"):
        c = StoreCluster(where, n_nodes, 0, tasks_per_job=4, cpu="8",
                         mem="32Gi")
        rng = np.random.default_rng(seed)
        per_cycle = []
        for s in range(cycles):
            if s:
                # churn: a quarter of the gangs finish, pods deleted
                for j in churn[s]:
                    for key in c.gangs.get(f"j{j}", ()):
                        ns, name = key.split("/")
                        if c.store.try_get("pods", name, ns) is not None:
                            c.store.delete("pods", name, ns)
                        c.cache.binder.binds.pop(key, None)
            c.submit(int(rng.integers(n_jobs // 3, n_jobs // 2)))
            row = c.run_cycle()
            c.check(f"small cycle {s} on {where}")
            ready = sorted(j.uid for j in c.cache.jobs.values()
                           if j.pod_group is not None and j.ready())
            per_cycle.append((sorted(c.cache.binder.binds.items()), ready,
                              row["launches"]))
        out.append(per_cycle)
    card, host = out
    for s, ((b1, r1, _), (b2, r2, _)) in enumerate(zip(card, host)):
        if {k for k, _ in b1} != {k for k, _ in b2}:
            raise AssertionError(f"small cycle {s}: bound pods differ")
        if r1 != r2:
            raise AssertionError(f"small cycle {s}: ready jobs differ")
        if b1 != b2:
            raise AssertionError(f"small cycle {s}: node choices differ")
    if any(n <= 0 for _, _, n in card):
        raise AssertionError("a small card cycle launched no kernel")
    return {"cycles": cycles, "binds": len(card[-1][0]),
            "ready_jobs": len(card[-1][1]),
            "launches_per_cycle": [n for _, _, n in card],
            "identical_to_host": True}


def phase_cycle(dev, scale=None) -> dict:
    """The port's Scheduler.run_once at full_cycle() scale: a warm-up
    burst, a measured burst on a fresh identical cluster sharing the warm
    arena, warm-up waves, then timed steady cycles of one wave each; the
    async readback checked in one cycle; a steady cycle profiled; a small
    churned cluster card vs host."""
    sc = dict(CYCLE, **(scale or {}))
    n, j, tpj = sc["n_nodes"], sc["n_jobs"], sc["tasks_per_job"]
    t0 = time.perf_counter()
    warm = StoreCluster(dev, n, j, tpj)
    build_s = time.perf_counter() - t0
    # the warm-up burst and the last warm-up wave run at the shapes of the
    # measured ones, with every launch checked against the plain version
    with KernelAudit() as audit_burst:
        warm_row = warm.run_cycle()
    warm.check("warm-up burst", gangs=list(warm.gangs))
    c = StoreCluster(dev, n, j, tpj, shared_arena=warm.cache.device_cache)
    del warm
    burst = c.run_cycle()
    c.check("burst", gangs=list(c.gangs))
    if burst["binds"] != j * tpj or burst["launches"] <= 0:
        raise AssertionError(f"burst: {burst['binds']} binds, "
                             f"{burst['launches']} launches")
    emit({"phase": "cycle", "regime": "burst", "nodes": n,
          "pods": j * tpj, "build_s": build_s,
          "warmup_cycle_ms": warm_row["cycle_ms"], **burst})

    # warm-up waves (the steady shape's first cycle re-ships the arena),
    # then the timed steady cycles, one wave of wave_jobs gangs each
    w = sc["wave_jobs"]
    for i in range(sc["warm_waves"]):
        gangs = c.submit(w)
        if i == sc["warm_waves"] - 1:
            with KernelAudit() as audit_steady:
                row = c.run_cycle()
        else:
            row = c.run_cycle()
        c.check(f"warm-up wave {i}", gangs=gangs)
        if row["launches"] <= 0:
            raise AssertionError(f"warm-up wave {i} launched no kernel")
    emit({"phase": "cycle_audit",
          "burst": audit_burst.summary(), "steady": audit_steady.summary(),
          "equal": True})
    rows = []
    for s in range(sc["steady_cycles"]):
        gangs = c.submit(w)
        if s == 1:
            with ReadbackProbe() as probe:
                row = c.run_cycle()
            readback_elems = probe.check()
        else:
            row = c.run_cycle()
        c.check(f"steady cycle {s}", gangs=gangs)
        if row["binds"] != w * tpj or row["launches"] <= 0:
            raise AssertionError(f"steady cycle {s}: {row['binds']} binds, "
                                 f"{row['launches']} launches")
        # a wave of new gangs changes the pending-job layout, which the
        # event-sourced flatten declines by design (job_layout: the JAX
        # package does the same on this stream); it re-diffs rows
        # incrementally, never cold, and the ordering stays on its events
        if row.get("arena_full_ship") or row.get("flatten_mode") == "cold" \
                or row.get("order_mode") != "event":
            raise AssertionError(f"steady cycle {s}: full re-ship, cold "
                                 f"flatten or ordering fallback ({row})")
        # a delta ships exactly its dirty chunks: values and an int32
        # index each
        chunk_bytes = c.cache.device_cache.chunk * 4 + 4
        if row["arena_bytes_shipped"] != row["delta_chunks"] * chunk_bytes:
            raise AssertionError(f"steady cycle {s}: "
                                 f"{row['arena_bytes_shipped']} bytes for "
                                 f"{row['delta_chunks']} dirty chunks")
        rows.append(row)
    # the solves read views of the resident buffers and the scatters
    # write them in place: after the run they must still equal the
    # host mirror, chunk for chunk
    dc = c.cache.device_cache
    for dev_buf, host in ((dc._dev_f, dc._host_f), (dc._dev_i, dc._host_i)):
        if not torch.equal(dev_buf.reshape(-1).cpu(), torch.from_numpy(host)):
            raise AssertionError("the resident arena drifted from its "
                                 "host mirror")
    emit({"phase": "cycle", "regime": "steady", "cycles": len(rows),
          "arena_matches_mirror": True,
          "wave_pods": w * tpj, "running_pods": len(c.cache.binder.binds),
          "cycle_ms": cycle_stats(rows, "cycle_ms"),
          **{k: cycle_stats(rows, k) for k in CYCLE_KEYS},
          "flatten_modes": sorted({r.get("flatten_mode") for r in rows}),
          "flatten_fallback_reasons": sorted(
              {str(r.get("flatten_fallback_reason")) for r in rows}),
          "order_modes": sorted({r.get("order_mode") for r in rows}),
          "arena_bytes_shipped": cycle_stats(rows, "arena_bytes_shipped"),
          "delta_chunks": cycle_stats(rows, "delta_chunks"),
          "arena_full_ship": sum(r.get("arena_full_ship", 0) for r in rows),
          "launches_per_cycle": [r["launches"] for r in rows],
          "binds_per_cycle": [r["binds"] for r in rows],
          "cycles_ms": [r["cycle_ms"] for r in rows]})
    emit({"phase": "cycle_readback", "cycle_elements": readback_elems,
          **readback_stress(dev), "equal_to_blocking_copy": True})
    prof = profile_cycle(c, w)
    emit({"phase": "cycle", **event_cycles(c)})
    emit({"phase": "cycle_small", **small_cycle_pair(dev)})
    return {"burst": burst, "steady": rows, "profile": prof}


LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")


def trace_profile(fn) -> dict:
    """fn() once under torch.profiler, read from the trace the profiler
    writes (its key_averages() takes minutes over the tens of thousands of
    launches of a per-task loop or an hdrf cycle): the device time (the
    kernels', copies' and sets' durations summed), the kernel launches and
    the device time by kernel. The trace is written under the checkout's
    build/ and deleted; a session that records no device event is taken
    again, up to 3 times (seen now and then on the H100)."""
    import os
    from torch.profiler import ProfilerActivity, profile
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build")
    os.makedirs(build, exist_ok=True)
    path = os.path.join(build, f"trace-{os.getpid()}.json")
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            result = fn()
            torch.cuda.synchronize()
        prof.export_chrome_trace(path)
        try:
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        by_name: dict = {}
        for e in events:
            if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
                n, us = by_name.get(e["name"], (0, 0.0))
                by_name[e["name"]] = (n + 1, us + float(e.get("dur", 0.0)))
        if by_name:
            return {"result": result,
                    "device_ms": sum(us for _, us in by_name.values()) / 1e3,
                    "launches": sum(e.get("name") in LAUNCH_CALLS
                                    for e in events),
                    "by_name": by_name}
    raise AssertionError("the profiler saw no device time in 3 sessions")


def profile_cycle(c, w, regime: str = "steady", plain=None) -> dict:
    """One steady cycle under torch.profiler: device time by kernel, the
    kernel launches, and the device's idle share of the unprofiled steady
    cycle's wall time (the median of ``plain``, the cycle times of earlier
    cycles of the regime; by default, of three cycles run first). A
    profile with no device events takes one more wave."""
    if plain is None:
        plain = []
        for _ in range(3):
            c.submit(w)
            plain.append(c.run_cycle()["cycle_ms"])

    def wave():
        c.submit(w)
        return c.run_cycle()

    prof = trace_profile(wave)
    row = prof["result"]
    c.check("profiled steady cycle")
    rows = sorted(((us, n, k) for k, (n, us) in prof["by_name"].items()),
                  reverse=True)
    device_ms = prof["device_ms"]
    wall = statistics.median(plain)
    out = {"phase": "cycle_profile", "regime": regime,
           "wall_ms_unprofiled": wall, "wall_ms_profiled": row["cycle_ms"],
           "device_ms": device_ms, "device_idle_share": 1.0 - device_ms / wall,
           "kernel_launches": prof["launches"],
           "fused_choice_launches": row["launches"],
           "prefilter_launches": row["prefilter_launches"],
           "fused_choice_device_ms": sum(
               us for us, _, k in rows if "fused_choice" in k) / 1e3,
           "device_kernels": [{"name": k[:80], "us": us, "count": cnt}
                              for us, cnt, k in rows[:15]],
           "timing": {k: row[k] for k in CYCLE_KEYS if k in row}}
    emit(out)
    return out


# -- hierarchical DRF (BASELINE config #5) ----------------------------------

HDRF = dict(n_nodes=1000, n_jobs=500, tasks_per_job=10, cpu="8", mem="32Gi",
            gpus=8, gpu_every=5, wave_jobs=5, steady_cycles=5)
#: example/hierarchical-jobs.yaml's three leaf queues (name, weight,
#: annotations)
HDRF_QUEUES = [(name, 1, {"volcano.sh/hierarchy": path,
                          "volcano.sh/hierarchy-weights": weights})
               for name, path, weights in (
                   ("root-eng-prod", "root/eng/prod", "1/2/8"),
                   ("root-eng-dev", "root/eng/dev", "1/2/2"),
                   ("root-sci", "root/sci", "1/2"))]
#: each leaf's share of the cluster under the weights: eng and sci split
#: the root 2:2, prod and dev split eng 8:2
HDRF_SPLIT = {"root-eng-prod": 0.4, "root-eng-dev": 0.1, "root-sci": 0.5}
#: the default conf with drf.enableHierarchy, less proportion: the conf
#: loader rejects proportion beside the hierarchy (in both packages)
HDRF_CONF = """
actions: "enqueue, allocate, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
- plugins:
  - name: drf
    arguments:
      drf.enableHierarchy: true
  - name: predicates
  - name: nodeorder
"""


def hdrf_cluster(dev, sc, shared_arena=None, solver_mode=None):
    return StoreCluster(dev, sc["n_nodes"], sc["n_jobs"], sc["tasks_per_job"],
                        cpu=sc["cpu"], mem=sc["mem"], gpus=sc["gpus"],
                        gpu_every=sc["gpu_every"], size_stride=3,
                        queues=HDRF_QUEUES, conf=HDRF_CONF,
                        shared_arena=shared_arena, solver_mode=solver_mode)


def queue_shares(c, n_nodes: int) -> dict:
    """Per queue: the bound pods and the dominant share of the cluster
    they hold (the largest of their cpu, memory and gpu shares), beside
    the share the weights give."""
    a = c.alloc
    total = (a["cpu"] * n_nodes, a["memory"] * n_nodes, a["gpu"] * n_nodes)
    held = {q: [0, 0.0, 0.0, 0.0] for q in c.queues}
    for key in c.cache.binder.binds:
        q = c.queue_of[key.split("/")[1].rsplit("-", 1)[0]]
        h = held[q]
        h[0] += 1
        for d, v in enumerate(c.req[key]):
            h[1 + d] += v
    return {q: {"binds": h[0],
                "share": max(v / t for v, t in zip(h[1:], total) if t),
                "cpu_share": h[1] / total[0],
                "split": HDRF_SPLIT.get(q)} for q, h in held.items()}


def phase_hdrf(dev, scale=None) -> dict:
    """Allocate with the drf hierarchy at BASELINE config #5's scale (8-cpu
    nodes, so that demand is ~1.25x the cluster's cpu and the weighted
    tree decides who binds; each queue's gangs take every cpu size, where
    bench.py's 1 + k % 3 would tie a queue to one size): a warm-up burst,
    a measured burst on a fresh identical cluster sharing the warm arena,
    with every kernel launch of both call sites (the admission round and
    the placeability prefilter) held against the plain version, then
    steady cycles in which bound gangs finish and as many new ones
    arrive."""
    sc = dict(HDRF, **(scale or {}))
    n = sc["n_nodes"]
    warm = hdrf_cluster(dev, sc)
    warm_row = warm.run_cycle()
    warm.check("hdrf warm-up burst")
    c = hdrf_cluster(dev, sc, shared_arena=warm.cache.device_cache)
    del warm
    with KernelAudit() as audit:
        burst = c.run_cycle()
    c.check("hdrf burst")
    audited = audit.summary()
    if burst["binds"] <= 0 or burst["prefilter_launches"] <= 0 \
            or audited["launches_checked"] != burst["launches"] \
            or audited["prefilter_launches_checked"] \
            != burst["prefilter_launches"]:
        raise AssertionError(f"hdrf burst: {burst}, audit {audited}")
    shares = queue_shares(c, n)
    # the weighted tree decides: the lightest leaf (eng/dev, 10% of the
    # cluster) holds less than either heavier leaf
    dev_share = shares["root-eng-dev"]["share"]
    if not dev_share < min(shares["root-eng-prod"]["share"],
                           shares["root-sci"]["share"]):
        raise AssertionError(f"hdrf burst shares ignore the tree: {shares}")
    emit({"phase": "hdrf", "regime": "burst", "nodes": n,
          "pods": sc["n_jobs"] * sc["tasks_per_job"],
          "warmup_cycle_ms": warm_row["cycle_ms"],
          "cycle_ms_less_audit": burst["cycle_ms"] - audited["audit_ms"],
          **burst, "queues": shares, "cycle_audit": audited})
    rows = [burst]
    w = sc["wave_jobs"]
    for s in range(sc["steady_cycles"]):
        binds = c.cache.binder.binds
        done = [g for g, keys in c.gangs.items()
                if all(k in binds for k in keys)][:w]
        for g in done:
            c.complete(g)
        c.submit(w)
        row = c.run_cycle()
        c.check(f"hdrf steady cycle {s}")
        if row["launches"] <= 0 or row["prefilter_launches"] <= 0:
            raise AssertionError(f"hdrf steady cycle {s}: {row}")
        emit({"phase": "hdrf", "regime": "steady", "cycle": s,
              "finished_gangs": len(done), **row,
              "queues": queue_shares(c, n)})
        rows.append(row)
    # one more wave under the profiler (not part of the counted run)
    t0 = time.perf_counter()
    prof = profile_cycle(c, w, regime="hdrf_steady",
                         plain=[r["cycle_ms"] for r in rows[1:]])
    emit({"phase": "hdrf_profile_seconds",
          "seconds": time.perf_counter() - t0})
    return {"rows": rows, "profile": prof}


# -- preempt and reclaim (BASELINE config #4) --------------------------------

EVICT = dict(n_nodes=200, cpu="16", mem="64Gi", low_pods=2000, gang=1000,
             a_jobs=320, b_jobs=100, tasks_per_job=10)
EVICT_CONF = """
actions: "enqueue, allocate, preempt, reclaim, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
"""
PRIORITY = {"high-priority": 100, "low-priority": 1}


class PipelineRecorder:
    """The session's pipelined tasks, read at its close (the cache's
    decision-recorder seam)."""

    def __init__(self):
        from volcano_tpu_torch.api import TaskStatus
        self.status = TaskStatus.PIPELINED
        self.last = []

    def observe_session(self, ssn) -> None:
        self.last = sorted(
            (f"{t.namespace}/{t.name}", t.node_name)
            for job in ssn.jobs.values()
            for t in job.task_status_index.get(self.status, {}).values())


class EvictAudit:
    """Wraps the port's two eviction solves for the cycles run inside it:
    each call's inputs, result and host time (synchronised). check() then
    holds each result against the same solve on CPU tensors and re-runs
    it on the card under the profiler for its device time
    (trace_profile)."""

    NAMES = ("solve_evict", "solve_evict_uniform")

    def __enter__(self):
        from volcano_tpu_torch.ops import evict
        self._mod, self.calls = evict, []
        self._real = {name: getattr(evict, name) for name in self.NAMES}
        for name in self.NAMES:
            def wrapped(arrays, victims, score_params, _name=name, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = self._real[_name](arrays, victims, score_params, **kw)
                torch.cuda.synchronize()
                self.calls.append((_name, arrays, victims, score_params, kw,
                                   res, (time.perf_counter() - t0) * 1e3))
                return res
            setattr(evict, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name in self.NAMES:
            setattr(self._mod, name, self._real[name])

    def check(self) -> list:
        rows = []
        for name, arrays, victims, params, kw, res, host_ms in self.calls:
            real = self._real[name]
            cpu = real(arrays, victims, params, **dict(kw, device="cpu"))
            for k in ("assigned", "evicted_by", "job_placed"):
                if not torch.equal(getattr(res, k).cpu(), getattr(cpu, k)):
                    raise AssertionError(f"{name}: {k} differs card vs the "
                                         f"port's own solve on the host")
            dev_ms = trace_profile(
                lambda: real(arrays, victims, params, **kw))["device_ms"]
            rows.append({"solve": name,
                         "T": int(arrays["task_init_req"].shape[0]),
                         "N": int(arrays["node_idle"].shape[0]),
                         "J": int(arrays["job_min"].shape[0]),
                         "V": int(victims["v_req"].shape[0]),
                         "host_ms": host_ms, "device_ms": dev_ms,
                         "placed": int((res.assigned >= 0).sum().item()),
                         "evicted": int((res.evicted_by >= 0).sum().item()),
                         "equal_to_host_solve": True})
        return rows


class EvictCluster:
    """The port's Scheduler under EVICT_CONF over ``n_nodes`` nodes, with
    the priority classes high-priority (100) and low-priority (1). Running
    pods are created on their nodes (as a kubelet reports them), claimers
    pending; FakeBinder and FakeEvictor record the binds and evictions."""

    def __init__(self, dev, n_nodes: int, cpu: str, mem: str, queues):
        from volcano_tpu_torch.cache import (
            FakeBinder, FakeEvictor, SchedulerCache,
        )
        from volcano_tpu_torch.client import ClusterStore
        from volcano_tpu_torch.models import (
            Node, PriorityClass, Queue, QueueSpec,
        )
        from volcano_tpu_torch.scheduler import Scheduler

        self.store = ClusterStore()
        self.cache = SchedulerCache(self.store, device=dev)
        self.cache.binder = FakeBinder()
        self.cache.evictor = FakeEvictor()
        self.recorder = self.cache.decision_recorder = PipelineRecorder()
        self.cache.run()
        for name, value in PRIORITY.items():
            self.store.create("priorityclasses", PriorityClass(name, value))
        self.reclaimable = {}
        for name, reclaimable in queues:
            self.store.apply("queues", Queue(name=name, spec=QueueSpec(
                weight=1, reclaimable=reclaimable)))
            self.reclaimable[name] = reclaimable is not False
        rl = {"cpu": cpu, "memory": mem, "pods": "110"}
        self.alloc = (float(cpu), _gib(mem), 110.0)
        for i in range(n_nodes):
            self.store.create("nodes", Node(name=f"n{i}", allocatable=rl,
                                            capacity=dict(rl)))
        self.pods: dict = {}    # key -> (job, cpu, memory bytes, node)
        self.jobs: dict = {}    # job -> (queue, priority, min_member)
        self.evicted: set = set()
        self.sched = Scheduler(self.cache, scheduler_conf=EVICT_CONF)

    def job(self, name: str, queue: str, prio: str, min_member: int,
            n_pods: int, cpu: int, mem_gi: int, nodes=None) -> None:
        """A job of ``n_pods`` pods: Running on ``nodes`` (one each) when
        given, else Pending."""
        from volcano_tpu_torch.api.types import POD_GROUP_ANNOTATION
        from volcano_tpu_torch.models import (
            Pod, PodGroup, PodGroupPhase, PodGroupSpec, PodGroupStatus,
        )
        phase = PodGroupPhase.RUNNING if nodes else PodGroupPhase.PENDING
        self.store.create("podgroups", PodGroup(
            name=name, namespace="ev",
            spec=PodGroupSpec(min_member=min_member, queue=queue,
                              priority_class_name=prio),
            status=PodGroupStatus(phase=phase)))
        self.jobs[name] = (queue, PRIORITY[prio], min_member)
        for i in range(n_pods):
            node = nodes[i] if nodes else ""
            self.store.create("pods", Pod(
                name=f"{name}-{i}", namespace="ev", node_name=node,
                phase="Running" if node else "Pending",
                annotations={POD_GROUP_ANNOTATION: name},
                containers=[{"requests": {"cpu": str(cpu),
                                          "memory": f"{mem_gi}Gi"}}]))
            self.pods[f"ev/{name}-{i}"] = (name, float(cpu),
                                           mem_gi * float(2 ** 30), node)

    def cycle(self) -> dict:
        """One Scheduler.run_once (the kernel's counts set to 0 just
        before, read just after): its evictions, pipelines and binds."""
        from volcano_tpu_torch.ops import fused_choice as fc
        binds, evicts = self.cache.binder.binds, self.cache.evictor.evicts
        before, n_ev = dict(binds), len(evicts)
        fc.fused_choice.launches = 0
        fc.fused_choice.launches_hdrf_prefilter = 0
        t0 = time.perf_counter()
        self.sched.run_once()
        ms = (time.perf_counter() - t0) * 1e3
        t = self.sched.last_cycle_timing
        errors = [k for k in t if k.endswith("_error")]
        if errors or t.get("host_fallback"):
            raise AssertionError(f"the cycle left the device path: {errors}")
        return {"cycle_ms": ms, "evicts": list(evicts[n_ev:]),
                "pipelined": list(self.recorder.last),
                "binds": sorted(k for k, v in binds.items()
                                if before.get(k) != v),
                "launches": fc.fused_choice.launches,
                "timing": {k: v for k, v in t.items()
                           if isinstance(v, float)}}

    def kubelet(self, evicts) -> None:
        """The evicted pods terminate: deleted from the store."""
        for key in evicts:
            ns, name = key.split("/")
            self.store.delete("pods", name, ns)
        self.evicted.update(evicts)

    def check(self, what: str, row: dict, preempt: bool) -> int:
        """Every evicted victim was allowed (queue scope and a lower
        priority than every claimer: the gang plugin's victim rule in this
        version compares priorities only, so a victim job may drop below
        its minMember) and no node's future idle (allocatable - running
        not evicted - pipelined) is below zero. Returns how many victim
        jobs were left below their minMember."""
        evicts = set(row["evicts"])
        claimers = {self.pods[k][0] for k, _ in row["pipelined"]}
        for key in evicts:
            vq, vprio, _ = self.jobs[self.pods[key][0]]
            for cj in claimers:
                cq, cprio, _ = self.jobs[cj]
                scoped = (vq == cq) if preempt else \
                    (vq != cq and self.reclaimable[vq])
                if not scoped or vprio >= cprio:
                    raise AssertionError(f"{what}: victim {key} not allowed "
                                         f"for claimer {cj}")
        gone = self.evicted | evicts
        running: dict = {}
        load: dict = {}
        for key, (job, cpu, mem, node) in self.pods.items():
            if node and key not in gone:
                running[job] = running.get(job, 0) + 1
                lc, lm, lp = load.get(node, (0.0, 0.0, 0.0))
                load[node] = (lc + cpu, lm + mem, lp + 1)
        below_min = sum(running.get(job, 0) < self.jobs[job][2]
                        for job in {self.pods[k][0] for k in evicts})
        for key, node in row["pipelined"]:
            _, cpu, mem, _ = self.pods[key]
            lc, lm, lp = load.get(node, (0.0, 0.0, 0.0))
            load[node] = (lc + cpu, lm + mem, lp + 1)
        over = [n for n, v in load.items()
                if any(x > a for x, a in zip(v, self.alloc))]
        if over:
            raise AssertionError(f"{what}: future idle below zero on "
                                 f"{over[:5]}")
        return below_min


def evict_part(c, part: str, claimer_jobs) -> dict:
    """One eviction cycle with its solves audited, the checks, then the
    victims deleted and the next cycle binding the claimers."""
    preempt = part == "preempt"
    with EvictAudit() as audit:
        row = c.cycle()
    below_min = c.check(part, row, preempt)
    claimers = [k for k, v in c.pods.items() if v[0] in claimer_jobs]
    pipelined = [k for k, _ in row["pipelined"]]
    if not row["evicts"] or not pipelined:
        raise AssertionError(f"{part}: {len(row['evicts'])} evictions, "
                             f"{len(pipelined)} pipelines")
    if preempt and len(pipelined) != len(claimers):
        raise AssertionError(f"preempt pipelined {len(pipelined)} of the "
                             f"gang's {len(claimers)} pods")
    t0 = time.perf_counter()
    solves = audit.check()
    check_s = time.perf_counter() - t0
    route = "solve_evict_uniform" if preempt else "solve_evict"
    if not any(s["solve"] == route and s["evicted"] for s in solves):
        raise AssertionError(f"{part}: no eviction through {route}")
    c.kubelet(row["evicts"])
    nxt = c.cycle()
    claimed = set(claimers)
    bound = [k for k in nxt["binds"] if k in claimed]
    if len(bound) < len(pipelined):
        raise AssertionError(f"{part}: {len(bound)} claimers bound after "
                             f"{len(pipelined)} pipelined")
    t = row["timing"]
    return {"phase": "evict", "part": part, "cycle_ms": row["cycle_ms"],
            "evictions": len(row["evicts"]), "pipelines": len(pipelined),
            "victim_jobs": len({c.pods[k][0] for k in row["evicts"]}),
            "victim_jobs_below_min_member": below_min,
            "claimer_pods": len(claimers), "solves": solves,
            f"{part}_solve_ms": t.get(f"{part}_solve_ms"),
            f"{part}_ms": t.get(f"{part}_ms"), "launches": row["launches"],
            "timing": t, "next_cycle_ms": nxt["cycle_ms"],
            "next_cycle_claimer_binds": len(bound),
            "next_cycle_launches": nxt["launches"],
            "audit_check_seconds": check_s}


def phase_evict(dev, scale=None) -> list:
    """Preempt at BASELINE config #4's scale (bench.py config4_preempt: a
    low-priority job of 2000 running pods, 10 a node on 200 nodes of 16
    cpu, and a high-priority gang of 1000 two-cpu pods in the same queue;
    uniform claimers, so solve_evict_uniform), then reclaim on the same
    nodes (queue a, reclaimable, fills them with 320 low-priority jobs of
    10 one-cpu pods; queue b submits 100 high-priority jobs of 10 two-cpu
    pods; per-task solve_evict)."""
    sc = dict(EVICT, **(scale or {}))
    n, tpj = sc["n_nodes"], sc["tasks_per_job"]
    c = EvictCluster(dev, n, sc["cpu"], sc["mem"], [("q0", None)])
    c.job("low", "q0", "low-priority", 1, sc["low_pods"], 1, 2,
          nodes=[f"n{i % n}" for i in range(sc["low_pods"])])
    c.job("high", "q0", "high-priority", sc["gang"], sc["gang"], 2, 4)
    rows = [evict_part(c, "preempt", {"high"})]
    emit(rows[-1])
    c = EvictCluster(dev, n, sc["cpu"], sc["mem"], [("a", True), ("b", None)])
    for j in range(sc["a_jobs"]):
        c.job(f"a{j}", "a", "low-priority", 1, tpj, 1, 2,
              nodes=[f"n{(j * tpj + i) % n}" for i in range(tpj)])
    for j in range(sc["b_jobs"]):
        c.job(f"b{j}", "b", "high-priority", 1, tpj, 2, 4)
    rows.append(evict_part(c, "reclaim",
                           {f"b{j}" for j in range(sc["b_jobs"])}))
    emit(rows[-1])
    return rows


# -- sequential allocate (BASELINE config #2's scale) ------------------------

SEQUENTIAL_CONF = """
actions: "enqueue, allocate, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
- plugins:
  - name: predicates
  - name: binpack
configurations:
- name: allocate
  arguments:
    mode: sequential
"""


def phase_sequential(dev, n_nodes: int = 50, n_jobs: int = 50) -> dict:
    """One cycle with allocate in ``mode: sequential`` (the parity oracle,
    one device step per task) on the card and the same cycle on the host:
    the same pods bound to the same nodes."""
    runs = []
    for where in (dev, "cpu"):
        c = StoreCluster(where, n_nodes, n_jobs, 10, conf=SEQUENTIAL_CONF)
        row = c.run_cycle()
        c.check(f"sequential cycle on {where}")
        runs.append((sorted(c.cache.binder.binds.items()), row))
    (card, row), (host, host_row) = runs
    if not card or card != host:
        raise AssertionError(f"sequential: {len(card)} binds on the card, "
                             f"{len(host)} on the host, or they differ")
    out = {"phase": "sequential", "nodes": n_nodes, "pods": n_jobs * 10,
           "binds": len(card), "cycle_ms": row["cycle_ms"],
           "solve_ms": row.get("solve_ms"), "host_cycle_ms": host_row[
               "cycle_ms"], "host_solve_ms": host_row.get("solve_ms"),
           "identical_to_host": True}
    emit(out)
    return out

# -- the node-axis sharded solver (bench.py sharded_scale()) ------------------

SHARDED = dict(shards=4, n_nodes=CYCLE["n_nodes"], n_jobs=CYCLE["n_jobs"],
               steady_cycles=5, scale_tasks=100_000, scale_nodes=10_000,
               hdrf_nodes=128)
#: the sharded burst's kernel shape: T=10240 over one shard's 512 of 2048
#: nodes, the default conf's kube scores
SHARD_KERNEL = (10240, 512, 2, ("kube",))


class ShardLaunches:
    """Counts the sharded solver's kernel launches per shard for the
    cycles run inside it (each shard launches on its own signature mask,
    so the mask's address names the shard; in first-seen order, which is
    shard order). Launches nothing itself."""

    def __enter__(self):
        from volcano_tpu_torch.ops import fused_choice as fc
        from volcano_tpu_torch.parallel import sharded_solver
        self._mod, self._orig = sharded_solver, sharded_solver.fused_choice
        self.by_shard: dict = {}

        def counted(*args, **kw):
            before = fc.fused_choice.launches
            out = self._orig(*args, **kw)
            key = args[7].data_ptr()
            self.by_shard[key] = self.by_shard.get(key, 0) + (
                fc.fused_choice.launches - before)
            return out

        sharded_solver.fused_choice = counted
        return self

    def __exit__(self, *exc):
        self._mod.fused_choice = self._orig

    def counts(self) -> list:
        return list(self.by_shard.values())


def _arena_row(c) -> dict:
    t = c.sched.last_cycle_timing
    return {k: t[k] for k in ("arena_mode", "arena_shard_bytes",
                              "arena_bytes_shipped") if k in t}


def sharded_cycles(dev, mesh, sc, twin=None) -> dict:
    """Part (a): the cycle phase's cluster through the sharded Scheduler
    over ``mesh`` and through a packed twin (or against ``twin``, the
    binds a packed twin gave before): a burst with every launch audited,
    steady waves (the last with a gang that fits no node), then two cycles
    with nothing new. Every cycle's binds identical to the twin's; the
    second quiet cycle ships 0 bytes to every shard."""
    from contextlib import nullcontext

    from volcano_tpu_torch.ops.device_cache import ShardedDeviceCache

    n, j = sc["n_nodes"], sc["n_jobs"]
    tpj, w = CYCLE["tasks_per_job"], CYCLE["wave_jobs"]
    info = {"shards": mesh.size, "distinct_devices": len(mesh.distinct)}
    s = StoreCluster(dev, n, j, tpj, solver_mode="sharded")
    s.cache.sharded_device_cache = ShardedDeviceCache(mesh)
    p = StoreCluster(dev, n, j, tpj) if twin is None else None
    plan = [("burst", 0, 0)] + [
        (f"steady {i}", w, int(i == sc["steady_cycles"] - 1))
        for i in range(sc["steady_cycles"])] + [
        ("quiet 0", 0, 0), ("quiet 1", 0, 0)]
    rows, binds, audit = [], [], None
    for i, (label, wave, stuck) in enumerate(plan):
        gangs = []
        for c in (s, p) if p is not None else (s,):
            gangs = c.submit(wave)
            if stuck:
                c.submit(1, cpu_per_pod=33)
        with (KernelAudit() if label == "burst" else nullcontext()) as au:
            with ShardLaunches() as sl:
                row = s.run_cycle()
        audit = au.summary() if label == "burst" else audit
        s.check(f"sharded {label}", gangs=gangs if i else list(s.gangs))
        got = sorted(s.cache.binder.binds.items())
        if p is not None:
            prow = p.run_cycle()
            p.check(f"packed twin {label}")
            want = sorted(p.cache.binder.binds.items())
            row.update(packed_cycle_ms=prow["cycle_ms"],
                       packed_launches=prow["launches"],
                       packed_solve_ms=prow.get("solve_ms"))
        else:
            want = twin[i]
        if got != want:
            raise AssertionError(f"sharded {label}: binds differ from the "
                                 f"packed twin's")
        binds.append(got)
        row.update(_arena_row(s), launches_per_shard=sl.counts(), **info)
        if row.get("arena_mode") != "sharded" or (
                label != "quiet 1" and row["launches"] <= 0):
            raise AssertionError(f"sharded {label}: {row}")
        if label == "burst" and row["binds"] != j * tpj:
            raise AssertionError(f"sharded burst bound {row['binds']}")
        emit({"phase": "sharded", "part": "cycle", "regime": label,
              "identical_to_packed": True, **row})
        rows.append(row)
    last = rows[-1]
    if last["arena_shard_bytes"] != [0.0] * mesh.size \
            or last["arena_bytes_shipped"] != 0.0:
        raise AssertionError(f"the quiet cycle shipped bytes: {last}")
    emit({"phase": "sharded", "part": "cycle_audit", **info, **audit,
          "equal": True})
    return {"rows": rows, "binds": binds, "audit": audit}


def sharded_hdrf(dev, mesh, sc) -> dict:
    """Part (d): the hdrf cell's cluster, cut to ``hdrf_nodes`` nodes and
    half as many gangs (BASELINE config #5's ratio of demand to cpu),
    through the sharded Scheduler over ``mesh`` beside a packed twin: one
    burst with every launch of both per-shard call sites (the round's
    choice and the hdrf placeability prefilter) held against the plain
    version; binds identical to the twin's."""
    from volcano_tpu_torch.ops.device_cache import ShardedDeviceCache

    h = dict(HDRF, n_nodes=sc["hdrf_nodes"], n_jobs=sc["hdrf_nodes"] // 2)
    info = {"shards": mesh.size, "distinct_devices": len(mesh.distinct)}
    s = hdrf_cluster(dev, h, solver_mode="sharded")
    s.cache.sharded_device_cache = ShardedDeviceCache(mesh)
    p = hdrf_cluster(dev, h)
    with KernelAudit() as au:
        with ShardLaunches() as sl:
            row = s.run_cycle()
    audit = au.summary()
    s.check("sharded hdrf burst")
    prow = p.run_cycle()
    p.check("packed twin hdrf burst")
    if sorted(s.cache.binder.binds.items()) \
            != sorted(p.cache.binder.binds.items()):
        raise AssertionError("sharded hdrf burst: binds differ from the "
                             "packed twin's")
    row.update(_arena_row(s), launches_per_shard=sl.counts(), **info,
               packed_cycle_ms=prow["cycle_ms"],
               packed_launches=prow["launches"],
               packed_prefilter_launches=prow["prefilter_launches"])
    if row.get("arena_mode") != "sharded" or row["binds"] <= 0 \
            or audit["launches_checked"] != row["launches"] \
            or audit["prefilter_launches_checked"] <= 0 \
            or audit["prefilter_launches_checked"] \
            != row["prefilter_launches"]:
        raise AssertionError(f"sharded hdrf burst: {row}, audit {audit}")
    emit({"phase": "sharded", "part": "hdrf", "regime": "burst",
          "nodes": h["n_nodes"], "pods": h["n_jobs"] * h["tasks_per_job"],
          "identical_to_packed": True, **row, "cycle_audit": audit})
    return row


def synth_snapshot(n_tasks: int, n_nodes: int, n_queues: int = 3,
                   tasks_per_job: int = 97, seed: int = 7):
    """bench.py's _synth_snapshot on the port's SnapshotArrays: the padded
    arrays of a problem built straight from numpy (no 100k pod objects),
    sized unsaturated (capacity ~3x demand) so every gang places in one
    fixpoint iteration."""
    from volcano_tpu_torch.api.resource import ResourceVocab
    from volcano_tpu_torch.ops import SnapshotArrays

    rng = np.random.default_rng(seed)
    T, N = n_tasks, n_nodes
    R = 2
    J = max(T // tasks_per_job + (1 if T % tasks_per_job else 0), 1)
    arr = SnapshotArrays(vocab=ResourceVocab())
    arr.task_init_req = np.zeros((T, R), np.float32)
    arr.task_job = np.zeros(T, np.int32)
    arr.task_rank = np.arange(T, dtype=np.int32)
    arr.task_sig = np.zeros(T, np.int32)
    arr.task_counts_ready = np.ones(T, bool)
    arr.task_valid = np.ones(T, bool)
    job_min = np.zeros(J, np.int32)
    for j in range(J):
        lo, hi = j * tasks_per_job, min((j + 1) * tasks_per_job, T)
        req = (float(rng.integers(1, 4)) * 1000.0,
               float(rng.integers(1, 5)) * (1 << 30))
        arr.task_init_req[lo:hi] = req
        arr.task_job[lo:hi] = j
        job_min[j] = hi - lo
    arr.task_req = arr.task_init_req.copy()
    arr.job_min = job_min
    arr.job_ready_base = np.zeros(J, np.int32)
    arr.job_queue = (np.arange(J) % n_queues).astype(np.int32)
    arr.job_valid = np.ones(J, bool)
    arr.job_drf_allocated = np.zeros((J, R), np.float32)
    arr.drf_total = np.zeros(R, np.float32)
    arr.job_drf_prerank = np.zeros(J, np.int32)
    idle = np.zeros((N, R), np.float32)
    per_node_cpu = max(3.0 * np.sum(arr.task_init_req[:, 0]) / N, 8000.0)
    idle[:, 0] = np.float32(per_node_cpu)
    idle[:, 1] = np.float32(256.0 * (1 << 30))
    arr.node_idle = idle
    arr.node_extra_future = np.zeros((N, R), np.float32)
    arr.node_used = np.zeros((N, R), np.float32)
    arr.node_alloc = idle.copy()
    arr.node_npods = np.zeros(N, np.int32)
    arr.node_max_pods = np.full(N, 1 << 20, np.int32)
    arr.node_valid = np.ones(N, bool)
    arr.sig_masks = np.ones((1, N), bool)
    arr.queue_weight = np.arange(1, n_queues + 1, dtype=np.float32)
    arr.queue_capability = np.full((n_queues, R), np.inf, np.float32)
    arr.queue_allocated = np.zeros((n_queues, R), np.float32)
    qreq = np.zeros((n_queues, R), np.float64)
    for j in range(J):
        lo, hi = j * tasks_per_job, min((j + 1) * tasks_per_job, T)
        qreq[arr.job_queue[j]] += arr.task_init_req[lo:hi].sum(axis=0)
    arr.queue_request = qreq.astype(np.float32)
    arr.thresholds = np.array([10.0, 1.0], np.float32)
    arr.scalar_dim_mask = np.zeros(R, bool)
    return arr


def decision_digest(*arrays) -> str:
    import hashlib
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(np.asarray(a)).tobytes())
    return h.hexdigest()[:16]


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def sharded_scale(dev, mesh, sc) -> dict:
    """Part (b): bench.py sharded_scale()'s problem, one solve through the
    sharded arena over ``mesh`` and one through the packed arena, with the
    bench's flags (pack, binpack, queue caps): decision digests equal;
    then a zero-dirty session of the sharded arena. Host ms (synchronised)
    and device ms (profiler) per solve."""
    from volcano_tpu_torch.ops import fused_choice as fc
    from volcano_tpu_torch.ops.device_cache import (
        PackedDeviceCache, ShardedDeviceCache,
    )
    from volcano_tpu_torch.ops.solver import solve_allocate_packed2d
    from volcano_tpu_torch.parallel import solve_allocate_sharded_arena

    t0 = time.perf_counter()
    arr = synth_snapshot(sc["scale_tasks"], sc["scale_nodes"])
    fbuf, ibuf, layout = arr.packed()
    build_s = time.perf_counter() - t0
    params = {"binpack_weight": np.float32(1.0),
              "binpack_res_weights": np.ones(arr.R, np.float32),
              "least_req_weight": np.float32(0.0),
              "most_req_weight": np.float32(0.0),
              "balanced_weight": np.float32(0.0),
              "node_static": np.zeros(arr.N, np.float32)}
    kw = dict(herd_mode="pack", score_families=("binpack",),
              use_queue_cap=True)
    sdc = ShardedDeviceCache(mesh)
    (bufs, sp), upload_ms = _timed(
        lambda: (sdc.update(fbuf, ibuf, layout), sdc.params_device(params)))
    full_bytes = list(sdc.last_shard_bytes)
    fc.fused_choice.launches = 0
    r_sh, sh_ms = _timed(lambda: solve_allocate_sharded_arena(
        *bufs, sp, mesh, **kw))
    sh_launches = fc.fused_choice.launches
    dc = PackedDeviceCache(device=dev)
    f2d, i2d = dc.update(fbuf, ibuf, layout)
    pp = dc.params_device(params)
    fc.fused_choice.launches = 0
    r_pk, pk_ms = _timed(lambda: solve_allocate_packed2d(
        f2d, i2d, layout, pp, **kw))
    pk_launches = fc.fused_choice.launches
    T = arr.T
    a_sh, k_sh = r_sh.assigned[:T].cpu().numpy(), r_sh.kind[:T].cpu().numpy()
    a_pk, k_pk = r_pk.assigned[:T].cpu().numpy(), r_pk.kind[:T].cpu().numpy()
    d_sh, d_pk = decision_digest(a_sh, k_sh), decision_digest(a_pk, k_pk)
    if d_sh != d_pk:
        raise AssertionError(
            f"sharded_scale: digest {d_sh} (sharded) != {d_pk} (packed): "
            f"{int((a_sh != a_pk).sum())} assignments and "
            f"{int((k_sh != k_pk).sum())} kinds differ, placed "
            f"{int((a_sh >= 0).sum())} / {int((a_pk >= 0).sum())}, rounds "
            f"{int(r_sh.rounds)} / {int(r_pk.rounds)}")
    placed = int((a_sh >= 0).sum())
    if placed <= 0:
        raise AssertionError("sharded_scale: nothing placed")
    bufs2 = sdc.update(fbuf, ibuf, layout)
    zero = list(sdc.last_shard_bytes)
    if zero != [0] * mesh.size or sdc.last_shipped_bytes:
        raise AssertionError(f"sharded_scale: zero-dirty session shipped "
                             f"{zero}")
    sh_dev = trace_profile(lambda: solve_allocate_sharded_arena(
        *bufs2, sp, mesh, **kw))["device_ms"]
    pk_dev = trace_profile(lambda: solve_allocate_packed2d(
        f2d, i2d, layout, pp, **kw))["device_ms"]
    out = {"phase": "sharded", "part": "scale", "shards": mesh.size,
           "distinct_devices": len(mesh.distinct), "T": T, "N": arr.N,
           "shard_shape": [T, arr.N // mesh.size, arr.R],
           "build_s": build_s, "upload_ms": upload_ms,
           "full_ship_shard_bytes": full_bytes,
           "sharded_host_ms": sh_ms, "sharded_device_ms": sh_dev,
           "sharded_rounds": int(r_sh.rounds), "sharded_launches":
           sh_launches, "packed_host_ms": pk_ms, "packed_device_ms": pk_dev,
           "packed_rounds": int(r_pk.rounds), "packed_launches": pk_launches,
           "placed": placed, "digest": d_sh, "digest_identical": True,
           "zero_dirty_shard_bytes": zero}
    emit(out)
    return out


def preempt_inputs(dev):
    """The evict phase's preempt (BASELINE config #4: 2000 running
    low-priority pods on 200 nodes, a high-priority gang of 1000): one
    cycle under EvictAudit, returning the uniform solve's inputs."""
    sc = EVICT
    n = sc["n_nodes"]
    c = EvictCluster(dev, n, sc["cpu"], sc["mem"], [("q0", None)])
    c.job("low", "q0", "low-priority", 1, sc["low_pods"], 1, 2,
          nodes=[f"n{i % n}" for i in range(sc["low_pods"])])
    c.job("high", "q0", "high-priority", sc["gang"], sc["gang"], 2, 4)
    with EvictAudit() as audit:
        c.cycle()
    for name, arrays, victims, params, kw, _, _ in audit.calls:
        if name == "solve_evict_uniform":
            return arrays, victims, params, kw
    raise AssertionError("the preempt cycle made no uniform eviction solve")


def sharded_evict(dev, mesh) -> dict:
    """Part (c): the preempt solve through solve_evict_uniform_sharded over
    ``mesh``, against the D=1 solve_evict_uniform on the same arrays."""
    from volcano_tpu_torch.ops.evict import solve_evict_uniform
    from volcano_tpu_torch.parallel import solve_evict_uniform_sharded

    arrays, victims, params, kw = preempt_inputs(dev)
    flags = {k: v for k, v in kw.items() if k != "device"}
    one, one_ms = _timed(lambda: solve_evict_uniform(
        arrays, victims, params, device=dev, **flags))
    res, sh_ms = _timed(lambda: solve_evict_uniform_sharded(
        arrays, victims, params, mesh, **flags))
    for k in ("assigned", "evicted_by", "job_placed"):
        if not torch.equal(getattr(res, k), getattr(one, k)):
            raise AssertionError(f"sharded evict: {k} differs from the D=1 "
                                 f"solve")
    out = {"phase": "sharded", "part": "evict", "shards": mesh.size,
           "distinct_devices": len(mesh.distinct),
           "T": int(arrays["task_init_req"].shape[0]),
           "N": int(arrays["node_idle"].shape[0]),
           "J": int(arrays["job_min"].shape[0]),
           "V": int(victims["v_req"].shape[0]),
           "placed": int((res.assigned >= 0).sum().item()),
           "evicted": int((res.evicted_by >= 0).sum().item()),
           "sharded_host_ms": sh_ms, "d1_host_ms": one_ms,
           "equal_to_d1": True}
    if not out["placed"] or not out["evicted"]:
        raise AssertionError(f"sharded evict: {out}")
    emit(out)
    return out


def phase_sharded(dev, scale=None) -> dict:
    """The node-axis sharded solver on a mesh of ``shards`` virtual shards
    of the card: (a) the cycle, (b) the 100k x 10k solve, (c) the
    eviction solve, (d) an hdrf burst, and the kernel at the shard
    shape."""
    from volcano_tpu_torch.parallel import arena_mesh, make_mesh

    sc = dict(SHARDED, **(scale or {}))
    mesh = make_mesh([dev] * sc["shards"])
    cyc = sharded_cycles(dev, mesh, sc)
    out = {"cycles": cyc}
    if torch.cuda.device_count() >= 2:
        out["cycles_multi"] = sharded_cycles(dev, arena_mesh(), sc,
                                             twin=cyc["binds"])
    t0 = time.perf_counter()
    out["scale"] = sharded_scale(dev, mesh, sc)
    out["scale"]["seconds"] = time.perf_counter() - t0
    out["evict"] = sharded_evict(dev, mesh)
    out["hdrf"] = sharded_hdrf(dev, mesh, sc)
    T, N, R, fam = SHARD_KERNEL
    out["kernel"] = kernel_row(kernel_inputs(400, T, N, R, dev), fam,
                               "the sharded burst's shard shape")
    return out


#: the reschedule phase: the cycle cell's 2000 nodes of 32 cpu / 128Gi
#: holding 1400 running gangs of 10 pods of 4 cpu / 8Gi, pod p of the 14000
#: on node p % 2000 and in gang p % 1400 (7 pods of 7 different gangs a
#: node, 4 cpu free on every node), and one pending 16-cpu / 16Gi pod that
#: fits nowhere. The knobs are bench.py reschedule_defrag()'s, with
#: minImprovement 0.001: one hole in 2000 nodes moves the stranded
#: fraction by only 16 / 8000 = 0.002. ``expect`` is the JAX package's
#: plan record on this layout (the proposed count may differ where
#: equal-score targets tie); ``small`` the layout the card-vs-host check
#: cuts it to.
RESCHED = dict(n_nodes=2000, n_gangs=1400, gang=10, max_moves=8,
               max_disruption=2, min_improvement=0.001,
               expect=dict(hole_node="n00000", selected=3, executed=3,
                           max_disruption=1, frag_before=1.0,
                           frag_after=0.998, largest_after=16000.0),
               proposed_reference=13996,
               small=dict(n_nodes=60, n_gangs=42, min_improvement=0.01))

RESCHED_CONF = """
actions: "reschedule"
tiers:
- plugins:
  - name: priority
  - name: gang
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: binpack
  - name: nodeorder
configurations:
- name: reschedule
  arguments:
    reschedule.interval: 1
    reschedule.maxMoves: {moves}
    reschedule.maxDisruptionPerJob: {cap}
    reschedule.minImprovement: {imp}
"""


def defrag_store(store, models, ann_key, n_nodes: int, n_gangs: int,
                 gang: int = 10) -> None:
    """Fill ``store`` (built from ``models``, either package's) with the
    fragmented layout of RESCHED: nodes ``n00000``... of 32 cpu / 128Gi,
    ``n_gangs`` running gangs of ``gang`` pods of 4 cpu / 8Gi (pod p on
    node p % n_nodes, in gang p % n_gangs) and one pending 16-cpu / 16Gi
    pod in namespace ``defrag``."""
    m = models
    store.apply("queues", m.Queue(name="q0", spec=m.QueueSpec(weight=1)))
    rl = {"cpu": "32", "memory": "128Gi", "pods": "110"}
    for i in range(n_nodes):
        store.create("nodes", m.Node(name=f"n{i:05d}", allocatable=rl,
                                     capacity=dict(rl)))

    def group(name, size, phase):
        store.create("podgroups", m.PodGroup(
            name=name, namespace="defrag",
            spec=m.PodGroupSpec(min_member=size, queue="q0"),
            status=m.PodGroupStatus(phase=phase)))

    for g in range(n_gangs):
        group(f"g{g:04d}", gang, m.PodGroupPhase.RUNNING)
    for p in range(n_gangs * gang):
        g = p % n_gangs
        store.create("pods", m.Pod(
            name=f"g{g:04d}-{p // n_gangs}", namespace="defrag",
            node_name=f"n{p % n_nodes:05d}", phase="Running",
            annotations={ann_key: f"g{g:04d}"},
            containers=[{"requests": {"cpu": "4", "memory": "8Gi"}}]))
    group("big", 1, m.PodGroupPhase.INQUEUE)
    store.create("pods", m.Pod(
        name="big-0", namespace="defrag", phase="Pending",
        annotations={ann_key: "big"},
        containers=[{"requests": {"cpu": "16", "memory": "16Gi"}}]))


def defrag_scheduler(dev, sc):
    """The port's Scheduler under RESCHED_CONF over a fresh defrag_store:
    (store, cache, scheduler). Evictions go through the cache's own
    evictor, so they land in the store (deletion stamp + condition)."""
    from volcano_tpu_torch import models
    from volcano_tpu_torch.api import POD_GROUP_ANNOTATION
    from volcano_tpu_torch.cache import SchedulerCache
    from volcano_tpu_torch.client import ClusterStore
    from volcano_tpu_torch.scheduler import Scheduler

    store = ClusterStore()
    defrag_store(store, models, POD_GROUP_ANNOTATION, sc["n_nodes"],
                 sc["n_gangs"], sc.get("gang", 10))
    cache = SchedulerCache(store, device=dev)
    cache.run()
    sched = Scheduler(cache, scheduler_conf=RESCHED_CONF.format(
        moves=sc["max_moves"], cap=sc["max_disruption"],
        imp=sc["min_improvement"]))
    return store, cache, sched


def evicted_pods(store) -> list:
    """(name, node, eviction message) of every pod with a deletion stamp,
    sorted."""
    out = []
    for p in store.list("pods", namespace="defrag"):
        if p.deletion_timestamp is None:
            continue
        msgs = [c.get("message", "") for c in p.conditions
                if c.get("reason") == "Evict"]
        out.append((p.name, p.node_name, msgs[-1] if msgs else ""))
    return sorted(out)


def reschedule_pass(sched, cache, require_plan: bool = True) -> dict:
    """One Scheduler.run_once with the kernel's count set to 0 just before
    and read just after: the pass's timing keys, plan record, launches,
    solve rounds and arena bytes. A failed solve fails the phase, and so
    do a skipped pass and a rejected plan under ``require_plan``."""
    from volcano_tpu_torch.ops import fused_choice as fc
    n_log = len(cache.reschedule_log)
    fc.fused_choice.launches = 0
    t0 = time.perf_counter()
    sched.run_once()
    ms = (time.perf_counter() - t0) * 1e3
    launches = fc.fused_choice.launches
    t = sched.last_cycle_timing
    solved = len(cache.reschedule_log) == n_log + 1
    rec = cache.reschedule_log[-1] if solved else None
    skipped = t.get("reschedule_skipped")
    if skipped == "solve_failed" or t.get("reschedule_error") or (
            require_plan and (skipped or rec is None
                              or rec["rejected"] is not None)):
        raise AssertionError(f"the reschedule pass executed no plan: "
                             f"skipped {skipped!r}, error "
                             f"{t.get('reschedule_error')!r}, plan {rec}")
    dc = cache.reschedule_state.device_cache
    return {"cycle_ms": ms, "launches": launches, "solved": solved,
            "rounds": cache.reschedule_state.rounds if solved else None,
            "arena_bytes_shipped": dc.last_shipped_bytes if solved else None,
            "arena_full_ship": dc.last_full_ship if solved else None,
            "arena_device": str(dc.device) if dc is not None else None,
            **{k: v for k, v in t.items() if k.startswith("reschedule_")},
            "record": rec}


def check_plan(rec, evicted, sc, what: str) -> None:
    """Budget, per-job cap, fragmentation down, and every evicted pod
    carries MIGRATION_REASON."""
    from volcano_tpu_torch.reschedule import MIGRATION_REASON
    if not (rec["selected"] <= sc["max_moves"]
            and rec["max_disruption"] <= sc["max_disruption"]
            and rec["frag_after"] < rec["frag_before"]
            and rec["executed"] == rec["selected"] == len(evicted)):
        raise AssertionError(f"{what}: plan out of bounds: {rec}, "
                             f"{len(evicted)} evicted")
    if not all(msg.startswith(MIGRATION_REASON) for *_, msg in evicted):
        raise AssertionError(f"{what}: an eviction lacks the migration "
                             f"reason: {evicted}")


def phase_reschedule(dev, scale=None) -> dict:
    """The global rescheduler's defragmentation pass at the cycle cell's
    cluster size (RESCHED): one pass with every fused_choice launch of
    its defrag solve held against the plain version, its plan held to
    the JAX package's record, a second pass, then the small layout
    through the same pass on the card and on the host (the same evicted
    pods and plan record), and the kernel timed at the defrag shape."""
    sc = dict(RESCHED, **(scale or {}))
    t0 = time.perf_counter()
    store, cache, sched = defrag_scheduler(dev, sc)
    build_s = time.perf_counter() - t0
    with KernelAudit() as audit:
        first = reschedule_pass(sched, cache)
    evicted = evicted_pods(store)
    rec = first["record"]
    check_plan(rec, evicted, sc, "first pass")
    if first["launches"] <= 0 or len(audit.shapes) != first["launches"]:
        raise AssertionError(f"the defrag solve launched "
                             f"{first['launches']} kernels, "
                             f"{len(audit.shapes)} audited")
    if first["arena_device"] != str(dev):
        raise AssertionError(f"the action's arena is on "
                             f"{first['arena_device']}, not {dev}")
    expect = sc.get("expect") or {}
    off = {k: (rec[k], v) for k, v in expect.items() if rec[k] != v}
    if off:
        raise AssertionError(f"the plan differs from the JAX package's "
                             f"record (got, want): {off}")
    if any(node != rec["hole_node"] for _, node, _ in evicted):
        raise AssertionError(f"a move left another node than the hole: "
                             f"{evicted}")
    emit({"phase": "reschedule", "pass": 1, "nodes": sc["n_nodes"],
          "running_pods": sc["n_gangs"] * sc.get("gang", 10),
          "build_s": build_s, "audit": audit.summary(), "equal": True,
          "evicted": [e[0] for e in evicted],
          "proposed_reference": sc.get("proposed_reference"),
          "matches_reference": bool(expect), **first})
    # the second pass runs against the first one's evictions (still
    # terminating): it may find another plan or reject one, but its solve
    # must not fail; it shows the arena's bytes on a pass that reuses it
    second = reschedule_pass(sched, cache, require_plan=False)
    rec2 = second["record"]
    if rec2 is not None and rec2["rejected"] is None:
        check_plan(rec2, [e for e in evicted_pods(store)
                          if e not in evicted], sc, "second pass")
    emit({"phase": "reschedule", "pass": 2, **second})
    out = {"first": first, "second": second}
    small = sc.get("small")
    if small:
        pair = {}
        for where in (dev, "cpu"):
            s2 = dict(sc, **small)
            st, ca, sch = defrag_scheduler(where, s2)
            row = reschedule_pass(sch, ca)
            check_plan(row["record"], evicted_pods(st), s2, f"small {where}")
            rec2 = dict(row["record"], solve_ms=None)
            pair[str(where)] = (evicted_pods(st), rec2)
        card, host = pair[str(dev)], pair["cpu"]
        if card != host:
            raise AssertionError(f"the small layout's pass differs card vs "
                                 f"host: {card} != {host}")
        emit({"phase": "reschedule_small", "nodes": small["n_nodes"],
              "evicted": [e[0] for e in card[0]], "record": card[1],
              "identical_to_host": True})
    T, N, R, fam, _ = audit.shapes[0]
    out["kernel"] = kernel_row(kernel_inputs(500, T, N, R, dev), fam,
                               "the defrag solve's shape")
    return out


# -- the device path's outer ring: prewarm, the sidecar, failover -----------

#: the prewarm phase: the cycle cell's cluster, waves of ``gangs`` gangs
#: whose pods per gang follow ``sizes``, each wave completing before the
#: next arrives: the pending task count T walks the buckets 112 -> 128 ->
#: 160 -> 192 with N fixed, each size twice (the second cycle at a bucket
#: is the warm one)
PREWARM = dict(n_nodes=2000, gangs=10,
               sizes=(10, 10, 10, 12, 12, 13, 13, 17, 17))
PREWARM_SMALL = dict(PREWARM, n_nodes=50)


def _binds_digest(pairs) -> str:
    import hashlib
    return hashlib.sha256(json.dumps(sorted(pairs)).encode()).hexdigest()[:16]


def prewarm_arm(dev, prewarm: bool, sc) -> dict:
    """One arm of the prewarm phase, in this process: the Scheduler with
    ``prewarm`` on or off (the compile watcher installed either way), one
    cycle a wave. After each cycle the arm waits for the prewarmer's
    outstanding warm (the schedule period's idle time in a deployment)
    and records how long that took. Returns the cycle rows, each with
    the digest of its binds."""
    from volcano_tpu_torch.ops import fused_choice as fc
    from volcano_tpu_torch.ops import precompile
    from volcano_tpu_torch.ops.arrays import bucket
    from volcano_tpu_torch.scheduler import Scheduler
    precompile.watcher.install()
    c = StoreCluster(dev, sc["n_nodes"], 0)
    c.sched = Scheduler(c.cache, prewarm=prewarm)
    pw = c.cache.prewarmer
    fc.fused_choice.launches_prewarm = 0
    rows, prev = [], []
    for i, size in enumerate(sc["sizes"]):
        for g in prev:
            c.complete(g)
        c.tpj = size
        prev = c.submit(sc["gangs"])
        row = c.run_cycle()
        c.check(f"prewarm wave {i}", gangs=prev)
        if row["binds"] != sc["gangs"] * size or row["launches"] <= 0:
            raise AssertionError(f"prewarm wave {i}: {row}")
        keys = {k for g in prev for k in c.gangs[g]}
        row.update(wave=i, T=bucket(sc["gangs"] * size),
                   binds_digest=_binds_digest(
                       [(k, v) for k, v in c.cache.binder.binds.items()
                        if k in keys]))
        if pw is not None:
            t0 = time.perf_counter()
            if not pw.wait(60):
                raise AssertionError("the prewarm did not finish in 60 s")
            row["warm_wait_ms"] = (time.perf_counter() - t0) * 1e3
        rows.append(row)
    return {"prewarm": prewarm, "rows": rows,
            "completions": pw.completions if pw else 0,
            "failures": pw.failures if pw else 0,
            "launches_prewarm": fc.fused_choice.launches_prewarm}


def phase_prewarm(dev, scale=None) -> dict:
    """The bucket prewarmer at the cycle cell's scale: each arm in its own
    process (a process's first-use costs are process-wide), prewarm off
    then on, through the same waves. The binds must be identical cycle for
    cycle; with prewarm on the warm must complete without a failure and
    every first cycle past a bucket crossing must make no compile on the
    session thread. Per crossing: the first cycle at the new bucket beside
    the next (warm) cycle at the same bucket, in both arms."""
    sc = dict(PREWARM, **(scale or {}))
    arms = {}
    for name in ("off", "on"):
        proc = subprocess.run(
            [sys.executable, __file__, "--prewarm-arm", name],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"prewarm arm {name} failed:\n"
                                 f"{proc.stderr[-3000:]}")
        arms[name] = json.loads(proc.stdout.strip().splitlines()[-1])
    off, on = arms["off"]["rows"], arms["on"]["rows"]
    if [r["binds_digest"] for r in off] != [r["binds_digest"] for r in on]:
        raise AssertionError("prewarm on and off bound differently")
    if arms["on"]["failures"] or arms["on"]["completions"] < 1:
        raise AssertionError(f"prewarm: {arms['on']['completions']} "
                             f"completions, {arms['on']['failures']} "
                             f"failures")
    keys = ("cycle_ms", "dispatch_ms", "session_compiles",
            "session_compile_s")
    crossings = []
    for i in range(1, len(on)):
        if on[i]["T"] == on[i - 1]["T"]:
            continue
        if on[i]["session_compiles"]:
            raise AssertionError(f"prewarm on: the first cycle at T="
                                 f"{on[i]['T']} compiled on the session "
                                 f"thread ({on[i]['session_compiles']})")
        warm = i + 1 if i + 1 < len(on) and on[i + 1]["T"] == on[i]["T"] \
            else None
        row = {"phase": "prewarm", "crossing": f"T {on[i - 1]['T']} -> "
               f"{on[i]['T']}", "wave": i}
        for arm, rows in (("off", off), ("on", on)):
            row[arm] = {"first": {k: rows[i].get(k) for k in keys}}
            if warm is not None:
                row[arm]["warm"] = {k: rows[warm].get(k) for k in keys}
        row["warm_wait_ms_before"] = on[i - 1].get("warm_wait_ms")
        crossings.append(row)
        emit(row)
    if len(crossings) < 2:
        raise AssertionError(f"only {len(crossings)} bucket crossings")
    # the cold cost a new bucket adds past the process's first solve, in
    # the arm without prewarm: the first cycle's dispatch over the warm one
    cold = [r["off"]["first"]["dispatch_ms"] - r["off"]["warm"]["dispatch_ms"]
            for r in crossings if "warm" in r["off"]]
    out = {"phase": "prewarm", "nodes": sc["n_nodes"],
           "wave_gangs": sc["gangs"], "sizes": list(sc["sizes"]),
           "crossings": len(crossings), "binds_identical": True,
           "completions": arms["on"]["completions"],
           "failures": arms["on"]["failures"],
           "session_compiles_after_crossing_on": 0,
           "session_compiles_after_crossing_off": [
               r["off"]["first"]["session_compiles"] for r in crossings],
           "cold_dispatch_ms_off": cold,
           "cold_cost_seen": any(ms > 1.0 for ms in cold),
           "warm_wait_ms": [r.get("warm_wait_ms") for r in on],
           "launches": sum(r["launches"] for r in on),
           "launches_off": sum(r["launches"] for r in off),
           "launches_prewarm_background": arms["on"]["launches_prewarm"],
           "first_cycle_session_compiles": [off[0]["session_compiles"],
                                            on[0]["session_compiles"]]}
    if not out["cold_cost_seen"]:
        out["finding"] = ("no cold cost at a new bucket past the process's "
                          "first solve: every first post-crossing dispatch "
                          "is within 1 ms of the warm one")
    if out["launches"] != out["launches_off"]:
        raise AssertionError("the prewarm's launches mixed into the cycles' "
                             "counts")
    emit(out)
    return out


SIDECAR = dict(n_nodes=CYCLE["n_nodes"], n_jobs=CYCLE["n_jobs"],
               tasks_per_job=10, wave_jobs=10, waves=12)


def start_sidecar(sock: str, faults: str = "") -> subprocess.Popen:
    """``python -m volcano_tpu_torch.parallel.sidecar SOCK`` from the
    repository root, with ``faults`` as its VOLCANO_FAULTS."""
    env = dict(os.environ)
    env.pop("VOLCANO_FAULTS", None)
    if faults:
        env["VOLCANO_FAULTS"] = faults
    return subprocess.Popen(
        [sys.executable, "-m", "volcano_tpu_torch.parallel.sidecar", sock],
        cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def connect_sidecar(proc, sock: str, timeout: float = 180.0):
    from volcano_tpu_torch.parallel import SidecarSolver
    deadline = time.time() + timeout
    while True:
        if proc.poll() is not None:
            raise AssertionError(f"the sidecar exited {proc.returncode}:\n"
                                 f"{proc.stdout.read()[-3000:]}")
        client = SidecarSolver(sock)
        try:
            client._connect()
            return client
        except OSError:
            if time.time() > deadline:
                raise
            time.sleep(0.1)


def stop_sidecar(proc, client) -> None:
    try:
        client.shutdown_server()
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def _sidecar_row(label, row, twin) -> dict:
    if row["binds"] != twin["binds"]:
        raise AssertionError(f"sidecar {label}: {row['binds']} binds, "
                             f"{twin['binds']} in process")
    out = {"phase": "sidecar", "cycle": label, "cycle_ms": row["cycle_ms"],
           "binds": row["binds"], "twin_cycle_ms": twin["cycle_ms"],
           "twin_launches": twin["launches"]}
    for k in SIDECAR_KEYS + ("dispatch_ms",):
        out[k] = row.get(k)
    return out


def phase_sidecar(dev, scale=None) -> dict:
    """The solver sidecar: ``python -m volcano_tpu_torch.parallel.sidecar``
    owns the card in its own process; this process's control plane runs
    on a CPU cache with ``cache.sidecar`` set. The cycle phase's burst and
    12 steady waves, an unchanged snapshot sent twice, and the evict
    phase's preempt go through it, each held bind for bind (eviction for
    eviction) against the same seeded cluster run in process on the card.
    A second server, armed to fail its first solve, must make the
    client's cycle report allocate_error and bind nothing on the host."""
    sc = dict(SIDECAR, **(scale or {}))
    n, j, tpj, w = (sc["n_nodes"], sc["n_jobs"], sc["tasks_per_job"],
                    sc["wave_jobs"])
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    # socket paths stay short (a unix socket path is capped near 108
    # bytes): the servers run from the checkout's root and take the path
    # relative to it; this process takes it relative to its own cwd
    socks = [os.path.join("build", f"sidecar-{os.getpid()}-{k}.sock")
             for k in ("ok", "fail")]
    t0 = time.perf_counter()
    procs = [start_sidecar(socks[0]),
             start_sidecar(socks[1], "sidecar_solve=at:1")]
    clients = []
    try:
        rig = StoreCluster("cpu", n, j, tpj)
        twin = StoreCluster(dev, n, j, tpj)
        clients = [connect_sidecar(p, os.path.relpath(os.path.join(REPO, s)))
                   for p, s in zip(procs, socks)]
        start_s = time.perf_counter() - t0
        client = rig.cache.sidecar = clients[0]
        rows = []

        def both(label, gangs=None):
            row, tw = rig.run_cycle(), twin.run_cycle()
            rig.check(f"sidecar {label}", gangs=gangs)
            if rig.cache.binder.binds != twin.cache.binder.binds:
                raise AssertionError(f"sidecar {label}: binds differ from "
                                     f"the in-process run on the card")
            rows.append(_sidecar_row(label, row, tw))
            emit(rows[-1])
            return row

        burst = both("burst", gangs=list(rig.gangs))
        if not client.on_card:
            raise AssertionError(f"the sidecar solves on {client.device}, "
                                 f"not a CUDA device")
        for i in range(sc["waves"]):
            gangs = rig.submit(w)
            twin.submit(w)
            both(f"wave {i}", gangs=gangs)
        # a gang that fits no node stays pending: the second request of
        # the unchanged snapshot ships 0 chunks
        rig.submit(1, cpu_per_pod=33)
        twin.submit(1, cpu_per_pod=33)
        both("stuck gang")
        quiet = both("unchanged snapshot")
        if quiet["sidecar_shipped_chunks"] != 0:
            raise AssertionError(f"an unchanged snapshot shipped "
                                 f"{quiet['sidecar_shipped_chunks']} chunks")
        if any(not r["sidecar_launches"] for r in rows):
            raise AssertionError("a sidecar cycle launched no kernel on "
                                 "the server")
        evict = sidecar_preempt(dev, client)
        emit(evict)
        failed = sidecar_failure(clients[1])
        emit(failed)
    finally:
        for p, cl in zip(procs, clients + [None] * 2):
            if cl is not None:
                stop_sidecar(p, cl)
            elif p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        for sock in socks:
            try:
                os.unlink(os.path.join(REPO, sock))
            except OSError:
                pass
    steady = rows[1:1 + sc["waves"]]
    out = {"phase": "sidecar", "device": client.device,
           "server_start_s": start_s,
           "burst": rows[0], "steady": {
               k: cycle_stats(steady, k) for k in (
                   "cycle_ms", "twin_cycle_ms", "sidecar_rtt_ms",
                   "sidecar_request_bytes", "sidecar_shipped_chunks",
                   "sidecar_rounds")},
           "unchanged_snapshot_chunks": quiet["sidecar_shipped_chunks"],
           "binds_identical": True, "launches": sum(
               r["sidecar_launches"] for r in rows),
           "evict": {k: evict[k] for k in ("evictions", "pipelines")},
           "failure": failed}
    emit(out)
    return out


def sidecar_preempt(dev, client) -> dict:
    """The evict phase's preempt through the sidecar (a CPU control plane)
    and in process on the card: the same evictions and pipelines."""
    sc = EVICT
    n = sc["n_nodes"]
    out = {}
    for where in ("sidecar", "card"):
        c = EvictCluster("cpu" if where == "sidecar" else dev, n, sc["cpu"],
                         sc["mem"], [("q0", None)])
        if where == "sidecar":
            c.cache.sidecar = client
        c.job("low", "q0", "low-priority", 1, sc["low_pods"], 1, 2,
              nodes=[f"n{i % n}" for i in range(sc["low_pods"])])
        c.job("high", "q0", "high-priority", sc["gang"], sc["gang"], 2, 4)
        row = c.cycle()
        c.check(f"sidecar preempt ({where})", row, True)
        out[where] = row
    a, b = out["sidecar"], out["card"]
    if (a["evicts"], a["pipelined"]) != (b["evicts"], b["pipelined"]) \
            or not a["evicts"]:
        raise AssertionError("the preempt through the sidecar differs from "
                             "the one in process on the card")
    return {"phase": "sidecar", "part": "preempt",
            "evictions": len(a["evicts"]), "pipelines": len(a["pipelined"]),
            "cycle_ms": a["cycle_ms"], "twin_cycle_ms": b["cycle_ms"],
            "preempt_solve_ms": a["timing"].get("preempt_solve_ms"),
            "twin_preempt_solve_ms": b["timing"].get("preempt_solve_ms"),
            "identical": True}


def sidecar_failure(client) -> dict:
    """A cycle against a server armed to fail its solve: the client must
    report allocate_error and bind nothing through the host."""
    c = StoreCluster("cpu", 20, 4)
    c.cache.sidecar = client
    row = c.run_cycle()
    t = c.sched.last_cycle_timing
    if not t.get("allocate_error") or t.get("host_fallback") \
            or c.cache.binder.binds or not client.on_card:
        raise AssertionError(f"a failed sidecar solve on {client.device} "
                             f"was absorbed: {row}")
    return {"phase": "sidecar", "part": "server_failure",
            "device": client.device, "allocate_error": True, "binds": 0,
            "host_fallback": False}


FAILOVER = dict(n_nodes=CYCLE["n_nodes"], n_jobs=CYCLE["n_jobs"],
                tasks_per_job=10, wave_jobs=10, waves_before_crash=3)


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def _store_binds(store) -> dict:
    return {f"{p.namespace}/{p.name}": p.node_name
            for p in store.list("pods") if p.node_name}


def failover_golden(dev, sc) -> dict:
    """The uninterrupted run: the burst, the waves before the crash, the
    crashed wave and the wave after takeover, one leader, one cycle
    each."""
    g = StoreCluster(dev, sc["n_nodes"], sc["n_jobs"], sc["tasks_per_job"])
    g.sched.run_once()
    for _ in range(sc["waves_before_crash"] + 2):
        g.submit(sc["wave_jobs"])
        g.sched.run_once()
    return dict(g.cache.binder.binds)


def phase_failover(dev, scale=None) -> dict:
    """Leader-elected failover with a warm standby, in one process over
    one store at the cycle cell's scale. A leads (fenced writes, the bind
    journal) through the burst and steady waves while B, a standby cache
    on the card, runs shadow_cycle() before each of A's cycles. A crashes
    at the bind_commit of a wave's replay (journaled, not dispatched); the
    elector's clock passes the lease, B takes over, reconciles, and runs
    its first cycle on the next wave, beside C, a cold standby (no
    shadows, fake effectors) deciding the same wave. Checks: every pod
    bound once (a store interceptor), the binds equal the uninterrupted
    run's, no intent left, A's late write fenced, gangs whole and no node
    over its allocatable, the shadows wrote nothing and B's arena equals
    its mirror, B's first cycle ships a delta, flattens warm and launches
    the kernel (every launch held against the plain version)."""
    from volcano_tpu_torch.cache import (
        FakeBinder, FakeEvictor, FakeStatusUpdater, FakeVolumeBinder,
        SchedulerCache,
    )
    from volcano_tpu_torch.cache.cache import DefaultBinder, DefaultEvictor
    from volcano_tpu_torch.client import FencedError
    from volcano_tpu_torch.ops import fused_choice as fc
    from volcano_tpu_torch.reschedule import reconcile_migration_intents
    from volcano_tpu_torch.resilience import (
        BindIntentJournal, faults, reconcile_bind_intents,
    )
    from volcano_tpu_torch.scheduler import Scheduler
    from volcano_tpu_torch.ops import precompile
    from volcano_tpu_torch.utils import LeaderElector, LeaseLock
    sc = dict(FAILOVER, **(scale or {}))
    w = sc["wave_jobs"]
    precompile.watcher.install()
    golden = failover_golden(dev, sc)
    clock = FakeClock()
    a = StoreCluster(dev, sc["n_nodes"], sc["n_jobs"], sc["tasks_per_job"])
    store = a.store
    store.clock = clock
    a.cache.binder = DefaultBinder(store)
    a.cache.evictor = DefaultEvictor(store)
    bind_writes: dict = {}

    def audit(verb, kind, obj):
        if kind == "pods" and verb == "update" and obj.node_name:
            prev = store.try_get("pods", obj.name, obj.namespace)
            if prev is None or prev is obj or not prev.node_name:
                key = f"{obj.namespace}/{obj.name}"
                bind_writes[key] = bind_writes.get(key, 0) + 1
        return obj

    store.add_interceptor(audit)

    def elector(identity):
        e = LeaderElector(LeaseLock(store, "volcano"), identity=identity,
                          lease_duration=10.0, clock=clock)
        if not e.step():
            raise AssertionError(f"{identity} did not acquire the lease")
        return e

    ea = elector("A")
    a.cache.install_fencing(ea.fencing_token)
    journal_a = BindIntentJournal(a.cache.fenced_cluster, identity="A",
                                  clock=clock)
    a.cache.bind_journal = journal_a
    standby = []
    for _ in range(2):
        cache = SchedulerCache(store, device=dev)
        cache.run()
        standby.append((cache, Scheduler(cache)))
    (cache_b, sched_b), (cache_c, sched_c) = standby
    for eff, fake in (("binder", FakeBinder), ("evictor", FakeEvictor),
                      ("status_updater", FakeStatusUpdater),
                      ("volume_binder", FakeVolumeBinder)):
        setattr(cache_c, eff, fake())
    shadows = []

    def shadow():
        rv = store._rv
        fc.fused_choice.launches = 0
        t0 = time.perf_counter()
        sched_b.shadow_cycle()
        shadows.append({"ms": (time.perf_counter() - t0) * 1e3,
                        "launches": fc.fused_choice.launches})
        if store._rv != rv:
            raise AssertionError("a shadow cycle wrote to the store")

    def lead(what):
        fc.fused_choice.launches = 0
        t0 = time.perf_counter()
        a.sched.run_once()
        ms = (time.perf_counter() - t0) * 1e3
        error = bool(a.sched.last_cycle_timing.get("allocate_error"))
        if not error:
            journal_a.sweep()   # once a cycle, as the HA loop does
        return {"cycle": what, "ms": ms, "launches": fc.fused_choice.launches,
                "error": error}

    leader_rows = []
    shadow()
    leader_rows.append(lead("burst"))
    for i in range(sc["waves_before_crash"]):
        a.submit(w)
        shadow()
        leader_rows.append(lead(f"wave {i}"))
    crash_gangs = a.submit(w)
    shadow()
    faults.arm("bind_commit", at=(1,))
    try:
        leader_rows.append(lead("crashed wave"))
    finally:
        faults.reset()
    crashed = [k for g in crash_gangs for k in a.gangs[g]]
    bound = _store_binds(store)
    if not leader_rows[-1]["error"] or any(k in bound for k in crashed) \
            or not store.list("bindintents"):
        raise AssertionError("A's crash at bind_commit did not leave a "
                             "journaled, undispatched wave")
    if any(r["error"] for r in leader_rows[:-1]):
        raise AssertionError(f"a leader cycle failed: {leader_rows}")
    # A is gone: the clock passes the lease, B takes over and reconciles
    clock.t += 11.0
    t0 = time.perf_counter()
    eb = elector("B")
    cache_b.install_fencing(eb.fencing_token)
    summary = reconcile_bind_intents(store, eb.fencing_token)
    migration = reconcile_migration_intents(store, eb.fencing_token)
    cache_b.bind_journal = journal_b = BindIntentJournal(
        cache_b.fenced_cluster, identity="B", clock=clock)
    takeover_ms = (time.perf_counter() - t0) * 1e3
    if summary["redriven"] != len(crashed) or summary["lost"] \
            or summary["conflicts"]:
        raise AssertionError(f"the takeover reconcile: {summary}")
    victim = store.get("pods", crashed[0].split("/")[1], "bench")
    before = repr(victim)
    try:
        a.cache.fenced_cluster.update("pods", victim)
    except FencedError:
        pass
    else:
        raise AssertionError("the deposed leader's late write landed")
    if repr(store.get("pods", victim.name, "bench")) != before:
        raise AssertionError("the fenced write changed the pod")
    # the next wave: the cold standby's first cycle, then B's
    next_gangs = a.submit(w)
    fc.fused_choice.launches = 0
    t1 = time.perf_counter()
    sched_c.run_once()
    cold = {"ms": (time.perf_counter() - t1) * 1e3,
            "launches": fc.fused_choice.launches,
            **{k: sched_c.last_cycle_timing.get(k) for k in (
                "arena_full_ship", "arena_bytes_shipped", "flatten_mode",
                "dispatch_ms", "session_compiles")}}
    fc.fused_choice.launches = 0
    t1 = time.perf_counter()
    with KernelAudit() as kaudit:
        sched_b.run_once()
    first = {"ms": (time.perf_counter() - t1) * 1e3,
             "launches": fc.fused_choice.launches,
             **{k: sched_b.last_cycle_timing.get(k) for k in (
                 "arena_full_ship", "arena_bytes_shipped", "flatten_mode",
                 "dispatch_ms", "session_compiles", "allocate_error")}}
    journal_b.sweep()
    binds = _store_binds(store)
    next_keys = [k for g in next_gangs for k in a.gangs[g]]
    if {k: binds.get(k) for k in next_keys} != {
            k: cache_c.binder.binds.get(k) for k in next_keys}:
        raise AssertionError("the cold standby decided the wave differently")
    if first["allocate_error"] or first["arena_full_ship"] \
            or first["flatten_mode"] == "cold" or first["launches"] <= 0 \
            or kaudit.summary()["launches_checked"] != first["launches"]:
        raise AssertionError(f"B's first cycle was not warm: {first}")
    dups = {k: n for k, n in bind_writes.items() if n != 1}
    if dups or set(bind_writes) != set(binds):
        raise AssertionError(f"duplicate or unaudited binds: {dups}")
    a.check_placement("failover", binds, gangs=list(a.gangs))
    if binds != golden:
        diff = sorted(k for k in set(binds) | set(golden)
                      if binds.get(k) != golden.get(k))
        raise AssertionError(f"{len(diff)} binds differ from the "
                             f"uninterrupted run: {diff[:5]}")
    if store.list("bindintents"):
        raise AssertionError("bind intents left after the takeover")
    dc = cache_b.device_cache
    for dev_buf, host in ((dc._dev_f, dc._host_f), (dc._dev_i, dc._host_i)):
        if not torch.equal(dev_buf.reshape(-1).cpu(), torch.from_numpy(host)):
            raise AssertionError("B's resident arena drifted from its "
                                 "host mirror")
    out = {"phase": "failover", "nodes": sc["n_nodes"],
           "pods_bound": len(binds), "golden_equal": True,
           "lost": 0, "duplicates": 0, "intents_left": 0,
           "deposed_write_fenced": True, "reconcile": summary,
           "migration_reconcile": migration,
           "takeover_ms": takeover_ms,
           "takeover_to_first_cycle_ms": takeover_ms + first["ms"],
           "leader_cycles": leader_rows, "shadows": shadows,
           "first_cycle": first, "cold_standby_first_cycle": cold,
           "b_arena_matches_mirror": True, "audit": kaudit.summary(),
           "launches": sum(r["launches"] for r in leader_rows)
           + sum(r["launches"] for r in shadows) + first["launches"]
           + cold["launches"]}
    emit(out)
    return out


LIFECYCLE = dict(n_nodes=CYCLE["n_nodes"], n_jobs=CYCLE["n_jobs"],
                 tasks_per_job=10, waves=12, complete=10, fail=2,
                 wave_jobs=10, plugin_every=10, max_rounds=6)
#: the card/host twin: the same script, cut to this size
LIFECYCLE_TWIN = dict(n_nodes=200, n_jobs=100, waves=4)


class LifecycleWorld:
    """A vcjob's whole path through the port, in one process over one
    in-memory store: admission (``start_webhooks``), the
    ControllerManager (the job, queue and podgroup controllers, the
    kubelet stand-in, the garbage collector) and the Scheduler on ``dev``
    with the cache's DefaultBinder (a bound pod goes Running), wrapped to
    record every bind by pod uid. ``n_nodes`` nodes of 32 cpu / 128Gi /
    110 pods, three queues weighted 1:2:3 created through the queue
    admission, the default conf.

    Job k (``submit``) has one task of ``tasks_per_job`` replicas,
    minAvailable = replicas, cpu ``1 + (k // 3) % 3`` and memory
    ``1 + k % 4`` Gi, queue ``k % 3``, job-level PodFailed -> RestartJob
    and TaskCompleted -> CompleteJob, ttlSecondsAfterFinished 0, and the
    svc and env plugins when ``k % plugin_every == 0``. ``expect`` holds
    each job's phase (a str, or None once collected) and retry count
    as the policies and commands imply them."""

    NS = "bench"

    def __init__(self, dev, sc):
        from volcano_tpu_torch.cache import SchedulerCache
        from volcano_tpu_torch.cache.cache import DefaultBinder
        from volcano_tpu_torch.cache.fakes import RecordingBinder
        from volcano_tpu_torch.client import ClusterStore
        from volcano_tpu_torch.controllers import (
            ControllerManager, KubeletStandin,
        )
        from volcano_tpu_torch.models import Node, Queue, QueueSpec
        from volcano_tpu_torch.scheduler import Scheduler
        from volcano_tpu_torch.webhooks import start_webhooks

        self.sc = sc
        self.tpj = sc["tasks_per_job"]
        self.store = ClusterStore()
        start_webhooks(self.store)
        self.cm = ControllerManager(self.store)
        self.cm.run()
        # the kubelet finishes a graceful termination at once, as the
        # reference e2e World's kubelet does
        self.kubelet = next(c for c in self.cm.controllers
                            if isinstance(c, KubeletStandin))
        self.kubelet.grace_seconds = 0.0
        self.cache = SchedulerCache(self.store, device=dev)
        self.on_card = self.cache.device.type == "cuda"
        self.bound: dict = {}     # pod uid -> node
        self.rebound: list = []   # pods bound a second time
        self.cache.binder = RecordingBinder(DefaultBinder(self.store),
                                            on_bind=self._on_bind)
        self.cache.run()
        self.queues = ["q0", "q1", "q2"]
        for i, name in enumerate(self.queues):
            self.store.create("queues", Queue(name=name,
                                              spec=QueueSpec(weight=i + 1)))
        self.alloc = {"cpu": 32.0, "memory": 128 * 2.0 ** 30, "pods": 110}
        rl = {"cpu": "32", "memory": "128Gi", "pods": "110"}
        for i in range(sc["n_nodes"]):
            self.store.create("nodes", Node(name=f"n{i}", allocatable=rl,
                                            capacity=dict(rl)))
        self.sched = Scheduler(self.cache)
        self.k = 0
        self.req: dict = {}     # job name -> (cpu, memory bytes) a pod
        self.expect: dict = {}  # job name -> (phase or None, retry count)
        self.fresh: list = []   # Running jobs no wave has touched yet
        self.aborted = None
        self.cycles: list = []

    def _on_bind(self, pod, hostname) -> None:
        if pod.uid in self.bound:
            self.rebound.append(f"{pod.namespace}/{pod.name}")
        self.bound[pod.uid] = hostname

    def submit(self, n: int) -> list:
        from volcano_tpu_torch.models import (
            Action, Event, Job, JobSpec, LifecyclePolicy, TaskSpec,
        )
        names = []
        for _ in range(n):
            k = self.k
            self.k += 1
            cpu, mem = 1 + (k // 3) % 3, 1 + k % 4
            name = f"vj{k}"
            plugins = ({"svc": [], "env": []}
                       if k % self.sc["plugin_every"] == 0 else {})
            self.store.create("jobs", Job(
                name=name, namespace=self.NS, spec=JobSpec(
                    min_available=self.tpj, queue=self.queues[k % 3],
                    tasks=[TaskSpec(name="worker", replicas=self.tpj,
                                    template={"spec": {"containers": [{
                                        "name": "c", "requests": {
                                            "cpu": str(cpu),
                                            "memory": f"{mem}Gi"}}]}})],
                    policies=[
                        LifecyclePolicy(event=Event.POD_FAILED,
                                        action=Action.RESTART_JOB),
                        LifecyclePolicy(event=Event.TASK_COMPLETED,
                                        action=Action.COMPLETE_JOB)],
                    plugins=plugins, ttl_seconds_after_finished=0)))
            self.req[name] = (float(cpu), mem * 2.0 ** 30)
            self.expect[name] = ("Running", 0)
            names.append(name)
        return names

    def job_pods(self, name: str) -> list:
        return [p for p in self.store.list("pods", namespace=self.NS)
                if p.annotations.get("volcano.sh/job-name") == name]

    def cycle(self) -> dict:
        """One Scheduler.run_once with the kernel's count set to 0 just
        before and read just after."""
        from volcano_tpu_torch.ops import fused_choice as fc
        before = len(self.bound) + len(self.rebound)
        fc.fused_choice.launches = 0
        t0 = time.perf_counter()
        self.sched.run_once()
        ms = (time.perf_counter() - t0) * 1e3
        t = self.sched.last_cycle_timing
        row = {"cycle_ms": ms, "launches": fc.fused_choice.launches,
               "binds": len(self.bound) + len(self.rebound) - before,
               **{k: t[k] for k in ("flatten_mode", "dispatch_ms",
                                    "allocate_error", "host_fallback")
                  if k in t}}
        if row.get("allocate_error") or row.get("host_fallback"):
            raise AssertionError(f"a lifecycle cycle left the device "
                                 f"path: {row}")
        self.cycles.append(row)
        return row

    def reached(self, names=None) -> bool:
        """Every job (of ``names``) in its expected phase and retry count,
        every collected one gone."""
        jobs = {j.name: j for j in self.store.list("jobs",
                                                   namespace=self.NS)}
        for name in (names if names is not None else self.expect):
            phase, retries = self.expect[name]
            j = jobs.get(name)
            if phase is None:
                if j is not None:
                    return False
            elif j is None or j.status.state.phase.value != phase \
                    or j.status.retry_count != retries:
                return False
        return True

    def converge(self, new=()) -> dict:
        """Rounds of controllers, the kubelet, then one cycle, as the
        reference e2e World's converge, until every job is where
        ``expect`` says or ``max_rounds`` cycles have run (then one more
        controllers pass). Per round: the controllers' drain ms and the
        cycle's row; the ms until the jobs ``new`` run."""
        t0 = time.perf_counter()
        rounds, new_ms = [], None
        for r in range(self.sc["max_rounds"] + 1):
            t1 = time.perf_counter()
            self.cm.process_all()
            ctrl_ms = (time.perf_counter() - t1) * 1e3
            if new_ms is None and new and self.reached(new):
                new_ms = (time.perf_counter() - t0) * 1e3
            if self.reached() or r == self.sc["max_rounds"]:
                rounds.append({"controllers_ms": ctrl_ms})
                break
            self.kubelet.process_all()
            rounds.append({"controllers_ms": ctrl_ms, **self.cycle()})
        return {"rounds": len(rounds), "ms": (time.perf_counter() - t0) * 1e3,
                "new_jobs_running_ms": new_ms,
                "controllers_ms": [r["controllers_ms"] for r in rounds],
                "cycle_ms": [r["cycle_ms"] for r in rounds if "cycle_ms" in r],
                "binds": [r["binds"] for r in rounds if "binds" in r],
                "launches": [r["launches"] for r in rounds
                             if "launches" in r]}

    def wave(self) -> dict:
        """The pods of ``complete`` Running jobs succeed (CompleteJob, then
        the collector), one pod of each of ``fail`` others fails
        (RestartJob), last wave's aborted job gets ResumeJob and one more
        gets AbortJob, and ``wave_jobs`` new jobs arrive."""
        from volcano_tpu_torch.models import Action, Command
        sc = self.sc
        done = self.fresh[:sc["complete"]]
        failed = self.fresh[sc["complete"]:sc["complete"] + sc["fail"]]
        abort = self.fresh[sc["complete"] + sc["fail"]]
        del self.fresh[:sc["complete"] + sc["fail"] + 1]
        for name in done:
            for p in self.job_pods(name):
                p.phase = "Succeeded"
                self.store.update("pods", p)
            self.expect[name] = (None, 0)
        for name in failed:
            p = min(self.job_pods(name), key=lambda p: p.name)
            p.phase = "Failed"
            p.container_statuses = [
                {"name": "c", "state": {"terminated": {"exitCode": 1}}}]
            self.store.update("pods", p)
            self.expect[name] = ("Running", 1)
        for name, action in ((self.aborted, Action.RESUME_JOB),
                             (abort, Action.ABORT_JOB)):
            if name is None:
                continue
            self.store.create("commands", Command(
                name=f"{action.value.lower()}-{name}", namespace=self.NS,
                action=action, target_object={"kind": "Job", "name": name}))
        if self.aborted is not None:
            self.expect[self.aborted] = ("Running", 1)
        self.expect[abort] = ("Aborted", 0)
        self.aborted = abort
        new = self.submit(sc["wave_jobs"])
        self.fresh += new
        return {"completed": done, "restarted": failed, "aborted": abort,
                "new": new}

    def check(self, what: str) -> None:
        """Phases and retries as ``expect`` says; every pod bound at most
        once; no node over its allocatable; a Running job with at least
        minAvailable pods bound; nothing of a collected job left; on the
        card, every cycle that bound a pod launched the kernel."""
        if not self.reached():
            jobs = {j.name: (j.status.state.phase.value, j.status.retry_count)
                    for j in self.store.list("jobs", namespace=self.NS)}
            wrong = {n: (e, jobs.get(n)) for n, e in self.expect.items()
                     if (jobs.get(n) or (None, 0)) != e}
            raise AssertionError(f"{what}: {len(wrong)} jobs off their "
                                 f"expected phase: "
                                 f"{dict(list(wrong.items())[:5])}")
        if self.rebound:
            raise AssertionError(f"{what}: pods bound twice: "
                                 f"{self.rebound[:5]}")
        load: dict = {}
        bound_of: dict = {}
        for p in self.store.list("pods", namespace=self.NS):
            job = p.annotations.get("volcano.sh/job-name")
            if self.expect.get(job, (None,))[0] is None:
                raise AssertionError(f"{what}: pod {p.name} of collected "
                                     f"job {job} remains")
            if not p.node_name or p.phase in ("Succeeded", "Failed"):
                continue
            if self.bound.get(p.uid) != p.node_name:
                raise AssertionError(f"{what}: pod {p.name} on "
                                     f"{p.node_name} without a bind")
            c, m = self.req[job]
            lc, lm, n = load.get(p.node_name, (0.0, 0.0, 0))
            load[p.node_name] = (lc + c, lm + m, n + 1)
            if p.phase == "Running":
                bound_of[job] = bound_of.get(job, 0) + 1
        a = self.alloc
        over = [n for n, (c, m, k) in load.items()
                if c > a["cpu"] or m > a["memory"] or k > a["pods"]]
        if over:
            raise AssertionError(f"{what}: nodes over allocatable: "
                                 f"{over[:5]}")
        short = [n for n, (ph, _) in self.expect.items()
                 if ph == "Running" and bound_of.get(n, 0) < self.tpj]
        if short:
            raise AssertionError(f"{what}: Running jobs with fewer than "
                                 f"minAvailable pods bound: {short[:5]}")
        gone = {n for n, (ph, _) in self.expect.items() if ph is None}
        for kind in ("podgroups", "configmaps", "services",
                     "networkpolicies"):
            left = [o.name for o in self.store.list(kind, namespace=self.NS)
                    if o.name.removesuffix("-svc") in gone]
            if left:
                raise AssertionError(f"{what}: {kind} of collected jobs "
                                     f"remain: {left[:5]}")
        idle = [r for r in self.cycles
                if self.on_card and r["binds"] and r["launches"] <= 0]
        if idle:
            raise AssertionError(f"{what}: a cycle bound pods without a "
                                 f"kernel launch: {idle[0]}")

    def record(self) -> dict:
        """The decisions, by name, for the card/host twin."""
        ns = self.NS
        return {
            "binds": sorted((p.name, p.node_name, p.phase)
                            for p in self.store.list("pods", namespace=ns)),
            "jobs": sorted((j.name, j.status.state.phase.value,
                            j.status.retry_count, j.status.version)
                           for j in self.store.list("jobs", namespace=ns)),
            "podgroups": sorted((pg.name, pg.status.phase.value)
                                for pg in self.store.list("podgroups",
                                                          namespace=ns)),
            "queues": sorted((q.name, q.status.state.value, q.status.pending,
                              q.status.running, q.status.inqueue,
                              q.status.unknown)
                             for q in self.store.list("queues"))}


def lifecycle_run(dev, sc, audit: bool = False, on_wave=None) -> dict:
    """The burst then the waves through one LifecycleWorld, checked after
    every convergence; ``audit`` holds every kernel launch of the burst
    against the plain version; ``on_wave(i, world)`` runs after the burst
    (i = -1) and after each wave."""
    w = LifecycleWorld(dev, sc)
    t0 = time.perf_counter()
    jobs = w.submit(sc["n_jobs"])
    submit_ms = (time.perf_counter() - t0) * 1e3
    if audit:
        with KernelAudit() as kaudit:
            burst = w.converge(new=jobs)
    else:
        burst = w.converge(new=jobs)
    burst["running_ms"] = (time.perf_counter() - t0) * 1e3
    w.check("burst")
    w.fresh = list(jobs)
    pods = w.store.list("pods")
    out = {"burst": {"nodes": sc["n_nodes"], "jobs": len(jobs),
                     "submit_ms": submit_ms, **burst,
                     "pods_created": len(pods),
                     "podgroups_created": len(w.store.list("podgroups")),
                     "plugin_jobs": len(w.store.list("services"))},
           "waves": []}
    if audit:
        out["burst"]["audit"] = kaudit.summary()
        if kaudit.summary()["launches_checked"] != sum(burst["launches"]):
            raise AssertionError("lifecycle burst: a launch escaped the "
                                 "audit")
    if on_wave:
        on_wave(-1, w)
    for i in range(sc["waves"]):
        moved = w.wave()
        row = w.converge(new=moved["new"])
        w.check(f"wave {i}")
        out["waves"].append({"wave": i, **row})
        if on_wave:
            on_wave(i, w)
    out["world"] = w
    out["launches"] = sum(r["launches"] for r in w.cycles)
    return out


def lifecycle_twin(dev, scale=None) -> dict:
    """The lifecycle script at LIFECYCLE_TWIN's size, on ``dev`` and on
    the host (``device="cpu"``, the plain path): binds, job phases,
    podgroup phases and queue status counts identical after the burst and
    after every wave."""
    sc = {**LIFECYCLE, **LIFECYCLE_TWIN, **(scale or {})}
    runs = []
    for where in (dev, "cpu"):
        records = []
        run = lifecycle_run(where, sc,
                            on_wave=lambda i, w: records.append(w.record()))
        runs.append((records, run["launches"]))
    (card, launches), (host, _) = runs
    for i, (a, b) in enumerate(zip(card, host)):
        for key in a:
            if a[key] != b[key]:
                raise AssertionError(f"lifecycle twin, "
                                     f"{'burst' if i == 0 else f'wave {i - 1}'}"
                                     f": {key} differ between card and host")
    if len(card) != len(host) or launches <= 0:
        raise AssertionError("lifecycle twin: the card run launched no "
                             "kernel or the runs differ in length")
    return {"nodes": sc["n_nodes"], "jobs": sc["n_jobs"],
            "waves": sc["waves"], "launches": launches,
            "pods_at_end": len(card[-1]["binds"]),
            "identical_to_host": True}


def phase_lifecycle(dev, scale=None) -> dict:
    """vcjobs from admission to podgroup, pods and binds on the card at
    the cycle cell's scale: the burst of ``n_jobs`` vcjobs, then the
    waves (jobs completing and collected, pods failing and jobs
    restarting, AbortJob then ResumeJob, new jobs); then the twin."""
    sc = dict(LIFECYCLE, **(scale or {}))
    res = lifecycle_run(dev, sc, audit=True)
    w = res.pop("world")
    emit({"phase": "lifecycle", "regime": "burst", **res["burst"]})
    for row in res["waves"]:
        emit({"phase": "lifecycle", "regime": "wave", **row})
    restarted = [n for n, (ph, r) in w.expect.items() if r]
    emit({"phase": "lifecycle", "regime": "summary", "waves": sc["waves"],
          "jobs_submitted": w.k,
          "jobs_collected": sum(ph is None for ph, _ in w.expect.values()),
          "jobs_running": sum(ph == "Running"
                              for ph, _ in w.expect.values()),
          "jobs_aborted": sum(ph == "Aborted"
                              for ph, _ in w.expect.values()),
          "jobs_with_one_retry": len(restarted),
          "cycles": len(w.cycles), "launches": res["launches"],
          "binds": len(w.bound), "double_binds": 0,
          "wave_controllers_ms": cycle_stats(
              [{"v": sum(r["controllers_ms"])} for r in res["waves"]], "v"),
          "wave_cycle_ms": cycle_stats(
              [{"v": v} for r in res["waves"] for v in r["cycle_ms"]], "v"),
          "wave_new_jobs_running_ms": cycle_stats(
              [{"v": r["new_jobs_running_ms"]} for r in res["waves"]], "v")})
    twin = lifecycle_twin(dev)
    emit({"phase": "lifecycle_twin", **twin})
    return {"launches": res["launches"], "burst": res["burst"],
            "waves": res["waves"], "twin": twin}


# -- the networked store: the scheduler on the card over the wire ------------

#: the cycle cell (phase cycle's cluster), not cut: 2000 nodes of
#: 32 cpu / 128Gi, queues 1:2:3, gangs of 10 pods; netstore seeds it pending
#: (a 1000-gang burst), netha seeds it bound; ``restart_wave`` is the wave
#: whose pods are committed when the store process is SIGKILLed
NETSTORE = dict(n_nodes=CYCLE["n_nodes"], n_jobs=CYCLE["n_jobs"],
                tasks_per_job=10, wave_jobs=10, waves=12, restart_wave=8)
#: netha: waves through three scheduler processes; the leader dies at
#: ``kill_exit`` (bind_commit armed exc:exit) and at ``kill_sigkill`` (a
#: SIGKILL once the wave's first bind landed); ``period`` is the HA loop's
NETHA = dict(n_nodes=CYCLE["n_nodes"], n_jobs=CYCLE["n_jobs"],
             tasks_per_job=10, wave_jobs=10, waves=6, kill_exit=2,
             kill_sigkill=4, period=0.25, arms=("warm", "cold"))
#: the client's transport retries: 10 attempts back off 0.1 s to 2 s,
#: about 13 s in all, past a store process's restart
NET_RETRIES = 10
#: how long a child process may take to reach a state it reports
CHILD_TIMEOUT_S = 240.0


class NetCell:
    """The cycle cell's objects, each made once here and handed to every
    store that must hold it (a deep copy in process, the wire's copy
    remotely), so the stores compared hold the same uids and creation
    times. Keeps the gangs' pod keys and requests for the placement
    checks (``StoreCluster.check_placement``)."""

    def __init__(self, n_nodes: int, tasks_per_job: int = 10):
        from volcano_tpu_torch.models import Node, Queue, QueueSpec
        self.tpj = tasks_per_job
        self.k = 0
        self.gangs: dict = {}
        self.req: dict = {}
        self.alloc = {"cpu": 32.0, "memory": _gib("128Gi"), "pods": 110,
                      "gpu": 0.0}
        rl = {"cpu": "32", "memory": "128Gi", "pods": "110"}
        self.base = [("queues", Queue(name=f"q{i}", uid=f"queue-q{i}",
                                      spec=QueueSpec(weight=i + 1)))
                     for i in range(3)]
        self.base += [("nodes", Node(name=f"n{i}", uid=f"node-n{i}",
                                     allocatable=rl, capacity=dict(rl)))
                      for i in range(n_nodes)]

    def gangs_objs(self, n_jobs: int, bound_on: int = 0):
        """``n_jobs`` new gangs: (podgroups, pods, gang names). With
        ``bound_on`` nodes, pod j of the batch sits on node j % bound_on,
        Running (5 pods of at most 3 cpu / 4Gi a node at the cell's
        size), and the podgroups are Running."""
        from volcano_tpu_torch.api.types import POD_GROUP_ANNOTATION
        from volcano_tpu_torch.models import (
            Pod, PodGroup, PodGroupPhase, PodGroupSpec, PodGroupStatus,
        )
        pgs, pods, names = [], [], []
        for _ in range(n_jobs):
            k = self.k
            self.k += 1
            g = f"j{k}"
            phase = PodGroupPhase.RUNNING if bound_on else \
                PodGroupPhase.PENDING
            pgs.append(("podgroups", PodGroup(
                name=g, namespace="bench", uid=f"pg-{g}",
                creation_timestamp=1.0 + k,
                spec=PodGroupSpec(min_member=self.tpj, queue=f"q{k % 3}"),
                status=PodGroupStatus(phase=phase,
                                      running=self.tpj if bound_on else 0))))
            keys = []
            for i in range(self.tpj):
                cpu, mem = 1 + (k // 3) % 3, 1 + k % 4
                node = f"n{(k * self.tpj + i) % bound_on}" if bound_on \
                    else ""
                pods.append(("pods", Pod(
                    name=f"{g}-{i}", namespace="bench", uid=f"pod-{g}-{i}",
                    creation_timestamp=1.0 + k, node_name=node,
                    phase="Running" if bound_on else "Pending",
                    annotations={POD_GROUP_ANNOTATION: g},
                    containers=[{"requests": {"cpu": str(cpu),
                                              "memory": f"{mem}Gi"}}])))
                key = f"bench/{g}-{i}"
                keys.append(key)
                self.req[key] = (float(cpu), mem * float(2 ** 30), 0.0)
            self.gangs[g] = keys
            names.append(g)
        return pgs, pods, names

    def canary(self):
        """A one-pod gang of 40 cpu that fits no node: it stays pending,
        so every cycle (and every standby's shadow) runs the solve."""
        from volcano_tpu_torch.api.types import POD_GROUP_ANNOTATION
        from volcano_tpu_torch.models import (
            Pod, PodGroup, PodGroupPhase, PodGroupSpec, PodGroupStatus,
        )
        return [("podgroups", PodGroup(
            name="canary", namespace="bench", uid="pg-canary",
            creation_timestamp=0.5,
            spec=PodGroupSpec(min_member=1, queue="q0"),
            status=PodGroupStatus(phase=PodGroupPhase.PENDING))),
            ("pods", Pod(
                name="canary-0", namespace="bench", uid="pod-canary-0",
                creation_timestamp=0.5, phase="Pending",
                annotations={POD_GROUP_ANNOTATION: "canary"},
                containers=[{"requests": {"cpu": "40",
                                          "memory": "1Gi"}}]))]

    def check(self, what: str, binds: dict) -> None:
        """Gangs whole, no node over its allocatable (``binds``: pod key
        -> node of the cell's pods)."""
        StoreCluster.check_placement(self, what, binds, gangs=list(
            self.gangs))


def feed(store, items, remote: bool, wait: bool = True) -> None:
    """Commit ``items`` ([(kind, obj)]) to ``store``: a deep copy each
    through ClusterStore.bulk_apply in process; over the wire one
    bulk_apply wave (ack mode), then (``wait``) until this client's watch
    streams delivered it (so a cycle's mirror holds the whole wave)."""
    import copy
    if not items:
        return
    if not remote:
        res = store.bulk_apply([(k, copy.deepcopy(o), "create")
                                for k, o in items])
    else:
        res = store.bulk_apply([(k, o, "create") for k, o in items],
                               ack=True)
    bad = [r for r in res if isinstance(r, Exception)]
    if bad:
        raise AssertionError(f"bulk_apply refused {len(bad)}: {bad[0]}")
    if remote and wait:
        rv = store.applied_hwm()
        for kind in sorted({k for k, _ in items}):
            if not store.wait_stream_applied(kind, rv, timeout=60.0):
                raise AssertionError(f"the {kind} watch did not reach "
                                     f"rv {rv} in 60 s")


def seed_cell(store, cell, n_jobs: int, bound: bool, remote: bool) -> None:
    """The cell into ``store``: queues and nodes, then the podgroups,
    then the pods (each kind committed before the next, as one wave),
    ``bound`` as netha seeds them, with the canary when bound."""
    feed(store, cell.base, remote)
    pgs, pods, _ = cell.gangs_objs(
        n_jobs, bound_on=len(cell.base) - 3 if bound else 0)
    if bound:
        pgs, pods = pgs + cell.canary()[:1], pods + cell.canary()[1:]
    feed(store, pgs, remote)
    feed(store, pods, remote)


def device_line(role: str, **extra) -> dict:
    """A child's first line: its role and the CUDA device it runs beside
    (raises without one: a child never falls back to the host)."""
    if not torch.cuda.is_available():
        raise SystemExit(f"{role}: no CUDA device")
    return {"role": role, "pid": os.getpid(), "device": "cuda:0",
            "device_name": torch.cuda.get_device_name(0), **extra}


class Child:
    """A child process of this script (``--role ...``): its stdout lines
    read on a thread, JSON lines parsed (the rest kept for errors)."""

    def __init__(self, name: str, argv: list):
        import threading
        self.name = name
        env = dict(os.environ, PYTHONHASHSEED="0", PYTHONUNBUFFERED="1")
        env.pop("VOLCANO_FAULTS", None)
        self.proc = subprocess.Popen(
            [sys.executable, os.path.join(REPO, "chip_smoke.py"), *argv],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        self.lines: list = []
        self.raw: list = []
        self.cv = threading.Condition()
        threading.Thread(target=self._read, daemon=True,
                         name=f"child-{name}").start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            line = line.rstrip("\n")
            with self.cv:
                self.raw.append(line)
                del self.raw[:-200]
                if line.startswith("{"):
                    try:
                        self.lines.append(json.loads(line))
                    except ValueError:
                        pass
                self.cv.notify_all()
        with self.cv:
            self.cv.notify_all()

    def wait_for(self, pred, timeout: float, what: str) -> dict:
        """The first JSON line matching ``pred``; raises past ``timeout``
        or when the child exits first."""
        deadline = time.time() + timeout
        with self.cv:
            while True:
                for line in self.lines:
                    if pred(line):
                        return line
                if self.proc.poll() is not None and not any(
                        pred(x) for x in self.lines):
                    self.cv.wait(0.2)
                    if not any(pred(x) for x in self.lines):
                        raise AssertionError(
                            f"{self.name} exited {self.proc.returncode} "
                            f"before {what}:\n" + "\n".join(self.raw[-40:]))
                left = deadline - time.time()
                if left <= 0:
                    raise AssertionError(f"{self.name}: no {what} in "
                                         f"{timeout} s:\n"
                                         + "\n".join(self.raw[-40:]))
                self.cv.wait(min(left, 0.5))

    def first(self, timeout: float = CHILD_TIMEOUT_S) -> dict:
        line = self.wait_for(lambda x: "role" in x, timeout, "first line")
        if not str(line.get("device", "")).startswith("cuda") \
                or self.lines[0] is not line:
            raise AssertionError(f"{self.name}'s first line names no CUDA "
                                 f"device: {line}")
        return line

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(timeout=30)


def start_store(data_dir: str, port: int = 0, seed: str = "",
                audit: str = "", n_nodes: int = 0,
                n_jobs: int = 0) -> tuple:
    argv = ["--role", "store", "--data-dir", data_dir, "--port", str(port)]
    if seed:
        argv += ["--seed", seed, "--nodes", str(n_nodes),
                 "--jobs", str(n_jobs)]
    if audit:
        argv += ["--audit", audit]
    child = Child("store", argv)
    return child, child.first()


def role_store(args) -> int:
    """``--role store``: a StoreServer over a DurableClusterStore in
    ``--data-dir`` (fsync every commit, the default), on ``--port``;
    ``--seed bound`` seeds netha's bound cell into an empty store;
    ``--audit FILE`` appends one JSON line per committed bind (a pod
    update that sets a node on an unbound pod) and lease write. Serves
    until killed; its one line names the device, the address and the
    recovery."""
    import threading

    from volcano_tpu_torch.client import DurableClusterStore, StoreServer
    line = device_line("store")
    store = DurableClusterStore(args.data_dir)
    seeded = False
    if args.seed and not store.list("nodes"):
        seed_cell(store, NetCell(args.nodes), args.jobs,
                  bound=args.seed == "bound", remote=False)
        seeded = True
    if args.audit:
        # committed writes only (a watch listener, called at the commit):
        # a write that loses its compare-and-swap or its fence never
        # shows here
        out = open(args.audit, "a", buffering=1)

        def on_pod(event, obj, old):
            if event == "update" and obj.node_name \
                    and (old is None or not old.node_name):
                out.write(json.dumps({
                    "t": time.time(), "ev": "bind",
                    "pod": f"{obj.namespace}/{obj.name}",
                    "node": obj.node_name}) + "\n")

        def on_lease(event, obj, old):
            if event != "delete":
                out.write(json.dumps({
                    "t": time.time(), "ev": "lease",
                    "holder": obj.holder_identity,
                    "renew": obj.renew_time,
                    "duration": obj.lease_duration_seconds,
                    "epoch": obj.lease_transitions}) + "\n")

        store.watch("pods", on_pod, replay=False)
        store.watch("leases", on_lease, replay=False)
    server = StoreServer(store, port=args.port).start()
    print(json.dumps({**line, "address": server.address,
                      "recovery_ms": store.recovery_ms,
                      "recovered_records": store.recovered_records,
                      "recovered_snapshot_rv": store.recovered_snapshot_rv,
                      "rv": store._rv, "seeded": seeded}), flush=True)
    threading.Event().wait()
    return 0


def store_requests(remote) -> dict:
    """The store server's request counters by op (``store_info``)."""
    return dict(remote._request({"op": "store_info"}).get("requests", {}))


class TimedBinder:
    """The cache's binder with its store writes timed, and each pod's
    binds counted and its node kept (the bind-write share of a cycle)."""

    def __init__(self, inner):
        self.inner = inner
        self.seconds = 0.0
        self.count: dict = {}
        self.nodes: dict = {}

    def bind(self, pod, hostname: str) -> None:
        t0 = time.perf_counter()
        self.inner.bind(pod, hostname)
        self.seconds += time.perf_counter() - t0
        key = f"{pod.namespace}/{pod.name}"
        self.count[key] = self.count.get(key, 0) + 1
        self.nodes[key] = hostname


def net_scheduler(dev, cluster):
    """The port's Scheduler on ``dev`` over ``cluster`` with a timed
    DefaultBinder (FakeEvictor: nothing is evicted here)."""
    from volcano_tpu_torch.cache import FakeEvictor, SchedulerCache
    from volcano_tpu_torch.cache.cache import DefaultBinder
    from volcano_tpu_torch.scheduler import Scheduler
    cache = SchedulerCache(cluster, device=dev)
    cache.binder = TimedBinder(DefaultBinder(cluster))
    cache.evictor = FakeEvictor()
    cache.run()
    cache.wait_for_cache_sync()
    return cache, Scheduler(cache)


def net_cycle(sched, what: str, remote=None, fresh_server=False) -> dict:
    """One run_once, its kernel count set to 0 just before and read just
    after; the binder's write ms apart and, over the wire, the store
    requests the cycle made (``store_info`` read around it, that read not
    counted; against a server that just started, its counters from 0,
    the resumed watch streams included)."""
    from volcano_tpu_torch.ops import fused_choice as fc
    binder = sched.cache.binder
    n0, s0 = sum(binder.count.values()), binder.seconds
    req0 = {} if fresh_server or remote is None else store_requests(remote)
    fc.fused_choice.launches = 0
    t0 = time.perf_counter()
    sched.run_once()
    ms = (time.perf_counter() - t0) * 1e3
    launches = fc.fused_choice.launches
    t = sched.last_cycle_timing
    row = {"cycle": what, "cycle_ms": ms,
           "binds": sum(binder.count.values()) - n0,
           "bind_write_ms": (binder.seconds - s0) * 1e3,
           "launches": launches,
           **{k: t[k] for k in CYCLE_KEYS if k in t}}
    for k in ("flatten_mode", "order_mode", "arena_full_ship",
              "arena_bytes_shipped", "allocate_error", "host_fallback",
              "delta_events_applied", "delta_decode_ms",
              "delta_apply_ms"):
        if k in t:
            row[k] = t[k]
    if remote is not None:
        req1 = store_requests(remote)
        row["store_requests"] = sum(req1.values()) - sum(req0.values()) \
            - (0 if fresh_server else 1)
    if t.get("allocate_error") or t.get("host_fallback"):
        raise AssertionError(f"{what}: the cycle left the device path: "
                             f"{t.get('allocate_error')}")
    if row["binds"] and launches <= 0:
        raise AssertionError(f"{what}: bound {row['binds']} pods without "
                             f"a kernel launch")
    return row


def read_audit(path: str) -> list:
    with open(path) as f:
        return [json.loads(x) for x in f if x.strip()]


def store_pod_binds(remote) -> dict:
    return {f"{p.namespace}/{p.name}": p.node_name
            for p in remote.list("pods", namespace="bench") if p.node_name}


def phase_netstore(dev, scale=None) -> dict:
    """The port's Scheduler on the card in this process over a
    RemoteClusterStore (delta watch) against a store process (a
    StoreServer over a DurableClusterStore, fsync every commit), beside
    the same script on an in-process ClusterStore on the card: the
    cycle cell's burst of 1000 gangs, then ``waves`` waves of 10 gangs.
    At ``restart_wave`` the store process is SIGKILLed once the wave is
    committed and before it is bound, and restarted on the same port and
    data directory while the cycle runs: its binds ride the client's
    retries and the watch streams resume with ``since:``. Checks: every
    cycle's binds equal the twin's, bind for bind; every kernel launch
    held against the plain version; every pod bound once (the store's
    audit across both store processes) and the store's pods equal the
    binds; gangs whole and no node over its allocatable."""
    import tempfile

    from volcano_tpu_torch.client import ClusterStore, RemoteClusterStore
    sc = dict(NETSTORE, **(scale or {}))
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="netstore-",
                           dir=os.path.join(REPO, "build"))
    wal, audit_path = os.path.join(tmp, "wal"), os.path.join(tmp,
                                                             "audit.jsonl")
    store, first = start_store(wal, audit=audit_path)
    stores = [store]
    remote = plain = None
    try:
        remote = RemoteClusterStore(first["address"], delta_watch=True,
                                    retry_attempts=NET_RETRIES)
        twin_store = ClusterStore()
        cell = NetCell(sc["n_nodes"], sc["tasks_per_job"])
        feed(remote, cell.base, True, wait=False)
        feed(twin_store, cell.base, False)
        cache, sched = net_scheduler(dev, remote)
        twin_cache, twin = net_scheduler(dev, twin_store)
        # an object-frame client on the same kinds, listeners empty: the
        # wire bytes the delta streams are held against
        plain = RemoteClusterStore(first["address"],
                                   retry_attempts=NET_RETRIES)
        for kind in ("pods", "nodes", "podgroups", "queues",
                     "priorityclasses", "resourcequotas"):
            plain.watch(kind, lambda *a: None)
        rows, twin_rows, restart = [], [], {}

        def wave(n_jobs, what, kill=False):
            pgs, pods, names = cell.gangs_objs(n_jobs)
            for items in (pgs, pods):
                feed(remote, items, True)
                feed(twin_store, items, False)
            keys = [k for g in names for k in cell.gangs[g]]
            if kill:
                # committed (acked, fsynced) and in the mirror, not bound
                t_kill = time.perf_counter()
                stores[-1].kill()
                stores.append(Child("store", [
                    "--role", "store", "--data-dir", wal, "--port",
                    str(remote.port), "--audit", audit_path]))
            with KernelAudit() as kaudit:
                row = net_cycle(sched, what, remote, fresh_server=kill)
            if kill:
                restart.update(
                    kill_to_next_cycle_end_ms=(time.perf_counter()
                                               - t_kill) * 1e3,
                    **{k: v for k, v in stores[-1].first().items()
                       if k in ("recovery_ms", "recovered_records",
                                "recovered_snapshot_rv", "device_name")},
                    first_cycle={k: row.get(k) for k in (
                        "cycle_ms", "flatten_mode", "arena_full_ship",
                        "arena_bytes_shipped", "binds", "bind_write_ms")},
                    watch_resumes=remote.watch_resumes,
                    watch_failed=remote.watch_failed)
            row["audit"] = kaudit.summary()
            if row["audit"]["launches_checked"] != row["launches"]:
                raise AssertionError(f"{what}: {row['launches']} launches, "
                                     f"{row['audit']} checked")
            trow = net_cycle(twin, what)
            mine = {k: cache.binder.nodes.get(k) for k in keys}
            theirs = {k: twin_cache.binder.nodes.get(k) for k in keys}
            if mine != theirs or None in mine.values():
                diff = [k for k in keys if mine[k] != theirs[k]]
                raise AssertionError(f"{what}: {len(diff)} binds differ "
                                     f"from the in-process twin or are "
                                     f"missing: {diff[:5]}")
            rows.append(row)
            twin_rows.append(trow)

        wave(sc["n_jobs"], "burst")
        for i in range(sc["waves"]):
            wave(sc["wave_jobs"], f"wave {i}",
                 kill=i == sc["restart_wave"])
        if remote.watch_failed or not restart.get("watch_resumes"):
            raise AssertionError(f"the watch did not resume over the "
                                 f"store restart: {restart}")
        binds = store_pod_binds(remote)
        if binds != cache.binder.nodes:
            raise AssertionError("the store's pods differ from the binds "
                                 "the scheduler wrote")
        per_pod: dict = {}
        for rec in read_audit(audit_path):
            if rec["ev"] == "bind":
                per_pod[rec["pod"]] = per_pod.get(rec["pod"], 0) + 1
        dups = {k: n for k, n in per_pod.items() if n != 1}
        if dups or set(per_pod) != set(binds) \
                or max(cache.binder.count.values()) != 1:
            raise AssertionError(f"pods bound more than once or unaudited: "
                                 f"{list(dups)[:5]}")
        cell.check("netstore", binds)
        ds = dict(remote.delta_stats)
        # steady: the waves but the one the store restart held up
        steady = [r for i, r in enumerate(rows[1:])
                  if i != sc["restart_wave"]]
        tsteady = [r for i, r in enumerate(twin_rows[1:])
                   if i != sc["restart_wave"]]
        out = {
            "phase": "netstore", "nodes": sc["n_nodes"],
            "pods_bound": len(binds), "twin_equal": True, "lost": 0,
            "duplicates": 0,
            "burst": rows[0], "twin_burst": twin_rows[0],
            "burst_bind_write_share": rows[0]["bind_write_ms"]
            / rows[0]["cycle_ms"],
            "steady_p50_ms": statistics.median(r["cycle_ms"]
                                               for r in steady),
            "steady_max_ms": max(r["cycle_ms"] for r in steady),
            "twin_steady_p50_ms": statistics.median(r["cycle_ms"]
                                                    for r in tsteady),
            "twin_steady_max_ms": max(r["cycle_ms"] for r in tsteady),
            "store_requests_per_cycle": [r["store_requests"] for r in rows],
            "delta_stats": ds,
            "object_stream_bytes": plain.delta_stats["bytes_object"],
            "delta_bytes_per_object_byte": ds["bytes_delta"]
            / max(plain.delta_stats["bytes_object"], 1),
            "restart": restart, "restart_wave": sc["restart_wave"],
            "waves": rows[1:],
            "launches": sum(r["launches"] for r in rows),
            "twin_launches": sum(r["launches"] for r in twin_rows)}
        emit(out)
        return out
    finally:
        for client in (remote, plain):
            if client is not None:
                client.close()
        for child in stores:
            child.kill()
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)


def role_scheduler(args) -> int:
    """``--role scheduler``: the port's Scheduler on the card under
    run_with_leader_election over a RemoteClusterStore at ``--server``
    (fenced writes, the bind-intent journal, takeover reconciliation;
    shadow cycles unless ``--cold-standby``). Every kernel launch is
    held against the plain version (KernelAudit). A configmap
    ``faults-<identity>`` arms this process's fault injector; a
    configmap ``netha-wave`` names the gangs of the wave in flight, and
    a leader cycle waits until each has all its pods in the mirror, so
    a wave is decided in one cycle as the in-process run decides it.
    Prints one JSON line per event: ``synced``, ``armed``, the first
    shadow cycle that launched the kernel (``warm``), and every leader
    cycle that launched it or was its first (``cycle``), each with the
    process's cumulative launch and audit counts."""
    import threading

    from volcano_tpu_torch.cache import SchedulerCache
    from volcano_tpu_torch.client import RemoteClusterStore
    from volcano_tpu_torch.ops import fused_choice as fc
    from volcano_tpu_torch.resilience import faults
    from volcano_tpu_torch.scheduler import Scheduler
    print(json.dumps(device_line("scheduler", identity=args.identity,
                                 cold=args.cold_standby)), flush=True)
    dev = torch.device("cuda", 0)
    remote = RemoteClusterStore(args.server, delta_watch=True,
                                retry_attempts=NET_RETRIES,
                                on_watch_failure=lambda: os._exit(3))
    cache = SchedulerCache(remote, device=dev)
    gate: dict = {}
    state = {"leader_cycles": 0, "shadows": 0, "warm": False,
             "kernel_load_ms": None}
    ident = args.identity

    def on_configmap(event, cm, old):
        if event == "delete":
            return
        if cm.name == f"faults-{ident}" and (cm.data or {}).get("spec"):
            faults.configure(cm.data["spec"])
            print(json.dumps({"ev": "armed", "id": ident,
                              "spec": cm.data["spec"]}), flush=True)
        elif cm.name == "netha-wave":
            gate.update(gangs=(cm.data or {}).get("gangs", "").split(","),
                        pods=int((cm.data or {}).get("pods", "0")))

    remote.watch("configmaps", on_configmap)
    load = fc._kernel

    def timed_load():
        if fc._lib is not None:
            return load()
        t0 = time.perf_counter()
        lib = load()
        state["kernel_load_ms"] = (time.perf_counter() - t0) * 1e3
        return lib

    fc._kernel = timed_load

    def wave_in_mirror() -> bool:
        with remote.locked():
            for g in gate.get("gangs") or ():
                job = cache.jobs.get(f"bench/{g}") if g else None
                if g and (job is None or job.pod_group is None
                          or len(job.tasks) != gate["pods"]):
                    return False
        return True

    class HAScheduler(Scheduler):
        def run_once(self):
            if not wave_in_mirror():
                return
            before = {"cuda_initialized": torch.cuda.is_initialized(),
                      "kernel_loaded": fc._lib is not None,
                      "arena_sessions": getattr(cache.device_cache,
                                                "sessions", 0)}
            n0 = fc.fused_choice.launches
            state["kernel_load_ms"] = None
            t0 = time.time()
            super().run_once()
            t1 = time.time()
            state["leader_cycles"] += 1
            launches = fc.fused_choice.launches - n0
            if launches or state["leader_cycles"] == 1:
                t = self.last_cycle_timing
                print(json.dumps({
                    "ev": "cycle", "id": ident,
                    "n": state["leader_cycles"], "t0": t0, "t1": t1,
                    "ms": (t1 - t0) * 1e3, "launches": launches,
                    "total_launches": fc.fused_choice.launches,
                    "checked": len(audit.shapes),
                    "kernel_load_ms": state["kernel_load_ms"],
                    "shadows": state["shadows"],
                    **{f"{k}_before": v for k, v in before.items()},
                    **{k: t.get(k) for k in (
                        "flatten_mode", "arena_full_ship",
                        "arena_bytes_shipped", "allocate_error",
                        "session_compiles", "dispatch_ms", "total_ms")}}),
                    flush=True)

        def shadow_cycle(self):
            n0 = fc.fused_choice.launches
            super().shadow_cycle()
            state["shadows"] += 1
            if fc.fused_choice.launches > n0 and not state["warm"]:
                state["warm"] = True
                print(json.dumps({
                    "ev": "warm", "id": ident, "shadows": state["shadows"],
                    "total_launches": fc.fused_choice.launches,
                    "checked": len(audit.shapes)}), flush=True)

    sync = cache.wait_for_cache_sync

    def synced():
        ok = sync()
        print(json.dumps({"ev": "synced", "id": ident}), flush=True)
        return ok

    cache.wait_for_cache_sync = synced
    sched = HAScheduler(cache, period=args.period)
    with KernelAudit() as audit:
        sched.run_with_leader_election(
            threading.Event(), identity=ident, lease_duration=args.lease,
            renew_deadline=args.renew, retry_period=args.retry,
            warm_standby=not args.cold_standby)
    return 0


def netha_golden(dev, sc) -> dict:
    """The uninterrupted run in this process on the card: the bound cell
    (as the store process seeds it), one idle cycle, then one cycle a
    wave. Returns the waves' binds and the wave objects."""
    from volcano_tpu_torch.client import ClusterStore
    cell = NetCell(sc["n_nodes"], sc["tasks_per_job"])
    store = ClusterStore()
    seed_cell(store, cell, sc["n_jobs"], bound=True, remote=False)
    cache, sched = net_scheduler(dev, store)
    sched.run_once()
    waves = []
    for _ in range(sc["waves"]):
        pgs, pods, names = cell.gangs_objs(sc["wave_jobs"])
        feed(store, pgs, False)
        feed(store, pods, False)
        sched.run_once()
        waves.append((pgs, pods, names))
    binds = {k: cache.binder.nodes.get(k) for _, _, names in waves
             for g in names for k in cell.gangs[g]}
    if None in binds.values():
        raise AssertionError("the uninterrupted run left a wave pod "
                             "unbound")
    return {"binds": binds, "waves": waves, "cell": cell}


def lease_of(remote):
    return remote.try_get("leases", "volcano")


#: the lease's floor: four times the longest first leader cycle of a
#: cold scheduler process measured on the card (1540-1755 ms, NVIDIA H100
#: 80GB HBM3 at 700 W, this phase's cold arm; PERF.md): a new process's
#: first device work holds it, and its renewals wait
NETHA_LEASE_FLOOR_S = 8.0


def netha_lease(netstore, replay_ms: float) -> dict:
    """The lease against what this run measured: the netstore phase's
    longest steady cycle over the wire (past the first wave after the
    burst, the restart wave left out) and ``replay_ms``, the store's
    replay of the bound cell's pods to one new watcher (it holds the
    store's lock: every renewal waits). Four times the longer, at least
    NETHA_LEASE_FLOOR_S; renew at 3/4, retry at 1/8."""
    steady = [r["cycle_ms"] for i, r in enumerate(netstore["waves"])
              if i not in (0, netstore["restart_wave"])] if netstore \
        else [500.0]
    longest = max(NETHA_LEASE_FLOOR_S,
                  4.0 * max(max(steady), replay_ms) / 1e3)
    return {"duration": round(longest, 1),
            "renew": round(0.75 * longest, 1),
            "retry": round(longest / 8.0, 2),
            "from_steady_max_ms": max(steady), "from_replay_ms": replay_ms,
            "floor_s": NETHA_LEASE_FLOOR_S}


def netha_arm(dev, sc, cold: bool, golden: dict, netstore) -> dict:
    """One arm: a store process holding the bound cell, three scheduler
    processes (the standbys started once the first holds the lease); the
    leader dies twice (bind_commit exc:exit, then a SIGKILL mid-wave),
    each time a standby takes over."""
    import tempfile

    from volcano_tpu_torch.client import FencedError, RemoteClusterStore
    from volcano_tpu_torch.models import ConfigMap
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="netha-", dir=os.path.join(REPO, "build"))
    audit_path = os.path.join(tmp, "audit.jsonl")
    children: dict = {}
    remote = None
    try:
        store, first = start_store(
            os.path.join(tmp, "wal"), seed="bound", audit=audit_path,
            n_nodes=sc["n_nodes"], n_jobs=sc["n_jobs"])
        children["store"] = store
        remote = RemoteClusterStore(first["address"],
                                    retry_attempts=NET_RETRIES)
        bound: dict = {}

        def on_pod(event, pod, old):
            key = f"{pod.namespace}/{pod.name}"
            if pod.node_name and key not in bound:
                bound[key] = pod.node_name

        t0 = time.perf_counter()
        remote.watch("pods", on_pod)
        lease = netha_lease(netstore, (time.perf_counter() - t0) * 1e3)
        seeded = set(bound)

        def spawn(ident):
            argv = ["--role", "scheduler", "--server", first["address"],
                    "--identity", ident, "--lease", str(lease["duration"]),
                    "--renew", str(lease["renew"]),
                    "--retry", str(lease["retry"]),
                    "--period", str(sc["period"])]
            if cold:
                argv.append("--cold-standby")
            children[ident] = Child(ident, argv)
            return children[ident]

        def ready(ident):
            ev = "synced" if cold else "warm"
            children[ident].wait_for(lambda x: x.get("ev") == ev,
                                     CHILD_TIMEOUT_S, ev)

        spawn("A").first()
        deadline = time.time() + CHILD_TIMEOUT_S
        while True:
            held = lease_of(remote)
            if held is not None and held.holder_identity == "A":
                break
            if time.time() > deadline:
                raise AssertionError("A did not take the lease")
            time.sleep(0.1)
        # two standbys, so the second kill finds one ready: the first
        # death hands over to either, the second to the other
        leader, standbys = "A", ["B", "C"]
        for ident in standbys:
            spawn(ident)
        for ident in standbys:
            children[ident].first()
        children[leader].wait_for(lambda x: x.get("ev") == "cycle",
                                  CHILD_TIMEOUT_S, "first leader cycle")
        for ident in standbys:
            ready(ident)
        kills, takeovers, late_write = [], [], {}
        for w, (pgs, pods, names) in enumerate(golden["waves"]):
            remote.apply("configmaps", ConfigMap(
                name="netha-wave", namespace="default",
                data={"gangs": ",".join(names),
                      "pods": str(sc["tasks_per_job"])}))
            killing = w in (sc["kill_exit"], sc["kill_sigkill"])
            if killing:
                held = lease_of(remote)
                if held.holder_identity != leader:
                    raise AssertionError(
                        f"the lease moved from {leader} to "
                        f"{held.holder_identity} without a kill:\n"
                        + "\n".join(children[leader].raw[-20:]))
                token = {"lock": "volcano", "holder": leader,
                         "epoch": held.lease_transitions}
            if w == sc["kill_exit"]:
                remote.apply("configmaps", ConfigMap(
                    name=f"faults-{leader}", namespace="default",
                    data={"spec": "bind_commit=at:1,exc:exit"}))
                children[leader].wait_for(lambda x: x.get("ev") == "armed",
                                          60.0, "armed")
            keys = [k for g in names for k in golden["cell"].gangs[g]]
            feed(remote, pgs, True, wait=False)
            feed(remote, pods, True, wait=False)
            t_sub = time.time()
            t_kill = t_sub
            if w == sc["kill_sigkill"]:
                deadline = time.time() + 60.0
                while not any(k in bound for k in keys):
                    if time.time() > deadline:
                        raise AssertionError(f"wave {w}: no bind in 60 s")
                    time.sleep(0.002)
                t_kill = time.time()
                children[leader].kill()
            deadline = time.time() + 120.0
            while not all(k in bound for k in keys):
                if time.time() > deadline:
                    raise AssertionError(
                        f"wave {w}: {sum(k in bound for k in keys)} of "
                        f"{len(keys)} bound in 120 s")
                time.sleep(0.01)
            if not killing:
                continue
            dead = leader
            rc = children[dead].proc.wait(timeout=60)
            if w == sc["kill_exit"] and rc != 17:
                raise AssertionError(f"{dead} exited {rc}, not at the "
                                     f"armed bind_commit")
            held = lease_of(remote)
            if held.holder_identity not in standbys:
                raise AssertionError(f"no standby of {standbys} took over: "
                                     f"{held.holder_identity}")
            new = held.holder_identity
            # the dead leader's token, presented late, is fenced
            victim = remote.get("pods", keys[0].split("/")[1], "bench")
            before = victim.node_name
            try:
                remote.update("pods", victim, fencing=token)
            except FencedError:
                late_write[dead] = "fenced"
            else:
                raise AssertionError(f"{dead}'s late write landed")
            if remote.get("pods", victim.name, "bench").node_name != before:
                raise AssertionError("the fenced write changed the pod")
            new_cycle = children[new].wait_for(
                lambda x: x.get("ev") == "cycle", 60.0,
                "first leader cycle")
            kills.append({"wave": w, "dead": dead, "rc": rc,
                          "how": "bind_commit exc:exit"
                          if w == sc["kill_exit"] else "SIGKILL",
                          "t": t_kill})
            takeovers.append({"wave": w, "dead": dead, "new": new,
                              "first_leader_cycle": new_cycle,
                              "wave_keys": keys})
            leader = new
            standbys.remove(new)
        # every wave's pod bound once, as the uninterrupted run bound it
        binds = {k: v for k, v in bound.items() if k not in seeded}
        audit = read_audit(audit_path)
        per_pod: dict = {}
        for rec in audit:
            if rec["ev"] == "bind":
                per_pod[rec["pod"]] = per_pod.get(rec["pod"], 0) + 1
        dups = {k: n for k, n in per_pod.items() if n != 1}
        if dups or set(per_pod) != set(golden["binds"]):
            raise AssertionError(f"binds not once each: {list(dups)[:5]}, "
                                 f"{len(per_pod)} audited")
        if binds != golden["binds"]:
            diff = sorted(k for k in set(binds) | set(golden["binds"])
                          if binds.get(k) != golden["binds"].get(k))
            raise AssertionError(f"{len(diff)} binds differ from the "
                                 f"uninterrupted run: {diff[:5]}")
        # the leader sweeps settled intents once a cycle
        deadline = time.time() + 30.0
        while remote.list("bindintents"):
            if time.time() > deadline:
                raise AssertionError("bind intents left after 30 s")
            time.sleep(0.1)
        # leadership: the first acquisition, then one change a kill
        holders = [r["holder"] for r in audit if r["ev"] == "lease"
                   and r["holder"]]
        changes = sum(1 for a, b in zip(holders, holders[1:]) if a != b)
        if changes != len(kills):
            raise AssertionError(
                f"{changes} leader transitions for {len(kills)} kills: "
                + str([(round(r["t"], 2), r["holder"], round(r["renew"], 2))
                       for r in audit if r["ev"] == "lease"][:40]))
        rows = []
        for tk, kill in zip(takeovers, kills):
            renews = [r for r in audit if r["ev"] == "lease"
                      and r["holder"] == tk["dead"]]
            last_renew = renews[-1]["renew"]
            expiry = last_renew + renews[-1]["duration"]
            wave_binds = sorted(r["t"] for r in audit if r["ev"] == "bind"
                                and r["pod"] in tk["wave_keys"])
            # past the kill, only requests the dead leader had already
            # sent may land before its lease expired (within 0.2 s);
            # every other bind waits for the expiry (0.1 s clock slack)
            after = [t for t in wave_binds if t > kill["t"]]
            early = [t for t in after if kill["t"] + 0.2 < t < expiry - 0.1]
            taken = [t for t in after if t >= expiry - 0.1]
            if early or not taken:
                raise AssertionError(
                    f"wave {tk['wave']}: {len(early)} binds between the "
                    f"kill and the lease expiry, {len(taken)} after it")
            rows.append({"wave": tk["wave"], "dead": tk["dead"],
                         "new": tk["new"], "how": kill["how"],
                         "takeover_ms": (taken[0] - last_renew) * 1e3,
                         "lease_expiry_to_first_bind_ms":
                             (taken[0] - expiry) * 1e3,
                         "dead_leader_binds": len(wave_binds) - len(taken),
                         "first_leader_cycle": tk["first_leader_cycle"]})
        for row in rows:
            c = row["first_leader_cycle"]
            if c.get("allocate_error") or c["launches"] <= 0 \
                    or c["checked"] != c["total_launches"]:
                raise AssertionError(f"{row['new']}'s first leader cycle: "
                                     f"{c}")
        launches, checked = 0, 0
        for ident, child in children.items():
            if ident == "store":
                continue
            counted = [x for x in child.lines if "total_launches" in x]
            if counted:
                launches += counted[-1]["total_launches"]
                checked += counted[-1]["checked"]
        if checked != launches:
            raise AssertionError(f"{launches} launches, {checked} held "
                                 f"against the plain version")
        return {"arm": "cold" if cold else "warm", "lease": lease,
                "lost": 0, "duplicates": 0, "golden_equal": True,
                "intents_left": 0,
                "late_writes": late_write, "leader_transitions": changes,
                "kills": [{k: v for k, v in x.items() if k != "t"}
                          for x in kills],
                "takeovers": rows, "launches": launches,
                "launches_checked": checked}
    finally:
        if remote is not None:
            remote.close()
        for child in children.values():
            child.kill()
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)


def phase_netha(dev, scale=None, netstore=None) -> dict:
    """Failover across processes: a store process holding the cycle cell
    already bound (seeded there, with a canary gang that fits no node so
    every cycle solves), three scheduler processes on the card under
    run_with_leader_election. The leader dies twice: at an armed
    bind_commit (exc:exit) and by SIGKILL once a wave's first bind
    landed; a standby takes over each time. The arm runs with warm
    standbys (shadow cycles), then with cold ones. The lease is set per
    arm from measured stalls (``netha_lease``). Checks per arm: every
    pod bound once (the store's audit), the waves' binds equal the
    uninterrupted in-process run's, no intent left, the dead leader's
    token fenced, no bind after a kill before the lease expired but the
    dead leader's own, one leader transition a kill, and each new
    leader's first cycle launching the kernel with every launch held
    against the plain version."""
    sc = dict(NETHA, **(scale or {}))
    golden = netha_golden(dev, sc)
    arms = []
    for arm in sc["arms"]:
        t0 = time.perf_counter()
        arms.append(netha_arm(dev, sc, cold=arm == "cold", golden=golden,
                              netstore=netstore))
        arms[-1]["seconds"] = time.perf_counter() - t0
    out = {"phase": "netha", "nodes": sc["n_nodes"],
           "waves": sc["waves"], "arms": arms,
           "launches": sum(a["launches"] for a in arms)}
    emit(out)
    return out


#: netshard: the cycle cell seeded bound (with the canary) into a primary
#: of ``shards`` worker processes behind a ProcShardRouter (fsync on every
#: commit), read through a depth-2 replica tree; shard worker
#: ``kill_worker`` is SIGKILLed at wave ``kill_worker_wave``, the mid-tier
#: replica at ``kill_replica_wave``
NETSHARD = dict(n_nodes=CYCLE["n_nodes"], n_jobs=CYCLE["n_jobs"],
                tasks_per_job=10, wave_jobs=10, waves=12, shards=4,
                kill_worker=2, kill_worker_wave=4, kill_replica_wave=8)
#: the kinds the scheduler cache watches (and netshard waits on)
WATCHED_KINDS = ("pods", "nodes", "podgroups", "queues")


def role_shardprimary(args) -> int:
    """``--role shardprimary``: a ShardProcSupervisor of ``--shards``
    worker processes (``python -m volcano_tpu_torch.client.shardproc``,
    each a DurableClusterStore under ``--data-dir/shard-NNN``, fsync on
    every commit) behind a ProcShardRouter on ``--port``. ``--audit
    FILE`` appends one JSON line per committed bind (a pod update that
    sets a node on an unbound pod), read off a direct per-worker watch
    of this router, so it spans a worker's restart. Serves until killed;
    its one line names the device, the address and the workers."""
    import threading

    from volcano_tpu_torch.client import (
        ProcShardedStore, ProcShardRouter, RemoteClusterStore,
        ShardProcSupervisor,
    )
    line = device_line("shardprimary")
    sup = ShardProcSupervisor(args.shards, data_dir=args.data_dir,
                              admission=False,
                              restart_backoff_base_s=0.1).start()
    server = ProcShardRouter(ProcShardedStore(sup), port=args.port).start()
    if args.audit:
        out = open(args.audit, "a", buffering=1)
        audit = RemoteClusterStore(server.address, direct_watch=True,
                                   retry_attempts=NET_RETRIES)

        def on_pod(event, obj, old):
            if event == "update" and obj.node_name \
                    and (old is None or not old.node_name):
                out.write(json.dumps({
                    "t": time.time(), "ev": "bind",
                    "pod": f"{obj.namespace}/{obj.name}",
                    "node": obj.node_name}) + "\n")

        audit.watch("pods", on_pod)
    print(json.dumps({**line, "address": server.address,
                      "workers": sup.topology()["workers"]}), flush=True)
    threading.Event().wait()
    return 0


def role_replica(args) -> int:
    """``--role replica``: a ReplicaStore tailing ``--upstream`` (the
    primary, or a replica: a deeper hop of the tree), one tailer a shard,
    served on ``--port`` once it has applied what the upstream held at
    its start. A mirror served while it still replays sends a resuming
    child the records the child already holds; the child meets a gap,
    re-bootstraps behind its own watchers' marks, and they cannot resume
    (ROADMAP Queue C). Its one line names the device, the address, the
    depth, the bootstraps and the ms to catch up."""
    import threading

    from volcano_tpu_torch.client import ReplicaStore
    line = device_line("replica")
    t0 = time.perf_counter()
    rep = ReplicaStore(args.upstream)
    rep.start()
    rep.wait_applied(rep._client._request({"op": "store_info"})["rv"],
                     wait_s=CHILD_TIMEOUT_S)
    catch_up_ms = (time.perf_counter() - t0) * 1e3
    server = rep.serve(port=args.port)
    print(json.dumps({**line, "address": server.address,
                      "depth": rep.depth, "applied_rv": rep.applied_rv(),
                      "bootstraps": dict(rep.bootstraps),
                      "catch_up_ms": catch_up_ms}), flush=True)
    threading.Event().wait()
    return 0


class PrimaryTap:
    """The scheduler's primary client (a RemoteClusterStore on the
    router, direct routing to the workers), counting what passes: each
    mutation's result rv by (kind, shard), so the phase can wait until
    the leaf's watch streams delivered every write; and every read by
    (op, kind), so the check can hold the primary's reads to PRIMARY_KINDS
    and the read tier's counted fallbacks."""

    def __init__(self, remote, n_shards: int):
        self.remote = remote
        self.n_shards = n_shards
        self.written: dict = {}
        self.reads: dict = {}

    def _note(self, kind: str, obj) -> None:
        from volcano_tpu_torch.client import shard_for
        from volcano_tpu_torch.client.store import _key
        if obj is None or isinstance(obj, Exception):
            return
        sh = str(shard_for(kind, _key(obj), self.n_shards))
        marks = self.written.setdefault(kind, {})
        marks[sh] = max(marks.get(sh, 0), int(obj.resource_version))

    def _read(self, op: str, kind: str) -> None:
        self.reads[(op, kind)] = self.reads.get((op, kind), 0) + 1

    def create(self, kind, obj, fencing=None):
        out = self.remote.create(kind, obj, fencing=fencing)
        self._note(kind, out)
        return out

    def update(self, kind, obj, fencing=None):
        out = self.remote.update(kind, obj, fencing=fencing)
        self._note(kind, out)
        return out

    def apply(self, kind, obj, fencing=None):
        out = self.remote.apply(kind, obj, fencing=fencing)
        self._note(kind, out)
        return out

    def bulk_apply(self, items, fencing=None, **kw):
        out = self.remote.bulk_apply(items, fencing=fencing, **kw)
        for (kind, *_), obj in zip(items, out):
            self._note(kind, obj)
        return out

    def get(self, kind, name, namespace=None, **kw):
        self._read("get", kind)
        return self.remote.get(kind, name, namespace, **kw)

    def list(self, kind, *a, **kw):
        self._read("list", kind)
        return self.remote.list(kind, *a, **kw)

    def watch(self, kind, *a, **kw):
        self._read("watch", kind)
        return self.remote.watch(kind, *a, **kw)

    def bulk_watch(self, subs, **kw):
        for kind, _ in subs:
            self._read("watch", kind)
        return self.remote.bulk_watch(subs, **kw)

    def __getattr__(self, name):
        return getattr(self.remote, name)

    def settle(self, leaf, timeout: float = 60.0) -> None:
        """Wait until ``leaf``'s streams delivered every write made here
        of a kind the cache watches (the cache's mirror holds it)."""
        for kind in WATCHED_KINDS:
            marks = self.written.get(kind)
            if marks and not leaf.wait_stream_applied(kind, dict(marks),
                                                      timeout=timeout):
                raise AssertionError(
                    f"the leaf's {kind} watch did not reach {marks} in "
                    f"{timeout} s (at {leaf._kind_hwm.get(kind)}; stream "
                    f"resumes {leaf.watch_resumes}, failed "
                    f"{leaf.watch_failed}; the leaf: "
                    f"{_info(f'{leaf.host}:{leaf.port}', 'replica_info')})")


def tree_twin(dev, leaf, cache, seed) -> tuple:
    """The in-process twin of a scheduler fed by ``leaf``: a ClusterStore
    holding ``seed`` ([queues and nodes, podgroups, pods]) with the pods
    in the leaf's order, and the port's Scheduler on ``dev`` over it. The
    cache subscribes to pods before nodes, so each node takes its place in
    the mirror at its first bound pod, and the leaf replays the pods shard
    by shard; the order of the nodes breaks ties between equal scores.
    Raises unless the twin's nodes stand in the order of ``cache``'s."""
    from volcano_tpu_torch.client import ClusterStore
    order = {f"{p.namespace}/{p.name}": i
             for i, p in enumerate(leaf.list("pods"))}
    store = ClusterStore()
    for items in seed[:2] + [sorted(seed[2], key=lambda ko: order[
            f"{ko[1].namespace}/{ko[1].name}"])]:
        feed(store, items, False)
    twin_cache, twin = net_scheduler(dev, store)
    if list(twin_cache.nodes) != list(cache.nodes):
        raise AssertionError("the twin's nodes are not in the mirror's "
                             "order")
    return store, twin_cache, twin


def feed_tree(tap, leaf, twin_store, groups) -> None:
    """Each group of [(kind, obj)] through the primary (``tap``) and into
    the twin, a group at a time, each in the leaf's mirror before the next
    (a pod ahead of its podgroup would place the job)."""
    for items in groups:
        tap.bulk_apply([(k, o, "create") for k, o in items])
        tap.settle(leaf)
        feed(twin_store, items, False)


def _info(address: str, op: str) -> dict:
    """One ``op`` request to ``address`` on a fresh router-only client."""
    from volcano_tpu_torch.client import RemoteClusterStore
    c = RemoteClusterStore(address, direct_routing=False,
                           retry_attempts=NET_RETRIES)
    try:
        return c._request({"op": op})
    finally:
        c.close()


def _rv_covers(have, want) -> bool:
    return all(int(have.get(sh, -1)) >= int(rv) for sh, rv in want.items())


def _pct(vals, q: float):
    if not vals:
        return None
    vals = sorted(vals)
    return vals[min(len(vals) - 1, int(round(q / 100.0 * (len(vals) - 1))))]


class Endpoints:
    """Per-cycle store requests at each endpoint of the tree (its
    ``store_info`` counters by op; the probes' own ``store_info`` and the
    supervisor's liveness polls left out by dropping that op)."""

    def __init__(self, named: dict):
        self.named = named  # name -> address (router first)

    def read(self) -> dict:
        out = {}
        # workers before the router: the router's store_info fans out to
        # every worker
        for name in sorted(self.named, key=lambda n: n == "router"):
            out[name] = dict(_info(self.named[name], "store_info")
                             .get("requests", {}))
        return out

    @staticmethod
    def delta(before: dict, after: dict) -> dict:
        out = {}
        for name, reqs in after.items():
            d = {op: n - before.get(name, {}).get(op, 0)
                 for op, n in reqs.items() if op != "store_info"}
            out[name] = {op: n for op, n in d.items() if n}
        return out


def replica_lag(address: str) -> dict:
    """One replica's lag: records summed over its shards, seconds the
    largest shard's (``replica_info``)."""
    info = _info(address, "replica_info")
    per = info.get("per_shard") or {}
    recs = [v.get("lag_records") for v in per.values()]
    secs = [v.get("lag_seconds") for v in per.values()]
    return {"records": None if None in recs else sum(recs),
            "seconds": None if None in secs else max(secs),
            "bootstraps": dict(info.get("bootstraps") or {}),
            "depth": info.get("depth")}


def tree_lists(primary_addr: str, replicas: dict) -> dict:
    """Every kind listed on the primary and on each replica at the same
    applied rv, encoded and compared (the bench's ``tree_ok``): the
    primary's rv read once the writes stopped, each replica's list asked
    at ``min_rv`` of it and its own stamp required equal."""
    from volcano_tpu_torch.client import RemoteClusterStore
    from volcano_tpu_torch.client.codec import encode
    from volcano_tpu_torch.client.store import KINDS
    prv = _info(primary_addr, "store_info")["rv"]
    clients = {name: RemoteClusterStore(a, direct_routing=False,
                                        retry_attempts=NET_RETRIES)
               for name, a in [("primary", primary_addr),
                               *replicas.items()]}
    try:
        counts = {}
        for kind in KINDS:
            objs, stamp = clients["primary"].list_versioned(kind)
            if stamp != prv:
                raise AssertionError(f"the primary moved during the tree "
                                     f"check: {stamp} != {prv}")
            want = sorted(json.dumps(encode(o), sort_keys=True)
                          for o in objs)
            for name in replicas:
                got, applied = clients[name].list_versioned(
                    kind, min_rv=prv, wait_s=60.0)
                if applied != prv:
                    raise AssertionError(f"{name} answered {kind} at "
                                         f"{applied}, not {prv}")
                if sorted(json.dumps(encode(o), sort_keys=True)
                          for o in got) != want:
                    raise AssertionError(f"{name}'s {kind} differ from the "
                                         f"primary's at rv {prv}")
            counts[kind] = len(want)
        return {"applied_rv": prv, "objects": counts, "tree_ok": True}
    finally:
        for c in clients.values():
            c.close()


def phase_netshard(dev, scale=None, netstore=None) -> dict:
    """The scheduler on the card over the sharded, replicated store: a
    primary process (``--role shardprimary``: 4 shard-worker processes,
    fsync on every commit, behind a ProcShardRouter) seeded through the
    router's bulk_apply with the cycle cell already bound plus a gang
    that fits no node (every cycle solves); replica r1 tails it and r2
    tails r1 (``--role replica``, a process each). This process's
    Scheduler runs on the card over SchedulerCache(ReadTierStore(primary,
    leaf)): binds direct to the owning worker, list/watch off r2 (delta
    watch), read-your-writes by min_rv; beside the same script on an
    in-process store (the twin). 12 waves of 10 gangs; at
    ``kill_worker_wave`` worker 2 is SIGKILLed once the wave is mirrored
    (its supervisor restarts it on the same port and data dir while the
    cycle binds), at ``kill_replica_wave`` r1 is SIGKILLed and restarted
    on its port. Checks: every cycle's binds equal the twin's, every
    launch held against the plain version, every pod bound once (the
    primary's audit across both lives of worker 2), gangs whole, no node
    over its allocatable, r1's and r2's lists of every kind equal the
    primary's at one applied rv, no replica gap, the leaf serving the
    reads and the primary only PRIMARY_KINDS and counted fallbacks."""
    import tempfile
    import threading

    from volcano_tpu_torch.client import ReadTierStore, RemoteClusterStore
    from volcano_tpu_torch.client.readtier import PRIMARY_KINDS
    t_phase = time.perf_counter()
    sc = dict(NETSHARD, **(scale or {}))
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="netshard-",
                           dir=os.path.join(REPO, "build"))
    audit_path = os.path.join(tmp, "audit.jsonl")
    prim = Child("shardprimary", [
        "--role", "shardprimary", "--data-dir", os.path.join(tmp, "data"),
        "--shards", str(sc["shards"]), "--audit", audit_path])
    children = [prim]
    clients = []
    try:
        pline = prim.first()
        addr = pline["address"]
        for w in pline["workers"]:
            with open(f"/proc/{w['pid']}/cmdline", "rb") as f:
                argv = f.read().split(b"\0")
            if b"volcano_tpu_torch.client.shardproc" not in argv:
                raise AssertionError(f"shard worker {w['shard']} does not "
                                     f"run the port's module: {argv}")
        primary = RemoteClusterStore(addr, retry_attempts=NET_RETRIES)
        clients.append(primary)
        tap = PrimaryTap(primary, sc["shards"])
        cell = NetCell(sc["n_nodes"], sc["tasks_per_job"])
        pgs, pods, _ = cell.gangs_objs(sc["n_jobs"], bound_on=sc["n_nodes"])
        canary = cell.canary()
        seed = [cell.base, pgs + canary[:1], pods + canary[1:]]
        # the seed through the router: one bulk_apply a kind group, split
        # per shard and fsynced by the workers in parallel
        t0 = time.perf_counter()
        for items in seed:
            res = primary.bulk_apply([(k, o, "create") for k, o in items],
                                     ack=True)
            bad = [r for r in res if isinstance(r, Exception)]
            if bad:
                raise AssertionError(f"the seed refused {len(bad)}: "
                                     f"{bad[0]}")
        seed_ms = (time.perf_counter() - t0) * 1e3
        seeded_rv = _info(addr, "store_info")["rv"]
        # the tree: r1 tails the primary, r2 tails r1
        r1 = Child("r1", ["--role", "replica", "--upstream", addr,
                          "--port", "0"])
        children.append(r1)
        r1addr = r1.first()["address"]
        r2 = Child("r2", ["--role", "replica", "--upstream", r1addr,
                          "--port", "0"])
        children.append(r2)
        r2line = r2.first()
        r2addr = r2line["address"]
        t0 = time.perf_counter()
        while not _rv_covers(_info(r2addr, "store_info")["rv"], seeded_rv):
            if time.perf_counter() - t0 > CHILD_TIMEOUT_S:
                raise AssertionError("the replica tree did not catch up "
                                     "with the seed")
            time.sleep(0.05)
        leaf = RemoteClusterStore(r2addr, delta_watch=True,
                                  direct_routing=False,
                                  retry_attempts=NET_RETRIES)
        clients.append(leaf)
        rts = ReadTierStore(tap, leaf)
        t0 = time.perf_counter()
        cache, sched = net_scheduler(dev, rts)
        mirror_sync_ms = (time.perf_counter() - t0) * 1e3
        twin_store, twin_cache, twin = tree_twin(dev, leaf, cache, seed)
        ends = Endpoints({"router": addr, "r1": r1addr, "r2": r2addr,
                          **{f"worker{w['shard']}": w["endpoint"]
                             for w in pline["workers"]}})
        rows, twin_rows, lags = [], [], {1: [], 2: []}
        kill_worker, kill_replica = {}, {}

        def cycle(what, keys, pre_kill=None):
            tap.settle(leaf)
            if pre_kill is not None:
                pre_kill()
            lag = {d: replica_lag(a) for d, a in ((1, ends.named["r1"]),
                                                  (2, r2addr))} \
                if pre_kill is None else {}
            for d, v in lag.items():
                lags[d].append(v)
            before = ends.read() if pre_kill is None else None
            with KernelAudit() as kaudit:
                row = net_cycle(sched, what)
            row["t_end"] = time.perf_counter()
            if before is not None:
                row["store_requests"] = Endpoints.delta(before, ends.read())
            row["audit"] = kaudit.summary()
            if row["audit"]["launches_checked"] != row["launches"]:
                raise AssertionError(f"{what}: {row['launches']} launches, "
                                     f"{row['audit']} checked")
            trow = net_cycle(twin, what)
            mine = {k: cache.binder.nodes.get(k) for k in keys}
            theirs = {k: twin_cache.binder.nodes.get(k) for k in keys}
            if mine != theirs or None in mine.values():
                diff = [k for k in keys if mine[k] != theirs[k]]
                raise AssertionError(f"{what}: {len(diff)} binds differ "
                                     f"from the in-process twin or are "
                                     f"missing: {diff[:5]}")
            rows.append(row)
            twin_rows.append(trow)
            return row

        def kill_the_worker():
            k = sc["kill_worker"]
            w0 = _info(addr, "topology")["workers"][k]
            poll = RemoteClusterStore(addr, direct_routing=False,
                                      retry_attempts=NET_RETRIES)
            clients.append(poll)
            kill_worker.update(shard=k, pid=w0["pid"])
            kill_worker["t_kill"] = time.perf_counter()
            os.kill(w0["pid"], 9)

            def watch_ready():
                while time.perf_counter() - kill_worker["t_kill"] < 60:
                    w = poll._request({"op": "topology"})["workers"][k]
                    if w["alive"] and w["restarts"] > w0["restarts"]:
                        kill_worker["kill_to_ready_ms"] = (
                            time.perf_counter()
                            - kill_worker["t_kill"]) * 1e3
                        kill_worker["new_pid"] = w["pid"]
                        return
                    time.sleep(0.01)

            th = threading.Thread(target=watch_ready, daemon=True)
            th.start()
            kill_worker["thread"] = th

        def kill_the_replica():
            kill_replica["before"] = replica_lag(r2addr)["bootstraps"]
            kill_replica["fallbacks_before"] = rts.read_fallbacks
            port = int(ends.named["r1"].rpartition(":")[2])
            kill_replica["t_kill"] = time.perf_counter()
            children[1].kill()
            children[1] = Child("r1", ["--role", "replica", "--upstream",
                                       addr, "--port", str(port)])

        cycle("settle", [])
        for i in range(sc["waves"]):
            pgs, pods, names = cell.gangs_objs(sc["wave_jobs"])
            feed_tree(tap, leaf, twin_store, (pgs, pods))
            keys = [k for g in names for k in cell.gangs[g]]
            if i == sc["kill_worker_wave"]:
                row = cycle(f"wave {i}", keys, kill_the_worker)
                kill_worker.pop("thread").join(timeout=60)
                if "kill_to_ready_ms" not in kill_worker:
                    raise AssertionError("the killed shard worker did not "
                                         "come back in 60 s")
                k = sc["kill_worker"]
                info = _info(pline["workers"][k]["endpoint"], "store_info")
                kill_worker.update(
                    recovered_records=info.get("recovered"),
                    kill_to_next_cycle_end_ms=(
                        row["t_end"] - kill_worker.pop("t_kill")) * 1e3,
                    first_cycle={x: row.get(x) for x in (
                        "cycle_ms", "flatten_mode", "arena_full_ship",
                        "arena_bytes_shipped", "binds", "bind_write_ms")})
            elif i == sc["kill_replica_wave"]:
                row = cycle(f"wave {i}", keys, kill_the_replica)
                r1line = children[1].first()
                tap.settle(leaf)
                kill_replica.update(
                    caught_up_ms=(time.perf_counter()
                                  - kill_replica.pop("t_kill")) * 1e3,
                    restarted_bootstraps=r1line["bootstraps"],
                    restarted_catch_up_ms=r1line["catch_up_ms"],
                    leaf_bootstraps={
                        r: n - kill_replica["before"].get(r, 0)
                        for r, n in replica_lag(r2addr)["bootstraps"]
                        .items() if n - kill_replica["before"].get(r, 0)},
                    fallbacks=rts.read_fallbacks
                    - kill_replica.pop("fallbacks_before"),
                    cycle={x: row.get(x) for x in (
                        "cycle_ms", "flatten_mode", "binds",
                        "bind_write_ms")})
                kill_replica.pop("before")
            else:
                cycle(f"wave {i}", keys)
        tap.settle(leaf)
        # the audit: every wave pod bound once, across both lives of the
        # killed worker; the store's pods equal the binds
        binds = store_pod_binds(primary)
        wave_binds = dict(cache.binder.nodes)
        if any(binds.get(k) != n for k, n in wave_binds.items()):
            raise AssertionError("the primary's pods differ from the binds "
                                 "the scheduler wrote")
        t0 = time.perf_counter()
        while True:
            per_pod: dict = {}
            for rec in read_audit(audit_path):
                if rec["ev"] == "bind":
                    per_pod[rec["pod"]] = per_pod.get(rec["pod"], 0) + 1
            if set(per_pod) >= set(wave_binds) \
                    or time.perf_counter() - t0 > 30:
                break
            time.sleep(0.1)
        dups = {k: n for k, n in per_pod.items() if n != 1}
        if dups or set(per_pod) != set(wave_binds) \
                or max(cache.binder.count.values()) != 1:
            raise AssertionError(f"pods bound more than once or unaudited: "
                                 f"{list(dups)[:5]}, "
                                 f"{len(per_pod)} audited of "
                                 f"{len(wave_binds)}")
        cell.check("netshard", binds)
        tree = tree_lists(addr, {"r1": ends.named["r1"], "r2": r2addr})
        boots = {name: replica_lag(a)["bootstraps"]
                 for name, a in (("r1", ends.named["r1"]), ("r2", r2addr))}
        if any(b.get("apply_gap") for b in boots.values()):
            raise AssertionError(f"a replica met a record gap: {boots}")
        # the leaf served the reads; the primary saw only PRIMARY_KINDS
        # and the counted fallbacks
        stray = {f"{op} {kind}": n for (op, kind), n in tap.reads.items()
                 if kind not in PRIMARY_KINDS}
        if rts.reads_replica <= 0 or any(op.startswith("watch")
                                         for op in stray) \
                or sum(stray.values()) != rts.read_fallbacks:
            raise AssertionError(
                f"the scheduler read the primary past the read tier: "
                f"{stray}, fallbacks {rts.read_fallbacks}, replica reads "
                f"{rts.reads_replica}")
        skip = {sc["kill_worker_wave"] + 1, sc["kill_replica_wave"] + 1}
        steady = [r for i, r in enumerate(rows) if i and i not in skip]
        tsteady = [r for i, r in enumerate(twin_rows) if i and i not in skip]
        wave_rows = rows[1:]
        reqs = {}
        for r in steady:
            for name, d in r["store_requests"].items():
                reqs.setdefault(name, []).append(sum(d.values()))
        ns_steady = None
        ns_bind = None
        if netstore:
            ns_steady = netstore["steady_p50_ms"]
            # its steady waves: past the first after the burst, the store
            # restart's left out
            ns_w = [r for i, r in enumerate(netstore["waves"])
                    if i not in (0, netstore["restart_wave"])]
            ns_bind = sum(r["bind_write_ms"] for r in ns_w) \
                / max(sum(r["binds"] for r in ns_w), 1)
        bound = [r for r in wave_rows if r["binds"]]
        out = {
            "phase": "netshard", "nodes": sc["n_nodes"],
            "shards": sc["shards"], "pods_bound": len(binds),
            "wave_binds": len(wave_binds), "twin_equal": True, "lost": 0,
            "duplicates": 0, "seed_objects": sum(len(x) for x in seed),
            "seed_ms": seed_ms, "mirror_sync_ms": mirror_sync_ms,
            "steady_p50_ms": statistics.median(r["cycle_ms"]
                                               for r in steady),
            "steady_max_ms": max(r["cycle_ms"] for r in steady),
            "twin_steady_p50_ms": statistics.median(r["cycle_ms"]
                                                    for r in tsteady),
            "twin_steady_max_ms": max(r["cycle_ms"] for r in tsteady),
            "netstore_steady_p50_ms": ns_steady,
            "bind_write_ms_per_bind": sum(r["bind_write_ms"]
                                          for r in bound)
            / max(sum(r["binds"] for r in bound), 1),
            "netstore_bind_write_ms_per_bind": ns_bind,
            "direct_requests": primary.direct_requests,
            "direct_fallbacks": primary.direct_fallbacks,
            "store_requests_per_cycle_p50": {
                name: statistics.median(v) for name, v in reqs.items()},
            "store_requests_by_op": [r["store_requests"] for r in steady],
            "lag_at_cycle_start": {
                f"depth{d}": {
                    "records_p50": _pct([x["records"] for x in v
                                         if x["records"] is not None], 50),
                    "records_p99": _pct([x["records"] for x in v
                                         if x["records"] is not None], 99),
                    "seconds_p50": _pct([x["seconds"] for x in v
                                         if x["seconds"] is not None], 50),
                    "seconds_p99": _pct([x["seconds"] for x in v
                                         if x["seconds"] is not None], 99),
                    "samples": len(v)} for d, v in lags.items()},
            "reads_replica": rts.reads_replica,
            "read_fallbacks": rts.read_fallbacks,
            "primary_reads": {f"{op} {kind}": n
                              for (op, kind), n in tap.reads.items()},
            "worker_kill": {**kill_worker,
                            "wave": sc["kill_worker_wave"]},
            "replica_kill": {**kill_replica,
                             "wave": sc["kill_replica_wave"]},
            "bootstraps": boots, "tree": tree,
            "waves": [{k: v for k, v in r.items()
                       if k not in ("t_end", "store_requests")}
                      for r in wave_rows],
            "launches": sum(r["launches"] for r in rows),
            "twin_launches": sum(r["launches"] for r in twin_rows),
            "seconds": time.perf_counter() - t_phase}
        emit(out)
        return out
    finally:
        for client in clients:
            client.close()
        for child in children:
            child.kill()
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)


# -- the simulator (sim/), vcctl and the standalone control plane -----------

#: bench.py sim_quality()'s workload, not cut: seed 123, 500 cycles and a
#: drain of 100, 22 nodes of 32 cpu, 4.0 arrivals a cycle, gangs of 2-5,
#: durations 5-40, queues 1:2:3 (6710 pods)
SIM = dict(seed=123, cycles=500, drain=100, nodes=22, node_cpu="32",
           arrival_rate=4.0, gang_min=2, gang_max=5, duration_min=5,
           duration_max=40, queues=(("q0", 1), ("q1", 2), ("q2", 3)))
#: bench.py reschedule_defrag()'s A/B: the fragmented preset, 500 cycles on
#: 9 nodes, seed 7, a defrag pass every 5 cycles, 8 moves, 2 a job, the
#: binpack conf in both arms
SIM_FRAG = dict(seed=7, cycles=500, nodes=9,
                knobs={"interval": 5, "max_moves": 8,
                       "max_disruption_per_job": 2})
#: the vcctl sim child: `vcctl sim` at these flags against run_sim in
#: process on the same arguments
SIM_CLI = dict(cycles=100, seed=123, nodes=22, rate=4.0)
SIM_SCORE_KEYS = ("wait_mean", "wait_p99", "utilization_mean",
                  "jfi_queues", "preemption_churn", "pods_bound",
                  "jobs_completed")


def sim_workload(sc):
    from volcano_tpu_torch.sim import Workload, WorkloadSpec
    return Workload(WorkloadSpec(**{k: sc[k] for k in (
        "seed", "cycles", "nodes", "node_cpu", "arrival_rate", "gang_min",
        "gang_max", "duration_min", "duration_max", "queues")}))


class SimTicks:
    """Times every VirtualCluster.tick run inside it (the entry points
    stay run_sim / verify) and reads each cycle's launches and timing:
    the first cycle (the kernel library's load), the cycles that shipped
    the whole arena (a new layout bucket) and the delta cycles past
    them, apart. Fails on a cycle that left the device path."""

    def __enter__(self):
        from volcano_tpu_torch.ops import fused_choice as fc
        from volcano_tpu_torch.sim import virtualcluster as vcm
        self._vcm, self._fc = vcm, fc
        self._orig = vcm.VirtualCluster.tick
        self.rows = []
        orig, rows = self._orig, self.rows

        def tick(vc):
            before = fc.fused_choice.launches
            t0 = time.perf_counter()
            line = orig(vc)
            t = vc.sched.last_cycle_timing
            rows.append({"ms": (time.perf_counter() - t0) * 1e3,
                         "launches": fc.fused_choice.launches - before,
                         "full_ship": float(t.get("arena_full_ship", 0.0)),
                         "error": t.get("allocate_error"),
                         "fallback": t.get("host_fallback")})
            return line

        vcm.VirtualCluster.tick = tick
        return self

    def __exit__(self, *exc):
        self._vcm.VirtualCluster.tick = self._orig

    def summary(self, on_card: bool) -> dict:
        rows = self.rows
        bad = [r for r in rows if r["error"] or r["fallback"]]
        if on_card and bad:
            raise AssertionError(f"a sim cycle left the device path: "
                                 f"{bad[0]}")
        steady = [r["ms"] for r in rows[1:] if not r["full_ship"]]
        ships = [r["ms"] for r in rows[1:] if r["full_ship"]]
        return {"cycles": len(rows),
                "launches": sum(r["launches"] for r in rows),
                "first_cycle_ms": rows[0]["ms"] if rows else None,
                "full_ship_cycles": len(ships),
                "full_ship_ms_max": max(ships, default=None),
                "cycle_ms_p50": statistics.median(steady)
                if steady else None,
                "cycle_ms_max": max(steady, default=None)}


def sim_arm(dev, arm: str, mode: str, cycles=None, record=None,
            golden=None) -> dict:
    """One arm of the sim phase through run_sim (or verify against
    ``golden``, a trace path) on ``dev``, over SIM's workload, for SIM's
    cycles and drain or the first ``cycles`` cycles: its score, digest,
    wall s, cycle times and launches, counted from 0 at its start."""
    from volcano_tpu_torch.ops import fused_choice as fc
    from volcano_tpu_torch.sim import run_sim, verify
    sc = SIM if cycles is None else dict(SIM, cycles=cycles, drain=0)
    wl = sim_workload(SIM)
    on_card = torch.device(dev).type == "cuda"
    fc.fused_choice.launches = 0
    t0 = time.perf_counter()
    with SimTicks() as ticks:
        if golden is not None:
            res = verify(golden, workload=wl, cycles=sc["cycles"],
                         mode=mode, drain=sc["drain"], device=dev)
            out = {"verify_ok": res["ok"], "digest": res["digest"],
                   "divergence": res["divergence"]}
        else:
            r = run_sim(workload=wl, cycles=sc["cycles"], mode=mode,
                        drain=sc["drain"], device=dev, record_path=record)
            out = {"digest": r.digest,
                   "score": {k: r.score[k] for k in SIM_SCORE_KEYS},
                   "conservation_balanced":
                       r.vc.conservation()["balanced"]}
    launches = fc.fused_choice.launches
    row = {"phase": "sim", "arm": arm, "mode": mode,
           "device": str(torch.device(dev)), "pods": wl.total_pods,
           **out, "wall_s": time.perf_counter() - t0,
           **ticks.summary(on_card)}
    if row["launches"] != launches:
        raise AssertionError(f"sim {arm}: a launch escaped the cycles")
    if on_card and mode != "host" and launches <= 0:
        raise AssertionError(f"sim {arm}: no kernel launch on the card")
    return row


def sim_frag(dev) -> dict:
    """bench.py reschedule_defrag()'s A/B on ``dev``: the golden arm (no
    rescheduler) and the reschedule arm on the fragmented preset, both on
    the binpack conf. Checks that the rescheduler migrated, kept every
    plan within the move budget and the per-job cap, and executed only
    plans that project a fragmentation improvement; reports the
    reference's trio (utilization up, fragmentation down, wait p99 no
    worse) and each arm's digest, which phase_sim holds to the plain
    route's. The trio is reported, not required: on this workload the
    JAX package misses it too (its reschedule arm raises the
    fragmentation index and the wait p99), so it is no property of the
    code both packages share."""
    from volcano_tpu_torch.ops import fused_choice as fc
    from volcano_tpu_torch.sim import run_sim
    from volcano_tpu_torch.sim.virtualcluster import BINPACK_CONF
    from volcano_tpu_torch.sim.workload import fragmented_workload
    sc, knobs = SIM_FRAG, SIM_FRAG["knobs"]
    out, runs = {"phase": "sim", "arm": "fragmented"}, {}
    fc.fused_choice.launches = 0
    for arm, resched in (("golden", None), ("reschedule", knobs)):
        t0 = time.perf_counter()
        with SimTicks() as ticks:
            runs[arm] = run_sim(
                workload=fragmented_workload(seed=sc["seed"],
                                             cycles=sc["cycles"],
                                             nodes=sc["nodes"]),
                cycles=sc["cycles"], scheduler_conf=BINPACK_CONF,
                reschedule=resched, device=dev)
        s = runs[arm].score
        out[arm] = {"wall_s": time.perf_counter() - t0,
                    **{k: s[k] for k in (
                        "utilization_mean", "fragmentation_index",
                        "wait_p99", "migrations", "migration_churn")},
                    **ticks.summary(torch.device(dev).type == "cuda")}
    g, r = runs["golden"].score, runs["reschedule"].score
    plans = runs["reschedule"].vc.cache.reschedule_log
    executed = [p for p in plans if p["rejected"] is None]
    out["plans"] = {"built": len(plans), "executed": len(executed),
                    "moves_executed": int(sum(p["executed"]
                                              for p in executed))}
    out["trio"] = {
        "utilization_up": r["utilization_mean"] > g["utilization_mean"],
        "fragmentation_down": r["fragmentation_index"]
        < g["fragmentation_index"],
        "wait_p99_no_worse": r["wait_p99"] <= g["wait_p99"]}
    out["bounds"] = {
        "budget_respected": all(p["selected"] <= knobs["max_moves"]
                                for p in plans),
        "caps_respected": all(p["max_disruption"]
                              <= knobs["max_disruption_per_job"]
                              for p in plans),
        "executed_plans_improve": all(p["frag_after"] < p["frag_before"]
                                      for p in executed),
        "migrated": r["migrations"] > 0}
    out["digests"] = {arm: runs[arm].digest for arm in runs}
    out["launches"] = fc.fused_choice.launches
    if not all(out["bounds"].values()):
        raise AssertionError(f"the fragmented A/B's rescheduler broke a "
                             f"bound on {dev}: {out}")
    return out


#: the arms of the sim phase that run as children: mode, device ("card"
#: or the plain route's "cpu") and cycles (None: SIM's, with its drain).
#: The plain route's sharded solve takes ~1.5 s a cycle on the host, so
#: its arm covers the first 100 cycles, which the card's sharded arm must
#: reproduce (a cycle's record depends only on the events before it)
SIM_ARMS = {"solver": ("solver", "card", None),
            "sharded": ("sharded", "card", None),
            "host": ("host", "card", None),
            "solver_cpu": ("solver", "cpu", None),
            "sharded_cpu": ("sharded", "cpu", 100),
            "fragmented": (None, "card", None),
            "fragmented_cpu": (None, "cpu", None)}


def role_simarm(args) -> int:
    """``--role simarm --arm NAME``: one arm of the sim phase (SIM_ARMS)
    in its own process, its trace under ``--data-dir``; one JSON line."""
    torch.set_num_threads(1)
    line = device_line("simarm", arm=args.arm)
    print(json.dumps(line), flush=True)
    mode, where, cycles = SIM_ARMS[args.arm]
    dev = torch.device("cuda", 0) if where == "card" else "cpu"
    if mode is None:
        out = sim_frag(dev)
    else:
        out = sim_arm(dev, args.arm, mode, cycles=cycles,
                      record=os.path.join(args.data_dir,
                                          f"{args.arm}.jsonl"))
    print(json.dumps({"arm_done": args.arm, **out}), flush=True)
    return 0


def sim_cli_child(dev) -> dict:
    """``python -m volcano_tpu_torch.cli sim`` on the card (no --device:
    the CUDA device) beside run_sim in process on the same arguments:
    the same digest."""
    from volcano_tpu_torch.ops import fused_choice as fc
    from volcano_tpu_torch.sim import WorkloadSpec, run_sim
    c = SIM_CLI
    argv = [sys.executable, "-m", "volcano_tpu_torch.cli", "sim",
            "--cycles", str(c["cycles"]), "--seed", str(c["seed"]),
            "--nodes", str(c["nodes"]), "--rate", str(c["rate"]),
            "--mode", "solver"]
    env = dict(os.environ, PYTHONHASHSEED="0")
    proc = subprocess.Popen(argv, cwd=REPO, env=env, text=True,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)
    fc.fused_choice.launches = 0
    r = run_sim(spec=WorkloadSpec(seed=c["seed"], cycles=c["cycles"],
                                  nodes=c["nodes"],
                                  arrival_rate=c["rate"]),
                cycles=c["cycles"], mode="solver", device=dev)
    launches = fc.fused_choice.launches
    out, _ = proc.communicate(timeout=CHILD_TIMEOUT_S)
    if proc.returncode != 0:
        raise AssertionError(f"vcctl sim exited {proc.returncode}:\n"
                             + out[-3000:])
    got = [ln.split()[-1] for ln in out.splitlines()
           if ln.startswith("digest: ")]
    if got != [r.digest]:
        raise AssertionError(f"vcctl sim's digest {got} != run_sim's "
                             f"{r.digest}")
    return {"phase": "sim", "arm": "vcctl_child", "argv": argv[1:],
            "digest": r.digest, "identical_to_in_process": True,
            "in_process_launches": launches}


class SimPhase:
    """The simulator on the card, in two halves so that the standalone
    phase runs while the card verifies the trace. ``start``: every arm of
    SIM_ARMS a child process at once; meanwhile this process runs the
    vcctl child beside its in-process twin, waits for the plain route's
    solver trace (the first to finish), then starts verify of it on the
    card as one more child (``--role simverify``). ``finish``: waits for
    every child and checks that the card's solver trace equals the plain
    route's byte for byte (so verify on the card replays the card's own
    recorded trace), that verify passed, the card's sharded trace the
    plain route's sharded prefix and each fragmented arm the plain
    route's. The solver and sharded arms' digests are reported side by
    side, not required equal: at this load the solve reaches its 64-round
    cap, and the sharded solve spends rounds differently (every phase at
    least one round), in the JAX package as in the port."""

    def __init__(self, dev):
        import tempfile
        self.dev = dev
        os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
        self.tmp = tempfile.mkdtemp(prefix="sim-",
                                    dir=os.path.join(REPO, "build"))
        self.children: dict = {}
        self.got: dict = {}

    def _child(self, arm: str, role: str = "simarm") -> None:
        self.children[arm] = Child(f"sim-{arm}", [
            "--role", role, "--arm", arm, "--data-dir", self.tmp])
        self.children[arm].first()

    def _done(self, arm: str) -> dict:
        if arm not in self.got:
            self.got[arm] = self.children[arm].wait_for(
                lambda x: x.get("arm_done") == arm, 6 * CHILD_TIMEOUT_S,
                f"the {arm} arm")
            emit(self.got[arm])
        return self.got[arm]

    def start(self) -> "SimPhase":
        try:
            for arm in SIM_ARMS:
                self._child(arm)
            self.cli = sim_cli_child(self.dev)
            emit(self.cli)
            self._done("solver_cpu")
            self._child("verify", role="simverify")
        except BaseException:
            self.kill()
            raise
        return self

    def kill(self) -> None:
        for child in self.children.values():
            child.kill()

    def trace(self, arm: str) -> list:
        from volcano_tpu_torch.sim.replay import load_trace
        return load_trace(os.path.join(self.tmp, f"{arm}.jsonl"))

    def finish(self) -> dict:
        from volcano_tpu_torch.sim.replay import first_divergence
        try:
            for arm in self.children:
                self._done(arm)
        finally:
            self.kill()
        got = self.got
        for card, plain in (("solver", "solver_cpu"),
                            ("sharded", "sharded_cpu")):
            want = self.trace(plain)
            div = first_divergence(want, self.trace(card)[:len(want)])
            if div is not None:
                raise AssertionError(f"the card's {card} trace differs "
                                     f"from the plain route's: "
                                     f"{json.dumps(div)[:2000]}")
        if not got["verify"]["verify_ok"]:
            raise AssertionError(f"verify of the card's trace on the card "
                                 f"failed: {got['verify']['divergence']}")
        if got["fragmented"]["digests"] != got["fragmented_cpu"]["digests"]:
            raise AssertionError("the fragmented A/B decided unlike the "
                                 "plain route on the card")
        split = first_divergence(self.trace("solver"),
                                 self.trace("sharded"))
        launches = (sum(got[a]["launches"] for a in (
            "solver", "sharded", "fragmented", "verify"))
            + self.cli["in_process_launches"])
        import shutil
        shutil.rmtree(self.tmp, ignore_errors=True)
        out = {"phase": "sim", "regime": "summary",
               "solver_digest": got["solver"]["digest"],
               "sharded_digest": got["sharded"]["digest"],
               "card_equals_plain": True,
               "sharded_equals_plain_prefix": SIM_ARMS["sharded_cpu"][2],
               "verify_on_card": True,
               "solver_vs_sharded_first_divergence":
                   None if split is None else split["cycle"],
               "fragmented_equals_plain": True,
               "fragmented_trio": got["fragmented"]["trio"],
               "launches": launches}
        emit(out)
        return out


def role_simverify(args) -> int:
    """``--role simverify``: verify on the card of the plain route's
    solver trace (``--data-dir``/solver_cpu.jsonl), which phase_sim holds
    equal to the card's own; one JSON line."""
    torch.set_num_threads(1)
    print(json.dumps(device_line("simverify", arm="verify")), flush=True)
    out = sim_arm(torch.device("cuda", 0), "verify", "solver",
                  golden=os.path.join(args.data_dir, "solver_cpu.jsonl"))
    print(json.dumps({"arm_done": "verify", **out}), flush=True)
    return 0


#: the standalone phase (a): bench.py full_cycle()'s cell, not cut (2000
#: nodes of 32 cpu / 128Gi, queues 1:2:3, 1000 vcjobs of 10 pods at cpu
#: 1 + (k // 3) % 3 and 1-4Gi), the first ``gpu_nodes`` of the nodes also
#: carrying two 8-unit GPU cards (tests/test_gpu_sharing.py's gpu_node)
#: and a NoSchedule taint that only the GPU jobs tolerate, as GPU pools
#: are kept; ``host_only`` jobs of each host-only kind (required pod
#: affinity, a PVC claim, a shared GPU) in the burst, then ``waves`` waves
#: of ``wave_jobs`` vcjobs and one host-only job while ``complete``
#: Running jobs finish. Half the host-only jobs rank above the solver
#: jobs and half below, so both host passes of allocate (before the
#: device solve and after it) have work
STANDALONE = dict(n_nodes=CYCLE["n_nodes"], n_jobs=CYCLE["n_jobs"],
                  tasks_per_job=10, gpu_nodes=20, host_only=20, waves=12,
                  wave_jobs=10, complete=10, max_turns=8)
STANDALONE_CONF = """
actions: "enqueue, allocate, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
- plugins:
  - name: drf
  - name: predicates
    arguments:
      predicate.GPUSharingEnable: true
  - name: proportion
  - name: nodeorder
"""
HOST_ONLY_KINDS = ("affinity", "pvc", "gpu")
SA_TIMING_KEYS = ("open_ms", "enqueue_ms", "allocate_ms", "order_ms",
                  "flatten_ms", "flatten_mode", "dispatch_ms", "replay_ms",
                  "backfill_ms", "close_ms", "arena_full_ship",
                  "arena_bytes_shipped")


def vcjob_yaml(name: str, ns: str, queue: str, replicas: int, cpu: int,
               mem_gi: int, priority: str = "", labels=None,
               affinity_to: str = "", gpu_mem: int = 0) -> str:
    """A vcjob's YAML as a user submits it: one task of ``replicas``
    pods, minAvailable = replicas, collected when finished; optionally a
    priority class, required pod affinity to pods labelled
    ``app: <affinity_to>`` and a shared-GPU memory limit (with the GPU
    nodes' taint tolerated)."""
    lines = ["apiVersion: batch.volcano.sh/v1alpha1", "kind: Job",
             f"metadata: {{name: {name}, namespace: {ns}}}", "spec:",
             f"  minAvailable: {replicas}", f"  queue: {queue}",
             "  ttlSecondsAfterFinished: 0"]
    if priority:
        lines.append(f"  priorityClassName: {priority}")
    lines += ["  tasks:", "  - name: worker", f"    replicas: {replicas}",
              "    template:"]
    if labels:
        lines.append("      metadata: {labels: {%s}}" % ", ".join(
            f"{k}: {v}" for k, v in labels.items()))
    lines.append("      spec:")
    if gpu_mem:
        lines += ["        tolerations:", "        - {key: nvidia.com/gpu, "
                  "operator: Exists, effect: NoSchedule}"]
    if affinity_to:
        lines += ["        affinity:", "          podAffinity:",
                  "            requiredDuringSchedulingIgnoredDuringExecution:",
                  "            - labelSelector:",
                  f"                matchLabels: {{app: {affinity_to}}}",
                  "              topologyKey: kubernetes.io/hostname"]
    lines += ["        containers:", "        - name: c",
              f"          requests: {{cpu: \"{cpu}\", memory: {mem_gi}Gi}}"]
    if gpu_mem:
        lines.append(f"          limits: {{volcano.sh/gpu-memory: "
                     f"{gpu_mem}}}")
    return "\n".join(lines) + "\n"


class StandaloneWorld:
    """The whole control plane in one process: ``Standalone(device=dev,
    metrics_port=0)`` (admission, the ControllerManager, the Scheduler,
    async bind effectors, the metrics server) at STANDALONE's cell. vcjobs
    go in as YAML through ``apply_job_yaml``. A PVC job is a podgroup
    whose two pods each name their own claim (the job controller, in
    both packages, does not carry a template's volumes onto its pods).
    Records every bind per turn, each turn's controllers and cycle ms,
    and which host-only jobs each host pass of allocate placed: ``pre``
    (jobs that outrank every solver job, before the device solve) and
    ``post`` (after it)."""

    NS = "bench"

    def __init__(self, dev, sc):
        from volcano_tpu_torch.api import POD_GROUP_ANNOTATION
        from volcano_tpu_torch.cache import RecordingBinder
        from volcano_tpu_torch.framework import get_action
        from volcano_tpu_torch.models import (
            Node, PriorityClass, Queue, QueueSpec,
        )
        from volcano_tpu_torch.standalone import Standalone
        self.sc, self.ann = sc, POD_GROUP_ANNOTATION
        self.sa = Standalone(scheduler_conf=STANDALONE_CONF,
                             metrics_port=0, device=dev)
        self.store = self.sa.store
        self.on_card = self.sa.cache.device.type == "cuda"
        self.turn_binds: list = []
        self.turn_jobs: set = set()
        self.bound: dict = {}
        self.rebound: list = []
        self.sa.cache.binder = RecordingBinder(self.sa.cache.binder,
                                               on_bind=self._on_bind)
        for i in range(3):
            self.store.create("queues", Queue(name=f"q{i}",
                                              spec=QueueSpec(weight=i + 1)))
        self.store.create("priorityclasses", PriorityClass("high", 1000))
        self.store.create("priorityclasses", PriorityClass("low", -1000))
        rl = {"cpu": "32", "memory": "128Gi", "pods": "110"}
        gpu = dict(rl, **{"volcano.sh/gpu-memory": 16,
                          "volcano.sh/gpu-number": 2})
        taint = [{"key": "nvidia.com/gpu", "value": "present",
                  "effect": "NoSchedule"}]
        self.store.bulk_apply([
            ("nodes", Node(name=f"n{i}", allocatable=dict(
                gpu if i < sc["gpu_nodes"] else rl),
                capacity=dict(gpu if i < sc["gpu_nodes"] else rl),
                taints=list(taint) if i < sc["gpu_nodes"] else []))
            for i in range(sc["n_nodes"])])
        self.k = 0
        self.h = 0
        self.kind_of: dict = {}     # job name -> solver / host-only kind
        self.prio_of: dict = {}
        self.running: list = []     # solver jobs Running, oldest first
        self.passes = {"pre": set(), "post": set()}
        self.turns: list = []
        act = get_action("allocate")
        self._act = act
        orig_host, orig_solver = act._execute_host, act._execute_solver
        state = {"in_solver": False}

        def execute_solver(ssn, *a, **kw):
            state["in_solver"] = True
            try:
                return orig_solver(ssn, *a, **kw)
            finally:
                state["in_solver"] = False

        def execute_host(ssn, only_jobs=None):
            if only_jobs is not None:
                names = {ssn.jobs[u].name for u in only_jobs
                         if u in ssn.jobs}
                self._pass_jobs["pre" if state["in_solver"]
                                else "post"] |= names
            return orig_host(ssn, only_jobs=only_jobs)

        act._execute_solver, act._execute_host = execute_solver, \
            execute_host
        self._pass_jobs = {"pre": set(), "post": set()}

    def close(self) -> None:
        for name in ("_execute_solver", "_execute_host"):
            self._act.__dict__.pop(name, None)
        self.sa.stop()

    def _on_bind(self, pod, hostname) -> None:
        key = f"{pod.namespace}/{pod.name}"
        if key in self.bound:
            self.rebound.append(key)
        self.bound[key] = hostname
        self.turn_binds.append((pod.name, hostname))
        self.turn_jobs.add(pod.annotations.get(self.ann, ""))

    def submit_solver(self, n: int) -> list:
        names = []
        for _ in range(n):
            k = self.k
            self.k += 1
            name = f"vj{k}"
            self.sa.apply_job_yaml(vcjob_yaml(
                name, self.NS, f"q{k % 3}", self.sc["tasks_per_job"],
                1 + (k // 3) % 3, 1 + k % 4, labels={"app": name}))
            self.kind_of[name] = "solver"
            names.append(name)
        return names

    def submit_host_only(self, kind: str, high: bool,
                         anchor: str) -> str:
        """One host-only job: ``affinity`` (2 pods that must share a node
        with a pod of ``anchor``), ``pvc`` (a podgroup of 2 pods, each
        with its own claim) or ``gpu`` (2 pods of 4 GPU-memory units)."""
        from volcano_tpu_torch.models import (
            PersistentVolumeClaim, Pod, PodGroup, PodGroupSpec,
        )
        h = self.h
        self.h += 1
        name, queue = f"{kind}{h}", f"q{h % 3}"
        prio = "high" if high else "low"
        if kind == "pvc":
            for i in range(2):
                claim = f"{name}-claim-{i}"
                self.store.create("pvcs", PersistentVolumeClaim(
                    name=claim, namespace=self.NS))
                self.store.create("pods", Pod(
                    name=f"{name}-{i}", namespace=self.NS,
                    annotations={self.ann: name},
                    priority_class_name=prio,
                    containers=[{"name": "c", "requests": {
                        "cpu": "1", "memory": "1Gi"}}],
                    volumes=[{"name": "data", "persistentVolumeClaim": {
                        "claimName": claim}}]))
            self.store.create("podgroups", PodGroup(
                name=name, namespace=self.NS,
                spec=PodGroupSpec(min_member=2, queue=queue,
                                  priority_class_name=prio)))
        else:
            self.sa.apply_job_yaml(vcjob_yaml(
                name, self.NS, queue, 2, 1, 1, priority=prio,
                affinity_to=anchor if kind == "affinity" else "",
                gpu_mem=4 if kind == "gpu" else 0))
        self.kind_of[name] = kind
        self.prio_of[name] = prio
        return name

    def turn(self) -> dict:
        """One Standalone.run_once, the kernel's count set to 0 just
        before and read just after; its controllers' and cycle's ms."""
        from volcano_tpu_torch.ops import fused_choice as fc
        sa = self.sa
        spent = {"controllers_ms": 0.0, "cycle_ms": 0.0}
        pm, ro = sa.controllers.process_all, sa.scheduler.run_once

        def timed(key, fn):
            def run(*a, **kw):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    spent[key] += (time.perf_counter() - t0) * 1e3
            return run

        sa.controllers.process_all = timed("controllers_ms", pm)
        sa.scheduler.run_once = timed("cycle_ms", ro)
        self.turn_binds, self.turn_jobs = [], set()
        self._pass_jobs = {"pre": set(), "post": set()}
        fc.fused_choice.launches = 0
        t0 = time.perf_counter()
        try:
            sa.run_once()
        finally:
            del sa.controllers.process_all, sa.scheduler.run_once
        t = sa.scheduler.last_cycle_timing
        if t.get("allocate_error") or t.get("host_fallback"):
            raise AssertionError(f"a standalone turn left the device "
                                 f"path: {t}")
        host_bound = {p: sorted(self._pass_jobs[p] & self.turn_jobs)
                      for p in ("pre", "post")}
        for p in host_bound:
            self.passes[p] |= set(host_bound[p])
        row = {"turn": len(self.turns),
               "turn_ms": (time.perf_counter() - t0) * 1e3, **spent,
               "launches": fc.fused_choice.launches,
               "binds": len(self.turn_binds),
               "host_only_bound": host_bound,
               **{k: t[k] for k in SA_TIMING_KEYS if k in t}}
        if self.on_card and row["binds"] > len(
                host_bound["pre"] + host_bound["post"]) * 2 \
                and row["launches"] <= 0:
            raise AssertionError(f"a standalone turn bound solver pods "
                                 f"without a kernel launch: {row}")
        self.turns.append((row, sorted(self.turn_binds)))
        return row

    def pending(self, names) -> list:
        """The jobs of ``names`` not yet Running (a PVC job: not every
        pod bound)."""
        jobs = {j.name: j for j in self.store.list("jobs",
                                                   namespace=self.NS)}
        out = []
        for name in names:
            if self.kind_of[name] == "pvc":
                pods = [p for p in self.store.list("pods",
                                                   namespace=self.NS)
                        if p.annotations.get(self.ann) == name]
                if len(pods) < 2 or not all(p.node_name for p in pods):
                    out.append(name)
            else:
                j = jobs.get(name)
                if j is None or j.status.state.phase.value != "Running":
                    out.append(name)
        return out

    def converge(self, names, what: str) -> dict:
        t0 = time.perf_counter()
        rows = []
        while self.pending(names):
            if len(rows) == self.sc["max_turns"]:
                left = self.pending(names)
                raise AssertionError(f"standalone {what}: {len(left)} jobs "
                                     f"not Running after {len(rows)} "
                                     f"turns: {left[:8]}")
            rows.append(self.turn())
        if self.rebound:
            raise AssertionError(f"standalone {what}: pods bound twice: "
                                 f"{self.rebound[:5]}")
        return {"turns": len(rows),
                "all_running_ms": (time.perf_counter() - t0) * 1e3,
                "rows": rows}

    def complete(self, n: int) -> list:
        done, self.running = self.running[:n], self.running[n:]
        for name in done:
            for p in self.store.list("pods", namespace=self.NS):
                if p.annotations.get(self.ann) == name:
                    p.phase = "Succeeded"
                    self.store.update("pods", p)
        return done


def standalone_run(dev, sc) -> dict:
    """The standalone script on ``dev``: the burst (1000 vcjobs and the
    host-only mix) turned until every job runs, then the waves."""
    w = StandaloneWorld(dev, sc)
    try:
        t0 = time.perf_counter()
        solver = w.submit_solver(sc["n_jobs"])
        host = [w.submit_host_only(kind, i % 2 == 0, f"vj{i}")
                for kind in HOST_ONLY_KINDS
                for i in range(sc["host_only"])]
        submit_ms = (time.perf_counter() - t0) * 1e3
        burst = w.converge(solver + host, "burst")
        burst["submit_ms"] = submit_ms
        burst["submission_to_all_running_ms"] = \
            (time.perf_counter() - t0) * 1e3
        w.running = list(solver)
        waves = []
        for i in range(sc["waves"]):
            done = w.complete(sc["complete"])
            new = w.submit_solver(sc["wave_jobs"])
            kind = HOST_ONLY_KINDS[i % 3]
            new.append(w.submit_host_only(kind, i % 2 == 0,
                                          w.running[0]))
            row = w.converge(new, f"wave {i}")
            row.update(wave=i, completed=len(done), kind=kind)
            waves.append(row)
            w.running += [n for n in new if w.kind_of[n] == "solver"]
        return {"burst": burst, "waves": waves,
                "turn_binds": [b for _, b in w.turns],
                "passes": {p: len(v) for p, v in w.passes.items()},
                "pass_kinds": {p: sorted({w.kind_of[n] for n in v})
                               for p, v in w.passes.items()},
                "jobs": w.k, "host_only_jobs": w.h,
                "pods_bound": len(w.bound),
                "launches": sum(r["launches"] for r, _ in w.turns)}
    finally:
        w.close()


def role_standalonetwin(args) -> int:
    """``--role standalonetwin``: the standalone script on device="cpu"
    (the plain route) at STANDALONE updated by ``--scale``; its per-turn
    binds to ``--data-dir``/twin.json."""
    torch.set_num_threads(1)
    print(json.dumps(device_line("standalonetwin")), flush=True)
    res = standalone_run("cpu", dict(STANDALONE,
                                     **json.loads(args.scale or "{}")))
    with open(os.path.join(args.data_dir, "twin.json"), "w") as f:
        json.dump(res["turn_binds"], f)
    print(json.dumps({"twin_done": True, "passes": res["passes"],
                      "turns": len(res["turn_binds"]),
                      "launches": res["launches"]}), flush=True)
    return 0


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def standalone_binary(dev) -> dict:
    """``python -m volcano_tpu_torch.standalone --serve-store`` as a child
    on the card: nodes created over the wire, example/mpi-job.yaml,
    example/tensorflow-job.yaml and a generated job submitted with
    ``python -m volcano_tpu_torch.cli job run -f``, every pod bound, `job
    list` and `status` over the wire, the child's cmdline naming the port
    and its memory map holding libcuda and the fused_choice kernel
    library (loaded only to launch the kernel on CUDA tensors);
    SIGTERM, exit 0. The card's compute-process list is printed but not
    read: inside the machine's PID namespace it shows no usable PIDs."""
    import signal
    import tempfile
    from volcano_tpu_torch.client import RemoteClusterStore
    from volcano_tpu_torch.models import Node
    port = _free_port()
    addr = f"127.0.0.1:{port}"
    env = dict(os.environ, PYTHONHASHSEED="0", PYTHONUNBUFFERED="1")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "volcano_tpu_torch.standalone",
         "--serve-store", addr, "--metrics-port", "0", "--period", "0.2"],
        cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    log: list = []
    remote = None
    tmp = tempfile.mkdtemp(prefix="sa-", dir=os.path.join(REPO, "build"))
    try:
        for line in proc.stdout:
            log.append(line.rstrip("\n"))
            if "standalone up" in line:
                break
        else:
            raise AssertionError("the standalone binary exited before "
                                 "it came up:\n" + "\n".join(log[-40:]))
        up_ms = (time.perf_counter() - t0) * 1e3
        import threading
        threading.Thread(target=lambda: [log.append(x.rstrip("\n"))
                                         for x in proc.stdout],
                         daemon=True).start()
        cmdline = open(f"/proc/{proc.pid}/cmdline", "rb").read() \
            .decode().split("\0")
        if cmdline[1:3] != ["-m", "volcano_tpu_torch.standalone"]:
            raise AssertionError(f"the standalone child runs {cmdline}")
        remote = RemoteClusterStore(addr)
        rl = {"cpu": "8", "memory": "16Gi", "pods": "110"}
        for i in range(4):
            remote.create("nodes", Node(name=f"n{i}", allocatable=dict(rl),
                                        capacity=dict(rl)))
        gen = os.path.join(tmp, "gen.yaml")
        with open(gen, "w") as f:
            f.write(vcjob_yaml("gen-job", "default", "default", 4, 1, 1))
        cli = [sys.executable, "-m", "volcano_tpu_torch.cli", "--server",
               addr]

        def vcctl(*argv) -> str:
            out = subprocess.run(cli + list(argv), cwd=REPO, env=env,
                                 capture_output=True, text=True,
                                 timeout=120)
            if out.returncode != 0:
                raise AssertionError(f"vcctl {argv} exited "
                                     f"{out.returncode}: {out.stderr}")
            return out.stdout
        t1 = time.perf_counter()
        for path in (os.path.join(REPO, "example", "mpi-job.yaml"),
                     os.path.join(REPO, "example", "tensorflow-job.yaml"),
                     gen):
            out = vcctl("job", "run", "-f", path)
            if "successfully" not in out:
                raise AssertionError(f"vcctl job run -f {path}: {out}")
        want = 3 + 3 + 4
        deadline = time.time() + 120
        bound = []
        while time.time() < deadline:
            pods = remote.list("pods", namespace="default")
            bound = [p for p in pods if p.node_name]
            if len(bound) == want:
                break
            time.sleep(0.2)
        if len(bound) != want:
            raise AssertionError(f"the standalone binary bound "
                                 f"{len(bound)} of {want} pods:\n"
                                 + "\n".join(log[-40:]))
        bound_ms = (time.perf_counter() - t1) * 1e3
        listed = vcctl("job", "list")
        status = vcctl("status")
        for name in ("mpi-demo", "tf-demo", "gen-job"):
            if name not in listed:
                raise AssertionError(f"vcctl job list lacks {name}:\n"
                                     + listed)
        if "store: shards=1" not in status:
            raise AssertionError("vcctl status:\n" + status)
        apps = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,used_memory",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
        maps = open(f"/proc/{proc.pid}/maps").read()
        on_card = {"libcuda": "libcuda.so" in maps,
                   "fused_choice_library": "fused_choice" in maps}
        remote.close()
        remote = None
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
        if rc != 0:
            raise AssertionError(f"the standalone binary exited {rc} on "
                                 f"SIGTERM:\n" + "\n".join(log[-40:]))
        return {"phase": "standalone", "regime": "binary",
                "cmdline": cmdline[1:3], "up_ms": up_ms,
                "pods_bound": len(bound), "submit_to_bound_ms": bound_ms,
                "job_list_lines": len(listed.splitlines()),
                "status": status.splitlines()[:2],
                "mapped": on_card, "compute_apps": apps,
                "exit_code": rc}
    finally:
        if remote is not None:
            remote.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)


def phase_standalone(dev, scale=None) -> dict:
    """(a) The control plane in one process on the card, turn by turn,
    beside its twin on device="cpu" in a child (bind for bind, per turn);
    (b) the standalone binary on the card."""
    import tempfile
    sc = dict(STANDALONE, **(scale or {}))
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="sa-", dir=os.path.join(REPO, "build"))
    argv = ["--role", "standalonetwin", "--data-dir", tmp]
    if scale:
        argv += ["--scale", json.dumps(scale)]
    twin = Child("standalone-twin", argv)
    try:
        twin.first()
        res = standalone_run(dev, sc)
        burst = res["burst"]
        emit({"phase": "standalone", "regime": "burst",
              **{k: v for k, v in burst.items() if k != "rows"}})
        for row in burst["rows"]:
            emit({"phase": "standalone", "regime": "burst_turn", **row})
        for wave in res["waves"]:
            emit({"phase": "standalone", "regime": "wave",
                  **{k: v for k, v in wave.items() if k != "rows"},
                  "turn_ms": [r["turn_ms"] for r in wave["rows"]],
                  "cycle_ms": [r["cycle_ms"] for r in wave["rows"]],
                  "controllers_ms": [r["controllers_ms"]
                                     for r in wave["rows"]],
                  "launches": [r["launches"] for r in wave["rows"]],
                  "host_only_bound": [r["host_only_bound"]
                                      for r in wave["rows"]]})
        done = twin.wait_for(lambda x: x.get("twin_done"),
                             3 * CHILD_TIMEOUT_S, "the twin's run")
        with open(os.path.join(tmp, "twin.json")) as f:
            host = [[tuple(b) for b in turn] for turn in json.load(f)]
    finally:
        twin.kill()
    card = res["turn_binds"]
    for i, (a, b) in enumerate(zip(card, host)):
        if [tuple(x) for x in a] != b:
            raise AssertionError(f"standalone turn {i}: the card's binds "
                                 f"differ from the host's")
    if len(card) != len(host):
        raise AssertionError(f"standalone: {len(card)} turns on the card, "
                             f"{len(host)} on the host, the first "
                             f"{min(len(card), len(host))} binding alike")
    if min(res["passes"].values()) <= 0:
        raise AssertionError(f"standalone: a host pass of allocate bound "
                             f"no host-only job: {res['passes']}")
    binary = standalone_binary(dev)
    emit(binary)
    if not all(binary["mapped"].values()):
        raise AssertionError(f"the standalone binary did not load libcuda "
                             f"and the kernel library: "
                             f"{binary['mapped']}")
    import shutil
    shutil.rmtree(tmp, ignore_errors=True)
    out = {"phase": "standalone", "regime": "summary",
           "jobs": res["jobs"], "host_only_jobs": res["host_only_jobs"],
           "pods_bound": res["pods_bound"],
           "turns": len(card), "identical_to_host": True,
           "host_passes_jobs_bound": res["passes"],
           "host_passes_kinds": res["pass_kinds"],
           "launches": res["launches"], "twin_launches": done["launches"],
           "binary_pods_bound": binary["pods_bound"]}
    emit(out)
    return out


PHASES = ("kernel", "edges", "small", "solve", "profile", "cycle", "hdrf",
          "evict", "sequential", "sharded", "reschedule", "prewarm",
          "sidecar", "failover", "lifecycle", "netstore", "netha",
          "netshard", "sim", "standalone")


def main() -> int:
    import argparse

    import volcano_tpu_torch.ops  # noqa: F401  (fails outside the repo)

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of %(default)s (the "
                         "device and build phases always run; the last two "
                         "lines print only when every phase runs)")
    ap.add_argument("--prewarm-arm", choices=("on", "off"),
                    help="run one arm of the prewarm phase in this process "
                         "and print its JSON (the prewarm phase starts "
                         "each arm this way)")
    ap.add_argument("--role", choices=("store", "scheduler",
                                       "shardprimary", "replica", "simarm",
                                       "simverify", "standalonetwin"),
                    help="run as a child of the netstore / netha / "
                         "netshard / sim / standalone phases (role_store, "
                         "role_scheduler, role_shardprimary, role_replica, "
                         "role_simarm, role_simverify, "
                         "role_standalonetwin)")
    ap.add_argument("--data-dir")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--seed", choices=("bound",))
    ap.add_argument("--nodes", type=int, default=0)
    ap.add_argument("--jobs", type=int, default=0)
    ap.add_argument("--audit")
    ap.add_argument("--server")
    ap.add_argument("--identity")
    ap.add_argument("--lease", type=float, default=2.0)
    ap.add_argument("--renew", type=float, default=1.5)
    ap.add_argument("--retry", type=float, default=0.25)
    ap.add_argument("--period", type=float, default=0.25)
    ap.add_argument("--cold-standby", action="store_true")
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--upstream")
    ap.add_argument("--arm", choices=tuple(SIM_ARMS) + ("verify",))
    ap.add_argument("--scale", help="a JSON dict over STANDALONE (the "
                    "standalone twin runs its parent's scale)")
    args = ap.parse_args()
    if os.environ.get("PYTHONHASHSEED") != "0":
        # the netha phase compares decisions across processes: this
        # process and its children hash strings alike
        os.execve(sys.executable, [sys.executable, *sys.argv],
                  dict(os.environ, PYTHONHASHSEED="0"))
    phases = args.phases.split(",")
    if not set(phases) <= set(PHASES):
        ap.error(f"unknown phases {set(phases) - set(PHASES)}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    if args.role == "store":
        return role_store(args)
    if args.role == "scheduler":
        return role_scheduler(args)
    if args.role == "shardprimary":
        return role_shardprimary(args)
    if args.role == "replica":
        return role_replica(args)
    if args.role == "simarm":
        return role_simarm(args)
    if args.role == "simverify":
        return role_simverify(args)
    if args.role == "standalonetwin":
        return role_standalonetwin(args)
    if args.prewarm_arm:
        print(json.dumps(prewarm_arm(dev, args.prewarm_arm == "on",
                                     PREWARM)), flush=True)
        return 0
    info = phase_device()
    seconds = {}

    def run(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        print(f"chip_smoke: {name} took {seconds[name]:.1f} s",
              file=sys.stderr, flush=True)
        return out

    run("build", phase_build)
    out = {name: run(name, fn, dev) for name, fn in (
        ("kernel", phase_kernel), ("edges", phase_edges),
        ("small", phase_small), ("solve", phase_solve),
        ("profile", phase_profile), ("cycle", phase_cycle),
        ("hdrf", phase_hdrf), ("evict", phase_evict),
        ("sequential", phase_sequential), ("sharded", phase_sharded),
        ("reschedule", phase_reschedule), ("prewarm", phase_prewarm),
        ("sidecar", phase_sidecar), ("failover", phase_failover),
        ("lifecycle", phase_lifecycle), ("netstore", phase_netstore))
        if name in phases}
    if "netha" in phases:
        out["netha"] = run("netha", phase_netha, dev, None,
                           out.get("netstore"))
    if "netshard" in phases:
        out["netshard"] = run("netshard", phase_netshard, dev, None,
                              out.get("netstore"))
    # the standalone phase runs while the card verifies the sim's trace
    sim = run("sim_start", SimPhase(dev).start) if "sim" in phases \
        else None
    try:
        if "standalone" in phases:
            out["standalone"] = run("standalone", phase_standalone, dev)
        if sim is not None:
            out["sim"] = run("sim", sim.finish)
    finally:
        if sim is not None:
            sim.kill()
    emit({"phase": "seconds", **seconds})
    if set(phases) != set(PHASES):
        return 0
    (krows, cyc, hdrf, evict, sharded, resched, prewarm, sidecar, failover,
     lifecycle) = (out[k] for k in (
         "kernel", "cycle", "hdrf", "evict", "sharded", "reschedule",
         "prewarm", "sidecar", "failover", "lifecycle"))
    main_launches = out["solve"][1]
    head = next(r for r in krows if r["R"] == 2 and r["eligible_rows"]
                > 0.5 * r["T"] and r["families"] == ["binpack"])
    # the main path: the scheduling cycle's measured burst and timed
    # steady cycles, the hdrf cycles, the eviction cycles, the sharded
    # cycles, the two reschedule passes, the prewarm arm's cycles (its
    # background warms counted apart), the sidecar server's solves (its
    # count read before and after each request) and the failover's
    # leader, shadow, standby and cold-twin cycles, and the lifecycle's
    # cycles (its twin's counted apart), the netstore scheduler's cycles
    # over the wire (its in-process twin's apart), the netha scheduler
    # processes' leader and shadow cycles (each child counts from 0 at its
    # start and reports its total), the netshard scheduler's cycles over
    # the read tier (its twin's apart), the sim's card arms (its children
    # and the vcctl child's in-process twin) and the standalone's turns on
    # the card (its CPU twin's apart), each counted from 0 (the sequential
    # mode launches no kernel)
    cycle_rows = [cyc["burst"]] + cyc["steady"]
    evict_launches = sum(r["launches"] + r["next_cycle_launches"]
                         for r in evict)
    sharded_rows = sharded["cycles"]["rows"] + sharded.get(
        "cycles_multi", {}).get("rows", []) + [sharded["hdrf"]]
    sharded_launches = sum(r["launches"] for r in sharded_rows)
    if sharded_launches <= 0:
        raise AssertionError("the sharded cycles launched no kernel")
    shard_k = sharded["kernel"]
    resched_launches = sum(resched[k]["launches"]
                           for k in ("first", "second"))
    resched_k = resched["kernel"]
    ring = {"prewarm": prewarm["launches"], "sidecar": sidecar["launches"],
            "failover": failover["launches"],
            "lifecycle": lifecycle["launches"],
            "netstore": out["netstore"]["launches"],
            "netha": out["netha"]["launches"],
            "netshard": out["netshard"]["launches"],
            "sim": out["sim"]["launches"],
            "standalone": out["standalone"]["launches"]}
    if min(ring.values()) <= 0:
        raise AssertionError(f"a path of the outer ring, the lifecycle, "
                             f"the network, the sim or the standalone "
                             f"launched no kernel: {ring}")
    emit({"kernels": [{
        "name": "fused_choice", "route": "cuda",
        "source": "volcano_tpu_torch/csrc/fused_choice.cu",
        "replaces": "volcano_tpu/ops/pallas_kernels.py:201",
        "launches": sum(r["launches"] for r in cycle_rows + hdrf["rows"])
        + evict_launches + sharded_launches + resched_launches
        + sum(ring.values()),
        "launches_sharded": sharded_launches,
        "launches_sharded_hdrf_prefilter":
            sharded["hdrf"]["prefilter_launches"],
        "launches_sharded_scale_solve": sharded["scale"]["sharded_launches"],
        "launches_per_burst_cycle": cyc["burst"]["launches"],
        "launches_per_steady_cycle": statistics.median(
            r["launches"] for r in cyc["steady"]),
        "launches_per_hdrf_cycle": [r["launches"] for r in hdrf["rows"]],
        "launches_hdrf_prefilter": sum(r["prefilter_launches"]
                                       for r in hdrf["rows"]),
        "launches_evict_cycles": evict_launches,
        "launches_reschedule": resched_launches,
        "launches_prewarm_cycles": ring["prewarm"],
        "launches_prewarm_background": prewarm["launches_prewarm_background"],
        "launches_sidecar_server": ring["sidecar"],
        "launches_failover": ring["failover"],
        "launches_lifecycle": ring["lifecycle"],
        "launches_lifecycle_twin": lifecycle["twin"]["launches"],
        "launches_netstore": ring["netstore"],
        "launches_netstore_twin": out["netstore"]["twin_launches"],
        "launches_netha_schedulers": ring["netha"],
        "launches_netshard": ring["netshard"],
        "launches_netshard_twin": out["netshard"]["twin_launches"],
        "launches_sim": ring["sim"],
        "launches_standalone": ring["standalone"],
        "launches_standalone_twin": out["standalone"]["twin_launches"],
        "launches_headline_solve": main_launches,
        "max_abs_err": max(r["max_abs_err"]
                           for r in krows + [shard_k, resched_k]),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None,
        "shape": {"T": head["T"], "N": head["N"], "R": head["R"],
                  "families": head["families"]},
        "shard_shape": {"T": shard_k["T"], "N": shard_k["N"],
                        "R": shard_k["R"], "families": shard_k["families"],
                        "shards": sharded["cycles"]["rows"][0]["shards"],
                        "ms": shard_k["ms"], "plain_ms": shard_k["plain_ms"],
                        "bound_ms": shard_k["bound_ms"],
                        "bound_by": shard_k["bound_by"]},
        "reschedule_shape": {k: resched_k[k] for k in (
            "T", "N", "R", "families", "ms", "plain_ms", "bound_ms",
            "bound_by")}}]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["name"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
