#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (volcano_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA GPU (an H100: the kernels are built for sm_90a) and the CUDA
toolkit; exits non-zero without them. Builds the port's kernels from the
checkout, then, printing one JSON line per phase:

1. device  - nvidia-smi name and power limit, torch's device name;
2. build   - nvcc of every kernel source;
3. kernel  - fused_choice against its plain PyTorch version at the headline
             shape (T=10240 tasks, N=2048 nodes) with R=2 and R=3, for each
             score-family set: best_score and node_max equal, best_idx
             equal wherever the top score is unique; CUDA-event times;
4. small   - a small seeded solve on the card (fused kernel) against the
             same solve on the host (dense path): identical results;
5. solve   - the headline allocate solve (1000 gangs x 10 pods over 2000
             nodes, 3 queues weighted 1:2:3) through the port's entry
             points, fused kernel vs dense path on the card, in three arms:
             binpack/pack with queue caps, the same with live DRF order,
             and kube/spread scoring. Checks: identical kind and job_ready,
             assignment differences only between score-tied nodes, no node
             over its idle, gangs all-or-nothing, kernel launches counted
             on the fused run only;
6. profile - one fused headline session under torch.profiler: device time
             by kernel and the device's idle share;
7. the kernels line, then the result line.

Any failed check raises, so the run exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
# The data sheet's 67 TFLOP/s fp32 (outside the tensor cores) counts a fused
# multiply-add as two operations: one fp32 instruction per lane per clock.
# The kernels are built with --fmad=false, so every add, multiply, compare,
# min/max and select is an instruction of its own, issued at half that rate.
H100_FP32_INSTR_PER_S = 67e12 / 2
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


# -- timing and bounds -------------------------------------------------------

def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of fn() in milliseconds."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def fused_choice_cost(T: int, N: int, R: int, families) -> tuple:
    """(bytes, fp32 instructions) the fused choice needs: each input read
    once, each output written once. Each term is charged once per value it
    depends on:
    - per node: the fit threshold av + (thr + tol*|av|) (abs, mul, 2 adds
      per dim); binpack's w*inv and sum of (used*w)*inv (4 per dim);
    - per task: the scalar-dim request <= 10 test (1 per dim past the 2nd);
    - per (task, node) pair: the fit test's 2 compares per dim, the
      node_static add, the mask select, the row max and the column max;
      binpack's R products and R sums, the node term's add, the weight and
      scale multiplies and the add into the score (2R + 4); kube's fill
      fractions, clips, least / most / balanced and weighted sum (30).
    Boolean and int8 mask logic is not fp32 work and is not counted."""
    nbytes = (T * N                      # int8 signature mask
              + 4 * (T * R + T)          # init_req, eligible
              + 4 * (3 * N * R + 2 * N)  # avail, used, inv_alloc; static, pods_ok
              + 4 * (5 + R)              # pars
              + 4 * (2 * T + N))         # best_s, best_i, node_max
    per_pair = 2 * R + 4
    per_node = 4 * R
    per_task = max(R - 2, 0)
    if "binpack" in families:
        per_pair += 2 * R + 4
        per_node += 4 * R
    if "kube" in families:
        per_pair += 30
    return nbytes, T * N * per_pair + N * per_node + T * per_task


def bound_ms(nbytes: int, ops: int) -> tuple:
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_FP32_INSTR_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


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


def phase_build():
    from volcano_tpu_torch.ops import _build
    t0 = time.perf_counter()
    reports = {name: _build.build(name) for name in _build.KERNELS}
    for name in _build.KERNELS:
        _build.load(name)
    seconds = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in out.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, out in reports.items() if out}
    emit({"phase": "build", "seconds": seconds, "kernels": list(_build.KERNELS),
          "compiled": sorted(ptxas), "ptxas": ptxas})


def kernel_inputs(seed: int, T: int, N: int, R: int, dev):
    """Seeded kernel inputs at the headline shape: integer-valued
    requests (milli-cpu, GiB, gpu milli), nodes part-used, random
    eligible / pods_ok / signature masks, pairs of identical nodes so that
    argmax ties occur."""
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
    used[1::2] = used[0::2]
    avail = alloc - used
    params = {"binpack_weight": 1.0,
              "binpack_res_weights": np.ones(R, np.float32),
              "least_req_weight": 1.0, "most_req_weight": 0.0,
              "balanced_weight": 1.0,
              "node_static": np.zeros(N, np.float32)}
    tp = to_torch_params(params, dev)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return [t(req), t(avail), t(used), t((1.0 / alloc).astype(np.float32)),
            tp["node_static"],
            t((rng.random(T) < 0.9).astype(np.float32)),
            t((rng.random(N) < 0.95).astype(np.float32)),
            t((rng.random((T, N)) < 0.9).astype(np.int8)),
            pack_pars(tp, R)]


def phase_kernel(dev):
    from volcano_tpu_torch.ops import fused_choice as fc

    T, N = KERNEL_SHAPE
    rows = []
    for R in (2, 3):
        args = kernel_inputs(100 + R, T, N, R, dev)
        for fam in FAMILY_SETS:
            got = fc.fused_choice(*args, fam)
            want = fc.fused_choice_plain(*args, fam)
            torch.cuda.synchronize()
            feas = fc.fused_feasible(args[0], args[1], args[5], args[6],
                                     args[7])
            score = fc._score(args[0], args[2], args[3], args[4], args[8],
                              fam)
            masked = torch.where(feas, score, fc.NEG)
            n_top = (masked == want[0][:, None]).sum(dim=1)
            unique = n_top == 1
            err_s = (got[0] - want[0]).abs().max().item()
            err_n = (got[2] - want[2]).abs().max().item()
            idx_bad = int(((got[1] != want[1]) & unique).sum().item())
            idx_tied_diff = int(((got[1] != want[1]) & ~unique).sum().item())
            if not (torch.equal(got[0], want[0])
                    and torch.equal(got[2], want[2]) and idx_bad == 0):
                raise AssertionError(
                    f"fused_choice disagrees with its plain version at "
                    f"R={R} {fam}: best_score err {err_s}, node_max err "
                    f"{err_n}, best_idx differs at {idx_bad} unique rows")
            del feas, score, masked
            ms = cuda_ms(lambda: fc.fused_choice(*args, fam))
            plain_ms = cuda_ms(lambda: fc.fused_choice_plain(*args, fam))
            nbytes, ops = fused_choice_cost(T, N, R, fam)
            b_ms, b_by = bound_ms(nbytes, ops)
            row = {"phase": "kernel", "name": "fused_choice", "T": T,
                   "N": N, "R": R, "families": list(fam),
                   "max_abs_err": max(err_s, err_n),
                   "idx_diff_unique": idx_bad,
                   "idx_diff_tied": idx_tied_diff,
                   "tied_rows": int((~unique).sum().item()),
                   "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                   "bound_by": b_by, "bytes": nbytes, "fp32_instructions": ops}
            emit(row)
            rows.append(row)
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
        emit(row)
        out.append(row)
    arr.drf_total[:] = 0.0
    return out, main_launches


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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_ms, res, _, _ = timed_session(arr, params, kw, "auto", dev)
    from torch.autograd import DeviceType
    # device-side events only (kernels, memcpy, memset): the aten ops that
    # launched them carry the same time and would count it twice
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    device_ms = sum(r[0] for r in rows) / 1e3
    launches = sum(e.count for e in prof.key_averages()
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                "cudaLaunchKernelExC"))
    syncs = sum(e.count for e in prof.key_averages()
                if e.key in ("cudaStreamSynchronize", "cudaMemcpyAsync"))
    emit({"phase": "profile", "arm": "binpack_pack_qcap",
          "wall_ms_unprofiled": plain_wall, "wall_ms_profiled": wall_ms,
          "device_ms": device_ms,
          "device_idle_share": 1.0 - device_ms / plain_wall,
          "kernel_launches": launches, "sync_or_copy_calls": syncs,
          "rounds": int(res.rounds.item()),
          "top_device_us": [{"name": k[:80], "us": us, "count": c}
                            for us, c, k in rows[:12]]})


def main() -> int:
    import volcano_tpu_torch.ops  # noqa: F401  (fails outside the repo)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    info = phase_device()
    phase_build()
    krows = phase_kernel(dev)
    phase_small(dev)
    _, main_launches = phase_solve(dev)
    phase_profile(dev)
    head = next(r for r in krows
                if r["R"] == 2 and r["families"] == ["binpack"])
    emit({"kernels": [{
        "name": "fused_choice", "route": "cuda",
        "source": "volcano_tpu_torch/csrc/fused_choice.cu",
        "replaces": "volcano_tpu/ops/pallas_kernels.py:201",
        "launches": main_launches,
        "max_abs_err": max(r["max_abs_err"] for r in krows),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None,
        "shape": {"T": head["T"], "N": head["N"], "R": head["R"],
                  "families": head["families"]}}]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["name"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
