"""Seeded workload generation + the JSONL trace format.

The simulator is trace-driven: a Workload is a deterministic list of
arrival events (one per job), either generated from a WorkloadSpec with a
seeded RNG or loaded from a JSONL file, so externally captured cluster
traces (Borg/Philly-style) can drive the same harness. Every event
carries everything the virtual cluster needs to emulate the job's
lifetime: gang size, queue, priority, per-task requests, per-task run
duration in virtual cycles, and optional mid-run failures.

Event line schema (one JSON object per line):

    {"t": <arrival cycle>, "kind": "job", "name": "j12",
     "namespace": "sim", "queue": "q1", "min_member": 3,
     "priority_class": "", "tasks": [
        {"cpu": "2", "memory": "2Gi", "gpu": 0,
         "duration": 11, "fail_after": null}, ...]}

A ``{"kind": "header", "spec": {...}}`` first line records the generating
spec; loaders ignore unknown keys so hand-edited or external traces stay
loadable.
"""

from __future__ import annotations

import json
import math
import random
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional, Tuple

from ..models import (
    Node, Pod, PodGroup, PodGroupPhase, PodGroupSpec, PodGroupStatus,
    PriorityClass, Queue, QueueSpec,
)
from ..api.types import POD_GROUP_ANNOTATION

#: pod annotations the virtual cluster reads to emulate the lifecycle
DURATION_ANNOTATION = "sim.volcano.sh/duration-cycles"
FAIL_AFTER_ANNOTATION = "sim.volcano.sh/fail-after-cycles"


@dataclass
class WorkloadSpec:
    """Knobs for the seeded generator. Every distribution draws from ONE
    ``random.Random(seed)`` stream in a fixed order, so a spec is a
    complete, reproducible description of the workload."""

    seed: int = 0
    cycles: int = 100              # arrival horizon (cycles with arrivals)
    nodes: int = 8
    node_cpu: str = "32"
    node_mem: str = "128Gi"
    gpu_nodes: int = 0             # first K nodes also expose GPUs
    node_gpu: int = 8
    queues: Tuple[Tuple[str, int], ...] = (("q0", 1), ("q1", 2))
    arrival_rate: float = 1.5      # expected jobs per cycle (Poisson)
    gang_min: int = 1
    gang_max: int = 3
    cpu_choices: Tuple[int, ...] = (1, 2, 4)
    mem_gi_choices: Tuple[int, ...] = (1, 2, 4)
    gpu_fraction: float = 0.0      # fraction of jobs requesting 1 GPU/task
    duration_min: int = 3          # task run time, virtual cycles
    duration_max: int = 12
    fail_fraction: float = 0.0     # fraction of pods failing once mid-run
    # (name, priority value, fraction of jobs) — empty = no priorities
    priorities: Tuple[Tuple[str, int, float], ...] = ()
    namespace: str = "sim"

    def to_dict(self) -> dict:
        d = asdict(self)
        d["queues"] = [list(q) for q in self.queues]
        d["priorities"] = [list(p) for p in self.priorities]
        return d


def _poisson(rng: random.Random, lam: float) -> int:
    """Knuth's algorithm: deterministic given the rng stream."""
    if lam <= 0:
        return 0
    limit = math.exp(-lam)
    k, p = 0, 1.0
    while True:
        p *= rng.random()
        if p <= limit:
            return k
        k += 1


class Workload:
    """A deterministic event list + the cluster objects it runs against."""

    def __init__(self, spec: WorkloadSpec,
                 events: Optional[List[dict]] = None):
        self.spec = spec
        self.events: List[dict] = (list(events) if events is not None
                                   else self._generate())
        self._by_cycle: Dict[int, List[dict]] = {}
        for ev in self.events:
            self._by_cycle.setdefault(int(ev["t"]), []).append(ev)

    # -- generation ---------------------------------------------------------

    def _generate(self) -> List[dict]:
        s = self.spec
        rng = random.Random(s.seed)
        events: List[dict] = []
        seq = 0
        qnames = [q for q, _ in s.queues]
        for t in range(s.cycles):
            for _ in range(_poisson(rng, s.arrival_rate)):
                gang = rng.randint(s.gang_min, s.gang_max)
                queue = qnames[seq % len(qnames)] if qnames else "default"
                wants_gpu = s.gpu_fraction > 0 \
                    and rng.random() < s.gpu_fraction
                prio = ""
                for name, _value, frac in s.priorities:
                    if rng.random() < frac:
                        prio = name
                        break
                cpu = rng.choice(s.cpu_choices)
                mem = rng.choice(s.mem_gi_choices)
                tasks = []
                for _i in range(gang):
                    dur = rng.randint(s.duration_min, s.duration_max)
                    fail = None
                    if s.fail_fraction > 0 \
                            and rng.random() < s.fail_fraction:
                        fail = max(1, dur // 2)
                    tasks.append({"cpu": str(cpu), "memory": f"{mem}Gi",
                                  "gpu": 1 if wants_gpu else 0,
                                  "duration": dur, "fail_after": fail})
                events.append({"t": t, "kind": "job", "name": f"j{seq}",
                               "namespace": s.namespace, "queue": queue,
                               "min_member": gang, "priority_class": prio,
                               "tasks": tasks})
                seq += 1
        return events

    # -- access -------------------------------------------------------------

    def arrivals(self, cycle: int) -> List[dict]:
        return self._by_cycle.get(cycle, [])

    @property
    def total_pods(self) -> int:
        return sum(len(ev["tasks"]) for ev in self.events)

    # -- cluster objects ----------------------------------------------------

    def node_objects(self) -> List[Node]:
        s = self.spec
        out = []
        for i in range(s.nodes):
            rl = {"cpu": s.node_cpu, "memory": s.node_mem, "pods": 110}
            if i < s.gpu_nodes:
                rl["nvidia.com/gpu"] = s.node_gpu
            out.append(Node(name=f"n{i}", allocatable=rl,
                            capacity=dict(rl)))
        return out

    def queue_objects(self) -> List[Queue]:
        # distinct virtual creation timestamps: the queue-order
        # comparator's tiebreak must never fall through to the
        # process-local uid counter (which differs between runs)
        return [Queue(name=name, spec=QueueSpec(weight=w),
                      creation_timestamp=float(i) * 1e-4)
                for i, (name, w) in enumerate(self.spec.queues)]

    def priority_class_objects(self) -> List[PriorityClass]:
        return [PriorityClass(name=name, value=value)
                for name, value, _frac in self.spec.priorities]

    # -- trace (de)serialization --------------------------------------------

    def dump_lines(self) -> List[str]:
        lines = [json.dumps({"kind": "header", "spec": self.spec.to_dict()},
                            sort_keys=True, separators=(",", ":"))]
        lines += [json.dumps(ev, sort_keys=True, separators=(",", ":"))
                  for ev in self.events]
        return lines

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write("\n".join(self.dump_lines()) + "\n")

    @classmethod
    def load(cls, path: str) -> "Workload":
        spec = WorkloadSpec()
        events: List[dict] = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                obj = json.loads(line)
                if obj.get("kind") == "header":
                    raw = obj.get("spec") or {}
                    known = {k: raw[k] for k in raw
                             if k in WorkloadSpec.__dataclass_fields__}
                    if "queues" in known:
                        known["queues"] = tuple(
                            (q, int(w)) for q, w in known["queues"])
                    if "priorities" in known:
                        known["priorities"] = tuple(
                            (n, int(v), float(fr))
                            for n, v, fr in known["priorities"])
                    spec = WorkloadSpec(**known)
                elif obj.get("kind", "job") == "job":
                    events.append(obj)
        return cls(spec, events=events)


def fragmented_workload(seed: int = 0, cycles: int = 500,
                        nodes: int = 9) -> Workload:
    """Seeded ``fragmented`` preset: the workload the rescheduler's
    defrag gain is judged on.

    Three deterministic components interleave on ``nodes`` x 32-cpu
    nodes. The component rates are absolute, so ``nodes`` sets the
    operating point: the default 9 lands at ~0.80 mean utilization —
    fragmented (the 16-cpu shape regularly fits nowhere, bigs queue)
    but with landing capacity left for migrations, which is the regime
    defragmentation exists for. 6 nodes saturates (~0.88, no landing
    room); 12 idles (~0.69, nothing queues long enough to matter).

    - **long-running gangs** (cpu 8, gang 2-3, 60-140 cycles) arriving
      every few cycles — the placements that pin history;
    - **high-churn short jobs** (cpu 1-2, gang 1-2, 2-6 cycles, Poisson
      ~4/cycle) constantly opening and closing holes around them;
    - **big periodic jobs** (cpu 16, 10-20 cycles) — the fragmentation
      victims: once the longs are scattered, plenty of total free CPU
      sits stranded in sub-16 slots and the bigs queue.

    Same seed => byte-identical trace; the no-reschedule run of this
    workload is the golden baseline the reschedule-enabled run must beat
    on utilization and fragmentation_index with wait p99 no worse
    (tests/test_reschedule.py, bench.py reschedule_defrag).
    """
    spec = WorkloadSpec(
        seed=seed, cycles=cycles, nodes=nodes, node_cpu="32",
        node_mem="128Gi", queues=(("q0", 1), ("q1", 2)),
        arrival_rate=4.0, gang_min=1, gang_max=3,
        cpu_choices=(1, 2, 4, 8, 16), mem_gi_choices=(1, 2, 4),
        duration_min=2, duration_max=140)
    rng = random.Random(seed ^ 0xF4A6)
    qnames = [q for q, _ in spec.queues]
    events: List[dict] = []
    seq = 0

    def emit(t, gang, cpu, mem_gi, dur_lo, dur_hi, tag):
        nonlocal seq
        tasks = [{"cpu": str(cpu), "memory": f"{mem_gi}Gi", "gpu": 0,
                  "duration": rng.randint(dur_lo, dur_hi),
                  "fail_after": None} for _ in range(gang)]
        events.append({"t": t, "kind": "job",
                       "name": f"{tag}{seq}",
                       "namespace": spec.namespace,
                       "queue": qnames[seq % len(qnames)],
                       "min_member": gang, "priority_class": "",
                       "tasks": tasks})
        seq += 1

    for t in range(cycles):
        if t % 8 == 0:
            # long-running gang: the fragment-pinning component
            emit(t, rng.randint(2, 3), 8, 4, 50, 110, "long")
        if t % 4 == 2:
            # big single-node job: needs one mostly-free node — the
            # fragmentation victim the defrag gain is measured on
            emit(t, 1, 16, 4, 15, 30, "big")
        for _ in range(_poisson(rng, 4.0)):
            emit(t, rng.randint(1, 2), rng.choice((1, 1, 2)),
                 rng.choice((1, 2)), 2, 6, "churn")
    return Workload(spec, events=events)


#: named presets accepted by `vcctl sim --preset` / `python -m
#: volcano_tpu_torch.sim --preset`; each returns a fully-seeded Workload
WORKLOAD_PRESETS = {
    "fragmented": fragmented_workload,
}


def build_job_crd(ev: dict):
    """One arrival event as a volcano Job CRD — the ``standalone
    --sim-trace`` path, where arrivals must take the full admission +
    job-controller route instead of raw podgroup/pod creation."""
    from ..models import Job, JobSpec, TaskSpec

    groups: Dict[tuple, int] = {}
    for t in ev["tasks"]:
        sig = (str(t.get("cpu", "1")), str(t.get("memory", "1Gi")),
               int(t.get("gpu", 0) or 0))
        groups[sig] = groups.get(sig, 0) + 1
    tasks = []
    for i, (sig, n) in enumerate(sorted(groups.items())):
        req = {"cpu": sig[0], "memory": sig[1]}
        if sig[2]:
            req["nvidia.com/gpu"] = sig[2]
        tasks.append(TaskSpec(
            name=f"task{i}", replicas=n,
            template={"spec": {"containers": [
                {"name": ev["name"], "image": "sim", "requests": req}]}}))
    return Job(
        name=ev["name"], namespace=ev.get("namespace", "sim"),
        spec=JobSpec(
            min_available=int(ev.get("min_member", 1)),
            queue=ev.get("queue", ""),
            # empty: the mutate webhook fills the control plane's
            # scheduler name (see cli.vcctl._job_from_yaml)
            scheduler_name="",
            priority_class_name=ev.get("priority_class", ""),
            tasks=tasks))


def build_job_objects(ev: dict, now: float, seq_base: float = 0.0):
    """Materialize one arrival event into (PodGroup, [Pod]) with virtual
    creation timestamps. ``seq_base`` spreads objects created in the same
    virtual instant so ordering tiebreaks never reach the process-local
    uid counter."""
    name = ev["name"]
    ns = ev.get("namespace", "sim")
    pg = PodGroup(
        name=name, namespace=ns,
        spec=PodGroupSpec(min_member=int(ev.get("min_member", 1)),
                          queue=ev.get("queue", "default"),
                          priority_class_name=ev.get("priority_class", "")),
        status=PodGroupStatus(phase=PodGroupPhase.PENDING),
        creation_timestamp=now + seq_base)
    pods = []
    for i, t in enumerate(ev["tasks"]):
        req = {"cpu": str(t.get("cpu", "1")),
               "memory": t.get("memory", "1Gi")}
        if t.get("gpu"):
            req["nvidia.com/gpu"] = int(t["gpu"])
        ann = {POD_GROUP_ANNOTATION: name,
               DURATION_ANNOTATION: str(int(t.get("duration", 5)))}
        if t.get("fail_after") is not None:
            ann[FAIL_AFTER_ANNOTATION] = str(int(t["fail_after"]))
        pods.append(Pod(
            name=f"{name}-{i}", namespace=ns, annotations=ann,
            containers=[{"requests": req}],
            priority_class_name=ev.get("priority_class", ""),
            creation_timestamp=now + seq_base + (i + 1) * 1e-6))
    return pg, pods
