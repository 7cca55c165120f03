"""vcctl-equivalent CLI (reference cmd/cli/vcctl.go + pkg/cli/*).

Commands: job {run,list,view,suspend,resume,delete},
queue {create,delete,operate,list,get}, version. Operates against a
ClusterStore (in production the gRPC sidecar to the control plane; in
tests/dev an in-memory store). Standalone aliases vsub/vjobs/vqueues/
vcancel/vsuspend/vresume map onto the same verbs. Its output is the JAX
package's vcctl's, string for string; ``sim`` runs the scheduler on the
CUDA device unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import yaml

from .. import __version__
from ..client.store import ClusterStore, NotFoundError
from ..models import (
    Action, Command, Job, JobSpec, Queue, QueueSpec, TaskSpec,
)


def _fmt_age(ts: float) -> str:
    s = int(time.time() - ts)
    if s < 60:
        return f"{s}s"
    if s < 3600:
        return f"{s // 60}m"
    return f"{s // 3600}h"


def _list_versioned(cluster, args, kind: str, **kw):
    """List with staleness surfaced: ``(objects, applied_rv)``. Against
    a remote store (primary or replica) the response's ``applied_rv``
    comes back for display and ``--min-rv`` rides through as the
    rv-bounded read (a replica blocks-or-fails until it has applied that
    rv); the in-process store is its own source of truth, so there is
    nothing to bound or report."""
    lv = getattr(cluster, "list_versioned", None)
    if lv is not None:
        return lv(kind, min_rv=getattr(args, "min_rv", None), **kw)
    return cluster.list(kind, **kw), None


def _rv_footer(applied_rv) -> str:
    if applied_rv is None:
        return ""
    return f"\napplied_rv: {applied_rv}"


def _table(headers: List[str], rows: List[List[str]]) -> str:
    widths = [len(h) for h in headers]
    for row in rows:
        for i, cell in enumerate(row):
            widths[i] = max(widths[i], len(str(cell)))
    lines = ["  ".join(h.ljust(widths[i]) for i, h in enumerate(headers))]
    for row in rows:
        lines.append("  ".join(str(c).ljust(widths[i])
                               for i, c in enumerate(row)))
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# job commands (pkg/cli/job)
# ---------------------------------------------------------------------------

def job_run(args, cluster: ClusterStore) -> str:
    if args.filename:
        with open(args.filename) as f:
            raw = yaml.safe_load(f)
        job = _job_from_yaml(raw)
    else:
        requests = {}
        for kv in (args.requests or "").split(","):
            if "=" in kv:
                k, v = kv.split("=", 1)
                requests[k.strip()] = v.strip()
        requests.setdefault("cpu", "1")
        requests.setdefault("memory", "1Gi")
        job = Job(
            name=args.name, namespace=args.namespace,
            spec=JobSpec(
                min_available=args.min_available or args.replicas,
                queue=args.queue,
                scheduler_name=args.scheduler,
                tasks=[TaskSpec(name="task", replicas=args.replicas,
                                template={"spec": {"containers": [{
                                    "name": args.name,
                                    "image": args.image,
                                    "requests": requests}]}})]))
    cluster.create("jobs", job)
    return f"run job {job.name} successfully"


def _policies_from_yaml(raw_policies) -> list:
    from ..models import Event, LifecyclePolicy

    out = []
    for p in raw_policies or []:
        exit_code = p.get("exitCode")
        timeout = p.get("timeout")
        out.append(LifecyclePolicy(
            action=Action(p["action"]) if p.get("action") else Action.SYNC_JOB,
            event=Event(p["event"]) if p.get("event") else None,
            events=[Event(e) for e in p.get("events", [])],
            exit_code=int(exit_code) if exit_code is not None else None,
            timeout_seconds=float(timeout) if timeout is not None else None,
        ))
    return out


def _job_from_yaml(raw: dict) -> Job:
    meta = raw.get("metadata", {})
    spec = raw.get("spec", {})
    tasks = []
    for t in spec.get("tasks", []):
        tasks.append(TaskSpec(name=t.get("name", ""),
                              replicas=int(t.get("replicas", 1)),
                              template=t.get("template", {}),
                              policies=_policies_from_yaml(t.get("policies"))))
    kw = {}
    if spec.get("maxRetry") is not None:
        kw["max_retry"] = int(spec["maxRetry"])
    return Job(
        name=meta.get("name", "job"),
        namespace=meta.get("namespace", "default"),
        spec=JobSpec(
            min_available=int(spec.get("minAvailable", 0)),
            queue=spec.get("queue", ""),
            # empty when the YAML names none: the mutate webhook fills
            # the CONTROL PLANE's scheduler name (its --scheduler-name),
            # which the CLI cannot know
            scheduler_name=spec.get("schedulerName", ""),
            tasks=tasks,
            plugins=spec.get("plugins", {}) or {},
            policies=_policies_from_yaml(spec.get("policies")),
            priority_class_name=spec.get("priorityClassName", ""),
            ttl_seconds_after_finished=(
                int(spec["ttlSecondsAfterFinished"])
                if spec.get("ttlSecondsAfterFinished") is not None else None),
            volumes=spec.get("volumes", []) or [],
            **kw,
        ))


def job_list(args, cluster: ClusterStore) -> str:
    jobs, applied_rv = _list_versioned(cluster, args, "jobs",
                                       namespace=args.namespace)
    rows = []
    for j in sorted(jobs, key=lambda x: x.name):
        st = j.status
        replicas = sum(t.replicas for t in j.spec.tasks)
        rows.append([j.name, _fmt_age(j.creation_timestamp),
                     str(replicas), str(j.spec.min_available),
                     st.state.phase.value, str(st.pending), str(st.running),
                     str(st.succeeded), str(st.failed), str(st.retry_count)])
    return _table(["Name", "Age", "Replicas", "Min", "Phase", "Pending",
                   "Running", "Succeeded", "Failed", "RetryCount"],
                  rows) + _rv_footer(applied_rv)


def job_view(args, cluster: ClusterStore) -> str:
    try:
        j = cluster.get("jobs", args.name, args.namespace)
    except NotFoundError:
        return f"Error: job {args.namespace}/{args.name} not found"
    st = j.status
    lines = [
        f"Name:        {j.name}",
        f"Namespace:   {j.namespace}",
        f"Queue:       {j.spec.queue or 'default'}",
        f"Scheduler:   {j.spec.scheduler_name}",
        f"MinAvailable:{j.spec.min_available}",
        f"Phase:       {st.state.phase.value}",
        f"Version:     {st.version}",
        f"RetryCount:  {st.retry_count}",
        "Tasks:",
    ]
    for t in j.spec.tasks:
        lines.append(f"  - {t.name}: replicas={t.replicas}")
    lines.append(f"Status: pending={st.pending} running={st.running} "
                 f"succeeded={st.succeeded} failed={st.failed}")
    return "\n".join(lines)


def _job_command(args, cluster: ClusterStore, action: Action, verb: str) -> str:
    try:
        job = cluster.get("jobs", args.name, args.namespace)
    except NotFoundError:
        return f"Error: job {args.namespace}/{args.name} not found"
    cluster.create("commands", Command(
        name=f"{verb}-{job.name}-{int(time.time() * 1000) % 100000}",
        namespace=job.namespace, action=action,
        target_object={"kind": "Job", "name": job.name, "uid": job.uid}))
    return f"{verb} job {job.name} successfully"


def job_suspend(args, cluster) -> str:
    return _job_command(args, cluster, Action.ABORT_JOB, "suspend")


def job_resume(args, cluster) -> str:
    return _job_command(args, cluster, Action.RESUME_JOB, "resume")


def job_delete(args, cluster) -> str:
    try:
        cluster.delete("jobs", args.name, args.namespace)
    except NotFoundError:
        return f"Error: job {args.namespace}/{args.name} not found"
    return f"delete job {args.name} successfully"


# ---------------------------------------------------------------------------
# queue commands (pkg/cli/queue)
# ---------------------------------------------------------------------------

def apply_file(args, cluster: ClusterStore) -> str:
    """Apply every document of a (multi-doc) YAML file — Jobs, Queues and
    PodGroups, dispatched by `kind` (the kubectl-apply shape the
    reference's examples assume, e.g. example/hierarchical-jobs)."""
    from ..models import PodGroup, PodGroupSpec

    applied = []
    with open(args.filename) as f:
        docs = [d for d in yaml.safe_load_all(f) if d]
    # validate BEFORE applying anything: a bad document must not leave
    # the file half-applied (kubectl validates the whole file first)
    supported = {"Job", "Queue", "PodGroup"}
    bad = [d.get("kind", "Job") for d in docs
           if d.get("kind", "Job") not in supported]
    if bad:
        return (f"unsupported kind(s) {sorted(set(bad))} in "
                f"{args.filename}; nothing applied")
    for raw in docs:
        kind = raw.get("kind", "Job")
        meta = raw.get("metadata", {})
        if kind == "Job":
            obj = _job_from_yaml(raw)
            cluster.apply("jobs", obj)
        elif kind == "Queue":
            spec = raw.get("spec", {})
            obj = Queue(name=meta.get("name", "queue"),
                        annotations=meta.get("annotations", {}) or {},
                        spec=QueueSpec(
                            weight=int(spec.get("weight", 1)),
                            capability=spec.get("capability", {}) or {}))
            cluster.apply("queues", obj)
        elif kind == "PodGroup":
            spec = raw.get("spec", {})
            obj = PodGroup(
                name=meta.get("name", "podgroup"),
                namespace=meta.get("namespace", "default"),
                annotations=meta.get("annotations", {}) or {},
                spec=PodGroupSpec(
                    min_member=int(spec.get("minMember", 1)),
                    queue=spec.get("queue", "default")))
            cluster.apply("podgroups", obj)
        applied.append(f"{kind.lower()}/{meta.get('name', '?')}")
    return "applied " + ", ".join(applied)


def queue_create(args, cluster: ClusterStore) -> str:
    q = Queue(name=args.name, spec=QueueSpec(weight=args.weight))
    cluster.create("queues", q)
    return f"create queue {q.name} successfully"


def queue_list(args, cluster: ClusterStore) -> str:
    queues, applied_rv = _list_versioned(cluster, args, "queues")
    rows = []
    for q in sorted(queues, key=lambda x: x.name):
        rows.append([q.name, str(q.spec.weight), q.status.state.value,
                     str(q.status.inqueue), str(q.status.pending),
                     str(q.status.running), str(q.status.unknown)])
    return _table(["Name", "Weight", "State", "Inqueue", "Pending",
                   "Running", "Unknown"], rows) + _rv_footer(applied_rv)


def queue_get(args, cluster: ClusterStore) -> str:
    try:
        q = cluster.get("queues", args.name)
    except NotFoundError:
        return f"Error: queue {args.name} not found"
    return _table(["Name", "Weight", "State", "Inqueue", "Pending",
                   "Running", "Unknown"],
                  [[q.name, str(q.spec.weight), q.status.state.value,
                    str(q.status.inqueue), str(q.status.pending),
                    str(q.status.running), str(q.status.unknown)]])


def queue_operate(args, cluster: ClusterStore) -> str:
    try:
        q = cluster.get("queues", args.name)
    except NotFoundError:
        return f"Error: queue {args.name} not found"
    if args.action:
        action = (Action.OPEN_QUEUE if args.action == "open"
                  else Action.CLOSE_QUEUE)
        cluster.create("commands", Command(
            name=f"{args.action}-{q.name}-{int(time.time() * 1000) % 100000}",
            namespace="default", action=action,
            target_object={"kind": "Queue", "name": q.name, "uid": q.uid}))
        return f"{args.action} queue {q.name} successfully"
    if args.weight is not None:
        q.spec.weight = args.weight
        cluster.update("queues", q)
        return f"update queue {q.name} successfully"
    return "Error: nothing to do; specify --action or --weight"


def queue_delete(args, cluster: ClusterStore) -> str:
    try:
        cluster.delete("queues", args.name)
    except NotFoundError:
        return f"Error: queue {args.name} not found"
    return f"delete queue {args.name} successfully"


# ---------------------------------------------------------------------------
# status command (store topology + shard-worker liveness)
# ---------------------------------------------------------------------------

def _admission_table(lanes: dict) -> str:
    """Per-lane admission rows (resilience/overload.py stats shape)."""
    rows = []
    for lane in ("system", "control", "bulk", "read"):
        st = lanes.get(lane)
        if st is None:
            continue
        caps = "/".join(
            "inf" if not st.get(k) else str(st.get(k))
            for k in ("max_inflight", "max_queue", "max_streams"))
        reasons = st.get("shed_reasons") or {}
        rows.append([
            lane,
            str(st.get("inflight", 0)), str(st.get("streams", 0)),
            str(st.get("queued", 0)), str(st.get("admitted", 0)),
            str(st.get("sheds", 0)),
            str(st.get("deadline_expired", 0)),
            ",".join(f"{k}:{v}" for k, v in sorted(reasons.items()))
            or "-",
            caps,
        ])
    return _table(
        ["Lane", "Inflight", "Streams", "Queued", "Admitted", "Sheds",
         "DeadlineExp", "ShedReasons", "Limits(i/q/s)"], rows)


def _fmt_rv(rv) -> str:
    if isinstance(rv, dict):
        return ",".join(f"{sh}:{v}" for sh, v in sorted(rv.items()))
    return str(rv)


def _replica_chain_table(rinfo: dict, cluster) -> str:
    """Walk a replica's upstream chain hop by hop (replica_info on each
    parent until the primary answers store_info) and render one row per
    hop — the tree-debugging view: who feeds whom, how far behind, and
    how many re-bootstraps each hop has absorbed."""
    from ..client.remote import RemoteClusterStore
    rows = []

    def add_row(endpoint: str, info: dict) -> None:
        per = info.get("per_shard") or {}
        lag_r = ",".join(str(per[s].get("lag_records"))
                         for s in sorted(per)) or "-"
        lag_s = ",".join(
            "-" if per[s].get("lag_seconds") is None
            else f"{per[s]['lag_seconds']:.1f}"
            for s in sorted(per)) or "-"
        boots = ",".join(
            f"{k}:{v}" for k, v in
            sorted((info.get("bootstraps") or {}).items())) or "-"
        served = ",".join(
            f"{k}:{v}" for k, v in
            sorted((info.get("ship_served") or {}).items())) or "-"
        rows.append([str(info.get("depth", "?")), endpoint,
                     _fmt_rv(info.get("applied_rv")), lag_r, lag_s,
                     boots, served])

    add_row(f"{cluster.host}:{cluster.port}", rinfo)
    token = getattr(cluster, "token", "") or None
    upstream = rinfo.get("upstream")
    hops = 0
    while upstream and hops < 8:  # defensive: a cycle must not spin
        hops += 1
        c = None
        try:
            c = RemoteClusterStore(upstream, token=token,
                                   direct_routing=False,
                                   retry_attempts=1)
            try:
                uinfo = c._request({"op": "replica_info"})
            except Exception:  # noqa: BLE001 — not a replica: primary?
                uinfo = None
            if uinfo and uinfo.get("ok"):
                add_row(upstream, uinfo)
                upstream = uinfo.get("upstream")
                continue
            sinfo = c._request({"op": "store_info"})
            rows.append(["0", upstream, _fmt_rv(sinfo.get("rv")),
                         "-", "-", "-", "primary"])
            upstream = None
        except Exception as e:  # noqa: BLE001 — best-effort rendering
            rows.append(["?", upstream, "unreachable", "-", "-", "-",
                         f"{type(e).__name__}"])
            upstream = None
        finally:
            if c is not None:
                c.close()
    return _table(
        ["Depth", "Endpoint", "AppliedRv", "Lag(rec)", "Lag(s)",
         "Bootstraps", "ShipServed"], rows)


def status_cmd(args, cluster: ClusterStore) -> str:
    """Control-plane store status: shape, durability, rv(s) — for a
    multi-process sharded deployment, the shard map with per-worker
    endpoint, liveness, pid, restart count, uptime and ingest rate —
    and the overload-admission lane table (inflight / queued / sheds /
    deadline expirations per lane; works against plain, sharded, proc
    and replica endpoints alike)."""
    req = getattr(cluster, "_request", None)
    if req is None:
        shards = getattr(cluster, "n_shards", 1)
        durable = getattr(cluster, "data_dir", None) is not None
        return (f"store: in-process, shards={shards}, "
                f"durable={'yes' if durable else 'no'}, "
                f"rv={getattr(cluster, '_rv', 0)}")
    info = req({"op": "store_info"})
    try:
        topo = req({"op": "topology"})
    except Exception:  # noqa: BLE001 — pre-topology server
        topo = {"n_shards": info.get("shards", 1), "endpoints": []}
    rv = info.get("rv")
    lines = [f"store: shards={topo.get('n_shards', 1)}, "
             f"durable={'yes' if info.get('durable') else 'no'}, "
             f"recovered_records={info.get('recovered', 0)}"]
    workers = topo.get("workers") or []
    if workers:
        rows = []
        for w in workers:
            shard = str(w.get("shard"))
            shard_rv = (rv.get(shard) if isinstance(rv, dict)
                        else (rv if shard == "0" else ""))
            rows.append([shard, w.get("endpoint", ""),
                         "up" if w.get("alive") else "DOWN",
                         str(w.get("pid") or "-"),
                         str(w.get("restarts", 0)),
                         str(w.get("uptime_s", "")),
                         str(w.get("events_per_sec", "")),
                         str(shard_rv if shard_rv is not None else "")])
        lines.append(_table(
            ["Shard", "Endpoint", "State", "Pid", "Restarts",
             "Uptime(s)", "Events/s", "Rv"], rows))
    elif isinstance(rv, dict):
        lines.append(_table(
            ["Shard", "Rv"],
            [[sh, str(v)] for sh, v in sorted(rv.items())])
            + "\n(shards share the server process; no direct endpoints)")
    else:
        lines.append(f"rv: {rv}")
    try:
        rinfo = req({"op": "replica_info"})
    except Exception:  # noqa: BLE001 — not a replica endpoint
        rinfo = None
    if rinfo and rinfo.get("ok"):
        lines.append("replica upstream chain (this endpoint first):")
        lines.append(_replica_chain_table(rinfo, cluster))
    try:
        adm = req({"op": "admission_info"})
    except Exception:  # noqa: BLE001 — pre-admission (old) server
        adm = None
    if adm and adm.get("enabled"):
        lines.append("admission (front-door lanes):")
        lines.append(_admission_table(adm.get("lanes") or {}))
        worker_lanes = adm.get("workers") or {}
        for shard in sorted(worker_lanes, key=lambda s: int(s)):
            wl = worker_lanes[shard]
            if not wl:
                lines.append(f"admission shard {shard}: (worker down)")
                continue
            sheds = sum(st.get("sheds", 0) for st in wl.values())
            if sheds:
                lines.append(f"admission shard {shard} "
                             f"(worker gate, {sheds} sheds):")
                lines.append(_admission_table(wl))
        if worker_lanes and not any(
                sum(st.get("sheds", 0) for st in (wl or {}).values())
                for wl in worker_lanes.values()):
            lines.append(f"(each of the {len(worker_lanes)} shard "
                         "workers runs its own gate; no worker sheds)")
    elif adm is not None:
        lines.append("admission: gate disabled")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# sim command (sim/: trace-driven scheduling-quality harness)
# ---------------------------------------------------------------------------

def sim_cmd(args, cluster: ClusterStore) -> str:
    """Run the deterministic cluster simulator (record / verify / score).
    Self-contained: the sim builds its own virtual cluster, so the
    --server store (if any) is not touched. ``--device`` places its
    scheduler (the CUDA device by default)."""
    import json

    from ..sim import replay as sim_replay
    from ..sim.workload import WORKLOAD_PRESETS, Workload, WorkloadSpec

    spec = WorkloadSpec(seed=args.seed, cycles=args.cycles,
                        nodes=args.nodes, arrival_rate=args.rate,
                        fail_fraction=args.fail_fraction)
    conf = None
    if args.trace:
        workload = Workload.load(args.trace)
    elif args.preset:
        workload = WORKLOAD_PRESETS[args.preset](
            seed=args.seed, cycles=args.cycles, nodes=args.nodes)
        # defrag A/B arms share the binpack conf (see sim/__main__.py)
        from ..sim.virtualcluster import BINPACK_CONF
        conf = BINPACK_CONF
    else:
        workload = Workload(spec)
    reschedule = None
    if args.reschedule_interval > 0:
        reschedule = {
            "interval": args.reschedule_interval,
            "max_moves": args.reschedule_max_moves,
            "max_disruption_per_job": args.reschedule_max_disruption,
        }

    if args.verify:
        rep = sim_replay.verify(args.verify, workload=workload,
                                cycles=args.cycles, mode=args.mode,
                                drain=args.drain,
                                solver_mode=args.solver_mode,
                                sharded_byte_budget=args.sharded_byte_budget,
                                scheduler_conf=conf,
                                reschedule=reschedule,
                                device=args.device)
        status = "replay OK (byte-identical)" if rep["ok"] \
            else "replay DIVERGED"
        out = [f"{status}: {rep['cycles']} cycles, digest {rep['digest']}"]
        if rep["divergence"] is not None:
            out.append(json.dumps(rep["divergence"], sort_keys=True))
        return "\n".join(out)

    result = sim_replay.run_sim(workload=workload, cycles=args.cycles,
                                mode=args.mode, drain=args.drain,
                                record_path=args.record,
                                solver_mode=args.solver_mode,
                                sharded_byte_budget=args.sharded_byte_budget,
                                scheduler_conf=conf,
                                reschedule=reschedule,
                                device=args.device)
    sc = result.score
    out = [
        f"sim: {sc['cycles']} cycles, mode={args.mode}, seed={args.seed}",
        f"jobs: {sc['jobs_arrived']} arrived, {sc['jobs_served']} served, "
        f"{sc['jobs_completed']} completed; {sc['pods_bound']} pods bound",
        f"fragmentation: index {sc['fragmentation_index']}, largest free "
        f"slot {sc['largest_free_slot_mean']}; {sc['migrations']} "
        f"migrations (churn {sc['migration_churn']})",
        f"digest: {result.digest}",
    ]
    # the aggregated FitErrors summaries ("x/y tasks unschedulable: ...")
    # from the final cycle — the same strings the recorder traces
    last = result.vc.recorder.last_record() or {}
    for job, msg in sorted((last.get("unschedulable") or {}).items()):
        out.append(f"unschedulable {job}: {msg}")
    if args.record:
        out.append(f"trace recorded to {args.record}")
    out.append(json.dumps({"score": sc}, sort_keys=True))
    return "\n".join(out)


# ---------------------------------------------------------------------------
# parser
# ---------------------------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="vcctl",
                                description="volcano_tpu_torch command line "
                                            "client")
    p.add_argument("--server", "-s", default=None, metavar="HOST:PORT",
                   help="drive a deployed control plane over TCP "
                        "(standalone --serve-store) instead of an "
                        "in-process store")
    p.add_argument("--replica", default=None, metavar="HOST:PORT",
                   help="route READ commands (job list/view, queue "
                        "list/get) to a read replica (standalone "
                        "--serve-replica) instead of the primary; "
                        "output then reports the replica's applied_rv "
                        "so staleness is visible at a glance. Writes "
                        "still go to --server (a replica refuses them)")
    p.add_argument("--min-rv", type=int, default=None, dest="min_rv",
                   metavar="RV",
                   help="rv-bounded read: block until the (replica) "
                        "store has applied this resource_version, fail "
                        "typed if it cannot within the wait budget — "
                        "read-your-writes against an explicitly stale "
                        "read tier")
    p.add_argument("--token", default=None,
                   help="store auth token (default $VOLCANO_STORE_TOKEN)")
    p.add_argument("--tls-ca", default=None, metavar="PEM",
                   help="verify the store server's TLS cert against this "
                        "CA bundle (default $VOLCANO_STORE_CA)")
    sub = p.add_subparsers(dest="group")

    jobp = sub.add_parser("job")
    jsub = jobp.add_subparsers(dest="verb")
    run = jsub.add_parser("run")
    run.add_argument("--name", "-N", default="job")
    run.add_argument("--namespace", "-n", default="default")
    run.add_argument("--image", "-i", default="busybox")
    run.add_argument("--replicas", "-r", type=int, default=1)
    run.add_argument("--min-available", "-m", type=int, default=0,
                     dest="min_available")
    run.add_argument("--requests", default="cpu=1,memory=1Gi")
    run.add_argument("--scheduler", "-S", default="volcano")
    run.add_argument("--queue", "-q", default="")
    run.add_argument("--filename", "-f", default=None)
    for verb in ("list",):
        v = jsub.add_parser(verb)
        v.add_argument("--namespace", "-n", default=None)
    for verb in ("view", "suspend", "resume", "delete"):
        v = jsub.add_parser(verb)
        v.add_argument("--name", "-N", required=True)
        v.add_argument("--namespace", "-n", default="default")

    queuep = sub.add_parser("queue")
    qsub = queuep.add_subparsers(dest="verb")
    qc = qsub.add_parser("create")
    qc.add_argument("--name", "-n", required=True)
    qc.add_argument("--weight", "-w", type=int, default=1)
    qsub.add_parser("list")
    for verb in ("get", "delete"):
        v = qsub.add_parser(verb)
        v.add_argument("--name", "-n", required=True)
    qo = qsub.add_parser("operate")
    qo.add_argument("--name", "-n", required=True)
    qo.add_argument("--weight", "-w", type=int, default=None)
    qo.add_argument("--action", "-a", choices=["open", "close"], default=None)

    applyp = sub.add_parser("apply")
    applyp.add_argument("--filename", "-f", required=True)

    simp = sub.add_parser(
        "sim", help="trace-driven cluster simulator "
                    "(record/replay/score scheduling quality)")
    simp.add_argument("--cycles", type=int, default=100)
    simp.add_argument("--seed", type=int, default=0)
    simp.add_argument("--solver-mode", default=None,
                      choices=["packed", "sharded", "auto"],
                      help="device-solver routing: packed = single-device "
                           "arena, sharded = node-axis sharded arena, "
                           "auto = shard when the padded problem exceeds "
                           "--sharded-byte-budget bytes per device "
                           "(applies when --mode is left at its default)")
    simp.add_argument("--sharded-byte-budget", type=int,
                      default=256 * 1024 * 1024,
                      help="per-device resident-state budget for "
                           "--solver-mode auto (bytes; default 256 MiB)")
    simp.add_argument("--mode", default="solver",
                      choices=["solver", "host", "sequential", "sharded"])
    simp.add_argument("--nodes", type=int, default=8)
    simp.add_argument("--rate", type=float, default=1.5)
    simp.add_argument("--fail-fraction", type=float, default=0.0,
                      dest="fail_fraction")
    simp.add_argument("--drain", type=int, default=0)
    simp.add_argument("--record", metavar="PATH", default=None)
    simp.add_argument("--verify", metavar="PATH", default=None)
    simp.add_argument("--trace", metavar="PATH", default=None)
    simp.add_argument("--preset", default=None, choices=["fragmented"],
                      help="named seeded workload preset (the fragmented "
                           "500-cycle defrag baseline)")
    simp.add_argument("--reschedule-interval", type=int, default=0,
                      metavar="N",
                      help="enable the global rescheduler: defrag solve "
                           "every N cycles (0 = off)")
    simp.add_argument("--reschedule-max-moves", type=int, default=8,
                      help="migration budget per defrag plan")
    simp.add_argument("--reschedule-max-disruption-per-job", type=int,
                      default=1, dest="reschedule_max_disruption",
                      help="PDB-style per-job disruption cap per plan")
    simp.add_argument("--device", default=None,
                      help="torch device of the sim's scheduler (default: "
                           "the CUDA device; 'cpu' runs on the host)")

    sub.add_parser(
        "status", help="store topology + shard-worker liveness "
                       "(per-worker pid/restarts/uptime/ingest against "
                       "a multi-process sharded deployment)")

    sub.add_parser("version")
    return p


_DISPATCH = {
    ("job", "run"): job_run,
    ("job", "list"): job_list,
    ("job", "view"): job_view,
    ("job", "suspend"): job_suspend,
    ("job", "resume"): job_resume,
    ("job", "delete"): job_delete,
    ("queue", "create"): queue_create,
    ("queue", "list"): queue_list,
    ("queue", "get"): queue_get,
    ("queue", "operate"): queue_operate,
    ("queue", "delete"): queue_delete,
    ("apply", None): apply_file,
    ("sim", None): sim_cmd,
    ("status", None): status_cmd,
}

#: standalone binary aliases (cmd/cli/{vsub,vjobs,...})
ALIASES = {
    "vsub": ["job", "run"],
    "vjobs": ["job", "list"],
    "vqueues": ["queue", "list"],
    "vcancel": ["job", "delete"],
    "vsuspend": ["job", "suspend"],
    "vresume": ["job", "resume"],
}


#: (group, verb) pairs safe to serve from a read replica
_READ_VERBS = {("job", "list"), ("job", "view"),
               ("queue", "list"), ("queue", "get"),
               ("status", None)}


def main(argv: List[str], cluster: Optional[ClusterStore] = None) -> str:
    if argv and argv[0] in ALIASES:
        argv = ALIASES[argv[0]] + argv[1:]
    args = build_parser().parse_args(argv)
    verb = getattr(args, "verb", None)
    if cluster is None:
        if args.replica and (args.group, verb) in _READ_VERBS:
            # the read tier: same wire protocol, explicit staleness
            from ..client.remote import RemoteClusterStore
            cluster = RemoteClusterStore(args.replica, token=args.token,
                                         tls_ca=args.tls_ca)
        elif args.server:
            # the wire path of cmd/cli/vcctl.go:44-49 (kubeconfig -> API
            # server); here HOST:PORT -> standalone's StoreServer
            from ..client.remote import RemoteClusterStore
            cluster = RemoteClusterStore(args.server, token=args.token,
                                         tls_ca=args.tls_ca)
        elif args.replica and args.group not in (None, "version", "sim"):
            raise SystemExit(
                f"vcctl {args.group} {verb or ''} mutates the cluster; "
                "a replica is read-only — point --server at the primary")
        elif args.token or args.tls_ca:
            # succeeding against a throwaway in-process store while the
            # user thinks they reached a deployed control plane is a trap
            raise SystemExit(
                "--token/--tls-ca require --server HOST:PORT")
        else:
            cluster = ClusterStore()
    if args.group == "version":
        return f"vcctl version {__version__}"
    fn = _DISPATCH.get((args.group, verb))
    if fn is None:
        return build_parser().format_help()
    return fn(args, cluster)
