"""CLI entry: ``python -m volcano_tpu_torch.sim``.

Prints the canonical decision trace (one JSONL record per virtual cycle)
followed by one summary line ``{"sim": {...score...}, "digest": ...}``.
Everything printed derives from the virtual clock, so the same seed and
flags produce byte-identical stdout — the property the golden-trace
tier-1 tests pin.

Modes:
  (default)        run a seeded workload, print trace + score
  --record PATH    also write the trace to PATH (golden trace)
  --verify PATH    re-run and diff against a golden trace; exit 2 on
                   divergence with a structured first-divergence report
  --trace PATH     load the workload from an external JSONL trace
                   instead of generating one
  --emit-workload PATH  write the generated workload trace (editable,
                   reloadable via --trace) and exit

The scheduler runs on the CUDA device; ``--device cpu`` runs it on the
host. Without a CUDA device and without ``--device cpu`` the run raises.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="volcano-tpu-torch-sim")
    ap.add_argument("--cycles", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mode", default="solver",
                    choices=["solver", "host", "sequential", "sharded"],
                    help="allocate execution mode under test")
    ap.add_argument("--nodes", type=int, default=8)
    ap.add_argument("--rate", type=float, default=1.5,
                    help="expected job arrivals per cycle (Poisson)")
    ap.add_argument("--gang-max", type=int, default=3)
    ap.add_argument("--duration-max", type=int, default=12)
    ap.add_argument("--fail-fraction", type=float, default=0.0)
    ap.add_argument("--drain", type=int, default=0,
                    help="extra cycles to let in-flight jobs finish")
    ap.add_argument("--preempt", action="store_true",
                    help="enable the preempt action")
    ap.add_argument("--record", metavar="PATH",
                    help="write the decision trace to PATH")
    ap.add_argument("--verify", metavar="PATH",
                    help="verify against a golden trace at PATH")
    ap.add_argument("--trace", metavar="PATH",
                    help="load the workload from a JSONL trace")
    ap.add_argument("--preset", default=None,
                    choices=["fragmented"],
                    help="named seeded workload preset (overrides the "
                         "generator knobs; --seed/--cycles/--nodes still "
                         "apply)")
    ap.add_argument("--reschedule-interval", type=int, default=0,
                    metavar="N",
                    help="enable the global rescheduler: run the defrag "
                         "solve every N cycles (0 = off)")
    ap.add_argument("--reschedule-max-moves", type=int, default=8,
                    help="migration budget per defrag plan")
    ap.add_argument("--reschedule-max-disruption-per-job", type=int,
                    default=1, dest="reschedule_max_disruption",
                    help="PDB-style per-job disruption cap per plan")
    ap.add_argument("--emit-workload", metavar="PATH",
                    help="write the generated workload trace and exit")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress per-cycle trace lines on stdout")
    ap.add_argument("--device", default=None,
                    help="torch device of the scheduler's arena (default: "
                         "the CUDA device; 'cpu' runs on the host)")
    args = ap.parse_args(argv)

    from .replay import run_sim, verify
    from .workload import WORKLOAD_PRESETS, Workload, WorkloadSpec

    spec = WorkloadSpec(seed=args.seed, cycles=args.cycles,
                        nodes=args.nodes, arrival_rate=args.rate,
                        gang_max=args.gang_max,
                        duration_max=args.duration_max,
                        fail_fraction=args.fail_fraction)
    conf = None
    if args.trace:
        workload = Workload.load(args.trace)
    elif args.preset:
        workload = WORKLOAD_PRESETS[args.preset](
            seed=args.seed, cycles=args.cycles, nodes=args.nodes)
        # both arms of a defrag A/B run the binpack conf: the baseline
        # must already pack as well as the scorer can, so the reschedule
        # gain measures un-done HISTORY, not a handicapped allocate
        from .virtualcluster import BINPACK_CONF
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

    if args.emit_workload:
        workload.save(args.emit_workload)
        print(json.dumps({"workload": args.emit_workload,
                          "events": len(workload.events),
                          "pods": workload.total_pods}))
        return 0

    if args.verify:
        rep = verify(args.verify, workload=workload, cycles=args.cycles,
                     mode=args.mode, drain=args.drain,
                     preempt=args.preempt, scheduler_conf=conf,
                     reschedule=reschedule, device=args.device)
        print(json.dumps(rep, sort_keys=True))
        return 0 if rep["ok"] else 2

    result = run_sim(workload=workload, cycles=args.cycles,
                     mode=args.mode, drain=args.drain,
                     preempt=args.preempt, record_path=args.record,
                     scheduler_conf=conf, reschedule=reschedule,
                     device=args.device)
    if not args.quiet:
        for line in result.lines:
            print(line)
    print(json.dumps({"sim": result.score, "digest": result.digest},
                     sort_keys=True, separators=(",", ":")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
