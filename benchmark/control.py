"""The correctness check's control, on the card at a cell's own size.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \
        --seconds <s> [--dtype bfloat16]

For each seed, one run of the cell (set-up, a window of ``--seconds``),
then over the same cycles two readings: the program's bind and eviction
mismatches against the float32 reference (the lower reading, which sound
runs give) and those of the reference computed with its node scores in
``--dtype`` (the control, the upper reading). The reference is the one
the cell's configuration names (``check.reference_module``). One JSON
line a seed, then a summary. The benchmark's own runs do not run this.
"""

from __future__ import annotations

import os
import sys


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--dtype", default="bfloat16")
    args = ap.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import torch

    from benchmark.core import run_cell

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    dtype = getattr(torch, args.dtype)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        out = run_cell(args.workload, seed, args.seconds, False,
                       root=root, control_dtype=dtype)
        row = {"seed": seed, "correct": out["correct"],
               "program": out["checks"]["bind_mismatches"]["value"],
               "control": out["control_bind_mismatches"],
               "program_evictions":
                   out["checks"]["eviction_mismatches"]["value"],
               "control_evictions": out["control_eviction_mismatches"],
               "compared_cycles": out["compared_cycles"],
               "failed": out["failed"], "check_s": out["check_s"]}
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps({
        "workload": args.workload, "dtype": args.dtype,
        "lower": max(r["program"] for r in rows),
        "upper": min(r["control"] for r in rows),
        "lower_evictions": max(r["program_evictions"] for r in rows),
        "upper_evictions": min(r["control_evictions"] for r in rows),
        "seeds": len(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
