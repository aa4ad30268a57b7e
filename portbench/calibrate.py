"""The readings that a rollout cell's correctness limits are set from.

    python3 -m portbench.calibrate --workload <name> --seeds 12 \\
        --control 3 --seconds 4 [--first-seed N] [--out FILE]

For each of ``--seeds`` seeds (``first-seed``, ``first-seed + 1``, ...),
in one process: the cell at its size, a short window of ``--seconds``,
and the comparison's numbers of the program (the lower readings).  For
the first ``--control`` seeds also the control's: the reference put in
the program's place in the precision below the configuration's, and, in
a training cell, the reference with each planted fault (the upper
readings); the cell's kind (``kinds/<kind>.py``, ``calibrate``) says
how.  Prints one JSON line a seed, then the largest sound and the
smallest control and fault reading of each number.  The benchmark's own
runs do not run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--first-seed", type=int, default=1_000_003)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch

    from portbench.spec import load_cell

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 1
    cell = load_cell(args.workload)
    kind = cell.module("kinds", cell.traffic["kind"])
    rows = []
    for i in range(args.seeds):
        seed = args.first_seed + i
        t0 = time.perf_counter()
        row = {"seed": seed, **kind.calibrate(cell, seed, args.seconds,
                                               i < args.control)}
        row["seconds"] = time.perf_counter() - t0
        rows.append(row)
        print(json.dumps(row), flush=True)
    keys = rows[0]["sound"].keys()
    summary = {"workload": args.workload,
               "device": torch.cuda.get_device_name(0),
               "lower": {k: max(r["sound"][k] for r in rows) for k in keys},
               "control": {k: min(r["control"][k] for r in rows
                                  if "control" in r) for k in keys}
               if args.control else {}}
    for name in sorted({f for r in rows for f in r.get("faults", {})}):
        summary[name] = {k: min(r["faults"][name][k] for r in rows
                                if name in r.get("faults", {}))
                         for k in keys}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
