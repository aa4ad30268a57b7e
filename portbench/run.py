"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  The cell's traffic kind (``kinds/<kind>.py``) builds the port's
system at the cell's size, warms it, measures for ``--seconds``, then
compares what the timed path produced with the configuration's plain
reference.  The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics read by
``layers/<metric>.py``), ``device`` and, last, ``check``: each number the
comparison gave beside its limit, which are also the last lines on
standard error.  Without the cards, or if JAX or the JAX package was
loaded, it prints no result and exits with another code than 0.

Set-up (``setup_s``) is counted from the start of this process.
"""
import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

# Whole top-level module names that the benchmark's process may not hold
# (the port's own name begins with the last one).
FORBIDDEN = ("jax", "jaxlib", "flax", "vectorizedmultiagentsimulator_tpu")


def parse(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def execute(cell, args, started: float, device="cuda"):
    """Run ``cell`` as ``args`` say on ``device``: a ``RunResult``."""
    return cell.module("kinds", cell.traffic["kind"]).run(
        cell, args, started, device)


def report(res, trace: bool, device_name: str, chips: int) -> dict:
    """The result's line: ``metrics`` are the cell's end-to-end metrics,
    or, traced, the per-layer metrics whose readers found something."""
    metrics = {}
    if trace:
        for m in res.cell.per_layer:
            value = res.cell.module("layers", m["name"]).read(res)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in res.cell.end_to_end:
            metrics[m["name"]] = {"value": res.metrics[m["name"]],
                                  "unit": m["unit"]}
    device = {"platform": "gpu", "kind": device_name, "count": chips,
              "memory_peak_bytes": res.memory_peak_bytes}
    line = {"correct": bool(res.checks and all(c.ok for c in res.checks)
                            and res.failed == 0),
            "attempted": res.attempted, "failed": res.failed,
            "metrics": metrics, "device": device}
    if trace and res.trace is not None:
        device["busy_s"] = res.trace.busy_s()
        device["window_s"] = res.trace.wall_s
        line["breakdown"] = {"device_ops": res.trace.top_ops(10),
                             "idle_gaps": res.trace.idle_gaps(10)}
    line["check"] = {c.name: {"value": c.value, "limit": c.limit}
                     for c in res.checks}
    return line


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from portbench.spec import load_cell

    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell.chips):
        print(f"portbench: {args.workload} needs {cell.chips} CUDA"
              f" device(s); {torch.cuda.device_count()} available",
              file=sys.stderr)
        return 1
    torch.set_num_threads(2)
    res = execute(cell, args, STARTED)
    loaded = forbidden_modules()
    if loaded:
        print(f"portbench: the run loaded {loaded}", file=sys.stderr)
        return 2
    line = report(res, bool(args.trace), torch.cuda.get_device_name(0),
                  cell.chips)
    for k, v in res.extra.items():
        print(f"portbench: {k} {v!r}", file=sys.stderr)
    for c in res.checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r}"
              f" {'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
