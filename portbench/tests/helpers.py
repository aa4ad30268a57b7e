"""Cells of ``BENCHMARK.json`` cut to a size a CPU test run holds."""
import time
import types

from portbench import run as R
from portbench.spec import load_cell

# The traffic of each kind at a tiny size: every env compared, so that a
# fault in one env shows.
TINY = {
    "rollout": dict(num_envs=48, steps_per_call=8, check_calls=3,
                    check_rows=48, trace_calls=1),
    "train": dict(num_envs=512),
}


def tiny_cell(workload: str, **traffic):
    cell = load_cell(workload)
    cell.traffic = dict(cell.traffic, **TINY[cell.traffic["kind"]],
                        **traffic)
    return cell


def run_cpu(cell, seed=2**33 + 17, seconds=1.0):
    """A run of ``cell`` on the CPU (the plain path): its result line."""
    args = types.SimpleNamespace(seed=seed, seconds=seconds, trace=0)
    res = R.execute(cell, args, time.perf_counter(), device="cpu")
    return res, R.report(res, False, "cpu", cell.chips)
