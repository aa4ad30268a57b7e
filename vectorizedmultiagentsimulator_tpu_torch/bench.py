"""The port's bench: ``bench.py``'s workload on one NVIDIA GPU.

    python -m vectorizedmultiagentsimulator_tpu_torch.bench

Steady-state env-steps/s of the complete step (action decode, dynamics,
physics, observations, rewards, dones) of ``make_env(BENCH_SCENARIO,
BENCH_NUM_ENVS)`` on the card: fixed actions uniform in [-1, 1] from seed
0, each step's observations and rewards consumed into a sink (checked
finite), ``BENCH_STEPS`` steps as a CUDA graph of ``BENCH_CHUNK`` steps
replayed (``utils.profiling.benchmark_step``), the best of 3 timings on the
host clock ended by a synchronize.

Environment variables, as ``bench.py`` reads them: ``BENCH_SCENARIO``
(transport), ``BENCH_NUM_ENVS`` (30,000), ``BENCH_STEPS`` (4,000) and
``BENCH_CHUNK``.  The chunk defaults to 100 steps, not ``bench.py``'s
whole run: a replay costs the host one launch, so a longer graph saves
nothing and takes longer to capture.

Prints the card's name and power limit, then as its last line ONE JSON
line in ``bench.py``'s keys: ``{"metric", "value", "unit",
"vs_baseline"}``, ``vs_baseline`` against the reference's 296k
env-steps/s (simple_spread at 30k envs on an RTX 2080 Ti, BASELINE.md).
Without a card it exits with an error and prints no result.
"""
import json
import os
import subprocess
import sys

import torch

REFERENCE_EPS = 296_000.0


def main():
    if not torch.cuda.is_available():
        sys.exit("bench: needs a CUDA GPU; none is available")
    import vectorizedmultiagentsimulator_tpu_torch as vmt
    from vectorizedmultiagentsimulator_tpu_torch.utils.profiling import (
        benchmark_step,
    )

    scenario = os.environ.get("BENCH_SCENARIO", "transport")
    num_envs = int(os.environ.get("BENCH_NUM_ENVS", 30_000))
    n_steps = int(os.environ.get("BENCH_STEPS", 4000))
    chunk = min(int(os.environ.get("BENCH_CHUNK", 100)), n_steps)
    total = max(1, n_steps // chunk) * chunk
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0], flush=True)
    env = vmt.make_env(scenario, num_envs=num_envs, seed=0)
    result = benchmark_step(env, n_steps=total, n_repeats=3, warmup=True,
                            chunk=chunk)
    eps = result["env_steps_per_s"]
    print(json.dumps({
        "metric": f"{scenario}_env_steps_per_sec_{num_envs}envs",
        "value": round(eps),
        "unit": "env-steps/s",
        "vs_baseline": round(eps / REFERENCE_EPS, 2),
    }), flush=True)


if __name__ == "__main__":
    main()
