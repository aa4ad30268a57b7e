"""PPO training-throughput benchmark of the PyTorch/CUDA port: end-to-end
training env-steps/s of ``examples/torch_ppo.py`` (rollout with masked
resets, GAE, and every epoch and minibatch on the device), the counterpart
of the JAX package's ``tools/bench_ppo.py`` with the same cells and the same
JSON line.

Usage: python -m vectorizedmultiagentsimulator_tpu_torch.examples.bench_ppo \\
           [scenario] [num_envs] [iters] [mode] [device]
mode: continuous (default) | discrete | multidiscrete.  Runs on the CUDA
card unless ``device`` is ``cpu``.  Prints one JSON line per cell; each
names the device it ran on.
"""
import json
import sys
import time

import torch

from vectorizedmultiagentsimulator_tpu_torch.examples.torch_ppo import (
    PPOConfig,
    init_training,
)

# The cells of the JAX package's PPO benchmark: continuous actions, 64-step
# rollouts.
CELLS = (("simple_spread", 4096), ("transport", 4096), ("transport", 16384))


def _wait(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench(scenario, num_envs, iters=20, cfg=PPOConfig(), mode="continuous",
          device=None):
    kw = {}
    if mode in ("discrete", "multidiscrete"):
        kw["continuous_actions"] = False
    if mode == "multidiscrete":
        kw["multidiscrete_actions"] = True
    t0 = time.time()
    env, train_step, trainer = init_training(
        scenario, num_envs, cfg=cfg, device=device, **kw
    )
    # Warm-up: builds the kernels at their first launches.
    trainer, metrics = train_step(trainer)
    _wait(env.device)
    build_s = time.time() - t0

    t0 = time.time()
    for _ in range(iters):
        trainer, metrics = train_step(trainer)
    _wait(env.device)
    wall = time.time() - t0
    loss = float(metrics["loss"])
    assert loss == loss and abs(loss) != float("inf"), "loss is not finite"

    env_steps = iters * cfg.rollout_steps * num_envs
    row = {
        "bench": "ppo_training",
        "scenario": scenario,
        "mode": mode,
        "num_envs": num_envs,
        "rollout_steps": cfg.rollout_steps,
        "iters": iters,
        "wall_s": round(wall, 4),
        "train_env_steps_per_s": round(env_steps / wall),
        "final_loss": round(loss, 4),
        "build_and_compile_s": round(build_s, 1),
        "fused_update": trainer.fused,
        "device": (torch.cuda.get_device_name(env.device)
                   if env.device.type == "cuda" else "cpu"),
    }
    print(json.dumps(row), flush=True)
    return row


def main():
    if len(sys.argv) > 1:
        scenario = sys.argv[1]
        num_envs = int(sys.argv[2]) if len(sys.argv) > 2 else 4096
        iters = int(sys.argv[3]) if len(sys.argv) > 3 else 20
        mode = sys.argv[4] if len(sys.argv) > 4 else "continuous"
        device = sys.argv[5] if len(sys.argv) > 5 else None
        bench(scenario, num_envs, iters, mode=mode, device=device)
        return
    for scenario, num_envs in CELLS:
        bench(scenario, num_envs)


if __name__ == "__main__":
    main()
