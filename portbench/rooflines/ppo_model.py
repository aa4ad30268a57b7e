"""The model FLOPs of one PPO iteration of the actor-critic MLP, counted
from its shapes: a forward (2 FLOP a multiply-add of every dense layer:
W1, W2, Wm, Wv, Wv2) over every rollout sample and over the last
observations, and forward plus backward (3 forwards) over every sample
in each epoch.  As bf16 operations: the iteration's least time at the
card's bf16 peak, which ``train.mfu_pct`` sets against its time."""

import os

from portbench.spec import load_module

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def forward_flops(od: int, aw: int, H: int) -> int:
    return 2 * (od * H + H * H + H * aw + od * H + H)


def count(config: dict, traffic: dict) -> dict:
    s = load_module("rooflines", "ppo_update", BENCH_DIR).shapes(config,
                                                                 traffic)
    ppo = traffic["ppo"]
    A = len(config["agents"])
    n = ppo["rollout_steps"] * A * traffic["num_envs"]
    f = forward_flops(s["od"], s["aw"], s["H"])
    flops = f * (n + A * traffic["num_envs"]) + 3 * f * n * ppo["epochs"]
    return {"bytes": 0, "ops": {"bf16": flops}}
