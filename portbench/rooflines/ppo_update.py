"""Operations and bytes of one launch of the port's PPO update (the
``ppo_update_kernel`` of one minibatch and its ``ppo_reduce_kernel``),
counted from the policy's shapes and the minibatch: a copy of the port's
``chip_smoke.py`` ``ppo_bound_ms``.  Bytes: the minibatch's columns of the
packed rollout, the block indices, the advantage statistics and the
parameters read once, the gradients and the three loss sums written once.
Operations: the trunk's products (bf16 operands, fp32 sums: W1, Wv, W2
forward; dW1, dWv, dW2, dh1 backward) at the tensor cores' bf16 rate; the
fp32 heads (Wm, Wv2 and their three backward products) and the
elementwise work (3H tanh and their derivatives, the loss head) at the
fp32 rate."""

KERNELS = ("ppo_update_kernel", "ppo_reduce_kernel")
LAUNCH = "ppo_update_kernel"


def shapes(config: dict, traffic: dict) -> dict:
    """The update's sizes: observation rows with the one-hot agent id,
    action width, hidden size, packed rows, minibatch and block."""
    ppo = traffic["ppo"]
    A = len(config["agents"])
    od, aw, H = config["obs_dim"] + A, config["action_dim"], ppo["hidden"]
    n = ppo["rollout_steps"] * A * traffic["num_envs"]
    return {"od": od, "aw": aw, "H": H, "d": od + aw + 3 + aw,
            "mb": n // ppo["minibatches"], "lb": ppo["fused_block"]}


def n_params(od: int, aw: int, H: int) -> int:
    """W1, b1, W2, b2, Wm, bm, log_std, Wv, bv, Wv2, bv2."""
    return (od * H + H + H * H + H + H * aw + aw + aw + od * H + H + H + 1)


def count(config: dict, traffic: dict) -> dict:
    s = shapes(config, traffic)
    od, aw, H, mb = s["od"], s["aw"], s["H"], s["mb"]
    moved = 4 * (s["d"] * mb + mb // s["lb"] + 2
                 + 2 * n_params(od, aw, H) + 3)
    trunk = 2 * (4 * od * H + 3 * H * H) * mb
    rest = (2 * (3 * H * aw + 2 * H) + 15 * H + 30 * aw) * mb
    return {"bytes": moved, "ops": {"bf16": trunk, "fp32": rest}}
