"""What the traffic kinds share: seeds, the device's synchronize, and the
passage of a state between the benchmark and the port's state API."""
from __future__ import annotations

import numpy as np

STATE_FIELDS = ("pos", "vel", "rot", "ang_vel", "steps")


def sub_seeds(seed: int, n: int):
    """``n`` independent 62-bit seeds from ``seed`` (any whole number)."""
    words = np.random.SeedSequence(seed % 2**128).generate_state(
        2 * n, dtype=np.uint32)
    return [(int(words[2 * i]) << 30) ^ int(words[2 * i + 1])
            for i in range(n)]


def sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def program_state(env, init: dict):
    """The port's ``WorldState`` holding ``init`` (a reference state dict:
    ``pos``, ``vel``, ``rot``, ``ang_vel``, ``steps`` and ``extras`` under
    the port's names): the env's own state with every field and extras
    buffer replaced, action fields zero as after a reset."""
    import torch

    s = env.state
    if set(s.extras) != set(init["extras"]):
        raise KeyError(
            f"the configuration's initial state holds the extras"
            f" {sorted(init['extras'])}, the env {sorted(s.extras)}")
    fields = {f: init[f].clone() for f in STATE_FIELDS}
    fields.update({f: torch.zeros_like(getattr(s, f))
                   for f in ("force", "torque", "c", "u", "action_c")})
    return s.replace(**fields,
                     extras={k: v.clone() for k, v in init["extras"].items()})


def take_rows(state, rows) -> dict:
    """The envs ``rows`` of a port ``WorldState``, as a reference state."""
    out = {f: getattr(state, f)[rows] for f in STATE_FIELDS}
    out["extras"] = {k: v[rows] for k, v in state.extras.items()}
    return out
