"""Fixed-length rollouts: a Python loop over ``env.step`` (the JAX
package's ``lax.scan`` rollout; a CUDA-graph version is ROADMAP Queue 1
item 5)."""
from __future__ import annotations

from typing import Dict, List, Sequence


def rollout(env, n_steps: int, actions: Sequence) -> Dict[str, List]:
    """Step ``env`` with ``actions[t]`` (one per-agent action list per step)
    for ``t < n_steps``; returns ``{"obs", "rews", "dones"}`` as lists over
    time.  No output is read on the host, so on a GPU the loop never waits
    for the device."""
    traj = {"obs": [], "rews": [], "dones": []}
    for t in range(n_steps):
        obs, rews, dones = env.step(actions[t])[:3]
        traj["obs"].append(obs)
        traj["rews"].append(rews)
        traj["dones"].append(dones)
    return traj
