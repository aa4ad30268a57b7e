"""The collector's policy in the rollout cells: a fixed random map of each
agent's own observation, ``tanh(obs . W + b + sin(omega * t + phi))``,
with ``t`` the env's step count and ``W``, ``b``, ``omega``, ``phi`` drawn
for each env and agent.  The sine gives each env and action dimension a
forcing of its own period (10-60 steps), so that no env settles into a
fixed point where a frozen step would look right.  Weights of its own
for each env make the work of a window the same from seed to seed: one
random map shared by all envs would steer them all alike, more or less
into contact.

It is the benchmark's, not the program's: both sides of the comparison
run this same code on the same weights, made from the seed on the device.
"""
from __future__ import annotations

import math

import torch


class LinearTanhPolicy:
    def __init__(self, n_agents: int, obs_dim: int, act_dim: int,
                 num_envs: int, generator: torch.Generator, device):
        def randn(*shape):
            return torch.randn(shape, generator=generator, device=device)

        def rand(*shape):
            return torch.rand(shape, generator=generator, device=device)

        self.w = randn(n_agents, num_envs, obs_dim, act_dim) / math.sqrt(
            obs_dim)
        self.b = 0.1 * randn(n_agents, num_envs, act_dim)
        self.omega = 2 * math.pi / (10 + 50 * rand(n_agents, num_envs, act_dim))
        self.phi = 2 * math.pi * rand(n_agents, num_envs, act_dim)

    def rows(self, rows: torch.Tensor) -> "LinearTanhPolicy":
        """The same policy over the envs ``rows`` only."""
        out = object.__new__(LinearTanhPolicy)
        for name in ("w", "b", "omega", "phi"):
            setattr(out, name, getattr(self, name)[:, rows])
        return out

    def __call__(self, obs: torch.Tensor, steps: torch.Tensor) -> torch.Tensor:
        """Actions ``[A, B, act_dim]`` in [-1, 1] from ``obs [A, B, D]``
        and the envs' step counts ``steps [B]``."""
        t = steps.to(torch.float32)[None, :, None]
        pre = (obs.to(torch.float32)[..., None] * self.w).sum(-2) + self.b
        return torch.tanh(pre + torch.sin(self.omega * t + self.phi))
