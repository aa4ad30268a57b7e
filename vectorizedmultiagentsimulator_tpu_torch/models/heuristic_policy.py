"""Heuristic policy interface (reference
``vmas/simulator/heuristic_policy.py``).  Per-scenario policies map
``observation [B, obs] -> action [B, act]`` tensors."""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Optional

import torch


class BaseHeuristicPolicy(ABC):
    def __init__(self, continuous_action: bool = True):
        self.continuous_actions = continuous_action

    @abstractmethod
    def compute_action(self, observation: torch.Tensor, u_range: float) -> torch.Tensor:
        raise NotImplementedError


class RandomPolicy(BaseHeuristicPolicy):
    """Standard normal actions clipped to ``u_range``, drawn from a
    generator seeded ``seed`` on the observations' device."""

    def __init__(self, continuous_action: bool = True, seed: int = 0):
        super().__init__(continuous_action)
        self._seed = seed
        self._generator: Optional[torch.Generator] = None

    def compute_action(self, observation: torch.Tensor, u_range: float) -> torch.Tensor:
        if self._generator is None:
            self._generator = torch.Generator(
                device=observation.device).manual_seed(self._seed)
        n_envs = observation.shape[0]
        return torch.clamp(
            torch.randn((n_envs, 2), generator=self._generator,
                        device=observation.device),
            -u_range, u_range,
        )
