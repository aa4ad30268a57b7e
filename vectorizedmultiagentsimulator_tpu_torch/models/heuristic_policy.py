"""Heuristic policy interface (reference
``vmas/simulator/heuristic_policy.py``).  Per-scenario policies map
``observation [B, obs] -> action [B, act]`` tensors."""
from __future__ import annotations

from abc import ABC, abstractmethod

import torch


class BaseHeuristicPolicy(ABC):
    def __init__(self, continuous_action: bool = True):
        self.continuous_actions = continuous_action

    @abstractmethod
    def compute_action(self, observation: torch.Tensor, u_range: float) -> torch.Tensor:
        raise NotImplementedError
