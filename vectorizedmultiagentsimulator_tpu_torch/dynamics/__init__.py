"""Action-to-force dynamics models.

PyTorch counterpart of ``vectorizedmultiagentsimulator_tpu/dynamics``
(reference ``vmas/simulator/dynamics/``).  Ported so far: the abstract
base, ``Holonomic`` and ``HolonomicWithRotation``; the other models are
ROADMAP Queue 1 item 6.
"""
from __future__ import annotations

import abc
from abc import ABC


class Dynamics(ABC):
    def __init__(self):
        self._agent = None

    def reset(self, index=None):
        return

    @property
    def agent(self):
        if self._agent is None:
            raise ValueError(
                "You need to add the dynamics to an agent during construction"
                " before accessing its properties"
            )
        return self._agent

    @agent.setter
    def agent(self, value):
        if self._agent is not None:
            raise ValueError("Agent in dynamics has already been set")
        self._agent = value

    def check_and_process_action(self):
        action = self.agent.action.u
        if action.shape[1] < self.needed_action_size:
            raise ValueError(
                f"Agent action size {action.shape[1]} is less than the required"
                f" dynamics action size {self.needed_action_size}"
            )
        self.process_action()

    @property
    @abc.abstractmethod
    def needed_action_size(self) -> int:
        raise NotImplementedError

    @abc.abstractmethod
    def process_action(self):
        raise NotImplementedError


class Holonomic(Dynamics):
    """force = u (dynamics/holonomic.py)."""

    @property
    def needed_action_size(self) -> int:
        return 2

    def process_action(self):
        self.agent.state.force = self.agent.action.u[:, :2]


class HolonomicWithRotation(Dynamics):
    """force = u[:2], torque = u[2] (dynamics/holonomic_with_rot.py)."""

    @property
    def needed_action_size(self) -> int:
        return 3

    def process_action(self):
        self.agent.state.force = self.agent.action.u[:, :2]
        self.agent.state.torque = self.agent.action.u[:, 2:3]
