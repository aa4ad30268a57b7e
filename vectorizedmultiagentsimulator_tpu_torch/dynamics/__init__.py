"""Action-to-force dynamics models.

PyTorch counterpart of ``vectorizedmultiagentsimulator_tpu/dynamics``
(reference ``vmas/simulator/dynamics/``).  Ported so far: the abstract
base, ``Holonomic``, ``HolonomicWithRotation`` and ``KinematicBicycle``;
the other models come with the debug scenarios (ROADMAP Queue 1, the
debug scenarios).
"""
from __future__ import annotations

import abc
from abc import ABC

import torch


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


class KinematicBicycle(Dynamics):
    """Polack et al. kinematic bicycle (dynamics/kinematic_bicycle.py):
    actions are (speed, steering angle); the pose change over ``dt`` is
    integrated with Euler or RK4 and turned into the force and torque that
    make the world's integrator reproduce it."""

    def __init__(
        self,
        world,
        width: float,
        l_f: float,
        l_r: float,
        max_steering_angle: float,
        integration: str = "rk4",
    ):
        super().__init__()
        assert integration in ("rk4", "euler")
        self.width = width
        self.l_f = l_f
        self.l_r = l_r
        self.max_steering_angle = max_steering_angle
        self.dt = world.dt
        self.integration = integration
        self.world = world

    def f(self, state, steering_command, v_command):
        theta = state[:, 2]
        tan_s = torch.tan(steering_command)
        beta = torch.atan2(tan_s * self.l_r / (self.l_f + self.l_r),
                           torch.ones_like(tan_s))
        dx = v_command * torch.cos(theta + beta)
        dy = v_command * torch.sin(theta + beta)
        dtheta = (
            v_command
            / (self.l_f + self.l_r)
            * torch.cos(beta)
            * torch.tan(steering_command)
        )
        return torch.stack((dx, dy, dtheta), dim=1)

    def euler(self, state, steering_command, v_command):
        return self.dt * self.f(state, steering_command, v_command)

    def runge_kutta(self, state, steering_command, v_command):
        """RK4 in the JAX package's hoisted form, bit-equal to the naive
        4-stage one: ``f`` reads the state only through theta and every
        stage's theta-derivative is the same, so k3 == k2 and beta,
        tan(steering) and dtheta are computed once."""
        lwb = self.l_f + self.l_r
        tan_s = torch.tan(steering_command)
        beta = torch.atan2(tan_s * self.l_r / lwb, torch.ones_like(tan_s))
        dtheta = v_command / lwb * torch.cos(beta) * tan_s
        theta = state[:, 2]

        def dxy(th):
            a = th + beta
            return v_command * torch.cos(a), v_command * torch.sin(a)

        x1, y1 = dxy(theta)
        x2, y2 = dxy(theta + self.dt * dtheta / 2)  # == k3 bitwise
        x4, y4 = dxy(theta + self.dt * dtheta)
        # The left-associated fold of k1 + 2*k2 + 2*k3 + k4.
        dx = x1 + 2 * x2 + 2 * x2 + x4
        dy = y1 + 2 * y2 + 2 * y2 + y4
        dth = dtheta + 2 * dtheta + 2 * dtheta + dtheta
        return (self.dt / 6) * torch.stack((dx, dy, dth), dim=1)

    @property
    def needed_action_size(self) -> int:
        return 2

    def process_action(self):
        agent = self.agent
        v_command = agent.action.u[:, 0]
        steering_command = torch.clamp(
            agent.action.u[:, 1], -self.max_steering_angle,
            self.max_steering_angle,
        )
        state = torch.cat((agent.state.pos, agent.state.rot), dim=1)
        v_cur = agent.state.vel
        w_cur = agent.state.ang_vel[:, 0]
        if self.integration == "euler":
            delta = self.euler(state, steering_command, v_command)
        else:
            delta = self.runge_kutta(state, steering_command, v_command)
        acc_x = (delta[:, 0] - v_cur[:, 0] * self.dt) / self.dt**2
        acc_y = (delta[:, 1] - v_cur[:, 1] * self.dt) / self.dt**2
        acc_w = (delta[:, 2] - w_cur * self.dt) / self.dt**2
        agent.state.force = torch.stack(
            [agent.mass * acc_x, agent.mass * acc_y], dim=-1
        )
        agent.state.torque = (agent.moment_of_inertia * acc_w)[:, None]
