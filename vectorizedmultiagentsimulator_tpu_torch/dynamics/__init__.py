"""Action-to-force dynamics models.

PyTorch counterpart of ``vectorizedmultiagentsimulator_tpu/dynamics``
(reference ``vmas/simulator/dynamics/``): the abstract base and all eight
models, ``Holonomic``, ``HolonomicWithRotation``, ``Forward``,
``Rotation``, ``Static``, ``DiffDrive``, ``KinematicBicycle`` and
``Drone``.  Each maps the agent's action slice to force and torque writes
on the world state.  The one stateful model, :class:`Drone`, keeps its
12-value internal state in ``state.extras["<agent>.drone_state"]``, made
by the first reset, so that it rides through a captured graph as the
other state does.
"""
from __future__ import annotations

import abc
import math
from abc import ABC

import torch

from vectorizedmultiagentsimulator_tpu_torch.utils import TorchUtils


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


class Forward(Dynamics):
    """force = rotate([u, 0], rot) (dynamics/forward.py)."""

    @property
    def needed_action_size(self) -> int:
        return 1

    def process_action(self):
        u = self.agent.action.u[:, 0]
        force = torch.stack([u, torch.zeros_like(u)], dim=-1)
        self.agent.state.force = TorchUtils.rotate_vector(
            force, self.agent.state.rot)


class Rotation(Dynamics):
    """torque = u (dynamics/roatation.py)."""

    @property
    def needed_action_size(self) -> int:
        return 1

    def process_action(self):
        self.agent.state.torque = self.agent.action.u[:, 0:1]


class Static(Dynamics):
    """No force, no torque (dynamics/static.py)."""

    @property
    def needed_action_size(self) -> int:
        return 0

    def process_action(self):
        pass


class DiffDrive(Dynamics):
    """Unicycle model (dynamics/diff_drive.py:28-84): actions are (forward
    speed, angular speed); the pose change over ``dt`` is integrated with
    Euler or RK4 and turned into the force and torque that make the
    world's integrator reproduce it."""

    def __init__(self, world, integration: str = "rk4"):
        super().__init__()
        assert integration in ("rk4", "euler")
        self.dt = world.dt
        self.integration = integration
        self.world = world

    def f(self, state, u_command, ang_vel_command):
        theta = state[:, 2]
        dx = u_command * torch.cos(theta)
        dy = u_command * torch.sin(theta)
        return torch.stack((dx, dy, ang_vel_command), dim=-1)

    def euler(self, state, u_command, ang_vel_command):
        return self.dt * self.f(state, u_command, ang_vel_command)

    def runge_kutta(self, state, u_command, ang_vel_command):
        """RK4 hoisted as ``KinematicBicycle.runge_kutta``, bit-equal to the
        naive 4-stage form: ``f`` reads the state only through theta, whose
        derivative is the command in every stage, so k3 == k2 and only
        three stages' cos and sin are needed."""
        w = ang_vel_command
        theta = state[:, 2]

        def dxy(th):
            return u_command * torch.cos(th), u_command * torch.sin(th)

        x1, y1 = dxy(theta)
        x2, y2 = dxy(theta + self.dt * w / 2)  # == k3 bitwise
        x4, y4 = dxy(theta + self.dt * w)
        # The left-associated fold of k1 + 2*k2 + 2*k3 + k4.
        dx = x1 + 2 * x2 + 2 * x2 + x4
        dy = y1 + 2 * y2 + 2 * y2 + y4
        dth = w + 2 * w + 2 * w + w
        return (self.dt / 6) * torch.stack((dx, dy, dth), dim=1)

    @property
    def needed_action_size(self) -> int:
        return 2

    def process_action(self):
        agent = self.agent
        u_command = agent.action.u[:, 0]
        ang_vel_command = agent.action.u[:, 1]
        state = torch.cat((agent.state.pos, agent.state.rot), dim=1)
        v_cur = agent.state.vel
        w_cur = agent.state.ang_vel[:, 0]
        if self.integration == "euler":
            delta = self.euler(state, u_command, ang_vel_command)
        else:
            delta = self.runge_kutta(state, u_command, ang_vel_command)
        acc_x = (delta[:, 0] - v_cur[:, 0] * self.dt) / self.dt**2
        acc_y = (delta[:, 1] - v_cur[:, 1] * self.dt) / self.dt**2
        acc_w = (delta[:, 2] - w_cur * self.dt) / self.dt**2
        agent.state.force = torch.stack(
            [agent.mass * acc_x, agent.mass * acc_y], dim=-1
        )
        agent.state.torque = (agent.moment_of_inertia * acc_w)[:, None]


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


class Drone(Dynamics):
    """12-state quadrotor projected on the plane (dynamics/drone.py):
    actions are (thrust above hover, torque x, y, z).  The internal state
    (roll, pitch, yaw, body rates, 3-D velocity and position) is carried
    from step to step in ``state.extras["<agent>.drone_state"]``, which the
    first reset makes (``World.reset`` calls ``reset``), never a step."""

    def __init__(
        self,
        world,
        I_xx: float = 8.1e-3,
        I_yy: float = 8.1e-3,
        I_zz: float = 14.2e-3,
        integration: str = "rk4",
    ):
        super().__init__()
        assert integration in ("rk4", "euler")
        self.integration = integration
        self.I_xx = I_xx
        self.I_yy = I_yy
        self.I_zz = I_zz
        self.world = world
        self.g = 9.81
        self.dt = world.dt

    @property
    def _key(self) -> str:
        return f"{self.agent.name}.drone_state"

    @property
    def drone_state(self) -> torch.Tensor:
        world = self.world
        if not world.has_extra(self._key):
            world.set_extra(self._key, torch.zeros(
                (world.batch_dim, 12), dtype=torch.float32,
                device=world.device))
        return world.get_extra(self._key)

    @drone_state.setter
    def drone_state(self, value: torch.Tensor):
        self.world.set_extra(self._key, value)

    def reset(self, index=None):
        if self.world.is_finalized:
            self.drone_state = TorchUtils.where_from_index(
                index, 0.0, self.drone_state)

    def f(self, state, thrust_command, torque_command):
        phi, theta, psi = state[:, 0], state[:, 1], state[:, 2]
        p, q, r = state[:, 3], state[:, 4], state[:, 5]
        x_dot, y_dot, z_dot = state[:, 6], state[:, 7], state[:, 8]
        c_phi, s_phi = torch.cos(phi), torch.sin(phi)
        c_theta, s_theta = torch.cos(theta), torch.sin(theta)
        c_psi, s_psi = torch.cos(psi), torch.sin(psi)
        m = self.agent.mass
        x_ddot = (c_phi * s_theta * c_psi + s_phi * s_psi) * thrust_command / m
        y_ddot = (c_phi * s_theta * s_psi - s_phi * c_psi) * thrust_command / m
        z_ddot = (c_phi * c_theta) * thrust_command / m - self.g
        p_dot = (torque_command[:, 0]
                 - (self.I_yy - self.I_zz) * q * r) / self.I_xx
        q_dot = (torque_command[:, 1]
                 - (self.I_zz - self.I_xx) * p * r) / self.I_yy
        r_dot = (torque_command[:, 2]
                 - (self.I_xx - self.I_yy) * p * q) / self.I_zz
        return torch.stack(
            [p, q, r, p_dot, q_dot, r_dot, x_ddot, y_ddot, z_ddot,
             x_dot, y_dot, z_dot],
            dim=-1,
        )

    def needs_reset(self) -> torch.Tensor:
        """|roll| or |pitch| over 30 degrees (drone.py:110-112)."""
        return torch.any(
            torch.abs(self.drone_state[:, :2]) > 30 * (math.pi / 180), dim=-1)

    def euler(self, state, thrust, torque):
        return self.dt * self.f(state, thrust, torque)

    def runge_kutta(self, state, thrust, torque):
        """The naive four stages: ``f`` reads every state component, so
        no stage repeats another."""
        k1 = self.f(state, thrust, torque)
        k2 = self.f(state + self.dt * k1 / 2, thrust, torque)
        k3 = self.f(state + self.dt * k2 / 2, thrust, torque)
        k4 = self.f(state + self.dt * k3, thrust, torque)
        return (self.dt / 6) * (k1 + 2 * k2 + 2 * k3 + k4)

    @property
    def needed_action_size(self) -> int:
        return 4

    def process_action(self):
        agent = self.agent
        u = agent.action.u
        thrust = u[:, 0] + agent.mass * self.g
        torque = u[:, 1:4]

        # The planar pose from the world: x, y into slots 9-10, yaw into 2.
        ds = self.drone_state
        pos, rot = agent.state.pos, agent.state.rot
        ds = torch.cat([ds[:, :2], rot, ds[:, 3:9], pos, ds[:, 11:]], dim=1)

        if self.integration == "euler":
            delta = self.euler(ds, thrust, torque)
        else:
            delta = self.runge_kutta(ds, thrust, torque)
        self.drone_state = ds + delta

        v_cur = agent.state.vel
        w_cur = agent.state.ang_vel[:, 0]
        acc_x = (delta[:, 6] - v_cur[:, 0] * self.dt) / self.dt**2
        acc_y = (delta[:, 7] - v_cur[:, 1] * self.dt) / self.dt**2
        acc_w = (delta[:, 5] - w_cur * self.dt) / self.dt**2
        agent.state.force = torch.stack(
            [agent.mass * acc_x, agent.mass * acc_y], dim=-1
        )
        agent.state.torque = (agent.moment_of_inertia * acc_w)[:, None]
