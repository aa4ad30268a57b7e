"""Wind_flocking scenario (reference ``vmas/scenarios/wind_flocking.py``).

Two velocity-controlled agents fly upward through wind, modelled as
per-env gravity (``state.extras["<agent>.dyn_gravity"]``); the big agent's
wind is attenuated when the pair's orientation covers it, which rewards
drafting formations.  The PyTorch counterpart of the JAX package's
``scenarios/wind_flocking.py``: the reference's per-reset ``randperm``
swap of the two ends (wind_flocking.py:160-163) is a per-env random sign,
and the agents' PID state lives in extras
(``controllers/velocity_controller.py``), zeroed per env by a masked
reset.
"""
import math

import numpy as np
import torch

from vectorizedmultiagentsimulator_tpu_torch.controllers import VelocityController
from vectorizedmultiagentsimulator_tpu_torch.core import Agent, Sphere, World
from vectorizedmultiagentsimulator_tpu_torch.scenario import BaseScenario
from vectorizedmultiagentsimulator_tpu_torch.utils import (
    Color,
    ScenarioUtils,
    TorchUtils,
    X,
    Y,
)


def angle_to_vector(angle):
    return torch.cat([torch.cos(angle), torch.sin(angle)], dim=1)


def get_line_angle_0_180(rot):
    return rot % math.pi


def get_line_angle_dist_0_360(angle, goal):
    angle = angle_to_vector(angle)
    goal = angle_to_vector(goal)
    return -torch.sum(angle * goal, dim=-1)


def get_line_angle_dist_0_180(angle, goal: float):
    angle = get_line_angle_0_180(angle)
    goal = float(np.float32(goal) % np.float32(math.pi))
    return torch.minimum(
        torch.abs(angle - goal),
        torch.minimum(
            torch.abs(angle - (goal - math.pi)),
            torch.abs((angle - math.pi) - goal),
        ),
    ).squeeze(-1)


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        self.plot_grid = True
        self.viewer_zoom = 2

        self.vel_shaping_factor = kwargs.pop("vel_shaping_factor", 1)
        self.dist_shaping_factor = kwargs.pop("dist_shaping_factor", 1)
        self.wind_shaping_factor = kwargs.pop("wind_shaping_factor", 1)
        self.pos_shaping_factor = kwargs.pop("pos_shaping_factor", 0)
        self.rot_shaping_factor = kwargs.pop("rot_shaping_factor", 0)
        self.energy_shaping_factor = kwargs.pop("energy_shaping_factor", 0)
        self.observe_rel_pos = kwargs.pop("observe_rel_pos", False)
        self.observe_rel_vel = kwargs.pop("observe_rel_vel", False)
        self.observe_pos = kwargs.pop("observe_pos", True)
        self.use_controller = kwargs.pop("use_controller", True)
        wind = kwargs.pop("wind", 2)
        self.v_range = kwargs.pop("v_range", 0.5)
        desired_vel = kwargs.pop("desired_vel", self.v_range)
        self.f_range = kwargs.pop("f_range", 100)
        controller_params = [1.5, 0.6, 0.002]
        self.u_range = self.v_range if self.use_controller else self.f_range
        self.cover_angle_tolerance = kwargs.pop("cover_angle_tolerance", 1)
        self.horizon = kwargs.pop("horizon", 200)
        ScenarioUtils.check_kwargs_consumed(kwargs)

        self.desired_distance = 1
        self.grid_spacing = self.desired_distance

        world = World(batch_dim, device, drag=0, linear_friction=0.1)
        dev = world.device

        # The wind as each agent's [B, 2] gravity: numpy at construction
        # (the world makes the "<agent>.dyn_gravity" extras from it at
        # finalize), a device tensor for the big agent's attenuated wind.
        wind_np = np.tile(np.asarray([0.0, -wind], np.float32),
                          (batch_dim, 1))
        self.wind = torch.as_tensor(wind_np, device=dev)
        self.desired_vel = torch.tensor([0.0, desired_vel],
                                        dtype=torch.float32, device=dev)
        self.max_pos = (self.horizon * world.dt) * desired_vel
        self.desired_pos = 10.0
        self.n_agents = 2

        self._big_agent = Agent(
            name="agent_0",
            render_action=True,
            shape=Sphere(radius=0.05),
            u_range=self.u_range,
            v_range=self.v_range,
            f_range=self.f_range,
            gravity=wind_np,
        )
        self._big_agent.controller = VelocityController(
            self._big_agent, world, controller_params, "standard"
        )
        world.add_agent(self._big_agent)

        self._small_agent = Agent(
            name="agent_1",
            render_action=True,
            shape=Sphere(radius=0.03),
            u_range=self.u_range,
            v_range=self.v_range,
            f_range=self.f_range,
            gravity=wind_np,
        )
        self._small_agent.controller = VelocityController(
            self._small_agent, world, controller_params, "standard"
        )
        world.add_agent(self._small_agent)
        return world

    def set_wind(self, wind):
        self.wind = torch.tensor(
            [0.0, -wind], dtype=torch.float32, device=self.world.device
        ).expand(self.world.batch_dim, self.world.dim_p)
        self._big_agent.gravity = self.wind
        self._small_agent.gravity = self.wind

    def reset_world_at(self, env_index=None):
        B = self.world.batch_dim
        g, dev = self.world.generator, self.world.device
        u = torch.rand((B, 1), generator=g, device=dev)
        start_angle = -math.pi / 8 + u * (math.pi / 4)
        delta = (self.desired_distance / 2) * torch.cat(
            [torch.cos(start_angle), torch.sin(start_angle)], dim=1
        )
        sign = torch.where(torch.rand((B, 1), generator=g, device=dev) < 0.5,
                           1.0, -1.0)

        for i, agent in enumerate(self.world.agents):
            agent.controller.reset(env_index)
            agent.set_pos(
                -sign * delta if i == 0 else sign * delta,
                batch_index=env_index,
            )
            vel_shaping = (
                torch.linalg.norm(
                    agent.state.vel - self.desired_vel[None], dim=-1
                )
                * self.vel_shaping_factor
            )
            wind_shaping = (
                torch.linalg.norm(agent.gravity, dim=-1)
                * self.wind_shaping_factor
            )
            if env_index is None:
                agent.vel_shaping = vel_shaping
                agent.wind_shaping = wind_shaping
                for name in ("energy_shaping", "wind_rew", "vel_rew",
                             "energy_rew"):
                    setattr(agent, name, torch.zeros(
                        (B,), dtype=torch.float32, device=dev))
            else:
                agent.vel_shaping = TorchUtils.where_from_index(
                    env_index, vel_shaping, agent.vel_shaping
                )
                agent.energy_shaping = TorchUtils.where_from_index(
                    env_index, 0.0, agent.energy_shaping
                )
                agent.wind_shaping = TorchUtils.where_from_index(
                    env_index, wind_shaping, agent.wind_shaping
                )

        distance_shaping = (
            torch.abs(
                torch.linalg.norm(
                    self._small_agent.state.pos - self._big_agent.state.pos,
                    dim=-1,
                )
                - self.desired_distance
            )
            * self.dist_shaping_factor
        )
        pos_shaping = (
            torch.abs(
                torch.maximum(
                    self._big_agent.state.pos[:, Y],
                    self._small_agent.state.pos[:, Y],
                )
                - self.desired_pos
            )
            * self.pos_shaping_factor
        )
        rot_shaping = (
            get_line_angle_dist_0_180(self.get_agents_angle(), 0.0)
            * self.rot_shaping_factor
        )
        if env_index is None:
            self.t = torch.zeros((B,), dtype=torch.int32, device=dev)
            self.distance_shaping = distance_shaping
            self.pos_shaping = pos_shaping
            self.rot_shaping = rot_shaping
            for name in ("dist_rew", "rot_rew", "vel_reward", "pos_rew",
                         "energy_rew", "wind_rew"):
                setattr(self, name, torch.zeros((B,), dtype=torch.float32,
                                                device=dev))
        else:
            self.t = TorchUtils.where_from_index(env_index, 0, self.t)
            self.distance_shaping = TorchUtils.where_from_index(
                env_index, distance_shaping, self.distance_shaping
            )
            self.pos_shaping = TorchUtils.where_from_index(
                env_index, pos_shaping, self.pos_shaping
            )
            self.rot_shaping = TorchUtils.where_from_index(
                env_index, rot_shaping, self.rot_shaping
            )

    def process_action(self, agent):
        if self.use_controller:
            agent.controller.process_force()

    def reward(self, agent):
        is_first = agent is self.world.agents[0]
        if is_first:
            self.t = self.t + 1
            self.set_friction()

            distance_shaping = (
                torch.abs(
                    torch.linalg.norm(
                        self._small_agent.state.pos
                        - self._big_agent.state.pos,
                        dim=-1,
                    )
                    - self.desired_distance
                )
                * self.dist_shaping_factor
            )
            self.dist_rew = self.distance_shaping - distance_shaping
            self.distance_shaping = distance_shaping

            rot_shaping = (
                get_line_angle_dist_0_180(self.get_agents_angle(), 0.0)
                * self.rot_shaping_factor
            )
            self.rot_rew = self.rot_shaping - rot_shaping
            self.rot_shaping = rot_shaping

            pos_shaping = (
                torch.abs(
                    torch.maximum(
                        self._big_agent.state.pos[:, Y],
                        self._small_agent.state.pos[:, Y],
                    )
                    - self.desired_pos
                )
                * self.pos_shaping_factor
            )
            self.pos_rew = self.pos_shaping - pos_shaping
            self.pos_shaping = pos_shaping

            for a in self.world.agents:
                vel_shaping = (
                    torch.linalg.norm(
                        a.state.vel - self.desired_vel[None], dim=-1
                    )
                    * self.vel_shaping_factor
                )
                a.vel_rew = a.vel_shaping - vel_shaping
                a.vel_shaping = vel_shaping
            self.vel_reward = torch.mean(
                torch.stack([a.vel_rew for a in self.world.agents], dim=1),
                dim=-1,
            )

            for a in self.world.agents:
                energy_shaping = (
                    torch.linalg.norm(a.action.u, dim=-1)
                    * self.energy_shaping_factor
                )
                a.energy_rew = torch.where(
                    self.t < 10, 0.0, a.energy_shaping - energy_shaping
                )
                a.energy_shaping = energy_shaping
            self.energy_rew = torch.mean(
                torch.stack([a.energy_rew for a in self.world.agents], dim=1),
                dim=-1,
            )

            for a in self.world.agents:
                wind_shaping = (
                    torch.linalg.norm(a.gravity, dim=-1)
                    * self.wind_shaping_factor
                )
                a.wind_rew = torch.where(
                    self.t < 5, 0.0, a.wind_shaping - wind_shaping
                )
                a.wind_shaping = wind_shaping
            self.wind_rew = torch.mean(
                torch.stack([a.wind_rew for a in self.world.agents], dim=1),
                dim=-1,
            )

        return (
            self.dist_rew
            + self.vel_reward
            + self.rot_rew
            + self.energy_rew
            + self.wind_rew
            + self.pos_rew
        )

    def set_friction(self):
        """Attenuate the big agent's wind when the pair covers it
        (wind_flocking.py:318-335)."""
        goal = torch.full((self.world.batch_dim, 1), -math.pi / 2,
                          device=self.world.device)
        dist_to_goal_angle = (
            torch.clamp_max(
                get_line_angle_dist_0_360(self.get_agents_angle(), goal) + 1,
                self.cover_angle_tolerance,
            )[:, None]
            + (1 - self.cover_angle_tolerance)
        )
        dist_to_goal_angle = (
            dist_to_goal_angle - 1 + self.cover_angle_tolerance
        ) / self.cover_angle_tolerance
        self._big_agent.gravity = self.wind * dist_to_goal_angle

    def observation(self, agent):
        observations = []
        if self.observe_pos:
            observations.append(agent.state.pos)
        observations.append(agent.state.vel)
        if self.observe_rel_pos:
            for a in self.world.agents:
                if a is not agent:
                    observations.append(a.state.pos - agent.state.pos)
        if self.observe_rel_vel:
            for a in self.world.agents:
                if a is not agent:
                    observations.append(a.state.vel - agent.state.vel)
        return torch.cat(observations, dim=-1)

    def get_agents_angle(self):
        return torch.atan2(
            self._big_agent.state.pos[:, Y]
            - self._small_agent.state.pos[:, Y],
            self._big_agent.state.pos[:, X]
            - self._small_agent.state.pos[:, X],
        )[:, None]

    def info(self, agent):
        return {
            "dist_rew": self.dist_rew,
            "rot_rew": self.rot_rew,
            "pos_rew": self.pos_rew,
            "agent_wind_rew": agent.wind_rew,
            "agent_vel_rew": agent.vel_rew,
            "agent_energy_rew": agent.energy_rew,
            "delta_vel_to_goal": torch.linalg.norm(
                agent.state.vel - self.desired_vel[None], dim=-1
            ),
        }

    def extra_render(self, env_index: int = 0):
        from vectorizedmultiagentsimulator_tpu_torch import render as rendering

        geoms = []
        line = rendering.Line(
            (-self.desired_distance / 2, 0),
            (self.desired_distance / 2, 0),
            width=0.005,
        )
        xform = rendering.Transform()
        mid = (
            np.asarray(self._big_agent.state.pos)[env_index]
            + np.asarray(self._small_agent.state.pos)[env_index]
        ) / 2
        xform.set_translation(*mid)
        xform.set_rotation(
            float(np.asarray(self.get_agents_angle())[env_index, 0])
        )
        line.add_attr(xform)
        line.set_color(*Color.BLACK.value)
        geoms.append(line)

        line2 = rendering.Line(
            (-self.desired_distance / 2, 0),
            (self.desired_distance / 2, 0),
            width=0.005,
        )
        xform2 = rendering.Transform()
        xform2.set_translation(0.0, self.max_pos)
        line2.add_attr(xform2)
        line2.set_color(*Color.RED.value)
        geoms.append(line2)
        return geoms
