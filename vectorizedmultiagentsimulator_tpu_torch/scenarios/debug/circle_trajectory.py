"""Debug circle_trajectory (reference
``vmas/scenarios/debug/circle_trajectory.py``).

One velocity-controlled agent rewarded for tracking a circle of radius 1.5:
the negative square root of its distance to the circle plus its velocity
along the circle's tangent.  The control-delay queue (``dt_delay``) is
batch-leading, ``[B, dt_delay, 2]``.
"""
import math

import numpy as np
import torch

from vectorizedmultiagentsimulator_tpu_torch.controllers import VelocityController
from vectorizedmultiagentsimulator_tpu_torch.core import Agent, Sphere, World
from vectorizedmultiagentsimulator_tpu_torch.scenario import BaseScenario
from vectorizedmultiagentsimulator_tpu_torch.scenarios.give_way import (
    controlled_action,
    delayed_action,
    with_noise,
)
from vectorizedmultiagentsimulator_tpu_torch.utils import (
    Color,
    ScenarioUtils,
    TorchUtils,
    X,
    Y,
)


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        self.u_range = kwargs.pop("u_range", 1)
        self.a_range = kwargs.pop("a_range", 1)
        self.obs_noise = kwargs.pop("obs_noise", 0.0)
        self.dt_delay = kwargs.pop("dt_delay", 0)
        self.min_input_norm = kwargs.pop("min_input_norm", 0.08)
        self.linear_friction = kwargs.pop("linear_friction", 0.1)
        ScenarioUtils.check_kwargs_consumed(kwargs)

        self.agent_radius = 0.16
        self.desired_radius = 1.5
        self.viewer_zoom = 2

        world = World(batch_dim, device, linear_friction=self.linear_friction,
                      dt=0.05, drag=0)
        controller_params = [2, 6, 0.002]
        self.f_range = self.a_range + self.linear_friction

        self._agent = Agent(
            name="agent_0",
            shape=Sphere(self.agent_radius),
            f_range=self.f_range,
            u_range=self.u_range,
            render_action=True,
        )
        self._agent.controller = VelocityController(
            self._agent, world, controller_params, "standard"
        )
        world.add_agent(self._agent)
        return world

    @property
    def agent(self):
        return self._agent

    def process_action(self, agent):
        if self.dt_delay > 0:
            agent.action.u = delayed_action(self, agent)
        agent.action.u = controlled_action(agent, self.u_range,
                                           self.min_input_norm)
        agent.controller.process_force()

    def reset_world_at(self, env_index=None):
        self._agent.controller.reset(env_index)
        self._agent.set_pos(
            ScenarioUtils.uniform_in_bounds(
                self.world, -self.desired_radius, self.desired_radius
            ),
            batch_index=env_index,
        )
        if env_index is None:
            B, dev = self.world.batch_dim, self.world.device
            self.pos_rew = torch.zeros((B,), dtype=torch.float32, device=dev)
            self.dot_product = torch.zeros((B,), dtype=torch.float32,
                                           device=dev)
            if self.dt_delay > 0:
                self.input_queue = torch.zeros(
                    (B, self.dt_delay, self.world.dim_p), dtype=torch.float32,
                    device=dev)

    def get_closest_point_circle(self, agent):
        pos_norm = torch.linalg.norm(agent.state.pos, dim=1)
        normalized = (
            agent.state.pos
            / torch.clamp_min(pos_norm, 1e-12)[:, None]
            * self.desired_radius
        )
        return torch.where(pos_norm[:, None] > 0, normalized, 0.0)

    def get_next_closest_point_circle(self, agent):
        closest_point = self.get_closest_point_circle(agent)
        angle = (torch.atan2(closest_point[:, Y], closest_point[:, X])
                 + math.pi / 24)
        return (
            torch.stack([torch.cos(angle), torch.sin(angle)], dim=1)
            * self.desired_radius
        )

    def get_tangent_to_circle(self, agent, closest_point=None):
        if closest_point is None:
            closest_point = self.get_closest_point_circle(agent)
        distance_to_circle = agent.state.pos - closest_point
        inside_circle = (
            torch.linalg.norm(agent.state.pos, dim=1) < self.desired_radius
        )
        angle_90 = torch.full_like(agent.state.pos[:, X], math.pi / 2)
        rot_90 = TorchUtils.rotate_vector(distance_to_circle, angle_90)
        rot_neg_90 = TorchUtils.rotate_vector(distance_to_circle, -angle_90)
        rotated = torch.where(inside_circle[:, None], rot_neg_90, rot_90)
        norm = torch.linalg.norm(rotated, dim=1)
        tangent = rotated / torch.clamp_min(norm, 1e-12)[:, None]
        return torch.where(norm[:, None] > 0, tangent, 0.0)

    def reward(self, agent):
        closest_point = self.get_closest_point_circle(agent)
        self.pos_rew = -(
            torch.linalg.norm(agent.state.pos - closest_point, dim=1) ** 0.5)
        tangent = self.get_tangent_to_circle(agent, closest_point)
        self.dot_product = torch.sum(tangent * agent.state.vel, dim=-1) * 0.5
        return self.pos_rew + self.dot_product

    def observation(self, agent):
        return with_noise(
            self.world, [agent.state.pos, agent.state.vel, agent.state.pos],
            self.obs_noise)

    def info(self, agent):
        return {"pos_rew": self.pos_rew, "dot_product": self.dot_product}

    def extra_render(self, env_index: int = 0):
        from vectorizedmultiagentsimulator_tpu_torch import render as rendering

        geoms = []
        color = Color.BLACK.value
        circle = rendering.make_circle(self.desired_radius, filled=False)
        xform = rendering.Transform()
        circle.add_attr(xform)
        xform.set_translation(0, 0)
        circle.set_color(*color)
        geoms.append(circle)

        tangent = np.asarray(self.get_tangent_to_circle(self._agent))
        line = rendering.Line((0, 0), tuple(tangent[env_index]), width=0.01)
        line.set_color(*color)
        geoms.append(line)
        return geoms
