"""Debug goal (reference ``vmas/scenarios/debug/goal.py``).

One velocity-controlled agent reaching a goal in a lab-sized arena, with
position shaping, time and energy rewards and an optional control delay
(``dt_delay``; its queue batch-leading, ``[B, dt_delay, 2]``).
"""
import math

import torch

from vectorizedmultiagentsimulator_tpu_torch.controllers import VelocityController
from vectorizedmultiagentsimulator_tpu_torch.core import (
    Agent,
    Landmark,
    Sphere,
    World,
)
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
)


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        self.u_range = kwargs.pop("u_range", 1)
        self.a_range = kwargs.pop("a_range", 1)
        self.obs_noise = kwargs.pop("obs_noise", 0.0)
        self.dt_delay = kwargs.pop("dt_delay", 0)
        self.min_input_norm = kwargs.pop("min_input_norm", 0.08)
        self.linear_friction = kwargs.pop("linear_friction", 0.1)
        self.pos_shaping_factor = kwargs.pop("pos_shaping_factor", 1.0)
        self.time_rew_coeff = kwargs.pop("time_rew_coeff", -0.01)
        self.energy_reward_coeff = kwargs.pop("energy_rew_coeff", 0.0)
        ScenarioUtils.check_kwargs_consumed(kwargs)

        self.viewer_size = (1600, 700)
        self.viewer_zoom = 2
        self.plot_grid = True
        self.agent_radius = 0.16
        self.lab_length = 6
        self.lab_width = 3
        controller_params = [2, 6, 0.002]
        self.f_range = self.a_range + self.linear_friction

        world = World(batch_dim, device, drag=0, dt=0.05, substeps=5)

        self._goal = Landmark(
            "goal", collide=False, movable=False, shape=Sphere(radius=0.06)
        )
        world.add_landmark(self._goal)
        agent = Agent(
            name="agent 0",
            collide=True,
            color=Color.GREEN,
            render_action=True,
            linear_friction=self.linear_friction,
            shape=Sphere(radius=self.agent_radius),
            f_range=self.f_range,
            u_range=self.u_range,
        )
        agent.controller = VelocityController(
            agent, world, controller_params, "standard"
        )
        agent.goal = self._goal
        world.add_agent(agent)
        return world

    @property
    def goal(self):
        return self._goal

    def _random_lab_pos(self):
        B, dev = self.world.batch_dim, self.world.device
        g = self.world.generator
        x = (-self.lab_length / 2
             + self.lab_length * torch.rand((B, 1), generator=g, device=dev))
        y = (-self.lab_width / 2
             + self.lab_width * torch.rand((B, 1), generator=g, device=dev))
        return torch.cat([x, y], dim=1)

    def reset_world_at(self, env_index=None):
        B, dev = self.world.batch_dim, self.world.device
        for agent in self.world.agents:
            agent.controller.reset(env_index)
            agent.set_pos(self._random_lab_pos(), batch_index=env_index)
        for landmark in self.world.landmarks:
            landmark.set_pos(self._random_lab_pos(), batch_index=env_index)
            pos_shaping = (
                torch.amin(
                    torch.stack(
                        [
                            torch.linalg.norm(
                                landmark.state.pos - a.state.pos, dim=1
                            )
                            for a in self.world.agents
                        ],
                        dim=1,
                    ),
                    dim=1,
                )
                * self.pos_shaping_factor
            )
            if env_index is None:
                landmark.pos_shaping = pos_shaping
            else:
                landmark.pos_shaping = TorchUtils.where_from_index(
                    env_index, pos_shaping, landmark.pos_shaping
                )
        if env_index is None:
            self.pos_rew = torch.zeros((B,), dtype=torch.float32, device=dev)
            self.time_rew = torch.zeros((B,), dtype=torch.float32, device=dev)
            self.goal_reached = torch.zeros((B,), dtype=torch.bool,
                                            device=dev)
            if self.dt_delay > 0:
                self.input_queue = torch.zeros(
                    (B, self.dt_delay, self.world.dim_p), dtype=torch.float32,
                    device=dev)
            for agent in self.world.agents:
                agent.energy_rew = torch.zeros((B,), dtype=torch.float32,
                                               device=dev)
                agent.energy_expenditure = torch.zeros(
                    (B,), dtype=torch.float32, device=dev)

    def process_action(self, agent):
        if self.dt_delay > 0:
            agent.action.u = delayed_action(self, agent)
        agent.action.u = controlled_action(agent, self.u_range,
                                           self.min_input_norm)
        agent.controller.process_force()

    def reward(self, agent):
        is_first = agent is self.world.agents[0]
        if is_first:
            goal_dist = torch.amin(
                torch.stack(
                    [
                        torch.linalg.norm(
                            self._goal.state.pos - a.state.pos, dim=1
                        )
                        for a in self.world.agents
                    ],
                    dim=1,
                ),
                dim=1,
            )
            self.goal_reached = goal_dist < self._goal.shape.radius
            pos_shaping = goal_dist * self.pos_shaping_factor
            self.pos_rew = torch.where(
                self.goal_reached, 0.0, self._goal.pos_shaping - pos_shaping
            )
            self._goal.pos_shaping = pos_shaping
            self.time_rew = torch.where(
                self.goal_reached, 0.0, self.time_rew_coeff
            )

        agent.energy_expenditure = torch.sum(
            torch.stack(
                [
                    torch.linalg.norm(a.action.u, dim=-1)
                    / math.sqrt(self.world.dim_p * (a.f_range**2))
                    for a in self.world.agents
                ],
                dim=1,
            ),
            dim=-1,
        )
        agent.energy_rew = -agent.energy_expenditure * self.energy_reward_coeff
        return self.pos_rew + agent.energy_rew + self.time_rew

    def observation(self, agent):
        return with_noise(
            self.world,
            [agent.state.pos, agent.state.vel,
             agent.state.pos - self._goal.state.pos],
            self.obs_noise)

    def info(self, agent):
        return {
            "pos_rew": self.pos_rew,
            "energy_rew": agent.energy_rew,
            "time_rew": self.time_rew,
        }
