"""Dropout scenario (reference ``vmas/scenarios/dropout.py``).

n agents share a +1 reward when any of them reaches the goal, minus a team
energy penalty: the best policy "drops out" all but the closest agent.
The goal stops being drawn once eaten (``is_rendering``).
"""
import math

import torch

from vectorizedmultiagentsimulator_tpu_torch.core import (
    Agent,
    Landmark,
    Sphere,
    World,
)
from vectorizedmultiagentsimulator_tpu_torch.scenario import BaseScenario
from vectorizedmultiagentsimulator_tpu_torch.utils import (
    Color,
    ScenarioUtils,
    TorchUtils,
)

DEFAULT_ENERGY_COEFF = 0.02


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        n_agents = kwargs.pop("n_agents", 4)
        self.energy_coeff = kwargs.pop("energy_coeff", DEFAULT_ENERGY_COEFF)
        self.start_same_point = kwargs.pop("start_same_point", False)
        ScenarioUtils.check_kwargs_consumed(kwargs)
        self.agent_radius = 0.05
        self.goal_radius = 0.03

        world = World(batch_dim, device)
        for i in range(n_agents):
            world.add_agent(
                Agent(
                    name=f"agent_{i}",
                    collide=False,
                    shape=Sphere(radius=self.agent_radius),
                )
            )
        world.add_landmark(
            Landmark(
                name="goal",
                collide=False,
                shape=Sphere(radius=self.goal_radius),
                color=Color.GREEN,
            )
        )
        return world

    def reset_world_at(self, env_index=None):
        B = self.world.batch_dim
        dev = self.world.device
        if self.start_same_point:
            for agent in self.world.agents:
                agent.set_pos(
                    torch.zeros((B, 2), device=dev), batch_index=env_index
                )
            ScenarioUtils.spawn_entities_randomly(
                self.world.landmarks,
                self.world,
                env_index,
                self.goal_radius + self.agent_radius + 0.01,
                x_bounds=(-1, 1),
                y_bounds=(-1, 1),
                occupied_positions=torch.zeros((B, 1, 2), device=dev),
            )
        else:
            ScenarioUtils.spawn_entities_randomly(
                self.world.policy_agents + self.world.landmarks,
                self.world,
                env_index,
                self.goal_radius + self.agent_radius + 0.01,
                x_bounds=(-1, 1),
                y_bounds=(-1, 1),
            )

        for landmark in self.world.landmarks:
            if env_index is None:
                landmark.eaten = torch.zeros((B,), dtype=torch.bool,
                                             device=dev)
                landmark.reset_render()
                self.terminated = torch.zeros((B,), dtype=torch.bool,
                                              device=dev)
                self.any_eaten = torch.zeros((B,), dtype=torch.bool,
                                             device=dev)
                self.pos_rew = torch.zeros((B,), device=dev)
                self.energy_rew = torch.zeros((B,), device=dev)
            else:
                landmark.eaten = TorchUtils.where_from_index(
                    env_index, torch.zeros_like(landmark.eaten),
                    landmark.eaten
                )
                landmark.is_rendering = TorchUtils.where_from_index(
                    env_index, torch.ones_like(landmark.is_rendering),
                    landmark.is_rendering
                )
                self.terminated = TorchUtils.where_from_index(
                    env_index, torch.zeros_like(self.terminated),
                    self.terminated
                )

    def reward(self, agent):
        is_first = agent is self.world.agents[0]
        is_last = agent is self.world.agents[-1]
        goal = self.world.landmarks[0]

        if is_first:
            any_eaten = torch.any(
                torch.stack(
                    [
                        torch.linalg.norm(
                            a.state.pos - goal.state.pos, dim=1
                        )
                        < a.shape.radius + goal.shape.radius
                        for a in self.world.agents
                    ],
                    dim=1,
                ),
                dim=-1,
            )
            self.any_eaten = any_eaten
            self.terminated = any_eaten

        self.pos_rew = torch.where(self.any_eaten & ~goal.eaten, 1.0, 0.0)

        if is_last:
            goal.eaten = goal.eaten | self.any_eaten
            goal.is_rendering = goal.is_rendering & ~self.any_eaten

        if is_first:
            self.energy_rew = self.energy_coeff * -torch.sum(
                torch.stack(
                    [
                        torch.linalg.norm(a.action.u, dim=-1)
                        / math.sqrt(
                            self.world.dim_p
                            * ((a.u_range * a.u_multiplier) ** 2)
                        )
                        for a in self.world.agents
                    ],
                    dim=1,
                ),
                dim=-1,
            )
        return self.pos_rew + self.energy_rew

    def observation(self, agent):
        goal = self.world.landmarks[0]
        return torch.cat(
            [
                agent.state.pos,
                agent.state.vel,
                goal.state.pos - agent.state.pos,
                goal.eaten.to(torch.float32)[:, None],
            ],
            dim=-1,
        )

    def info(self, agent):
        return {"pos_rew": self.pos_rew, "energy_rew": self.energy_rew}

    def done(self):
        return self.terminated
