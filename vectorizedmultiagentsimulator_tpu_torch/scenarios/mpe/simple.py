"""MPE simple (reference ``vmas/scenarios/mpe/simple.py``).

One agent, one landmark; the reward is the negative squared distance to
the landmark.
"""
import torch

from vectorizedmultiagentsimulator_tpu_torch.core import Agent, Landmark, World
from vectorizedmultiagentsimulator_tpu_torch.scenario import BaseScenario
from vectorizedmultiagentsimulator_tpu_torch.utils import Color, ScenarioUtils


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        ScenarioUtils.check_kwargs_consumed(kwargs)
        world = World(batch_dim, device)
        for i in range(1):
            world.add_agent(
                Agent(name=f"agent_{i}", collide=False, color=Color.GRAY)
            )
        for i in range(1):
            world.add_landmark(
                Landmark(name=f"landmark {i}", collide=False, color=Color.RED)
            )
        return world

    def reset_world_at(self, env_index=None):
        for entity in self.world.agents + self.world.landmarks:
            entity.set_pos(
                ScenarioUtils.uniform_in_bounds(self.world, -1.0, 1.0),
                batch_index=env_index,
            )

    def reward(self, agent):
        dist2 = torch.sum(
            torch.square(agent.state.pos - self.world.landmarks[0].state.pos),
            dim=-1,
        )
        return -dist2

    def observation(self, agent):
        entity_pos = [
            entity.state.pos - agent.state.pos
            for entity in self.world.landmarks
        ]
        return torch.cat([agent.state.vel, *entity_pos], dim=-1)
