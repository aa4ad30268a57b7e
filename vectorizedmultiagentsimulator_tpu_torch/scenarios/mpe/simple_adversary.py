"""MPE simple_adversary (reference
``vmas/scenarios/mpe/simple_adversary.py``).

n_agents in all, the first n_adversaries adversarial; n_agents - 1
landmarks, one of them the secret goal.  Good agents are rewarded for the
closest good agent's proximity to the goal and the adversaries' distance
from it; adversaries for their own proximity.

As in the JAX package, the goal is a per-env ``goal_index`` drawn at a
full reset and kept across partial resets, where the reference draws one
goal for the whole batch.
"""
import torch

from vectorizedmultiagentsimulator_tpu_torch.core import (
    Agent,
    Landmark,
    Sphere,
    World,
)
from vectorizedmultiagentsimulator_tpu_torch.scenario import BaseScenario
from vectorizedmultiagentsimulator_tpu_torch.scenarios.mpe import (
    select_landmark,
)
from vectorizedmultiagentsimulator_tpu_torch.utils import Color, ScenarioUtils


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        n_agents = kwargs.pop("n_agents", 3)
        n_adversaries = kwargs.pop("n_adversaries", 1)
        ScenarioUtils.check_kwargs_consumed(kwargs)
        assert n_agents > n_adversaries

        world = World(batch_dim, device)
        num_landmarks = n_agents - 1
        for i in range(n_agents):
            adversary = i < n_adversaries
            name = (
                f"adversary_{i}" if adversary else f"agent_{i - n_adversaries}"
            )
            world.add_agent(
                Agent(
                    name=name,
                    collide=False,
                    shape=Sphere(radius=0.15),
                    color=Color.RED if adversary else Color.BLUE,
                    adversary=adversary,
                )
            )
        for i in range(num_landmarks):
            world.add_landmark(
                Landmark(
                    name=f"landmark {i}",
                    collide=False,
                    shape=Sphere(radius=0.08),
                    color=Color.BLACK,
                )
            )
        return world

    def _goal_pos(self):
        return select_landmark(self.world.landmarks, self.goal_index)

    def reset_world_at(self, env_index=None):
        if env_index is None:
            self.goal_index = torch.randint(
                0, len(self.world.landmarks), (self.world.batch_dim,),
                generator=self.world.generator, device=self.world.device,
            )
        for entity in self.world.agents + self.world.landmarks:
            entity.set_pos(
                ScenarioUtils.uniform_in_bounds(self.world, -1.0, 1.0),
                batch_index=env_index,
            )

    def good_agents(self):
        return [agent for agent in self.world.agents if not agent.adversary]

    def adversaries(self):
        return [agent for agent in self.world.agents if agent.adversary]

    def reward(self, agent):
        return (
            self.adversary_reward(agent)
            if agent.adversary
            else self.agent_reward(agent)
        )

    def agent_reward(self, agent):
        goal_pos = self._goal_pos()
        adv_rew = torch.sum(
            torch.stack(
                [
                    torch.linalg.norm(a.state.pos - goal_pos, dim=-1)
                    for a in self.adversaries()
                ],
                dim=1,
            ),
            dim=-1,
        )
        pos_rew = -torch.min(
            torch.stack(
                [
                    torch.linalg.norm(a.state.pos - goal_pos, dim=-1)
                    for a in self.good_agents()
                ],
                dim=1,
            ),
            dim=-1,
        ).values
        return pos_rew + adv_rew

    def adversary_reward(self, agent):
        return -torch.linalg.norm(agent.state.pos - self._goal_pos(), dim=-1)

    def observation(self, agent):
        entity_pos = [
            entity.state.pos - agent.state.pos
            for entity in self.world.landmarks
        ]
        other_pos = [
            other.state.pos - agent.state.pos
            for other in self.world.agents
            if other is not agent
        ]
        if not agent.adversary:
            return torch.cat(
                [self._goal_pos() - agent.state.pos, *entity_pos, *other_pos],
                dim=-1,
            )
        return torch.cat([*entity_pos, *other_pos], dim=-1)
