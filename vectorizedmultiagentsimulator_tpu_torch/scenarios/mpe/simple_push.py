"""MPE simple_push (reference ``vmas/scenarios/mpe/simple_push.py``).

One good agent, one adversary, two landmarks.  The good agent seeks its
secret goal landmark; the adversary is rewarded for keeping the good agent
away from it while staying near it.

As in the JAX package, the goal is a per-env ``goal_index`` drawn at a
full reset (the reference draws one for the whole batch); the landmarks'
and the goal's colours enter the observation from a static colour table.
"""
import numpy as np
import torch

from vectorizedmultiagentsimulator_tpu_torch.core import Agent, Landmark, World
from vectorizedmultiagentsimulator_tpu_torch.scenario import BaseScenario
from vectorizedmultiagentsimulator_tpu_torch.scenarios.mpe import (
    select_landmark,
)
from vectorizedmultiagentsimulator_tpu_torch.utils import ScenarioUtils


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        ScenarioUtils.check_kwargs_consumed(kwargs)
        world = World(batch_dim, device)
        num_agents = 2
        num_adversaries = 1
        num_landmarks = 2
        for i in range(num_agents):
            adversary = i < num_adversaries
            name = (
                f"adversary_{i}" if adversary else f"agent_{i - num_adversaries}"
            )
            world.add_agent(
                Agent(name=name, collide=True, adversary=adversary)
            )
        # landmark i: [0.1, 0.1, 0.1] + 0.8 on channel i + 1
        colors = np.full((num_landmarks, 3), 0.1, np.float32)
        for i in range(num_landmarks):
            colors[i, (i + 1) % 3] += 0.8
            world.add_landmark(
                Landmark(
                    name=f"landmark {i}",
                    collide=False,
                    color=tuple(colors[i]),
                )
            )
        self._landmark_colors = torch.as_tensor(colors, device=world.device)
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

    def reward(self, agent):
        return (
            self.adversary_reward(agent)
            if agent.adversary
            else self.agent_reward(agent)
        )

    def agent_reward(self, agent):
        return -torch.linalg.norm(agent.state.pos - self._goal_pos(), dim=-1)

    def adversary_reward(self, agent):
        goal_pos = self._goal_pos()
        pos_rew = torch.min(
            torch.stack(
                [
                    torch.linalg.norm(a.state.pos - goal_pos, dim=-1)
                    for a in self.world.agents
                    if not a.adversary
                ],
                dim=1,
            ),
            dim=-1,
        ).values
        neg_rew = -torch.linalg.norm(goal_pos - agent.state.pos, dim=-1)
        return pos_rew + neg_rew

    def observation(self, agent):
        B = self.world.batch_dim
        entity_pos = [
            entity.state.pos - agent.state.pos
            for entity in self.world.landmarks
        ]
        entity_color = [
            self._landmark_colors[i][None].expand(B, 3)
            for i in range(len(self.world.landmarks))
        ]
        other_pos = [
            other.state.pos - agent.state.pos
            for other in self.world.agents
            if other is not agent
        ]
        if not agent.adversary:
            # The agent's colour tinted toward its goal's (0.25 + 0.5 on
            # the goal's channel).
            agent_color = 0.25 + 0.5 * torch.nn.functional.one_hot(
                (self.goal_index + 1) % 3, 3
            ).to(torch.float32)
            return torch.cat(
                [
                    agent.state.vel,
                    self._goal_pos() - agent.state.pos,
                    agent_color,
                    *entity_pos,
                    *entity_color,
                    *other_pos,
                ],
                dim=-1,
            )
        return torch.cat(
            [agent.state.vel, *entity_pos, *other_pos], dim=-1
        )
