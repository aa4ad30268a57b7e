"""MPE simple_reference (reference
``vmas/scenarios/mpe/simple_reference.py``).

Two communicating agents (dim_c 10) and three landmarks.  Each agent's
target landmark is known only to the other agent, so they must
communicate.  The shared reward is minus the sum of each agent's distance
to its secret goal landmark.

As in the JAX package, the goals are per-env ``goal_index_0`` and
``goal_index_1``, drawn at a full reset (the reference draws one pair for
the whole batch); the goal colour in the observation comes from the
static landmark colour table.
"""
import numpy as np
import torch

from vectorizedmultiagentsimulator_tpu_torch.core import Agent, Landmark, World
from vectorizedmultiagentsimulator_tpu_torch.scenario import BaseScenario
from vectorizedmultiagentsimulator_tpu_torch.scenarios.mpe import (
    select_landmark,
)
from vectorizedmultiagentsimulator_tpu_torch.utils import ScenarioUtils

_LANDMARK_COLORS = np.asarray(
    [[0.75, 0.25, 0.25], [0.25, 0.75, 0.25], [0.25, 0.25, 0.75]], np.float32
)


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        ScenarioUtils.check_kwargs_consumed(kwargs)
        world = World(batch_dim, device, dim_c=10)
        for i in range(2):
            world.add_agent(
                Agent(name=f"agent_{i}", collide=False, silent=False)
            )
        for i in range(3):
            world.add_landmark(
                Landmark(
                    name=f"landmark {i}",
                    collide=False,
                    color=tuple(_LANDMARK_COLORS[i]),
                )
            )
        self._colors = torch.as_tensor(_LANDMARK_COLORS, device=world.device)
        return world

    def _goal_pos(self, agent_idx: int):
        idx = self.goal_index_0 if agent_idx == 0 else self.goal_index_1
        return select_landmark(self.world.landmarks, idx)

    def reset_world_at(self, env_index=None):
        if env_index is None:
            B = self.world.batch_dim
            L = len(self.world.landmarks)
            g, dev = self.world.generator, self.world.device
            # goal_index_i is the landmark agent (1 - i) must reach (agent
            # i observes it and communicates it).
            self.goal_index_0 = torch.randint(0, L, (B,), generator=g,
                                              device=dev)
            self.goal_index_1 = torch.randint(0, L, (B,), generator=g,
                                              device=dev)
            self.rew = torch.zeros((B,), device=dev)
        for entity in self.world.agents + self.world.landmarks:
            entity.set_pos(
                ScenarioUtils.uniform_in_bounds(self.world, -1.0, 1.0),
                batch_index=env_index,
            )

    def reward(self, agent):
        is_first = agent is self.world.agents[0]
        if is_first:
            # agent_0's goal_a is agent_1 (it reaches goal_index_0), and
            # the other way round (simple_reference.py:41-48).
            self.rew = -torch.linalg.norm(
                self.world.agents[1].state.pos - self._goal_pos(0), dim=-1
            ) - torch.linalg.norm(
                self.world.agents[0].state.pos - self._goal_pos(1), dim=-1
            )
        return self.rew

    def observation(self, agent):
        agent_idx = self.world.agents.index(agent)
        idx = self.goal_index_0 if agent_idx == 0 else self.goal_index_1
        goal_color = self._colors[idx]  # [B, 3]
        entity_pos = [
            entity.state.pos - agent.state.pos
            for entity in self.world.landmarks
        ]
        comm = [
            other.state.c
            for other in self.world.agents
            if other is not agent
        ]
        return torch.cat(
            [agent.state.vel, *entity_pos, goal_color, *comm], dim=-1
        )
