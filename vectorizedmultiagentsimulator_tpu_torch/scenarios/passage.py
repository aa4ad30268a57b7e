"""Passage scenario (reference ``vmas/scenarios/passage.py``).

A five-agent cross formation must traverse a wall of box segments with
``n_passages`` random openings and reform on the other side.

As in the JAX package, the agents' formation slots and the openings'
places are permutations drawn per env (the reference draws one for the
whole batch with python's ``randperm``): here the ranks of uniform draws
from the world's generator, the same distribution.
"""
import math

import torch

from vectorizedmultiagentsimulator_tpu_torch.core import (
    Agent,
    Box,
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


def passage_slots(n_boxes, agent_radius, passage_length, device):
    """``[n_boxes]`` x of each wall segment's slot, left to right."""
    return torch.tensor(
        [
            -1 - agent_radius + passage_length / 2 + passage_length * i
            for i in range(n_boxes)
        ],
        dtype=torch.float32,
        device=device,
    )


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        self.n_passages = kwargs.pop("n_passages", 1)
        self.shared_reward = kwargs.pop("shared_reward", False)
        ScenarioUtils.check_kwargs_consumed(kwargs)
        assert 1 <= self.n_passages <= 20

        self.shaping_factor = 100
        self.n_agents = 5
        self.agent_radius = 0.03333
        self.agent_spacing = 0.1
        self.passage_width = 0.2
        self.passage_length = 0.103
        self.visualize_semidims = False

        world = World(batch_dim, device, x_semidim=1, y_semidim=1)
        for i in range(self.n_agents):
            agent = Agent(
                name=f"agent_{i}",
                shape=Sphere(self.agent_radius),
                u_multiplier=0.7,
            )
            world.add_agent(agent)
            goal = Landmark(
                name=f"goal {i}",
                collide=False,
                shape=Sphere(radius=self.agent_radius),
                color=Color.LIGHT_GREEN,
            )
            agent.goal = goal
            world.add_landmark(goal)
        self.n_boxes = int(
            (2 * world.x_semidim + 2 * self.agent_radius) // self.passage_length
        )
        for i in range(self.n_boxes):
            removed = i < self.n_passages
            world.add_landmark(
                Landmark(
                    name=f"passage {i}",
                    collide=not removed,
                    movable=False,
                    shape=Box(
                        length=self.passage_length, width=self.passage_width
                    ),
                    color=Color.RED,
                    collision_filter=lambda e: not isinstance(e.shape, Box),
                )
            )
        # Formation slot offsets (passage.py:125-175), a cross about the
        # centre, and the wall's slots: made once on the device.
        s = self.agent_spacing
        self._slot_offsets = torch.tensor(
            [[s, 0.0], [0.0, s], [-s, 0.0], [0.0, -s], [0.0, 0.0]],
            dtype=torch.float32, device=world.device,
        )
        self._slot_x = passage_slots(self.n_boxes, self.agent_radius,
                                     self.passage_length, world.device)
        return world

    def _passages(self):
        return self.world.landmarks[self.n_agents :]

    def reset_world_at(self, env_index=None):
        B = self.world.batch_dim
        dev = self.world.device
        world = self.world
        m = 3 * self.agent_radius + self.agent_spacing
        central_agent_pos = torch.cat(
            [
                ScenarioUtils.uniform_in_bounds(world, -1 + m, 1 - m, (1,)),
                ScenarioUtils.uniform_in_bounds(
                    world, -1 + m, -m - self.passage_width / 2, (1,)),
            ],
            dim=1,
        )
        central_goal_pos = torch.cat(
            [
                ScenarioUtils.uniform_in_bounds(world, -1 + m, 1 - m, (1,)),
                ScenarioUtils.uniform_in_bounds(
                    world, m + self.passage_width / 2, 1 - m, (1,)),
            ],
            dim=1,
        )

        # One slot permutation per env for the agents and their goals.
        perm = ScenarioUtils.random_permutations(world, self.n_agents)
        for j, agent in enumerate(world.agents):
            slot = self._slot_offsets[perm[:, j]]  # [B, 2]
            agent.set_pos(central_agent_pos + slot, batch_index=env_index)
            agent.goal.set_pos(central_goal_pos + slot, batch_index=env_index)

        for agent in world.agents:
            global_shaping = (
                torch.linalg.norm(
                    agent.state.pos - agent.goal.state.pos, dim=1
                )
                * self.shaping_factor
            )
            if env_index is None:
                agent.global_shaping = global_shaping
            else:
                agent.global_shaping = TorchUtils.where_from_index(
                    env_index, global_shaping, agent.global_shaping
                )

        # One permutation of the wall's slots per env.
        perm_p = ScenarioUtils.random_permutations(world, self.n_boxes)
        for i, passage in enumerate(self._passages()):
            if not passage.collide:
                passage.is_rendering = torch.zeros((B,), dtype=torch.bool,
                                                   device=dev)
            x = self._slot_x[perm_p[:, i]]
            passage.set_pos(
                torch.stack([x, torch.zeros_like(x)], dim=1),
                batch_index=env_index,
            )
        if env_index is None:
            self.rew = torch.zeros((B,), device=dev)

    def reward(self, agent):
        is_first = agent is self.world.agents[0]
        if self.shared_reward:
            if is_first:
                rew = torch.zeros((self.world.batch_dim,),
                                  device=self.world.device)
                for a in self.world.agents:
                    dist_to_goal = torch.linalg.norm(
                        a.state.pos - a.goal.state.pos, dim=1
                    )
                    agent_shaping = dist_to_goal * self.shaping_factor
                    rew = rew + (a.global_shaping - agent_shaping)
                    a.global_shaping = agent_shaping
                self.rew = rew
            rew = self.rew
        else:
            dist_to_goal = torch.linalg.norm(
                agent.state.pos - agent.goal.state.pos, dim=1
            )
            agent_shaping = dist_to_goal * self.shaping_factor
            rew = agent.global_shaping - agent_shaping
            agent.global_shaping = agent_shaping

        if agent.collide:
            for a in self.world.agents:
                if a is not agent:
                    rew = rew - torch.where(
                        self.world.is_overlapping(a, agent), 10.0, 0.0
                    )
            for landmark in self._passages():
                if landmark.collide:
                    rew = rew - torch.where(
                        self.world.is_overlapping(agent, landmark), 10.0, 0.0
                    )
        if self.shared_reward:
            # The penalties add up in the shared buffer over the agents'
            # calls, as the reference's in-place writes do
            # (passage.py:231-239).
            self.rew = rew
        return rew

    def observation(self, agent):
        passage_obs = [
            passage.state.pos - agent.state.pos
            for passage in self._passages()
            if not passage.collide
        ]
        return torch.cat(
            [
                agent.state.pos,
                agent.state.vel,
                agent.goal.state.pos - agent.state.pos,
                *passage_obs,
            ],
            dim=-1,
        )

    def done(self):
        return torch.all(
            torch.stack(
                [
                    torch.linalg.norm(a.state.pos - a.goal.state.pos, dim=1)
                    <= a.shape.radius / 2
                    for a in self.world.agents
                ],
                dim=1,
            ),
            dim=1,
        )

    def extra_render(self, env_index: int = 0):
        from vectorizedmultiagentsimulator_tpu_torch import render as rendering

        geoms = []
        length = 2 + self.agent_radius * 2
        offset = self.world.x_semidim + self.agent_radius
        for i in range(4):
            geom = rendering.make_line(length)
            xform = rendering.Transform()
            geom.add_attr(xform)
            xform.set_translation(
                0.0 if i % 2 else (offset if i == 0 else -offset),
                0.0 if not i % 2 else (offset if i == 1 else -offset),
            )
            xform.set_rotation(math.pi / 2 if not i % 2 else 0.0)
            geom.set_color(*Color.BLACK.value)
            geoms.append(geom)
        return geoms
