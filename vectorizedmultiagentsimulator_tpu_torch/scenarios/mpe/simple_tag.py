"""MPE simple_tag (reference ``vmas/scenarios/mpe/simple_tag.py``).

Predator-prey: slow adversaries chase faster good agents among collidable
landmark obstacles (10 substeps, collision_force 500).  A collision gives
+-10; distance shaping and a respawn at a catch are options.
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
from vectorizedmultiagentsimulator_tpu_torch.utils import Color, ScenarioUtils


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        num_good_agents = kwargs.pop("num_good_agents", 1)
        num_adversaries = kwargs.pop("num_adversaries", 3)
        num_landmarks = kwargs.pop("num_landmarks", 2)
        self.shape_agent_rew = kwargs.pop("shape_agent_rew", False)
        self.shape_adversary_rew = kwargs.pop("shape_adversary_rew", False)
        self.agents_share_rew = kwargs.pop("agents_share_rew", False)
        self.adversaries_share_rew = kwargs.pop("adversaries_share_rew", True)
        self.observe_same_team = kwargs.pop("observe_same_team", True)
        self.observe_pos = kwargs.pop("observe_pos", True)
        self.observe_vel = kwargs.pop("observe_vel", True)
        self.bound = kwargs.pop("bound", 1.0)
        self.respawn_at_catch = kwargs.pop("respawn_at_catch", False)
        ScenarioUtils.check_kwargs_consumed(kwargs)

        self.visualize_semidims = False

        world = World(
            batch_dim,
            device,
            x_semidim=self.bound,
            y_semidim=self.bound,
            substeps=10,
            collision_force=500,
        )
        num_agents = num_adversaries + num_good_agents
        self.adversary_radius = 0.075
        for i in range(num_agents):
            adversary = i < num_adversaries
            name = (
                f"adversary_{i}" if adversary else f"agent_{i - num_adversaries}"
            )
            world.add_agent(
                Agent(
                    name=name,
                    collide=True,
                    shape=Sphere(
                        radius=self.adversary_radius if adversary else 0.05
                    ),
                    u_multiplier=3.0 if adversary else 4.0,
                    max_speed=1.0 if adversary else 1.3,
                    color=Color.RED if adversary else Color.GREEN,
                    adversary=adversary,
                )
            )
        for i in range(num_landmarks):
            world.add_landmark(
                Landmark(
                    name=f"landmark {i}",
                    collide=True,
                    shape=Sphere(radius=0.2),
                    color=Color.BLACK,
                )
            )
        return world

    def reset_world_at(self, env_index=None):
        for agent in self.world.agents:
            agent.set_pos(
                ScenarioUtils.uniform_in_bounds(
                    self.world, -self.bound, self.bound
                ),
                batch_index=env_index,
            )
        for landmark in self.world.landmarks:
            landmark.set_pos(
                ScenarioUtils.uniform_in_bounds(
                    self.world, -(self.bound - 0.1), self.bound - 0.1
                ),
                batch_index=env_index,
            )
        if env_index is None:
            B = self.world.batch_dim
            dev = self.world.device
            self.agents_rew = torch.zeros((B,), device=dev)
            self.adversary_rew = torch.zeros((B,), device=dev)
            for a in self.world.agents:
                a.rew = torch.zeros((B,), device=dev)

    def is_collision(self, agent1, agent2):
        dist = torch.linalg.norm(agent1.state.pos - agent2.state.pos, dim=-1)
        return dist < agent1.shape.radius + agent2.shape.radius

    def good_agents(self):
        return [agent for agent in self.world.agents if not agent.adversary]

    def adversaries(self):
        return [agent for agent in self.world.agents if agent.adversary]

    def reward(self, agent):
        is_first = agent is self.world.agents[0]
        if is_first:
            for a in self.world.agents:
                a.rew = (
                    self.adversary_reward(a)
                    if a.adversary
                    else self.agent_reward(a)
                )
            self.agents_rew = torch.sum(
                torch.stack([a.rew for a in self.good_agents()], dim=-1),
                dim=-1,
            )
            self.adversary_rew = torch.sum(
                torch.stack([a.rew for a in self.adversaries()], dim=-1),
                dim=-1,
            )
            if self.respawn_at_catch:
                for a in self.good_agents():
                    caught = torch.zeros(
                        (self.world.batch_dim,), dtype=torch.bool,
                        device=self.world.device,
                    )
                    for adv in self.adversaries():
                        caught = caught | self.is_collision(a, adv)
                    new_pos = ScenarioUtils.uniform_in_bounds(
                        self.world, -self.bound, self.bound
                    )
                    a.set_pos(
                        torch.where(caught[:, None], new_pos, a.state.pos)
                    )
                    a.set_vel(
                        torch.where(caught[:, None], 0.0, a.state.vel)
                    )

        if agent.adversary:
            return self.adversary_rew if self.adversaries_share_rew else agent.rew
        return self.agents_rew if self.agents_share_rew else agent.rew

    def agent_reward(self, agent):
        rew = torch.zeros((self.world.batch_dim,), device=self.world.device)
        adversaries = self.adversaries()
        if self.shape_agent_rew:
            for adv in adversaries:
                rew = rew + 0.1 * torch.linalg.norm(
                    agent.state.pos - adv.state.pos, dim=-1
                )
        if agent.collide:
            for a in adversaries:
                rew = rew - torch.where(self.is_collision(a, agent), 10.0, 0.0)
        return rew

    def adversary_reward(self, agent):
        rew = torch.zeros((self.world.batch_dim,), device=self.world.device)
        agents = self.good_agents()
        if self.shape_adversary_rew:
            rew = rew - 0.1 * torch.min(
                torch.stack(
                    [
                        torch.linalg.norm(a.state.pos - agent.state.pos,
                                          dim=-1)
                        for a in agents
                    ],
                    dim=-1,
                ),
                dim=-1,
            ).values
        if agent.collide:
            for ag in agents:
                rew = rew + torch.where(self.is_collision(ag, agent), 10.0, 0.0)
        return rew

    def observation(self, agent):
        entity_pos = [
            entity.state.pos - agent.state.pos
            for entity in self.world.landmarks
        ]
        other_pos = []
        other_vel = []
        for other in self.world.agents:
            if other is agent:
                continue
            if agent.adversary and not other.adversary:
                other_pos.append(other.state.pos - agent.state.pos)
                other_vel.append(other.state.vel)
            elif (
                not agent.adversary
                and not other.adversary
                and self.observe_same_team
            ):
                other_pos.append(other.state.pos - agent.state.pos)
                other_vel.append(other.state.vel)
            elif not agent.adversary and other.adversary:
                other_pos.append(other.state.pos - agent.state.pos)
            elif agent.adversary and other.adversary and self.observe_same_team:
                other_pos.append(other.state.pos - agent.state.pos)
        return torch.cat(
            [
                *([agent.state.vel] if self.observe_vel else []),
                *([agent.state.pos] if self.observe_pos else []),
                *entity_pos,
                *other_pos,
                *other_vel,
            ],
            dim=-1,
        )

    def extra_render(self, env_index: int = 0):
        from vectorizedmultiagentsimulator_tpu_torch import render as rendering

        geoms = []
        length = 2 * (self.bound + self.adversary_radius)
        offset = self.bound + self.adversary_radius
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
