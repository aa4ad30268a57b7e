"""MPE simple_world_comm (reference
``vmas/scenarios/mpe/simple_world_comm.py``).

Predator-prey with a communicating lead adversary (dim_c 4), food targets
and forests to hide in.

As in the JAX package: the reference computes the forest-occupancy
features by chained advanced indexing (``in_forest[index][:, i] = 1``,
simple_world_comm.py:292-301), which writes into a copy in torch and so
changes nothing; what it observes is ``in_forest`` constantly -1, and
zeros for the other agents' positions and velocities for every agent but
the leader.  That behaviour is kept as it is.
"""
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
        num_good_agents = kwargs.pop("num_good_agents", 2)
        num_adversaries = kwargs.pop("num_adversaries", 4)
        num_landmarks = kwargs.pop("num_landmarks", 1)
        num_food = kwargs.pop("num_food", 2)
        num_forests = kwargs.pop("num_forests", 2)
        ScenarioUtils.check_kwargs_consumed(kwargs)

        world = World(batch_dim, device, x_semidim=1, y_semidim=1, dim_c=4)
        num_agents = num_good_agents + num_adversaries
        for i in range(num_agents):
            adversary = i < num_adversaries
            leader = i == 0
            name = (
                "lead_adversary_0"
                if leader
                else (
                    f"adversary_{i}"
                    if adversary
                    else f"agent_{i - num_adversaries}"
                )
            )
            agent = Agent(
                name=name,
                collide=True,
                shape=Sphere(radius=0.075 if adversary else 0.045),
                u_multiplier=3.0 if adversary else 4.0,
                max_speed=1.0 if adversary else 1.3,
                color=Color.RED if adversary else Color.GREEN,
                adversary=adversary,
                silent=not leader,
            )
            agent.leader = leader
            world.add_agent(agent)
        self._obstacles = []
        self._food = []
        self._forests = []
        for i in range(num_landmarks):
            landmark = Landmark(
                name=f"landmark {i}", collide=True, shape=Sphere(radius=0.2)
            )
            self._obstacles.append(landmark)
            world.add_landmark(landmark)
        for i in range(num_food):
            landmark = Landmark(
                name=f"food {i}",
                collide=False,
                shape=Sphere(radius=0.03),
                color=(0.15, 0.15, 0.65),
            )
            self._food.append(landmark)
            world.add_landmark(landmark)
        for i in range(num_forests):
            landmark = Landmark(
                name=f"forest {i}",
                collide=False,
                shape=Sphere(radius=0.3),
                color=(0.6, 0.9, 0.6),
            )
            self._forests.append(landmark)
            world.add_landmark(landmark)
        return world

    @property
    def food(self):
        return self._food

    @property
    def forests(self):
        return self._forests

    def reset_world_at(self, env_index=None):
        for agent in self.world.agents:
            agent.set_pos(
                ScenarioUtils.uniform_in_bounds(self.world, -1.0, 1.0),
                batch_index=env_index,
            )
        for landmark in self.world.landmarks:
            landmark.set_pos(
                ScenarioUtils.uniform_in_bounds(self.world, -0.9, 0.9),
                batch_index=env_index,
            )

    def is_collision(self, agent1, agent2):
        dist = torch.linalg.norm(agent1.state.pos - agent2.state.pos, dim=-1)
        return dist < agent1.shape.radius + agent2.shape.radius

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
        rew = torch.zeros((self.world.batch_dim,), device=self.world.device)
        if agent.collide:
            for a in self.adversaries():
                rew = rew - torch.where(self.is_collision(a, agent), 5.0, 0.0)
        for food in self._food:
            rew = rew + torch.where(self.is_collision(agent, food), 2.0, 0.0)
        rew = rew - 0.05 * torch.min(
            torch.stack(
                [
                    torch.linalg.norm(food.state.pos - agent.state.pos, dim=-1)
                    for food in self._food
                ],
                dim=1,
            ),
            dim=-1,
        ).values
        return rew

    def adversary_reward(self, agent):
        # The reference's distance shaping computes ||a.pos - a.pos|| == 0
        # (simple_world_comm.py:252-269), so only the collision term is
        # left.
        rew = torch.zeros((self.world.batch_dim,), device=self.world.device)
        if agent.collide:
            for ag in self.good_agents():
                for adv in self.adversaries():
                    rew = rew + torch.where(self.is_collision(ag, adv), 5.0,
                                            0.0)
        return rew

    def observation(self, agent):
        B = self.world.batch_dim
        dev = self.world.device
        entity_pos = [
            entity.state.pos - agent.state.pos
            for entity in self.world.landmarks
        ]
        n_forests = len(self._forests)
        # Constant -1 (see the module docstring).
        in_forest = torch.full((B, n_forests), -1.0, device=dev)

        other_pos = []
        other_vel = []
        for other in self.world.agents:
            if other is agent:
                continue
            for _ in range(n_forests):
                if agent.leader:
                    pos = other.state.pos - agent.state.pos
                    vel = (
                        other.state.vel
                        if not other.adversary
                        else torch.zeros((B, 2), device=dev)
                    )
                else:
                    pos = torch.zeros((B, 2), device=dev)
                    vel = torch.zeros((B, 2), device=dev)
                other_pos.append(pos)
                other_vel.append(vel)

        comm = self.world.agents[0].state.c

        if agent.adversary:
            return torch.cat(
                [
                    agent.state.vel,
                    agent.state.pos,
                    *entity_pos,
                    *other_pos,
                    *other_vel,
                    in_forest,
                    comm,
                ],
                dim=-1,
            )
        return torch.cat(
            [
                agent.state.vel,
                agent.state.pos,
                *entity_pos,
                *other_pos,
                *other_vel,
                in_forest,
            ],
            dim=-1,
        )
