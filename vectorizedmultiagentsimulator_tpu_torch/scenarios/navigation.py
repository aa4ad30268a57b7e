"""Navigation scenario (reference ``vmas/scenarios/navigation.py``).

n agents with agent-detecting LIDAR navigate to per-agent (or shared) goal
landmarks; position-shaping rewards, collision penalties, final bonus.
Exercises the ray-cast kernel (one LIDAR measure per agent per step) and
the physics kernel's sphere-sphere class.
"""
from typing import Callable

import numpy as np
import torch

from vectorizedmultiagentsimulator_tpu_torch.core import (
    Agent,
    Entity,
    Landmark,
    Sphere,
    World,
)
from vectorizedmultiagentsimulator_tpu_torch.models import BaseHeuristicPolicy
from vectorizedmultiagentsimulator_tpu_torch.scenario import BaseScenario
from vectorizedmultiagentsimulator_tpu_torch.sensors import Lidar
from vectorizedmultiagentsimulator_tpu_torch.utils import (
    Color,
    ScenarioUtils,
    TorchUtils,
    X,
    Y,
)


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        self.plot_grid = False
        self.n_agents = kwargs.pop("n_agents", 4)
        self.collisions = kwargs.pop("collisions", True)
        self.world_spawning_x = kwargs.pop("world_spawning_x", 1)
        self.world_spawning_y = kwargs.pop("world_spawning_y", 1)
        self.enforce_bounds = kwargs.pop("enforce_bounds", False)
        self.agents_with_same_goal = kwargs.pop("agents_with_same_goal", 1)
        self.split_goals = kwargs.pop("split_goals", False)
        self.observe_all_goals = kwargs.pop("observe_all_goals", False)
        self.lidar_range = kwargs.pop("lidar_range", 0.35)
        self.agent_radius = kwargs.pop("agent_radius", 0.1)
        self.comms_range = kwargs.pop("comms_range", 0)
        self.n_lidar_rays = kwargs.pop("n_lidar_rays", 12)
        self.shared_rew = kwargs.pop("shared_rew", True)
        self.pos_shaping_factor = kwargs.pop("pos_shaping_factor", 1)
        self.final_reward = kwargs.pop("final_reward", 0.01)
        self.agent_collision_penalty = kwargs.pop(
            "agent_collision_penalty", -1
        )
        ScenarioUtils.check_kwargs_consumed(kwargs)

        self.min_distance_between_entities = self.agent_radius * 2 + 0.05
        self.min_collision_distance = 0.005

        if self.enforce_bounds:
            self.x_semidim = self.world_spawning_x
            self.y_semidim = self.world_spawning_y
        else:
            self.x_semidim = None
            self.y_semidim = None

        assert 1 <= self.agents_with_same_goal <= self.n_agents
        if self.agents_with_same_goal > 1:
            assert (
                not self.collisions
            ), "If agents share goals they cannot be collidables"
        if self.split_goals:
            assert (
                self.n_agents % 2 == 0
                and self.agents_with_same_goal == self.n_agents // 2
            ), (
                "Splitting the goals is allowed when the agents are even and"
                " half the team has the same goal"
            )

        world = World(
            batch_dim,
            device,
            substeps=2,
            x_semidim=self.x_semidim,
            y_semidim=self.y_semidim,
        )

        known_colors = [
            (0.22, 0.49, 0.72),
            (1.00, 0.50, 0),
            (0.30, 0.69, 0.29),
            (0.97, 0.51, 0.75),
            (0.60, 0.31, 0.64),
            (0.89, 0.10, 0.11),
            (0.87, 0.87, 0),
        ]
        entity_filter_agents: Callable[[Entity], bool] = lambda e: isinstance(
            e, Agent
        )
        for i in range(self.n_agents):
            color = (
                known_colors[i]
                if i < len(known_colors)
                else tuple(np.random.randn(3))
            )
            agent = Agent(
                name=f"agent_{i}",
                collide=self.collisions,
                color=color,
                shape=Sphere(radius=self.agent_radius),
                render_action=True,
                sensors=(
                    [
                        Lidar(
                            world,
                            n_rays=self.n_lidar_rays,
                            max_range=self.lidar_range,
                            entity_filter=entity_filter_agents,
                        )
                    ]
                    if self.collisions
                    else None
                ),
            )
            world.add_agent(agent)
            goal = Landmark(name=f"goal {i}", collide=False, color=color)
            world.add_landmark(goal)
            agent.goal = goal
        return world

    def reset_world_at(self, env_index=None):
        B = self.world.batch_dim
        dev = self.world.device
        ScenarioUtils.spawn_entities_randomly(
            self.world.agents,
            self.world,
            env_index,
            self.min_distance_between_entities,
            (-self.world_spawning_x, self.world_spawning_x),
            (-self.world_spawning_y, self.world_spawning_y),
        )
        occupied_positions = torch.stack(
            [agent.state.pos for agent in self.world.agents], dim=1
        )
        goal_positions = ScenarioUtils.find_random_positions_for_entities(
            occupied_positions,
            len(self.world.agents),
            self.world,
            self.min_distance_between_entities,
            (-self.world_spawning_x, self.world_spawning_x),
            (-self.world_spawning_y, self.world_spawning_y),
            env_index=env_index,
        )
        goal_poses = [
            goal_positions[:, i] for i in range(len(self.world.agents))
        ]

        for i, agent in enumerate(self.world.agents):
            if self.split_goals:
                goal_index = int(i // self.agents_with_same_goal)
            else:
                goal_index = 0 if i < self.agents_with_same_goal else i
            agent.goal.set_pos(goal_poses[goal_index], batch_index=env_index)

            pos_shaping = (
                torch.linalg.norm(
                    agent.state.pos - agent.goal.state.pos, dim=1
                )
                * self.pos_shaping_factor
            )
            if env_index is None:
                agent.pos_shaping = pos_shaping
                agent.pos_rew = torch.zeros((B,), device=dev)
                agent.agent_collision_rew = torch.zeros((B,), device=dev)
                agent.distance_to_goal = torch.zeros((B,), device=dev)
                agent.on_goal = torch.zeros((B,), dtype=torch.bool, device=dev)
            else:
                agent.pos_shaping = TorchUtils.where_from_index(
                    env_index, pos_shaping, agent.pos_shaping
                )
        if env_index is None:
            self.pos_rew = torch.zeros((B,), device=dev)
            self.final_rew = torch.zeros((B,), device=dev)
            self.all_goal_reached = torch.zeros(
                (B,), dtype=torch.bool, device=dev
            )

    def reward(self, agent):
        is_first = agent is self.world.agents[0]
        if is_first:
            pos_rew = torch.zeros(
                (self.world.batch_dim,), device=self.world.device
            )
            for a in self.world.agents:
                pos_rew = pos_rew + self.agent_reward(a)
                a.agent_collision_rew = torch.zeros_like(a.agent_collision_rew)
            self.pos_rew = pos_rew

            self.all_goal_reached = torch.all(
                torch.stack([a.on_goal for a in self.world.agents], dim=-1),
                dim=-1,
            )
            self.final_rew = torch.where(
                self.all_goal_reached,
                torch.full_like(pos_rew, self.final_reward),
                torch.zeros_like(pos_rew),
            )

            for i, a in enumerate(self.world.agents):
                for j, b in enumerate(self.world.agents):
                    if i <= j:
                        continue
                    if self.world.collides(a, b):
                        distance = self.world.get_distance(a, b)
                        penalty = torch.where(
                            distance <= self.min_collision_distance,
                            torch.full_like(distance,
                                            self.agent_collision_penalty),
                            torch.zeros_like(distance),
                        )
                        a.agent_collision_rew = a.agent_collision_rew + penalty
                        b.agent_collision_rew = b.agent_collision_rew + penalty

        pos_reward = self.pos_rew if self.shared_rew else agent.pos_rew
        return pos_reward + self.final_rew + agent.agent_collision_rew

    def agent_reward(self, agent):
        agent.distance_to_goal = torch.linalg.norm(
            agent.state.pos - agent.goal.state.pos, dim=-1
        )
        agent.on_goal = agent.distance_to_goal < agent.goal.shape.radius
        pos_shaping = agent.distance_to_goal * self.pos_shaping_factor
        agent.pos_rew = agent.pos_shaping - pos_shaping
        agent.pos_shaping = pos_shaping
        return agent.pos_rew

    def observation(self, agent):
        goal_poses = []
        if self.observe_all_goals:
            for a in self.world.agents:
                goal_poses.append(agent.state.pos - a.goal.state.pos)
        else:
            goal_poses.append(agent.state.pos - agent.goal.state.pos)
        return torch.cat(
            [agent.state.pos, agent.state.vel]
            + goal_poses
            + (
                [agent.sensors[0]._max_range - agent.sensors[0].measure()]
                if self.collisions
                else []
            ),
            dim=-1,
        )

    def done(self):
        return torch.all(
            torch.stack(
                [
                    torch.linalg.norm(
                        agent.state.pos - agent.goal.state.pos, dim=-1
                    )
                    < agent.shape.radius
                    for agent in self.world.agents
                ],
                dim=-1,
            ),
            dim=-1,
        )

    def info(self, agent):
        return {
            "pos_rew": self.pos_rew if self.shared_rew else agent.pos_rew,
            "final_rew": self.final_rew,
            "agent_collisions": agent.agent_collision_rew,
        }

    def extra_render(self, env_index: int = 0):
        from vectorizedmultiagentsimulator_tpu_torch import render as rendering

        geoms = []
        for i, agent1 in enumerate(self.world.agents):
            for j, agent2 in enumerate(self.world.agents):
                if j <= i:
                    continue
                agent_dist = torch.linalg.norm(
                    agent1.state.pos - agent2.state.pos, dim=-1
                )
                if float(agent_dist[env_index]) <= self.comms_range:
                    line = rendering.Line(
                        tuple(np.asarray(agent1.state.pos)[env_index]),
                        tuple(np.asarray(agent2.state.pos)[env_index]),
                        width=0.005,
                    )
                    line.set_color(*Color.BLACK.value)
                    geoms.append(line)
        return geoms


class HeuristicPolicy(BaseHeuristicPolicy):
    """CLF-QP goal-reaching controller (navigation.py:311-394), in the JAX
    package's closed form: the QP ``min ||u||^2 + slack`` with one CLF
    constraint has the solution
    ``u = -max(0, LfV + eps*V) / ||LgV||^2 * LgV``, clipped to the box."""

    def __init__(self, clf_epsilon=0.2, clf_slack=100.0, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.clf_epsilon = clf_epsilon
        self.clf_slack = clf_slack

    def compute_action(self, observation, u_range):
        agent_pos = observation[:, :2]
        agent_vel = observation[:, 2:4]
        goal_pos = (-1.0) * (observation[:, 4:6] - agent_pos)

        err = agent_pos - goal_pos
        V_value = (
            err[:, X] ** 2
            + 0.5 * err[:, X] * agent_vel[:, X]
            + agent_vel[:, X] ** 2
            + err[:, Y] ** 2
            + 0.5 * err[:, Y] * agent_vel[:, Y]
            + agent_vel[:, Y] ** 2
        )
        LfV_val = (2 * err[:, X] + agent_vel[:, X]) * agent_vel[:, X] + (
            2 * err[:, Y] + agent_vel[:, Y]
        ) * agent_vel[:, Y]
        LgV_vals = torch.stack(
            [
                0.5 * err[:, X] + 2 * agent_vel[:, X],
                0.5 * err[:, Y] + 2 * agent_vel[:, Y],
            ],
            dim=1,
        )
        # Closed-form minimum-norm u satisfying LfV + LgV.u + eps V <= 0.
        violation = torch.clamp_min(LfV_val + self.clf_epsilon * V_value, 0.0)
        denom = torch.clamp_min(torch.sum(LgV_vals**2, dim=1), 1e-9)
        u = -(violation / denom)[:, None] * LgV_vals
        return torch.clamp(u, -u_range, u_range)
