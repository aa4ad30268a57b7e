"""Flocking scenario (reference ``vmas/scenarios/flocking.py``).

Agents with obstacle-detecting LIDAR flock around a scripted target agent
that circles; cohesion (desired-distance) shaping + collision penalties.
Exercises the ray-cast kernel (one LIDAR measure per agent per step) and
the physics kernel's sphere-sphere class over 5 substeps.
"""
import math
from typing import Callable

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
        n_agents = kwargs.pop("n_agents", 4)
        n_obstacles = kwargs.pop("n_obstacles", 5)
        self._min_dist_between_entities = kwargs.pop(
            "min_dist_between_entities", 0.15
        )
        self.n_lidar_rays = kwargs.pop("n_lidar_rays", 12)
        self.collision_reward = kwargs.pop("collision_reward", -0.1)
        self.dist_shaping_factor = kwargs.pop("dist_shaping_factor", 1)
        ScenarioUtils.check_kwargs_consumed(kwargs)

        self.plot_grid = True
        self.desired_distance = 0.1
        self.min_collision_distance = 0.005
        self.x_dim = 1
        self.y_dim = 1

        world = World(batch_dim, device, collision_force=400, substeps=5)
        self._target = Agent(
            name="target",
            collide=True,
            color=Color.GREEN,
            render_action=True,
            action_script=self.action_script_creator(),
        )
        world.add_agent(self._target)
        goal_entity_filter: Callable[[Entity], bool] = lambda e: not isinstance(
            e, Agent
        )
        for i in range(n_agents):
            agent = Agent(
                name=f"agent_{i}",
                collide=True,
                sensors=[
                    Lidar(
                        world,
                        n_rays=self.n_lidar_rays,
                        max_range=0.2,
                        entity_filter=goal_entity_filter,
                    )
                ],
                render_action=True,
            )
            world.add_agent(agent)

        self._obstacles = []
        for i in range(n_obstacles):
            obstacle = Landmark(
                name=f"obstacle_{i}",
                collide=True,
                movable=False,
                shape=Sphere(radius=0.1),
                color=Color.RED,
            )
            world.add_landmark(obstacle)
            self._obstacles.append(obstacle)
        return world

    @property
    def obstacles(self):
        return self._obstacles

    def action_script_creator(self):
        def action_script(agent, world):
            t = self.t / 30
            agent.action.u = torch.stack([torch.cos(t), torch.sin(t)], dim=1)

        return action_script

    def _distance_shaping(self, agent):
        """Mean squared deviation from the desired distance to every other
        agent, target included."""
        return (
            torch.mean(
                (
                    torch.stack(
                        [
                            torch.linalg.norm(
                                agent.state.pos - a.state.pos, dim=-1
                            )
                            for a in self.world.agents
                            if a is not agent
                        ],
                        dim=1,
                    )
                    - self.desired_distance
                )
                ** 2,
                dim=-1,
            )
            * self.dist_shaping_factor
        )

    def reset_world_at(self, env_index=None):
        B = self.world.batch_dim
        dev = self.world.device
        target_pos = torch.zeros((B, self.world.dim_p), device=dev)
        target_pos[:, Y] = -self.y_dim
        self._target.set_pos(target_pos, batch_index=env_index)
        ScenarioUtils.spawn_entities_randomly(
            self._obstacles + self.world.policy_agents,
            self.world,
            env_index,
            self._min_dist_between_entities,
            x_bounds=(-self.x_dim, self.x_dim),
            y_bounds=(-self.y_dim, self.y_dim),
            occupied_positions=target_pos[:, None],
        )

        for agent in self.world.policy_agents:
            distance_shaping = self._distance_shaping(agent)
            if env_index is None:
                agent.distance_shaping = distance_shaping
                agent.collision_rew = torch.zeros((B,), device=dev)
                agent.dist_rew = torch.zeros((B,), device=dev)
            else:
                agent.distance_shaping = TorchUtils.where_from_index(
                    env_index, distance_shaping, agent.distance_shaping
                )
        if env_index is None:
            self.t = torch.zeros((B,), device=dev)
        else:
            self.t = TorchUtils.where_from_index(
                env_index, torch.zeros_like(self.t), self.t
            )

    def reward(self, agent):
        is_first = self.world.policy_agents.index(agent) == 0
        if is_first:
            self.t = self.t + 1
            if self.collision_reward != 0:
                for a in self.world.policy_agents:
                    a.collision_rew = torch.zeros_like(a.collision_rew)
                for i, a in enumerate(self.world.agents):
                    for j, b in enumerate(self.world.agents):
                        if j <= i:
                            continue
                        distance = self.world.get_distance(a, b)
                        penalty = torch.where(
                            distance <= self.min_collision_distance,
                            torch.full_like(distance, self.collision_reward),
                            torch.zeros_like(distance),
                        )
                        if a.action_script is None:
                            a.collision_rew = a.collision_rew + penalty
                        if b.action_script is None:
                            b.collision_rew = b.collision_rew + penalty

        agents_dist_shaping = self._distance_shaping(agent)
        agent.dist_rew = agent.distance_shaping - agents_dist_shaping
        agent.distance_shaping = agents_dist_shaping
        return agent.collision_rew + agent.dist_rew

    def observation(self, agent):
        return torch.cat(
            [
                agent.state.pos,
                agent.state.vel,
                agent.state.pos - self._target.state.pos,
                agent.sensors[0].measure(),
            ],
            dim=-1,
        )

    def info(self, agent):
        return {
            "agent_collision_rew": agent.collision_rew,
            "agent_distance_rew": agent.dist_rew,
        }


class HeuristicPolicy(BaseHeuristicPolicy):
    """Circle-following with LIDAR-based avoidance (flocking.py:213-252)."""

    def compute_action(self, observation, u_range):
        assert self.continuous_actions
        circle_origin = torch.zeros((1, 2), device=observation.device)
        circle_radius = 0.3
        current_pos = observation[:, :2]
        v = current_pos - circle_origin
        closest_point_on_circ = (
            circle_origin
            + v
            / torch.clamp_min(torch.linalg.norm(v, dim=1), 1e-12)[:, None]
            * circle_radius
        )
        normal = torch.stack(
            [closest_point_on_circ[:, Y], -closest_point_on_circ[:, X]], dim=1
        )
        normal = (
            normal
            / torch.clamp_min(torch.linalg.norm(normal, dim=1), 1e-12)[:, None]
            * 0.1
        )
        des_pos = closest_point_on_circ + normal

        lidar = observation[:, 6:18]
        object_visible = torch.any(lidar < 0.1, dim=1)
        object_dir_index = torch.argmin(lidar, dim=1)
        object_dir = object_dir_index / lidar.shape[1] * 2 * math.pi
        object_vec = torch.stack(
            [torch.cos(object_dir), torch.sin(object_dir)], dim=1
        )
        des_pos_object = current_pos - object_vec * 0.1
        des_pos = torch.where(object_visible[:, None], des_pos_object, des_pos)
        return torch.clamp((des_pos - current_pos) * 10, -u_range, u_range)
