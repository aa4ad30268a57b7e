"""Discovery scenario (reference ``vmas/scenarios/discovery.py``).

Agents with target-detecting LIDAR must jointly cover targets
(``agents_per_target`` agents at once within ``covering_range``); covered
targets respawn, or with ``targets_respawn=False`` leave the arena for
good.  The five target LIDARs share one filter, base angles and range, so
``World.measure_lidar`` casts them in one launch of the ray-cast kernel
(and the agent LIDARs of ``use_agent_lidar`` in a second).

The respawn in ``reward()`` is one spawner call for every covered target
of every env, as in the JAX package.  It runs a fixed number of rounds
under a mask (``env_index`` all envs), so a step reads nothing from the
device; an unplaced target is counted in ``world.spawn_give_ups``.
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
        self.n_agents = kwargs.pop("n_agents", 5)
        self.n_targets = kwargs.pop("n_targets", 7)
        self.x_semidim = kwargs.pop("x_semidim", 1)
        self.y_semidim = kwargs.pop("y_semidim", 1)
        self._min_dist_between_entities = kwargs.pop(
            "min_dist_between_entities", 0.2
        )
        self._lidar_range = kwargs.pop("lidar_range", 0.35)
        self._covering_range = kwargs.pop("covering_range", 0.25)
        self.use_agent_lidar = kwargs.pop("use_agent_lidar", False)
        self.n_lidar_rays_entities = kwargs.pop("n_lidar_rays_entities", 15)
        self.n_lidar_rays_agents = kwargs.pop("n_lidar_rays_agents", 12)
        self._agents_per_target = kwargs.pop("agents_per_target", 2)
        self.targets_respawn = kwargs.pop("targets_respawn", True)
        self.shared_reward = kwargs.pop("shared_reward", False)
        self.agent_collision_penalty = kwargs.pop(
            "agent_collision_penalty", 0
        )
        self.covering_rew_coeff = kwargs.pop("covering_rew_coeff", 1.0)
        self.time_penalty = kwargs.pop("time_penalty", 0)
        ScenarioUtils.check_kwargs_consumed(kwargs)

        self._comms_range = self._lidar_range
        self.min_collision_distance = 0.005
        self.agent_radius = 0.05
        self.target_radius = self.agent_radius
        self.viewer_zoom = 1
        self.target_color = Color.GREEN

        world = World(
            batch_dim,
            device,
            x_semidim=self.x_semidim,
            y_semidim=self.y_semidim,
            collision_force=500,
            substeps=2,
            drag=0.25,
        )

        # One filter object for all target LIDARs (and one for the agent
        # LIDARs): the world groups LIDARs by it.
        entity_filter_agents: Callable[[Entity], bool] = (
            lambda e: e.name.startswith("agent")
        )
        entity_filter_targets: Callable[[Entity], bool] = (
            lambda e: e.name.startswith("target")
        )
        for i in range(self.n_agents):
            agent = Agent(
                name=f"agent_{i}",
                collide=True,
                shape=Sphere(radius=self.agent_radius),
                sensors=(
                    [
                        Lidar(
                            world,
                            n_rays=self.n_lidar_rays_entities,
                            max_range=self._lidar_range,
                            entity_filter=entity_filter_targets,
                            render_color=Color.GREEN,
                        )
                    ]
                    + (
                        [
                            Lidar(
                                world,
                                angle_start=0.05,
                                angle_end=2 * np.pi + 0.05,
                                n_rays=self.n_lidar_rays_agents,
                                max_range=self._lidar_range,
                                entity_filter=entity_filter_agents,
                                render_color=Color.BLUE,
                            )
                        ]
                        if self.use_agent_lidar
                        else []
                    )
                ),
            )
            world.add_agent(agent)

        self._targets = []
        for i in range(self.n_targets):
            target = Landmark(
                name=f"target_{i}",
                collide=True,
                movable=False,
                shape=Sphere(radius=self.target_radius),
                color=self.target_color,
            )
            world.add_landmark(target)
            self._targets.append(target)
        # The respawn's env_index: every env, so that the spawner runs its
        # fixed rounds and reads nothing from the device.
        self._all_envs = torch.ones(
            (batch_dim,), dtype=torch.bool, device=world.device
        )
        return world

    def reset_world_at(self, env_index=None):
        B = self.world.batch_dim
        dev = self.world.device
        if env_index is None:
            self.all_time_covered_targets = torch.zeros(
                (B, self.n_targets), dtype=torch.bool, device=dev
            )
            self.covered_targets = torch.zeros(
                (B, self.n_targets), dtype=torch.bool, device=dev
            )
            self.shared_covering_rew = torch.zeros((B,), device=dev)
            self.time_rew = torch.zeros((B,), device=dev)
            for a in self.world.agents:
                a.collision_rew = torch.zeros((B,), device=dev)
                a.covering_reward = torch.zeros((B,), device=dev)
        else:
            self.all_time_covered_targets = TorchUtils.where_from_index(
                env_index,
                torch.zeros_like(self.all_time_covered_targets),
                self.all_time_covered_targets,
            )
        placable_entities = self._targets[: self.n_targets] + self.world.agents
        ScenarioUtils.spawn_entities_randomly(
            entities=placable_entities,
            world=self.world,
            env_index=env_index,
            min_dist_between_entities=self._min_dist_between_entities,
            x_bounds=(-self.world.x_semidim, self.world.x_semidim),
            y_bounds=(-self.world.y_semidim, self.world.y_semidim),
        )

    def get_outside_pos(self, env_index):
        return ScenarioUtils.uniform_in_bounds(
            self.world, -1000 * self.world.x_semidim,
            -10 * self.world.x_semidim,
        )

    def reward(self, agent):
        is_first = agent is self.world.agents[0]
        is_last = agent is self.world.agents[-1]
        B = self.world.batch_dim
        dev = self.world.device

        if is_first:
            self.time_rew = torch.full((B,), float(self.time_penalty),
                                       device=dev)
            # Host-side (no extras): remade here, before any read, in
            # every step.
            self._agents_pos = torch.stack(
                [a.state.pos for a in self.world.agents], dim=1
            )
            self._targets_pos = torch.stack(
                [t.state.pos for t in self._targets], dim=1
            )
            self._agents_targets_dists = torch.linalg.norm(
                self._agents_pos[:, :, None] - self._targets_pos[:, None],
                dim=-1,
            )
            agents_per_target = torch.sum(
                (self._agents_targets_dists < self._covering_range).to(
                    torch.int32
                ),
                dim=1,
            )
            self.covered_targets = agents_per_target >= self._agents_per_target

            shared = torch.zeros((B,), device=dev)
            for a in self.world.agents:
                shared = shared + self.agent_reward(a)
            self.shared_covering_rew = torch.where(
                shared != 0, shared / 2, shared
            )

        collision_rew = torch.zeros((B,), device=dev)
        for a in self.world.agents:
            if a is not agent:
                collision_rew = collision_rew + torch.where(
                    self.world.get_distance(a, agent)
                    < self.min_collision_distance,
                    float(self.agent_collision_penalty),
                    0.0,
                )
        agent.collision_rew = collision_rew

        if is_last:
            if self.targets_respawn:
                # Every covered target of every env in one spawner call;
                # the uncovered ones keep their place and still block.
                new_pos = ScenarioUtils.find_random_positions_for_entities(
                    self._agents_pos,
                    len(self._targets),
                    self.world,
                    self._min_dist_between_entities,
                    (-self.world.x_semidim, self.world.x_semidim),
                    (-self.world.y_semidim, self.world.y_semidim),
                    current_positions=self._targets_pos,
                    replace_mask=self.covered_targets,
                    proposals_per_round=4,
                    env_index=self._all_envs,
                )
                for i, target in enumerate(self._targets):
                    target.set_pos(new_pos[:, i])
            else:
                self.all_time_covered_targets = (
                    self.all_time_covered_targets | self.covered_targets
                )
                outside = self.get_outside_pos(None)
                for i, target in enumerate(self._targets):
                    target.set_pos(
                        torch.where(
                            self.covered_targets[:, i][:, None],
                            outside,
                            target.state.pos,
                        )
                    )
        covering_rew = (
            agent.covering_reward
            if not self.shared_reward
            else self.shared_covering_rew
        )
        return agent.collision_rew + covering_rew + self.time_rew

    def agent_reward(self, agent):
        agent_index = self.world.agents.index(agent)
        targets_covered_by_agent = (
            self._agents_targets_dists[:, agent_index] < self._covering_range
        )
        num_covered = torch.sum(
            targets_covered_by_agent & self.covered_targets, dim=-1
        )
        agent.covering_reward = (
            num_covered.to(torch.float32) * self.covering_rew_coeff
        )
        return agent.covering_reward

    def observation(self, agent):
        lidar_1_measures = agent.sensors[0].measure()
        return torch.cat(
            [agent.state.pos, agent.state.vel, lidar_1_measures]
            + ([agent.sensors[1].measure()] if self.use_agent_lidar else []),
            dim=-1,
        )

    def info(self, agent):
        return {
            "covering_reward": (
                agent.covering_reward
                if not self.shared_reward
                else self.shared_covering_rew
            ),
            "collision_rew": agent.collision_rew,
            "targets_covered": torch.sum(self.covered_targets, dim=-1),
        }

    def done(self):
        return torch.all(self.all_time_covered_targets, dim=-1)

    def extra_render(self, env_index: int = 0):
        from vectorizedmultiagentsimulator_tpu_torch import render as rendering

        geoms = []
        for target in self._targets:
            range_circle = rendering.make_circle(
                self._covering_range, filled=False
            )
            xform = rendering.Transform()
            xform.set_translation(*np.asarray(target.state.pos)[env_index])
            range_circle.add_attr(xform)
            range_circle.set_color(*self.target_color.value)
            geoms.append(range_circle)
        for i, agent1 in enumerate(self.world.agents):
            for j, agent2 in enumerate(self.world.agents):
                if j <= i:
                    continue
                agent_dist = torch.linalg.norm(
                    agent1.state.pos - agent2.state.pos, dim=-1
                )
                if float(agent_dist[env_index]) <= self._comms_range:
                    line = rendering.Line(
                        tuple(np.asarray(agent1.state.pos)[env_index]),
                        tuple(np.asarray(agent2.state.pos)[env_index]),
                        width=0.005,
                    )
                    line.set_color(*Color.BLACK.value)
                    geoms.append(line)
        return geoms


class HeuristicPolicy(BaseHeuristicPolicy):
    """Circle sweep with target attraction and agent repulsion
    (discovery.py:303-356)."""

    def compute_action(self, observation, u_range):
        assert self.continuous_actions
        circle_origin = torch.zeros((1, 2), device=observation.device)
        circle_radius = 0.75
        current_pos = observation[:, :2]
        v = current_pos - circle_origin
        closest_point_on_circ = (
            circle_origin
            + v
            / torch.clamp_min(torch.linalg.norm(v, dim=1), 1e-12)[:, None]
            * circle_radius
        )
        normal = torch.stack(
            [closest_point_on_circ[:, Y], -closest_point_on_circ[:, X]],
            dim=1,
        )
        normal = (
            normal
            / torch.clamp_min(torch.linalg.norm(normal, dim=1), 1e-12)[:, None]
            * 0.1
        )
        des_pos = closest_point_on_circ + normal

        lidar_targets = observation[:, 4:19]
        target_visible = torch.any(lidar_targets < 0.3, dim=1)
        target_dir_index = torch.argmin(lidar_targets, dim=1)
        target_dir = target_dir_index / lidar_targets.shape[1] * 2 * np.pi
        target_vec = torch.stack(
            [torch.cos(target_dir), torch.sin(target_dir)], dim=1
        )
        des_pos_target = current_pos + target_vec * 0.1
        des_pos = torch.where(target_visible[:, None], des_pos_target, des_pos)

        if observation.shape[-1] > 19:
            lidar_agents = observation[:, 19:31]
            agent_visible = torch.any(lidar_agents < 0.15, dim=1)
            agent_dir_index = torch.argmin(lidar_agents, dim=1)
            agent_dir = agent_dir_index / lidar_agents.shape[1] * 2 * np.pi
            agent_vec = torch.stack(
                [torch.cos(agent_dir), torch.sin(agent_dir)], dim=1
            )
            des_pos_agent = current_pos - agent_vec * 0.1
            des_pos = torch.where(
                agent_visible[:, None], des_pos_agent, des_pos
            )
        return torch.clamp((des_pos - current_pos) * 10, -u_range, u_range)
