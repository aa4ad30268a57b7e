"""Balance scenario (reference ``vmas/scenarios/balance.py``).

Agents under gravity (0, -0.05) balance a spherical package on a movable
line and carry it up to a goal; falling to the floor is penalized.
Exercises the physics kernel's line-sphere, box-sphere and box-line
classes, gravity and the y semidim clamp.
"""
import math

import torch

from vectorizedmultiagentsimulator_tpu_torch.core import (
    Agent,
    Box,
    Landmark,
    Line,
    Sphere,
    World,
)
from vectorizedmultiagentsimulator_tpu_torch.models import BaseHeuristicPolicy
from vectorizedmultiagentsimulator_tpu_torch.scenario import BaseScenario
from vectorizedmultiagentsimulator_tpu_torch.utils import (
    Color,
    ScenarioUtils,
    TorchUtils,
    Y,
)


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        self.n_agents = kwargs.pop("n_agents", 3)
        self.package_mass = kwargs.pop("package_mass", 5)
        self.random_package_pos_on_line = kwargs.pop(
            "random_package_pos_on_line", True
        )
        ScenarioUtils.check_kwargs_consumed(kwargs)
        assert self.n_agents > 1

        self.line_length = 0.8
        self.agent_radius = 0.03
        self.shaping_factor = 100
        self.fall_reward = -10
        self.visualize_semidims = False

        world = World(batch_dim, device, gravity=(0.0, -0.05), y_semidim=1)
        for i in range(self.n_agents):
            world.add_agent(
                Agent(
                    name=f"agent_{i}",
                    shape=Sphere(self.agent_radius),
                    u_multiplier=0.7,
                )
            )
        goal = Landmark(
            name="goal",
            collide=False,
            shape=Sphere(),
            color=Color.LIGHT_GREEN,
        )
        world.add_landmark(goal)
        self._package = Landmark(
            name="package",
            collide=True,
            movable=True,
            shape=Sphere(),
            mass=self.package_mass,
            color=Color.RED,
        )
        self._package.goal = goal
        world.add_landmark(self._package)
        self._line = Landmark(
            name="line",
            shape=Line(length=self.line_length),
            collide=True,
            movable=True,
            rotatable=True,
            mass=5,
            color=Color.BLACK,
        )
        world.add_landmark(self._line)
        self._floor = Landmark(
            name="floor",
            collide=True,
            shape=Box(length=10, width=1),
            color=Color.WHITE,
        )
        world.add_landmark(self._floor)
        return world

    @property
    def package(self):
        return self._package

    @property
    def line(self):
        return self._line

    def reset_world_at(self, env_index=None):
        B = self.world.batch_dim
        dev = self.world.device
        g = self.world.generator

        def uniform(lo, hi):
            return lo + (hi - lo) * torch.rand((B, 1), generator=g, device=dev)

        def full(value):
            return torch.full((B, 1), value, device=dev)

        goal_pos = torch.cat(
            [uniform(-1.0, 1.0), uniform(0.0, self.world.y_semidim)], dim=1
        )
        line_pos = torch.cat(
            [
                uniform(-1.0 + self.line_length / 2, 1.0 - self.line_length / 2),
                full(-self.world.y_semidim + self.agent_radius * 2),
            ],
            dim=1,
        )
        package_rel_pos = torch.cat(
            [
                (
                    uniform(
                        -self.line_length / 2 + self._package.shape.radius,
                        self.line_length / 2 - self._package.shape.radius,
                    )
                    if self.random_package_pos_on_line
                    else torch.zeros((B, 1), device=dev)
                ),
                full(self._package.shape.radius),
            ],
            dim=1,
        )

        for i, agent in enumerate(self.world.agents):
            # torch.full, not a tensor made from a list: a masked reset
            # copies nothing from the host.
            offset = torch.cat(
                [
                    full(
                        -(self.line_length - agent.shape.radius) / 2
                        + i
                        * (self.line_length - agent.shape.radius)
                        / (self.n_agents - 1)
                    ),
                    full(-self.agent_radius * 2),
                ],
                dim=1,
            )
            agent.set_pos(line_pos + offset, batch_index=env_index)
        self._line.set_pos(line_pos, batch_index=env_index)
        self._package.goal.set_pos(goal_pos, batch_index=env_index)
        self._line.set_rot(
            torch.zeros((1,), device=dev), batch_index=env_index
        )
        self._package.set_pos(
            line_pos + package_rel_pos, batch_index=env_index
        )
        self._floor.set_pos(
            torch.cat(
                [
                    full(0.0),
                    full(
                        -self.world.y_semidim
                        - self._floor.shape.width / 2
                        - self.agent_radius
                    ),
                ],
                dim=1,
            ),
            batch_index=env_index,
        )
        self.compute_on_the_ground()
        global_shaping = (
            torch.linalg.norm(
                self._package.state.pos - self._package.goal.state.pos, dim=1
            )
            * self.shaping_factor
        )
        if env_index is None:
            self.global_shaping = global_shaping
            self.pos_rew = torch.zeros((B,), device=dev)
            self.ground_rew = torch.zeros((B,), device=dev)
            self.package_dist = torch.zeros((B,), device=dev)
        else:
            self.global_shaping = TorchUtils.where_from_index(
                env_index, global_shaping, self.global_shaping
            )

    def compute_on_the_ground(self):
        self.on_the_ground = self.world.is_overlapping(
            self._line, self._floor
        ) | self.world.is_overlapping(self._package, self._floor)

    def reward(self, agent):
        is_first = agent is self.world.agents[0]
        if is_first:
            self.compute_on_the_ground()
            self.package_dist = torch.linalg.norm(
                self._package.state.pos - self._package.goal.state.pos, dim=1
            )
            self.ground_rew = torch.where(
                self.on_the_ground,
                torch.full_like(self.package_dist, self.fall_reward),
                torch.zeros_like(self.package_dist),
            )
            global_shaping = self.package_dist * self.shaping_factor
            self.pos_rew = self.global_shaping - global_shaping
            self.global_shaping = global_shaping
        return self.ground_rew + self.pos_rew

    def observation(self, agent):
        return torch.cat(
            [
                agent.state.pos,
                agent.state.vel,
                agent.state.pos - self._package.state.pos,
                agent.state.pos - self._line.state.pos,
                self._package.state.pos - self._package.goal.state.pos,
                self._package.state.vel,
                self._line.state.vel,
                self._line.state.ang_vel,
                torch.remainder(self._line.state.rot, math.pi),
            ],
            dim=-1,
        )

    def done(self):
        return self.on_the_ground | self.world.is_overlapping(
            self._package, self._package.goal
        )

    def info(self, agent):
        return {"pos_rew": self.pos_rew, "ground_rew": self.ground_rew}


class HeuristicPolicy(BaseHeuristicPolicy):
    """Push the package up while it is below the goal (balance.py:262-289)."""

    def compute_action(self, observation, u_range):
        index_package_goal_pos = 8
        dist_package_goal = observation[
            :, index_package_goal_pos : index_package_goal_pos + 2
        ]
        y_distance_ge_0 = dist_package_goal[:, Y] >= 0

        if self.continuous_actions:
            up = torch.clamp(-dist_package_goal[:, Y], -u_range, u_range)
            return torch.stack(
                [
                    torch.zeros_like(up),
                    torch.where(y_distance_ge_0, torch.zeros_like(up), up),
                ],
                dim=1,
            )
        return torch.where(
            y_distance_ge_0,
            torch.zeros_like(y_distance_ge_0, dtype=torch.long),
            torch.full_like(y_distance_ge_0, 4, dtype=torch.long),
        )
