"""Buzz_wire scenario (reference ``vmas/scenarios/buzz_wire.py``).

Two agents joint-linked to a ball steer it up a narrow wire corridor; any
touch of the walls ends the episode with a penalty (the "buzz wire" game).
Four joint constraints (two dist-0.25 joints, each with its own line),
15 substeps, joint_force 900, collision_force 1500.
"""
import math

import torch

from vectorizedmultiagentsimulator_tpu_torch.core import (
    Agent,
    Joint,
    Landmark,
    Line,
    Sphere,
    World,
)
from vectorizedmultiagentsimulator_tpu_torch.scenario import BaseScenario
from vectorizedmultiagentsimulator_tpu_torch.utils import (
    Color,
    ScenarioUtils,
    TorchUtils,
)


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        self.random_start_angle = kwargs.pop("random_start_angle", True)
        self.pos_shaping_factor = kwargs.pop("pos_shaping_factor", 1)
        self.collision_reward = kwargs.pop("collision_reward", -10)
        self.max_speed_1 = kwargs.pop("max_speed_1", None)
        ScenarioUtils.check_kwargs_consumed(kwargs)

        self.n_agents = 2
        self.wall_length = 2
        self.agent_spacing = 0.5
        self.agent_radius = 0.03
        self.ball_radius = self.agent_radius

        world = World(
            batch_dim, device, substeps=15, joint_force=900,
            collision_force=1500,
        )
        world.add_agent(
            Agent(
                name="agent_0",
                shape=Sphere(self.agent_radius),
                u_multiplier=1,
                mass=1,
            )
        )
        world.add_agent(
            Agent(
                name="agent_1",
                shape=Sphere(self.agent_radius),
                u_multiplier=1,
                mass=1,
                max_speed=self.max_speed_1,
            )
        )
        self._goal = Landmark(
            name="goal",
            shape=Sphere(radius=self.ball_radius),
            collide=False,
            color=Color.GREEN,
        )
        world.add_landmark(self._goal)
        self._ball = Landmark(
            name="ball",
            shape=Sphere(radius=self.ball_radius),
            collide=True,
            movable=True,
        )
        world.add_landmark(self._ball)

        self._joints = []
        for i in range(2):
            joint = Joint(
                world.agents[i],
                self._ball,
                anchor_a=(0, 0),
                anchor_b=(0, 0),
                dist=self.agent_spacing / 2,
                rotate_a=True,
                rotate_b=True,
                collidable=False,
                width=0,
                mass=1,
            )
            self._joints.append(joint)
            world.add_joint(joint)

        self.build_path_line(world)
        return world

    @property
    def ball(self):
        return self._ball

    @property
    def goal(self):
        return self._goal

    def reset_world_at(self, env_index=None):
        B = self.world.batch_dim
        dev = self.world.device
        g = self.world.generator

        def uniform(lo, hi):
            return lo + (hi - lo) * torch.rand((B, 1), generator=g, device=dev)

        if self.random_start_angle:
            start_angle = uniform(-math.pi / 2 + math.pi / 3,
                                  math.pi / 2 - math.pi / 3)
        else:
            start_angle = torch.zeros((B, 1), device=dev)
        start_delta = (self.agent_spacing / 2) * torch.cat(
            [torch.cos(start_angle), torch.sin(start_angle)], dim=1
        )

        min_x_start, max_x_start = -self.agent_radius, self.agent_radius
        min_y_start = -self.wall_length / 2 + 2 * self.agent_radius
        max_y_start = -self.agent_radius
        ball_position = torch.cat(
            [uniform(min_x_start, max_x_start),
             uniform(min_y_start, max_y_start)], dim=1
        )
        # Goal y bounds mirror the start's (buzz_wire.py:118-121).
        goal_pos = torch.cat(
            [uniform(min_x_start, max_x_start),
             uniform(-max_x_start, -min_y_start)], dim=1
        )

        self._goal.set_pos(goal_pos, batch_index=env_index)
        self._ball.set_pos(ball_position, batch_index=env_index)
        for i, agent in enumerate(self.world.agents):
            agent.set_pos(
                ball_position + start_delta * (-1 if i == 0 else 1),
                batch_index=env_index,
            )
        for i, joint in enumerate(self._joints):
            joint.landmark.set_pos(
                ball_position + (start_delta / 2) * (-1 if i == 0 else 1),
                batch_index=env_index,
            )
            joint.landmark.set_rot(
                start_angle + (math.pi if i == 1 else 0),
                batch_index=env_index,
            )

        self.spawn_path_line(env_index)
        pos_shaping = (
            torch.linalg.norm(
                self._ball.state.pos - self._goal.state.pos, dim=1
            )
            * self.pos_shaping_factor
        )
        if env_index is None:
            self.pos_shaping = pos_shaping
            self.collided = torch.zeros((B,), dtype=torch.bool, device=dev)
            self.pos_rew = torch.zeros((B,), device=dev)
            self.collision_rew = torch.zeros((B,), device=dev)
            self.rew = torch.zeros((B,), device=dev)
        else:
            self.pos_shaping = TorchUtils.where_from_index(
                env_index, pos_shaping, self.pos_shaping
            )
            self.collided = TorchUtils.where_from_index(
                env_index, False, self.collided
            )

    def reward(self, agent):
        is_first = agent is self.world.agents[0]
        if is_first:
            B = self.world.batch_dim
            dev = self.world.device
            collision_rew = torch.zeros((B,), device=dev)
            collided = torch.zeros((B,), dtype=torch.bool, device=dev)

            dist_to_goal = torch.linalg.norm(
                self._ball.state.pos - self._goal.state.pos, dim=1
            )
            pos_shaping = dist_to_goal * self.pos_shaping_factor
            self.pos_rew = self.pos_shaping - pos_shaping
            self.pos_shaping = pos_shaping

            for collidable in self.world.agents + [self._ball]:
                for entity in self._walls + self._floors:
                    is_overlap = self.world.is_overlapping(collidable, entity)
                    collision_rew = collision_rew + torch.where(
                        is_overlap, float(self.collision_reward), 0.0
                    )
                    collided = collided | is_overlap
            self.collision_rew = collision_rew
            self.collided = collided
            self.rew = self.pos_rew + self.collision_rew
        return self.rew

    def observation(self, agent):
        return torch.cat(
            [
                agent.state.pos,
                agent.state.vel,
                agent.state.pos - self._goal.state.pos,
            ],
            dim=-1,
        )

    def done(self):
        return (
            torch.linalg.norm(
                self._ball.state.pos - self._goal.state.pos, dim=1
            )
            <= 0.01
        ) | self.collided

    def info(self, agent):
        return {"pos_rew": self.pos_rew, "collision_rew": self.collision_rew}

    def build_path_line(self, world: World):
        self._walls = []
        for i in range(2):
            self._walls.append(
                Landmark(
                    name=f"wall {i}",
                    collide=True,
                    shape=Line(length=self.wall_length),
                    color=Color.BLACK,
                )
            )
            world.add_landmark(self._walls[i])
        self._floors = []
        for i in range(2):
            self._floors.append(
                Landmark(
                    name=f"floor {i}",
                    collide=True,
                    shape=Line(length=self.agent_spacing / 2),
                    color=Color.BLACK,
                )
            )
            world.add_landmark(self._floors[i])
        # The walls' and floors' poses, made once on the device so that a
        # reset copies nothing from the host.
        dev = world.device
        self._wall_pos = [
            torch.tensor([(self.agent_spacing / 4) * (-1 if i == 0 else 1),
                          0.0], device=dev)
            for i in range(2)
        ]
        self._wall_rot = torch.tensor([math.pi / 2], device=dev)
        self._floor_pos = [
            torch.tensor([0.0, (self.wall_length / 2) * (-1 if i == 0 else 1)],
                         device=dev)
            for i in range(2)
        ]

    def spawn_path_line(self, env_index):
        for i, wall in enumerate(self._walls):
            wall.set_pos(self._wall_pos[i], batch_index=env_index)
            wall.set_rot(self._wall_rot, batch_index=env_index)
        for i, floor in enumerate(self._floors):
            floor.set_pos(self._floor_pos[i], batch_index=env_index)
