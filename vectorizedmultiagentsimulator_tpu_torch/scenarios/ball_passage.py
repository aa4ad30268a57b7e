"""Ball_passage scenario (reference ``vmas/scenarios/ball_passage.py``).

Two agents push a ball through a random opening in a wall to a goal on
the other side; shaping before and after the passage, and overlap
penalties.

As in the JAX package, the openings' places are a permutation drawn per
env (the reference draws one for the whole batch): here the ranks of
uniform draws from the world's generator.
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
from vectorizedmultiagentsimulator_tpu_torch.scenarios.passage import (
    passage_slots,
)
from vectorizedmultiagentsimulator_tpu_torch.utils import (
    Color,
    ScenarioUtils,
    TorchUtils,
    X,
    Y,
)


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        self.n_passages = kwargs.pop("n_passages", 1)
        self.fixed_passage = kwargs.pop("fixed_passage", False)
        self.random_start_angle = kwargs.pop("random_start_angle", True)
        ScenarioUtils.check_kwargs_consumed(kwargs)
        assert 1 <= self.n_passages <= 20

        self.pos_shaping_factor = 1
        self.collision_reward = -0.06
        self.n_agents = 2
        self.agent_spacing = 0.5
        self.agent_radius = 0.03333
        self.ball_radius = self.agent_radius
        self.passage_width = 0.2
        self.passage_length = 0.103
        self.visualize_semidims = False

        world = World(
            batch_dim, device, x_semidim=1, y_semidim=1, drag=0,
            linear_friction=0.0,
        )
        for i in range(2):
            world.add_agent(
                Agent(
                    name=f"agent_{i}",
                    shape=Sphere(self.agent_radius),
                    u_multiplier=0.7,
                    mass=2,
                    drag=0.25,
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
            mass=1,
            color=Color.BLACK,
            linear_friction=0.02,
        )
        world.add_landmark(self._ball)
        self.create_passage_map(world)
        self._slot_x = passage_slots(self.n_boxes, self.agent_radius,
                                     self.passage_length, world.device)
        return world

    @property
    def ball(self):
        return self._ball

    @property
    def goal(self):
        return self._goal

    def create_passage_map(self, world: World):
        self._passages = []
        self.n_boxes = int(
            (2 * world.x_semidim + 2 * self.agent_radius)
            // self.passage_length
        )

        def removed(i):
            return (
                (self.n_boxes // 2) - self.n_passages / 2
                <= i
                < (self.n_boxes // 2) + self.n_passages / 2
            )

        for i in range(self.n_boxes):
            passage = Landmark(
                name=f"passage {i}",
                collide=not removed(i),
                movable=False,
                shape=Box(
                    length=self.passage_length, width=self.passage_width
                ),
                color=Color.RED,
                collision_filter=lambda e: not isinstance(e.shape, Box),
            )
            self._passages.append(passage)
            world.add_landmark(passage)

    def _open_passages(self):
        return [p for p in self._passages if not p.collide]

    def spawn_passage_map(self, env_index):
        B = self.world.batch_dim
        dev = self.world.device
        if not self.fixed_passage:
            perm = ScenarioUtils.random_permutations(self.world, self.n_boxes)
        else:
            perm = torch.arange(self.n_boxes, device=dev).expand(
                B, self.n_boxes)
        for i, passage in enumerate(self._passages):
            if not passage.collide:
                passage.is_rendering = torch.zeros((B,), dtype=torch.bool,
                                                   device=dev)
            x = self._slot_x[perm[:, i]]
            passage.set_pos(
                torch.stack([x, torch.zeros_like(x)], dim=1),
                batch_index=env_index,
            )

    def _ball_to_closest_open_passage(self):
        return torch.min(
            torch.stack(
                [
                    torch.linalg.norm(
                        self._ball.state.pos - p.state.pos, dim=1
                    )
                    for p in self._open_passages()
                ],
                dim=1,
            ),
            dim=1,
        ).values

    def reset_world_at(self, env_index=None):
        B = self.world.batch_dim
        dev = self.world.device
        world = self.world
        if self.random_start_angle:
            start_angle = ScenarioUtils.uniform_in_bounds(
                world, -math.pi / 2, math.pi / 2, (1,))
        else:
            start_angle = torch.full((B, 1), -math.pi / 2, device=dev)
        start_delta = (self.agent_spacing / 2) * torch.cat(
            [torch.cos(start_angle), torch.sin(start_angle)], dim=1
        )
        sdx_abs = torch.abs(start_delta[:, :1])
        sdy_abs = torch.abs(start_delta[:, 1:])
        min_x_start = -world.x_semidim + self.agent_radius + sdx_abs
        max_x_start = world.x_semidim - (self.agent_radius + sdx_abs)
        min_y_start = -world.y_semidim + self.agent_radius + sdy_abs
        max_y_start = (
            -2 * self.agent_radius - self.passage_width / 2 - sdy_abs
        )
        min_x_goal = -world.x_semidim + self.agent_radius
        max_x_goal = world.x_semidim - self.agent_radius
        min_y_goal = 2 * self.agent_radius + self.passage_width / 2
        max_y_goal = world.y_semidim - self.agent_radius

        u1 = ScenarioUtils.uniform_in_bounds(world, 0.0, 1.0)
        ball_pos = torch.cat(
            [
                (min_x_start - max_x_start) * u1[:, :1] + max_x_start,
                (min_y_start - max_y_start) * u1[:, 1:] + max_y_start,
            ],
            dim=1,
        )
        self._ball.set_pos(ball_pos, batch_index=env_index)
        for i, agent in enumerate(world.agents):
            agent.set_pos(
                ball_pos + start_delta * (-1 if i == 0 else 1),
                batch_index=env_index,
            )
        u2 = ScenarioUtils.uniform_in_bounds(world, 0.0, 1.0)
        self._goal.set_pos(
            torch.cat(
                [
                    (min_x_goal - max_x_goal) * u2[:, :1] + max_x_goal,
                    (min_y_goal - max_y_goal) * u2[:, 1:] + max_y_goal,
                ],
                dim=1,
            ),
            batch_index=env_index,
        )

        self.spawn_passage_map(env_index)

        pos_shaping_pre = (
            self._ball_to_closest_open_passage() * self.pos_shaping_factor
        )
        pos_shaping_post = (
            torch.linalg.norm(
                self._ball.state.pos - self._goal.state.pos, dim=1
            )
            * self.pos_shaping_factor
        )
        if env_index is None:
            self.pos_shaping_pre = pos_shaping_pre
            self.pos_shaping_post = pos_shaping_post
            self.pos_rew = torch.zeros((B,), device=dev)
            self.collision_rew = torch.zeros((B,), device=dev)
            self.rew = torch.zeros((B,), device=dev)
        else:
            self.pos_shaping_pre = TorchUtils.where_from_index(
                env_index, pos_shaping_pre, self.pos_shaping_pre
            )
            self.pos_shaping_post = TorchUtils.where_from_index(
                env_index, pos_shaping_post, self.pos_shaping_post
            )

    def reward(self, agent):
        is_first = agent is self.world.agents[0]
        if is_first:
            B = self.world.batch_dim
            ball_passed = self._ball.state.pos[:, Y] > 0

            ball_shaping = (
                self._ball_to_closest_open_passage() * self.pos_shaping_factor
            )
            pos_rew = torch.where(
                ball_passed, 0.0, self.pos_shaping_pre - ball_shaping
            )
            self.pos_shaping_pre = ball_shaping

            ball_dist_to_goal = torch.linalg.norm(
                self._ball.state.pos - self._goal.state.pos, dim=1
            )
            ball_shaping = ball_dist_to_goal * self.pos_shaping_factor
            pos_rew = pos_rew + torch.where(
                ball_passed, self.pos_shaping_post - ball_shaping, 0.0
            )
            self.pos_shaping_post = ball_shaping
            self.pos_rew = pos_rew

            collision_rew = torch.zeros((B,), device=self.world.device)
            for a in self.world.agents:
                for passage in self._passages:
                    if passage.collide:
                        collision_rew = collision_rew + torch.where(
                            self.world.is_overlapping(a, passage),
                            self.collision_reward,
                            0.0,
                        )
            for p in self._passages:
                if p.collide:
                    collision_rew = collision_rew + torch.where(
                        self.world.is_overlapping(p, self._ball),
                        self.collision_reward,
                        0.0,
                    )
            self.collision_rew = collision_rew
            self.rew = self.pos_rew + self.collision_rew
        return self.rew

    def observation(self, agent):
        passage_obs = [
            agent.state.pos - passage.state.pos
            for passage in self._open_passages()
        ]
        return torch.cat(
            [
                agent.state.pos,
                agent.state.vel,
                agent.state.pos - self._goal.state.pos,
                agent.state.pos - self._ball.state.pos,
                *passage_obs,
            ],
            dim=-1,
        )

    def done(self):
        bp = self._ball.state.pos
        return (
            (torch.linalg.norm(bp - self._goal.state.pos, dim=1) <= 0.01)
            | (-self.world.x_semidim + self.ball_radius >= bp[:, X])
            | (bp[:, X] >= self.world.x_semidim - self.ball_radius)
            | (-self.world.y_semidim + self.ball_radius >= bp[:, Y])
            | (bp[:, Y] >= self.world.y_semidim - self.ball_radius)
        )

    def info(self, agent):
        return {"pos_rew": self.pos_rew, "collision_rew": self.collision_rew}

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
