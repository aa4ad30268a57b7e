"""Joint_passage scenario (reference ``vmas/scenarios/joint_passage.py``).

Two agents rigidly joined (optionally with an asymmetric mass on the link)
must carry the joint through a passage opening in a wall and pose it on a
goal line: position + rotation shaping with collision penalties.  At its
defaults: 23 entities, 3 joint constraints, 10 substeps, joint_force 900,
collision_force 2500.

Deviations from VMAS, as in the JAX package:
 * the per-reset python ``randperm`` endpoint swap (joint_passage.py:286-288)
   becomes a per-env random sign;
 * in ``fixed_passage=False`` mode the data-dependent passage placement loop
   (joint_passage.py:666-681) is re-expressed as a vectorized k-th-free-slot
   computation, and the joint-vs-passage collision filter matches the
   reference's "collide with all" semantics for that mode.
"""
import math

import numpy as np
import torch

from vectorizedmultiagentsimulator_tpu_torch.controllers import VelocityController
from vectorizedmultiagentsimulator_tpu_torch.core import (
    Agent,
    Box,
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
    X,
    Y,
)


def get_line_angle_0_180(rot):
    return rot % math.pi


def get_line_angle_dist_0_180(angle, goal):
    angle = get_line_angle_0_180(angle)
    if not isinstance(goal, torch.Tensor):
        goal = torch.tensor(goal, dtype=torch.float32)
    goal = get_line_angle_0_180(goal)
    return torch.minimum(
        torch.abs(angle - goal),
        torch.minimum(
            torch.abs(angle - (goal - math.pi)),
            torch.abs((angle - math.pi) - goal),
        ),
    ).squeeze(-1)


def angle_to_vector(angle):
    return torch.cat([torch.cos(angle), torch.sin(angle)], dim=1)


def passage_slots(open_idx, n_collide: int, n_ext: int):
    """The slot of each collide passage, ``[B, n_collide]``: the k-th slot
    of ``range(n_ext)`` that no column of ``open_idx [B, P]`` holds."""
    slots = torch.arange(n_ext, device=open_idx.device)
    is_open = torch.any(slots[None, :, None] == open_idx[:, None, :], dim=-1)
    free_rank = torch.cumsum((~is_open).to(torch.int32), dim=1)  # 1-indexed
    return torch.stack(
        [torch.argmax((free_rank == (k + 1)).to(torch.int32), dim=1)
         for k in range(n_collide)],
        dim=1,
    )


def wall_poses(world, agent_radius):
    """The four boundary walls' ``(pos, rot)``, right, top, left, bottom,
    as device tensors made once, so that a reset copies nothing from the
    host."""
    xs, ys = world.x_semidim + agent_radius, world.y_semidim + agent_radius
    dev = world.device
    return [
        (torch.tensor(p, device=dev), torch.tensor([a], device=dev))
        for p, a in (([xs, 0.0], math.pi / 2), ([0.0, ys], 0.0),
                     ([-xs, 0.0], math.pi / 2), ([0.0, -ys], 0.0))
    ]


def spawn_walls(walls, poses, env_index):
    for wall, (pos, rot) in zip(walls, poses):
        wall.set_pos(pos, batch_index=env_index)
        wall.set_rot(rot, batch_index=env_index)


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        self.n_passages = kwargs.pop("n_passages", 1)
        self.fixed_passage = kwargs.pop("fixed_passage", True)
        self.joint_length = kwargs.pop("joint_length", 0.5)
        self.random_start_angle = kwargs.pop("random_start_angle", True)
        self.random_goal_angle = kwargs.pop("random_goal_angle", True)
        self.observe_joint_angle = kwargs.pop("observe_joint_angle", False)
        self.joint_angle_obs_noise = kwargs.pop("joint_angle_obs_noise", 0.0)
        self.asym_package = kwargs.pop("asym_package", True)
        self.mass_ratio = kwargs.pop("mass_ratio", 5)
        self.mass_position = kwargs.pop("mass_position", 0.75)
        self.max_speed_1 = kwargs.pop("max_speed_1", None)
        self.pos_shaping_factor = kwargs.pop("pos_shaping_factor", 1)
        self.rot_shaping_factor = kwargs.pop("rot_shaping_factor", 1)
        self.collision_reward = kwargs.pop("collision_reward", 0)
        self.energy_reward_coeff = kwargs.pop("energy_reward_coeff", 0)
        self.all_passed_rot = kwargs.pop("all_passed_rot", True)
        self.obs_noise = kwargs.pop("obs_noise", 0.0)
        self.use_controller = kwargs.pop("use_controller", False)
        ScenarioUtils.check_kwargs_consumed(kwargs)

        self.plot_grid = True
        self.visualize_semidims = False

        world = World(
            batch_dim,
            device,
            x_semidim=1,
            y_semidim=1,
            substeps=7 if not self.asym_package else 10,
            joint_force=900 if self.asym_package else 400,
            collision_force=2500 if self.asym_package else 1500,
            drag=0.25 if not self.asym_package else 0.15,
        )
        if not self.observe_joint_angle:
            assert self.joint_angle_obs_noise == 0

        self.middle_angle = math.pi / 2
        self.n_agents = 2
        self.agent_radius = 0.03333
        self.mass_radius = self.agent_radius * (2 / 3)
        self.passage_width = 0.2
        self.passage_length = 0.1476
        self.scenario_length = 2 * world.x_semidim + 2 * self.agent_radius
        self.n_boxes = int(self.scenario_length // self.passage_length)
        self.min_collision_distance = 0.005
        assert 1 <= self.n_passages <= self.n_boxes

        controller_params = [2.0, 10, 0.00001]

        for i in range(2):
            second = dict(
                mass=1 if self.asym_package else self.mass_ratio,
                color=Color.BLUE,
                max_speed=self.max_speed_1,
            )
            agent = Agent(
                name=f"agent_{i}",
                shape=Sphere(self.agent_radius),
                obs_noise=self.obs_noise,
                render_action=True,
                u_multiplier=0.8,
                f_range=0.8,
                **(second if i == 1 else {}),
            )
            agent.controller = VelocityController(
                agent, world, controller_params, "standard"
            )
            world.add_agent(agent)

        self._joint = Joint(
            world.agents[0],
            world.agents[1],
            anchor_a=(0, 0),
            anchor_b=(0, 0),
            dist=self.joint_length,
            rotate_a=True,
            rotate_b=True,
            collidable=True,
            width=0,
            mass=1,
        )
        world.add_joint(self._joint)

        if self.asym_package:

            def mass_collision_filter(e):
                return not isinstance(e.shape, Sphere)

            self._mass = Landmark(
                name="mass",
                shape=Sphere(radius=self.mass_radius),
                collide=True,
                movable=True,
                color=Color.BLACK,
                mass=self.mass_ratio,
                collision_filter=mass_collision_filter,
            )
            world.add_landmark(self._mass)
            world.add_joint(
                Joint(
                    self._mass,
                    self._joint.landmark,
                    anchor_a=(0, 0),
                    anchor_b=(self.mass_position, 0),
                    dist=0,
                    rotate_a=True,
                    rotate_b=True,
                )
            )

        self._goal = Landmark(
            name="joint_goal",
            shape=Line(length=self.joint_length),
            collide=False,
            color=Color.GREEN,
        )
        world.add_landmark(self._goal)

        self._walls = []
        for i in range(4):
            wall = Landmark(
                name=f"wall {i}",
                collide=True,
                shape=Line(length=2 + self.agent_radius * 2),
                color=Color.BLACK,
            )
            world.add_landmark(wall)
            self._walls.append(wall)
        self._wall_poses = wall_poses(world, self.agent_radius)

        self.create_passage_map(world)
        return world

    @property
    def joint(self):
        return self._joint

    @property
    def goal(self):
        return self._goal

    # -------------------------------------------------------------- #
    # Passage map
    # -------------------------------------------------------------- #
    def _fixed_passage_indexes(self):
        """Deterministic open-slot indexes (joint_passage.py:649-655)."""
        indexes = []
        j = self.n_boxes // 2
        for i in range(self.n_passages):
            j += i * (-1 if i % 2 == 0 else 1)
            indexes.append(j)
        return indexes

    def create_passage_map(self, world: World):
        self._passages = []
        self._collide_passages = []
        self._non_collide_passages = []

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
            if not passage.collide:
                self._non_collide_passages.append(passage)
            else:
                self._collide_passages.append(passage)
            self._passages.append(passage)
            world.add_landmark(passage)

        if self.fixed_passage:
            # Static neighbour flags: a collide passage adjacent to an open
            # slot collides with the joint line (joint_passage.py:615-621).
            indexes = set(self._fixed_passage_indexes())
            slots = []
            i = 0
            for _ in self._collide_passages:
                while i in indexes:
                    i += 1
                slots.append(i)
                i += 1
            neighbour_set = set()
            for p, slot in zip(self._collide_passages, slots):
                if (slot - 1) in indexes or (slot + 1) in indexes:
                    neighbour_set.add(p.name)
            # The slots as device tensors, made once.
            self._fixed_open_slots = torch.tensor(
                self._fixed_passage_indexes(), device=world.device
            )
            self._fixed_collide_slots = torch.tensor(slots, device=world.device)

            def joint_collides(e):
                return e.name in neighbour_set

        else:

            def joint_collides(e):
                return e in self._collide_passages

        self._joint.landmark.collision_filter = joint_collides

    def _slot_pos(self, i):
        """Slot index tensor ``[...]`` -> position ``[..., 2]``."""
        x = (
            -1
            - self.agent_radius
            + self.passage_length / 2
            + self.passage_length * i.to(torch.float32)
        )
        return torch.stack([x, torch.zeros_like(x)], dim=-1)

    def spawn_passage_map(self, env_index):
        B = self.world.batch_dim
        dev = self.world.device
        if self.fixed_passage:
            open_idx = self._fixed_open_slots[None].expand(B, -1)
            collide_slots = self._fixed_collide_slots[None].expand(B, -1)
        else:
            open_idx = torch.randint(
                0, self.n_boxes - 1, (B, self.n_passages),
                generator=self.world.generator, device=dev,
            )
            # k-th free slot per env, over an extended range so all collide
            # passages fit even when open slots cluster at the end.
            collide_slots = passage_slots(
                open_idx, len(self._collide_passages),
                self.n_boxes + self.n_passages + 1,
            )

        for k, passage in enumerate(self._non_collide_passages):
            passage.is_rendering = torch.zeros((B,), dtype=torch.bool,
                                               device=dev)
            passage.set_pos(
                self._slot_pos(open_idx[:, k]), batch_index=env_index
            )
        for k, passage in enumerate(self._collide_passages):
            passage.set_pos(
                self._slot_pos(collide_slots[:, k]), batch_index=env_index
            )

    # -------------------------------------------------------------- #
    def reset_world_at(self, env_index=None):
        B = self.world.batch_dim
        dev = self.world.device
        g = self.world.generator

        def half_pi_uniform():
            return (torch.rand((B, 1), generator=g, device=dev) - 0.5) * math.pi

        if self.random_start_angle:
            start_angle = half_pi_uniform()
        else:
            start_angle = torch.zeros((B, 1), device=dev)
        if self.random_goal_angle:
            goal_angle = half_pi_uniform()
        else:
            goal_angle = torch.zeros((B, 1), device=dev)

        start_delta = (self.joint_length / 2) * torch.cat(
            [torch.cos(start_angle), torch.sin(start_angle)], dim=1
        )
        sdx_abs = torch.abs(start_delta[:, :1])
        sdy_abs = torch.abs(start_delta[:, 1:])
        min_x_start = -self.world.x_semidim + self.agent_radius + sdx_abs
        max_x_start = self.world.x_semidim - (self.agent_radius + sdx_abs)
        min_y_start = -self.world.y_semidim + self.agent_radius + sdy_abs
        max_y_start = (
            -2 * self.agent_radius - self.passage_width / 2 - sdy_abs
        )

        goal_delta = (self.joint_length / 2) * torch.cat(
            [torch.cos(goal_angle), torch.sin(goal_angle)], dim=1
        )
        gdx_abs = torch.abs(goal_delta[:, :1])
        gdy_abs = torch.abs(goal_delta[:, 1:])
        min_x_goal = -self.world.x_semidim + self.agent_radius + gdx_abs
        max_x_goal = self.world.x_semidim - (self.agent_radius + gdx_abs)
        min_y_goal = (
            2 * self.agent_radius + self.passage_width / 2 + gdy_abs
        )
        max_y_goal = self.world.y_semidim - (self.agent_radius + gdy_abs)

        u1 = torch.rand((B, 2), generator=g, device=dev)
        joint_pos = torch.cat(
            [
                (min_x_start - max_x_start) * u1[:, :1] + max_x_start,
                (min_y_start - max_y_start) * u1[:, 1:] + max_y_start,
            ],
            dim=1,
        )
        u2 = torch.rand((B, 2), generator=g, device=dev)
        goal_pos = torch.cat(
            [
                (min_x_goal - max_x_goal) * u2[:, :1] + max_x_goal,
                (min_y_goal - max_y_goal) * u2[:, 1:] + max_y_goal,
            ],
            dim=1,
        )

        self._goal.set_pos(goal_pos, batch_index=env_index)
        self._goal.set_rot(goal_angle, batch_index=env_index)

        # A random sign drawn on the device: no host read.
        sign = torch.where(
            torch.rand((B, 1), generator=g, device=dev) < 0.5, 1.0, -1.0
        )
        for i, agent in enumerate(self.world.agents):
            agent.controller.reset(env_index)
            agent.set_pos(
                joint_pos + sign * start_delta * (-1 if i == 0 else 1),
                batch_index=env_index,
            )
        if self.asym_package:
            self._mass.set_pos(
                joint_pos + self.mass_position * start_delta * sign,
                batch_index=env_index,
            )

        self.spawn_passage_map(env_index)
        spawn_walls(self._walls, self._wall_poses, env_index)

        pos_shaping_pre = self._closest_passage_dist() * self.pos_shaping_factor
        pos_shaping_post = (
            torch.linalg.norm(
                self._joint.landmark.state.pos - self._goal.state.pos, dim=1
            )
            * self.pos_shaping_factor
        )
        rot_shaping_pre = (
            get_line_angle_dist_0_180(
                self._joint.landmark.state.rot, self.middle_angle
            )
            * self.rot_shaping_factor
        )
        rot_shaping_post = (
            get_line_angle_dist_0_180(
                self._joint.landmark.state.rot, self._goal.state.rot
            )
            * self.rot_shaping_factor
        )
        if env_index is None:
            self.passed = torch.zeros((B,), device=dev)
            self.pos_shaping_pre = pos_shaping_pre
            self.pos_shaping_post = pos_shaping_post
            self.rot_shaping_pre = rot_shaping_pre
            self.rot_shaping_post = rot_shaping_post
            self.pos_rew = torch.zeros((B,), device=dev)
            self.rot_rew = torch.zeros((B,), device=dev)
            self.collision_rew = torch.zeros((B,), device=dev)
            self.energy_rew = torch.zeros((B,), device=dev)
            self.energy_expenditure = torch.zeros((B,), device=dev)
            self.all_passed = torch.zeros((B,), dtype=torch.bool, device=dev)
            self.rew = torch.zeros((B,), device=dev)
        else:
            self.passed = TorchUtils.where_from_index(
                env_index, 0.0, self.passed
            )
            self.pos_shaping_pre = TorchUtils.where_from_index(
                env_index, pos_shaping_pre, self.pos_shaping_pre
            )
            self.pos_shaping_post = TorchUtils.where_from_index(
                env_index, pos_shaping_post, self.pos_shaping_post
            )
            self.rot_shaping_pre = TorchUtils.where_from_index(
                env_index, rot_shaping_pre, self.rot_shaping_pre
            )
            self.rot_shaping_post = TorchUtils.where_from_index(
                env_index, rot_shaping_post, self.rot_shaping_post
            )

    def _closest_passage_dist(self):
        return torch.min(
            torch.stack(
                [
                    torch.linalg.norm(
                        self._joint.landmark.state.pos - p.state.pos, dim=1
                    )
                    for p in self._non_collide_passages
                ],
                dim=1,
            ),
            dim=1,
        ).values

    def reward(self, agent):
        is_first = agent is self.world.agents[0]
        if is_first:
            B = self.world.batch_dim
            dev = self.world.device
            joint_passed = self._joint.landmark.state.pos[:, Y] > 0
            self.all_passed = torch.all(
                torch.stack(
                    [a.state.pos[:, Y] for a in self.world.agents], dim=1
                )
                > self.passage_width / 2,
                dim=1,
            )

            joint_shaping = self._closest_passage_dist() * self.pos_shaping_factor
            pos_rew = torch.where(
                joint_passed, 0.0, self.pos_shaping_pre - joint_shaping
            )
            self.pos_shaping_pre = joint_shaping

            joint_dist_to_goal = torch.linalg.norm(
                self._joint.landmark.state.pos - self._goal.state.pos, dim=1
            )
            joint_shaping = joint_dist_to_goal * self.pos_shaping_factor
            pos_rew = pos_rew + torch.where(
                joint_passed, self.pos_shaping_post - joint_shaping, 0.0
            )
            self.pos_shaping_post = joint_shaping
            self.pos_rew = pos_rew

            rot_passed = (
                self.all_passed if self.all_passed_rot else joint_passed
            )
            joint_dist_to_90_rot = get_line_angle_dist_0_180(
                self._joint.landmark.state.rot, self.middle_angle
            )
            joint_shaping = joint_dist_to_90_rot * self.rot_shaping_factor
            rot_rew = torch.where(
                rot_passed, 0.0, self.rot_shaping_pre - joint_shaping
            )
            self.rot_shaping_pre = joint_shaping

            joint_dist_to_goal_rot = get_line_angle_dist_0_180(
                self._joint.landmark.state.rot, self._goal.state.rot
            )
            joint_shaping = joint_dist_to_goal_rot * self.rot_shaping_factor
            rot_rew = rot_rew + torch.where(
                rot_passed, self.rot_shaping_post - joint_shaping, 0.0
            )
            self.rot_shaping_post = joint_shaping
            self.rot_rew = rot_rew

            collision_rew = torch.zeros((B,), device=dev)
            # With no penalty (the default) every term is 0: the 52
            # distance queries are skipped, as joint_passage_size does.
            if self.collision_reward != 0:
                penalty = float(self.collision_reward)
                movers = self.world.agents + (
                    [self._mass] if self.asym_package else []
                )
                for a in movers:
                    for other in self._collide_passages + self._walls:
                        collision_rew = collision_rew + torch.where(
                            self.world.get_distance(a, other)
                            <= self.min_collision_distance,
                            penalty,
                            0.0,
                        )
                for p in self._collide_passages:
                    collision_rew = collision_rew + torch.where(
                        self.world.get_distance(p, self._joint.landmark)
                        <= self.min_collision_distance,
                        penalty,
                        0.0,
                    )
            self.collision_rew = collision_rew

            self.energy_expenditure = torch.sum(
                torch.stack(
                    [
                        torch.linalg.norm(a.action.u, dim=-1)
                        / math.sqrt(self.world.dim_p * (a.f_range**2))
                        for a in self.world.agents
                    ],
                    dim=1,
                ),
                dim=-1,
            )
            self.energy_rew = -self.energy_expenditure * self.energy_reward_coeff

            self.rew = (
                self.pos_rew
                + self.rot_rew
                + self.collision_rew
                + self.energy_rew
            )
        return self.rew

    def observation(self, agent):
        B = self.world.batch_dim
        dev = self.world.device
        g = self.world.generator
        if self.observe_joint_angle:
            joint_angle = self._joint.landmark.state.rot
            if self.joint_angle_obs_noise:
                joint_angle = (
                    joint_angle
                    + torch.randn((B, 1), generator=g, device=dev)
                    * self.joint_angle_obs_noise
                )
        passage_obs = [
            agent.state.pos - passage.state.pos
            for passage in self._non_collide_passages
        ]
        observations = [
            agent.state.pos,
            agent.state.vel,
            agent.state.pos - self._goal.state.pos,
            *passage_obs,
            angle_to_vector(self._goal.state.rot),
        ] + (
            [angle_to_vector(joint_angle)] if self.observe_joint_angle else []
        )
        if self.obs_noise > 0:
            observations = [
                obs
                + (torch.rand(obs.shape, generator=g, device=dev) * 2 - 1)
                * self.obs_noise
                for obs in observations
            ]
        return torch.cat(observations, dim=-1)

    def done(self):
        return torch.all(
            (
                torch.linalg.norm(
                    self._joint.landmark.state.pos - self._goal.state.pos,
                    dim=1,
                )
                <= 0.01
            )[:, None]
            & (
                get_line_angle_dist_0_180(
                    self._joint.landmark.state.rot, self._goal.state.rot
                )[:, None]
                <= 0.01
            ),
            dim=1,
        )

    def process_action(self, agent):
        if self.use_controller:
            vel_is_zero = torch.linalg.norm(agent.action.u, dim=1) < 1e-3
            agent.controller.reset(vel_is_zero)
            agent.controller.process_force()

    def info(self, agent):
        is_first = self.world.agents[0] is agent
        if is_first:
            just_passed = self.all_passed & (self.passed == 0)
            self.passed = torch.where(just_passed, 100.0, self.passed)
            self._info_stored = {
                "pos_rew": self.pos_rew,
                "rot_rew": self.rot_rew,
                "collision_rew": self.collision_rew,
                "energy_rew": self.energy_rew,
                "passed": just_passed.to(torch.int32),
            }
        return self._info_stored

    def extra_render(self, env_index: int = 0):
        from vectorizedmultiagentsimulator_tpu_torch import render as rendering

        geoms = []
        color = self._goal.color
        goal_pos = np.asarray(self._goal.state.pos)[env_index]
        goal_rot = float(np.asarray(self._goal.state.rot)[env_index, 0])
        for sgn, radius in ((-1, self.agent_radius), (1, self.agent_radius)):
            circ = rendering.make_circle(radius)
            xform = rendering.Transform()
            circ.add_attr(xform)
            xform.set_translation(
                goal_pos[X] + sgn * self.joint_length / 2 * math.cos(goal_rot),
                goal_pos[Y] + sgn * self.joint_length / 2 * math.sin(goal_rot),
            )
            circ.set_color(*color[:3])
            geoms.append(circ)
        return geoms
