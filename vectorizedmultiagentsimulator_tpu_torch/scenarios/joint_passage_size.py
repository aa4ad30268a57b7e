"""Joint_passage_size scenario (reference
``vmas/scenarios/joint_passage_size.py``).

Like joint_passage but with differently-sized agents: a 2-slot "big"
passage and a 1-slot "small" passage offset -3 or +4 slots; the joint
must be oriented so each agent fits through its matching hole.

As in the JAX package, the data-dependent collide-passage placement loop
is a vectorized k-th-free-slot computation (``joint_passage.
passage_slots``), and the start angle +-pi/2 is drawn per env.
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
from vectorizedmultiagentsimulator_tpu_torch.scenarios.joint_passage import (
    angle_to_vector,
    get_line_angle_dist_0_180,
    passage_slots,
    spawn_walls,
    wall_poses,
)
from vectorizedmultiagentsimulator_tpu_torch.utils import (
    Color,
    ScenarioUtils,
    TorchUtils,
    X,
    Y,
)


def get_line_angle_dist_0_360(angle, goal):
    angle = angle_to_vector(angle)
    goal = angle_to_vector(goal)
    return -torch.sum(angle * goal, dim=-1)


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        self.fixed_passage = kwargs.pop("fixed_passage", False)
        self.joint_length = kwargs.pop("joint_length", 0.52)
        self.random_start_angle = kwargs.pop("random_start_angle", False)
        self.random_goal_angle = kwargs.pop("random_goal_angle", False)
        self.observe_joint_angle = kwargs.pop("observe_joint_angle", False)
        self.joint_angle_obs_noise = kwargs.pop("joint_angle_obs_noise", 0.0)
        self.asym_package = kwargs.pop("asym_package", False)
        self.mass_ratio = kwargs.pop("mass_ratio", 1)
        self.mass_position = kwargs.pop("mass_position", 0.75)
        self.max_speed_1 = kwargs.pop("max_speed_1", None)
        self.pos_shaping_factor = kwargs.pop("pos_shaping_factor", 1)
        self.rot_shaping_factor = kwargs.pop("rot_shaping_factor", 1)
        self.collision_reward = kwargs.pop("collision_reward", 0)
        self.energy_reward_coeff = kwargs.pop("energy_reward_coeff", 0)
        self.obs_noise = kwargs.pop("obs_noise", 0.0)
        self.n_passages = kwargs.pop("n_passages", 3)
        self.middle_angle_180 = kwargs.pop("middle_angle_180", False)
        self.use_vel_controller = kwargs.pop("use_vel_controller", False)
        ScenarioUtils.check_kwargs_consumed(kwargs)

        assert self.n_passages in (3, 4)
        self.plot_grid = False
        self.visualize_semidims = False

        world = World(
            batch_dim,
            device,
            x_semidim=1,
            y_semidim=1,
            substeps=5 if not self.asym_package else 10,
            joint_force=700 if self.asym_package else 400,
            collision_force=2500 if self.asym_package else 1500,
            drag=0.25 if not self.asym_package else 0.15,
        )
        if not self.observe_joint_angle:
            assert self.joint_angle_obs_noise == 0

        self.n_agents = 2
        self.agent_radius = 0.03333
        self.agent_radius_2 = 3 * self.agent_radius
        self.mass_radius = self.agent_radius * (2 / 3)
        self.passage_width = 0.2
        self.passage_length = 0.1476
        self.scenario_length = 2 + 2 * self.agent_radius
        self.n_boxes = int(self.scenario_length // self.passage_length)
        self.min_collision_distance = 0.005

        controller_params = [2.0, 10, 0.00001]

        for i, radius in enumerate((self.agent_radius, self.agent_radius_2)):
            second = dict(
                mass=1 if self.asym_package else self.mass_ratio,
                max_speed=self.max_speed_1,
            )
            agent = Agent(
                name=f"agent_{i}",
                shape=Sphere(radius),
                u_range=1,
                obs_noise=self.obs_noise,
                render_action=True,
                f_range=10,
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
            collidable=False,
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

    def create_passage_map(self, world: World):
        self._passages = []
        self._collide_passages = []
        self._non_collide_passages = []
        for i in range(self.n_boxes):
            passage = Landmark(
                name=f"passage {i}",
                collide=not (i < self.n_passages),
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

    def _slot_pos(self, i):
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
        g = self.world.generator
        if self.fixed_passage:
            big_start = torch.full((B,), 5, device=dev)
            small_lr = torch.full((B,), 1, device=dev)
        else:
            big_start = torch.randint(0, self.n_boxes - 1, (B,), generator=g,
                                      device=dev)
            small_lr = torch.randint(0, 2, (B,), generator=g, device=dev)
        small_lr = torch.where(
            big_start > self.n_boxes - 1 - (self.n_passages + 1), 0, small_lr
        )
        small_lr = torch.where(big_start < self.n_passages, 1, small_lr)
        small_lr = torch.where(small_lr == 0, -3, small_lr)
        small_lr = torch.where(small_lr == 1, 4, small_lr)
        # (reference: 0 -> -3, 1 -> +4 via "+= 3"; joint_passage_size.py:616-619)

        open_indexes = [big_start, big_start + 1, big_start + small_lr]
        if self.n_passages == 4:
            open_indexes.append(big_start + small_lr + torch.sign(small_lr))
        open_idx = torch.stack(open_indexes, dim=1)  # [B, n_passages]
        collide_slots = passage_slots(
            open_idx, len(self._collide_passages),
            self.n_boxes + self.n_passages + 8,
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

        big_passage_pos = (
            self._slot_pos(big_start) + self._slot_pos(big_start + 1)
        ) / 2
        small_passage_pos = self._slot_pos(big_start + small_lr)
        pass_center = (big_passage_pos + small_passage_pos) / 2
        middle_angle = torch.where((small_lr > 0)[:, None], math.pi, 0.0)

        # int32, the JAX package's dtype for these ids.
        small_lr = small_lr.to(torch.int32)
        if env_index is None:
            self.small_left_or_right = small_lr
            self.pass_center = pass_center
            self.big_passage_pos = big_passage_pos
            self.small_passage_pos = small_passage_pos
            self.middle_angle = middle_angle
        else:
            self.small_left_or_right = TorchUtils.where_from_index(
                env_index, small_lr, self.small_left_or_right
            )
            self.pass_center = TorchUtils.where_from_index(
                env_index, pass_center, self.pass_center
            )
            self.big_passage_pos = TorchUtils.where_from_index(
                env_index, big_passage_pos, self.big_passage_pos
            )
            self.small_passage_pos = TorchUtils.where_from_index(
                env_index, small_passage_pos, self.small_passage_pos
            )
            self.middle_angle = TorchUtils.where_from_index(
                env_index, middle_angle, self.middle_angle
            )

    def _rot_dist(self, rot, goal):
        if self.middle_angle_180:
            return get_line_angle_dist_0_180(rot, goal)
        return get_line_angle_dist_0_360(rot, goal)

    def reset_world_at(self, env_index=None):
        B = self.world.batch_dim
        dev = self.world.device
        g = self.world.generator
        # Start angle is +-pi/2 per env (joint_passage_size.py:221-226).
        start_angle = torch.where(
            torch.rand((B, 1), generator=g, device=dev) >= 0.5,
            math.pi / 2,
            -math.pi / 2,
        )
        if self.random_goal_angle:
            goal_angle = (
                torch.rand((B, 1), generator=g, device=dev) - 0.5
            ) * math.pi
        else:
            goal_angle = torch.full((B, 1), math.pi, device=dev)

        bigger_radius = max(self.agent_radius, self.agent_radius_2)
        start_delta = (self.joint_length / 2) * torch.cat(
            [torch.cos(start_angle), torch.sin(start_angle)], dim=1
        )
        sdx_abs = torch.abs(start_delta[:, :1])
        sdy_abs = torch.abs(start_delta[:, 1:])
        min_x_start = -self.world.x_semidim + bigger_radius + sdx_abs
        max_x_start = self.world.x_semidim - (bigger_radius + sdx_abs)
        min_y_start = -self.world.y_semidim + bigger_radius + sdy_abs
        max_y_start = -2 * bigger_radius - self.passage_width / 2 - sdy_abs

        goal_delta = (self.joint_length / 2) * torch.cat(
            [torch.cos(goal_angle), torch.sin(goal_angle)], dim=1
        )
        gdx_abs = torch.abs(goal_delta[:, :1])
        gdy_abs = torch.abs(goal_delta[:, 1:])
        min_x_goal = -self.world.x_semidim + bigger_radius + gdx_abs
        max_x_goal = self.world.x_semidim - (bigger_radius + gdx_abs)
        min_y_goal = 2 * bigger_radius + self.passage_width / 2 + gdy_abs
        max_y_goal = self.world.y_semidim - (bigger_radius + gdy_abs)

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

        for i, agent in enumerate(self.world.agents):
            agent.controller.reset(env_index)
            agent.set_pos(
                joint_pos + start_delta * (-1 if i == 0 else 1),
                batch_index=env_index,
            )
        if self.asym_package:
            self._mass.set_pos(
                joint_pos + self.mass_position * start_delta,
                batch_index=env_index,
            )

        self.spawn_passage_map(env_index)
        spawn_walls(self._walls, self._wall_poses, env_index)

        pos_shaping_pre = (
            torch.linalg.norm(
                self._joint.landmark.state.pos - self.pass_center, dim=1
            )
            * self.pos_shaping_factor
        )
        pos_shaping_post = (
            torch.linalg.norm(
                self._joint.landmark.state.pos - self._goal.state.pos, dim=1
            )
            * self.pos_shaping_factor
        )
        rot_shaping_pre = (
            self._rot_dist(self._joint.landmark.state.rot, self.middle_angle)
            * self.rot_shaping_factor
        )
        if env_index is None:
            self.t = torch.zeros((B,), device=dev)
            self.passed = torch.zeros((B,), device=dev)
            self.pos_shaping_pre = pos_shaping_pre
            self.pos_shaping_post = pos_shaping_post
            self.rot_shaping_pre = rot_shaping_pre
            self.pos_rew = torch.zeros((B,), device=dev)
            self.rot_rew = torch.zeros((B,), device=dev)
            self.collision_rew = torch.zeros((B,), device=dev)
            self.energy_rew = torch.zeros((B,), device=dev)
            self.all_passed = torch.zeros((B,), dtype=torch.bool, device=dev)
            self.rew = torch.zeros((B,), device=dev)
        else:
            self.t = TorchUtils.where_from_index(env_index, 0.0, self.t)
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

    def reward(self, agent):
        is_first = agent is self.world.agents[0]
        if is_first:
            B = self.world.batch_dim
            dev = self.world.device
            self.t = self.t + 1
            joint_passed = self._joint.landmark.state.pos[:, Y] > 0
            self.all_passed = torch.all(
                torch.stack(
                    [a.state.pos[:, Y] for a in self.world.agents], dim=1
                )
                > self.passage_width / 2,
                dim=1,
            )

            joint_dist_to_closest_pass = torch.linalg.norm(
                self._joint.landmark.state.pos - self.pass_center, dim=1
            )
            joint_shaping = (
                joint_dist_to_closest_pass * self.pos_shaping_factor
            )
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

            joint_dist_to_90_rot = self._rot_dist(
                self._joint.landmark.state.rot, self.middle_angle
            )
            joint_shaping = joint_dist_to_90_rot * self.rot_shaping_factor
            self.rot_rew = self.rot_shaping_pre - joint_shaping
            self.rot_shaping_pre = joint_shaping

            collision_rew = torch.zeros((B,), device=dev)
            if self.collision_reward != 0:
                movers = self.world.agents + (
                    [self._mass] if self.asym_package else []
                )
                for a in movers:
                    for other in self._collide_passages + self._walls:
                        collision_rew = collision_rew + torch.where(
                            self.world.get_distance(a, other)
                            <= self.min_collision_distance,
                            float(self.collision_reward),
                            0.0,
                        )
            self.collision_rew = collision_rew

            if self.energy_reward_coeff != 0:
                energy_expenditure = torch.sum(
                    torch.stack(
                        [
                            torch.linalg.norm(a.action.u, dim=-1)
                            / math.sqrt(
                                self.world.dim_p
                                * ((a.u_range * a.u_multiplier) ** 2)
                            )
                            for a in self.world.agents
                        ],
                        dim=1,
                    ),
                    dim=-1,
                )
                self.energy_rew = -energy_expenditure * self.energy_reward_coeff
            else:
                self.energy_rew = torch.zeros((B,), device=dev)

            self.rew = (
                self.pos_rew
                + self.rot_rew
                + self.collision_rew
                + self.energy_rew
            )
        return self.rew

    def process_action(self, agent):
        if self.use_vel_controller:
            vel_is_zero = torch.linalg.norm(agent.action.u, dim=1) < 1e-3
            agent.controller.reset(vel_is_zero)
            agent.controller.process_force()

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
        observations = [
            agent.state.pos,
            agent.state.vel,
            agent.state.pos - self._goal.state.pos,
            agent.state.pos - self.big_passage_pos,
            agent.state.pos - self.small_passage_pos,
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
        for sgn, radius in ((-1, self.agent_radius), (1, self.agent_radius_2)):
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
