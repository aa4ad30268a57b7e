"""Football scenario (reference ``vmas/scenarios/football.py``).

Blue vs red teams on a walled pitch with goals; dense ball-to-goal +
agent-to-ball shaping, sparse scoring reward, optional physically-different
roles, optional shooting actions, and a scripted team AI
(:class:`AgentPolicy`) with spline-based dribbling.

PyTorch counterpart of the JAX package's ``scenarios/football.py``, with the
same state layout, so a JAX state carries across key for key:

* the AI's per-agent objective buffers live in ``state.extras`` under
  ``ai_<team>.<agent>.<field>`` (with the JAX dtypes, bool included), all
  created at the first reset; masked writes are ``where`` updates over the
  whole batch, so a masked reset reads nothing from the device;
* the AI evaluates the whole team in one stacked ``[B, T, ...]`` pass on
  the first teammate's ``action_script`` call, and the candidate planner
  (``_check_better_positions_all``) runs the hand-written CUDA kernel of
  ``ops/football_policy_cuda.py`` (its plain version on CPU tensors);
* randomness comes from the world's ``torch.Generator``: one batched draw
  per step for the planner's samples (``planner_normals``), and for the
  decision / precision noise when those strengths are not 1.

``extra_render`` draws the pitch (its geoms built at the first frame and
kept), the blue agents' index labels and, with shooting, each blue agent's
cone and kick bar.
"""
from typing import Dict, List

import numpy as np
import torch

from vectorizedmultiagentsimulator_tpu_torch.core import (
    Agent,
    Box,
    Landmark,
    Line,
    Sphere,
    World,
)
from vectorizedmultiagentsimulator_tpu_torch.dynamics import (
    Holonomic,
    HolonomicWithRotation,
)
from vectorizedmultiagentsimulator_tpu_torch.ops import football_policy_cuda
from vectorizedmultiagentsimulator_tpu_torch.scenario import BaseScenario
from vectorizedmultiagentsimulator_tpu_torch.utils import (
    Color,
    ScenarioUtils,
    TorchUtils,
    X,
    Y,
    env_index_to_mask,
)

Tensor = torch.Tensor


class Scenario(BaseScenario):
    def init_params(self, **kwargs):
        self.viewer_size = kwargs.pop("viewer_size", (1200, 800))

        self.n_blue_agents = kwargs.pop("n_blue_agents", 3)
        self.n_red_agents = kwargs.pop("n_red_agents", 3)
        self.ai_red_agents = kwargs.pop("ai_red_agents", True)
        self.ai_blue_agents = kwargs.pop("ai_blue_agents", False)
        self.physically_different = kwargs.pop("physically_different", False)

        self.spawn_in_formation = kwargs.pop("spawn_in_formation", False)
        self.only_blue_formation = kwargs.pop("only_blue_formation", True)
        self.formation_agents_per_column = kwargs.pop(
            "formation_agents_per_column", 2
        )
        self.randomise_formation_indices = kwargs.pop(
            "randomise_formation_indices", False
        )
        self.formation_noise = kwargs.pop("formation_noise", 0.2)

        self.n_traj_points = kwargs.pop("n_traj_points", 0)
        self.ai_speed_strength = kwargs.pop("ai_strength", 1.0)
        self.ai_decision_strength = kwargs.pop("ai_decision_strength", 1.0)
        self.ai_precision_strength = kwargs.pop("ai_precision_strength", 1.0)
        self.disable_ai_red = kwargs.pop("disable_ai_red", False)

        self.agent_size = kwargs.pop("agent_size", 0.025)
        self.goal_size = kwargs.pop("goal_size", 0.35)
        self.goal_depth = kwargs.pop("goal_depth", 0.1)
        self.pitch_length = kwargs.pop("pitch_length", 3.0)
        self.pitch_width = kwargs.pop("pitch_width", 1.5)
        self.ball_mass = kwargs.pop("ball_mass", 0.25)
        self.ball_size = kwargs.pop("ball_size", 0.02)

        self.u_multiplier = kwargs.pop("u_multiplier", 0.1)

        self.enable_shooting = kwargs.pop("enable_shooting", False)
        self.u_rot_multiplier = kwargs.pop("u_rot_multiplier", 0.0003)
        self.u_shoot_multiplier = kwargs.pop("u_shoot_multiplier", 0.6)
        self.shooting_radius = kwargs.pop("shooting_radius", 0.08)
        self.shooting_angle = kwargs.pop("shooting_angle", np.pi / 2)

        self.max_speed = kwargs.pop("max_speed", 0.15)
        self.ball_max_speed = kwargs.pop("ball_max_speed", 0.3)

        self.dense_reward = kwargs.pop("dense_reward", True)
        self.pos_shaping_factor_ball_goal = kwargs.pop(
            "pos_shaping_factor_ball_goal", 10.0
        )
        self.pos_shaping_factor_agent_ball = kwargs.pop(
            "pos_shaping_factor_agent_ball", 0.1
        )
        self.distance_to_ball_trigger = kwargs.pop(
            "distance_to_ball_trigger", 0.4
        )
        self.scoring_reward = kwargs.pop("scoring_reward", 100.0)

        self.observe_teammates = kwargs.pop("observe_teammates", True)
        self.observe_adversaries = kwargs.pop("observe_adversaries", True)
        self.dict_obs = kwargs.pop("dict_obs", False)

        if kwargs.pop("dense_reward_ratio", None) is not None:
            raise ValueError(
                "dense_reward_ratio in football is deprecated, please use"
                " `dense_reward` which is a bool that turns on/off the dense"
                " reward"
            )
        ScenarioUtils.check_kwargs_consumed(kwargs)

    def make_world(self, batch_dim: int, device=None, **kwargs):
        self.init_params(**kwargs)
        self.visualize_semidims = False
        world = self.init_world(batch_dim, device)
        self.init_agents(world)
        self.init_ball(world)
        self.init_walls(world)
        self.init_goals(world)
        self.init_traj_pts(world)

        dev = world.device

        def const(values):
            # made once here: a reset or a step copies nothing from the host
            return torch.tensor(values, dtype=torch.float32, device=dev)

        self.left_goal_pos = const(
            [-self.pitch_length / 2 - self.ball_size / 2, 0]
        )
        self.right_goal_pos = -self.left_goal_pos
        self._render_field = True
        self._background = None  # the pitch's geoms, made at the first frame

        self._reset_agent_range = const(
            [self.pitch_length / 2, self.pitch_width]
        )
        self._reset_agent_offset_blue = const(
            [-self.pitch_length / 2 + self.agent_size, -self.pitch_width / 2]
        )
        self._reset_agent_offset_red = const(
            [-self.agent_size, -self.pitch_width / 2]
        )
        self._pi = const([np.pi])
        self._landmark_poses = {
            name: (const(pos), None if rot is None else const([rot]))
            for name, (pos, rot) in self._landmark_layout().items()
        }
        return world

    def reset_world_at(self, env_index=None):
        B = self.world.batch_dim
        dev = self.world.device
        self.reset_agents(env_index)
        self.reset_ball(env_index)
        self.reset_walls(env_index)
        self.reset_goals(env_index)
        self.reset_controllers(env_index)
        if env_index is None:
            self.terminated = torch.zeros((B,), dtype=torch.bool, device=dev)
            self.sparse_reward_blue = torch.zeros((B,), device=dev)
            self.sparse_reward_red = torch.zeros((B,), device=dev)
            self.ball.pos_rew_blue = torch.zeros((B,), device=dev)
            self.ball.pos_rew_red = torch.zeros((B,), device=dev)
            self.ball.pos_rew_agent_blue = torch.zeros((B,), device=dev)
            self.ball.pos_rew_agent_red = torch.zeros((B,), device=dev)
            if self.enable_shooting:
                self.ball.kicking_action = torch.zeros((B, 2), device=dev)
                for agent in self.blue_agents + self.red_agents:
                    agent.ball_within_angle = torch.zeros(
                        (B,), dtype=torch.bool, device=dev
                    )
                    agent.ball_within_range = torch.zeros(
                        (B,), dtype=torch.bool, device=dev
                    )
                    agent.shoot_force = torch.zeros((B, 2), device=dev)
        else:
            self.terminated = TorchUtils.where_from_index(
                env_index, False, self.terminated
            )

    def init_world(self, batch_dim: int, device):
        world = World(
            batch_dim,
            device,
            dt=0.1,
            drag=0.05,
            x_semidim=self.pitch_length / 2
            + self.goal_depth
            - self.agent_size,
            y_semidim=self.pitch_width / 2 - self.agent_size,
            substeps=2,
        )
        world.agent_size = self.agent_size
        world.pitch_width = self.pitch_width
        world.pitch_length = self.pitch_length
        world.goal_size = self.goal_size
        world.goal_depth = self.goal_depth
        return world

    # ------------------------------------------------------------------ #
    # Agents
    # ------------------------------------------------------------------ #
    def init_agents(self, world):
        self.blue_color = (0.22, 0.49, 0.72)
        self.red_color = (0.89, 0.10, 0.11)

        def strength(val, idx):
            return val[idx] if isinstance(val, tuple) else val

        self.red_controller = (
            AgentPolicy(
                team="Red",
                disabled=self.disable_ai_red,
                speed_strength=strength(self.ai_speed_strength, 1),
                precision_strength=strength(self.ai_precision_strength, 1),
                decision_strength=strength(self.ai_decision_strength, 1),
            )
            if self.ai_red_agents
            else None
        )
        self.blue_controller = (
            AgentPolicy(
                team="Blue",
                speed_strength=strength(self.ai_speed_strength, 0),
                precision_strength=strength(self.ai_precision_strength, 0),
                decision_strength=strength(self.ai_decision_strength, 0),
            )
            if self.ai_blue_agents
            else None
        )

        def make_team_agent(name, controller, is_ai, color=None):
            shooting = self.enable_shooting and not is_ai
            return Agent(
                name=name,
                shape=Sphere(radius=self.agent_size),
                action_script=controller.run if is_ai else None,
                u_multiplier=(
                    [self.u_multiplier, self.u_multiplier]
                    if not shooting
                    else [
                        self.u_multiplier,
                        self.u_multiplier,
                        self.u_rot_multiplier,
                        self.u_shoot_multiplier,
                    ]
                ),
                max_speed=self.max_speed,
                dynamics=Holonomic()
                if not shooting
                else HolonomicWithRotation(),
                action_size=2 if not shooting else 4,
                color=color,
                alpha=1,
            )

        blue_agents = []
        if self.physically_different:
            blue_agents = self.get_physically_different_agents()
            for agent in blue_agents:
                world.add_agent(agent)
        else:
            for i in range(self.n_blue_agents):
                agent = make_team_agent(
                    f"agent_blue_{i}",
                    self.blue_controller,
                    self.ai_blue_agents,
                    color=self.blue_color,
                )
                world.add_agent(agent)
                blue_agents.append(agent)
        self.blue_agents = blue_agents
        world.blue_agents = blue_agents

        red_agents = []
        for i in range(self.n_red_agents):
            agent = make_team_agent(
                f"agent_red_{i}",
                self.red_controller,
                self.ai_red_agents,
                color=self.red_color,
            )
            world.add_agent(agent)
            red_agents.append(agent)
        self.red_agents = red_agents
        world.red_agents = red_agents

    def get_physically_different_agents(self):
        """5 blue roles: 2 attackers, 2 defenders, 1 goalkeeper
        (football.py:301-387)."""
        assert self.n_blue_agents == 5, "Physical differences only for 5 agents"

        def build(i, radius_d, mult_d, speed_d, shoot_d=0.0, rot_d=0.0):
            shooting = self.enable_shooting and not self.ai_blue_agents
            return Agent(
                name=f"agent_blue_{i}",
                shape=Sphere(radius=self.agent_size + radius_d),
                action_script=self.blue_controller.run
                if self.ai_blue_agents
                else None,
                u_multiplier=(
                    [self.u_multiplier + mult_d, self.u_multiplier + mult_d]
                    if not shooting
                    else [
                        self.u_multiplier + mult_d,
                        self.u_multiplier + mult_d,
                        self.u_rot_multiplier + rot_d,
                        self.u_shoot_multiplier + shoot_d,
                    ]
                ),
                max_speed=self.max_speed + speed_d,
                dynamics=Holonomic()
                if not shooting
                else HolonomicWithRotation(),
                action_size=2 if not shooting else 4,
                color=self.blue_color,
                alpha=1,
            )

        return [
            build(0, -0.005, 0.1, 0.05, shoot_d=-0.2),  # attacker
            build(1, -0.005, 0.1, 0.05, shoot_d=-0.2),  # attacker
            build(2, 0.0, 0.0, 0.0),  # defender
            build(3, 0.0, 0.0, 0.0),  # defender
            build(4, 0.01, -0.05, -0.1, rot_d=0.2),  # goalkeeper
        ]

    def reset_agents(self, env_index=None):
        if self.spawn_in_formation:
            self._spawn_formation(self.blue_agents, True, env_index)
            if not self.only_blue_formation:
                self._spawn_formation(self.red_agents, False, env_index)
        else:
            for agent in self.blue_agents:
                agent.set_pos(
                    self._get_random_spawn_position(blue=True),
                    batch_index=env_index,
                )
        if (
            self.spawn_in_formation and self.only_blue_formation
        ) or not self.spawn_in_formation:
            for agent in self.red_agents:
                agent.set_pos(
                    self._get_random_spawn_position(blue=False),
                    batch_index=env_index,
                )
                agent.set_rot(self._pi, batch_index=env_index)

    def _spawn_formation(self, agents, blue, env_index):
        if self.randomise_formation_indices:
            order = np.random.permutation(len(agents)).tolist()
            agents = [agents[i] for i in order]
        B = self.world.batch_dim
        dev = self.world.device
        agent_index = 0
        endpoint = -(self.pitch_length / 2 + self.goal_depth) * (
            1 if blue else -1
        )
        xs = np.linspace(
            0, endpoint, len(agents) // self.formation_agents_per_column + 3
        )
        for x in xs:
            if agent_index >= len(agents):
                break
            if x == 0 or x == endpoint:
                continue
            agents_this_column = agents[
                agent_index : agent_index + self.formation_agents_per_column
            ]
            n_col = len(agents_this_column)
            for y in np.linspace(
                self.pitch_width / 2, -self.pitch_width / 2, n_col + 2
            ):
                if y in (-self.pitch_width / 2, self.pitch_width / 2):
                    continue
                noise = (
                    torch.rand(
                        (B, self.world.dim_p),
                        generator=self.world.generator,
                        device=dev,
                    )
                    - 0.5
                ) * self.formation_noise
                # fp32 of (x, y), then the noise: no tensor from a list
                centre = torch.stack(
                    [torch.full((B,), float(np.float32(x)), device=dev),
                     torch.full((B,), float(np.float32(y)), device=dev)],
                    dim=-1,
                )
                agents[agent_index].set_pos(
                    centre + noise, batch_index=env_index
                )
                agent_index += 1

    def _get_random_spawn_position(self, blue):
        B = self.world.batch_dim
        return torch.rand(
            (B, self.world.dim_p),
            generator=self.world.generator,
            device=self.world.device,
        ) * self._reset_agent_range + (
            self._reset_agent_offset_blue
            if blue
            else self._reset_agent_offset_red
        )

    def reset_controllers(self, env_index=None):
        for controller in (self.red_controller, self.blue_controller):
            if controller is not None:
                if not controller.initialised:
                    controller.init(self.world)
                controller.reset(env_index)

    # ------------------------------------------------------------------ #
    # Ball
    # ------------------------------------------------------------------ #
    def init_ball(self, world):
        ball = Agent(
            name="Ball",
            shape=Sphere(radius=self.ball_size),
            action_script=ball_action_script,
            max_speed=self.ball_max_speed,
            mass=self.ball_mass,
            alpha=1,
            color=Color.BLACK,
        )
        world.add_agent(ball)
        world.ball = ball
        self.ball = ball

    def get_closest_agent_to_ball(self, team):
        pos = torch.stack([a.state.pos for a in team], dim=-2)  # [B, n, 2]
        dist = torch.linalg.norm(pos - self.ball.state.pos[:, None], dim=-1)
        return torch.amin(dist, dim=-1)

    def reset_ball(self, env_index=None):
        if not self.ai_blue_agents:
            min_blue = self.get_closest_agent_to_ball(self.blue_agents)
            if env_index is None:
                self.min_agent_dist_to_ball_blue = min_blue
            else:
                self.min_agent_dist_to_ball_blue = TorchUtils.where_from_index(
                    env_index, min_blue, self.min_agent_dist_to_ball_blue
                )
        if not self.ai_red_agents:
            min_red = self.get_closest_agent_to_ball(self.red_agents)
            if env_index is None:
                self.min_agent_dist_to_ball_red = min_red
            else:
                self.min_agent_dist_to_ball_red = TorchUtils.where_from_index(
                    env_index, min_red, self.min_agent_dist_to_ball_red
                )

        if not self.ai_blue_agents:
            shaping_blue = (
                torch.linalg.norm(
                    self.ball.state.pos - self.right_goal_pos[None], dim=-1
                )
                * self.pos_shaping_factor_ball_goal
            )
            shaping_agent_blue = (
                self.min_agent_dist_to_ball_blue
                * self.pos_shaping_factor_agent_ball
            )
            if env_index is None:
                self.ball.pos_shaping_blue = shaping_blue
                self.ball.pos_shaping_agent_blue = shaping_agent_blue
            else:
                self.ball.pos_shaping_blue = TorchUtils.where_from_index(
                    env_index, shaping_blue, self.ball.pos_shaping_blue
                )
                self.ball.pos_shaping_agent_blue = TorchUtils.where_from_index(
                    env_index,
                    shaping_agent_blue,
                    self.ball.pos_shaping_agent_blue,
                )
        if not self.ai_red_agents:
            shaping_red = (
                torch.linalg.norm(
                    self.ball.state.pos - self.left_goal_pos[None], dim=-1
                )
                * self.pos_shaping_factor_ball_goal
            )
            shaping_agent_red = (
                self.min_agent_dist_to_ball_red
                * self.pos_shaping_factor_agent_ball
            )
            if env_index is None:
                self.ball.pos_shaping_red = shaping_red
                self.ball.pos_shaping_agent_red = shaping_agent_red
            else:
                self.ball.pos_shaping_red = TorchUtils.where_from_index(
                    env_index, shaping_red, self.ball.pos_shaping_red
                )
                self.ball.pos_shaping_agent_red = TorchUtils.where_from_index(
                    env_index,
                    shaping_agent_red,
                    self.ball.pos_shaping_agent_red,
                )
        if self.enable_shooting:
            self.ball.kicking_action = (
                TorchUtils.where_from_index(
                    env_index, 0.0, self.ball.kicking_action
                )
                if env_index is not None
                else torch.zeros(
                    (self.world.batch_dim, 2), device=self.world.device
                )
            )

    # ------------------------------------------------------------------ #
    # Field
    # ------------------------------------------------------------------ #
    def render_field(self, render: bool):
        self._render_field = render

    def init_walls(self, world):
        wall_length = (
            self.pitch_width / 2 - self.agent_size - self.goal_size / 2
        )
        self._walls = []
        for name in (
            "Right Top Wall",
            "Left Top Wall",
            "Right Bottom Wall",
            "Left Bottom Wall",
        ):
            wall = Landmark(
                name=name,
                collide=True,
                movable=False,
                shape=Line(length=wall_length),
                color=Color.WHITE,
            )
            world.add_landmark(wall)
            self._walls.append(wall)

    def _landmark_layout(self) -> Dict[str, tuple]:
        """Each wall's, goal line's and net's (position, rotation or
        None)."""
        half_l = self.pitch_length / 2
        wall_y = self.pitch_width / 4 + self.goal_size / 4
        return {
            "Left Top Wall": ((-half_l, wall_y), np.pi / 2),
            "Left Bottom Wall": ((-half_l, -wall_y), np.pi / 2),
            "Right Top Wall": ((half_l, wall_y), np.pi / 2),
            "Right Bottom Wall": ((half_l, -wall_y), np.pi / 2),
            "Left Goal Back": (
                (-half_l - self.goal_depth + self.agent_size, 0.0),
                np.pi / 2,
            ),
            "Right Goal Back": (
                (half_l + self.goal_depth - self.agent_size, 0.0),
                np.pi / 2,
            ),
            "Left Goal Top": (
                (-half_l - self.goal_depth / 2 + self.agent_size,
                 self.goal_size / 2),
                None,
            ),
            "Left Goal Bottom": (
                (-half_l - self.goal_depth / 2 + self.agent_size,
                 -self.goal_size / 2),
                None,
            ),
            "Right Goal Top": (
                (half_l + self.goal_depth / 2 - self.agent_size,
                 self.goal_size / 2),
                None,
            ),
            "Right Goal Bottom": (
                (half_l + self.goal_depth / 2 - self.agent_size,
                 -self.goal_size / 2),
                None,
            ),
            "Red Net": (
                (half_l + self.goal_depth / 2 - self.agent_size / 2, 0.0),
                None,
            ),
            "Blue Net": (
                (-half_l - self.goal_depth / 2 + self.agent_size / 2, 0.0),
                None,
            ),
        }

    def _place(self, landmarks, env_index):
        for lm in landmarks:
            pos, rot = self._landmark_poses[lm.name]
            lm.set_pos(pos, batch_index=env_index)
            if rot is not None:
                lm.set_rot(rot, batch_index=env_index)

    def reset_walls(self, env_index=None):
        self._place(self._walls, env_index)

    def init_goals(self, world):
        self._goal_landmarks = []
        for name, length in (
            ("Right Goal Back", self.goal_size),
            ("Left Goal Back", self.goal_size),
            ("Right Goal Top", self.goal_depth),
            ("Left Goal Top", self.goal_depth),
            ("Right Goal Bottom", self.goal_depth),
            ("Left Goal Bottom", self.goal_depth),
        ):
            lm = Landmark(
                name=name,
                collide=True,
                movable=False,
                shape=Line(length=length),
                color=Color.WHITE,
            )
            world.add_landmark(lm)
            self._goal_landmarks.append(lm)
        blue_net = Landmark(
            name="Blue Net",
            collide=False,
            movable=False,
            shape=Box(length=self.goal_depth, width=self.goal_size),
            color=(0.5, 0.5, 0.5),
        )
        world.add_landmark(blue_net)
        red_net = Landmark(
            name="Red Net",
            collide=False,
            movable=False,
            shape=Box(length=self.goal_depth, width=self.goal_size),
            color=(0.5, 0.5, 0.5),
        )
        world.add_landmark(red_net)
        self.blue_net = blue_net
        self.red_net = red_net
        world.blue_net = blue_net
        world.red_net = red_net

    def reset_goals(self, env_index=None):
        self._place(self._goal_landmarks + [self.blue_net, self.red_net],
                    env_index)

    def init_traj_pts(self, world):
        world.traj_points = {"Red": {}, "Blue": {}}
        for team, on, agents in (("Red", self.ai_red_agents, world.red_agents),
                                 ("Blue", self.ai_blue_agents,
                                  world.blue_agents)):
            if not on:
                continue
            for i, agent in enumerate(agents):
                world.traj_points[team][agent.name] = []
                for j in range(self.n_traj_points):
                    pointj = Landmark(
                        name=f"{team} {i} Trajectory {j}",
                        collide=False,
                        movable=False,
                        shape=Sphere(radius=0.01),
                        color=Color.GRAY,
                    )
                    world.add_landmark(pointj)
                    world.traj_points[team][agent.name].append(pointj)

    # ------------------------------------------------------------------ #
    # Step hooks
    # ------------------------------------------------------------------ #
    def process_action(self, agent):
        if agent is self.ball:
            return
        blue = agent in self.blue_agents
        if agent.action_script is None and not blue:
            # Red agents have the X action (and rotation) flipped.
            u = agent.action.u
            flip = [-u[..., X:X + 1], u[..., X + 1:X + 2]]
            if self.enable_shooting:
                flip += [-u[..., 2:3], u[..., 3:]]
            else:
                flip += [u[..., 2:]]
            agent.action.u = torch.cat(flip, dim=-1)

        if self.enable_shooting and agent.action_script is None:
            agents_exclude_ball = [
                a for a in self.world.agents if a is not self.ball
            ]
            if self._agents_rel_pos_to_ball is None:
                self._agents_rel_pos_to_ball = torch.stack(
                    [
                        self.ball.state.pos - a.state.pos
                        for a in agents_exclude_ball
                    ],
                    dim=1,
                )
                self._agent_dist_to_ball = torch.linalg.norm(
                    self._agents_rel_pos_to_ball, dim=-1
                )
                self._agents_closest_to_ball = self._agent_dist_to_ball == (
                    torch.amin(self._agent_dist_to_ball, dim=-1, keepdim=True)
                )
            agent_index = agents_exclude_ball.index(agent)
            rel_pos = self._agents_rel_pos_to_ball[:, agent_index]
            agent.ball_within_range = (
                self._agent_dist_to_ball[:, agent_index]
                <= self.shooting_radius
            )
            rel_pos_angle = torch.atan2(rel_pos[:, Y], rel_pos[:, X])
            a = torch.remainder(
                agent.state.rot.squeeze(-1) - rel_pos_angle + np.pi,
                2 * np.pi,
            ) - np.pi
            agent.ball_within_angle = (-self.shooting_angle / 2 <= a) & (
                a <= self.shooting_angle / 2
            )
            shoot_x = agent.action.u[..., -1] * 2.67 * self.u_shoot_multiplier
            shoot_force = torch.stack(
                [shoot_x, torch.zeros_like(shoot_x)], dim=-1
            )
            shoot_force = TorchUtils.rotate_vector(
                shoot_force, agent.state.rot
            )
            agent.shoot_force = shoot_force
            shoot_force = torch.where(
                (
                    agent.ball_within_angle
                    & agent.ball_within_range
                    & self._agents_closest_to_ball[:, agent_index]
                )[:, None],
                shoot_force,
                torch.zeros_like(shoot_force),
            )
            self.ball.kicking_action = (
                self.ball.kicking_action + shoot_force
            )
            agent.action.u = agent.action.u[:, :-1]

    def pre_step(self):
        if self.enable_shooting:
            self._agents_rel_pos_to_ball = None
            self.ball.action.u = self.ball.action.u + self.ball.kicking_action
            self.ball.kicking_action = torch.zeros_like(
                self.ball.kicking_action
            )

    _agents_rel_pos_to_ball = None

    # ------------------------------------------------------------------ #
    # Reward
    # ------------------------------------------------------------------ #
    def reward(self, agent):
        if agent is None or agent is self.world.agents[0]:
            ball_pos = self.ball.state.pos
            over_right_line = (
                ball_pos[:, X] > self.pitch_length / 2 + self.ball_size / 2
            )
            over_left_line = (
                ball_pos[:, X] < -self.pitch_length / 2 - self.ball_size / 2
            )
            goal_mask = (ball_pos[:, Y] <= self.goal_size / 2) & (
                ball_pos[:, Y] >= -self.goal_size / 2
            )
            blue_score = over_right_line & goal_mask
            red_score = over_left_line & goal_mask
            self.sparse_reward_blue = (
                self.scoring_reward * blue_score
                - self.scoring_reward * red_score
            )
            self.sparse_reward_red = -self.sparse_reward_blue
            self.terminated = blue_score | red_score

            self._dense_reward_blue = 0
            self._dense_reward_red = 0
            if self.dense_reward and agent is not None:
                if not self.ai_blue_agents:
                    self._dense_reward_blue = self.reward_ball_to_goal(
                        blue=True
                    ) + self.reward_all_agent_to_ball(blue=True)
                if not self.ai_red_agents:
                    self._dense_reward_red = self.reward_ball_to_goal(
                        blue=False
                    ) + self.reward_all_agent_to_ball(blue=False)

        blue = agent in self.blue_agents if agent is not None else True
        if blue:
            return self.sparse_reward_blue + self._dense_reward_blue
        return self.sparse_reward_red + self._dense_reward_red

    def reward_ball_to_goal(self, blue: bool):
        goal_pos = self.right_goal_pos if blue else self.left_goal_pos
        distance_to_goal = torch.linalg.norm(
            self.ball.state.pos - goal_pos[None], dim=-1
        )
        pos_shaping = distance_to_goal * self.pos_shaping_factor_ball_goal
        if blue:
            self.ball.pos_rew_blue = self.ball.pos_shaping_blue - pos_shaping
            self.ball.pos_shaping_blue = pos_shaping
            return self.ball.pos_rew_blue
        self.ball.pos_rew_red = self.ball.pos_shaping_red - pos_shaping
        self.ball.pos_shaping_red = pos_shaping
        return self.ball.pos_rew_red

    def reward_all_agent_to_ball(self, blue: bool):
        min_dist_to_ball = self.get_closest_agent_to_ball(
            team=self.blue_agents if blue else self.red_agents
        )
        if blue:
            self.min_agent_dist_to_ball_blue = min_dist_to_ball
        else:
            self.min_agent_dist_to_ball_red = min_dist_to_ball
        pos_shaping = min_dist_to_ball * self.pos_shaping_factor_agent_ball
        ball_moving = torch.linalg.norm(self.ball.state.vel, dim=-1) > 1e-6
        agent_close_to_goal = min_dist_to_ball < self.distance_to_ball_trigger
        gate = agent_close_to_goal | ball_moving
        zero = torch.zeros_like(pos_shaping)
        if blue:
            self.ball.pos_rew_agent_blue = torch.where(
                gate, zero, self.ball.pos_shaping_agent_blue - pos_shaping
            )
            self.ball.pos_shaping_agent_blue = pos_shaping
            return self.ball.pos_rew_agent_blue
        self.ball.pos_rew_agent_red = torch.where(
            gate, zero, self.ball.pos_shaping_agent_red - pos_shaping
        )
        self.ball.pos_shaping_agent_red = pos_shaping
        return self.ball.pos_rew_agent_red

    # ------------------------------------------------------------------ #
    # Observation
    # ------------------------------------------------------------------ #
    def observation(self, agent):
        blue = agent in self.blue_agents
        if not blue:
            my_team, other_team = self.red_agents, self.blue_agents
            goal_pos = self.left_goal_pos
        else:
            my_team, other_team = self.blue_agents, self.red_agents
            goal_pos = self.right_goal_pos

        adversary_poses, adversary_forces, adversary_vels = [], [], []
        if self.observe_adversaries:
            for a in other_team:
                adversary_poses.append(a.state.pos)
                adversary_vels.append(a.state.vel)
                adversary_forces.append(a.state.force)
        teammate_poses, teammate_forces, teammate_vels = [], [], []
        if self.observe_teammates:
            for a in my_team:
                if a is not agent:
                    teammate_poses.append(a.state.pos)
                    teammate_vels.append(a.state.vel)
                    teammate_forces.append(a.state.force)

        return self.observation_base(
            agent.state.pos,
            agent.state.rot,
            agent.state.vel,
            agent.state.force,
            goal_pos=goal_pos,
            ball_pos=self.ball.state.pos,
            ball_vel=self.ball.state.vel,
            ball_force=self.ball.state.force,
            adversary_poses=adversary_poses,
            adversary_forces=adversary_forces,
            adversary_vels=adversary_vels,
            teammate_poses=teammate_poses,
            teammate_forces=teammate_forces,
            teammate_vels=teammate_vels,
            blue=blue,
        )

    def observation_base(
        self,
        agent_pos,
        agent_rot,
        agent_vel,
        agent_force,
        teammate_poses,
        teammate_forces,
        teammate_vels,
        adversary_poses,
        adversary_forces,
        adversary_vels,
        ball_pos,
        ball_vel,
        ball_force,
        goal_pos,
        blue: bool,
    ):
        goal_pos = goal_pos[None].expand(agent_pos.shape)

        def flip(t):
            return torch.cat([-t[..., X:X + 1], t[..., X + 1:]], dim=-1)

        if not blue:
            agent_pos = flip(agent_pos)
            agent_vel = flip(agent_vel)
            agent_force = flip(agent_force)
            ball_pos = flip(ball_pos)
            ball_vel = flip(ball_vel)
            ball_force = flip(ball_force)
            goal_pos = flip(goal_pos)
            teammate_poses = [flip(t) for t in teammate_poses]
            teammate_forces = [flip(t) for t in teammate_forces]
            teammate_vels = [flip(t) for t in teammate_vels]
            adversary_poses = [flip(t) for t in adversary_poses]
            adversary_forces = [flip(t) for t in adversary_forces]
            adversary_vels = [flip(t) for t in adversary_vels]
            agent_rot = agent_rot - np.pi

        obs = {
            "obs": [
                agent_force,
                agent_pos - ball_pos,
                agent_vel - ball_vel,
                ball_pos - goal_pos,
                ball_vel,
                ball_force,
            ],
            "pos": [agent_pos - goal_pos],
            "vel": [agent_vel],
        }
        if self.enable_shooting:
            obs["obs"].append(agent_rot)

        for key, poses, forces, vels, on in (
            ("adversaries", adversary_poses, adversary_forces,
             adversary_vels, self.observe_adversaries),
            ("teammates", teammate_poses, teammate_forces, teammate_vels,
             self.observe_teammates),
        ):
            if not (on and len(poses)):
                continue
            rows = [
                torch.cat(
                    [agent_pos - o_pos, agent_vel - o_vel, o_vel, o_force],
                    dim=-1,
                )
                for o_pos, o_force, o_vel in zip(poses, forces, vels)
            ]
            obs[key] = [
                torch.stack(rows, dim=-2)
                if self.dict_obs
                else torch.cat(rows, dim=-1)
            ]

        for key, value in obs.items():
            obs[key] = torch.cat(value, dim=-1)
        if self.dict_obs:
            return obs
        return torch.cat(list(obs.values()), dim=-1)

    def done(self):
        if self.ai_blue_agents and self.ai_red_agents:
            self.reward(None)
        return self.terminated

    def _compute_coverage(self, blue: bool):
        team = self.blue_agents if blue else self.red_agents
        pos = torch.stack([a.state.pos for a in team], dim=-2)
        avg_point = torch.mean(pos, dim=-2, keepdim=True)
        dist = torch.linalg.norm(pos - avg_point, dim=-1)
        return torch.amax(dist, dim=-1)

    def info(self, agent):
        blue = agent in self.blue_agents
        info = {
            "sparse_reward": self.sparse_reward_blue
            if blue
            else self.sparse_reward_red,
            "ball_goal_pos_rew": self.ball.pos_rew_blue
            if blue
            else self.ball.pos_rew_red,
            "all_agent_ball_pos_rew": self.ball.pos_rew_agent_blue
            if blue
            else self.ball.pos_rew_agent_red,
            "ball_pos": self.ball.state.pos,
            "dist_ball_to_goal": (
                self.ball.pos_shaping_blue
                if blue
                else self.ball.pos_shaping_red
            )
            / self.pos_shaping_factor_ball_goal,
        }
        if blue and not self.ai_blue_agents:
            info["min_agent_dist_to_ball"] = self.min_agent_dist_to_ball_blue
            info["touching_ball"] = (
                self.min_agent_dist_to_ball_blue
                <= self.agent_size + self.ball_size + 1e-2
            )
        elif not blue and not self.ai_red_agents:
            info["min_agent_dist_to_ball"] = self.min_agent_dist_to_ball_red
            info["touching_ball"] = (
                self.min_agent_dist_to_ball_red
                <= self.agent_size + self.ball_size + 1e-2
            )
        return info

    def _background_geoms(self):
        """The pitch's geoms (reference football.py:1486-1526), built at the
        first frame and kept: they do not move."""
        from vectorizedmultiagentsimulator_tpu_torch import render as rendering

        if self._background is not None:
            return self._background
        w, length, a = self.pitch_width, self.pitch_length, self.agent_size
        specs = [
            ("box", (length, w), Color.GREEN, (0.0, 0.0), 0.0),
            ("circle", self.goal_size / 2, Color.WHITE, (0.0, 0.0), 0.0),
            ("circle", self.goal_size / 2 - 0.02, Color.GREEN, (0.0, 0.0),
             0.0),
            ("line", w - 2 * a, Color.WHITE, (0.0, 0.0), np.pi / 2),
            ("line", w - 2 * a, Color.WHITE, (length / 2 - a, 0.0),
             np.pi / 2),
            ("line", w - 2 * a, Color.WHITE, (-length / 2 + a, 0.0),
             np.pi / 2),
            ("line", length - 2 * a, Color.WHITE, (0.0, w / 2 - a), 0.0),
            ("line", length - 2 * a, Color.WHITE, (0.0, -w / 2 + a), 0.0),
        ]
        self._background = []
        for kind, size, color, pos, rot in specs:
            if kind == "box":
                box_length, box_width = size
                g = rendering.make_polygon(
                    [
                        (-box_length / 2, -box_width / 2),
                        (-box_length / 2, box_width / 2),
                        (box_length / 2, box_width / 2),
                        (box_length / 2, -box_width / 2),
                    ]
                )
            elif kind == "circle":
                g = rendering.make_circle(size)
            else:
                g = rendering.make_line(size)
            xform = rendering.Transform()
            g.add_attr(xform)
            xform.set_translation(*pos)
            xform.set_rotation(rot)
            g.set_color(*color.value)
            self._background.append(g)
        return self._background

    def extra_render(self, env_index: int = 0):
        from vectorizedmultiagentsimulator_tpu_torch import render as rendering

        background = self._background_geoms()
        geoms = list(background if self._render_field else background[3:])

        # Blue-agent index labels (reference football.py:1528-1531).
        geoms += ScenarioUtils.render_agent_indices(
            self,
            env_index,
            start_from=1,
            exclude=self.red_agents + [self.ball],
        )

        # Shooting cone + kick-intensity bar (reference football.py:1533-1568).
        if self.enable_shooting:
            for agent in self.blue_agents:
                color = agent.color
                within = bool(
                    np.asarray(agent.ball_within_angle)[env_index]
                ) and bool(np.asarray(agent.ball_within_range)[env_index])
                sector_color = Color.PINK.value if within else color
                pos = tuple(np.asarray(agent.state.pos)[env_index])
                rot = float(np.asarray(agent.state.rot)[env_index, 0])

                sector = rendering.make_circle(
                    radius=self.shooting_radius,
                    angle=self.shooting_angle,
                    filled=True,
                )
                xform = rendering.Transform()
                xform.set_rotation(rot)
                xform.set_translation(*pos)
                sector.add_attr(xform)
                sector.set_color(*sector_color[:3], alpha=0.5 / 2)
                geoms.append(sector)

                shoot_intensity = float(
                    np.linalg.norm(np.asarray(agent.shoot_force)[env_index])
                ) / (self.u_shoot_multiplier * 2)
                l, r, t, b = (
                    0,
                    self.shooting_radius * shoot_intensity,
                    self.agent_size / 2,
                    -self.agent_size / 2,
                )
                bar = rendering.make_polygon([(l, b), (l, t), (r, t), (r, b)])
                xform = rendering.Transform()
                xform.set_rotation(rot)
                xform.set_translation(*pos)
                bar.add_attr(xform)
                bar.set_color(*color[:3], alpha=0.5)
                geoms.append(bar)

        return geoms


# ---------------------------------------------------------------------- #
# Ball physics script (football.py:1620-1683)
# ---------------------------------------------------------------------- #
def ball_action_script(ball, world):
    dist_thres = world.agent_size * 2
    vel_thres = 0.3
    impulse = 0.05
    pos, vel = ball.state.pos, ball.state.vel
    upper = (
        1
        - torch.clamp_max(world.pitch_width / 2 - pos[:, 1], dist_thres)
        / dist_thres
    )
    lower = (
        1
        - torch.clamp_max(world.pitch_width / 2 + pos[:, 1], dist_thres)
        / dist_thres
    )
    right = (
        1
        - torch.clamp_max(world.pitch_length / 2 - pos[:, 0], dist_thres)
        / dist_thres
    )
    left = (
        1
        - torch.clamp_max(world.pitch_length / 2 + pos[:, 0], dist_thres)
        / dist_thres
    )
    vertical_vel = (
        1 - torch.clamp_max(torch.abs(vel[:, 1]), vel_thres) / vel_thres
    )
    horizontal_vel = vertical_vel
    dist_action = torch.stack([left - right, lower - upper], dim=1)
    vel_action = torch.stack([horizontal_vel, vertical_vel], dim=1)
    actions = dist_action * vel_action * impulse
    goal_mask = (pos[:, 1] < world.goal_size / 2) & (
        pos[:, 1] > -world.goal_size / 2
    )
    actions = torch.stack(
        [torch.where(goal_mask, torch.zeros_like(actions[:, 0]),
                     actions[:, 0]),
         actions[:, 1]],
        dim=1,
    )
    ball.action.u = actions


# ---------------------------------------------------------------------- #
# Scripted team AI (football.py:1686-2291)
# ---------------------------------------------------------------------- #
class AgentPolicy:
    def __init__(
        self,
        team: str,
        speed_strength=1.0,
        decision_strength=1.0,
        precision_strength=1.0,
        disabled: bool = False,
    ):
        self.team_name = team
        self.otherteam_name = "Blue" if (team == "Red") else "Red"
        self.speed_strength = speed_strength**2
        self.decision_strength = decision_strength
        self.precision_strength = precision_strength
        self.strength_multiplier = 25.0
        self.pos_lookahead = 0.01
        self.vel_lookahead = 0.01
        self.possession_lookahead = 0.5
        self.dribble_speed = 0.16 + 0.16 * speed_strength
        self.shooting_radius = 0.08
        self.shooting_angle = np.pi / 2
        self.take_shot_angle = np.pi / 4
        self.max_shot_dist = 0.5
        self.nsamples = 2
        self.sigma = 0.5
        self.replan_margin = 0.0
        self.initialised = False
        self.disabled = disabled
        self._team_disps = {}

    _FIELDS = (
        ("shot_power", 1),
        ("target_ang", 1),
        ("target_pos_rel", 2),
        ("target_pos", 2),
        ("target_vel", 2),
        ("start_pos", 2),
        ("start_vel", 2),
    )

    def init(self, world):
        self.initialised = True
        self.world = world
        self.ball = world.ball
        if self.team_name == "Red":
            self.teammates = world.red_agents
            self.opposition = world.blue_agents
            self.own_net = world.red_net
            self.target_net = world.blue_net
        else:
            self.teammates = world.blue_agents
            self.opposition = world.red_agents
            self.own_net = world.blue_net
            self.target_net = world.red_net
        self.enable_shooting = (
            self.teammates[0].action_size == 4 if self.teammates else False
        )
        B, dev = world.batch_dim, world.device
        for agent in self.teammates:
            for field, width in self._FIELDS:
                shape = (B,) if width == 1 else (B, width)
                world.set_extra(
                    self._k(agent, field), torch.zeros(shape, device=dev)
                )
            world.set_extra(
                self._k(agent, "possession"),
                torch.zeros((B,), dtype=torch.bool, device=dev),
            )
        world.set_extra(
            f"ai_{self.team_name}.team_possession",
            torch.zeros((B,), dtype=torch.bool, device=dev),
        )
        # Static per-teammate dribble offsets, fp32 (ball radius + agent
        # radius) * 0.7 as the JAX package computes them every step: made
        # once, so a step copies nothing from the host.
        radius = torch.tensor(
            [a.shape.radius for a in self.teammates], dtype=torch.float32,
            device=dev,
        )
        self._hit_offset = (self.ball.shape.radius + radius) * 0.7  # [T]

    # -- extras plumbing -- #
    def _k(self, agent, field):
        return f"ai_{self.team_name}.{agent.name}.{field}"

    def _get(self, agent, field):
        return self.world.get_extra(self._k(agent, field))

    def _set(self, agent, field, value, mask=None):
        cur = self._get(agent, field)
        if isinstance(value, Tensor):
            value = value.to(cur.dtype).expand(cur.shape)
        else:
            value = torch.full_like(cur, value)
        if mask is not None:
            m = mask.reshape(mask.shape + (1,) * (cur.ndim - 1))
            value = torch.where(m, value, cur)
        self.world.set_extra(self._k(agent, field), value)

    @property
    def team_possession(self):
        return self.world.get_extra(f"ai_{self.team_name}.team_possession")

    def agent_possession(self, agent):
        return self._get(agent, "possession")

    def reset(self, env_index=None):
        self._team_disps = {}
        mask = None
        if env_index is not None:
            mask = env_index_to_mask(
                env_index, self.world.batch_dim, self.world.device
            )
        for agent in self.teammates:
            for field, _ in self._FIELDS:
                self._set(agent, field, 0.0, mask)

    # -- policies -- #
    def dribble_policy(self, agent):
        possession_mask = self.agent_possession(agent)
        self.dribble_to_goal(agent, mask=possession_mask)
        move_mask = ~possession_mask
        best_pos = self.check_better_positions(agent)
        self.go_to(agent, pos=best_pos, aggression=1.0, mask=move_mask)

    def passing_policy(self, agent):
        possession_mask = self.agent_possession(agent)
        otheragent = next(a for a in self.teammates if a is not agent)
        self.shoot(agent, otheragent.state.pos, mask=possession_mask)
        move_mask = ~possession_mask
        best_pos = self.check_better_positions(agent)
        self.go_to(agent, pos=best_pos, aggression=1.0, mask=move_mask)

    def disable(self):
        self.disabled = True

    def enable(self):
        self.disabled = False

    def run(self, agent, world):
        if not self.disabled:
            if "0" in agent.name:
                self._team_disps = {}
                self.check_possession()
                # One stacked [B, T, 2] dribble-policy pass for the whole
                # team; the per-agent calls below take their column.
                self._controls_all = self._compute_controls_all()
            i = self.teammates.index(agent)
            control = self._controls_all[:, i]
            control = torch.clamp(control, -agent.u_range, agent.u_range)
            agent.action.u = control * agent.action.u_multiplier_tensor[None]
        else:
            agent.action.u = torch.zeros(
                (self.world.batch_dim, agent.action_size),
                device=self.world.device,
            )

    # -- team-stacked dribble policy (the hot path) -- #

    def _stack_extra(self, field):
        return torch.stack(
            [self._get(a, field) for a in self.teammates], dim=1
        )

    def _compute_controls_all(self):
        """Stacked ``dribble_policy`` + ``get_action`` for every teammate:
        [B, T, 2] controls in one pass.  Same math as the per-agent
        methods (kept below for the ``passing_policy`` API); the masked
        sequential extras writes of dribble_to_goal -> go_to become one
        possession-``where`` select."""
        agents_pos = torch.stack(
            [a.state.pos for a in self.teammates], dim=1
        )  # [B, T, 2]
        agents_vel = torch.stack(
            [a.state.vel for a in self.teammates], dim=1
        )
        possession = self._stack_extra("possession")  # [B, T] bool
        ball_pos = self.ball.state.pos  # [B, 2]

        # dribble-to-goal branch (possession)
        d_pos, d_vel, d_start_vel = self._update_dribble_all(
            agents_pos, self.target_net.state.pos[:, None]
        )

        # reposition branch (~possession).  curr_target replicates the
        # read-after-masked-write of the sequential form: envs in
        # possession see the fresh dribble target, others last step's.
        prev_rel = self._stack_extra("target_pos_rel")  # [B, T, 2]
        pmask = possession[..., None]
        curr_target = torch.where(pmask, d_pos, prev_rel + ball_pos[:, None])
        best_pos = self._check_better_positions_all(agents_pos, curr_target)
        aggression = (
            TorchUtils.safe_norm(best_pos - agents_pos, dim=-1) > 0.1
        ).to(torch.float32)
        m_start_vel = self.get_start_vel(
            best_pos, torch.zeros_like(best_pos), agents_pos, aggression
        )

        target_pos = torch.where(pmask, d_pos, best_pos)
        target_vel = torch.where(pmask, d_vel, torch.zeros_like(d_vel))
        start_vel = torch.where(pmask, d_start_vel, m_start_vel)
        start_pos = agents_pos

        if self.precision_strength != 1:
            # One batched draw, applied to the selected target (only the
            # selected branch's noise survives the sequential form's mask).
            prev_target = self._stack_extra("target_pos")
            diff = torch.linalg.norm(
                prev_target - target_pos, dim=-1, keepdim=True
            )
            exp_diff = torch.exp(-diff)
            scale = 10 * (1 - self.precision_strength) * (1 - exp_diff)
            g = self.world.generator
            target_pos = target_pos + torch.randn(
                target_pos.shape, generator=g, device=target_pos.device
            ) * scale
            target_vel = target_vel + torch.randn(
                target_vel.shape, generator=g, device=target_vel.device
            ) * scale

        target_pos_rel = target_pos - ball_pos[:, None]
        for i, a in enumerate(self.teammates):
            self._set(a, "target_pos_rel", target_pos_rel[:, i])
            self._set(a, "target_pos", target_pos[:, i])
            self._set(a, "target_vel", target_vel[:, i])
            self._set(a, "start_pos", start_pos[:, i])
            self._set(a, "start_vel", start_vel[:, i])
            self.plot_traj(a)

        des_curr_pos = Splines.hermite(
            start_pos, target_pos, start_vel, target_vel,
            u=min(self.pos_lookahead, 1), deriv=0,
        )
        des_curr_vel = Splines.hermite(
            start_pos, target_pos, start_vel, target_vel,
            u=min(self.vel_lookahead, 1), deriv=1,
        )
        control = 0.5 * (des_curr_pos - agents_pos) + 0.5 * (
            des_curr_vel - agents_vel
        )
        return control * (self.speed_strength * self.strength_multiplier)

    def _update_dribble_all(self, agents_pos, pos):
        """Stacked ``update_dribble``: targets for every teammate hitting
        the ball toward ``pos`` [B, 1, 2] -> (hit_pos [B, T, 2], hit_vel,
        start_vel)."""
        ball_pos = self.ball.state.pos[:, None]  # [B, 1, 2]
        ball_disp = pos - ball_pos
        ball_dist = torch.linalg.norm(ball_disp, dim=-1)
        direction = ball_disp / torch.clamp_min(ball_dist, 1e-12)[..., None]
        hit_vel = direction * self.dribble_speed  # [B, 1, 2]
        start_vel = self.get_start_vel(
            ball_pos, hit_vel, agents_pos, aggression=0.0
        )  # [B, T, 2]
        start_vel_mag = torch.linalg.norm(start_vel, dim=-1)
        offset = torch.where(
            (start_vel_mag > 0)[..., None],
            start_vel / torch.clamp_min(start_vel_mag, 1e-12)[..., None],
            start_vel,
        )
        new_direction = direction + 0.5 * offset  # [B, T, 2]
        new_direction = (
            new_direction
            / torch.clamp_min(
                torch.linalg.norm(new_direction, dim=-1), 1e-12
            )[..., None]
        )
        hit_pos = ball_pos - new_direction * self._hit_offset[None, :, None]
        hit_vel = hit_vel.expand(hit_pos.shape)
        return hit_pos, hit_vel, start_vel

    def planner_normals(self, B: int, T: int) -> Tensor:
        """The planner's one random draw a step: standard normal ``[B, T,
        nsamples, 2]`` from the world's generator, scaled by the caller.
        Tests feed two envs the same samples by replacing it."""
        return torch.randn(
            (B, T, self.nsamples, self.world.dim_p),
            generator=self.world.generator,
            device=self.world.device,
        )

    def _check_better_positions_all(self, agents_pos, curr_target):
        """Stacked ``check_better_positions`` + ``get_pos_value``
        (reference football.py:1871-1915): [B, T, 2] best candidate
        positions with one sample draw for the whole team.

        The sample scaling, the candidate build, the 5-term value and the
        first-max fold run in the hand-written CUDA kernel of
        ``ops/football_policy_cuda.py`` on the card, and in its plain
        version on the CPU; both take the same unscaled draws, and the
        ball's and nets' positions as the columns of the world's state."""
        B, T = agents_pos.shape[:2]
        normals = self.planner_normals(B, T)
        # a cheap static build from the current attributes, so a later
        # change to decision_strength, nsamples or the pitch is never stale
        params = football_policy_cuda.planner_params(self)
        value_noise = None
        if params.has_noise:
            # Samples first, then the value noise, as the JAX package draws.
            value_noise = torch.randn(
                (B, T, self.nsamples + 1),
                generator=self.world.generator,
                device=self.world.device,
            )
        return football_policy_cuda.fused_best_positions(
            params,
            agents_pos,
            curr_target,
            normals,
            self.ball.state.pos,
            self.target_net.state.pos,
            self.own_net.state.pos,
            value_noise,
        )

    def dribble_to_goal(self, agent, mask=None):
        self.dribble(agent, self.target_net.state.pos, mask=mask)

    def dribble(self, agent, pos, mask=None):
        self.update_dribble(agent, pos=pos, mask=mask)

    def update_dribble(self, agent, pos, mask=None):
        agent_pos = agent.state.pos
        ball_pos = self.ball.state.pos
        ball_disp = pos - ball_pos
        ball_dist = torch.linalg.norm(ball_disp, dim=-1)
        direction = ball_disp / torch.clamp_min(ball_dist, 1e-12)[:, None]
        hit_vel = direction * self.dribble_speed
        start_vel = self.get_start_vel(
            ball_pos, hit_vel, agent_pos, aggression=0.0
        )
        start_vel_mag = torch.linalg.norm(start_vel, dim=-1)
        offset = torch.where(
            (start_vel_mag > 0)[:, None],
            start_vel / torch.clamp_min(start_vel_mag, 1e-12)[:, None],
            start_vel,
        )
        new_direction = direction + 0.5 * offset
        new_direction = (
            new_direction
            / torch.clamp_min(
                torch.linalg.norm(new_direction, dim=-1), 1e-12
            )[:, None]
        )
        hit_pos = (
            ball_pos
            - new_direction
            * (self.ball.shape.radius + agent.shape.radius)
            * 0.7
        )
        self.go_to(
            agent, hit_pos, hit_vel, start_vel=start_vel, mask=mask
        )

    def shoot(self, agent, pos, mask=None):
        agent_pos = agent.state.pos
        ball_disp = self.ball.state.pos - agent_pos
        ball_dist = torch.linalg.norm(ball_disp, dim=-1)
        within_range_mask = ball_dist <= self.shooting_radius
        target_disp = pos - agent_pos
        target_dist = torch.linalg.norm(target_disp, dim=-1)
        ball_rel_angle = self.get_rel_ang(
            ang1=agent.state.rot, vec2=ball_disp
        )
        target_rel_angle = self.get_rel_ang(
            ang1=agent.state.rot, vec2=target_disp
        )
        ball_within_angle_mask = (
            torch.abs(ball_rel_angle) < self.shooting_angle / 2
        )
        rot_within_angle_mask = (
            torch.abs(target_rel_angle) < self.take_shot_angle / 2
        )
        shooting_mask = (
            within_range_mask & ball_within_angle_mask & rot_within_angle_mask
        )
        self._set(
            agent,
            "target_ang",
            torch.atan2(target_disp[:, 1], target_disp[:, 0]),
            mask,
        )
        self.dribble(agent, pos, mask=mask)
        if mask is not None:
            shooting_mask = shooting_mask & mask
        shot_power = torch.where(
            shooting_mask,
            torch.clamp_max(target_dist / self.max_shot_dist, 1.0),
            torch.full_like(target_dist, -1.0),
        )
        self._set(agent, "shot_power", shot_power)

    def go_to(self, agent, pos, vel=None, start_vel=None, aggression=1.0,
              mask=None):
        start_pos = agent.state.pos
        if vel is None:
            vel = torch.zeros_like(pos)
        if start_vel is None:
            aggression = (
                torch.linalg.norm(pos - start_pos, dim=-1) > 0.1
            ).to(torch.float32) * aggression
            start_vel = self.get_start_vel(
                pos, vel, start_pos, aggression=aggression
            )
        if self.precision_strength != 1:
            diff = torch.linalg.norm(
                self._get(agent, "target_pos") - pos, dim=-1
            )[:, None]
            exp_diff = torch.exp(-diff)
            g = self.world.generator
            pos = pos + (
                torch.randn(pos.shape, generator=g, device=pos.device)
                * 10
                * (1 - self.precision_strength)
                * (1 - exp_diff)
            )
            vel = vel + (
                torch.randn(vel.shape, generator=g, device=vel.device)
                * 10
                * (1 - self.precision_strength)
                * (1 - exp_diff)
            )
        self._set(
            agent, "target_pos_rel", pos - self.ball.state.pos, mask
        )
        self._set(agent, "target_pos", pos, mask)
        self._set(agent, "target_vel", vel, mask)
        self._set(agent, "start_pos", start_pos, mask)
        self._set(agent, "start_vel", start_vel, mask)
        self.plot_traj(agent)

    def get_start_vel(self, pos, vel, start_pos, aggression=0.0):
        """Works on ``[B, 2]`` and stacked ``[B, T, 2]`` inputs (with
        broadcasting between them); ``aggression`` is a Python number or a
        tensor matching the leading axes."""
        vel_mag = 1.0 * aggression + torch.linalg.norm(vel, dim=-1) * (
            1 - aggression
        )
        goal_disp = pos - start_pos
        goal_dist = torch.linalg.norm(goal_disp, dim=-1)
        vel_dir = torch.where(
            (vel_mag > 0)[..., None],
            vel / torch.clamp_min(vel_mag, 1e-12)[..., None],
            vel,
        )
        dist_behind_target = 0.6 * goal_dist
        target_pos = pos - vel_dir * dist_behind_target[..., None]
        target_disp = target_pos - start_pos
        target_dist = torch.linalg.norm(target_disp, dim=-1)
        start_vel_aug_dir = torch.where(
            (target_dist > 0)[..., None],
            target_disp / torch.clamp_min(target_dist, 1e-12)[..., None],
            target_disp,
        )
        return start_vel_aug_dir * vel_mag[..., None]

    def get_action(self, agent):
        curr_pos = agent.state.pos
        curr_vel = agent.state.vel
        start_pos = self._get(agent, "start_pos")
        target_pos = self._get(agent, "target_pos")
        start_vel = self._get(agent, "start_vel")
        target_vel = self._get(agent, "target_vel")
        des_curr_pos = Splines.hermite(
            start_pos, target_pos, start_vel, target_vel,
            u=min(self.pos_lookahead, 1), deriv=0,
        )
        des_curr_vel = Splines.hermite(
            start_pos, target_pos, start_vel, target_vel,
            u=min(self.vel_lookahead, 1), deriv=1,
        )
        movement_control = 0.5 * (des_curr_pos - curr_pos) + 0.5 * (
            des_curr_vel - curr_vel
        )
        movement_control = (
            movement_control * self.speed_strength * self.strength_multiplier
        )
        if agent.action_size == 2:
            return movement_control
        shot_power = self._get(agent, "shot_power")
        rel_ang = self.get_rel_ang(
            ang1=self._get(agent, "target_ang")[:, None],
            ang2=agent.state.rot,
        )
        rot_ctrl = torch.sin(rel_ang)
        rot_ctrl = torch.where(
            rel_ang > np.pi / 2, torch.ones_like(rot_ctrl), rot_ctrl
        )
        rot_ctrl = torch.where(
            rel_ang < -np.pi / 2, -torch.ones_like(rot_ctrl), rot_ctrl
        )
        shooting_control = torch.stack([rot_ctrl, shot_power], dim=-1)
        return torch.cat([movement_control, shooting_control], dim=-1)

    def get_rel_ang(self, vec1=None, vec2=None, ang1=None, ang2=None):
        if vec1 is not None:
            ang1 = torch.atan2(vec1[:, 1], vec1[:, 0])
        if vec2 is not None:
            ang2 = torch.atan2(vec2[:, 1], vec2[:, 0])
        if ang1.ndim == 2:
            ang1 = ang1.squeeze(-1)
        if ang2.ndim == 2:
            ang2 = ang2.squeeze(-1)
        return torch.remainder(ang1 - ang2 + np.pi, 2 * np.pi) - np.pi

    def plot_traj(self, agent):
        traj_points = self.world.traj_points.get(self.team_name, {}).get(
            agent.name, []
        )
        if not traj_points:
            return
        start_pos = self._get(agent, "start_pos")
        target_pos = self._get(agent, "target_pos")
        start_vel = self._get(agent, "start_vel")
        target_vel = self._get(agent, "target_vel")
        for i, u in enumerate(np.linspace(0, 1, len(traj_points))):
            posi = Splines.hermite(
                start_pos, target_pos, start_vel, target_vel,
                u=float(u), deriv=0,
            )
            traj_points[i].set_pos(posi, batch_index=None)

    def clamp_pos(self, pos, return_bool=False):
        agent_size = self.world.agent_size
        pitch_y = self.world.pitch_width / 2 - agent_size
        pitch_x = self.world.pitch_length / 2 - agent_size
        goal_y = self.world.goal_size / 2 - agent_size
        goal_x = self.world.goal_depth
        new_y = torch.clamp(pos[..., Y], -pitch_y, pitch_y)
        inside_goal_y_mask = torch.abs(new_y) < goal_y
        new_x = torch.where(
            inside_goal_y_mask,
            torch.clamp(pos[..., X], -pitch_x - goal_x, pitch_x + goal_x),
            torch.clamp(pos[..., X], -pitch_x, pitch_x),
        )
        new_pos = torch.stack([new_x, new_y], dim=-1)
        if return_bool:
            return torch.any(new_pos != pos, dim=-1)
        return new_pos

    def check_possession(self):
        agents = self.teammates + self.opposition
        agents_pos = torch.stack([a.state.pos for a in agents], dim=1)
        agents_vel = torch.stack([a.state.vel for a in agents], dim=1)
        ball_pos = self.ball.state.pos
        ball_vel = self.ball.state.vel
        ball_disps = ball_pos[:, None, :] - agents_pos
        relvels = ball_vel[:, None, :] - agents_vel
        dists = torch.linalg.norm(
            ball_disps + relvels * self.possession_lookahead, dim=-1
        )
        mindist_team = torch.argmin(dists, dim=-1) < len(self.teammates)
        self.world.set_extra(
            f"ai_{self.team_name}.team_possession", mindist_team
        )
        net_disps = self.target_net.state.pos[:, None, :] - agents_pos
        ball_dir = ball_disps / torch.clamp_min(
            torch.linalg.norm(ball_disps, dim=-1, keepdim=True), 1e-12
        )
        net_dir = net_disps / torch.clamp_min(
            torch.linalg.norm(net_disps, dim=-1, keepdim=True), 1e-12
        )
        side_dot_prod = torch.sum(ball_dir * net_dir, dim=-1)
        dists = dists - 0.5 * side_dot_prod * self.decision_strength
        if self.decision_strength != 1:
            dists = dists + 0.5 * torch.randn(
                dists.shape, generator=self.world.generator,
                device=dists.device,
            ) * (1 - self.decision_strength) ** 2
        mindist_agents = torch.argmin(
            dists[:, : len(self.teammates)], dim=-1
        )
        for i, agent in enumerate(self.teammates):
            self.world.set_extra(
                self._k(agent, "possession"), mindist_agents == i
            )

    def check_better_positions(self, agent):
        ball_pos = self.ball.state.pos
        curr_target = self._get(agent, "target_pos_rel") + ball_pos
        samples = (
            torch.randn(
                (ball_pos.shape[0], self.nsamples, self.world.dim_p),
                generator=self.world.generator,
                device=ball_pos.device,
            )
            * self.sigma
            * (1 + 3 * (1 - self.decision_strength))
        )
        centres = [ball_pos if j % 2 == 0 else agent.state.pos
                   for j in range(self.nsamples)]
        samples = samples + torch.stack(centres, dim=1)
        test_pos = torch.cat([curr_target[:, None, :], samples], dim=1)
        test_pos = self.clamp_pos(test_pos)
        values = self.get_pos_value(test_pos, agent=agent)
        values = torch.cat(
            [values[:, :1]
             + (self.replan_margin + 3 * (1 - self.decision_strength)),
             values[:, 1:]],
            dim=1,
        )
        # First-max fold: ties keep the first candidate, as argmax does.
        best_pos = test_pos[:, 0]
        best_val = values[:, 0]
        for k in range(1, test_pos.shape[1]):
            better = (values[:, k] > best_val)[:, None]
            best_pos = torch.where(better, test_pos[:, k], best_pos)
            best_val = torch.maximum(best_val, values[:, k])
        return best_pos

    def get_pos_value(self, pos, agent):
        """pos [B, S, 2] -> value [B, S] (football.py:2182-2234)."""
        ball_pos = self.ball.state.pos[:, None]
        target_net_pos = self.target_net.state.pos[:, None]
        own_net_pos = self.own_net.state.pos[:, None]
        ball_vec = ball_pos - pos
        ball_norm = torch.linalg.norm(ball_vec, dim=-1, keepdim=True)
        ball_vec = torch.where(
            ball_norm > 0,
            ball_vec / torch.clamp_min(ball_norm, 1e-12),
            torch.zeros_like(ball_vec),
        )

        ball_dist = torch.linalg.norm(pos - ball_pos, dim=-1)
        ball_dist_value = torch.exp(-2 * ball_dist**4)

        net_vec = target_net_pos - pos
        net_norm = torch.clamp_min(
            torch.linalg.norm(net_vec, dim=-1, keepdim=True), 1e-12
        )
        net_vec = net_vec / net_norm
        side_dot_prod = torch.sum(ball_vec * net_vec, dim=-1)
        side_value = torch.clamp_max(side_dot_prod + 1.25, 1.0)

        own_net_vec = (own_net_pos - pos) / net_norm
        defend_dot_prod = torch.sum(ball_vec * -own_net_vec, dim=-1)
        defend_value = torch.clamp_min(defend_dot_prod, 0.0)

        if len(self.teammates) > 1:
            agent_index = self.teammates.index(agent)
            team_disps = self.get_separations(teammate=True)
            team_disps = torch.cat(
                [
                    team_disps[:, :agent_index],
                    team_disps[:, agent_index + 1:],
                ],
                dim=1,
            )
            team_dists = torch.linalg.norm(
                team_disps[:, None] - pos[:, :, None], dim=-1
            )
            other_agent_value = (
                -torch.linalg.norm(torch.exp(-5 * team_dists), dim=-1) + 1
            )
        else:
            other_agent_value = 0

        wall_disps = self.get_wall_separations(pos)
        wall_dists = torch.linalg.norm(wall_disps, dim=-1)
        wall_value = (
            -torch.linalg.norm(torch.exp(-8 * wall_dists), dim=-1) + 1
        )

        value = (
            wall_value
            + other_agent_value
            + ball_dist_value
            + side_value
            + defend_value
        ) / 5
        if self.decision_strength != 1:
            value = value + torch.randn(
                value.shape, generator=self.world.generator,
                device=value.device,
            ) * (1 - self.decision_strength)
        return value

    def get_wall_separations(self, pos):
        """pos [..., 2] -> [..., 2 walls, 2] displacements."""
        top_wall_dist = -pos[..., Y] + self.world.pitch_width / 2
        bottom_wall_dist = pos[..., Y] + self.world.pitch_width / 2
        left_wall_dist = pos[..., X] + self.world.pitch_length / 2
        right_wall_dist = -pos[..., X] + self.world.pitch_length / 2
        vertical_mag = torch.minimum(top_wall_dist, bottom_wall_dist)
        vertical_sign = torch.where(
            bottom_wall_dist < top_wall_dist, -1.0, 1.0
        )
        vertical_wall_disp = torch.stack(
            [torch.zeros_like(vertical_mag), vertical_mag * vertical_sign],
            dim=-1,
        )
        horizontal_mag = torch.minimum(left_wall_dist, right_wall_dist)
        horizontal_sign = torch.where(
            left_wall_dist < right_wall_dist, -1.0, 1.0
        )
        horizontal_wall_disp = torch.stack(
            [horizontal_mag * horizontal_sign,
             torch.zeros_like(horizontal_mag)],
            dim=-1,
        )
        return torch.stack([vertical_wall_disp, horizontal_wall_disp], dim=-2)

    def get_separations(self, teammate=False, opposition=False, vel=False):
        assert teammate or opposition, (
            "One of teammate or opposition must be True"
        )
        key = (teammate, opposition, vel)
        if key in self._team_disps:
            return self._team_disps[key]
        disps = []
        if teammate:
            for a in self.teammates:
                disps.append(a.state.vel if vel else a.state.pos)
        if opposition:
            for a in self.opposition:
                disps.append(a.state.vel if vel else a.state.pos)
        out = torch.stack(disps, dim=1)
        self._team_disps[key] = out
        return out


class Splines:
    A = np.asarray(
        [
            [2.0, -2.0, 1.0, 1.0],
            [-3.0, 3.0, -2.0, -1.0],
            [0.0, 0.0, 1.0, 0.0],
            [1.0, 0.0, 0.0, 0.0],
        ],
        np.float32,
    )
    # (u, deriv) -> the 4 fp32 coefficients U(u) @ A, as Python floats: a
    # step multiplies by scalars and copies nothing from the host.
    _coefs: Dict[tuple, List[float]] = {}

    @classmethod
    def coefficients(cls, u: float, deriv: int) -> List[float]:
        key = (u, deriv)
        c = cls._coefs.get(key)
        if c is None:
            U = np.asarray(
                [
                    cls.nPr(3, deriv) * (u ** max(0, 3 - deriv)),
                    cls.nPr(2, deriv) * (u ** max(0, 2 - deriv)),
                    cls.nPr(1, deriv) * (u ** max(0, 1 - deriv)),
                    cls.nPr(0, deriv) * (u**0),
                ],
                np.float32,
            )
            c = cls._coefs[key] = [float(x) for x in U @ cls.A]
        return c

    @classmethod
    def hermite(cls, p0, p1, p0dot, p1dot, u=0.1, deriv=0):
        assert isinstance(u, float)
        c = cls.coefficients(u, deriv)
        return c[0] * p0 + c[1] * p1 + c[2] * p0dot + c[3] * p1dot

    @classmethod
    def nPr(cls, n, r):
        if r > n:
            return 0
        ans = 1
        for k in range(n, max(1, n - r), -1):
            ans = ans * k
        return ans
