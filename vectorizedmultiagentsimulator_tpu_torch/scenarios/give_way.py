"""Give_way scenario (reference ``vmas/scenarios/give_way.py``).

Two velocity-controlled agents start at opposite ends of a narrow corridor
with a single asymmetric passage bump; each must reach the other's start,
so one has to give way.  The PyTorch counterpart of the JAX package's
``scenarios/give_way.py``: the spawn noise is drawn per env where the
reference draws one sample for all envs (give_way.py:150-158), and the
agents' PID state lives in extras (``controllers/velocity_controller.py``),
zeroed per env by a masked reset and wherever an agent's command is 0.
"""
import math

import torch

from vectorizedmultiagentsimulator_tpu_torch.controllers import VelocityController
from vectorizedmultiagentsimulator_tpu_torch.core import (
    Agent,
    Box,
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


def point(world, *xy):
    """A constant position or rotation on the world's device, made once so
    that a reset copies nothing from the host."""
    return torch.tensor(xy, dtype=torch.float32, device=world.device)


def delayed_action(holder, agent):
    """Push the agent's action into ``holder.input_queue`` (``[B, D, 2]``)
    and return the oldest one (goal.py:57-59, 106-110)."""
    queue = holder.input_queue
    holder.input_queue = torch.cat([queue[:, 1:], agent.action.u[:, None]],
                                   dim=1)
    return queue[:, 0]


def controlled_action(agent, u_range, min_input_norm):
    """The velocity command clamped to ``u_range`` in norm, zeroed under
    ``min_input_norm``."""
    u = TorchUtils.clamp_with_norm(agent.action.u, u_range)
    action_norm = torch.linalg.norm(u, dim=1)
    return torch.where((action_norm < min_input_norm)[:, None], 0.0, u)


def with_noise(world, observations, obs_noise):
    """Each observation plus uniform noise in ``[-obs_noise, obs_noise)``
    where ``obs_noise`` > 0."""
    if obs_noise > 0:
        observations = [
            obs + ScenarioUtils.uniform_in_bounds(world, -obs_noise,
                                                  obs_noise, obs.shape[1:])
            for obs in observations
        ]
    return torch.cat(observations, dim=-1)


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        self.v_range = kwargs.pop("v_range", 0.5)
        self.a_range = kwargs.pop("a_range", 1)
        self.obs_noise = kwargs.pop("obs_noise", 0)
        self.box_agents = kwargs.pop("box_agents", False)
        self.linear_friction = kwargs.pop("linear_friction", 0.1)
        self.mirror_passage = kwargs.pop("mirror_passage", False)
        self.done_on_completion = kwargs.pop("done_on_completion", False)
        self.observe_rel_pos = kwargs.pop("observe_rel_pos", False)
        self.pos_shaping_factor = kwargs.pop("pos_shaping_factor", 1.0)
        self.final_reward = kwargs.pop("final_reward", 0.01)
        self.energy_reward_coeff = kwargs.pop("energy_rew_coeff", 0)
        self.agent_collision_penalty = kwargs.pop("agent_collision_penalty", 0)
        self.passage_collision_penalty = kwargs.pop(
            "passage_collision_penalty", 0
        )
        self.obstacle_collision_penalty = kwargs.pop(
            "obstacle_collision_penalty", 0
        )
        self.use_velocity_controller = kwargs.pop(
            "use_velocity_controller", True
        )
        self.min_input_norm = kwargs.pop("min_input_norm", 0.08)
        self.dt_delay = kwargs.pop("dt_delay", 0)
        ScenarioUtils.check_kwargs_consumed(kwargs)

        self.viewer_size = (1600, 700)
        controller_params = [2, 6, 0.002]
        self.f_range = self.a_range + self.linear_friction
        self.u_range = (
            self.v_range if self.use_velocity_controller else self.f_range
        )

        world = World(
            batch_dim,
            device,
            drag=0,
            dt=0.05,
            linear_friction=self.linear_friction,
            substeps=16 if self.box_agents else 5,
            collision_force=10000 if self.box_agents else 500,
        )

        self.agent_radius = 0.16
        self.agent_box_length = 0.32
        self.agent_box_width = 0.24
        self.spawn_pos_noise = 0.02
        self.min_collision_distance = 0.005

        def agent_shape():
            return (
                Sphere(radius=self.agent_radius)
                if not self.box_agents
                else Box(
                    length=self.agent_box_length, width=self.agent_box_width
                )
            )

        for i, color in enumerate((Color.BLUE, Color.GREEN)):
            agent = Agent(
                name=f"agent_{i}",
                rotatable=False,
                linear_friction=self.linear_friction,
                shape=agent_shape(),
                u_range=self.u_range,
                f_range=self.f_range,
                v_range=self.v_range,
                render_action=True,
                **({} if i == 0 else dict(color=Color.GREEN)),
            )
            if self.use_velocity_controller:
                agent.controller = VelocityController(
                    agent, world, controller_params, "standard"
                )
            goal = Landmark(
                name=f"goal_{i}",
                collide=False,
                shape=Sphere(radius=self.agent_radius / 2),
                color=color,
            )
            agent.goal = goal
            world.add_agent(agent)
            world.add_landmark(goal)

        self.spawn_map(world)
        return world

    def reset_world_at(self, env_index=None):
        B = self.world.batch_dim
        g, dev = self.world.generator, self.world.device

        def noise():
            u = torch.rand((B, self.world.dim_p), generator=g, device=dev)
            return -self.spawn_pos_noise + u * (2 * self.spawn_pos_noise)

        self.world.agents[0].set_pos(self._starts[0] + noise(),
                                     batch_index=env_index)
        self.world.landmarks[0].set_pos(self._goals[0], batch_index=env_index)
        self.world.agents[1].set_pos(self._starts[1] + noise(),
                                     batch_index=env_index)
        self.world.landmarks[1].set_pos(self._goals[1], batch_index=env_index)
        if self.use_velocity_controller:
            for agent in self.world.agents:
                agent.controller.reset(env_index)

        self.reset_map(env_index)
        for agent in self.world.agents:
            shaping = (
                torch.linalg.norm(agent.state.pos - agent.goal.state.pos,
                                  dim=1)
                * self.pos_shaping_factor
            )
            if env_index is None:
                agent.shaping = shaping
                for name in ("energy_rew", "energy_expenditure",
                             "agent_collision_rew", "obstacle_collision_rew"):
                    setattr(agent, name, torch.zeros(
                        (B,), dtype=torch.float32, device=dev))
                if self.dt_delay > 0:
                    agent.input_queue = torch.zeros(
                        (B, self.dt_delay, self.world.dim_p),
                        dtype=torch.float32, device=dev)
            else:
                agent.shaping = TorchUtils.where_from_index(
                    env_index, shaping, agent.shaping
                )
        if env_index is None:
            self.goal_reached = torch.zeros((B,), dtype=torch.bool,
                                            device=dev)
            self.pos_rew = torch.zeros((B,), dtype=torch.float32, device=dev)
            self.final_rew = torch.zeros((B,), dtype=torch.float32,
                                         device=dev)
        else:
            self.goal_reached = TorchUtils.where_from_index(
                env_index, False, self.goal_reached
            )

    def process_action(self, agent):
        if self.use_velocity_controller:
            if self.dt_delay > 0:
                agent.action.u = delayed_action(agent, agent)
            u = controlled_action(agent, self.u_range, self.min_input_norm)
            agent.action.u = u
            vel_is_zero = torch.linalg.norm(u, dim=1) < 1e-3
            agent.controller.reset(vel_is_zero)
            agent.controller.process_force()

    def reward(self, agent):
        is_first = agent is self.world.agents[0]
        blue_agent = self.world.agents[0]
        green_agent = self.world.agents[-1]

        if is_first:
            blue_distance = torch.linalg.norm(
                blue_agent.state.pos - blue_agent.goal.state.pos, dim=1
            )
            green_distance = torch.linalg.norm(
                green_agent.state.pos - green_agent.goal.state.pos, dim=1
            )
            blue_on_goal = blue_distance < blue_agent.goal.shape.radius
            green_on_goal = green_distance < green_agent.goal.shape.radius
            self.goal_reached = green_on_goal & blue_on_goal

            green_shaping = green_distance * self.pos_shaping_factor
            green_rew = green_agent.shaping - green_shaping
            green_agent.shaping = green_shaping

            blue_shaping = blue_distance * self.pos_shaping_factor
            blue_rew = blue_agent.shaping - blue_shaping
            blue_agent.shaping = blue_shaping

            self.pos_rew = blue_rew + green_rew
            self.final_rew = torch.where(
                self.goal_reached, self.final_reward, 0.0
            )

        agent_collision_rew = torch.zeros(
            (self.world.batch_dim,), dtype=torch.float32,
            device=self.world.device,
        )
        obstacle_collision_rew = torch.zeros_like(agent_collision_rew)
        for a in self.world.agents:
            if a is not agent:
                agent_collision_rew = agent_collision_rew + torch.where(
                    self.world.get_distance(agent, a)
                    <= self.min_collision_distance,
                    self.agent_collision_penalty,
                    0.0,
                )
        passages = (
            [*self._passage_1, *self._passage_2]
            if self.mirror_passage
            else [*self._passage_1]
        )
        for landmark in self.world.landmarks:
            if self.world.collides(agent, landmark):
                penalty = (
                    self.passage_collision_penalty
                    if landmark in passages
                    else self.obstacle_collision_penalty
                )
                obstacle_collision_rew = obstacle_collision_rew + torch.where(
                    self.world.get_distance(agent, landmark)
                    <= self.min_collision_distance,
                    penalty,
                    0.0,
                )
        agent.agent_collision_rew = agent_collision_rew
        agent.obstacle_collision_rew = obstacle_collision_rew

        agent.energy_expenditure = torch.linalg.norm(
            agent.action.u, dim=-1
        ) / math.sqrt(self.world.dim_p * (agent.f_range**2))
        agent.energy_rew = -agent.energy_expenditure * self.energy_reward_coeff

        return (
            self.pos_rew
            + agent.obstacle_collision_rew
            + agent.agent_collision_rew
            + agent.energy_rew
            + self.final_rew
        )

    def observation(self, agent):
        rel = [
            agent.state.pos - a.state.pos
            for a in self.world.agents
            if a is not agent
        ]
        observations = [agent.state.pos, agent.state.vel]
        if self.observe_rel_pos:
            observations += rel
        return with_noise(self.world, observations, self.obs_noise)

    def info(self, agent):
        return {
            "pos_rew": self.pos_rew,
            "final_rew": self.final_rew,
            "energy_rew": agent.energy_rew,
            "agent_collision_rew": agent.agent_collision_rew,
            "obstacle_collision_rew": agent.obstacle_collision_rew,
        }

    def spawn_map(self, world: World):
        self.scenario_length = 5
        self.passage_length = 0.4
        self.passage_width = 0.48
        self.corridor_width = self.passage_length
        self.small_ceiling_length = (self.scenario_length / 2) - (
            self.passage_length / 2
        )
        self.goal_dist_from_wall = self.agent_radius + 0.05
        self.agent_dist_from_wall = 0.5

        self._walls = []
        for i in range(2):
            landmark = Landmark(
                name=f"wall {i}",
                collide=True,
                shape=Line(length=self.corridor_width),
                color=Color.BLACK,
            )
            self._walls.append(landmark)
            world.add_landmark(landmark)
        self._small_ceilings_1 = []
        for i in range(2):
            landmark = Landmark(
                name=f"ceil 1 {i}",
                collide=True,
                shape=Line(length=self.small_ceiling_length),
                color=Color.BLACK,
            )
            self._small_ceilings_1.append(landmark)
            world.add_landmark(landmark)
        self._passage_1 = []
        for i in range(3):
            landmark = Landmark(
                name=f"ceil 2 {i}",
                collide=True,
                shape=Line(
                    length=self.passage_length
                    if i == 2
                    else self.passage_width
                ),
                color=Color.BLACK,
            )
            self._passage_1.append(landmark)
            world.add_landmark(landmark)
        self._passage_2 = []
        if self.mirror_passage:
            self._small_ceilings_2 = []
            for i in range(2):
                landmark = Landmark(
                    name=f"ceil 12 {i}",
                    collide=True,
                    shape=Line(length=self.small_ceiling_length),
                    color=Color.BLACK,
                )
                self._small_ceilings_2.append(landmark)
                world.add_landmark(landmark)
            for i in range(3):
                landmark = Landmark(
                    name=f"ceil 22 {i}",
                    collide=True,
                    shape=Line(
                        length=self.passage_length
                        if i == 2
                        else self.passage_width
                    ),
                    color=Color.BLACK,
                )
                self._passage_2.append(landmark)
                world.add_landmark(landmark)
        else:
            self._floor = Landmark(
                name="floor",
                collide=True,
                shape=Line(length=self.scenario_length),
                color=Color.BLACK,
            )
            world.add_landmark(self._floor)

        # The fixed poses, on the device once.
        L, P, W = self.scenario_length, self.passage_length, self.passage_width
        start = L / 2 - self.agent_dist_from_wall
        goal = L / 2 - self.goal_dist_from_wall
        self._starts = [point(world, -start, 0.0), point(world, start, 0.0)]
        self._goals = [point(world, goal, 0.0), point(world, -goal, 0.0)]
        self._upright = point(world, math.pi / 2)
        ceil = self.small_ceiling_length / 2 - L / 2
        self._poses = {"walls": [point(world, -L / 2, 0.0),
                                 point(world, L / 2, 0.0)]}
        for tag, s in (("1", 1.0), ("2", -1.0)):
            self._poses["ceil " + tag] = [point(world, -ceil, s * P / 2),
                                          point(world, ceil, s * P / 2)]
            self._poses["passage " + tag] = [
                point(world, -P / 2, s * (P / 2 + W / 2)),
                point(world, P / 2, s * (P / 2 + W / 2)),
                point(world, 0.0, s * (P / 2 + W)),
            ]
        self._poses["floor"] = point(world, 0.0, -P / 2)

    def reset_map(self, env_index):
        for landmark, pos in zip(self._walls, self._poses["walls"]):
            landmark.set_pos(pos, batch_index=env_index)
            landmark.set_rot(self._upright, batch_index=env_index)
        sides = [("1", self._small_ceilings_1, self._passage_1)]
        if self.mirror_passage:
            sides.append(("2", self._small_ceilings_2, self._passage_2))
        for tag, ceilings, passage in sides:
            for landmark, pos in zip(ceilings, self._poses["ceil " + tag]):
                landmark.set_pos(pos, batch_index=env_index)
            for i, (landmark, pos) in enumerate(
                    zip(passage, self._poses["passage " + tag])):
                landmark.set_pos(pos, batch_index=env_index)
                if i < 2:
                    landmark.set_rot(self._upright, batch_index=env_index)
        if not self.mirror_passage:
            self._floor.set_pos(self._poses["floor"], batch_index=env_index)

    def done(self):
        if self.done_on_completion:
            return self.goal_reached
        return torch.zeros_like(self.goal_reached)
