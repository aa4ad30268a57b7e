"""Multi_give_way scenario (reference ``vmas/scenarios/multi_give_way.py``).

Four velocity-controlled agents cross a 4-way corridor intersection, each
heading to the opposite arm: they must take turns in the central square.
The PyTorch counterpart of the JAX package's
``scenarios/multi_give_way.py``; the agents' PID state lives in extras
(``controllers/velocity_controller.py``), zeroed per env by a masked
reset and wherever an agent's command is 0.
"""
import math

import numpy as np
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
from vectorizedmultiagentsimulator_tpu_torch.scenarios.give_way import (
    controlled_action,
    point,
    with_noise,
)
from vectorizedmultiagentsimulator_tpu_torch.utils import (
    Color,
    ScenarioUtils,
    TorchUtils,
)


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        self.u_range = kwargs.pop("u_range", 0.5)
        self.a_range = kwargs.pop("a_range", 1)
        self.obs_noise = kwargs.pop("obs_noise", 0)
        self.box_agents = kwargs.pop("box_agents", False)
        self.linear_friction = kwargs.pop("linear_friction", 0.1)
        self.min_input_norm = kwargs.pop("min_input_norm", 0.08)
        self.comms_range = kwargs.pop("comms_range", 5)
        self.shared_rew = kwargs.pop("shared_rew", True)
        self.n_agents = kwargs.pop("n_agents", 4)
        self.pos_shaping_factor = kwargs.pop("pos_shaping_factor", 1)
        self.final_reward = kwargs.pop("final_reward", 0.01)
        self.agent_collision_penalty = kwargs.pop(
            "agent_collision_penalty", -0.1
        )
        ScenarioUtils.check_kwargs_consumed(kwargs)

        self.viewer_zoom = 1.7
        controller_params = [2, 6, 0.002]
        self.n_agents = 4
        self.f_range = self.a_range + self.linear_friction

        world = World(
            batch_dim,
            device,
            drag=0,
            dt=0.1,
            linear_friction=self.linear_friction,
            substeps=16 if self.box_agents else 5,
            collision_force=10000 if self.box_agents else 500,
        )

        self.agent_radius = 0.16
        self.agent_box_length = 0.32
        self.agent_box_width = 0.24
        self.min_collision_distance = 0.005
        self.colors = [Color.GREEN, Color.BLUE, Color.RED, Color.GRAY]

        for i in range(self.n_agents):
            agent = Agent(
                name=f"agent_{i}",
                rotatable=False,
                linear_friction=self.linear_friction,
                shape=(
                    Sphere(radius=self.agent_radius)
                    if not self.box_agents
                    else Box(
                        length=self.agent_box_length,
                        width=self.agent_box_width,
                    )
                ),
                u_range=self.u_range,
                f_range=self.f_range,
                render_action=True,
                color=self.colors[i],
            )
            agent.controller = VelocityController(
                agent, world, controller_params, "standard"
            )
            goal = Landmark(
                name=f"goal {i}",
                collide=False,
                shape=Sphere(radius=self.agent_radius / 2),
                color=self.colors[i],
            )
            agent.goal = goal
            world.add_agent(agent)
            world.add_landmark(goal)
        self.spawn_map(world)
        return world

    def reset_world_at(self, env_index=None):
        B = self.world.batch_dim
        dev = self.world.device
        for i, agent in enumerate(self.world.agents):
            agent.controller.reset(env_index)
            next_i = (i + 1) % self.n_agents
            agent.set_pos(self._starts[i], batch_index=env_index)
            self.world.agents[next_i].goal.set_pos(self._goals[i],
                                                   batch_index=env_index)

        for agent in self.world.agents:
            shaping = (
                torch.linalg.norm(agent.state.pos - agent.goal.state.pos,
                                  dim=1)
                * self.pos_shaping_factor
            )
            if env_index is None:
                agent.shaping = shaping
                for name in ("pos_rew", "agent_collision_rew",
                             "distance_to_goal"):
                    setattr(agent, name, torch.zeros(
                        (B,), dtype=torch.float32, device=dev))
                agent.on_goal = torch.zeros((B,), dtype=torch.bool,
                                            device=dev)
            else:
                agent.shaping = TorchUtils.where_from_index(
                    env_index, shaping, agent.shaping
                )
        self.reset_map(env_index)
        if env_index is None:
            self.reached_goal = torch.zeros((B,), dtype=torch.bool,
                                            device=dev)
            self.pos_rew = torch.zeros((B,), dtype=torch.float32, device=dev)
            self.final_rew = torch.zeros((B,), dtype=torch.float32,
                                         device=dev)
            self.all_goal_reached = torch.zeros((B,), dtype=torch.bool,
                                                device=dev)
        else:
            self.reached_goal = TorchUtils.where_from_index(
                env_index, False, self.reached_goal
            )

    def process_action(self, agent):
        u = controlled_action(agent, self.u_range, self.min_input_norm)
        agent.action.u = u
        vel_is_zero = torch.linalg.norm(u, dim=1) < 1e-3
        agent.controller.reset(vel_is_zero)
        agent.controller.process_force()

    def reward(self, agent):
        is_first = agent is self.world.agents[0]
        if is_first:
            pos_rew = torch.zeros((self.world.batch_dim,), dtype=torch.float32,
                                  device=self.world.device)
            for a in self.world.agents:
                a.distance_to_goal = torch.linalg.norm(
                    a.state.pos - a.goal.state.pos, dim=-1
                )
                a.on_goal = a.distance_to_goal < a.goal.shape.radius
                pos_shaping = a.distance_to_goal * self.pos_shaping_factor
                a.pos_rew = (
                    (a.shaping - pos_shaping)
                    if self.pos_shaping_factor != 0
                    else -a.distance_to_goal * 0.0001
                )
                a.shaping = pos_shaping
                pos_rew = pos_rew + a.pos_rew
            self.pos_rew = pos_rew
            self.all_goal_reached = torch.all(
                torch.stack([a.on_goal for a in self.world.agents], dim=-1),
                dim=-1,
            )
            self.final_rew = torch.where(
                self.all_goal_reached, self.final_reward, 0.0
            )
            self.reached_goal = self.reached_goal | self.all_goal_reached

        agent_collision_rew = torch.zeros(
            (self.world.batch_dim,), dtype=torch.float32,
            device=self.world.device,
        )
        for a in self.world.agents:
            if a is not agent:
                agent_collision_rew = agent_collision_rew + torch.where(
                    self.world.get_distance(agent, a)
                    <= self.min_collision_distance,
                    self.agent_collision_penalty,
                    0.0,
                )
        agent.agent_collision_rew = agent_collision_rew
        return (
            (self.pos_rew if self.shared_rew else agent.pos_rew)
            + agent.agent_collision_rew
            + self.final_rew
        )

    def observation(self, agent):
        observations = [
            agent.state.pos,
            agent.state.vel,
            agent.state.pos - agent.goal.state.pos,
            torch.linalg.norm(
                agent.state.pos - agent.goal.state.pos, dim=-1
            )[:, None],
        ]
        return with_noise(self.world, observations, self.obs_noise)

    def info(self, agent):
        return {
            "pos_rew": self.pos_rew if self.shared_rew else agent.pos_rew,
            "final_rew": self.final_rew,
            "agent_collision_rew": agent.agent_collision_rew,
        }

    def spawn_map(self, world: World):
        self.scenario_length = 5
        self.scenario_width = 0.4
        self.long_wall_length = (self.scenario_length / 2) - (
            self.scenario_width / 2
        )
        self.short_wall_length = self.scenario_width
        self.goal_dist_from_wall = self.agent_radius + 0.05
        self.agent_dist_from_wall = 0.5

        self._long_walls = []
        for i in range(8):
            landmark = Landmark(
                name=f"wall {i}",
                collide=True,
                shape=Line(length=self.long_wall_length),
                color=Color.BLACK,
            )
            self._long_walls.append(landmark)
            world.add_landmark(landmark)
        self._short_walls = []
        for i in range(4):
            landmark = Landmark(
                name=f"short wall {i}",
                collide=True,
                shape=Line(length=self.short_wall_length),
                color=Color.BLACK,
            )
            self._short_walls.append(landmark)
            world.add_landmark(landmark)

        # The fixed poses, on the device once: agent i starts on its arm and
        # agent i + 1's goal lies at the end of that arm.
        L = self.scenario_length
        start = L / 2 - self.agent_dist_from_wall
        goal = L / 2 - self.goal_dist_from_wall
        signs = (-1, 1, 1, -1)
        self._starts = [
            point(world, start * signs[i], 0.0) if i in (0, 2)
            else point(world, 0.0, start * signs[i]) for i in range(4)]
        self._goals = [
            point(world, goal * signs[i], 0.0) if i in (0, 2)
            else point(world, 0.0, goal * signs[i]) for i in range(4)]
        self._upright = point(world, math.pi / 2)
        self._short_pos = [
            point(world, -L / 2 if i % 2 == 0 else L / 2, 0.0) if i < 2
            else point(world, 0.0, -L / 2 if i % 2 == 0 else L / 2)
            for i in range(4)]
        long_wall_pos = self.long_wall_length / 2 - L / 2
        half = self.scenario_width / 2
        self._long_pos = [
            point(world, long_wall_pos * (1 if i < 2 else -1),
                  half * (-1 if i % 2 == 0 else 1)) if i < 4
            else point(world, half * (-1 if i % 2 == 0 else 1),
                       long_wall_pos * (1 if i < 6 else -1))
            for i in range(8)]

    def reset_map(self, env_index):
        for i, landmark in enumerate(self._short_walls):
            landmark.set_pos(self._short_pos[i], batch_index=env_index)
            if i < 2:
                landmark.set_rot(self._upright, batch_index=env_index)
        for i, landmark in enumerate(self._long_walls):
            landmark.set_pos(self._long_pos[i], batch_index=env_index)
            if i >= 4:
                landmark.set_rot(self._upright, batch_index=env_index)

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
