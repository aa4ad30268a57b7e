"""Wheel scenario (reference ``vmas/scenarios/wheel.py``).

Agents spin a heavy line anchored at the origin to a desired angular
velocity.
"""
import math

import torch

from vectorizedmultiagentsimulator_tpu_torch.core import (
    Agent,
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
)


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        n_agents = kwargs.pop("n_agents", 4)
        self.line_length = kwargs.pop("line_length", 2)
        line_mass = kwargs.pop("line_mass", 30)
        self.desired_velocity = kwargs.pop("desired_velocity", 0.05)
        ScenarioUtils.check_kwargs_consumed(kwargs)

        world = World(batch_dim, device)
        for i in range(n_agents):
            world.add_agent(
                Agent(name=f"agent_{i}", u_multiplier=0.6, shape=Sphere(0.03))
            )
        self._line = Landmark(
            name="line",
            collide=True,
            rotatable=True,
            shape=Line(length=self.line_length),
            mass=line_mass,
            color=Color.BLACK,
        )
        world.add_landmark(self._line)
        world.add_landmark(
            Landmark(
                name="center",
                shape=Sphere(radius=0.02),
                collide=False,
                color=Color.BLACK,
            )
        )
        return world

    @property
    def line(self):
        return self._line

    def reset_world_at(self, env_index=None):
        B = self.world.batch_dim
        for agent in self.world.agents:
            agent.set_pos(
                ScenarioUtils.uniform_in_bounds(self.world, -1.0, 1.0),
                batch_index=env_index,
            )
        self._line.set_rot(
            ScenarioUtils.uniform_in_bounds(
                self.world, -math.pi / 2, math.pi / 2, (1,)
            ),
            batch_index=env_index,
        )
        if env_index is None:
            self.rew = torch.zeros((B,), device=self.world.device)

    def reward(self, agent):
        is_first = agent is self.world.agents[0]
        if is_first:
            self.rew = torch.abs(
                torch.abs(self._line.state.ang_vel[:, 0])
                - self.desired_velocity
            )
        return -self.rew

    def observation(self, agent):
        line_end_1 = torch.cat(
            [
                (self.line_length / 2) * torch.cos(self._line.state.rot),
                (self.line_length / 2) * torch.sin(self._line.state.rot),
            ],
            dim=1,
        )
        line_end_2 = -line_end_1
        return torch.cat(
            [
                agent.state.pos,
                agent.state.vel,
                self._line.state.pos - agent.state.pos,
                line_end_1 - agent.state.pos,
                line_end_2 - agent.state.pos,
                self._line.state.rot % math.pi,
                torch.abs(self._line.state.ang_vel),
                torch.abs(
                    torch.abs(self._line.state.ang_vel)
                    - self.desired_velocity
                ),
            ],
            dim=-1,
        )


class HeuristicPolicy(BaseHeuristicPolicy):
    """Chase a rotated line end to keep torquing the line
    (wheel.py:118-143)."""

    def compute_action(self, observation, u_range):
        assert (
            self.continuous_actions is True
        ), "Heuristic for continuous actions only"
        index_line_extrema = 6
        pos_agent = observation[:, :2]
        pos_end2_agent = observation[
            :, index_line_extrema + 2 : index_line_extrema + 4
        ]
        pos_end2 = pos_end2_agent + pos_agent
        pos_end2_shifted = TorchUtils.rotate_vector(
            pos_end2,
            torch.full((pos_end2.shape[0],), math.pi / 4,
                       device=observation.device),
        )
        pos_end2_shifted_agent = pos_end2_shifted - pos_agent
        return torch.clamp(pos_end2_shifted_agent, -u_range, u_range)
