"""Debug line_trajectory (reference
``vmas/scenarios/debug/line_trajectory.py``).

One velocity-controlled agent rewarded for tracking the vertical line
x = 0 upward: the negative square root of its distance to the line, its
velocity along the line, and a steadiness bonus for a velocity aligned
with the command.  Done once the agent passes the line's end.
"""
import torch

from vectorizedmultiagentsimulator_tpu_torch.controllers import VelocityController
from vectorizedmultiagentsimulator_tpu_torch.core import Agent, Sphere, World
from vectorizedmultiagentsimulator_tpu_torch.scenario import BaseScenario
from vectorizedmultiagentsimulator_tpu_torch.scenarios.give_way import (
    with_noise,
)
from vectorizedmultiagentsimulator_tpu_torch.utils import (
    Color,
    ScenarioUtils,
    X,
    Y,
)


def _safe_normalize(v):
    norm = torch.linalg.norm(v, dim=1, keepdim=True)
    return torch.where(norm > 0, v / torch.clamp_min(norm, 1e-12), 0.0)


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        self.obs_noise = kwargs.pop("obs_noise", 0)
        ScenarioUtils.check_kwargs_consumed(kwargs)

        self.agent_radius = 0.03
        self.line_length = 3

        world = World(batch_dim, device, drag=0.1)
        self._agent = Agent(
            name="agent_0",
            shape=Sphere(self.agent_radius),
            mass=2,
            f_range=0.5,
            u_range=1,
            render_action=True,
        )
        self._agent.controller = VelocityController(
            self._agent, world, [4, 1.25, 0.001], "standard"
        )
        world.add_agent(self._agent)
        return world

    def process_action(self, agent):
        self.vel_action = agent.action.u
        agent.controller.process_force()

    def reset_world_at(self, env_index=None):
        self._agent.controller.reset(env_index)
        B, dev = self.world.batch_dim, self.world.device
        g = self.world.generator
        x = -1 + 2 * torch.rand((B, 1), generator=g, device=dev)
        y = -1 + torch.rand((B, 1), generator=g, device=dev)
        self._agent.set_pos(torch.cat([x, y], dim=1), batch_index=env_index)
        if env_index is None:
            for name in ("pos_rew", "dot_product", "steady_rew"):
                setattr(self, name, torch.zeros((B,), dtype=torch.float32,
                                                device=dev))
            self.vel_action = torch.zeros((B, self.world.dim_p),
                                          dtype=torch.float32, device=dev)

    def reward(self, agent):
        pos = agent.state.pos
        closest_point = torch.stack([torch.zeros_like(pos[:, X]), pos[:, Y]],
                                    dim=1)
        self.pos_rew = -(torch.linalg.norm(pos - closest_point, dim=1) ** 0.5)
        tangent = torch.zeros_like(agent.state.vel)
        tangent[:, Y] = 1.0
        self.dot_product = torch.sum(tangent * agent.state.vel, dim=-1) * 0.5
        normalized_vel = _safe_normalize(agent.state.vel)
        normalized_vel_action = _safe_normalize(self.vel_action)
        self.steady_rew = (
            torch.sum(normalized_vel * normalized_vel_action, dim=-1) * 0.2
        )
        return self.pos_rew + self.dot_product + self.steady_rew

    def observation(self, agent):
        return with_noise(
            self.world, [agent.state.pos, agent.state.vel, agent.state.pos],
            self.obs_noise)

    def done(self):
        return self.world.agents[0].state.pos[:, Y] > self.line_length - 1

    def info(self, agent):
        return {
            "pos_rew": self.pos_rew,
            "dot_product": self.dot_product,
            "steady_rew": self.steady_rew,
        }

    def extra_render(self, env_index: int = 0):
        from vectorizedmultiagentsimulator_tpu_torch import render as rendering

        line = rendering.Line((0, -1), (0, -1 + self.line_length), width=0.01)
        line.set_color(*Color.BLACK.value)
        return [line]
