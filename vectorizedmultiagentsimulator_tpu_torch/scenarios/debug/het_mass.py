"""Debug het_mass (reference ``vmas/scenarios/debug/het_mass.py``).

Two agents with heterogeneous masses move along X only; the reward is the
larger speed minus the energy spent.  Each env draws its own mass noise
at every reset (the reference draws one for the whole batch,
het_mass.py:49-54), held as per-env mass in
``state.extras["<name>.dyn_mass"]``.  As in the JAX package, a world with
per-env mass steps through the plain physics, never the kernel
(``ops/physics_cuda.step_supported``).
"""
import math

import torch

from vectorizedmultiagentsimulator_tpu_torch.core import Agent, World
from vectorizedmultiagentsimulator_tpu_torch.scenario import BaseScenario
from vectorizedmultiagentsimulator_tpu_torch.utils import (
    Color,
    ScenarioUtils,
    env_index_to_mask,
)


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        self.green_mass = kwargs.pop("green_mass", 4)
        self.blue_mass = kwargs.pop("blue_mass", 2)
        self.mass_noise = kwargs.pop("mass_noise", 1)
        ScenarioUtils.check_kwargs_consumed(kwargs)
        self.plot_grid = True

        world = World(batch_dim, device)
        self._green_agent = Agent(
            name="agent 0",
            collide=False,
            color=Color.GREEN,
            render_action=True,
            mass=self.green_mass,
            f_range=1,
        )
        world.add_agent(self._green_agent)
        self._blue_agent = Agent(
            name="agent 1",
            collide=False,
            render_action=True,
            mass=self.blue_mass,
            f_range=1,
        )
        world.add_agent(self._blue_agent)
        return world

    def reset_world_at(self, env_index=None):
        B, dev = self.world.batch_dim, self.world.device
        mask = env_index_to_mask(env_index, B, dev)[:, None]
        for agent, base in (
            (self._green_agent, self.green_mass),
            (self._blue_agent, self.blue_mass),
        ):
            new_mass = base + ScenarioUtils.uniform_in_bounds(
                self.world, -self.mass_noise, self.mass_noise, (1,))
            if self.world.has_extra(f"{agent.name}.dyn_mass"):
                agent.mass = torch.where(mask, new_mass, agent.mass)
            else:
                agent.mass = new_mass
        for agent in self.world.agents:
            agent.set_pos(
                ScenarioUtils.uniform_in_bounds(self.world, -1.0, 1.0),
                batch_index=env_index,
            )
        if env_index is None:
            self.max_speed = torch.zeros((B,), dtype=torch.float32,
                                         device=dev)
            self.energy_expenditure = torch.zeros((B,), dtype=torch.float32,
                                                  device=dev)

    def process_action(self, agent):
        u = agent.action.u
        agent.action.u = torch.cat([u[:, :1], torch.zeros_like(u[:, 1:2]),
                                    u[:, 2:]], dim=1)

    def reward(self, agent):
        is_first = agent is self.world.agents[0]
        if is_first:
            self.max_speed = torch.amax(
                torch.stack(
                    [
                        torch.linalg.norm(a.state.vel, dim=1)
                        for a in self.world.agents
                    ],
                    dim=1,
                ),
                dim=1,
            )
            self.energy_expenditure = (
                -torch.sum(
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
                * 0.17
            )
        return self.max_speed + self.energy_expenditure

    def observation(self, agent):
        return torch.cat([agent.state.pos, agent.state.vel], dim=-1)

    def info(self, agent):
        return {
            "max_speed": self.max_speed,
            "energy_expenditure": self.energy_expenditure,
        }
