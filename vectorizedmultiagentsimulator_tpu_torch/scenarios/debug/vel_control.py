"""Debug vel_control (reference ``vmas/scenarios/debug/vel_control.py``).

Three velocity-controlled agents with different force limits; the reward
is the negative total command norm: a showcase of the velocity
controller, whose PID state lives in extras
(``controllers/velocity_controller.py``).
"""
import torch

from vectorizedmultiagentsimulator_tpu_torch.controllers import VelocityController
from vectorizedmultiagentsimulator_tpu_torch.core import Agent, Landmark, World
from vectorizedmultiagentsimulator_tpu_torch.scenario import BaseScenario
from vectorizedmultiagentsimulator_tpu_torch.scenarios.give_way import (
    controlled_action,
)
from vectorizedmultiagentsimulator_tpu_torch.utils import (
    Color,
    ScenarioUtils,
    X,
)


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        self.green_mass = kwargs.pop("green_mass", 1)
        ScenarioUtils.check_kwargs_consumed(kwargs)
        self.plot_grid = True
        self.agent_radius = 0.16

        controller_params = [2, 6, 0.002]
        linear_friction = 0.1
        v_range = 1
        a_range = 1
        f_range = linear_friction + a_range
        u_range = v_range  # actions are velocity goals under the controller

        world = World(
            batch_dim,
            device,
            linear_friction=linear_friction,
            drag=0,
            dt=0.05,
            substeps=4,
        )

        for i, extra in enumerate((
                dict(color=Color.GREEN, mass=self.green_mass, f_range=f_range),
                dict(),
                dict(f_range=30))):
            agent = Agent(name=f"agent {i}", collide=False,
                          render_action=True, u_range=u_range, **extra)
            agent.controller = VelocityController(
                agent, world, controller_params, "standard"
            )
            world.add_agent(agent)

        self._landmark = Landmark("landmark 0", collide=False, movable=True)
        world.add_landmark(self._landmark)
        self._start = torch.tensor([-1.0, 0.0], device=world.device)
        return world

    def reset_world_at(self, env_index=None):
        for agent in self.world.agents:
            agent.controller.reset(env_index)
            agent.set_pos(self._start, batch_index=env_index)
        if env_index is None:
            self.energy_expenditure = torch.zeros(
                (self.world.batch_dim,), dtype=torch.float32,
                device=self.world.device)

    def process_action(self, agent):
        u = controlled_action(agent, agent.u_range, 0.08)
        if agent is self.world.agents[1]:
            # Acceleration-feasibility clamp on the X velocity goal
            # (vel_control.py:143-152).
            max_a = 1
            vel_goal = u[:, X]
            requested_a = (vel_goal - agent.state.vel[:, X]) / self.world.dt
            achievable_a = torch.clamp(requested_a, -max_a, max_a)
            u = torch.stack(
                [achievable_a * self.world.dt + agent.state.vel[:, X],
                 u[:, 1]], dim=1)
        agent.action.u = u
        agent.controller.process_force()

    def reward(self, agent):
        is_first = agent is self.world.agents[0]
        if is_first:
            self.energy_expenditure = (
                -torch.sum(
                    torch.stack(
                        [
                            torch.linalg.norm(a.action.u, dim=-1)
                            for a in self.world.agents
                        ],
                        dim=1,
                    ),
                    dim=-1,
                )
                * 3
            )
        return self.energy_expenditure

    def observation(self, agent):
        return torch.cat([agent.state.pos, agent.state.vel], dim=-1)

    def info(self, agent):
        return {"energy_expenditure": self.energy_expenditure}
