"""Debug drone (reference ``vmas/scenarios/debug/drone.py``).

Agents with 12-state quadrotor dynamics (``dynamics.Drone``, RK4, its
state in ``state.extras["<agent>.drone_state"]``): the three torque
actions are exposed and ``process_action`` prepends a fixed hover thrust.
Done when any drone's roll or pitch passes 30 degrees.
"""
import torch

from vectorizedmultiagentsimulator_tpu_torch.core import Agent, World
from vectorizedmultiagentsimulator_tpu_torch.dynamics import Drone
from vectorizedmultiagentsimulator_tpu_torch.scenario import BaseScenario
from vectorizedmultiagentsimulator_tpu_torch.utils import ScenarioUtils


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        self.plot_grid = True
        self.n_agents = kwargs.pop("n_agents", 2)
        ScenarioUtils.check_kwargs_consumed(kwargs)

        world = World(batch_dim, device, substeps=10)
        for i in range(self.n_agents):
            agent = Agent(
                name=f"drone_{i}",
                collide=True,
                render_action=True,
                u_range=[0.00001, 0.00001, 0.00001],  # torque_x/y/z
                u_multiplier=[1, 1, 1],
                action_size=3,  # the thrust is prepended in process_action
                dynamics=Drone(world, integration="rk4"),
            )
            world.add_agent(agent)
        return world

    def reset_world_at(self, env_index=None):
        ScenarioUtils.spawn_entities_randomly(
            self.world.agents,
            self.world,
            env_index,
            min_dist_between_entities=0.1,
            x_bounds=(-1, 1),
            y_bounds=(-1, 1),
        )

    def reward(self, agent):
        return torch.zeros((self.world.batch_dim,), dtype=torch.float32,
                           device=self.world.device)

    def process_action(self, agent):
        torque = agent.action.u
        thrust = torch.full((self.world.batch_dim, 1),
                            agent.mass * agent.dynamics.g,
                            device=self.world.device)
        agent.action.u = torch.cat([thrust, torque], dim=-1)

    def observation(self, agent):
        return torch.cat([agent.state.pos, agent.state.vel], dim=-1)

    def done(self):
        return torch.any(
            torch.stack(
                [agent.dynamics.needs_reset() for agent in self.world.agents],
                dim=-1,
            ),
            dim=-1,
        )

    def extra_render(self, env_index: int = 0):
        return [
            ScenarioUtils.plot_entity_rotation(agent, env_index, length=0.1)
            for agent in self.world.agents
        ]
