"""Debug diff_drive (reference ``vmas/scenarios/debug/diff_drive.py``).

The first agent has differential-drive dynamics (forward and angular
speed, RK4), the others holonomic dynamics with rotation; zero reward (a
dynamics showcase).
"""
import torch

from vectorizedmultiagentsimulator_tpu_torch.core import Agent, World
from vectorizedmultiagentsimulator_tpu_torch.dynamics import (
    DiffDrive,
    HolonomicWithRotation,
)
from vectorizedmultiagentsimulator_tpu_torch.scenario import BaseScenario
from vectorizedmultiagentsimulator_tpu_torch.utils import ScenarioUtils


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        self.plot_grid = True
        self.n_agents = kwargs.pop("n_agents", 2)
        ScenarioUtils.check_kwargs_consumed(kwargs)

        world = World(batch_dim, device, substeps=10)
        for i in range(self.n_agents):
            if i == 0:
                agent = Agent(
                    name=f"diff_drive_{i}",
                    collide=True,
                    render_action=True,
                    u_range=[1, 1],
                    u_multiplier=[1, 1],
                    dynamics=DiffDrive(world, integration="rk4"),
                )
            else:
                agent = Agent(
                    name=f"holo_rot_{i}",
                    collide=True,
                    render_action=True,
                    u_range=[1, 1, 1],
                    u_multiplier=[1, 1, 0.001],
                    dynamics=HolonomicWithRotation(),
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

    def observation(self, agent):
        return torch.cat([agent.state.pos, agent.state.vel], dim=-1)

    def extra_render(self, env_index: int = 0):
        return [
            ScenarioUtils.plot_entity_rotation(agent, env_index, length=0.1)
            for agent in self.world.agents
        ]
