"""Debug kinematic_bicycle (reference
``vmas/scenarios/debug/kinematic_bicycle.py``).

The first agent is a box with kinematic-bicycle dynamics (speed and
steering actions, Euler integration); the others are boxes with
holonomic-with-rotation dynamics.  The boxes collide (the physics kernel's
box-box class, 10 substeps).  Zero reward.
"""
import math

import torch

from vectorizedmultiagentsimulator_tpu_torch.core import Agent, Box, World
from vectorizedmultiagentsimulator_tpu_torch.dynamics import (
    HolonomicWithRotation,
    KinematicBicycle,
)
from vectorizedmultiagentsimulator_tpu_torch.scenario import BaseScenario
from vectorizedmultiagentsimulator_tpu_torch.utils import ScenarioUtils


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        self.n_agents = kwargs.pop("n_agents", 2)
        width = kwargs.pop("width", 0.1)
        l_f = kwargs.pop("l_f", 0.1)
        l_r = kwargs.pop("l_r", 0.1)
        max_steering_angle = kwargs.pop(
            "max_steering_angle", math.radians(30.0)
        )
        max_speed = kwargs.pop("max_speed", 1.0)
        ScenarioUtils.check_kwargs_consumed(kwargs)

        world = World(batch_dim, device, substeps=10, collision_force=500)
        for i in range(self.n_agents):
            if i == 0:
                agent = Agent(
                    name=f"bicycle_{i}",
                    shape=Box(length=l_f + l_r, width=width),
                    collide=True,
                    render_action=True,
                    u_range=[max_speed, max_steering_angle],
                    u_multiplier=[1, 1],
                    max_speed=max_speed,
                    dynamics=KinematicBicycle(
                        world,
                        width=width,
                        l_f=l_f,
                        l_r=l_r,
                        max_steering_angle=max_steering_angle,
                        integration="euler",
                    ),
                )
            else:
                agent = Agent(
                    name=f"holo_rot_{i}",
                    shape=Box(length=l_f + l_r, width=width),
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
        return torch.zeros(
            (self.world.batch_dim,), dtype=torch.float32,
            device=self.world.device,
        )

    def observation(self, agent):
        return torch.cat([agent.state.pos, agent.state.vel], dim=-1)

    def extra_render(self, env_index: int = 0):
        return [
            ScenarioUtils.plot_entity_rotation(agent, env_index, length=0.1)
            for agent in self.world.agents
        ]
