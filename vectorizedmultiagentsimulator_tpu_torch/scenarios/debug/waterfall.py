"""Debug waterfall (reference ``vmas/scenarios/debug/waterfall.py``).

A chain of agents linked by collidable joints falls through tilted boxes
onto a floor line: the joint-system stress scene (substeps=5,
collision_force=500).  It always steps through the plain version: its
weighted pair cost x substeps is over the kernel's guard, and the last
joint's ends do not rotate and infer their fixed rotation per env
(``ops/physics_cuda.step_supported``).
"""
import math

import torch

from vectorizedmultiagentsimulator_tpu_torch.core import (
    Agent,
    Box,
    Joint,
    Landmark,
    Line,
    Sphere,
    World,
)
from vectorizedmultiagentsimulator_tpu_torch.scenario import BaseScenario
from vectorizedmultiagentsimulator_tpu_torch.utils import Color, ScenarioUtils


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        self.n_agents = kwargs.pop("n_agents", 5)
        self.with_joints = kwargs.pop("joints", True)
        ScenarioUtils.check_kwargs_consumed(kwargs)

        self.agent_dist = 0.1
        self.agent_radius = 0.04

        world = World(
            batch_dim, device, dt=0.1, drag=0.25, substeps=5,
            collision_force=500,
        )
        for i in range(self.n_agents):
            world.add_agent(
                Agent(
                    name=f"agent_{i}",
                    shape=Sphere(radius=self.agent_radius),
                    u_multiplier=0.7,
                    rotatable=True,
                )
            )
        self._joined = []
        if self.with_joints:
            for i in range(self.n_agents - 1):
                world.add_joint(
                    Joint(
                        world.agents[i],
                        world.agents[i + 1],
                        anchor_a=(1, 0),
                        anchor_b=(-1, 0),
                        dist=self.agent_dist,
                        rotate_a=True,
                        rotate_b=True,
                        collidable=True,
                        width=0,
                        mass=1,
                    )
                )
            landmark = Landmark(
                name="joined landmark",
                collide=True,
                movable=True,
                rotatable=True,
                shape=Box(length=self.agent_radius * 2, width=0.3),
                color=Color.GREEN,
            )
            world.add_landmark(landmark)
            self._joined.append(landmark)
            world.add_joint(
                Joint(
                    world.agents[-1],
                    landmark,
                    anchor_a=(1, 0),
                    anchor_b=(-1, 0),
                    dist=self.agent_dist,
                    rotate_a=False,
                    rotate_b=False,
                    collidable=True,
                    width=0,
                    mass=1,
                )
            )
        self._boxes = []
        for i in range(5):
            box = Landmark(
                name=f"landmark {i}",
                collide=True,
                movable=True,
                rotatable=True,
                shape=Box(length=0.3, width=0.1),
                color=Color.RED,
            )
            world.add_landmark(box)
            self._boxes.append(box)
        self._floor = Landmark(
            name="floor",
            collide=True,
            movable=False,
            shape=Line(length=2),
            color=Color.BLACK,
        )
        world.add_landmark(self._floor)
        return world

    def reset_world_at(self, env_index=None):
        dev = self.world.device

        def point(x, y):
            # A [1, 2] tensor made on the device, not copied from the host.
            return torch.cat([torch.full((1, 1), float(x), device=dev),
                              torch.full((1, 1), float(y), device=dev)], 1)

        for i, agent in enumerate(self.world.agents + self._joined):
            agent.set_pos(
                point(-0.2 + (self.agent_dist + 2 * self.agent_radius) * i, 1.0),
                batch_index=env_index,
            )
        for i, box in enumerate(self._boxes):
            box.set_pos(point(0.2 if i % 2 else -0.2, 0.6 - 0.3 * i),
                        batch_index=env_index)
            box.set_rot(
                torch.full((1,), math.pi / 4 if i % 2 else -math.pi / 4,
                           device=dev),
                batch_index=env_index,
            )
        self._floor.set_pos(point(0.0, -1.0), batch_index=env_index)

    def reward(self, agent):
        return -torch.linalg.norm(
            agent.state.pos - self._floor.state.pos, dim=1
        )

    def observation(self, agent):
        return torch.cat(
            [agent.state.pos, agent.state.vel]
            + [
                landmark.state.pos - agent.state.pos
                for landmark in self.world.landmarks
            ],
            dim=-1,
        )
