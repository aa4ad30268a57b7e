"""Debug pollock (reference ``vmas/scenarios/debug/pollock.py``).

The stress scene: 15 agents, 15 movable lines and 15 movable boxes, 5
substeps, optionally a 16-ray LIDAR on each agent (the reference's
LIDAR-consistency scene), measured in one launch a LIDAR group or, with
``vectorized_lidar=False``, one ray cast a ray.  At its defaults the
weighted pair cost x substeps is over the physics kernel's guard, so it
steps through the plain physics, as the JAX package's guard routes it
(``ops/physics_cuda.step_supported``).
"""
import torch

from vectorizedmultiagentsimulator_tpu_torch.core import (
    Agent,
    Box,
    Landmark,
    Line,
    Sphere,
    World,
)
from vectorizedmultiagentsimulator_tpu_torch.scenario import BaseScenario
from vectorizedmultiagentsimulator_tpu_torch.sensors import Lidar
from vectorizedmultiagentsimulator_tpu_torch.utils import Color, ScenarioUtils


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        self.n_agents = kwargs.pop("n_agents", 15)
        self.n_lines = kwargs.pop("n_lines", 15)
        self.n_boxes = kwargs.pop("n_boxes", 15)
        self.lidar = kwargs.pop("lidar", False)
        self.vectorized_lidar = kwargs.pop("vectorized_lidar", True)
        ScenarioUtils.check_kwargs_consumed(kwargs)

        self.agent_radius = 0.05
        self.line_length = 0.3
        self.box_length = 0.2
        self.box_width = 0.1
        self.world_semidim = 1
        self.min_dist_between_entities = 0.1

        world = World(
            batch_dim,
            device,
            dt=0.1,
            drag=0.25,
            substeps=5,
            collision_force=500,
            x_semidim=self.world_semidim,
            y_semidim=self.world_semidim,
        )
        for i in range(self.n_agents):
            world.add_agent(
                Agent(
                    name=f"agent_{i}",
                    shape=Sphere(radius=self.agent_radius),
                    u_multiplier=0.7,
                    rotatable=True,
                    sensors=(
                        [Lidar(world, n_rays=16, max_range=0.5)]
                        if self.lidar
                        else []
                    ),
                )
            )
        for i in range(self.n_lines):
            world.add_landmark(
                Landmark(
                    name=f"line {i}",
                    collide=True,
                    movable=True,
                    rotatable=True,
                    shape=Line(length=self.line_length),
                    color=Color.BLACK,
                )
            )
        for i in range(self.n_boxes):
            world.add_landmark(
                Landmark(
                    name=f"box {i}",
                    collide=True,
                    movable=True,
                    rotatable=True,
                    shape=Box(length=self.box_length, width=self.box_width),
                    color=Color.RED,
                )
            )
        return world

    def reset_world_at(self, env_index=None):
        ScenarioUtils.spawn_entities_randomly(
            self.world.agents + self.world.landmarks,
            self.world,
            env_index,
            self.min_dist_between_entities,
            (-self.world_semidim, self.world_semidim),
            (-self.world_semidim, self.world_semidim),
        )

    def reward(self, agent):
        return torch.zeros((self.world.batch_dim,), dtype=torch.float32,
                           device=self.world.device)

    def observation(self, agent):
        if not self.lidar:
            return torch.zeros((self.world.batch_dim, 1), dtype=torch.float32,
                               device=self.world.device)
        return agent.sensors[0].measure(vectorized=self.vectorized_lidar)
