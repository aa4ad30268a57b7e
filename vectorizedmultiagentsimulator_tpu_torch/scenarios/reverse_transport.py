"""Reverse_transport scenario (reference
``vmas/scenarios/reverse_transport.py``).

Agents spawn inside a hollow, heavy box package and must push it from
within onto the goal: the hollow-box contacts of the physics kernel
(contact_margin 6e-3, 5 substeps, collision_force 500).
"""
import torch

from vectorizedmultiagentsimulator_tpu_torch.core import (
    Agent,
    Box,
    Landmark,
    Sphere,
    World,
)
from vectorizedmultiagentsimulator_tpu_torch.scenario import BaseScenario
from vectorizedmultiagentsimulator_tpu_torch.utils import (
    Color,
    ScenarioUtils,
    TorchUtils,
)


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        n_agents = kwargs.pop("n_agents", 4)
        self.package_width = kwargs.pop("package_width", 0.6)
        self.package_length = kwargs.pop("package_length", 0.6)
        self.package_mass = kwargs.pop("package_mass", 50)
        ScenarioUtils.check_kwargs_consumed(kwargs)

        self.shaping_factor = 100

        world = World(
            batch_dim, device, contact_margin=6e-3, substeps=5,
            collision_force=500,
        )
        for i in range(n_agents):
            world.add_agent(
                Agent(name=f"agent_{i}", shape=Sphere(0.03), u_multiplier=0.5)
            )
        goal = Landmark(
            name="goal",
            collide=False,
            shape=Sphere(radius=0.09),
            color=Color.LIGHT_GREEN,
        )
        world.add_landmark(goal)
        self._package = Landmark(
            name=f"package {n_agents - 1}",
            collide=True,
            movable=True,
            mass=self.package_mass,
            shape=Box(
                length=self.package_length,
                width=self.package_width,
                hollow=True,
            ),
            color=Color.RED,
        )
        self._package.goal = goal
        world.add_landmark(self._package)
        return world

    @property
    def package(self):
        return self._package

    def reset_world_at(self, env_index=None):
        B = self.world.batch_dim
        dev = self.world.device
        package = self._package
        package_pos = ScenarioUtils.uniform_in_bounds(self.world, -1.0, 1.0)
        package.set_pos(package_pos, batch_index=env_index)
        for agent in self.world.agents:
            r = agent.shape.radius
            rel = torch.cat(
                [
                    ScenarioUtils.uniform_in_bounds(
                        self.world, -self.package_length / 2 + r,
                        self.package_length / 2 - r, (1,)),
                    ScenarioUtils.uniform_in_bounds(
                        self.world, -self.package_width / 2 + r,
                        self.package_width / 2 - r, (1,)),
                ],
                dim=1,
            )
            agent.set_pos(rel + package_pos, batch_index=env_index)
        package.goal.set_pos(
            ScenarioUtils.uniform_in_bounds(self.world, -1.0, 1.0),
            batch_index=env_index,
        )
        global_shaping = (
            torch.linalg.norm(
                package.state.pos - package.goal.state.pos, dim=1
            )
            * self.shaping_factor
        )
        if env_index is None:
            package.global_shaping = global_shaping
            package.on_goal = torch.zeros((B,), dtype=torch.bool, device=dev)
            package.dist_to_goal = torch.zeros((B,), device=dev)
            self.rew = torch.zeros((B,), device=dev)
        else:
            package.global_shaping = TorchUtils.where_from_index(
                env_index, global_shaping, package.global_shaping
            )
            package.on_goal = TorchUtils.where_from_index(
                env_index, torch.zeros_like(package.on_goal), package.on_goal
            )

    def reward(self, agent):
        is_first = agent is self.world.agents[0]
        if is_first:
            package = self._package
            package.dist_to_goal = torch.linalg.norm(
                package.state.pos - package.goal.state.pos, dim=1
            )
            package.on_goal = self.world.is_overlapping(package, package.goal)
            package_shaping = package.dist_to_goal * self.shaping_factor
            # The reference applies the shaping delta twice (the block is
            # repeated, reverse_transport.py:171-183); so does the port.
            rew = torch.where(
                package.on_goal, 0.0, package.global_shaping - package_shaping
            )
            package.global_shaping = package_shaping
            rew = rew + torch.where(
                package.on_goal, 0.0, package.global_shaping - package_shaping
            )
            self.rew = rew
        return self.rew

    def observation(self, agent):
        package = self._package
        return torch.cat(
            [
                agent.state.pos,
                agent.state.vel,
                package.state.vel,
                package.state.pos - agent.state.pos,
                package.state.pos - package.goal.state.pos,
            ],
            dim=-1,
        )

    def done(self):
        return self._package.on_goal
