"""Debug asym_joint (reference ``vmas/scenarios/debug/asym_joint.py``).

Two agents joined by a joint of length ``joint_length`` (optionally with an
asymmetric heavy mass attached along the joint) must rotate the joint to
the goal angle (pi/2); rotation-shaping + energy rewards.  The smallest
joint world: 2 agents, the joint's line and the mass, 3 constraints, 10
substeps.

As in the JAX package, the reference's per-reset ``randperm`` of the
agents' endpoints (asym_joint.py:191-193) is a per-env random sign.
"""
import math

import torch

from vectorizedmultiagentsimulator_tpu_torch.core import (
    Agent,
    Joint,
    Landmark,
    Sphere,
    World,
)
from vectorizedmultiagentsimulator_tpu_torch.scenario import BaseScenario
from vectorizedmultiagentsimulator_tpu_torch.scenarios.joint_passage import (
    angle_to_vector,
    get_line_angle_dist_0_180,
)
from vectorizedmultiagentsimulator_tpu_torch.utils import (
    Color,
    ScenarioUtils,
    TorchUtils,
)


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        self.joint_length = kwargs.pop("joint_length", 0.5)
        self.random_start_angle = kwargs.pop("random_start_angle", False)
        self.observe_joint_angle = kwargs.pop("observe_joint_angle", False)
        self.joint_angle_obs_noise = kwargs.pop("joint_angle_obs_noise", 0.0)
        self.asym_package = kwargs.pop("asym_package", True)
        self.mass_ratio = kwargs.pop("mass_ratio", 5)
        self.mass_position = kwargs.pop("mass_position", 0.75)
        self.max_speed_1 = kwargs.pop("max_speed_1", None)
        self.obs_noise = kwargs.pop("obs_noise", 0.2)
        self.rot_shaping_factor = kwargs.pop("rot_shaping_factor", 1)
        self.energy_reward_coeff = kwargs.pop("energy_reward_coeff", 0.08)
        ScenarioUtils.check_kwargs_consumed(kwargs)

        world = World(
            batch_dim,
            device,
            substeps=7 if not self.asym_package else 10,
            joint_force=900 if self.asym_package else 400,
            drag=0.25 if not self.asym_package else 0.15,
        )

        if not self.observe_joint_angle:
            assert self.joint_angle_obs_noise == 0

        self.goal_angle = math.pi / 2
        self.n_agents = 2
        self.agent_radius = 0.03333
        self.mass_radius = self.agent_radius * (2 / 3)

        world.add_agent(
            Agent(
                name="agent 0",
                shape=Sphere(self.agent_radius),
                u_multiplier=0.8,
                obs_noise=self.obs_noise,
                render_action=True,
            )
        )
        world.add_agent(
            Agent(
                name="agent 1",
                shape=Sphere(self.agent_radius),
                u_multiplier=0.8,
                mass=1 if self.asym_package else self.mass_ratio,
                max_speed=self.max_speed_1,
                obs_noise=self.obs_noise,
                render_action=True,
            )
        )

        self._joint = Joint(
            world.agents[0],
            world.agents[1],
            anchor_a=(0, 0),
            anchor_b=(0, 0),
            dist=self.joint_length,
            rotate_a=True,
            rotate_b=True,
            collidable=False,
            width=0,
            mass=1,
        )
        world.add_joint(self._joint)

        if self.asym_package:

            def mass_collision_filter(e):
                return not isinstance(e.shape, Sphere)

            self._mass = Landmark(
                name="mass",
                shape=Sphere(radius=self.mass_radius),
                collide=False,
                movable=True,
                color=Color.BLACK,
                mass=self.mass_ratio,
                collision_filter=mass_collision_filter,
            )
            world.add_landmark(self._mass)
            world.add_joint(
                Joint(
                    self._mass,
                    self._joint.landmark,
                    anchor_a=(0, 0),
                    anchor_b=(self.mass_position, 0),
                    dist=0,
                    rotate_a=True,
                    rotate_b=True,
                )
            )
        return world

    @property
    def joint(self):
        return self._joint

    def reset_world_at(self, env_index=None):
        B = self.world.batch_dim
        dev = self.world.device
        g = self.world.generator
        if self.random_start_angle:
            start_angle = (
                torch.rand((B, 1), generator=g, device=dev) - 0.5
            ) * math.pi
        else:
            start_angle = torch.zeros((B, 1), device=dev)

        delta = (self.joint_length / 2) * torch.cat(
            [torch.cos(start_angle), torch.sin(start_angle)], dim=1
        )
        joint_pos = torch.zeros((B, 2), device=dev)
        # Per-env endpoint swap (see module docstring).
        sign = torch.where(
            torch.rand((B, 1), generator=g, device=dev) < 0.5, 1.0, -1.0
        )
        self.world.agents[0].set_pos(
            joint_pos - sign * delta, batch_index=env_index
        )
        self.world.agents[1].set_pos(
            joint_pos + sign * delta, batch_index=env_index
        )
        if self.asym_package:
            self._mass.set_pos(
                joint_pos + self.mass_position * delta * sign,
                batch_index=env_index,
            )

        rot_shaping = (
            get_line_angle_dist_0_180(
                self._joint.landmark.state.rot, self.goal_angle
            )
            * self.rot_shaping_factor
        )
        if env_index is None:
            self.rot_shaping_pre = rot_shaping
            self.rot_rew = torch.zeros((B,), device=dev)
            self.energy_rew = torch.zeros((B,), device=dev)
            self.energy_expenditure = torch.zeros((B,), device=dev)
            self.rew = torch.zeros((B,), device=dev)
        else:
            self.rot_shaping_pre = TorchUtils.where_from_index(
                env_index, rot_shaping, self.rot_shaping_pre
            )

    def reward(self, agent):
        is_first = agent is self.world.agents[0]
        if is_first:
            joint_dist_to_90_rot = get_line_angle_dist_0_180(
                self._joint.landmark.state.rot, self.goal_angle
            )
            joint_shaping = joint_dist_to_90_rot * self.rot_shaping_factor
            self.rot_rew = self.rot_shaping_pre - joint_shaping
            self.rot_shaping_pre = joint_shaping

            self.energy_expenditure = torch.sum(
                torch.stack(
                    [
                        torch.linalg.norm(a.action.u, dim=-1)
                        / math.sqrt(
                            self.world.dim_p
                            * ((a.u_range * a.u_multiplier) ** 2)
                        )
                        for a in self.world.agents
                    ],
                    dim=1,
                ),
                dim=-1,
            )
            self.energy_rew = -self.energy_expenditure * self.energy_reward_coeff
            self.rew = self.rot_rew + self.energy_rew
        return self.rew

    def observation(self, agent):
        B = self.world.batch_dim
        dev = self.world.device
        g = self.world.generator
        observations = [agent.state.pos, agent.state.vel]
        if self.observe_joint_angle:
            joint_angle = self._joint.landmark.state.rot
            if self.joint_angle_obs_noise:
                joint_angle = (
                    joint_angle
                    + torch.randn((B, 1), generator=g, device=dev)
                    * self.joint_angle_obs_noise
                )
            observations.append(angle_to_vector(joint_angle))
        if self.obs_noise > 0:
            observations = [
                obs
                + (torch.rand(obs.shape, generator=g, device=dev) * 2 - 1)
                * self.obs_noise
                for obs in observations
            ]
        return torch.cat(observations, dim=-1)

    def done(self):
        return torch.all(
            get_line_angle_dist_0_180(
                self._joint.landmark.state.rot, self.goal_angle
            )[..., None]
            <= 0.01,
            dim=1,
        )

    def info(self, agent):
        return {"rot_rew": self.rot_rew, "energy_rew": self.energy_rew}

    def extra_render(self, env_index: int = 0):
        from vectorizedmultiagentsimulator_tpu_torch import render as rendering

        origin = rendering.make_circle(0.01)
        xform = rendering.Transform()
        origin.add_attr(xform)
        xform.set_translation(0, 0)
        origin.set_color(*Color.GREEN.value)
        return [origin]
