"""Ball_trajectory scenario (reference ``vmas/scenarios/ball_trajectory.py``).

Two agents (optionally joined to the ball) must keep a ball moving along a
circular trajectory at a desired speed.  With joints (the default): 15
substeps, joint_force 900, collision_force 1500.

As in the JAX package, the reference's per-reset ``randperm`` of the
agents' endpoints (ball_trajectory.py:103-106) is a per-env random sign.
"""
import torch

from vectorizedmultiagentsimulator_tpu_torch.core import (
    Agent,
    Joint,
    Landmark,
    Sphere,
    World,
)
from vectorizedmultiagentsimulator_tpu_torch.scenario import BaseScenario
from vectorizedmultiagentsimulator_tpu_torch.utils import (
    Color,
    JOINT_FORCE,
    ScenarioUtils,
    TorchUtils,
    X,
)


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        self.pos_shaping_factor = kwargs.pop("pos_shaping_factor", 0)
        self.speed_shaping_factor = kwargs.pop("speed_shaping_factor", 1)
        self.dist_shaping_factor = kwargs.pop("dist_shaping_factor", 0)
        self.joints = kwargs.pop("joints", True)
        ScenarioUtils.check_kwargs_consumed(kwargs)

        self.n_agents = 2
        self.desired_speed = 1
        self.desired_radius = 0.5
        self.agent_spacing = 0.4
        self.agent_radius = 0.03
        self.ball_radius = 2 * self.agent_radius

        world = World(
            batch_dim,
            device,
            substeps=15 if self.joints else 5,
            joint_force=900 if self.joints else JOINT_FORCE,
            collision_force=1500 if self.joints else 400,
            drag=0,
        )
        world.add_agent(
            Agent(name="agent_0", shape=Sphere(self.agent_radius), drag=0.25)
        )
        world.add_agent(
            Agent(name="agent_1", shape=Sphere(self.agent_radius), drag=0.25)
        )
        self._ball = Landmark(
            name="ball",
            shape=Sphere(radius=self.ball_radius),
            collide=True,
            movable=True,
            linear_friction=0.04,
        )
        world.add_landmark(self._ball)
        if self.joints:
            for i in range(self.n_agents):
                world.add_joint(
                    Joint(
                        world.agents[i],
                        self._ball,
                        anchor_a=(0, 0),
                        anchor_b=(0, 0),
                        dist=self.agent_spacing / 2,
                        rotate_a=True,
                        rotate_b=True,
                        collidable=False,
                        width=0,
                        mass=1,
                    )
                )
        return world

    @property
    def ball(self):
        return self._ball

    def get_closest_point_circle(self, pos):
        pos_norm = torch.linalg.norm(pos, dim=1)
        normalized = (
            pos / torch.clamp_min(pos_norm, 1e-12)[:, None] * self.desired_radius
        )
        return torch.where(pos_norm[:, None] > 0, normalized, 0.0)

    def _shapings(self):
        pos_shaping = (
            torch.linalg.norm(
                self._ball.state.pos
                - self.get_closest_point_circle(self._ball.state.pos),
                dim=1,
            )
            ** 0.5
            * self.pos_shaping_factor
        )
        speed_shaping = (
            torch.abs(
                self.desired_speed
                - torch.linalg.norm(self._ball.state.vel, dim=1)
            )
            * self.speed_shaping_factor
        )
        dist_shaping = (
            torch.sum(
                torch.stack(
                    [
                        torch.linalg.norm(
                            a.state.pos - self._ball.state.pos, dim=1
                        )
                        for a in self.world.agents
                    ],
                    dim=1,
                ),
                dim=1,
            )
            * self.dist_shaping_factor
        )
        return pos_shaping, speed_shaping, dist_shaping

    def reset_world_at(self, env_index=None):
        B = self.world.batch_dim
        dev = self.world.device
        g = self.world.generator
        ball_pos = (
            torch.rand((B, self.world.dim_p), generator=g, device=dev) * 2 - 1
        ) * self.desired_radius
        self._ball.set_pos(ball_pos, batch_index=env_index)

        sign = torch.where(
            torch.rand((B,), generator=g, device=dev) < 0.5, 1.0, -1.0
        )
        for i, agent in enumerate(self.world.agents):
            shift = (self.agent_spacing / 2) * sign * (-1 if i == 0 else 1)
            agent_pos = torch.stack(
                [ball_pos[:, X] + shift, ball_pos[:, 1]], dim=1
            )
            agent.set_pos(agent_pos, batch_index=env_index)

        pos_shaping, speed_shaping, dist_shaping = self._shapings()
        if env_index is None:
            self.pos_shaping = pos_shaping
            self.speed_shaping = speed_shaping
            self.dist_shaping = dist_shaping
            self.pos_rew = torch.zeros((B,), device=dev)
            self.speed_rew = torch.zeros((B,), device=dev)
            self.dist_rew = torch.zeros((B,), device=dev)
        else:
            self.pos_shaping = TorchUtils.where_from_index(
                env_index, pos_shaping, self.pos_shaping
            )
            self.speed_shaping = TorchUtils.where_from_index(
                env_index, speed_shaping, self.speed_shaping
            )
            self.dist_shaping = TorchUtils.where_from_index(
                env_index, dist_shaping, self.dist_shaping
            )

    def reward(self, agent):
        pos_shaping, speed_shaping, dist_shaping = self._shapings()
        self.pos_rew = self.pos_shaping - pos_shaping
        self.pos_shaping = pos_shaping
        self.speed_rew = self.speed_shaping - speed_shaping
        self.speed_shaping = speed_shaping
        self.dist_rew = self.dist_shaping - dist_shaping
        self.dist_shaping = dist_shaping
        return self.pos_rew + self.speed_rew + self.dist_rew

    def observation(self, agent):
        return torch.cat(
            [
                agent.state.pos,
                agent.state.vel,
                agent.state.pos - self._ball.state.pos,
                agent.state.pos,
            ],
            dim=-1,
        )

    def info(self, agent):
        return {
            "pos_rew": self.pos_rew,
            "speed_rew": self.speed_rew,
            "dist_rew": self.dist_rew,
        }

    def extra_render(self, env_index: int = 0):
        from vectorizedmultiagentsimulator_tpu_torch import render as rendering

        circle = rendering.make_circle(self.desired_radius, filled=False)
        xform = rendering.Transform()
        circle.add_attr(xform)
        xform.set_translation(0, 0)
        circle.set_color(*Color.BLACK.value)
        return [circle]
