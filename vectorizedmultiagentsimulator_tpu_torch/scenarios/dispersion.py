"""Dispersion scenario (reference ``vmas/scenarios/dispersion.py``).

n agents spawn at the origin and must spread out to eat n food landmarks.
The per-landmark buffers (``eaten``, ``just_eaten``, ``how_many_on_food``)
are tensors stored on the entities (``state.extras``); the reference's
per-env branching is written with ``where`` masks, as in the JAX package.
``is_rendering`` (an eaten food is no longer drawn) is kept as that package
keeps it, so its state loads here as it is and a frame leaves eaten food
out.
"""
import torch

from vectorizedmultiagentsimulator_tpu_torch.core import (
    Agent,
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
        self.share_reward = kwargs.pop("share_reward", False)
        self.penalise_by_time = kwargs.pop("penalise_by_time", False)
        self.food_radius = kwargs.pop("food_radius", 0.05)
        self.pos_range = kwargs.pop("pos_range", 1.0)
        n_food = kwargs.pop("n_food", n_agents)
        ScenarioUtils.check_kwargs_consumed(kwargs)

        world = World(
            batch_dim,
            device,
            x_semidim=self.pos_range,
            y_semidim=self.pos_range,
        )
        for i in range(n_agents):
            world.add_agent(
                Agent(
                    name=f"agent_{i}",
                    collide=False,
                    shape=Sphere(radius=0.035),
                )
            )
        for i in range(n_food):
            world.add_landmark(
                Landmark(
                    name=f"food_{i}",
                    collide=False,
                    shape=Sphere(radius=self.food_radius),
                    color=Color.GREEN,
                )
            )
        return world

    def reset_world_at(self, env_index=None):
        B = self.world.batch_dim
        dev = self.world.device
        for agent in self.world.agents:
            agent.set_pos(
                torch.zeros((self.world.dim_p,), device=dev),
                batch_index=env_index,
            )
        for landmark in self.world.landmarks:
            pos = (
                torch.rand(
                    (B, self.world.dim_p),
                    generator=self.world.generator,
                    device=dev,
                )
                * (2 * self.pos_range)
                - self.pos_range
            )
            landmark.set_pos(pos, batch_index=env_index)
            if env_index is None:
                landmark.eaten = torch.zeros((B,), dtype=torch.bool, device=dev)
                landmark.just_eaten = torch.zeros(
                    (B,), dtype=torch.bool, device=dev
                )
                # Written by reward(); created here with the other buffers.
                landmark.how_many_on_food = torch.zeros(
                    (B,), dtype=torch.int32, device=dev
                )
                landmark.reset_render()
            else:
                landmark.eaten = TorchUtils.where_from_index(
                    env_index, torch.zeros_like(landmark.eaten), landmark.eaten
                )
                landmark.just_eaten = TorchUtils.where_from_index(
                    env_index,
                    torch.zeros_like(landmark.just_eaten),
                    landmark.just_eaten,
                )
                landmark.is_rendering = TorchUtils.where_from_index(
                    env_index,
                    torch.ones_like(landmark.is_rendering),
                    landmark.is_rendering,
                )

    def reward(self, agent):
        is_first = agent is self.world.agents[0]
        is_last = agent is self.world.agents[-1]
        rews = torch.zeros((self.world.batch_dim,), device=self.world.device)

        for landmark in self.world.landmarks:
            if is_first:
                on_food_count = torch.stack(
                    [
                        torch.linalg.norm(
                            a.state.pos - landmark.state.pos, dim=1
                        )
                        < a.shape.radius + landmark.shape.radius
                        for a in self.world.agents
                    ],
                    dim=1,
                ).sum(dim=-1)
                landmark.how_many_on_food = on_food_count.to(torch.int32)
                landmark.just_eaten = landmark.just_eaten | (on_food_count > 0)

            if self.share_reward:
                rews = rews + (landmark.just_eaten & ~landmark.eaten).to(
                    torch.float32
                )
            else:
                on_food = (
                    torch.linalg.norm(
                        agent.state.pos - landmark.state.pos, dim=1
                    )
                    < agent.shape.radius + landmark.shape.radius
                )
                count = landmark.how_many_on_food.to(torch.float32)
                eating_rew = torch.where(
                    count > 0,
                    1.0 / torch.clamp_min(count, 1),
                    torch.zeros_like(count),
                )
                rews = rews + torch.where(
                    on_food & ~landmark.eaten,
                    eating_rew,
                    torch.zeros_like(eating_rew),
                )

            if is_last:
                landmark.eaten = landmark.eaten | landmark.just_eaten
                landmark.just_eaten = torch.zeros_like(landmark.just_eaten)
                landmark.is_rendering = landmark.is_rendering & ~landmark.eaten

        if self.penalise_by_time:
            rews = torch.where(rews == 0, torch.full_like(rews, -0.01), rews)
        return rews

    def observation(self, agent):
        obs = []
        for landmark in self.world.landmarks:
            obs.append(landmark.state.pos - agent.state.pos)
            obs.append(landmark.eaten[:, None].to(torch.float32))
        return torch.cat([agent.state.pos, agent.state.vel, *obs], dim=-1)

    def done(self):
        return torch.all(
            torch.stack(
                [landmark.eaten for landmark in self.world.landmarks], dim=1
            ),
            dim=-1,
        )
