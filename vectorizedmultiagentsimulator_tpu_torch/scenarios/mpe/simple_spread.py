"""MPE simple_spread (reference ``vmas/scenarios/mpe/simple_spread.py``).

N agents cover N landmarks; reward is -(sum over landmarks of min agent
distance), with a -1 collision penalty per overlapping agent pair.  This is
the reference's baseline workload (100 steps x 30k envs).
"""
import torch

from vectorizedmultiagentsimulator_tpu_torch.core import Agent, Landmark, Sphere, World
from vectorizedmultiagentsimulator_tpu_torch.scenario import BaseScenario
from vectorizedmultiagentsimulator_tpu_torch.utils import Color, ScenarioUtils


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        num_agents = kwargs.pop("n_agents", 3)
        obs_agents = kwargs.pop("obs_agents", True)
        ScenarioUtils.check_kwargs_consumed(kwargs)
        self.obs_agents = obs_agents

        world = World(batch_dim=batch_dim, device=device)
        for i in range(num_agents):
            world.add_agent(
                Agent(
                    name=f"agent_{i}",
                    collide=True,
                    shape=Sphere(radius=0.15),
                    color=Color.BLUE,
                )
            )
        for i in range(num_agents):
            world.add_landmark(
                Landmark(
                    name=f"landmark {i}",
                    collide=False,
                    color=Color.BLACK,
                )
            )
        return world

    def reset_world_at(self, env_index=None):
        B = self.world.batch_dim
        for entity in self.world.agents + self.world.landmarks:
            pos = torch.rand(
                (B, self.world.dim_p),
                generator=self.world.generator,
                device=self.world.device,
            ) * 2 - 1
            entity.set_pos(pos, batch_index=env_index)
        if env_index is None:
            self.rew = torch.zeros((B,), device=self.world.device)

    def reward(self, agent):
        is_first = agent is self.world.agents[0]
        if is_first:
            agent_pos = torch.stack(
                [a.state.pos for a in self.world.agents], dim=1
            )  # [B, A, 2]
            landmark_pos = torch.stack(
                [l.state.pos for l in self.world.landmarks], dim=1
            )  # [B, L, 2]
            dists = torch.linalg.norm(
                agent_pos[:, :, None, :] - landmark_pos[:, None, :, :], dim=-1
            )  # [B, A, L]
            closest = torch.min(dists, dim=1).values  # [B, L]
            rew = -closest.sum(dim=-1) * len(self.world.agents)
            # collision penalty: -1 per ordered overlapping pair
            for single_agent in self.world.agents:
                if single_agent.collide:
                    for a in self.world.agents:
                        if a is not single_agent:
                            rew = rew - self.world.is_overlapping(
                                a, single_agent
                            ).to(torch.float32)
            self.rew = rew
        return self.rew

    def observation(self, agent):
        landmark_pos = [
            landmark.state.pos - agent.state.pos
            for landmark in self.world.landmarks
        ]
        other_pos = [
            other.state.pos - agent.state.pos
            for other in self.world.agents
            if other is not agent
        ]
        return torch.cat(
            [
                agent.state.pos,
                agent.state.vel,
                *landmark_pos,
                *(other_pos if self.obs_agents else []),
            ],
            dim=-1,
        )
