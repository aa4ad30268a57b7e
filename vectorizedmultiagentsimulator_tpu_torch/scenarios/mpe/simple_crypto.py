"""MPE simple_crypto (reference ``vmas/scenarios/mpe/simple_crypto.py``).

Alice (the speaker) must communicate a binary secret to Bob through a
shared binary key while Eve (the adversary) eavesdrops.  All agents are
immovable and do not collide; the task is communication alone (dim_c 4 by
default).  The key and the secret are per-env draws at every reset, kept
in extras.
"""
import torch

from vectorizedmultiagentsimulator_tpu_torch.core import Agent, World
from vectorizedmultiagentsimulator_tpu_torch.scenario import BaseScenario
from vectorizedmultiagentsimulator_tpu_torch.utils import (
    Color,
    ScenarioUtils,
    TorchUtils,
)


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        dim_c = kwargs.pop("dim_c", 4)
        ScenarioUtils.check_kwargs_consumed(kwargs)
        assert dim_c > 0
        self._dim_c = dim_c

        world = World(batch_dim, device, dim_c=dim_c)
        num_agents = 3
        num_adversaries = 1
        for i in range(num_agents):
            adversary = i < num_adversaries
            speaker = i == 2
            agent = Agent(
                name=(
                    "eve_0" if adversary else ("alice_0" if speaker else "bob_0")
                ),
                collide=False,
                movable=False,
                color=(
                    Color.RED
                    if adversary
                    else (Color.GREEN if speaker else Color.BLUE)
                ),
                adversary=adversary,
                silent=False,
            )
            agent.speaker = speaker
            world.add_agent(agent)
        return world

    def reset_world_at(self, env_index=None):
        B = self.world.batch_dim
        g, dev = self.world.generator, self.world.device
        key = torch.randint(0, 2, (B, self._dim_c), generator=g,
                            device=dev).to(torch.float32)
        secret = torch.randint(0, 2, (B, self._dim_c), generator=g,
                               device=dev).to(torch.float32)
        if env_index is None:
            self.key = key
            self.secret = secret
            for agent in self.world.agents:
                agent.set_pos(
                    ScenarioUtils.uniform_in_bounds(self.world, -1.0, 1.0),
                    batch_index=env_index,
                )
        else:
            self.key = TorchUtils.where_from_index(env_index, key, self.key)
            self.secret = TorchUtils.where_from_index(
                env_index, secret, self.secret
            )

    def good_listeners(self):
        return [
            a for a in self.world.agents if not a.adversary and not a.speaker
        ]

    def good_agents(self):
        return [a for a in self.world.agents if not a.adversary]

    def adversaries(self):
        return [a for a in self.world.agents if a.adversary]

    def reward(self, agent):
        return (
            self.adversary_reward(agent)
            if agent.adversary
            else self.agent_reward(agent)
        )

    def _comm_error(self, a):
        """-(c - secret)^2 summed, 0 while the comms are all zero
        (simple_crypto.py:119-146)."""
        zero_comms = torch.all(a.state.c == 0.0, dim=-1)
        err = torch.sum(torch.square(a.state.c - self.secret), dim=-1)
        return torch.where(zero_comms, 0.0, err)

    def agent_reward(self, agent):
        good_rew = -sum(self._comm_error(a) for a in self.good_listeners())
        adv_rew = sum(self._comm_error(a) for a in self.adversaries())
        return adv_rew + good_rew

    def adversary_reward(self, agent):
        return -self._comm_error(agent)

    def observation(self, agent):
        comm = [
            other.state.c
            for other in self.world.agents
            if other is not agent and other.speaker
        ]
        if agent.speaker:
            return torch.cat([self.secret, self.key], dim=-1)
        if not agent.adversary:
            return torch.cat([self.key, *comm], dim=-1)
        return torch.cat([*comm], dim=-1)
