"""MPE simple_speaker_listener (reference
``vmas/scenarios/mpe/simple_speaker_listener.py``).

An immovable speaker (dim_c=3, silent=False) observes the colour of the
listener's goal landmark and must communicate it; the movable, silent
listener is rewarded for reaching the goal.  As in the JAX package, a
per-env ``goal_index`` tensor takes the place of the reference's one
random goal for the whole batch; it is drawn at a full reset only.
"""
import torch

from vectorizedmultiagentsimulator_tpu_torch.core import (
    Agent,
    Landmark,
    Sphere,
    World,
)
from vectorizedmultiagentsimulator_tpu_torch.scenario import BaseScenario
from vectorizedmultiagentsimulator_tpu_torch.scenarios.mpe import (
    select_landmark,
)
from vectorizedmultiagentsimulator_tpu_torch.utils import ScenarioUtils

_LANDMARK_COLORS = (
    (0.65, 0.15, 0.15),
    (0.15, 0.65, 0.15),
    (0.15, 0.15, 0.65),
)


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        ScenarioUtils.check_kwargs_consumed(kwargs)
        world = World(batch_dim, device, dim_c=3)
        for i in range(2):
            speaker = i == 0
            world.add_agent(
                Agent(
                    name="speaker_0" if speaker else "listener_0",
                    collide=False,
                    movable=not speaker,
                    silent=not speaker,
                    shape=Sphere(radius=0.075),
                )
            )
        for i in range(3):
            world.add_landmark(
                Landmark(
                    name=f"landmark {i}",
                    collide=False,
                    shape=Sphere(radius=0.04),
                    color=_LANDMARK_COLORS[i],
                )
            )
        self._colors = torch.tensor(_LANDMARK_COLORS, device=world.device)
        return world

    def _goal_pos(self):
        return select_landmark(self.world.landmarks, self.goal_index)

    def reset_world_at(self, env_index=None):
        B = self.world.batch_dim
        dev = self.world.device
        g = self.world.generator
        if env_index is None:
            self.goal_index = torch.randint(
                0, len(self.world.landmarks), (B,), generator=g, device=dev
            )
            self.rew = torch.zeros((B,), device=dev)
        for entity in self.world.agents + self.world.landmarks:
            pos = torch.rand((B, self.world.dim_p), generator=g, device=dev)
            entity.set_pos(pos * 2 - 1, batch_index=env_index)

    def reward(self, agent):
        is_first = agent is self.world.agents[0]
        if is_first:
            listener = self.world.agents[1]
            dist = torch.linalg.norm(
                listener.state.pos - self._goal_pos(), dim=-1
            )
            # The reference sums the same term once per agent.
            self.rew = -dist * len(self.world.agents)
        return self.rew

    def observation(self, agent):
        if not agent.movable:  # speaker
            return self._colors[self.goal_index]
        entity_pos = [
            entity.state.pos - agent.state.pos
            for entity in self.world.landmarks
        ]
        comm = [
            other.state.c
            for other in self.world.agents
            if other is not agent and other.state.c is not None
        ]
        return torch.cat([agent.state.vel, *entity_pos, *comm], dim=-1)
