"""Scenario API (reference ``vmas/simulator/scenario.py``).

Scenarios subclass :class:`BaseScenario` as in the JAX package:
``make_world / reset_world_at / observation / reward`` are compulsory;
``done / info / extra_render / process_action / pre_step / post_step``
optional; the viewer attributes (``viewer_size``, ``viewer_zoom``,
``render_origin``, ``plot_grid``, ``grid_spacing``, ``visualize_semidims``)
default as in the JAX package.
``env_index`` arrives as ``None`` for a full reset or as an int index /
boolean mask, which the entity setters consume directly.

Persistent scenario buffers are batch-leading tensors assigned onto
entities or ``self`` (e.g. ``self.rew = torch.zeros(B)``); they are stored
in ``state.extras`` under ``"scenario.<name>"`` and are created during
``reset_world_at(None)``.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Optional

import torch

from vectorizedmultiagentsimulator_tpu_torch.core.entities import (
    Agent,
    _is_batched_array,
)
from vectorizedmultiagentsimulator_tpu_torch.core.world import World
from vectorizedmultiagentsimulator_tpu_torch.utils import (
    AGENT_INFO_TYPE,
    AGENT_OBS_TYPE,
    AGENT_REWARD_TYPE,
    INITIAL_VIEWER_SIZE,
    VIEWER_DEFAULT_ZOOM,
)


class BaseScenario(ABC):

    def __init__(self):
        """Do not override."""
        self._world: Optional[World] = None
        self.viewer_size = INITIAL_VIEWER_SIZE
        self.viewer_zoom = VIEWER_DEFAULT_ZOOM
        self.render_origin = (0.0, 0.0)
        self.plot_grid = False
        self.grid_spacing = 0.1
        self.visualize_semidims = True

    # -- dynamic scenario buffers -> state.extras (mirrors Entity trap) -- #
    def __setattr__(self, name: str, value):
        world = self.__dict__.get("_world")
        if (
            not name.startswith("_")
            and world is not None
            and world.is_finalized
            and _is_batched_array(value, world.batch_dim)
        ):
            world.set_extra(f"scenario.{name}", value)
        else:
            object.__setattr__(self, name, value)

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        world = self.__dict__.get("_world")
        if world is not None and world.is_finalized:
            key = f"scenario.{name}"
            if world.has_extra(key):
                return world.get_extra(key)
        raise AttributeError(
            f"'{type(self).__name__}' object has no attribute '{name}'"
        )

    @property
    def world(self) -> World:
        assert (
            self._world is not None
        ), "You first need to set `self._world` in the `make_world` method"
        return self._world

    # ------------------------------------------------------------------ #
    # Called by the Environment (do not override) — scenario.py:82-98
    # ------------------------------------------------------------------ #
    def env_make_world(self, batch_dim: int, device=None, **kwargs) -> World:
        self._world = self.make_world(batch_dim, device, **kwargs)
        return self._world

    def env_reset_world_at(self, env_index):
        self.world.reset(env_index)
        self.reset_world_at(env_index)

    def env_process_action(self, agent: Agent):
        if agent.action_script is not None:
            agent.action_callback(self.world)
        self.process_action(agent)
        agent.dynamics.check_and_process_action()

    # ------------------------------------------------------------------ #
    # User hooks
    # ------------------------------------------------------------------ #
    @abstractmethod
    def make_world(self, batch_dim: int, device=None, **kwargs) -> World:
        raise NotImplementedError()

    @abstractmethod
    def reset_world_at(self, env_index=None):
        raise NotImplementedError()

    @abstractmethod
    def observation(self, agent: Agent) -> AGENT_OBS_TYPE:
        raise NotImplementedError()

    @abstractmethod
    def reward(self, agent: Agent) -> AGENT_REWARD_TYPE:
        raise NotImplementedError()

    def done(self):
        return torch.zeros(
            (self.world.batch_dim,), dtype=torch.bool, device=self.world.device
        )

    def done_query(self, *, in_reset: bool = False):
        """What the Environment calls for the dones.  ``in_reset=True``
        marks the query of a reset: a scenario whose ``done()`` has per-step
        side effects (road_traffic re-places agents there) overrides this
        and leaves them out on a reset."""
        del in_reset
        return self.done()

    def info(self, agent: Agent) -> AGENT_INFO_TYPE:
        return {}

    def process_action(self, agent: Agent):
        return

    def extra_render(self, env_index: int = 0) -> list:
        """Geoms the scenario draws beside its entities for env
        ``env_index``.  ``Environment.render`` calls it while the world is
        bound to a one-env copy of the state on the host (``env_index`` 0
        there), so the state it reads lies on the CPU."""
        return []

    def pre_step(self):
        return

    def post_step(self):
        return
