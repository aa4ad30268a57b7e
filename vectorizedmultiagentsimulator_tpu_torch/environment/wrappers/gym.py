"""Old-gym API wrapper (reference
``vmas/simulator/environment/gym/gym.py``), the PyTorch counterpart of the
JAX package's ``environment/wrappers/gym.py``.

``gym`` is optional; when absent the wrapper is a plain class exposing the
same old-gym ``step/reset/render`` API (single done flag, num_envs == 1).
"""
from __future__ import annotations

import importlib.util
from typing import Optional

import numpy as np

from vectorizedmultiagentsimulator_tpu_torch.environment.environment import (
    Environment,
)
from vectorizedmultiagentsimulator_tpu_torch.environment.wrappers.base import (
    BaseGymWrapper,
)

if importlib.util.find_spec("gym") is not None:
    import gym

    _GymEnvBase = gym.Env
else:

    class _GymEnvBase:  # pragma: no cover - fallback when gym is absent
        pass


class GymWrapper(_GymEnvBase, BaseGymWrapper):
    metadata = Environment.metadata

    def __init__(self, env: Environment, return_numpy: bool = True):
        BaseGymWrapper.__init__(
            self, env, return_numpy=return_numpy, vectorized=False
        )
        assert env.num_envs == 1, (
            "GymEnv wrapper is not vectorised,"
            f" got env.num_envs: {env.num_envs}"
        )
        assert not self._env.terminated_truncated, (
            "GymWrapper is not compatible with termination and truncation"
            " flags. Please set `terminated_truncated=False` in the"
            " environment."
        )
        self.observation_space = self._env.observation_space
        self.action_space = self._env.action_space

    @property
    def unwrapped(self) -> Environment:
        return self._env

    def step(self, action):
        action = self._action_list_to_tensor(action)
        obs, rews, done, info = self._env.step(action)
        env_data = self._convert_env_data(
            obs=obs, rews=rews, info=info, done=done
        )
        return env_data.obs, env_data.rews, env_data.done, env_data.info

    def reset(
        self,
        *,
        seed: Optional[int] = None,
        return_info: bool = False,
        options: Optional[dict] = None,
    ):
        if seed is not None:
            self._env.seed(seed)
        obs = self._env.reset_at(index=0)
        env_data = self._convert_env_data(obs=obs)
        return env_data.obs

    def render(
        self,
        mode="human",
        agent_index_focus: Optional[int] = None,
        visualize_when_rgb: bool = False,
        **kwargs,
    ) -> Optional[np.ndarray]:
        return self._env.render(
            mode=mode,
            env_index=0,
            agent_index_focus=agent_index_focus,
            visualize_when_rgb=visualize_when_rgb,
            **kwargs,
        )
