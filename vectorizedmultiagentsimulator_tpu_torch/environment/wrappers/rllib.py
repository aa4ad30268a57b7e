"""RLlib VectorEnv wrapper (reference
``vmas/simulator/environment/rllib.py``), the PyTorch counterpart of the
JAX package's ``environment/wrappers/rllib.py``.

``ray`` is optional; when absent the wrapper exposes the same
``rllib.VectorEnv`` API (``vector_reset/reset_at/vector_step/...``) as a
plain class so the per-env list conventions remain usable and testable.
A step copies its outputs from the device in one copy and de-vectorises
every env from that host copy; the per-env actions go to the device in one
copy.
"""
from __future__ import annotations

import importlib.util
from typing import Dict, List, Optional

import numpy as np
import torch

from vectorizedmultiagentsimulator_tpu_torch.environment.environment import (
    Environment,
)
from vectorizedmultiagentsimulator_tpu_torch.utils import TorchUtils, map_tensors

if importlib.util.find_spec("ray") is not None:
    from ray import rllib

    _VectorEnvBase = rllib.VectorEnv

    def _init_base(self):
        rllib.VectorEnv.__init__(
            self,
            observation_space=self._env.observation_space,
            action_space=self._env.action_space,
            num_envs=self._env.num_envs,
        )

else:

    class _VectorEnvBase:  # pragma: no cover - fallback when ray is absent
        pass

    def _init_base(self):
        self.observation_space = self._env.observation_space
        self.action_space = self._env.action_space
        self.num_envs = self._env.num_envs


class VectorEnvWrapper(_VectorEnvBase):
    """Vector environment wrapper for rllib (rllib.py:27-253)."""

    def __init__(self, env: Environment):
        assert not env.terminated_truncated, (
            "Rllib wrapper is not compatible with termination and truncation"
            " flags. Please set `terminated_truncated=False`."
        )
        self._env = env
        _init_base(self)

    @property
    def env(self):
        return self._env

    def vector_reset(self):
        obs = TorchUtils.to_numpy(self._env.reset())
        return self._read_data(obs)[0]

    def reset_at(self, index: Optional[int] = None):
        assert index is not None
        obs = self._env.reset_at(index)
        row = TorchUtils.to_numpy(map_tensors(obs, lambda t: t[index:index + 1]))
        return self._read_data(row, env_index=0)[0]

    def vector_step(self, actions):
        actions = self._action_list_to_tensor(actions)
        obs, rews, dones, infos = TorchUtils.to_numpy(self._env.step(actions))
        obs, infos, rews = self._read_data(obs, infos, rews)
        return obs, rews, np.asarray(dones), infos

    def seed(self, seed=None):
        return self._env.seed(seed)

    def try_render_at(
        self,
        index: Optional[int] = None,
        mode="human",
        agent_index_focus: Optional[int] = None,
        visualize_when_rgb: bool = False,
        **kwargs,
    ) -> Optional[np.ndarray]:
        if index is None:
            index = 0
        return self._env.render(
            mode=mode,
            env_index=index,
            agent_index_focus=agent_index_focus,
            visualize_when_rgb=visualize_when_rgb,
            **kwargs,
        )

    def get_sub_environments(self) -> List[Environment]:
        return [self._env]

    def _action_list_to_tensor(self, list_in: List) -> List:
        """Per-env list of per-agent actions -> per-agent ``[B, a]`` tensors
        on the env's device, in one copy (rllib.py:110-145)."""
        if len(list_in) != self.num_envs:
            raise TypeError("Input action is not in correct format")
        sizes = [self._env.get_agent_action_size(a) for a in self._env.agents]
        rows = []
        for j in range(self.num_envs):
            assert len(list_in[j]) == self._env.n_agents, (
                f"Expecting actions for {self._env.n_agents} agents,"
                f" got {len(list_in[j])} actions"
            )
            for i, size in enumerate(sizes):
                act = np.asarray(list_in[j][i], dtype=np.float32)
                if act.ndim == 0:
                    assert size == 1, (
                        f"Action of agent {i} in env {j} is supposed to be a"
                        " scalar int"
                    )
                    act = act.reshape(1)
                else:
                    assert act.ndim == 1 and act.shape[0] == size, (
                        f"Action of agent {i} in env {j} has wrong shape:"
                        f" expected {size}, got {act.shape[0]}"
                    )
                rows.append(act)
        flat = torch.as_tensor(np.concatenate(rows), device=self._env.device)
        table = flat.view(self.num_envs, sum(sizes))
        return list(torch.split(table, sizes, dim=1))

    def _read_data(self, obs, info=None, reward=None, env_index=None):
        if env_index is None:
            obs_list, info_list, rew_list = [], [], []
            for env_index in range(self.num_envs):
                o, i, r = self._get_data_at_env_index(
                    env_index, obs, info, reward
                )
                obs_list.append(o)
                if info:
                    info_list.append(i)
                if reward is not None:
                    rew_list.append(r)
            return (
                obs_list,
                info_list if info else None,
                rew_list if reward is not None else None,
            )
        return self._get_data_at_env_index(env_index, obs, info, reward)

    def _get_data_at_env_index(self, env_index, obs, info=None, reward=None):
        assert len(obs) == self._env.n_agents
        total_rew = 0.0
        new_info = {"rewards": {}} if info else None
        if isinstance(obs, Dict):
            new_obs = {}
            for agent_index, agent in enumerate(self._env.agents):
                new_obs[agent.name] = self._get_agent_data_at_env_index(
                    env_index, obs[agent.name]
                )
                if info:
                    new_info[agent.name] = self._get_agent_data_at_env_index(
                        env_index, info[agent.name]
                    )
                if reward is not None:
                    agent_rew = self._get_agent_data_at_env_index(
                        env_index, reward[agent.name]
                    )
                    new_info["rewards"][agent_index] = agent_rew
                    total_rew += agent_rew
        elif isinstance(obs, List):
            new_obs = []
            for agent_index, agent in enumerate(self._env.agents):
                new_obs.append(
                    self._get_agent_data_at_env_index(
                        env_index, obs[agent_index]
                    )
                )
                if info:
                    new_info[agent.name] = self._get_agent_data_at_env_index(
                        env_index, info[agent_index]
                    )
                if reward is not None:
                    agent_rew = self._get_agent_data_at_env_index(
                        env_index, reward[agent_index]
                    )
                    new_info["rewards"][agent_index] = agent_rew
                    total_rew += agent_rew
        else:
            raise ValueError(f"Unsupported obs type {obs}")
        return (
            new_obs,
            new_info if info else None,
            total_rew / self._env.n_agents if reward is not None else None,
        )

    def _get_agent_data_at_env_index(self, env_index, agent_data):
        if isinstance(agent_data, np.ndarray):
            if agent_data.ndim == 1 or (
                agent_data.ndim == 2 and agent_data.shape[1] == 1
            ):
                return agent_data[env_index].item()
            return np.asarray(agent_data[env_index])
        if isinstance(agent_data, Dict):
            return {
                key: self._get_agent_data_at_env_index(env_index, value)
                for key, value in agent_data.items()
            }
        raise ValueError(f"Unsupported data type {agent_data}")
