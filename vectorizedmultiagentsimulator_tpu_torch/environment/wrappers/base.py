"""Base wrapper utilities (reference
``vmas/simulator/environment/gym/base.py``).

PyTorch counterpart of the JAX package's ``environment/wrappers/base.py``:
converts the env's tensors into the numpy / single-env conventions of the
external RL APIs.  A step's outputs that go to the host (all of them with
``return_numpy``, else the rewards and flags a single-env wrapper returns
as Python scalars) are copied from the device in one copy
(``utils.host_copy``); numpy actions go to the device in one copy.  With
``return_numpy=False`` the rest stay tensors on the env's device.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from collections import namedtuple
from typing import List, Optional

import numpy as np
import torch

from vectorizedmultiagentsimulator_tpu_torch.environment.environment import (
    Environment,
)
from vectorizedmultiagentsimulator_tpu_torch.utils import (
    extract_nested_with_index,
    host_copy,
    map_tensors,
)

EnvData = namedtuple(
    "EnvData", ["obs", "rews", "terminated", "truncated", "done", "info"]
)


def actions_to_device(env: Environment, actions: List) -> List[torch.Tensor]:
    """Per-agent actions (numpy or nested lists; tensors are taken as they
    are) as ``[num_envs, action_size]`` tensors on the env's device: float32
    for continuous actions, int32 else.  Host actions are packed into one
    array and copied to the device once."""
    dtype = np.float32 if env.continuous_actions else np.int32
    shapes = [(env.num_envs, env.get_agent_action_size(agent))
              for agent in env.agents]
    if all(isinstance(a, torch.Tensor) for a in actions):
        return [torch.as_tensor(a, device=env.device).reshape(shape)
                for a, shape in zip(actions, shapes)]
    host = [np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a,
                       dtype=dtype).reshape(shape)
            for a, shape in zip(actions, shapes)]
    flat = torch.as_tensor(np.concatenate([h.reshape(-1) for h in host]),
                           device=env.device)
    out, at = [], 0
    for shape in shapes:
        n = shape[0] * shape[1]
        out.append(flat[at:at + n].view(shape))
        at += n
    return out


class BaseGymWrapper(ABC):
    def __init__(self, env: Environment, return_numpy: bool, vectorized: bool):
        self._env = env
        self.return_numpy = return_numpy
        self.dict_spaces = env.dict_spaces
        self.vectorized = vectorized

    @property
    def env(self):
        return self._env

    def _compress_infos(self, infos):
        if isinstance(infos, dict):
            return infos
        if isinstance(infos, list):
            return {
                self._env.agents[i].name: info for i, info in enumerate(infos)
            }
        raise ValueError(
            f"Expected list or dictionary for infos but got {type(infos)}"
        )

    def _convert_env_data(
        self,
        obs=None,
        rews=None,
        info=None,
        terminated=None,
        truncated=None,
        done=None,
    ):
        """The JAX wrapper's conversion: a single-env wrapper takes env 0
        and returns each agent's reward and the flags as Python scalars;
        ``return_numpy`` turns the rest into numpy.  What goes to the host
        goes in one copy."""
        if not self.vectorized:
            pick = lambda t: extract_nested_with_index(t, 0)  # noqa: E731
            obs, info, rews, terminated, truncated, done = (
                map_tensors(x, pick)
                for x in (obs, info, rews, terminated, truncated, done))
        data = {"obs": obs, "info": info, "rews": rews,
                "terminated": terminated, "truncated": truncated,
                "done": done}

        def how(key):
            if not self.vectorized and key not in ("obs", "info"):
                return lambda host: host.item()
            if self.return_numpy:
                return lambda host: host.numpy()
            return None

        leaves = []
        for key, x in data.items():
            if how(key) is not None:
                map_tensors(x, leaves.append)
        host = iter(host_copy(leaves))
        for key, x in data.items():
            convert = how(key)
            if convert is not None:
                data[key] = map_tensors(x, lambda _: convert(next(host)))
        info = data["info"]
        return EnvData(
            obs=data["obs"],
            rews=data["rews"],
            terminated=data["terminated"],
            truncated=data["truncated"],
            done=data["done"],
            info=self._compress_infos(info) if info is not None else None,
        )

    def _action_list_to_tensor(self, list_in: List) -> List:
        if isinstance(list_in, dict):
            # Dict-space convenience: actions keyed by agent name
            # (the underlying Environment.step also accepts this form).
            list_in = [list_in[agent.name] for agent in self._env.agents]
        assert len(list_in) == self._env.n_agents, (
            f"Expecting actions for {self._env.n_agents} agents,"
            f" got {len(list_in)} actions"
        )
        return actions_to_device(self._env, list(list_in))

    @abstractmethod
    def step(self, action):
        raise NotImplementedError

    @abstractmethod
    def reset(
        self, *, seed: Optional[int] = None, options: Optional[dict] = None
    ):
        raise NotImplementedError

    @abstractmethod
    def render(
        self,
        agent_index_focus: Optional[int] = None,
        visualize_when_rgb: bool = False,
        **kwargs,
    ) -> Optional[np.ndarray]:
        raise NotImplementedError
