"""RL Environment front end.

PyTorch counterpart of ``vectorizedmultiagentsimulator_tpu/environment/
environment.py`` (reference ``vmas/simulator/environment/environment.py``),
without rendering or wrappers.  PyTorch runs eagerly, so ``step`` /
``reset`` / ``reset_at`` act on the world's state directly; randomness
comes from the world's ``torch.Generator``, seeded from ``seed``.  Nothing
in ``step`` copies between host and device or waits for the device.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from vectorizedmultiagentsimulator_tpu_torch.core.entities import Agent
from vectorizedmultiagentsimulator_tpu_torch.environment import spaces
from vectorizedmultiagentsimulator_tpu_torch.ops import physics_cuda
from vectorizedmultiagentsimulator_tpu_torch.scenario import BaseScenario
from vectorizedmultiagentsimulator_tpu_torch.utils import (
    AGENT_OBS_TYPE,
    env_index_to_mask,
    resolve_device,
)

Tensor = torch.Tensor


class Environment:
    metadata = {"runtime.vectorized": True}

    def __init__(
        self,
        scenario: BaseScenario,
        num_envs: int = 32,
        device=None,
        max_steps: Optional[int] = None,
        continuous_actions: bool = True,
        seed: Optional[int] = None,
        dict_spaces: bool = False,
        multidiscrete_actions: bool = False,
        clamp_actions: bool = False,
        grad_enabled: bool = False,
        terminated_truncated: bool = False,
        **kwargs,
    ):
        if multidiscrete_actions:
            assert not continuous_actions, (
                "When asking for multidiscrete_actions, make sure"
                " continuous_actions=False"
            )
        self.scenario = scenario
        self.num_envs = num_envs
        self.batch_dim = num_envs
        self.device = resolve_device(device)
        self.world = scenario.env_make_world(num_envs, self.device, **kwargs)
        self.world.finalize(seed=seed)

        self.agents = self.world.policy_agents
        self.n_agents = len(self.agents)
        self.max_steps = max_steps
        self.continuous_actions = continuous_actions
        self.dict_spaces = dict_spaces
        self.clamp_action = clamp_actions
        self.grad_enabled = grad_enabled
        self.terminated_truncated = terminated_truncated
        self.multidiscrete_actions = multidiscrete_actions

        observations = self._reset_impl(None)[0]
        # Pin the kernel choice now that the first reset has created the
        # scenario's extras (a per-env mass keeps the plain path).
        self.world._use_kernel = (
            self.world._use_kernel and physics_cuda.step_supported(self.world)
        )

        self.action_space = self.get_action_space()
        self.observation_space = self.get_observation_space(observations)

    @property
    def steps(self) -> Tensor:
        return self.world.state.steps

    # ------------------------------------------------------------------ #
    # Public API (reference environment.py:113-202,325-405)
    # ------------------------------------------------------------------ #
    def reset(
        self,
        seed: Optional[int] = None,
        return_observations: bool = True,
        return_info: bool = False,
        return_dones: bool = False,
    ):
        if seed is not None:
            self.seed(seed)
        outs = self._reset_impl(None)
        return self._select_reset_outputs(
            outs, return_observations, return_info, return_dones
        )

    def reset_at(
        self,
        index,
        return_observations: bool = True,
        return_info: bool = False,
        return_dones: bool = False,
    ):
        """Reset the envs that ``index`` names: an int, an int tensor of
        env indices, or a ``[num_envs]`` bool tensor (the counterpart of the
        JAX package's ``reset_at_fn(state, mask)``; a training loop passes
        the step's ``dones``).  Returns the observations of all envs.  With
        a tensor nothing here reads the device: the spawner runs a fixed
        number of rounds under a mask."""
        self._check_batch_index(index)
        mask = env_index_to_mask(index, self.num_envs, self.device)
        outs = self._reset_impl(mask)
        return self._select_reset_outputs(
            outs, return_observations, return_info, return_dones
        )

    def step(self, actions: Union[List, Dict]):
        """Vectorized step over all envs.

        ``actions``: list of len ``n_agents`` of ``[num_envs, action_size]``
        tensors, or a dict keyed by agent name.
        """
        actions = self._normalize_actions(actions)
        for i, agent in enumerate(self.agents):
            self._set_action(actions[i], agent)
        for agent in self.world.agents:
            self.scenario.env_process_action(agent)
        self.scenario.pre_step()
        self.world.step()
        self.scenario.post_step()
        s = self.world.state
        s.steps = s.steps + 1
        return self._get_from_scenario(
            get_observations=True,
            get_infos=True,
            get_rewards=True,
            get_dones=True,
        )

    def done(self):
        return self._done_impl()

    def seed(self, seed=None):
        if seed is None:
            seed = 0
        self.world.generator.manual_seed(seed)
        return [seed]

    def get_from_scenario(
        self,
        get_observations: bool,
        get_rewards: bool,
        get_infos: bool,
        get_dones: bool,
        dict_agent_names: Optional[bool] = None,
    ):
        return self._get_from_scenario(
            get_observations=get_observations,
            get_rewards=get_rewards,
            get_infos=get_infos,
            get_dones=get_dones,
            dict_agent_names=dict_agent_names,
        )

    # ------------------------------------------------------------------ #
    # Internals
    # ------------------------------------------------------------------ #
    def _check_batch_index(self, batch_index):
        if batch_index is not None and isinstance(batch_index, (int, np.integer)):
            assert 0 <= batch_index < self.num_envs, (
                f"Index must be between 0 and {self.num_envs}, got {batch_index}"
            )

    def _reset_impl(self, env_index):
        """Reset the world (+ scenario hook) and gather obs/info/done."""
        self.scenario.env_reset_world_at(env_index)
        mask = env_index_to_mask(env_index, self.num_envs, self.device)
        s = self.world.state
        s.steps = torch.where(mask, torch.zeros_like(s.steps), s.steps)
        # The dones of a reset only report the flags: done_query(in_reset=
        # True) runs none of a scenario's per-step side effects.
        return self._get_from_scenario(
            get_observations=True,
            get_rewards=False,
            get_infos=True,
            get_dones=True,
            in_reset=True,
        )

    def _select_reset_outputs(
        self, outs, return_observations, return_info, return_dones
    ):
        """Filter reset outputs to the requested subset, in the reference's
        order (environment.py:204-252: obs, dones, infos)."""
        if self.terminated_truncated:
            obs, terminated, truncated, infos = outs
            result = [
                obs if return_observations else None,
                terminated if return_dones else None,
                truncated if return_dones else None,
                infos if return_info else None,
            ]
        else:
            obs, dones, infos = outs
            result = [
                obs if return_observations else None,
                dones if return_dones else None,
                infos if return_info else None,
            ]
        result = [r for r in result if r is not None]
        if not result:
            return None
        return result[0] if len(result) == 1 else result

    def _normalize_actions(self, actions) -> List[Tensor]:
        if isinstance(actions, Dict):
            actions_dict = actions
            actions = []
            for agent in self.agents:
                try:
                    actions.append(actions_dict[agent.name])
                except KeyError:
                    raise AssertionError(
                        f"Agent '{agent.name}' not contained in action dict"
                    )
            assert len(actions_dict) == self.n_agents, (
                f"Expecting actions for {self.n_agents},"
                f" got {len(actions_dict)} actions"
            )
        assert len(actions) == self.n_agents, (
            f"Expecting actions for {self.n_agents}, got {len(actions)} actions"
        )
        norm = []
        for i, action in enumerate(actions):
            action = torch.as_tensor(action, device=self.device)
            if action.ndim == 1:
                action = action[:, None]
            assert action.shape[0] == self.num_envs, (
                f"Actions used in input of env must be of len {self.num_envs},"
                f" got {action.shape[0]}"
            )
            assert action.shape[1] == self.get_agent_action_size(self.agents[i]), (
                f"Action for agent {self.agents[i].name} has shape"
                f" {action.shape[1]}, but should have shape"
                f" {self.get_agent_action_size(self.agents[i])}"
            )
            norm.append(action)
        return norm

    def _get_from_scenario(
        self,
        get_observations: bool,
        get_rewards: bool,
        get_infos: bool,
        get_dones: bool,
        dict_agent_names: Optional[bool] = None,
        in_reset: bool = False,
    ):
        if not any((get_observations, get_rewards, get_infos, get_dones)):
            return
        if dict_agent_names is None:
            dict_agent_names = self.dict_spaces
        obs = rewards = infos = terminated = truncated = dones = None
        if get_observations:
            obs = {} if dict_agent_names else []
        if get_rewards:
            rewards = {} if dict_agent_names else []
        if get_infos:
            infos = {} if dict_agent_names else []

        def put(coll, agent, value):
            if dict_agent_names:
                coll[agent.name] = value
            else:
                coll.append(value)

        if get_rewards:
            for agent in self.agents:
                put(rewards, agent, self.scenario.reward(agent))
        if get_observations:
            for agent in self.agents:
                put(obs, agent, self.scenario.observation(agent))
        if get_infos:
            for agent in self.agents:
                put(infos, agent, self.scenario.info(agent))

        if self.terminated_truncated:
            if get_dones:
                terminated, truncated = self._done_impl(in_reset)
            result = [obs, rewards, terminated, truncated, infos]
        else:
            if get_dones:
                dones = self._done_impl(in_reset)
            result = [obs, rewards, dones, infos]
        return [data for data in result if data is not None]

    def _done_impl(self, in_reset: bool = False):
        terminated = self.scenario.done_query(in_reset=in_reset)
        if self.max_steps is not None:
            truncated = self.world.state.steps >= self.max_steps
        else:
            truncated = None
        if self.terminated_truncated:
            if truncated is None:
                truncated = torch.zeros_like(terminated)
            return terminated, truncated
        if truncated is None:
            return terminated
        return terminated | truncated

    # ------------------------------------------------------------------ #
    # Spaces (environment.py:431-523)
    # ------------------------------------------------------------------ #
    def get_action_space(self):
        if not self.dict_spaces:
            return spaces.Tuple(
                [self.get_agent_action_space(agent) for agent in self.agents]
            )
        return spaces.Dict(
            {
                agent.name: self.get_agent_action_space(agent)
                for agent in self.agents
            }
        )

    def get_observation_space(self, observations):
        if not self.dict_spaces:
            return spaces.Tuple(
                [
                    self.get_agent_observation_space(agent, observations[i])
                    for i, agent in enumerate(self.agents)
                ]
            )
        return spaces.Dict(
            {
                agent.name: self.get_agent_observation_space(
                    agent, observations[agent.name]
                )
                for agent in self.agents
            }
        )

    def _speaks(self, agent: Agent) -> bool:
        return not agent.silent and self.world.dim_c != 0

    def get_agent_action_size(self, agent: Agent):
        if self.continuous_actions:
            return agent.action.action_size + (
                self.world.dim_c if not agent.silent else 0
            )
        elif self.multidiscrete_actions:
            return agent.action_size + (1 if self._speaks(agent) else 0)
        return 1

    def get_agent_action_space(self, agent: Agent):
        if self.continuous_actions:
            u_range = agent.action._to_array(agent.u_range)
            n_c = self.world.dim_c if not agent.silent else 0
            return spaces.Box(
                low=np.array((-u_range).tolist() + [0.0] * n_c, dtype=np.float32),
                high=np.array(u_range.tolist() + [1.0] * n_c, dtype=np.float32),
            )
        elif self.multidiscrete_actions:
            nvec = agent.discrete_action_nvec + (
                [self.world.dim_c] if self._speaks(agent) else []
            )
            return spaces.MultiDiscrete(nvec)
        return spaces.Discrete(
            math.prod(agent.discrete_action_nvec)
            * (self.world.dim_c if self._speaks(agent) else 1)
        )

    def get_agent_observation_space(self, agent: Agent, obs: AGENT_OBS_TYPE):
        if isinstance(obs, Tensor):
            return spaces.Box(
                low=-np.float32("inf"),
                high=np.float32("inf"),
                shape=tuple(obs.shape[1:]),
            )
        elif isinstance(obs, Dict):
            return spaces.Dict(
                {
                    key: self.get_agent_observation_space(agent, value)
                    for key, value in obs.items()
                }
            )
        raise NotImplementedError(
            f"Invalid type of observation {obs} for agent {agent.name}"
        )

    # ------------------------------------------------------------------ #
    # Random actions (environment.py:525-607), drawn from the world's
    # generator on the env's device.
    # ------------------------------------------------------------------ #
    def get_random_action(self, agent: Agent,
                          generator: Optional[torch.Generator] = None
                          ) -> Tensor:
        """A uniform random action of ``agent`` for every env, drawn from
        ``generator`` (the world's by default)."""
        g = self.world.generator if generator is None else generator
        B = self.num_envs
        if self.continuous_actions:
            u_range = agent.action.u_range_tensor
            u = torch.rand((B, agent.action_size), generator=g, device=self.device)
            actions = [u * (2 * u_range) - u_range]
            if self.world.dim_c != 0 and not agent.silent:
                actions.append(
                    torch.rand(
                        (B, self.world.dim_c), generator=g, device=self.device
                    )
                )
            return torch.cat(actions, dim=-1)
        action_space = self.get_agent_action_space(agent)
        if self.multidiscrete_actions:
            return torch.stack(
                [
                    torch.randint(
                        0, int(n), (B,), generator=g, device=self.device
                    )
                    for n in action_space.nvec
                ],
                dim=-1,
            )
        return torch.randint(
            0, int(action_space.n), (B,), generator=g, device=self.device
        )

    def get_random_actions(self, generator: Optional[torch.Generator] = None
                           ) -> Sequence[Tensor]:
        return [self.get_random_action(agent, generator)
                for agent in self.agents]

    # ------------------------------------------------------------------ #
    # Action decoding (environment.py:609-749)
    # ------------------------------------------------------------------ #
    def _set_action(self, action, agent: Agent):
        action = action.to(torch.float32)
        if not self.grad_enabled:
            action = action.detach()

        if self.clamp_action and self.continuous_actions:
            physical_action = action[..., : agent.action_size]
            a_range = agent.action.u_range_tensor[None]
            physical_action = torch.minimum(
                torch.maximum(physical_action, -a_range), a_range
            )
            if self.world.dim_c > 0 and not agent.silent:
                comm_action = action[..., agent.action_size:]
                action = torch.cat(
                    [physical_action, torch.clamp(comm_action, 0, 1)], dim=-1
                )
            else:
                action = physical_action

        action_index = 0
        if self.continuous_actions:
            u = action[:, : agent.action_size]
            action_index += agent.action_size
        else:
            if not self.multidiscrete_actions:
                # Flat Discrete -> multidiscrete unflatten
                # (environment.py:658-678).
                flat_action = action[:, 0]
                acts = []
                nvec = list(agent.discrete_action_nvec) + (
                    [self.world.dim_c] if self._speaks(agent) else []
                )
                for i in range(len(nvec)):
                    n = math.prod(nvec[i + 1:])
                    acts.append(torch.div(flat_action, n, rounding_mode="floor"))
                    flat_action = torch.remainder(flat_action, n)
                action = torch.stack(acts, dim=-1)

            # Per-dim discrete -> continuous mapping with the odd-n
            # "first action is zero" remap (environment.py:681-705).
            u_range = agent.action.u_range_tensor
            u_cols = []
            for j, n in enumerate(agent.discrete_action_nvec):
                physical_action = action[:, action_index]
                u_max = u_range[j]
                if n % 2 != 0:
                    stay = physical_action == 0
                    decrement = (physical_action > 0) & (physical_action <= n // 2)
                    physical_action = torch.where(
                        stay, torch.full_like(physical_action, n // 2),
                        physical_action,
                    )
                    physical_action = torch.where(
                        decrement, physical_action - 1, physical_action
                    )
                u_cols.append((physical_action / (n - 1)) * (2 * u_max) - u_max)
                action_index += 1
            u = torch.stack(u_cols, dim=-1)

        u = u * agent.action.u_multiplier_tensor[None]

        if np.any(agent.action._to_array(agent.u_noise) > 0):
            noise = torch.randn(
                u.shape, generator=self.world.generator, device=self.device
            ) * agent.action.u_noise_tensor[None]
            u = u + noise
        agent.action.u = u

        if self.world.dim_c > 0 and not agent.silent:
            if not self.continuous_actions:
                comm_action = action[:, action_index:].long()
                c = torch.nn.functional.one_hot(
                    comm_action[:, 0], self.world.dim_c
                ).to(torch.float32)
            else:
                c = action[:, action_index:]
            if agent.c_noise > 0:
                c = c + torch.randn(
                    c.shape, generator=self.world.generator, device=self.device
                ) * agent.c_noise
            agent.action.c = c
