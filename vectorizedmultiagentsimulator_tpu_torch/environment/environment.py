"""RL Environment front end.

PyTorch counterpart of ``vectorizedmultiagentsimulator_tpu/environment/
environment.py`` (reference ``vmas/simulator/environment/environment.py``).
PyTorch runs eagerly, so ``step`` / ``reset`` / ``reset_at`` act on the
world's state directly; randomness comes from the world's
``torch.Generator``, seeded from ``seed``.  Nothing in ``step`` copies
between host and device or waits for the device.

``render`` copies env ``env_index``'s row of every state field, every
extras buffer and (with ``render_sensors``) every LIDAR's distances from
the device in one copy, binds the world to that one-env state on the host
while the scenario, its entities and sensors build their geoms, and draws
them with the numpy rasterizer (``render/``).  A frame's cost does not grow
with ``num_envs``; it draws no random numbers and leaves the state as it
was.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from vectorizedmultiagentsimulator_tpu_torch.core.entities import Agent
from vectorizedmultiagentsimulator_tpu_torch.core.state import WorldState
from vectorizedmultiagentsimulator_tpu_torch.environment import spaces
from vectorizedmultiagentsimulator_tpu_torch.ops import physics_cuda
from vectorizedmultiagentsimulator_tpu_torch.scenario import BaseScenario
from vectorizedmultiagentsimulator_tpu_torch.utils import (
    AGENT_OBS_TYPE,
    ALPHABET,
    STATE_FIELDS,
    X,
    Y,
    env_index_to_mask,
    host_copy,
    resolve_device,
    same_device,
)

Tensor = torch.Tensor


class Environment:
    metadata = {
        "render.modes": ["human", "rgb_array"],
        "runtime.vectorized": True,
    }

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
        # What this env was built with, but for the batch and the device:
        # parallel.shard_environment builds a rank's env from it.
        self.build_kwargs = dict(
            kwargs, max_steps=max_steps,
            continuous_actions=continuous_actions, seed=seed,
            dict_spaces=dict_spaces,
            multidiscrete_actions=multidiscrete_actions,
            clamp_actions=clamp_actions, grad_enabled=grad_enabled,
            terminated_truncated=terminated_truncated,
        )
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

        # rendering
        self.viewer = None
        self.text_lines = None

    # ------------------------------------------------------------------ #
    # State and the functional API (the JAX package's environment.py:
    # 112-181)
    # ------------------------------------------------------------------ #
    @property
    def state(self) -> WorldState:
        """The whole simulation state but the random stream (checkpoint =
        save this and ``world.generator.get_state()``): a new object over
        the world's tensors, which later steps leave as it is.  (After a
        ``parallel.rollout`` on the card those tensors are the graph's
        buffers, which its next replay writes over: clone to keep them.)"""
        return self.world.snapshot()

    @state.setter
    def state(self, value: WorldState):
        self.world.bind(value.replace(), borrowed=True)

    @property
    def steps(self) -> Tensor:
        return self.world.state.steps

    def step_fn(self, state: WorldState, actions,
                generator: Optional[torch.Generator] = None):
        """``(new state, (obs, rews, dones, infos))``: one step from
        ``state`` (``(obs, rews, terminated, truncated, infos)`` with
        ``terminated_truncated``; dicts with ``dict_spaces``), as ``step``
        gives it.  ``state`` and the world's own state are left as they
        were.  Random numbers come from ``generator``, else from the
        world's generator; the same state and actions with generators in
        the same state give the same outputs to the bit."""
        actions = self._normalize_actions(actions)
        return self.world.functional(
            state, lambda: tuple(self._step_impl(actions)), generator)

    def reset_fn(self, state: WorldState,
                 generator: Optional[torch.Generator] = None):
        """``(new state, (obs, dones, infos))``: every env of ``state``
        reset, as ``reset`` does it, ``state`` left as it was."""
        return self.world.functional(
            state, lambda: tuple(self._reset_impl(None)), generator)

    def reset_at_fn(self, state: WorldState, mask,
                    generator: Optional[torch.Generator] = None):
        """``(new state, (obs, dones, infos))``: the envs of ``mask`` (a
        ``[num_envs]`` bool tensor, or what ``reset_at`` takes) of
        ``state`` reset, ``state`` left as it was."""
        self._check_batch_index(mask)
        mask = env_index_to_mask(mask, self.num_envs, self.device)
        return self.world.functional(
            state, lambda: tuple(self._reset_impl(mask)), generator)

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
        return self._step_impl(self._normalize_actions(actions))

    def done(self):
        return self._done_impl()

    def seed(self, seed=None):
        if seed is None:
            seed = 0
        self.world.generator.manual_seed(seed)
        return [seed]

    def to(self, device):
        """``self`` on the env's own device.  An env is built on its device
        and stays there (as the JAX package's ``to``, which moves nothing):
        another device raises."""
        same_device(self.device, device)
        return self

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

    def _step_impl(self, actions: List[Tensor]):
        """The step on the state the world holds: ``step``'s and
        ``step_fn``'s body."""
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

    # ------------------------------------------------------------------ #
    # Rendering (environment.py:751-1015, numpy rasterizer backend)
    # ------------------------------------------------------------------ #
    def render(
        self,
        mode: str = "human",
        env_index: int = 0,
        agent_index_focus: Optional[int] = None,
        visualize_when_rgb: bool = False,
        plot_position_function: Optional[Callable] = None,
        plot_position_function_precision: float = 0.01,
        plot_position_function_range=None,
        plot_position_function_cmap_range=None,
        plot_position_function_cmap_alpha: float = 1.0,
        plot_position_function_cmap_name: str = "viridis",
        render_sensors: bool = False,
    ):
        """A frame of env ``env_index``: an ``[H, W, 3]`` uint8 array with
        ``mode="rgb_array"``, else shown through matplotlib.  The arguments
        are the JAX package's; ``render_sensors`` also draws every LIDAR's
        rays, as the reference's ``Agent.render`` does (the JAX package's
        frames draw none)."""
        self._check_batch_index(env_index)
        assert mode in self.metadata["render.modes"]
        if agent_index_focus is not None:
            assert 0 <= agent_index_focus < self.n_agents

        from vectorizedmultiagentsimulator_tpu_torch.render import Viewer

        if self.viewer is None:
            self.viewer = Viewer(*self.scenario.viewer_size)
            self._init_text_lines()
        if self.scenario.viewer_zoom <= 0:
            raise ValueError("Scenario viewer zoom must be > 0")

        lidars = ([x for a in self.world.agents for x in a.sensors
                   if getattr(x, "rendering", False)]
                  if render_sensors else [])
        frame_state, measurements = self._frame_state(env_index, lidars)

        def draw():
            self._draw_frame(
                agent_index_focus, plot_position_function,
                plot_position_function_precision, plot_position_function_range,
                plot_position_function_cmap_range,
                plot_position_function_cmap_alpha,
                plot_position_function_cmap_name)
            for lidar, meas in zip(lidars, measurements):
                self.viewer.add_onetime_list(lidar.render(0, meas))

        self.world.functional(frame_state, draw)
        return self.viewer.render(return_rgb_array=mode == "rgb_array")

    def _frame_state(self, env_index: int, lidars):
        """Env ``env_index``'s row of every state field and extras buffer,
        and the distances of each of ``lidars`` measured from the current
        state, copied from the device in one copy: ``(a one-env WorldState
        on the host, [numpy [n_rays] per LIDAR])``."""
        s = self.world.state
        keys = list(s.extras)
        # The LIDARs' casts as a step leaves them where they are current
        # (World.measure_lidar), else cast now.
        rows = [getattr(s, f)[env_index:env_index + 1] for f in STATE_FIELDS]
        rows += [s.extras[k][env_index:env_index + 1] for k in keys]
        rows += [lidar.measure()[env_index:env_index + 1] for lidar in lidars]
        values = host_copy(rows)
        n_fields = len(STATE_FIELDS)
        state = WorldState(**dict(zip(STATE_FIELDS, values[:n_fields])))
        state.extras = dict(zip(keys, values[n_fields:n_fields + len(keys)]))
        measurements = [v[0].numpy() for v in values[n_fields + len(keys):]]
        return state, measurements

    def _draw_frame(self, agent_index_focus, plot_position_function,
                    precision, prange, cmap_range, cmap_alpha, cmap_name):
        """Set the camera and queue the frame's geoms, the world bound to a
        one-env host state (env 0): the JAX package's ``render`` body."""
        from vectorizedmultiagentsimulator_tpu_torch.render import (
            render_function_util,
        )

        self._set_agent_comm_messages(0)
        zoom = self.scenario.viewer_zoom
        aspect = self.scenario.viewer_size[X] / self.scenario.viewer_size[Y]
        if aspect < 1:
            cam_range = np.array([zoom, zoom / aspect])
        else:
            cam_range = np.array([zoom * aspect, zoom])

        if agent_index_focus is None:
            all_poses = np.stack(
                [np.asarray(agent.state.pos)[0] for agent in self.world.agents]
            )
            max_agent_radius = max(
                agent.shape.circumscribed_radius()
                for agent in self.world.agents
            )
            origin = np.asarray(self.scenario.render_origin)
            viewer_size_fit = (
                np.array(
                    [
                        np.max(np.abs(all_poses[:, X] - origin[X])),
                        np.max(np.abs(all_poses[:, Y] - origin[Y])),
                    ]
                )
                + 2 * max_agent_radius
            )
            viewer_size = np.maximum(viewer_size_fit / cam_range, zoom)
            cam_range = cam_range * np.max(viewer_size)
            self.viewer.set_bounds(
                -cam_range[X] + origin[X],
                cam_range[X] + origin[X],
                -cam_range[Y] + origin[Y],
                cam_range[Y] + origin[Y],
            )
        else:
            pos = np.asarray(self.agents[agent_index_focus].state.pos)[0]
            self.viewer.set_bounds(
                pos[X] - cam_range[X],
                pos[X] + cam_range[X],
                pos[Y] - cam_range[Y],
                pos[Y] + cam_range[Y],
            )

        if self.scenario.visualize_semidims:
            self._plot_boundary()
        if self.scenario.plot_grid:
            self._plot_grid()
        if plot_position_function is not None:
            if prange is None:
                xmin, xmax, ymin, ymax = self.viewer.bounds
                prange = ((xmin, xmax), (ymin, ymax))
            elif isinstance(prange, (int, float)):
                prange = ((-prange, prange), (-prange, prange))
            elif isinstance(prange[0], (int, float)):
                prange = ((-prange[0], prange[0]), (-prange[1], prange[1]))
            self.viewer.add_onetime(
                render_function_util(plot_position_function, precision,
                                     prange, cmap_range, cmap_alpha,
                                     cmap_name)
            )
        self.viewer.add_onetime_list(self.scenario.extra_render(0))
        for entity in self.world.entities:
            self.viewer.add_onetime_list(entity.render(env_index=0))

    def plot_function(
        self, f, precision, plot_range, cmap_range, cmap_alpha, cmap_name
    ):
        """A heatmap geom of ``f`` over ``plot_range`` (reference
        environment.py:990-1014); with ``plot_range=None`` the viewer's
        bounds (render once first).  Add it with ``env.viewer.add_onetime``,
        or use :meth:`render`'s ``plot_position_function`` arguments."""
        from vectorizedmultiagentsimulator_tpu_torch.render import (
            render_function_util,
        )

        if plot_range is None:
            assert (
                self.viewer is not None and self.viewer.bounds is not None
            ), "Set viewer bounds before plotting"
            x_min, x_max, y_min, y_max = self.viewer.bounds
            plot_range = (
                [x_min - precision, x_max - precision],
                [y_min - precision, y_max + precision],
            )
        return render_function_util(
            f, precision, plot_range, cmap_range, cmap_alpha, cmap_name
        )

    def _init_text_lines(self):
        """One screen-space text line per speaking agent for comm-message
        overlays (reference environment.py:1023-1031)."""
        from vectorizedmultiagentsimulator_tpu_torch.render import TextLine

        self.text_lines = []
        if self.world.dim_c > 0:
            idx = 0
            for agent in self.world.agents:
                if not agent.silent:
                    text_line = TextLine(y=idx * 40)
                    self.viewer.geoms.append(text_line)
                    self.text_lines.append(text_line)
                    idx += 1

    def _set_agent_comm_messages(self, env_index: int):
        """Comm utterances as text (reference environment.py:1033-1055)."""
        if self.world.dim_c == 0 or not self.text_lines:
            return
        idx = 0
        for agent in self.world.agents:
            if agent.silent:
                continue
            c = np.asarray(agent.state.c)[env_index]
            if self.continuous_actions:
                word = "[" + ",".join(f"{comm:.2f}" for comm in c) + "]"
            else:
                word = ALPHABET[int(np.argmax(c))]
            self.text_lines[idx].set_text(f"{agent.name} sends {word}   ")
            idx += 1

    def _plot_grid(self):
        """Background grid (reference rendering.py Grid)."""
        from vectorizedmultiagentsimulator_tpu_torch.render import Segment

        xmin, xmax, ymin, ymax = self.viewer.bounds or (-1.2, 1.2, -1.2, 1.2)
        spacing = float(self.scenario.grid_spacing) or 0.1
        x = math.floor(xmin / spacing) * spacing
        while x <= xmax:
            seg = Segment(start=(x, ymin), end=(x, ymax), width=0.002)
            seg.set_color(0.8, 0.8, 0.8)
            self.viewer.add_onetime(seg)
            x += spacing
        y = math.floor(ymin / spacing) * spacing
        while y <= ymax:
            seg = Segment(start=(xmin, y), end=(xmax, y), width=0.002)
            seg.set_color(0.8, 0.8, 0.8)
            self.viewer.add_onetime(seg)
            y += spacing

    def _plot_boundary(self):
        from vectorizedmultiagentsimulator_tpu_torch.render import Segment

        if self.world.x_semidim is not None or self.world.y_semidim is not None:
            infinite = 100
            x_semi = (self.world.x_semidim
                      if self.world.x_semidim is not None else infinite)
            y_semi = (self.world.y_semidim
                      if self.world.y_semidim is not None else infinite)
            corners = [
                (-x_semi, y_semi),
                (x_semi, y_semi),
                (x_semi, -y_semi),
                (-x_semi, -y_semi),
            ]
            for i in range(4):
                seg = Segment(
                    start=corners[i], end=corners[(i + 1) % 4], width=0.005
                )
                seg.set_color(0.25, 0.25, 0.25)
                self.viewer.add_onetime(seg)
