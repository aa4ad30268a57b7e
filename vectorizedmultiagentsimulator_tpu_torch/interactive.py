"""Interactive play (reference ``vmas/interactive_rendering.py``).

PyTorch counterpart of the JAX package's ``interactive.py``: the loop runs
on the matplotlib backend of the software rasterizer, as there: arrow keys
control the selected agent (W/A/S/D the second when
``control_two_agents=True``), TAB / LSHIFT cycle agents, R resets, M/N
control a third action dimension.  matplotlib is imported only when a
frame is shown; without it (or with ``save_render``) the frames are
``rgb_array`` ones.  The key handling (``_on_key``, ``_action_from_keys``,
agent cycling) takes synthetic key events, so it runs with no display.
"""
from __future__ import annotations

import importlib.util
from typing import Union

import numpy as np

from vectorizedmultiagentsimulator_tpu_torch.make_env import make_env
from vectorizedmultiagentsimulator_tpu_torch.scenario import BaseScenario

N_TEXT_LINES_INTERACTIVE = 6


class InteractiveEnv:
    def __init__(
        self,
        env,
        control_two_agents: bool = False,
        display_info: bool = True,
        save_render: bool = False,
        render_name: str = "interactive",
        n_steps: int = 200,
    ):
        self.env = env
        self.control_two_agents = control_two_agents
        self.current_agent_index = 0
        self.current_agent_index2 = 1
        self.n_agents = self.env.unwrapped.n_agents
        self.agents = self.env.unwrapped.agents
        self.continuous = self.env.unwrapped.continuous_actions
        self.reset_requested = False
        self.keys = np.zeros(6)  # up, down, left, right, rot+, rot-
        self.keys2 = np.zeros(6)
        self.display_info = display_info
        self.save_render = save_render
        self.render_name = render_name
        self.frame_list = []
        self.n_steps = n_steps
        if self.control_two_agents:
            assert self.n_agents >= 2, (
                "Control_two_agents is true but not enough agents in scenario"
            )
        self._cycle()

    def _increment_selected_agent_index(self, index: int) -> int:
        index += 1
        if index == self.n_agents:
            index = 0
        return index

    def _action_from_keys(self, keys, action_size):
        u = [0.0] * max(action_size, 2)
        u[0] = keys[3] - keys[2]  # x: right - left
        u[1] = keys[0] - keys[1]  # y: up - down
        if action_size > 2:
            u[2] = keys[4] - keys[5]
        if not self.continuous:
            # Map to the discrete stay/left/right/down/up encoding
            if u[0] != 0:
                return 2 if u[0] > 0 else 1
            if u[1] != 0:
                return 4 if u[1] > 0 else 3
            return 0
        return u[:action_size]

    def _on_key(self, event, down: bool):
        v = 1.0 if down else 0.0
        mapping = {
            "up": 0, "down": 1, "left": 2, "right": 3, "m": 4, "n": 5,
        }
        mapping2 = {"w": 0, "s": 1, "a": 2, "d": 3, "q": 4, "e": 5}
        k = event.key if hasattr(event, "key") else event
        if k in mapping:
            self.keys[mapping[k]] = v
        elif self.control_two_agents and k in mapping2:
            self.keys2[mapping2[k]] = v
        elif k == "tab" and down:
            self.current_agent_index = self._increment_selected_agent_index(
                self.current_agent_index
            )
        elif k == "shift" and down and self.control_two_agents:
            self.current_agent_index2 = self._increment_selected_agent_index(
                self.current_agent_index2
            )
        elif k == "r" and down:
            self.reset_requested = True

    def actions(self):
        """The agents' actions from the keys held now: the selected
        agent(s) from the keys, the others still."""
        actions = []
        for i, agent in enumerate(self.agents):
            size = self.env.unwrapped.get_agent_action_size(agent)
            if i == self.current_agent_index:
                act = self._action_from_keys(self.keys, size)
            elif self.control_two_agents and i == self.current_agent_index2:
                act = self._action_from_keys(self.keys2, size)
            else:
                act = [0.0] * size if self.continuous else 0
            actions.append(np.asarray(act))
        return actions

    def _display(self):
        """matplotlib's current figure with the key handlers connected, or
        ``None`` where matplotlib is absent or the frames are saved."""
        if self.save_render or importlib.util.find_spec("matplotlib") is None:
            return None
        import matplotlib.pyplot as plt

        fig = plt.gcf()
        fig.canvas.mpl_connect(
            "key_press_event", lambda e: self._on_key(e, True)
        )
        fig.canvas.mpl_connect(
            "key_release_event", lambda e: self._on_key(e, False)
        )
        return fig

    def _cycle(self):
        fig = self._display() if self.n_steps > 0 else None
        self.env.reset()
        total_rew = [0.0] * self.n_agents
        for _ in range(self.n_steps):
            if self.reset_requested:
                self.env.reset()
                total_rew = [0.0] * self.n_agents
                self.reset_requested = False
            obs, rews, done, info = self.env.step(self.actions())
            total_rew = [t + r for t, r in zip(total_rew, rews)]
            frame = self.env.render(
                mode="rgb_array" if fig is None else "human"
            )
            if self.save_render and frame is not None:
                self.frame_list.append(frame)
            if done:
                self.env.reset()
                total_rew = [0.0] * self.n_agents
        if self.save_render and self.frame_list:
            save_video(self.render_name, self.frame_list, fps=30)

    @staticmethod
    def format_obs(obs):
        if isinstance(obs, dict):
            return {k: InteractiveEnv.format_obs(v) for k, v in obs.items()}
        return np.round(np.asarray(obs), 2).tolist()


def save_video(name: str, frames, fps: int = 30):
    from vectorizedmultiagentsimulator_tpu_torch.utils import (
        save_video as _sv,
    )

    _sv(name, frames, fps=int(fps))


def render_interactively(
    scenario: Union[str, BaseScenario],
    control_two_agents: bool = False,
    display_info: bool = True,
    save_render: bool = False,
    n_steps: int = 200,
    device=None,
    **kwargs,
):
    """Interactive play entry point (reference
    interactive_rendering.py:306-363), on the card unless ``device="cpu"``
    is given."""
    if isinstance(scenario, str) and scenario.endswith(".py"):
        scenario = scenario.split("/")[-1][: -len(".py")]
    env = make_env(
        scenario=scenario,
        num_envs=1,
        device=device,
        seed=0,
        wrapper="gym",
        **kwargs,
    )
    return InteractiveEnv(
        env,
        control_two_agents=control_two_agents,
        display_info=display_info,
        save_render=save_render,
        render_name=(
            scenario if isinstance(scenario, str) else "interactive"
        ),
        n_steps=n_steps,
    )
