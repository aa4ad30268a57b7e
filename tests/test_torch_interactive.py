"""The port's interactive play and examples: ``InteractiveEnv``'s
key-to-action mapping and agent cycling held to the JAX package's under
the same synthetic key events, with no display; ``examples/use_vmt_env.py``
and ``examples/run_heuristic.py`` run a few steps on the CPU."""
import os
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(__file__))

import vectorizedmultiagentsimulator_tpu as vmt_jax  # noqa: E402
import vectorizedmultiagentsimulator_tpu_torch as vmt  # noqa: E402
from vectorizedmultiagentsimulator_tpu.interactive import (  # noqa: E402
    InteractiveEnv as JaxInteractiveEnv,
)
from vectorizedmultiagentsimulator_tpu_torch.interactive import (  # noqa: E402
    InteractiveEnv,
)

# Presses and releases, the second agent's keys, agent cycling (past the
# last agent back to the first), a reset request, and keys no one maps.
EVENTS = [
    ("right", True), ("up", True), ("m", True), ("right", False),
    ("left", True), ("tab", True), ("tab", False), ("w", True), ("d", True),
    ("shift", True), ("q", True), ("down", True), ("up", False),
    ("tab", True), ("tab", True), ("tab", True), ("r", True), ("x", True),
    ("shift", True), ("shift", True), ("a", True), ("w", False),
    ("n", True), ("m", False), ("e", True), ("left", False),
]


class _Event:
    def __init__(self, key):
        self.key = key


def _state(ie):
    return (ie.keys.tolist(), ie.keys2.tolist(), ie.current_agent_index,
            ie.current_agent_index2, ie.reset_requested)


@pytest.mark.parametrize("continuous", [True, False])
@pytest.mark.parametrize("two", [True, False])
def test_key_handling_equals_the_jax_one(continuous, two):
    kwargs = dict(num_envs=1, seed=0, wrapper="gym",
                  continuous_actions=continuous)
    jenv = vmt_jax.make_env("transport", n_agents=3, jit_compile=False,
                            **kwargs)
    env = vmt.make_env("transport", n_agents=3, device="cpu", **kwargs)
    # n_steps=0: no loop and no display, the key handling only.
    jie = JaxInteractiveEnv(jenv, control_two_agents=two, n_steps=0)
    ie = InteractiveEnv(env, control_two_agents=two, n_steps=0)
    for i, (key, down) in enumerate(EVENTS):
        event = _Event(key) if i % 2 else key  # both forms are taken
        jie._on_key(event, down)
        ie._on_key(event, down)
        assert _state(ie) == _state(jie), (i, key, down)
        for size in (1, 2, 3):
            for keys in (ie.keys, ie.keys2):
                got = ie._action_from_keys(keys, size)
                want = jie._action_from_keys(keys, size)
                assert np.array_equal(np.asarray(got), np.asarray(want))
        want = []
        for j, agent in enumerate(jie.agents):
            size = jenv.unwrapped.get_agent_action_size(agent)
            if j == jie.current_agent_index:
                want.append(jie._action_from_keys(jie.keys, size))
            elif two and j == jie.current_agent_index2:
                want.append(jie._action_from_keys(jie.keys2, size))
            else:
                want.append([0.0] * size if continuous else 0)
        for g, w in zip(ie.actions(), want):
            np.testing.assert_array_equal(g, np.asarray(w))


def test_interactive_loop_steps_and_saves_frames(tmp_path, monkeypatch):
    """A short loop with ``save_render``: rgb_array frames, no display."""
    from vectorizedmultiagentsimulator_tpu_torch import interactive

    monkeypatch.chdir(tmp_path)
    ie = interactive.render_interactively(
        "transport", n_steps=3, save_render=True, device="cpu", n_agents=2)
    assert len(ie.frame_list) == 3
    assert ie.frame_list[0].shape == (700, 700, 3)
    assert os.path.exists(tmp_path / "transport.npz")


def test_use_vmt_env_runs(capsys):
    from vectorizedmultiagentsimulator_tpu_torch.examples.use_vmt_env import (
        use_vmt_env,
    )

    env = use_vmt_env(scenario_name="waterfall", num_envs=4, n_steps=3,
                      device="cpu", continuous_actions=False, n_agents=4,
                      render=True)
    assert env.device.type == "cpu" and int(env.steps[0]) == 3
    assert "3 steps of 4 parallel environments" in capsys.readouterr().out


@pytest.mark.parametrize("heuristic", [None, "transport"])
def test_run_heuristic_runs(heuristic):
    from vectorizedmultiagentsimulator_tpu_torch.examples.run_heuristic import (
        run_heuristic,
    )
    from vectorizedmultiagentsimulator_tpu_torch.models import RandomPolicy
    from vectorizedmultiagentsimulator_tpu_torch.scenarios import transport

    policy = RandomPolicy if heuristic is None else transport.HeuristicPolicy
    total = run_heuristic("transport", policy, n_steps=5, n_envs=4,
                          device="cpu")
    assert np.isfinite(total)
