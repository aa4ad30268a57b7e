"""The port's wheel, passage, ball_passage, reverse_transport and
dropout: replay of the reference goldens, live parity with the JAX env
from one injected state (the ``is_rendering`` flags among the extras
carried across), same-seed determinism, the physics route against the
JAX package's, wheel's heuristic, and ``Entity.is_rendering``."""
import os
import sys

import numpy as np
import pytest
import torch

# The CPU tests run at small sizes, several test processes at once:
# PyTorch's intra-op threads would only contend with each other.
torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(__file__))
from torch_helpers import (
    cpu_env,
    live_parity,
    replay_golden,
    same_seed_runs,
)

import vectorizedmultiagentsimulator_tpu as vmt

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
SCENARIOS = ["wheel", "passage", "ball_passage", "reverse_transport",
             "dropout"]
B = 8

_JAX_ENVS = {}


def jax_env(scenario):
    """One JAX env (B envs, seed 0) a scenario for this file."""
    if scenario not in _JAX_ENVS:
        _JAX_ENVS[scenario] = vmt.make_env(scenario, num_envs=B, seed=0)
    return _JAX_ENVS[scenario]



@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setenv("VMT_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("VMT_PALLAS_STEP", "1")
    from vectorizedmultiagentsimulator_tpu.ops import physics_pallas
    return physics_pallas


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_scenario_golden(scenario):
    replay_golden(cpu_env, os.path.join(GOLDEN, f"scenario_{scenario}.npz"))


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_live_parity_with_jax(scenario):
    live_parity(jax_env(scenario), cpu_env(scenario, B, seed=1), 8)


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_same_seed_same_trajectory(scenario):
    same_seed_runs(cpu_env, scenario)


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_route_matches_jax(pallas_interpret, scenario):
    """The port steps through the physics kernel where the JAX package's
    step_supported takes its Pallas kernel (all five)."""
    assert cpu_env(scenario, 2).world._use_kernel
    assert pallas_interpret.step_supported(jax_env(scenario).world)


def test_wheel_heuristic_matches_jax():
    from vectorizedmultiagentsimulator_tpu.scenarios.wheel import (
        HeuristicPolicy as JaxPolicy,
    )
    from vectorizedmultiagentsimulator_tpu_torch.scenarios.wheel import (
        HeuristicPolicy,
    )

    obs = np.random.RandomState(4).uniform(-1.5, 1.5, (64, 13)).astype(
        np.float32)
    ref = np.asarray(JaxPolicy().compute_action(obs, u_range=0.5))
    got = HeuristicPolicy().compute_action(torch.as_tensor(obs), u_range=0.5)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


@pytest.mark.parametrize("scenario,flagged", [
    ("passage", ["passage 0"]),
    ("ball_passage", ["passage 10"]),
    ("dropout", ["goal"]),
    ("wheel", []),
])
def test_is_rendering_keys_made_at_reset(scenario, flagged):
    """The entities whose ``is_rendering`` a reset writes, and only those,
    hold it in extras from the first reset on, as the JAX env's state
    does; the others read all True without a key appearing."""
    env = cpu_env(scenario, 4)
    keys = {k[:-len(".is_rendering")] for k in env.world.state.extras
            if k.endswith(".is_rendering")}
    assert keys == set(flagged)
    j_keys = {k[:-len(".is_rendering")] for k in jax_env(scenario).state.extras
              if k.endswith(".is_rendering")}
    assert j_keys == keys
    for e in env.world.entities:
        if e.name not in flagged:
            assert bool(e.is_rendering.all())
    env.step(env.get_random_actions())
    assert set(env.world.state.extras) == set(cpu_env(scenario, 4)
                                              .world.state.extras)


def test_dropout_goal_stops_rendering_once_eaten():
    """An agent on the goal eats it: the goal is eaten and not drawn in
    that env, the +1 is paid once, and a masked reset draws it again."""
    env = cpu_env("dropout", 4)
    goal = env.world.landmarks[0]
    a0 = env.world.agents[0]
    on_goal = torch.tensor([True, False, True, False])
    a0.set_pos(torch.where(on_goal[:, None], goal.state.pos, a0.state.pos))
    zeros = [torch.zeros(4, 2) for _ in env.agents]
    _, rews, dones, _ = env.step(zeros)
    assert torch.equal(goal.eaten, on_goal)
    assert torch.equal(goal.is_rendering, ~on_goal)
    assert torch.equal(dones, on_goal)
    assert torch.equal(env.scenario.pos_rew, on_goal.to(torch.float32))
    env.step(zeros)
    assert bool((env.scenario.pos_rew == 0).all())
    env.reset_at(torch.tensor([True, False, False, False]))
    assert torch.equal(goal.is_rendering,
                       torch.tensor([True, True, False, True]))
