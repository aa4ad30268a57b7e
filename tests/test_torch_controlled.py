"""The port's velocity-controlled scenarios: give_way, multi_give_way,
wind_flocking and the debug circle_trajectory, line_trajectory, goal and
vel_control.  Replay of the reference goldens, live parity with the JAX
env from one injected state (the PID state among the extras carried
across), same-seed determinism, the physics route against the JAX
package's, and the controller's state under a masked reset."""
import os
import sys

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
SCENARIOS = ["give_way", "multi_give_way", "wind_flocking",
             "circle_trajectory", "line_trajectory", "goal", "vel_control"]
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
    """The port steps through the physics kernel exactly where the JAX
    package's step_supported takes its Pallas kernel (all seven)."""
    assert (cpu_env(scenario, 2).world._use_kernel
            == pallas_interpret.step_supported(jax_env(scenario).world))


@pytest.mark.parametrize("scenario", ["give_way", "multi_give_way",
                                      "wind_flocking"])
def test_masked_reset_zeroes_pid_state_of_reset_envs(scenario):
    """A masked reset zeroes the controllers' integrator and previous
    error in the envs it names and leaves the others' bits alone."""
    env = cpu_env(scenario, B, seed=2)
    for _ in range(3):
        env.step(env.get_random_actions())
    keys = [k for k in env.world.state.extras if ".pid_" in k]
    assert len(keys) == 2 * len(env.agents)
    before = {k: env.world.state.extras[k].clone() for k in keys}
    assert any(bool((v != 0).any()) for v in before.values())
    mask = torch.tensor([True, False] * (B // 2))
    env.reset_at(mask)
    for k in keys:
        after = env.world.state.extras[k]
        assert bool((after[mask] == 0).all()), k
        assert torch.equal(after[~mask], before[k][~mask]), k
