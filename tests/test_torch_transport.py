"""The port's scenarios (transport and simple_spread; the LIDAR worlds
navigation and flocking; balance; dispersion and
simple_speaker_listener): replay of the reference goldens, live parity
with the JAX env from one injected state, same-seed determinism, and the
heuristic policies against the JAX package's."""
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
SCENARIOS = ["simple_spread", "transport", "navigation", "flocking", "balance",
             "dispersion", "simple_speaker_listener"]



@pytest.mark.parametrize("scenario", SCENARIOS)
def test_scenario_golden(scenario):
    """``golden/scenario_<name>.npz`` replayed exactly as
    ``test_scenario_parity.py`` does: the recorded t=0 state injected, the
    recorded actions stepped, states compared with its divergence
    accounting (``torch_helpers.replay_golden``)."""
    replay_golden(cpu_env, os.path.join(GOLDEN, f"scenario_{scenario}.npz"))


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_live_parity_with_jax(scenario, B=8, n_steps=10):
    """The JAX env's reset state carried into the port (state_from_numpy);
    both stepped with the same numpy actions; obs, rewards and dones agree
    at atol 1e-5 growing x1.6 a step (test_scenario_parity's growth)."""
    jenv = vmt.make_env(scenario, num_envs=B, seed=0)
    if scenario == "transport":
        # Agents against the package's four sides, so the box-sphere
        # contacts act from the first step (entities: goal, package,
        # agents).
        pos = np.array(jenv.state.pos)
        offsets = np.array([[0.1, 0.0], [-0.1, 0.0], [0.0, 0.1], [0.0, -0.1]])
        pos[:, 2:] = pos[:, 1:2] + offsets
        jenv.state = jenv.state.replace(pos=pos)
    live_parity(jenv, cpu_env(scenario, B, seed=1), n_steps)


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_same_seed_same_trajectory(scenario):
    same_seed_runs(cpu_env, scenario)


def test_transport_heuristic_matches_jax():
    from vectorizedmultiagentsimulator_tpu.scenarios.transport import (
        HeuristicPolicy as JaxPolicy,
    )
    from vectorizedmultiagentsimulator_tpu_torch.scenarios.transport import (
        HeuristicPolicy,
    )

    obs = np.random.RandomState(1).uniform(-1, 1, (16, 11)).astype(np.float32)
    ref = np.asarray(JaxPolicy().compute_action(obs, u_range=1.0))
    got = HeuristicPolicy().compute_action(torch.as_tensor(obs), u_range=1.0)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


@pytest.mark.parametrize("scenario,obs_dim,continuous", [
    ("navigation", 18, True),
    ("flocking", 18, True),
    ("balance", 16, True),
    ("balance", 16, False),
])
def test_heuristic_matches_jax(scenario, obs_dim, continuous):
    import importlib

    JaxPolicy = importlib.import_module(
        f"vectorizedmultiagentsimulator_tpu.scenarios.{scenario}"
    ).HeuristicPolicy
    Policy = importlib.import_module(
        f"vectorizedmultiagentsimulator_tpu_torch.scenarios.{scenario}"
    ).HeuristicPolicy

    rng = np.random.RandomState(2)
    obs = rng.uniform(-1, 1, (32, obs_dim)).astype(np.float32)
    if scenario == "flocking":
        obs[:, 6:18] = rng.uniform(0, 0.2, (32, 12))  # LIDAR distances
    ref = np.asarray(JaxPolicy(continuous).compute_action(obs, u_range=0.8))
    got = Policy(continuous).compute_action(torch.as_tensor(obs), u_range=0.8)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
