"""The port's scenarios (transport and simple_spread; the LIDAR worlds
navigation and flocking; balance; dispersion and
simple_speaker_listener): replay of the reference goldens, live parity
with the JAX env from one injected state, same-seed determinism, and the
heuristic policies against the JAX package's."""
import ast
import os
import sys

import numpy as np
import pytest
import torch

# The CPU tests run at small sizes, several test processes at once:
# PyTorch's intra-op threads would only contend with each other.
torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(__file__))
from torch_helpers import jax_state_arrays

import vectorizedmultiagentsimulator_tpu as vmt
import vectorizedmultiagentsimulator_tpu_torch as vmt_torch
from vectorizedmultiagentsimulator_tpu_torch.utils import (
    state_from_numpy,
    state_to_numpy,
)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
SCENARIOS = ["simple_spread", "transport", "navigation", "flocking", "balance",
             "dispersion", "simple_speaker_listener"]
# test_scenario_parity.py's default tolerance.
BASE, GROWTH, MAX_FRAC = 5e-4, 1.6, 0.25


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_scenario_golden(scenario):
    """``golden/scenario_<name>.npz`` replayed exactly as
    ``test_scenario_parity.py`` does: the recorded t=0 state injected, the
    recorded actions stepped, states compared with its divergence
    accounting."""
    data = np.load(os.path.join(GOLDEN, f"scenario_{scenario}.npz"),
                   allow_pickle=True)
    kwargs = ast.literal_eval(str(data["kwargs_json"]))
    B = data["pos"].shape[2]
    env = vmt_torch.make_env(scenario, num_envs=B, device="cpu", seed=0,
                             **kwargs)
    env.reset(seed=0)

    names = [str(n) for n in data["entity_names"]]
    mine = {e.name: e for e in env.world.entities}
    assert set(names) == set(mine)
    for i, n in enumerate(names):
        e = mine[n]
        e.set_pos(torch.as_tensor(data["pos"][0, i]))
        e.set_rot(torch.as_tensor(data["rot"][0, i]))
        e.set_vel(torch.as_tensor(data["vel"][0, i]))
        e.set_ang_vel(torch.as_tensor(data["ang_vel"][0, i]))

    sizes = [int(s) for s in data["action_sizes"]]
    assert sizes == [env.get_agent_action_size(a) for a in env.agents]
    diverged = np.zeros((B,), dtype=bool)
    for t in range(data["actions"].shape[0]):
        flat = data["actions"][t]
        acts, ofs = [], 0
        for size in sizes:
            acts.append(torch.as_tensor(flat[:, ofs:ofs + size]))
            ofs += size
        env.step(acts)
        atol = min(BASE * GROWTH**t, 0.05)
        for i, n in enumerate(names):
            for field in ("pos", "vel", "rot", "ang_vel"):
                got = getattr(mine[n].state, field).numpy()
                target = data[field][t + 1, i]
                bad = np.abs(got - target) > atol + 2e-3 * np.abs(target)
                diverged |= bad.any(axis=-1)
        assert diverged.mean() <= MAX_FRAC + 1e-9, (
            f"{scenario}: {diverged.sum()}/{B} envs diverged by step {t}"
        )


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_live_parity_with_jax(scenario, B=8, n_steps=10):
    """The JAX env's reset state carried into the port (state_from_numpy);
    both stepped with the same numpy actions; obs, rewards and dones agree
    at atol 1e-5 growing x1.6 a step (test_scenario_parity's growth)."""
    jenv = vmt.make_env(scenario, num_envs=B, seed=0)
    env = vmt_torch.make_env(scenario, num_envs=B, device="cpu", seed=1)
    if scenario == "transport":
        # Agents against the package's four sides, so the box-sphere
        # contacts act from the first step (entities: goal, package,
        # agents).
        pos = np.array(jenv.state.pos)
        offsets = np.array([[0.1, 0.0], [-0.1, 0.0], [0.0, 0.1], [0.0, -0.1]])
        pos[:, 2:] = pos[:, 1:2] + offsets
        jenv.state = jenv.state.replace(pos=pos)
    arrays = jax_state_arrays(jenv.state)
    assert set(arrays["extras"]) == set(env.world.state.extras)
    state_from_numpy(env, arrays)
    back = state_to_numpy(env)
    for f in ("pos", "vel", "u", "steps"):
        np.testing.assert_array_equal(back[f], arrays[f])

    rng = np.random.RandomState(0)
    sizes = [env.get_agent_action_size(a) for a in env.agents]
    for t in range(n_steps):
        acts = [rng.uniform(-1, 1, (B, s)).astype(np.float32) for s in sizes]
        j_obs, j_rew, j_done, _ = jenv.step(acts)
        obs, rew, done, _ = env.step([torch.as_tensor(a) for a in acts])
        atol = 1e-5 * 1.6**t
        for k in range(len(sizes)):
            np.testing.assert_allclose(obs[k].numpy(), np.asarray(j_obs[k]),
                                       atol=atol, err_msg=f"obs {k} step {t}")
            np.testing.assert_allclose(rew[k].numpy(), np.asarray(j_rew[k]),
                                       atol=atol, err_msg=f"rew {k} step {t}")
        np.testing.assert_array_equal(done.numpy(), np.asarray(j_done))


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_same_seed_same_trajectory(scenario, B=8, n_steps=5):
    def run(seed):
        env = vmt_torch.make_env(scenario, num_envs=B, device="cpu",
                                 seed=seed)
        out = [env.reset()]
        for _ in range(n_steps):
            out.append(env.step(env.get_random_actions())[0])
        return torch.stack([torch.cat(o, dim=-1) for o in out])

    a, b, c = run(3), run(3), run(4)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)


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
