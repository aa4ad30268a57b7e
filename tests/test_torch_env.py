"""The port's env front end: the closed-form action mapping of
``test_actions.py``, the verify probes, and a check that the port never
imports JAX."""
import math
import os
import random
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

# The CPU tests run at small sizes, several test processes at once:
# PyTorch's intra-op threads would only contend with each other.
torch.set_num_threads(1)

import vectorizedmultiagentsimulator_tpu_torch as vmt_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "vectorizedmultiagentsimulator_tpu_torch")


def _full_nvec(agent, world):
    return list(agent.discrete_action_nvec) + (
        [world.dim_c] if not agent.silent and world.dim_c != 0 else []
    )


@pytest.mark.parametrize("multidiscrete", [True, False])
def test_discrete_action_nvec(multidiscrete, num_envs=6, n_steps=3):
    env = vmt_torch.make_env(
        "transport", num_envs=num_envs, device="cpu", seed=0,
        multidiscrete_actions=multidiscrete, continuous_actions=False,
    )
    random.seed(0)
    for agent in env.world.agents:
        agent.discrete_action_nvec = [
            random.randint(2, 6) for _ in range(agent.action_size)
        ]
    env.action_space = env.get_action_space()

    def to_multidiscrete(action, nvec):
        out = []
        for i in range(len(nvec)):
            n = math.prod(nvec[i + 1:])
            out.append(action // n)
            action = action % n
        return torch.stack(out, dim=-1)

    for _ in range(n_steps):
        actions = env.get_random_actions()
        for a_batch, s in zip(actions, env.action_space.spaces):
            for a in a_batch.numpy():
                assert s.contains(a)
        env.step(actions)
        if not multidiscrete:
            actions = [
                to_multidiscrete(a.reshape(-1), _full_nvec(agent, env.world))
                for a, agent in zip(actions, env.world.policy_agents)
            ]
        for i_a, agent in enumerate(env.world.policy_agents):
            for i, n in enumerate(agent.discrete_action_nvec):
                a = actions[i_a][:, i].numpy()
                u = agent.action.u[:, i].numpy()
                U = float(agent.action.u_range_tensor[i])
                k = float(agent.action.u_multiplier_tensor[i])
                for aj, uj in zip(a, u):
                    assert 0 <= aj < n
                    if n % 2 != 0:
                        assert aj != 0 or np.isclose(uj, 0), (aj, uj, n)
                        if 1 <= aj <= n // 2:
                            assert np.isclose(
                                uj / k, (2 * U * (aj - 1)) / (n - 1) - U,
                                atol=1e-6,
                            ), (aj, uj, n)
                        if aj > n // 2:
                            assert np.isclose(
                                uj / k, 2 * U * (aj / (n - 1)) - U, atol=1e-6
                            ), (aj, uj, n)
                    else:
                        assert np.isclose(
                            uj / k, 2 * U * (aj / (n - 1)) - U, atol=1e-6
                        ), (aj, uj, n)


def test_discrete_equals_multidiscrete(num_envs=6, n_steps=3):
    kw = dict(num_envs=num_envs, device="cpu", seed=0, continuous_actions=False)
    env = vmt_torch.make_env("transport", multidiscrete_actions=False, **kw)
    env_multi = vmt_torch.make_env("transport", multidiscrete_actions=True, **kw)
    for _ in range(n_steps):
        actions_multi = env_multi.get_random_actions()
        actions = []
        for a_multi, agent in zip(actions_multi, env.world.policy_agents):
            nvec = _full_nvec(agent, env.world)
            prods = torch.tensor([math.prod(nvec[i + 1:]) for i in range(len(nvec))])
            actions.append((a_multi * prods).sum(dim=1))
        env_multi.step(actions_multi)
        env.step(actions)
        for agent, agent_multi in zip(
            env.world.policy_agents, env_multi.world.policy_agents
        ):
            torch.testing.assert_close(
                agent.action.u, agent_multi.action.u, rtol=0, atol=1e-6
            )


def test_continuous_actions_scaled_and_clamped(num_envs=4):
    env = vmt_torch.make_env(
        "transport", num_envs=num_envs, device="cpu", seed=0,
        clamp_actions=True,
    )
    env.step([torch.full((num_envs, 2), 10.0) for _ in env.agents])
    for agent in env.agents:
        # u_range 1, u_multiplier 0.6 (transport.py)
        torch.testing.assert_close(
            agent.action.u, torch.full((num_envs, 2), 0.6)
        )
        torch.testing.assert_close(agent.state.force, agent.action.u)


def test_probe_wrong_action_width():
    env = vmt_torch.make_env("transport", num_envs=4, device="cpu", seed=0)
    with pytest.raises(AssertionError, match="Action for agent .* has shape"):
        env.step([torch.zeros(4, 3) for _ in env.agents])


def test_probe_unknown_scenario():
    with pytest.raises(AssertionError, match="scenario not found."):
        vmt_torch.make_env("no_such_scenario", num_envs=4, device="cpu")


def test_probe_reset_at_out_of_range():
    env = vmt_torch.make_env("simple_spread", num_envs=4, device="cpu", seed=0)
    with pytest.raises(AssertionError, match="Index must be between"):
        env.reset_at(4)
    before = [o.clone() for o in env.reset()]
    after = env.reset_at(1)
    for b, a in zip(before, after):
        assert torch.equal(a[[0, 2, 3]], b[[0, 2, 3]])
        assert not torch.equal(a[1], b[1])


def test_make_env_defaults_to_the_card():
    """No ``device`` means the CUDA card; without one, make_env raises and
    names ``device="cpu"`` as the way to run on the CPU."""
    if torch.cuda.is_available():
        env = vmt_torch.make_env("transport", num_envs=2, seed=0)
        assert env.device.type == "cuda" and env.world.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match='device="cpu"'):
        vmt_torch.make_env("transport", num_envs=2, seed=0)


def test_port_never_imports_jax():
    pattern = re.compile(
        r"^\s*(import|from) (jax|flax|vectorizedmultiagentsimulator_tpu)(\.|\s|$)"
    )
    sources = [os.path.join(ROOT, "chip_smoke.py")] + [
        os.path.join(dirpath, f)
        for dirpath, _, files in os.walk(PKG)
        for f in files
        if f.endswith(".py")
    ]
    for path in sources:
        with open(path) as fh:
            for i, line in enumerate(fh, 1):
                assert not pattern.match(line), f"{path}:{i}: {line}"
    code = (
        "import importlib, pkgutil, sys\n"
        "import vectorizedmultiagentsimulator_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "for name in ('transport', 'navigation', 'football', 'road_traffic'):\n"
        "    env = p.make_env(name, num_envs=2, device='cpu')\n"
        "    env.step(env.get_random_actions())\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'flax', 'vectorizedmultiagentsimulator_tpu')]\n"
        "print(sorted(bad))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=60,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_rollout_and_reseed(num_envs=4, n_steps=3):
    """``rollout(env, n_steps=...)`` stacks the outputs on a leading time
    axis; ``reset(seed=...)`` restarts the world's generator, so the spawn
    repeats, and the same rollout from there (the default policy's
    generator seeded 0 at each call) gives the same trajectory."""
    from vectorizedmultiagentsimulator_tpu_torch.parallel import rollout

    env = vmt_torch.make_env(
        "simple_spread", num_envs=num_envs, device="cpu", seed=0
    )
    first = env.reset(seed=5)
    state, traj = rollout(env, n_steps=n_steps)
    assert state is env.world.state
    assert all(len(traj[k]) == env.n_agents for k in ("obs", "rews"))
    assert traj["obs"][0].shape == (n_steps, num_envs, 14)
    assert traj["rews"][0].shape == (n_steps, num_envs)
    assert traj["dones"].shape == (n_steps, num_envs)
    assert traj["dones"].dtype == torch.bool
    again = env.reset(seed=5)
    for a, b in zip(first, again):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    _, replay = rollout(env, n_steps=n_steps)
    for a, b in zip(traj["obs"], replay["obs"]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


SCENARIOS = ["transport", "simple_spread", "navigation", "flocking", "balance",
             "dispersion", "simple_speaker_listener", "football"]


def _state_rows(env):
    s = env.world.state
    return torch.cat([s.pos.flatten(1), s.vel.flatten(1), s.rot.flatten(1)], 1)


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_masked_reset_changes_only_masked_envs(scenario, num_envs=6):
    """``reset_at`` with a ``[B]`` bool tensor: the envs it names are reset
    (steps to 0, new spawn), the others keep their state to the bit, and
    the observations of all envs come back."""
    env = vmt_torch.make_env(scenario, num_envs=num_envs, device="cpu", seed=0)
    for _ in range(3):
        env.step(env.get_random_actions())
    before = _state_rows(env).clone()
    mask = torch.tensor([False, True, False, True, True, False])
    obs = env.reset_at(mask)
    after = _state_rows(env)
    assert torch.equal(after[~mask], before[~mask])
    assert not any(torch.equal(after[i], before[i]) for i in (1, 3, 4))
    assert torch.equal(env.steps, torch.where(mask, 0, 3))
    assert len(obs) == env.n_agents
    assert all(o.shape[0] == num_envs and bool(torch.isfinite(o).all())
               for o in obs)


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_one_hot_mask_equals_reset_at_index(scenario, num_envs=5):
    """From the same generator state, ``reset_at(i)`` and ``reset_at`` of
    the one-hot mask of ``i`` leave the same state."""
    envs = [vmt_torch.make_env(scenario, num_envs=num_envs, device="cpu",
                               seed=3) for _ in range(3)]
    actions = envs.pop().get_random_actions()  # draws from its own generator
    for env in envs:
        env.step(actions)
    obs_i = envs[0].reset_at(2)
    obs_m = envs[1].reset_at(torch.arange(num_envs) == 2)
    assert torch.equal(_state_rows(envs[0]), _state_rows(envs[1]))
    for a, b in zip(obs_i, obs_m):
        assert torch.equal(a, b)


def _spawn_world(batch, seed=0):
    from vectorizedmultiagentsimulator_tpu_torch.core import Agent, World

    world = World(batch, "cpu")
    world.add_agent(Agent(name="a"))
    world.finalize(seed=seed)
    return world


def test_spawner_respects_min_dist_with_and_without_a_mask():
    from vectorizedmultiagentsimulator_tpu_torch.utils import ScenarioUtils

    B, M, min_d = 64, 5, 0.25
    world = _spawn_world(B)
    occupied = torch.rand((B, 2, 2)) * 2 - 1
    for env_index in (None, torch.rand(B) > 0.5):
        pos = ScenarioUtils.find_random_positions_for_entities(
            occupied, M, world, min_d, (-1, 1), (-1, 1), env_index=env_index)
        assert pos.shape == (B, M, 2)
        assert bool((pos.abs() <= 1).all())
        points = torch.cat([occupied, pos], dim=1)
        dist = torch.cdist(points, points)[:, 2:]  # new entities to all
        dist[:, torch.arange(M), torch.arange(M) + 2] = float("inf")
        assert float(dist.min()) >= min_d
    assert int(world.spawn_give_ups) == 0
    # The masked path's rounds come from static facts only.
    assert ScenarioUtils.spawn_rounds(2, M, min_d, (-1, 1), (-1, 1), 16) == 2
    assert ScenarioUtils.spawn_rounds(0, 1, min_d, (-1, 1), (-1, 1), 16) == 1


def test_spawner_counts_give_ups_on_the_device():
    """A world too small for its entities: a masked respawn stops after its
    fixed rounds, places the entities at the give-up proposals and counts
    them, for the masked envs only."""
    from vectorizedmultiagentsimulator_tpu_torch.utils import ScenarioUtils

    B, M = 8, 3
    world = _spawn_world(B)
    mask = torch.arange(B) < 4
    pos = ScenarioUtils.find_random_positions_for_entities(
        torch.zeros((B, 1, 2)), M, world, 10.0, (-1, 1), (-1, 1),
        env_index=mask)
    assert bool(torch.isfinite(pos).all()) and bool((pos.abs() <= 1).all())
    assert int(world.spawn_give_ups) == 4 * M
    # Distinct give-up proposals, so entities never collapse onto a point.
    assert float(torch.cdist(pos, pos)[:, 0, 1:].min()) > 0


@pytest.mark.parametrize("proposals", [None, 4])
def test_spawner_replace_mask_keeps_rows(proposals):
    """Per-step respawns: rows where ``replace_mask`` is False keep their
    current position and still block the others."""
    from vectorizedmultiagentsimulator_tpu_torch.utils import ScenarioUtils

    B, M, min_d = 32, 4, 0.3
    world = _spawn_world(B, seed=1)
    current = ScenarioUtils.find_random_positions_for_entities(
        torch.zeros((B, 0, 2)), M, world, min_d, (-1, 1), (-1, 1))
    replace = torch.rand((B, M)) > 0.5
    new = ScenarioUtils.find_random_positions_for_entities(
        torch.zeros((B, 0, 2)), M, world, min_d, (-1, 1), (-1, 1),
        current_positions=current, replace_mask=replace,
        proposals_per_round=proposals, env_index=torch.ones(B, dtype=torch.bool),
    )
    assert torch.equal(new[~replace], current[~replace])
    assert not bool((new[replace] == current[replace]).all(dim=-1).any())
    dist = torch.cdist(new, new)
    dist[:, torch.arange(M), torch.arange(M)] = float("inf")
    assert float(dist.min()) >= min_d
    assert int(world.spawn_give_ups) == 0
