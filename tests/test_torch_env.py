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
        "for name in ('transport', 'navigation'):\n"
        "    env = p.make_env(name, num_envs=2, device='cpu')\n"
        "    env.step(env.get_random_actions())\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'flax', 'vectorizedmultiagentsimulator_tpu')]\n"
        "print(sorted(bad))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_rollout_and_reseed(num_envs=4, n_steps=3):
    from vectorizedmultiagentsimulator_tpu_torch.parallel import rollout

    env = vmt_torch.make_env(
        "simple_spread", num_envs=num_envs, device="cpu", seed=0
    )
    first = env.reset(seed=5)
    actions = [env.get_random_actions() for _ in range(n_steps)]
    traj = rollout(env, n_steps, actions)
    assert all(len(traj[k]) == n_steps for k in ("obs", "rews", "dones"))
    assert traj["obs"][-1][0].shape == (num_envs, 14)
    assert traj["dones"][-1].dtype == torch.bool
    # reset(seed=...) restarts the generator, so the spawn repeats, and the
    # same actions give the same trajectory.
    again = env.reset(seed=5)
    for a, b in zip(first, again):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    replay = rollout(env, n_steps, actions)
    for a, b in zip(traj["obs"][-1], replay["obs"][-1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
