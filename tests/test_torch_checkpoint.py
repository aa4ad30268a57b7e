"""The port's checkpoints (``utils/checkpoint.py``): save, restore into a
fresh env of the same scenario and kwargs, and continue equal to the bit
to the run that was never interrupted, for every scenario (road_traffic on
maps '1', '2' and '3'), eagerly and through ``parallel/rollout.py``; a
JAX package checkpoint loads and gives the JAX env's observations."""
import os
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(__file__))
from torch_helpers import cpu_env  # noqa: E402

import vectorizedmultiagentsimulator_tpu as vmt_jax  # noqa: E402
import vectorizedmultiagentsimulator_tpu_torch as vmt  # noqa: E402
from vectorizedmultiagentsimulator_tpu_torch.scenarios import (  # noqa: E402
    names as scenario_names,
)
from vectorizedmultiagentsimulator_tpu.utils import (  # noqa: E402
    checkpoint as jax_checkpoint,
)
from vectorizedmultiagentsimulator_tpu_torch.parallel import (  # noqa: E402
    rollout,
)
from vectorizedmultiagentsimulator_tpu_torch.utils import (  # noqa: E402
    checkpoint,
)

B = 4
N_STEPS = 4
CASES = {name: {} for name in scenario_names()}
CASES["road_traffic map 2"] = dict(map_type="2")
CASES["road_traffic map 3"] = dict(map_type="3", n_agents=10)


def _scenario(case):
    return case.split(" ")[0]


def _outputs(outs):
    """A step's observations, rewards and dones as one float tensor."""
    obs, rews, dones = outs[:3]
    return torch.cat([x.reshape(B, -1).float() for x in obs]
                     + [r.reshape(B, -1).float() for r in rews]
                     + [dones.reshape(B, -1).float()], dim=-1)


def _random_steps(env, n):
    """``n`` steps of uniform actions drawn from the world's generator."""
    return torch.cat([_outputs(env.step(env.get_random_actions()))
                      for _ in range(n)], dim=-1)


def _assert_bit_equal(a, b):
    assert torch.equal(torch.isnan(a), torch.isnan(b))
    assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))


@pytest.mark.parametrize("case", sorted(CASES))
def test_restore_continues_bit_equal(case, tmp_path):
    kwargs = CASES[case]
    path = str(tmp_path / "ckpt.npz")
    env = cpu_env(_scenario(case), B, seed=1, **kwargs)
    _random_steps(env, N_STEPS)
    checkpoint.save_env(path, env)
    want = _random_steps(env, N_STEPS)
    # Another seed and another history: everything must come from the file.
    fresh = cpu_env(_scenario(case), B, seed=7, **kwargs)
    _random_steps(fresh, 2)
    checkpoint.restore_env(path, fresh)
    _assert_bit_equal(_random_steps(fresh, N_STEPS), want)


@pytest.mark.parametrize("case", ["transport", "road_traffic map 2"])
def test_restore_continues_bit_equal_through_rollout(case, tmp_path):
    """The same through ``rollout`` (its eager loop on the CPU), the
    world's generator drawing the policy's actions."""
    kwargs = CASES[case]
    path = str(tmp_path / "ckpt.npz")

    def run(env):
        _, traj = rollout(env, n_steps=N_STEPS, generator=env.world.generator)
        return torch.cat([_outputs([[o[t] for o in traj["obs"]],
                                    [r[t] for r in traj["rews"]],
                                    traj["dones"][t]])
                          for t in range(N_STEPS)], dim=-1)

    env = cpu_env(_scenario(case), B, seed=1, **kwargs)
    run(env)
    checkpoint.save_env(path, env)
    want = run(env)
    fresh = cpu_env(_scenario(case), B, seed=7, **kwargs)
    checkpoint.restore_env(path, fresh)
    _assert_bit_equal(run(fresh), want)


@pytest.mark.parametrize("name,kwargs", [
    ("dispersion", {}),
    ("navigation", dict(n_agents=2)),
])
def test_a_jax_checkpoint_gives_the_jax_observations(name, kwargs, tmp_path):
    """A file written by the JAX package's ``utils/checkpoint.save`` loads
    into the port (its PRNG key ignored): the port's observations at that
    state are the JAX env's, at ``held_in_parity``'s first-step
    tolerance."""
    path = str(tmp_path / "jax_ckpt.npz")
    jenv = vmt_jax.make_env(name, num_envs=B, seed=3, jit_compile=False,
                            **kwargs)
    jax_checkpoint.save(path, jenv.state)
    env = cpu_env(name, B, seed=0, **kwargs)
    rng = env.world.generator.get_state()
    checkpoint.restore_env(path, env)
    assert torch.equal(env.world.generator.get_state(), rng)
    want = jenv.get_from_scenario(get_observations=True, get_rewards=False,
                                  get_infos=False, get_dones=False)[0]
    got = env.get_from_scenario(get_observations=True, get_rewards=False,
                                get_infos=False, get_dones=False)[0]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_a_checkpoint_of_another_scenario_is_refused(tmp_path):
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save_env(path, cpu_env("transport", B))
    with pytest.raises(ValueError, match="mismatch"):
        checkpoint.restore_env(path, cpu_env("balance", B))
    with pytest.raises(ValueError, match="shape"):
        checkpoint.restore_env(path, cpu_env("transport", B + 1))
