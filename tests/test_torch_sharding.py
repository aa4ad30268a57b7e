"""The env-batch split (``parallel/sharding.py``) in one process: shards
made with an explicit rank and world size, no process group.

For each scenario of ``torch_helpers.SHARD_CASES`` at B = 8 over 2 ranks:
3 steps of given actions equal the unsharded env's rows to the bit (every
output, state field and extras buffer); from the JAX package's state, split
by its ``shard_environment`` over a 2-device CPU mesh (``conftest.py``'s 8
virtual devices), each shard matches its rows of the JAX env at the
live-parity tolerances (``torch_helpers.held_in_parity``; joint_passage
as ``tests/test_torch_joints.py`` holds its live parity, its stiff joints
growing an ulp to about 1e-4 in one step), five scenarios here and the
others in ``tests/test_torch_sharding_jax.py`` and
``test_torch_sharding_road_joint.py`` (``JAX_GROUPS``).  A split repeats under the same seed and world size, the
ranks draw different resets, and a batch the ranks do not divide raises.
"""
import os
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(__file__))
from torch_helpers import (  # noqa: E402
    SHARD_CASES,
    cpu_env,
    planner_draws,
    shards_match_jax,
    shards_step_as_global,
)

import vectorizedmultiagentsimulator_tpu as vmt  # noqa: E402
from vectorizedmultiagentsimulator_tpu.parallel import (  # noqa: E402
    make_mesh as jax_make_mesh,
    shard_environment as jax_shard_environment,
)
from vectorizedmultiagentsimulator_tpu_torch.parallel import (  # noqa: E402
    make_mesh,
    rank_seed,
    shard_environment,
    shard_state,
)

B = 8
# The scenarios each file holds to the JAX package's shards: each JAX env's
# compiles take 5-40 s on one core, so three files share them.
JAX_GROUPS = {
    "test_torch_sharding": ("transport", "navigation", "wind_flocking",
                            "give_way", "drone"),
    "test_torch_sharding_jax": ("discovery", "sampling", "football"),
    "test_torch_sharding_road_joint": ("road_traffic", "joint_passage"),
}
assert sorted(sum(JAX_GROUPS.values(), ())) == sorted(SHARD_CASES)


def jax_sharded_env(scenario, monkeypatch, n=2):
    """The JAX package's env of ``scenario`` at B envs, its state split over
    ``n`` CPU devices by its own ``shard_environment``; football's planner
    samples fixed to ``torch_helpers.planner_draws`` (the env is jitted, so
    the patched draw is fixed at trace time and serves every step)."""
    kwargs = SHARD_CASES[scenario]
    if scenario == "football":
        normal = jax.random.normal

        def fixed_normal(key, shape=(), dtype=jnp.float32):
            if len(shape) == 4 and shape[0] == B and shape[-1] == 2:
                return jnp.asarray(planner_draws(B, *shape[1:3]), dtype)
            return normal(key, shape, dtype)

        monkeypatch.setattr(jax.random, "normal", fixed_normal)
    jenv = vmt.make_env(scenario, num_envs=B, seed=0, **kwargs)
    jax_shard_environment(jenv, jax_make_mesh(n))
    assert len(jenv.state.pos.sharding.device_set) == n
    return jenv


@pytest.mark.parametrize("scenario", sorted(SHARD_CASES))
def test_shards_step_as_the_global_env(scenario):
    shards_step_as_global(scenario, SHARD_CASES[scenario], B=B)


def jax_shard_parity(scenario, monkeypatch):
    jenv = jax_sharded_env(scenario, monkeypatch)
    env = cpu_env(scenario, B, **SHARD_CASES[scenario])
    shards_match_jax(jenv, env, joint=scenario == "joint_passage")


@pytest.mark.parametrize("scenario", JAX_GROUPS["test_torch_sharding"])
def test_shards_match_jax_shards(scenario, monkeypatch):
    jax_shard_parity(scenario, monkeypatch)


def _split_rollout(scenario, seed, n, steps=3):
    """Each rank's observations over a full reset and ``steps`` random
    steps, both drawn from the rank's own generator."""
    env = cpu_env(scenario, B, seed=seed, **SHARD_CASES[scenario])
    out = []
    for r in range(n):
        shard = shard_environment(env, rank=r, world_size=n)
        obs = [torch.cat(shard.reset(), -1)]
        for _ in range(steps):
            obs.append(torch.cat(shard.step(shard.get_random_actions())[0],
                                 -1))
        out.append(torch.stack(obs))
    return out


@pytest.mark.parametrize("scenario", ["transport", "discovery",
                                      "road_traffic", "football"])
def test_split_repeats_and_ranks_draw_their_own(scenario):
    a, b = _split_rollout(scenario, 3, 2), _split_rollout(scenario, 3, 2)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert not torch.equal(a[0][0], a[1][0])  # the ranks' resets differ
    # rank 0 keeps the seed: a world of one draws what the env draws
    env = cpu_env(scenario, B, seed=3, **SHARD_CASES[scenario])
    one = shard_environment(env, rank=0, world_size=1)
    assert torch.equal(one.world.generator.get_state(),
                       torch.Generator().manual_seed(3).get_state())
    assert rank_seed(3, 0) == 3 and len({rank_seed(3, r)
                                         for r in range(64)}) == 64


def test_a_batch_the_ranks_do_not_divide_raises():
    env = cpu_env("transport", 6)
    with pytest.raises(ValueError, match="divisible by the number of mesh"):
        shard_environment(env, rank=0, world_size=4)
    with pytest.raises(ValueError, match="divisible by the number of mesh"):
        shard_state(env.world.state, make_mesh(rank=1, world_size=4), 6)
    with pytest.raises(RuntimeError, match="needs a process group"):
        make_mesh(2)
    assert make_mesh().size == 1 and not make_mesh().distributed


def test_shard_state_rows_and_the_global_env_untouched():
    env = cpu_env("road_traffic", B, **SHARD_CASES["road_traffic"])
    before = {k: v.clone() for k, v in env.world.state.extras.items()}
    shard = shard_environment(env, rank=1, world_size=4)
    assert shard.num_envs == shard.world.batch_dim == 2
    torch.testing.assert_close(shard.world.state.pos,
                               env.world.state.pos[2:4], rtol=0, atol=0)
    for k, v in before.items():
        torch.testing.assert_close(env.world.state.extras[k], v, rtol=0,
                                   atol=0)
        assert shard.world.state.extras[k].shape[0] == 2
    # the shard's buffers are its own, not views of the global env's
    shard.world.state.pos.add_(1.0)
    torch.testing.assert_close(env.world.state.pos[2:4],
                               shard.world.state.pos - 1.0)
