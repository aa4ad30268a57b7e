"""The port's fixed-length rollout (``parallel/rollout.py``) on the CPU,
where it runs its eager loop: held against the JAX package's ``lax.scan``
rollout from one carried state with one deterministic policy, the default
policy's range and seeding, the output structure, the state copy of a
graph's last step, the launch-count helpers, ``collect`` as a function,
and ``benchmark_step`` and the port's bench refusing to measure without a
card.  The CUDA graph
itself is held to this loop on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 6)."""
import dataclasses
import os
import sys

import jax.numpy as jnp
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
from vectorizedmultiagentsimulator_tpu.parallel import rollout as jax_rollout
from vectorizedmultiagentsimulator_tpu_torch import bench, ops
from vectorizedmultiagentsimulator_tpu_torch.core.state import WorldState
from vectorizedmultiagentsimulator_tpu_torch.parallel import rollout
from vectorizedmultiagentsimulator_tpu_torch.parallel.rollout import (
    _copy_state,
)
from vectorizedmultiagentsimulator_tpu_torch.utils import state_from_numpy
from vectorizedmultiagentsimulator_tpu_torch.utils.profiling import (
    benchmark_step,
)

# tests/test_scenario_parity.py's _DEFAULT: atol 5e-4 growing x1.6 a step
# (at most 0.05), plus 2e-3 relative; at most a quarter of the envs may
# leave it.
BASE, GROWTH, MAX_FRAC = 5e-4, 1.6, 0.25


def _weights(env, seed=0):
    """One [obs_d, action width] float32 matrix per agent, from numpy."""
    rng = np.random.RandomState(seed)
    obs = env.get_from_scenario(get_observations=True, get_rewards=False,
                                get_infos=False, get_dones=False)[0]
    return [(rng.randn(o.shape[1], env.get_agent_action_size(a)) * 0.5)
            .astype(np.float32) for o, a in zip(obs, env.agents)]


def _diverged(got, ref, t):
    """Per env: does step ``t``'s ``got`` leave the parity tolerance?"""
    got = got.reshape(got.shape[0], -1).astype(np.float64)
    ref = ref.reshape(ref.shape[0], -1).astype(np.float64)
    atol = min(BASE * GROWTH**t, 0.05)
    return (np.abs(got - ref) > atol + 2e-3 * np.abs(ref)).any(-1)


@pytest.mark.parametrize("scenario,kwargs", [
    ("simple_spread", {}),
    ("transport", dict(terminated_truncated=True, max_steps=3)),
])
def test_rollout_matches_jax(scenario, kwargs, B=4, n_steps=5):
    """The JAX env's reset state carried into the port; both rollouts
    driven by one linear-tanh policy of numpy weights; the stacked
    observations and rewards at the parity tolerance, the dones (or
    terminated and truncated, which truncate at step 3 here) equal."""
    jenv = vmt.make_env(scenario, num_envs=B, seed=0, **kwargs)
    env = vmt_torch.make_env(scenario, num_envs=B, device="cpu", seed=1,
                             **kwargs)
    state_from_numpy(env, jax_state_arrays(jenv.state))
    weights = _weights(env)
    j_w = [jnp.asarray(w) for w in weights]
    t_w = [torch.as_tensor(w) for w in weights]

    def j_policy(obs, key):
        return tuple(jnp.tanh(o @ w) for o, w in zip(obs, j_w))

    def t_policy(obs, generator):
        return [torch.tanh(o @ w) for o, w in zip(obs, t_w)]

    flags = (("terminated", "truncated") if kwargs else ("dones",))
    collect = ("obs", "rews") + flags
    _, j_traj = jax_rollout(jenv, j_policy, n_steps=n_steps, collect=collect)
    state, traj = rollout(env, t_policy, n_steps=n_steps, collect=collect)
    assert set(traj) == set(collect) == set(j_traj)
    assert state is env.world.state
    assert int(state.steps[0]) == n_steps
    diverged = np.zeros(B, dtype=bool)
    for key in ("obs", "rews"):
        assert len(traj[key]) == len(j_traj[key]) == env.n_agents
        for got, ref in zip(traj[key], j_traj[key]):
            got, ref = got.numpy(), np.asarray(ref)
            assert got.shape == ref.shape and got.shape[:2] == (n_steps, B)
            for t in range(n_steps):
                diverged |= _diverged(got[t], ref[t], t)
    assert diverged.mean() <= MAX_FRAC, diverged
    for key in flags:
        assert traj[key].shape == (n_steps, B)
        np.testing.assert_array_equal(traj[key].numpy(),
                                      np.asarray(j_traj[key]))
    if kwargs:
        assert traj["truncated"][2:].all() and not traj["truncated"][:2].any()


def test_default_policy_in_range_and_seeded(monkeypatch, B=6, n_steps=5):
    """The default policy draws each agent's actions uniform in its
    ``u_range`` from the rollout's generator: the same generator state
    gives the same trajectory, generator=None is a fresh seed-0 generator
    at every call, another seed another trajectory."""
    env = vmt_torch.make_env("navigation", num_envs=B, device="cpu", seed=0)
    taken = []
    step = env.step

    def spy(actions):
        taken.append([a.clone() for a in actions])
        return step(actions)

    monkeypatch.setattr(env, "step", spy)
    start, world_rng = env.world.state, env.world.generator.get_state()

    def run(generator):
        # the world rebinds the fields of the state object it holds
        env.world.bind(dataclasses.replace(start, extras=dict(start.extras)))
        env.world.generator.set_state(world_rng)
        return rollout(env, n_steps=n_steps, generator=generator)[1]

    a, b = run(None), run(None)
    seeded = run(torch.Generator().manual_seed(0))
    other = run(torch.Generator().manual_seed(1))
    for x, y, z in zip(a["obs"], b["obs"], seeded["obs"]):
        assert torch.equal(x, y) and torch.equal(x, z)
    assert not torch.equal(a["obs"][0], other["obs"][0])
    assert len(taken) == 4 * n_steps
    for actions in taken:
        for act, agent in zip(actions, env.agents):
            r = agent.action.u_range_tensor
            assert act.shape == (B, env.get_agent_action_size(agent))
            assert bool((act.abs() <= r).all()) and bool(act.std() > 0)


def test_rollout_structure_dict_spaces():
    """With ``dict_spaces`` the observations and rewards stack per agent
    name, with ``terminated_truncated`` the flags come as two keys; the
    loop refuses a CUDA graph on the CPU and a length that is not a whole
    number of chunks."""
    env = vmt_torch.make_env("football", num_envs=3, device="cpu", seed=0,
                             dict_spaces=True, terminated_truncated=True)
    _, traj = rollout(env, n_steps=2, collect=("obs", "rews", "terminated",
                                                "truncated"))
    names = [a.name for a in env.agents]
    assert list(traj["obs"]) == list(traj["rews"]) == names
    assert traj["obs"][names[0]].shape[:2] == (2, 3)
    assert traj["rews"][names[0]].shape == (2, 3)
    assert traj["terminated"].dtype == torch.bool
    assert traj["truncated"].shape == (2, 3)
    with pytest.raises(ValueError, match="CUDA graph"):
        rollout(env, n_steps=2, graph=True)
    with pytest.raises(ValueError, match="multiple"):
        rollout(env, n_steps=5, chunk=2)


def test_copy_state_reads_before_it_writes():
    """The graph's last step copies the final state into the static
    buffers; a final tensor that views another static buffer (a scenario
    keeping last step's positions) is read before that buffer is
    written."""
    def state(pos, extras):
        z = torch.zeros(2, 3, 2)
        return WorldState(pos=pos, vel=z.clone(), rot=z[..., :1].clone(),
                          ang_vel=z[..., :1].clone(), force=z.clone(),
                          torque=z[..., :1].clone(), c=z[..., :0].clone(),
                          u=z.clone(), action_c=z[..., :0].clone(),
                          steps=torch.zeros(2, dtype=torch.int32),
                          extras=extras)

    static = state(torch.arange(12.0).reshape(2, 3, 2),
                   {"a.prev": torch.zeros(2, 2)})
    old = static.pos[:, 1].clone()
    final = state(static.pos + 100, {"a.prev": static.pos[:, 1]})
    _copy_state(static, final)
    assert torch.equal(static.pos, torch.arange(12.0).reshape(2, 3, 2) + 100)
    assert torch.equal(static.extras["a.prev"], old)
    with pytest.raises(RuntimeError, match="extras"):
        _copy_state(static, state(static.pos, {}))


def test_launch_count_helpers():
    """``ops.launch_counts`` reads every wrapper's count by kernel;
    ``set_launch_counts`` sets the ones it names and restores."""
    before = ops.launch_counts()
    assert set(before) == {"physics_step", "raycast", "football_policy",
                           "ppo_update", "agent_geometry", "pair_collisions",
                           "neighbor_obs"}
    try:
        ops.set_launch_counts({"physics_step": before["physics_step"] + 3,
                               "neighbor_obs": before["neighbor_obs"] + 2})
        now = ops.launch_counts()
        assert now["physics_step"] == before["physics_step"] + 3
        assert now["neighbor_obs"] == before["neighbor_obs"] + 2
        assert now["raycast"] == before["raycast"]
    finally:
        ops.set_launch_counts(before)
    assert ops.launch_counts() == before


def test_rollout_collect_function(B=3, n_steps=4):
    """``collect`` as a function of the step's outputs: its result of
    every step stacked on the time axis, equal to what the names collect
    from the same start."""
    env = vmt_torch.make_env("transport", num_envs=B, device="cpu", seed=0)
    start = env.world.state

    def run(collect):
        env.world.bind(dataclasses.replace(start, extras=dict(start.extras)))
        return rollout(env, n_steps=n_steps, collect=collect)[1]

    by_name = run(("rews",))
    summed = run(lambda env, outs: {"total": sum(outs[1]),
                                    "first": [outs[0][0][:, :2]]})
    assert summed["total"].shape == (n_steps, B)
    assert torch.equal(summed["total"], sum(by_name["rews"]))
    assert summed["first"][0].shape == (n_steps, B, 2)


def test_measurements_need_the_card(monkeypatch, capsys):
    """``benchmark_step`` raises on a CPU env, and the port's bench exits
    with an error and prints no result on a machine without a card."""
    env = vmt_torch.make_env("transport", num_envs=2, device="cpu", seed=0)
    with pytest.raises(RuntimeError, match="card"):
        benchmark_step(env, n_steps=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        bench.main()
    assert exc.value.code != 0
    assert "{" not in capsys.readouterr().out
