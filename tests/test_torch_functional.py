"""The port's functional API (``Environment.state``, ``step_fn``,
``reset_fn``, ``reset_at_fn``; the JAX package's environment.py:112-181)
on the CPU, the port alone:

* every one of the 41 scenarios at 4 envs over 2 steps
  (``torch_helpers.functional_checks``): ``step_fn`` and ``reset_at_fn``
  leave their input state as it was, to the bit (leaves and extras keys),
  and the state the world holds; two branches with equal generator
  states are equal to the bit; ``env.state = s`` then ``env.step`` equals
  the ``step_fn`` chain and leaves ``s`` as it was;
* road_traffic map '2' (``test_torch_road_traffic_map2.py``'s recording
  setup): a ``step_fn`` that records and a ``reset_at_fn`` that replays
  leave the input state's ring and initial-state buffer untouched;
* the LIDAR casts (``World._CastGroup``) after functional calls from two
  other states are those of the state the world holds;
* ``reset_fn``, ``dict_spaces`` / ``terminated_truncated`` outputs, a
  call that raises, a frame between ``env.state = s`` and a step,
  ``to(device)``, ``WorldState.replace`` / ``clone``, the gradient with
  respect to the state.

``test_torch_functional_jax*.py`` hold ``step_fn`` and the state's
gradient against the JAX package's."""
import os
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(__file__))
from torch_helpers import (  # noqa: E402
    cpu_env,
    differing_leaves,
    functional_checks,
    generator_at,
    tree_leaves,
)

from vectorizedmultiagentsimulator_tpu_torch.scenarios import (  # noqa: E402
    names,
)

B, N_STEPS = 4, 2
# test_torch_road_traffic_map2.py's settings: no observation noise, every
# collision recorded, every reset replaying a recorded row (a buffer of 2).
MAP2 = dict(map_type="2", is_add_noise=False, n_agents=8,
            initial_state_buffer_size=2, probability_record=1.0,
            probability_use_recording=1.0)


def random_actions(env, n, seed=1):
    g = torch.Generator(device=env.device).manual_seed(seed)
    return [env.get_random_actions(g) for _ in range(n)]


@pytest.mark.parametrize("scenario", names())
def test_functional_api(scenario):
    env = cpu_env(scenario, B)
    functional_checks(env, random_actions(env, N_STEPS))


@pytest.mark.parametrize("kwargs", [
    dict(dict_spaces=True),
    dict(terminated_truncated=True, max_steps=2),
    dict(continuous_actions=False),
])
def test_functional_api_output_forms(kwargs):
    """``step_fn`` and ``reset_at_fn`` give what ``step`` and ``reset_at``
    give under each output and action form (dicts keyed by agent name,
    terminated and truncated, discrete actions)."""
    env = cpu_env("navigation", B, **kwargs)
    _, _, outs = functional_checks(env, random_actions(env, 3))
    want = 5 if kwargs.get("terminated_truncated") else 4
    assert all(isinstance(o, tuple) and len(o) == want for o in outs)
    if kwargs.get("dict_spaces"):
        assert set(outs[0][0]) == {a.name for a in env.agents}


def map2_buffers(state):
    return {k: state.extras[f"scenario.{k}"] for k in ("state_hist",
                                                       "isb_buf")}


def test_map2_buffers_untouched_by_functional_calls():
    """A ``step_fn`` that records a collision into the initial-state buffer
    and a ``reset_at_fn`` that replays it leave the input state's ring and
    buffer (their storage and values) as they were; the step and the reset
    do what ``env.step`` and ``env.reset_at`` do."""
    env = cpu_env("road_traffic", B, **MAP2)
    actions = random_actions(env, 3, seed=2)
    # The second vehicle on top of the first, in every env: the first step
    # records.
    i, j = (a.index for a in env.world.agents[:2])
    pos = env.world.state.pos.clone()
    pos[:, j] = pos[:, i] + 0.02
    state, recorded = env.state.replace(pos=pos), None
    for a in actions:
        before = {k: (v.data_ptr(), v.clone())
                  for k, v in map2_buffers(state).items()}
        new, _ = env.step_fn(state, a)
        for k, (ptr, value) in before.items():
            buf = map2_buffers(state)[k]
            assert buf.data_ptr() == ptr and torch.equal(buf, value), k
            assert map2_buffers(new)[k].data_ptr() != ptr, k
        grew = (new.extras["scenario.isb_len"]
                > state.extras["scenario.isb_len"])
        state = new
        if bool(grew.any()):
            recorded = grew
            break
    assert recorded is not None, "no step recorded a collision"
    copy = state.clone()
    mask = torch.ones((B,), dtype=torch.bool)
    g0 = env.world.generator.get_state()
    reset, _ = env.reset_at_fn(state, mask, generator=generator_at(g0, "cpu"))
    assert not differing_leaves(state, copy)
    # Every env with a recorded row starts from one: its first agent's pose
    # is a row of its buffer.
    rows = state.extras["scenario.isb_buf"][:, :, 0, 0:2]     # [B, S, 2]
    pos = reset.pos[:, env.world.agents[0].index]             # [B, 2]
    has = state.extras["scenario.isb_len"] > 0
    hit = (rows == pos[:, None]).all(-1).any(-1)
    assert bool(hit[has].all()) and bool(has.any())
    env.state = state
    env.world.generator.set_state(g0)
    env.reset_at(mask)
    assert not differing_leaves(env.world.state, reset)
    assert not differing_leaves(state, copy)


def test_state_set_stays_the_callers_across_a_frame():
    """``env.state = s``, a frame, then ``env.step`` on map '2' (whose
    step writes two buffers in place) leave ``s`` as it was: the frame
    binds its one-env state through ``World.functional`` and puts back
    the world's state as it held it, borrowed."""
    env = cpu_env("road_traffic", 2, map_type="2", n_agents=4)
    state = env.state
    copy = state.clone()
    env.state = state
    env.render(mode="rgb_array")
    env.step(random_actions(env, 1)[0])
    assert not differing_leaves(state, copy)


@pytest.mark.parametrize("scenario", ["navigation", "discovery"])
def test_lidar_casts_follow_the_state_read(scenario):
    """Observations of the state the world holds, read before and after
    ``step_fn`` calls from two other states, are equal to the bit (each
    LIDAR cast is of the state it reads), and the next ``env.step`` equals
    that of an env that made no functional call."""
    envs = [cpu_env(scenario, B) for _ in range(2)]
    actions = random_actions(envs[0], 4)
    for env in envs:
        env.step(actions[0])
    a_state = envs[0].state
    for env in envs:
        env.step(actions[1])
    b_state = envs[0].state
    obs = lambda env: env.get_from_scenario(  # noqa: E731
        get_observations=True, get_rewards=False, get_infos=False,
        get_dones=False)[0]
    before = obs(envs[0])
    for state in (a_state, b_state):
        envs[0].step_fn(state, actions[2])
    assert not differing_leaves(obs(envs[0]), before)
    assert not differing_leaves(envs[0].step(actions[3]),
                                envs[1].step(actions[3]))
    assert not differing_leaves(envs[0].world.state, envs[1].world.state)


def test_reset_fn_matches_reset():
    env = cpu_env("transport", B)
    env.step(random_actions(env, 1)[0])
    state, copy = env.state, env.state.clone()
    g0 = env.world.generator.get_state()
    new, outs = env.reset_fn(state, generator=generator_at(g0, "cpu"))
    assert not differing_leaves(state, copy)
    assert isinstance(outs, tuple) and len(outs) == 3
    env.world.generator.set_state(g0)
    got = env.reset(return_observations=True, return_info=True,
                    return_dones=True)
    assert not differing_leaves(got, list(outs))
    assert not differing_leaves(env.world.state, new)
    assert int(new.steps.abs().sum()) == 0


def test_failed_call_restores_the_world():
    """A functional call that raises leaves the world holding what it held:
    its state object and generator."""
    env = cpu_env("transport", B)
    held, gen = env.world.state, env.world.generator
    copy = held.clone()
    other = torch.Generator().manual_seed(5)
    reward = env.scenario.reward

    def broken(agent):
        reward(agent)
        raise RuntimeError("planted")

    env.scenario.reward = broken
    with pytest.raises(RuntimeError, match="planted"):
        env.step_fn(env.state, random_actions(env, 1)[0], generator=other)
    assert env.world.state is held and env.world.generator is gen
    assert not differing_leaves(held, copy)


def test_world_state_replace_and_clone():
    env = cpu_env("drone", B)
    s = env.world.state
    r = s.replace(pos=s.pos + 1)
    assert r.vel is s.vel and r.extras is not s.extras
    assert r.extras.keys() == s.extras.keys()
    assert all(r.extras[k] is s.extras[k] for k in s.extras)
    assert torch.equal(r.pos, s.pos + 1) and s.pos is not r.pos
    c = s.clone()
    assert not differing_leaves(c, s)
    for (_, x), (_, y) in zip(tree_leaves(c), tree_leaves(s)):
        assert x.data_ptr() != y.data_ptr() or x.numel() == 0


def test_to_device():
    """``to`` of the env and its sensors returns them on their own device
    and raises, naming make_env's ``device=`` and utils/checkpoint.py, on
    any other (the JAX package's ``to`` moves nothing)."""
    env = cpu_env("navigation", B)
    lidar = env.agents[0].sensors[0]
    for x in (env, lidar):
        assert x.to("cpu") is x and x.to(torch.device("cpu")) is x
        with pytest.raises(ValueError, match=r"make_env.*checkpoint\.py"):
            x.to("meta")


def test_state_gradient_through_step_fn():
    """``torch.autograd.grad`` of a 3-step ``step_fn`` loss with respect to
    the initial ``pos`` and ``vel`` leaves: finite, nonzero, and with
    ``grad_enabled=False`` the same (the flag detaches the actions only, as
    the JAX package's ``grad_enabled`` stops their gradient only)."""
    grads = []
    for grad_enabled in (True, False):
        env = cpu_env("transport", B, grad_enabled=grad_enabled)
        s0 = env.state
        pos = s0.pos.clone().requires_grad_(True)
        vel = s0.vel.clone().requires_grad_(True)
        state, total = s0.replace(pos=pos, vel=vel), 0.0
        actions = random_actions(env, 3)
        for a in actions:
            state, (obs, rews, _, _) = env.step_fn(state, a)
            total = total + sum(o.mean() for o in obs) + sum(
                r.mean() for r in rews)
        grads.append(torch.autograd.grad(total, (pos, vel)))
    for g in grads[0]:
        assert bool(torch.isfinite(g).all()) and bool((g != 0).any())
    assert not differing_leaves(grads[0], grads[1])
    np.testing.assert_array_equal(s0.pos.numpy(), pos.detach().numpy())
