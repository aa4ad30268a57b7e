"""Gradients through the port's step (``make_env(..., grad_enabled=True)``),
the counterpart of ``tests/test_grad.py``: the loss of a 3-step rollout
(the mean of every observation plus the mean of every reward, each step)
with respect to the first action, applied at every step.

* every scenario the JAX package differentiates (all but football,
  simple_crypto and road_traffic), at 2 envs with ``tests/test_grad.py``'s
  kwargs: the gradient is finite and nonzero;
* transport, discovery (3 agents, 3 targets) and road_traffic (4 agents,
  map '1'; in ``tests/test_torch_grad_road.py``, its JAX compile alone
  takes about a minute on one core): the port's gradient from the JAX
  env's injected reset state against ``jax.grad`` of the same loss
  (``GRAD_RTOL`` below);
* with ``grad_enabled=False`` the actions are detached: the gradient is 0.

On the CPU the step runs the plain versions; on the card the same loss
goes through the kernels' ``autograd.Function``s (``chip_smoke.py`` phase
8 holds the card's gradient to the CPU's).
"""
import importlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(__file__))
from torch_helpers import cpu_env, jax_state_arrays  # noqa: E402

import vectorizedmultiagentsimulator_tpu as vmt  # noqa: E402
from vectorizedmultiagentsimulator_tpu_torch.utils import (  # noqa: E402
    state_from_numpy,
)

scenarios_module = importlib.import_module(
    "vectorizedmultiagentsimulator_tpu_torch.scenarios")

# tests/test_grad.py's exclusions and small-world kwargs.
EXCLUDED = {"football", "simple_crypto", "road_traffic"}
KWARGS = {
    "pollock": dict(n_agents=3, n_lines=2, n_boxes=2, lidar=True),
    "discovery": dict(n_agents=3, n_targets=3),
    "navigation": dict(n_agents=3),
    "flocking": dict(n_agents=3, n_obstacles=2),
}
JAX_CASES = {
    "transport": {},
    "discovery": dict(n_agents=3, n_targets=3),
    "road_traffic": dict(n_agents=4, map_type="1"),
}
N_ENVS, N_STEPS = 2, 3
# Port against jax.grad: the same fp32 operations in another order (XLA
# fuses and reassociates), through 3 steps of soft contacts whose
# derivatives amplify an ulp; held at 1e-4 of the gradient's largest entry
# (the forward steps agree within 1e-5, held_in_parity's first step).
GRAD_RTOL = 1e-4


def port_rollout_grad(env, n_steps=N_STEPS, first=None):
    """The gradient of the rollout loss with respect to the first action
    ``first`` (``[B, sum of action sizes]``, 0.1 by default)."""
    sizes = [env.get_agent_action_size(a) for a in env.agents]
    if first is None:
        first = torch.full((env.num_envs, sum(sizes)), 0.1)
    first = first.clone().requires_grad_(True)
    actions = list(torch.split(first, sizes, dim=1))
    total = 0.0
    for _ in range(n_steps):
        obs, rews, _, _ = env.step(actions)
        total = total + sum(o.mean() for o in obs) + sum(
            r.mean() for r in rews)
    if not total.requires_grad:  # nothing of the loss depends on actions
        return torch.zeros_like(first)
    (grad,) = torch.autograd.grad(total, first, allow_unused=True,
                                  materialize_grads=True)
    return grad


def jax_rollout_grad(jenv, n_steps=N_STEPS):
    """``tests/test_grad.py``'s ``jax.grad`` of the same loss from the JAX
    env's current state."""
    state0 = jenv.state
    sizes = [jenv.get_agent_action_size(a) for a in jenv.agents]

    def loss(first):
        actions, at = [], 0
        for size in sizes:
            actions.append(first[:, at:at + size])
            at += size
        state, total = state0, 0.0
        for _ in range(n_steps):
            state, (obs, rews, _, _) = jenv.step_fn(state, tuple(actions))
            total = total + sum(jnp.mean(o) for o in obs) + sum(
                jnp.mean(r) for r in rews)
        return total

    return np.asarray(jax.grad(loss)(
        jnp.full((jenv.num_envs, sum(sizes)), 0.1, jnp.float32)))


def _grad_scenarios():
    return [n for n in scenarios_module.names() if n not in EXCLUDED]


@pytest.mark.parametrize("scenario", _grad_scenarios())
def test_grad_through_rollout(scenario):
    env = cpu_env(scenario, N_ENVS, grad_enabled=True,
                  **KWARGS.get(scenario, {}))
    grad = port_rollout_grad(env).numpy()
    assert np.isfinite(grad).all(), f"{scenario}: NaN/inf gradient"
    assert np.abs(grad).sum() > 0, f"{scenario}: gradient identically zero"


def grad_matches_jax(scenario):
    kwargs = JAX_CASES[scenario]
    jenv = vmt.make_env(scenario, num_envs=N_ENVS, seed=0,
                        grad_enabled=True, **kwargs)
    env = cpu_env(scenario, N_ENVS, grad_enabled=True, **kwargs)
    arrays = jax_state_arrays(jenv.state)
    assert set(arrays["extras"]) == set(env.world.state.extras)
    state_from_numpy(env, arrays)
    ref = jax_rollout_grad(jenv)
    got = port_rollout_grad(env).numpy()
    assert np.isfinite(got).all() and np.abs(ref).sum() > 0
    err = np.abs(got - ref).max()
    assert err <= GRAD_RTOL * np.abs(ref).max(), (err, got, ref)


@pytest.mark.parametrize("scenario", ["discovery", "transport"])
def test_grad_matches_jax(scenario):
    grad_matches_jax(scenario)


def test_grad_disabled_stops_gradient():
    """``tests/test_grad.py::test_grad_disabled_stops_gradient``'s check on
    dispersion, through the rollout loss: the actions are detached, so no
    output depends on them; with ``grad_enabled=True`` the same loss has a
    nonzero gradient."""
    env = cpu_env("dispersion", N_ENVS, grad_enabled=False)
    action = torch.full((N_ENVS, 2), 0.1, requires_grad=True)
    obs, rews, _, _ = env.step([action] * len(env.agents))
    assert not any(x.requires_grad for x in obs + rews)
    env = cpu_env("dispersion", N_ENVS, grad_enabled=False)
    assert torch.count_nonzero(port_rollout_grad(env)) == 0
    env = cpu_env("dispersion", N_ENVS, grad_enabled=True)
    assert torch.count_nonzero(port_rollout_grad(env)) > 0
