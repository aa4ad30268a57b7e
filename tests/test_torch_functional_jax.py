"""The port's functional API against the JAX package's on the CPU, from
the JAX env's state injected into the port (``utils.state_from_numpy``):
transport (its agents against the package's four sides, as
``test_torch_transport.py`` poses them) and navigation (LIDARs), at 3 envs
over 3 steps.

* ``step_fn`` chained from that state against the JAX ``env.step_fn``
  with the same numpy actions, held by ``torch_helpers.held_in_parity``
  (``test_torch_transport.py``'s live parity: atol 1e-5 growing x1.6 a
  step, dones equal);
* the gradient of ``test_torch_grad.py``'s 3-step loss (the mean of every
  observation plus the mean of every reward, each step, the first action
  at every step) with respect to the initial ``pos``, against ``jax.grad``
  of the same loss, within ``GRAD_RTOL`` (1e-4) of its largest entry,
  with ``grad_enabled`` True and False: the JAX package's flag only stops
  the actions' gradient, so the state's flows either way.

The JAX env runs its jnp path (the Pallas kernels' plain reference on
the CPU), its ``step_fn`` and the gradient jit-compiled.  One JAX env a
file (about 20 s on one core each): navigation is in
``test_torch_functional_jax_lidar.py``."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_grad import GRAD_RTOL  # noqa: E402
from torch_helpers import (  # noqa: E402
    cpu_env,
    held_in_parity,
    jax_state_arrays,
)

import vectorizedmultiagentsimulator_tpu as vmt  # noqa: E402
from vectorizedmultiagentsimulator_tpu_torch.utils import (  # noqa: E402
    state_from_numpy,
)

B, N_STEPS = 3, 3


def jax_env(scenario):
    jenv = vmt.make_env(scenario, num_envs=B, seed=0, grad_enabled=True)
    if scenario == "transport":
        pos = np.array(jenv.state.pos)
        offsets = np.array([[0.1, 0.0], [-0.1, 0.0], [0.0, 0.1], [0.0, -0.1]])
        pos[:, 2:] = pos[:, 1:2] + offsets
        jenv.state = jenv.state.replace(pos=pos)
    return jenv


def port_state(scenario, jenv, grad_enabled):
    """The port env and its copy of ``jenv``'s state (``env.state``)."""
    env = cpu_env(scenario, B, seed=1, grad_enabled=grad_enabled)
    arrays = jax_state_arrays(jenv.state)
    assert set(arrays["extras"]) == set(env.world.state.extras)
    state_from_numpy(env, arrays)
    return env, env.state


def first_actions(sizes):
    return np.full((B, sum(sizes)), 0.1, np.float32)


def split(first, sizes):
    out, at = [], 0
    for size in sizes:
        out.append(first[:, at:at + size])
        at += size
    return out


def port_pos_grad(env, state0):
    """The gradient of the rollout loss through ``step_fn`` with respect to
    ``state0.pos``."""
    sizes = [env.get_agent_action_size(a) for a in env.agents]
    actions = split(torch.as_tensor(first_actions(sizes)), sizes)
    pos = state0.pos.clone().requires_grad_(True)
    state, total = state0.replace(pos=pos), 0.0
    for _ in range(N_STEPS):
        state, (obs, rews, _, _) = env.step_fn(state, actions)
        total = total + sum(o.mean() for o in obs) + sum(
            r.mean() for r in rews)
    (grad,) = torch.autograd.grad(total, pos)
    return grad.numpy()


def jax_pos_grad(jenv):
    """``jax.grad`` of the same loss with respect to the JAX state's
    ``pos`` (its packed physics mirror, if any, left to be repacked)."""
    state0 = jenv.state
    sizes = [jenv.get_agent_action_size(a) for a in jenv.agents]
    actions = tuple(split(jnp.asarray(first_actions(sizes)), sizes))

    def loss(pos):
        state = state0.replace(pos=pos, phys_pack=None)
        total = 0.0
        for _ in range(N_STEPS):
            state, (obs, rews, _, _) = jenv.step_fn(state, actions)
            total = total + sum(jnp.mean(o) for o in obs) + sum(
                jnp.mean(r) for r in rews)
        return total

    return np.asarray(jax.jit(jax.grad(loss))(jnp.asarray(state0.pos)))


def functional_matches_jax(scenario):
    jenv = jax_env(scenario)
    j_step = jax.jit(jenv.step_fn)
    env, state = port_state(scenario, jenv, grad_enabled=True)
    j_state = jenv.state
    rng = np.random.RandomState(0)
    sizes = [env.get_agent_action_size(a) for a in env.agents]
    for t in range(N_STEPS):
        acts = [rng.uniform(-1, 1, (B, s)).astype(np.float32) for s in sizes]
        state, outs = env.step_fn(state, [torch.as_tensor(a) for a in acts])
        j_state, j_outs = j_step(j_state, tuple(jnp.asarray(a) for a in acts))
        assert isinstance(outs, tuple) and len(outs) == len(j_outs) == 4
        held_in_parity(t, outs, j_outs)
    np.testing.assert_allclose(state.pos.numpy(), np.asarray(j_state.pos),
                               atol=1e-5 * 1.6**N_STEPS)
    np.testing.assert_array_equal(state.steps.numpy(),
                                  np.asarray(j_state.steps))

    ref = jax_pos_grad(jenv)
    assert np.isfinite(ref).all() and np.abs(ref).max() > 0
    for grad_enabled in (True, False):
        env, state0 = port_state(scenario, jenv, grad_enabled)
        got = port_pos_grad(env, state0)
        err = np.abs(got - ref).max()
        assert err <= GRAD_RTOL * np.abs(ref).max(), (grad_enabled, err,
                                                      got, ref)


@pytest.mark.parametrize("scenario", ["transport"])
def test_step_fn_and_state_gradient_match_jax(scenario):
    functional_matches_jax(scenario)
