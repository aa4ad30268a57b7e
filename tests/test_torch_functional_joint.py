"""A joint scenario's rollout gradient against ``jax.grad`` on the CPU:
buzz_wire (two agents, each joined to a ball by a dist-0.25 joint: four
constraints, 15 substeps, joint_force 900) at 2 envs over 3 steps,
through ``step_fn`` on both sides, with ``test_torch_grad.py``'s loss (the
mean of every observation plus the mean of every reward, each step) with
respect to the first action, applied at every step.

The state is the JAX env's reset state with every position moved by up
to ``JITTER`` (``torch_helpers.JITTER``, as the physics tests stretch the
joint worlds), injected into the port.  At the reset state itself every
constraint sits exactly at rest: its force divides by an anchor distance
of 0, and an ulp of the state moved the port's own gradient by 7 to 130
times its largest entry (8 nudges, measured when this test was written),
so no tolerance could hold it there.  Stretched, the gradient is smooth.

Tolerance: ``NUDGE_FACTOR`` times the port's own spread, the largest
change of its gradient over ``NUDGES`` copies of the state with every
position moved by an ulp up or down (relative to the gradient's largest
entry: 7.0e-7 to 2.4e-6 measured, the port against ``jax.grad``
7.9e-7).  A wrong derivative of the joint branch moves it by O(1).

joint_passage is left out: its 3-step gradient is chaotic even from a
stretched state (an ulp moves it by more than 1e-3 of its largest entry
in a fifth of the envs; ``PERF.md`` §6)."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(__file__))
from torch_helpers import (  # noqa: E402
    JITTER,
    cpu_env,
    jax_state_arrays,
)

import vectorizedmultiagentsimulator_tpu as vmt  # noqa: E402
from vectorizedmultiagentsimulator_tpu_torch.utils import (  # noqa: E402
    state_from_numpy,
)

SCENARIO, B, N_STEPS = "buzz_wire", 2, 3
NUDGES, NUDGE_FACTOR = 8, 4.0


def split(first, sizes):
    out, at = [], 0
    for size in sizes:
        out.append(first[:, at:at + size])
        at += size
    return out


def port_grad(env, state0):
    sizes = [env.get_agent_action_size(a) for a in env.agents]
    first = torch.full((B, sum(sizes)), 0.1, requires_grad=True)
    actions = split(first, sizes)
    state, total = state0, 0.0
    for _ in range(N_STEPS):
        state, (obs, rews, _, _) = env.step_fn(state, actions)
        total = total + sum(o.mean() for o in obs) + sum(
            r.mean() for r in rews)
    (grad,) = torch.autograd.grad(total, first)
    return grad.numpy()


def jax_grad(jenv, state0):
    sizes = [jenv.get_agent_action_size(a) for a in jenv.agents]

    def loss(first):
        actions = tuple(split(first, sizes))
        state, total = state0, 0.0
        for _ in range(N_STEPS):
            state, (obs, rews, _, _) = jenv.step_fn(state, actions)
            total = total + sum(jnp.mean(o) for o in obs) + sum(
                jnp.mean(r) for r in rews)
        return total

    return np.asarray(jax.grad(loss)(
        jnp.full((B, sum(sizes)), 0.1, jnp.float32)))


def test_joint_rollout_gradient_matches_jax():
    jenv = vmt.make_env(SCENARIO, num_envs=B, seed=0, grad_enabled=True)
    pos = np.array(jenv.state.pos)
    rng = np.random.RandomState(0)
    pos = (pos + rng.uniform(-JITTER, JITTER, pos.shape)).astype(np.float32)
    j_state = jenv.state.replace(pos=jnp.asarray(pos), phys_pack=None)
    ref = jax_grad(jenv, j_state)
    scale = np.abs(ref).max()
    assert np.isfinite(ref).all() and scale > 0

    env = cpu_env(SCENARIO, B, seed=1, grad_enabled=True)
    assert env.world._joints
    state_from_numpy(env, jax_state_arrays(j_state))
    state0 = env.state
    got = port_grad(env, state0)
    spread = 0.0
    for k in range(NUDGES):
        x = state0.pos
        up = torch.rand(x.shape, generator=torch.Generator().manual_seed(k))
        nudged = torch.where(up < 0.5, torch.nextafter(x, x + 1),
                             torch.nextafter(x, x - 1))
        spread = max(spread, np.abs(
            port_grad(env, state0.replace(pos=nudged)) - got).max())
    assert 0 < spread < 1e-4 * scale, (spread, scale)
    err = np.abs(got - ref).max()
    assert err <= NUDGE_FACTOR * spread, (err, spread, scale, got, ref)
