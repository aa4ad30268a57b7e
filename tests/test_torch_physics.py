"""The port's physics step: its plain path against the VMAS goldens, against
the JAX package's ``World._step_core`` and its Pallas kernel (interpret
mode), and the kernel wrapper's CPU behaviour and gradients."""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from physics_configs import BATCH, CONFIGS, N_STEPS
from torch_helpers import build_world, random_step_inputs

import vectorizedmultiagentsimulator_tpu as vmt
import vectorizedmultiagentsimulator_tpu_torch as vmt_torch
from vectorizedmultiagentsimulator_tpu_torch.ops import physics_cuda

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")

# The joint configs wait for core/joints.py (ROADMAP Queue 1 item 2).
NO_JOINTS = sorted(c for c in CONFIGS if not CONFIGS[c].get("joints"))


@pytest.mark.parametrize("cfg_name", NO_JOINTS)
def test_physics_golden(cfg_name):
    """Replays ``golden/physics_<cfg>.npz`` exactly as
    ``test_golden_physics.py`` does, at its tolerances."""
    data = np.load(os.path.join(GOLDEN, f"physics_{cfg_name}.npz"))
    cfg = CONFIGS[cfg_name]
    world, entities = build_world(cfg, BATCH)
    names = [str(n) for n in data["entity_names"]]
    assert [e.name for e in world.entities] == names
    for i, n in enumerate(names):
        e = entities[n]
        e.set_pos(torch.as_tensor(data["pos"][0, i]))
        e.set_rot(torch.as_tensor(data["rot"][0, i]))
        e.state.vel = torch.as_tensor(data["vel"][0, i])
        e.state.ang_vel = torch.as_tensor(data["ang_vel"][0, i])

    agent_names = [s["name"] for s in cfg.get("agents", [])]
    max_frac = 0.125
    diverged = np.zeros((BATCH,), dtype=bool)
    for t in range(N_STEPS):
        for k, n in enumerate(agent_names):
            entities[n].state.force = torch.as_tensor(data["forces"][t, k])
            entities[n].state.torque = torch.as_tensor(data["torques"][t, k])
        world.step()
        atol = min(3e-4 * (1.6**t), 0.05)
        for i, e in enumerate(world.entities):
            for field in ("pos", "vel", "rot", "ang_vel"):
                mine = getattr(e.state, field).numpy()
                target = data[field][t + 1, i]
                bad = (np.abs(mine - target) > atol + 1e-3 * np.abs(target))
                diverged |= bad.any(axis=-1)
                assert diverged.mean() <= max_frac + 1e-9, (
                    f"{cfg_name}: {e.name}.{field} diverged at step {t}:"
                    f" {diverged.sum()}/{BATCH} envs"
                )


def test_step_supported_is_static():
    """Kernel worlds: only ss/bs pairs; any line or box-box pair keeps the
    plain path."""
    env = vmt_torch.make_env("transport", num_envs=2)
    assert env.world._use_kernel and physics_cuda.step_supported(env.world)
    expected = {"spheres": True, "clamps": True, "hollow_box": True,
                "boxes_lines": False, "gravity_friction": False}
    for cfg, supported in expected.items():
        world, _ = build_world(CONFIGS[cfg], 2)
        assert physics_cuda.step_supported(world) is supported, cfg
        assert world._use_kernel is supported, cfg


def _transport_pair(B=8):
    """The JAX and the port transport worlds at B envs, and one set of
    step inputs with many overlapping pairs, as numpy arrays."""
    jenv = vmt.make_env("transport", num_envs=B, seed=0)
    env = vmt_torch.make_env("transport", num_envs=B, seed=0)
    inputs = [x.numpy() for x in random_step_inputs(env.world, 0.3, seed=7)]
    return jenv, env, inputs


def test_step_plain_matches_jax_step_core():
    jenv, env, inputs = _transport_pair()
    jw = jenv.world
    ref = jw._step_core(*(jnp.asarray(x) for x in inputs[:6]), {})
    got = physics_cuda.step_plain(env.world, *(torch.as_tensor(x) for x in inputs))
    for r, o, name in zip(ref, got, ("pos", "vel", "rot", "ang_vel")):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-5,
                                   err_msg=name)


def test_step_plain_matches_jax_pallas_kernel(monkeypatch):
    """The JAX Pallas kernel in interpret mode, as tests/test_pallas.py
    runs it on the CPU."""
    monkeypatch.setenv("VMT_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("VMT_PALLAS_STEP", "1")
    from vectorizedmultiagentsimulator_tpu.ops import physics_pallas

    jenv, env, inputs = _transport_pair()
    assert physics_pallas.step_supported(jenv.world)
    ref = physics_pallas.fused_step(
        jenv.world, *(jnp.asarray(x) for x in inputs)
    )
    got = physics_cuda.step_plain(env.world, *(torch.as_tensor(x) for x in inputs))
    for r, o, name in zip(ref, got, ("pos", "vel", "rot", "ang_vel")):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-5,
                                   err_msg=name)


def test_fused_step_on_cpu_runs_plain_and_counts_no_launch():
    env = vmt_torch.make_env("transport", num_envs=8, seed=0)
    inputs = random_step_inputs(env.world, 0.3, seed=8)
    before = physics_cuda.LAUNCHES
    got = physics_cuda.fused_step(env.world, *inputs)
    ref = physics_cuda.step_plain(env.world, *inputs)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    env.step(env.get_random_actions())
    assert physics_cuda.LAUNCHES == before


def test_fused_step_gradients_match_plain():
    """The autograd.Function's backward (plain path re-run) gives the plain
    path's own gradients."""
    env = vmt_torch.make_env("transport", num_envs=8, seed=0)
    base = random_step_inputs(env.world, 0.3, seed=9)
    weights = [torch.randn(x.shape, generator=torch.Generator().manual_seed(i))
               for i, x in enumerate(base[:4])]

    def grads(step):
        inputs = [x.clone().requires_grad_(True) for x in base]
        out = step(env.world, *inputs)
        loss = sum((o * w).sum() for o, w in zip(out, weights))
        return torch.autograd.grad(loss, inputs[:6])

    got = grads(physics_cuda.fused_step)
    ref = grads(physics_cuda.step_plain)
    for name, g, r in zip(("pos", "vel", "rot", "ang_vel", "force", "torque"),
                          got, ref):
        assert torch.isfinite(g).all(), name
        torch.testing.assert_close(g, r, rtol=1e-6, atol=1e-6, msg=name)
    assert got[4].abs().sum() > 0  # the action force reaches the outputs
