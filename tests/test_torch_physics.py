"""The port's physics step: its plain path against the VMAS goldens, against
the JAX package's ``World._step_core`` and its Pallas kernel (interpret
mode), and the kernel wrapper's CPU behaviour and gradients."""
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from physics_configs import BATCH, CONFIGS, N_STEPS
from torch_helpers import MANY_ENTITIES, build_world, random_step_inputs

import vectorizedmultiagentsimulator_tpu as vmt
import vectorizedmultiagentsimulator_tpu_torch as vmt_torch
from vectorizedmultiagentsimulator_tpu_torch.ops import (
    football_policy_cuda,
    physics_cuda,
    raycast_cuda,
)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")

@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
def test_physics_golden(cfg_name):
    """Replays ``golden/physics_<cfg>.npz`` exactly as
    ``test_golden_physics.py`` does, at its tolerances."""
    data = np.load(os.path.join(GOLDEN, f"physics_{cfg_name}.npz"))
    cfg = CONFIGS[cfg_name]
    world, entities = build_world(cfg, BATCH, device="cpu")
    names = [str(n) for n in data["entity_names"]]
    assert [e.name for e in world.entities] == names
    # The recorded t=0 state, written in the config's order as the golden's
    # generator wrote it, so that the joint observers pose the joint
    # landmarks (and infer fixed rotations) as they did there.
    order = [s["name"] for s in cfg.get("agents", [])] + [
        s["name"] for s in cfg.get("landmarks", [])
    ]
    for n in order:
        e, i = entities[n], names.index(n)
        e.set_pos(torch.as_tensor(data["pos"][0, i]))
        e.set_rot(torch.as_tensor(data["rot"][0, i]))
        e.state.vel = torch.as_tensor(data["vel"][0, i])
        e.state.ang_vel = torch.as_tensor(data["ang_vel"][0, i])
    for i, e in enumerate(world.entities):
        for field in ("pos", "rot"):
            np.testing.assert_allclose(
                getattr(e.state, field).numpy(), data[field][0, i],
                atol=1e-6, err_msg=f"{e.name} initial {field}")

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
    """Kernel worlds: every pair class and joints with a static fixed
    rotation, under the JAX kernel's size guard (at most 64 entities,
    weighted pair count + 2 a joint constraint, x substeps <= 2048); a
    fixed rotation inferred per env takes the plain path."""
    env = vmt_torch.make_env("transport", num_envs=2, device="cpu")
    assert env.world._use_kernel and physics_cuda.step_supported(env.world)
    for cfg in CONFIGS:
        world, _ = build_world(CONFIGS[cfg], 2, device="cpu")
        on_kernel = cfg != "joints_fixed_rotation"
        assert physics_cuda.step_supported(world) is on_kernel, cfg
        assert world._use_kernel is on_kernel, cfg
    # Four boxes: 6 box-box pairs of weight 16, so 21 substeps pass the
    # guard (2016) and 22 do not (2112).
    boxes = [dict(name=f"b{i}", shape=("box", 0.2, 0.1, False))
             for i in range(4)]
    for substeps, supported in ((21, True), (22, False)):
        world, _ = build_world(
            dict(world=dict(substeps=substeps), agents=boxes), 2, device="cpu"
        )
        assert world._use_kernel is supported, substeps
    # 16 dist-0 joints between non-colliding spheres cost 32: 64 substeps
    # pass the guard (2048) and 65 do not (2080).
    spheres = [dict(name=f"s{i}", shape=("sphere", 0.05), collide=False)
               for i in range(32)]
    pins = [dict(a=f"s{2 * i}", b=f"s{2 * i + 1}") for i in range(16)]
    for substeps, supported in ((64, True), (65, False)):
        world, _ = build_world(
            dict(world=dict(substeps=substeps), agents=spheres, joints=pins),
            2, device="cpu",
        )
        assert world._use_kernel is supported, substeps
    world, _ = build_world(MANY_ENTITIES, 2, device="cpu")
    assert not world._use_kernel


@functools.lru_cache(maxsize=None)
def _transport_pair(B=8):
    """The JAX and the port transport worlds at B envs, and one set of
    step inputs with many overlapping pairs, as numpy arrays; built once
    (the JAX env's first reset compiles for seconds)."""
    jenv = vmt.make_env("transport", num_envs=B, seed=0)
    env = vmt_torch.make_env("transport", num_envs=B, device="cpu", seed=0)
    inputs = [x.numpy() for x in random_step_inputs(env.world, 0.3, seed=7)]
    return jenv, env, inputs


def test_step_plain_matches_jax_step_core():
    jenv, env, inputs = _transport_pair()
    jw = jenv.world
    # Jitted, as the JAX env runs it (and seconds faster to compile on the
    # CPU than op by op).
    ref = jax.jit(lambda *a: jw._step_core(*a, {}))(
        *(jnp.asarray(x) for x in inputs[:6])
    )
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
    env = vmt_torch.make_env("transport", num_envs=8, device="cpu", seed=0)
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
    env = vmt_torch.make_env("transport", num_envs=8, device="cpu", seed=0)
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


@pytest.mark.parametrize("module,structs", [
    (physics_cuda, ("Tables", "Dims")),
    (raycast_cuda, ("CastTable",)),
    (football_policy_cuda, ("Params",)),
])
def test_kernel_structs_match_ctypes_mirrors(module, structs, tmp_path):
    """The structs a wrapper fills for its kernel have the C layout: every
    field's offset and the size, from the .cu source compiled as host C++
    (the struct definitions come before the source's anonymous namespace)."""
    import ctypes
    import shutil
    import subprocess

    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    with open(module.SOURCE) as f:
        src = f.read()
    first = min(src.index(f"struct {s} {{") for s in structs)
    if "enum PairClass" in src:
        first = min(first, src.index("enum PairClass"))
    lines = ["#include <cstdio>", "#include <cstddef>",
             src[first:src.index("namespace {")], "int main() {"]
    expected = []
    for s in structs:
        mirror = getattr(module, f"_{s}")
        lines.append(f'printf("%zu\\n", sizeof({s}));')
        expected.append(ctypes.sizeof(mirror))
        for field, *_ in mirror._fields_:
            lines.append(f'printf("%zu\\n", offsetof({s}, {field}));')
            expected.append(getattr(mirror, field).offset)
    lines.append("return 0; }")
    (tmp_path / "layout.cpp").write_text("\n".join(lines))
    subprocess.run([cxx, "-o", str(tmp_path / "layout"),
                    str(tmp_path / "layout.cpp")], check=True)
    out = subprocess.run([str(tmp_path / "layout")], capture_output=True,
                         text=True, check=True).stdout.split()
    assert [int(x) for x in out] == expected
