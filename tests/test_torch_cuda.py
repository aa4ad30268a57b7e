"""The physics kernel on the card against its plain version.  These tests
need an NVIDIA GPU and nvcc; elsewhere they skip.  This file imports no
JAX, so on a machine with PyTorch only it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from physics_configs import CONFIGS
from torch_helpers import build_world, random_step_inputs

import vectorizedmultiagentsimulator_tpu_torch as vmt_torch
from vectorizedmultiagentsimulator_tpu_torch.ops import physics_cuda

pytestmark = pytest.mark.cuda

B = 2048
# Kernel vs plain, one step from identical inputs: fp32 force sums in
# another order (see chip_smoke.py).
ATOL = RTOL = 1e-4

# A kernel world with every per-entity feature the kernel covers: world
# and per-entity static gravity, per-env dyn_gravity, linear and angular
# friction, drag overrides, max_speed, v_range, a hollow movable box, and
# several substeps.
FEATURES = dict(
    world=dict(substeps=3, dt=0.1, gravity=(0.0, -0.05),
               linear_friction=0.02, angular_friction=0.01, drag=0.1),
    agents=[
        dict(name="a0", shape=("sphere", 0.08), max_speed=0.4),
        dict(name="a1", shape=("box", 0.2, 0.1, False), rotatable=True,
             drag=0.4, linear_friction=0.1, v_range=0.3),
        dict(name="a2", shape=("sphere", 0.05), gravity=(0.02, 0.01)),
        dict(name="a3", shape=("sphere", 0.06),
             gravity=np.tile(np.float32([[0.01, -0.02]]), (B, 1))),
    ],
    landmarks=[
        # Box-box pairs are not a kernel class: the two boxes ignore
        # each other.
        dict(name="hb", shape=("box", 0.5, 0.4, True), movable=True,
             rotatable=True, mass=2.0, angular_friction=0.05,
             collision_filter=lambda e: e.name != "a1"),
    ],
    spread=0.3,
)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    physics_cuda.build()


def _compare(world, inputs):
    assert world._use_kernel
    before = physics_cuda.LAUNCHES
    with torch.no_grad():
        got = physics_cuda.fused_step(world, *inputs)
        ref = physics_cuda.step_plain(world, *inputs)
    torch.cuda.synchronize()
    assert physics_cuda.LAUNCHES == before + 1
    for name, g, r in zip(("pos", "vel", "rot", "ang_vel"), got, ref):
        torch.testing.assert_close(g, r, rtol=RTOL, atol=ATOL, msg=name)


@pytest.mark.parametrize("cfg", ["spheres", "clamps", "hollow_box", "features"])
def test_kernel_matches_plain(cuda, cfg):
    spec = FEATURES if cfg == "features" else CONFIGS[cfg]
    world, _ = build_world(spec, B, device="cuda")
    if cfg == "features":
        assert world._dyn_gravity_names == ["a3"]
    _compare(world, random_step_inputs(world, spec["spread"], seed=11))


@pytest.mark.parametrize("scenario", ["transport", "simple_spread"])
def test_main_path_one_launch_per_step_no_sync(cuda, scenario):
    env = vmt_torch.make_env(scenario, num_envs=B, device="cuda", seed=0)
    _compare(env.world, random_step_inputs(env.world, 0.3, seed=12))
    actions = [env.get_random_actions() for _ in range(5)]
    torch.cuda.synchronize()
    before = physics_cuda.LAUNCHES
    torch.cuda.set_sync_debug_mode("error")
    try:
        for a in actions:
            obs, rews, dones, _ = env.step(a)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert physics_cuda.LAUNCHES == before + 5
    assert all(bool(torch.isfinite(o).all()) for o in obs)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    env = vmt_torch.make_env("transport", num_envs=8, device="cuda", seed=0)
    inputs = list(random_step_inputs(env.world, 0.3, seed=13))
    with pytest.raises(ValueError, match="mixed devices"):
        physics_cuda.fused_step(env.world, inputs[0].cpu(), *inputs[1:])
    with pytest.raises(TypeError, match="float32"):
        physics_cuda.fused_step(env.world, inputs[0].double(), *inputs[1:])
    with pytest.raises(ValueError, match="contiguous"):
        pos = inputs[0].transpose(0, 1).contiguous().transpose(0, 1)
        physics_cuda.fused_step(env.world, pos, *inputs[1:])
    lines, _ = build_world(CONFIGS["boxes_lines"], 8, device="cuda")
    with pytest.raises(RuntimeError, match="does not step through the kernel"):
        physics_cuda.fused_step(
            lines, *random_step_inputs(lines, 0.3, seed=14)
        )
