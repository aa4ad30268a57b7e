"""The port's LIDAR: ``World.cast_rays`` against the reference golden, the
plain ray cast (``raycast_cuda.cast_rays_plain``) against the JAX
package's jnp reference and its Pallas kernel (interpret mode), the
``Lidar`` angles, and the kernel wrapper's CPU behaviour and gradients."""
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# The CPU tests run at small sizes, several test processes at once:
# PyTorch's intra-op threads would only contend with each other.
torch.set_num_threads(1)

import vectorizedmultiagentsimulator_tpu_torch as vmt_torch
from vectorizedmultiagentsimulator_tpu_torch.core import (
    Agent,
    Box,
    Landmark,
    Line,
    Sphere,
    World,
)
from vectorizedmultiagentsimulator_tpu_torch.ops import raycast_cuda
from vectorizedmultiagentsimulator_tpu_torch.sensors import Lidar

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
# test_golden_geometry.py's tolerance for the ray-cast golden.
ATOL = 1e-5
MAX_RANGE = 1.5

# The golden's scene: 2 boxes, 2 spheres, 2 lines (entities 0-5), and the
# origin agent (entity 6: a world lists its landmarks first).
ORIGIN = 6
SHAPES = [
    ("b0", Box(length=0.4, width=0.2)),
    ("b1", Box(length=0.3, width=0.3)),
    ("s0", Sphere(radius=0.15)),
    ("s1", Sphere(radius=0.25)),
    ("li0", Line(length=0.6)),
    ("li1", Line(length=0.9)),
]


def scene_world(batch):
    world = World(batch, device="cpu")
    agent = Agent(name="a", shape=Sphere(radius=0.03))
    world.add_agent(agent)
    for name, shape in SHAPES:
        world.add_landmark(Landmark(name, shape=shape))
    world.finalize()
    return world, agent


def test_cast_rays_golden():
    """``golden/raycast.npz`` (recorded from the reference simulator),
    through the port's ``World.cast_rays`` with world-frame angles."""
    data = np.load(os.path.join(GOLDEN, "raycast.npz"))
    world, agent = scene_world(data["angles"].shape[0])
    for e in world.entities:
        e.state.pos = torch.as_tensor(data[f"{e.name}_0"])
        e.state.rot = torch.as_tensor(data[f"{e.name}_1"])
    dists = world.cast_rays(
        agent, torch.as_tensor(data["angles"]), max_range=MAX_RANGE,
        entity_filter=lambda e: True,
    )
    np.testing.assert_allclose(dists.numpy(), data["dists"], atol=ATOL)


def random_scene(seed, B=8, R=12, axis_aligned=False):
    """State arrays for ``scene_world``.  With ``axis_aligned`` the boxes
    are unrotated, the rays point along the axes, and some origins lie
    exactly on a box side's line, so the ray at angle 0 grazes that side."""
    rng = np.random.RandomState(seed)
    N = len(SHAPES) + 1
    pos = rng.uniform(-0.8, 0.8, (B, N, 2)).astype(np.float32)
    rot = rng.uniform(-math.pi, math.pi, (B, N, 1)).astype(np.float32)
    angles = rng.uniform(-math.pi, math.pi, (B, R)).astype(np.float32)
    if axis_aligned:
        rot[:, :2] = 0.0
        angles[:] = np.float32([0.0, math.pi / 2, math.pi, -math.pi / 2])[
            np.arange(R) % 4
        ]
        # b0 (length 0.4, width 0.2) at (0.1, 0): its sides lie on
        # y = +-0.1 (exactly half of float32 0.2); origins 0.4 left of it
        # on those lines.
        pos[:, 0] = np.float32([0.1, 0.0])
        pos[::2, ORIGIN] = np.float32([-0.5, 0.1])
        pos[1::2, ORIGIN] = np.float32([-0.5, -0.1])
    return pos, rot, angles


def jax_inputs(world, pos, rot, angles):
    """The JAX kernel's flattened inputs for the same scene."""
    idx = {n: [e.index for e in world.landmarks if isinstance(e.shape, t)]
           for n, t in (("s", Sphere), ("b", Box), ("l", Line))}
    B = pos.shape[0]
    args = (
        pos[:, ORIGIN], angles,
        pos[:, idx["s"]].reshape(B, -1), pos[:, idx["b"]].reshape(B, -1),
        rot[:, idx["b"], 0], pos[:, idx["l"]].reshape(B, -1),
        rot[:, idx["l"], 0],
    )
    statics = dict(
        sphere_radius=tuple(float(world._radius[i]) for i in idx["s"]),
        box_length=tuple(float(world._length[i]) for i in idx["b"]),
        box_width=tuple(float(world._width[i]) for i in idx["b"]),
        line_length=tuple(float(world._length[i]) for i in idx["l"]),
        max_range=MAX_RANGE,
    )
    return [jnp.asarray(a) for a in args], statics


def plain(world, pos, rot, angles):
    """``cast_rays_plain`` from the origin over every landmark."""
    table = raycast_cuda.cast_table(
        world,
        *([e.index for e in world.landmarks if isinstance(e.shape, t)]
          for t in (Sphere, Box, Line)),
    )
    return raycast_cuda.cast_rays_plain(
        torch.as_tensor(pos), torch.as_tensor(rot), torch.as_tensor(angles),
        ORIGIN, table, MAX_RANGE,
    ).numpy()


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_matches_jax_reference_and_pallas(seed, monkeypatch):
    """Random scenes with every shape class: the jnp reference, and the
    Pallas kernel run in interpret mode as tests/test_pallas.py runs it."""
    monkeypatch.setenv("VMT_PALLAS_INTERPRET", "1")
    from vectorizedmultiagentsimulator_tpu.ops import raycast_pallas as rcp

    world, _ = scene_world(8)
    pos, rot, angles = random_scene(seed)
    got = plain(world, pos, rot, angles)
    assert (got < MAX_RANGE).sum() > 10  # the scene has hits to compare
    args, statics = jax_inputs(world, pos, rot, angles)
    for ref in (rcp._jnp_reference(*args, **statics),
                rcp._pallas_forward(*args, **statics)):
        np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL)


def test_plain_matches_jax_reference_axis_aligned():
    """Axis-aligned rays against unrotated boxes, some grazing a side.  The
    Pallas kernel's unguarded slab is undefined there (0/0), so only the
    jnp reference, whose slab is guarded as the port's is."""
    from vectorizedmultiagentsimulator_tpu.ops import raycast_pallas as rcp

    world, _ = scene_world(8)
    pos, rot, angles = random_scene(2, axis_aligned=True)
    got = plain(world, pos, rot, angles)
    assert np.isfinite(got).all()
    assert (got[:, 0] <= 0.4 + ATOL).all()  # every grazing ray hits b0
    args, statics = jax_inputs(world, pos, rot, angles)
    ref = rcp._jnp_reference(*args, **statics)
    np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("start,end,n_rays", [
    (0.0, 2 * np.pi, 12), (0.0, 2 * np.pi, 8), (-np.pi / 4, np.pi / 4, 5),
    (0.0, np.pi, 7),
])
def test_lidar_angles_match_jax(start, end, n_rays):
    """Full circles drop the duplicated endpoint, partial arcs keep it."""
    from vectorizedmultiagentsimulator_tpu.sensors import Lidar as JaxLidar

    ref = JaxLidar(None, angle_start=start, angle_end=end, n_rays=n_rays)
    got = Lidar(World(1, device="cpu"), angle_start=start, angle_end=end,
                n_rays=n_rays)
    np.testing.assert_array_equal(got._angles.numpy(), np.asarray(ref._angles))


def test_fused_cast_on_cpu_runs_plain_and_its_gradients():
    """On CPU tensors the wrapper is the plain version (no launch counted),
    and its backward gives plain autograd's gradients."""
    world, _ = scene_world(8)
    pos, rot, angles = random_scene(3)
    table = raycast_cuda.cast_table(world, [2, 3], [0, 1], [4, 5])
    weights = torch.randn((8, 12), generator=torch.Generator().manual_seed(0))

    def grads(cast):
        inputs = [torch.tensor(x, requires_grad=True) for x in (pos, rot, angles)]
        out = cast(*inputs, ORIGIN, table, MAX_RANGE)
        return (out,) + torch.autograd.grad((out * weights).sum(), inputs)

    before = raycast_cuda.LAUNCHES
    got = grads(raycast_cuda.fused_cast_rays)
    ref = grads(raycast_cuda.cast_rays_plain)
    assert raycast_cuda.LAUNCHES == before
    for name, g, r in zip(("out", "pos", "rot", "angles"), got, ref):
        assert torch.isfinite(g).all(), name
        torch.testing.assert_close(g, r, rtol=1e-6, atol=1e-6, msg=name)
    assert got[1].abs().sum() > 0 and got[3].abs().sum() > 0


def test_lidar_detects_entity(num_envs=2):
    """A sphere straight ahead must shorten the corresponding rays (port of
    tests/test_lidar.py::test_lidar_detects_entity)."""
    world = World(num_envs, device="cpu")
    agent = Agent(name="a", shape=Sphere(0.05))
    world.add_agent(agent)
    target = Landmark(name="t", shape=Sphere(0.1), collide=True)
    world.add_landmark(target)
    lidar = Lidar(world, n_rays=8, max_range=2.0)
    lidar.agent = agent
    world.finalize()
    agent.set_pos(torch.zeros((num_envs, 2)))
    target.set_pos(torch.tensor([1.0, 0.0]).expand(num_envs, 2))
    meas = lidar.measure().numpy()
    assert np.allclose(meas[:, 0], 0.9, atol=1e-3)  # ray at angle 0 hits
    assert np.allclose(meas[:, 4], 2.0)  # ray pointing away misses


def test_measure_follows_heading_and_filter():
    """A LIDAR's rays turn with its agent, and its filter picks what it
    sees: navigation's agents see agents only, flocking's obstacles only."""
    env = vmt_torch.make_env("navigation", num_envs=4, device="cpu", seed=0)
    a0, a1 = env.world.agents[:2]
    a0.set_pos(torch.zeros((4, 2)))
    a1.set_pos(torch.tensor([[0.3, 0.0]]).expand(4, 2))
    for i, a in enumerate(env.world.agents[2:]):
        a.set_pos(torch.tensor([[-5.0, 5.0 + i]]).expand(4, 2))
    a0.set_rot(torch.tensor([[0.0], [math.pi / 2], [math.pi], [-math.pi / 2]]))
    meas = a0.sensors[0].measure().numpy()
    # 12 rays 30 degrees apart; agent 1 (radius 0.1) is 0.3 away along +x.
    hit = [0, 9, 6, 3]  # the ray along +x for each heading
    for b in range(4):
        assert np.isclose(meas[b, hit[b]], 0.2, atol=1e-5), meas[b]
        assert (np.delete(meas[b], hit[b]) == 0.35).all(), meas[b]
