"""The port's LIDAR: ``World.cast_rays`` against the reference golden, the
plain ray cast (``raycast_cuda.cast_rays_plain``) against the JAX
package's jnp reference and its Pallas kernel (interpret mode), the
``Lidar`` angles, and the kernel wrapper's CPU behaviour and gradients;
the kernel's source compiled as host C++ against the plain version; the
grouped ``Lidar.measure`` (every LIDAR of a group cast at once) against
the JAX package's ``Lidar.measure``, its cache and its gradients."""
import ctypes
import importlib
import math
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# The CPU tests run at small sizes, several test processes at once:
# PyTorch's intra-op threads would only contend with each other.
torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(__file__))
from torch_helpers import poses_at_cast_reach

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
from vectorizedmultiagentsimulator_tpu_torch.utils import state_from_numpy

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


# --------------------------------------------------------------------- #
# The kernel's source on the host
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def host_cast(tmp_path_factory):
    """``csrc/raycast.cu`` compiled as host C++ (its three phases run block
    by block, each phase's threads as a loop), called as the wrapper calls
    the kernel: ``(pos, rot, angles, origins, table, max_range)``."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    lib_path = str(tmp_path_factory.mktemp("raycast") / "libraycast.so")
    subprocess.run(
        [cxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
         "-x", "c++", "-o", lib_path, raycast_cuda.SOURCE],
        check=True, timeout=60,
    )
    fn = ctypes.CDLL(lib_path).vmt_cast_rays
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes, fn.restype = [P] * 5 + [I] * 4 + [F, P], I

    def cast(pos, rot, angles, origins, table, max_range):
        many = not isinstance(origins, int)
        origins = tuple(origins) if many else (origins,)
        B, N, R = pos.shape[0], pos.shape[1], angles.shape[-1]
        out = torch.empty((len(origins), B, R))
        struct = raycast_cuda.kernel_table(table, origins)
        err = fn(pos.data_ptr(), rot.data_ptr(), angles.data_ptr(),
                 out.data_ptr(), ctypes.addressof(struct), B, N, R,
                 R if angles.ndim == 2 else 0, max_range, None)
        assert err == 0
        return out if many else out[0]

    return cast


def _held(got, ref, cap=MAX_RANGE):
    """Within 1e-5 + 1e-5|ref| (the host's libm against PyTorch's cos and
    sin), and no ray that hits on one side and misses on the other."""
    assert int(((got == cap) != (ref == cap)).sum()) == 0
    assert (ref < cap).sum() > 10  # the scene has hits to compare
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


def _scene_tensors(scene, seed):
    """(pos, rot, world-frame angles) of the golden scene; of a random scene
    of every shape class (``random_scene``, 64 envs), axis-aligned, or
    spread over [-2.4, 2.4]^2 (some entities beyond every ray's reach); or
    of poses on the edge of the kernel's reach test
    (``poses_at_cast_reach``, 512 envs)."""
    if scene == "golden":
        data = np.load(os.path.join(GOLDEN, "raycast.npz"))
        world, _ = scene_world(1)
        pos = np.stack([data[f"{e.name}_0"] for e in world.entities], 1)
        rot = np.stack([data[f"{e.name}_1"] for e in world.entities], 1)
        angles = data["angles"]
    elif scene == "reach":
        world, _ = scene_world(1)
        _, _, angles = random_scene(seed, B=512)
        pos, rot = poses_at_cast_reach(world, ORIGIN, angles[0], MAX_RANGE,
                                       seed, 512)
    else:
        pos, rot, angles = random_scene(seed, B=64,
                                        axis_aligned=scene == "axis")
        if scene == "wide":
            pos = pos * 3.0
    return (torch.as_tensor(np.ascontiguousarray(x, dtype=np.float32))
            for x in (pos, rot, angles))


# The LIDAR scenarios whose groups the host build casts too: discovery's
# five target LIDARs (and, with use_agent_lidar, its agent LIDARs) and
# sampling's agent LIDARs, the agents drawn together by ``squeeze`` so
# that their rays meet.
SCENARIO_SCENES = {
    "discovery": (dict(use_agent_lidar=True), 1.0),
    "sampling": ({}, 0.1),
}


def _check_scenario_groups(host_cast, scene, seed, B=64):
    """Every LIDAR group of the scenario after 3 random steps, in one
    launch of the host build from all its agents, against the plain
    version from each agent over its own table."""
    kwargs, squeeze = SCENARIO_SCENES[scene]
    env = vmt_torch.make_env(scene, num_envs=B, device="cpu", seed=seed,
                             **kwargs)
    for _ in range(3):
        env.step(env.get_random_actions())
    w = env.world
    pos, rot = w.state.pos.clone(), w.state.rot
    for a in w.agents:
        pos[:, a.index] *= squeeze
    groups = list({id(g): g for g, _ in w._lidar_groups.values()}.values())
    assert len(groups) == len(kwargs) + 1
    for grp in groups:
        args = (pos, rot, grp.angles, grp.origins, grp.table, grp.max_range)
        got = host_cast(*args)
        ref = raycast_cuda.cast_rays_plain(*args)
        assert got.shape == (len(w.agents), B, grp.angles.shape[0])
        _held(got, ref, cap=grp.max_range)
        torch.testing.assert_close(
            ref[1], raycast_cuda.cast_rays_plain(*args[:3], grp.origins[1],
                                                 *args[4:]),
            rtol=0, atol=0)


@pytest.mark.parametrize("scene,seed", [("golden", 0), ("random", 4),
                                        ("random", 5), ("axis", 6),
                                        ("wide", 7), ("reach", 8),
                                        ("discovery", 9), ("sampling", 10)])
def test_host_kernel_matches_plain(host_cast, scene, seed):
    """The kernel's source on the host against ``cast_rays_plain``: one
    origin with world-frame and with base angles, and every entity as an
    origin of one launch over all seven (each skipping itself), against
    the plain version origin by origin; on spread scenes and on the edge
    of the reach test, whose culled entities must change nothing; and the
    LIDAR groups of discovery and sampling."""
    if scene in SCENARIO_SCENES:
        _check_scenario_groups(host_cast, scene, seed)
        return
    pos, rot, angles = _scene_tensors(scene, seed)
    world, _ = scene_world(pos.shape[0])
    table = raycast_cuda.cast_table(world, [2, 3], [0, 1], [4, 5])
    base = angles[0].contiguous()
    for ang in (angles, base):
        _held(host_cast(pos, rot, ang, ORIGIN, table, MAX_RANGE),
              raycast_cuda.cast_rays_plain(pos, rot, ang, ORIGIN, table,
                                           MAX_RANGE))
    everyone = raycast_cuda.cast_table(world, [2, 3, ORIGIN], [0, 1], [4, 5])
    origins = (ORIGIN, 2, 0, 4, 3, 1, 5)
    got = host_cast(pos, rot, base, origins, everyone, MAX_RANGE)
    ref = raycast_cuda.cast_rays_plain(pos, rot, base, origins, everyone,
                                       MAX_RANGE)
    assert got.shape == (7, pos.shape[0], base.shape[0])
    _held(got, ref)
    for i, o in enumerate(origins):
        alone = raycast_cuda.cast_table(
            world, *([e for e in x if e != o]
                     for x in ([2, 3, ORIGIN], [0, 1], [4, 5])))
        torch.testing.assert_close(
            ref[i], raycast_cuda.cast_rays_plain(pos, rot, base, o, alone,
                                                 MAX_RANGE), rtol=0, atol=0)


def test_kernel_table_refuses_what_the_kernel_does_not_take():
    world, _ = scene_world(1)
    table = raycast_cuda.cast_table(world, [2] * 129, [], [])
    with pytest.raises(ValueError, match="at most 128 cast entities"):
        raycast_cuda.kernel_table(table, (ORIGIN,))


# --------------------------------------------------------------------- #
# Grouped measures: every LIDAR of a group in one cast
# --------------------------------------------------------------------- #
def _carried(name, B=8, seed=0):
    """The JAX package's world of ``name`` (made and finalized, no env) and
    the port's env, both at one random state of pos and rot: entities
    within 0.6 of the origin, so that rays hit."""
    js = importlib.import_module(
        f"vectorizedmultiagentsimulator_tpu.scenarios.{name}").Scenario()
    jw = js.env_make_world(B, None)
    jw.finalize(key=jax.random.PRNGKey(0))
    env = vmt_torch.make_env(name, num_envs=B, device="cpu", seed=0)
    rng = np.random.RandomState(seed)
    shape = tuple(env.world.state.pos.shape)
    pos = rng.uniform(-0.6, 0.6, shape).astype(np.float32)
    rot = rng.uniform(-math.pi, math.pi, shape[:2] + (1,)).astype(np.float32)
    jw.bind(jw.state.replace(pos=jnp.asarray(pos), rot=jnp.asarray(rot)))
    state_from_numpy(env, {"pos": pos, "rot": rot})
    return jw, env


def _count_casts(monkeypatch):
    """Count ``raycast_cuda.fused_cast_rays`` calls (on the CPU no launch is
    counted)."""
    calls = []
    fused = raycast_cuda.fused_cast_rays

    def counted(*args):
        calls.append(args[3])
        return fused(*args)

    monkeypatch.setattr(raycast_cuda, "fused_cast_rays", counted)
    return calls


@pytest.mark.parametrize("name", ["navigation", "flocking"])
def test_grouped_measure_matches_jax(name, monkeypatch):
    """Every agent's ``Lidar.measure`` at B = 8 from one carried state: the
    port casts the four LIDARs at once (one call, four origins) and each
    agent's slice agrees with the JAX package's ``Lidar.measure`` within
    1e-5 (test_golden_geometry.py's ray-cast tolerance)."""
    jw, env = _carried(name)
    calls = _count_casts(monkeypatch)
    agents = [a for a in env.world.agents if a.sensors]
    got = [a.sensors[0].measure() for a in agents]
    assert calls == [tuple(a.index for a in agents)]
    hits = 0
    for a, g in zip(agents, got):
        ja = jw.entities[a.index]
        assert ja.name == a.name
        ref = np.asarray(ja.sensors[0].measure())
        np.testing.assert_allclose(g.numpy(), ref, atol=ATOL, err_msg=a.name)
        hits += int((ref < ref.max()).sum())
    assert hits > 20


@pytest.mark.parametrize("name", ["navigation", "flocking"])
def test_env_step_casts_once(name, monkeypatch):
    """A step's observations cast every LIDAR of the group in one call, and
    a masked reset casts once more (its poses are written)."""
    env = vmt_torch.make_env(name, num_envs=4, device="cpu", seed=0)
    calls = _count_casts(monkeypatch)
    for _ in range(3):
        env.step(env.get_random_actions())
    assert len(calls) == 3 and all(len(c) == 4 for c in calls)
    env.reset_at(torch.tensor([True, False, True, False]))
    assert len(calls) == 4


def _write(env, how):
    """Change what a cast reads between two measures."""
    w, a1 = env.world, env.world.agents[1]
    if how == "set_pos":
        a1.set_pos(a1.state.pos + 0.05, batch_index=None)
    elif how == "set_rot":
        a1.set_rot(a1.state.rot + 0.3, batch_index=None)
    elif how == "reset_at":
        env.reset_at(0)
    elif how == "step":
        env.step(env.get_random_actions())
    elif how == "bind":
        s = w.state
        w.bind(type(s)(**{**vars(s), "pos": s.pos.flip(0).contiguous()}))
    elif how == "in_place":
        w.state.pos[:, a1.index].add_(0.05)
    else:
        raise ValueError(how)


@pytest.mark.parametrize("how", ["set_pos", "set_rot", "reset_at", "step",
                                 "bind", "in_place", "grad_mode"])
def test_a_write_between_measures_casts_anew(how):
    """Agent 0's measure casts the group; a pose write (or a new state, or
    another grad mode) before agent 1's measure gives agent 1 a fresh cast
    of the new state, equal to its own single cast; with no write, agent 1
    reads the cached slice."""
    _, env = _carried("navigation")
    w = env.world
    a0, a1 = w.agents[:2]
    lidar = a1.sensors[0]

    def single():
        return w.cast_rays(a1, lidar._angles, lidar._max_range,
                           lidar.entity_filter)

    with torch.no_grad():
        a0.sensors[0].measure()
        group, slot = w._lidar_groups[(lidar, a1, lidar.entity_filter)]
        cached = group.out
        assert torch.equal(lidar.measure(), single())
        assert group.out is cached  # nothing written: the cached slice
        before = lidar.measure().clone()
        if how != "grad_mode":
            _write(env, how)
            got = lidar.measure()
    if how == "grad_mode":
        got = lidar.measure()
    assert group.out is not cached
    assert torch.equal(got, single())
    if how != "grad_mode":
        assert not torch.equal(got, before)


@pytest.mark.parametrize("name", ["navigation", "flocking"])
def test_gradient_through_cached_measures_is_per_origin(name):
    """Gradients of a loss over every agent's measure (the first casts the
    group, the others read its slices) equal those of the plain version
    cast origin by origin over each agent's own table."""
    _, env = _carried(name, seed=1)
    w, s = env.world, env.world.state
    agents = [a for a in w.agents if a.sensors]
    lidar = agents[0].sensors[0]
    weights = torch.randn((len(agents),) + tuple(lidar._angles.shape),
                          generator=torch.Generator().manual_seed(0))

    def grads(measure):
        pos = s.pos.detach().clone().requires_grad_(True)
        rot = s.rot.detach().clone().requires_grad_(True)
        s.pos, s.rot = pos, rot
        loss = sum((measure(a) * wt).sum() for a, wt in zip(agents, weights))
        return torch.autograd.grad(loss, (pos, rot))

    def per_origin(a):
        x = a.sensors[0]
        own = [e.index for e in w.entities
               if x.entity_filter(e) and e is not a]
        table = raycast_cuda.cast_table(w, own, [], [])
        return raycast_cuda.cast_rays_plain(s.pos, s.rot, x._angles, a.index,
                                            table, x._max_range)

    got = grads(lambda a: a.sensors[0].measure())
    ref = grads(per_origin)
    for name_, g, r in zip(("pos", "rot"), got, ref):
        assert torch.isfinite(g).all(), name_
        torch.testing.assert_close(g, r, rtol=1e-6, atol=1e-6, msg=name_)
    assert got[0].abs().sum() > 0 and got[1].abs().sum() > 0
