"""The physics (joints included), ray-cast, planner, PPO-update and
road-geometry kernels on the card against their plain versions, the
joint worlds' routes, and the masked reset and the
trainer under the host-sync check.  These tests need an NVIDIA GPU and nvcc; elsewhere they skip.
This file imports no JAX, so on a machine with PyTorch only it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import math
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from physics_configs import CONFIGS
from torch_helpers import (
    JOINTS_STATIC_ROTATION,
    MANY_ENTITIES,
    build_world,
    geometry_diff,
    jittered_inputs,
    neighbor_diff,
    physics_diff,
    planner_fields,
    planner_selection_diff,
    posed_step_inputs,
    poses_at_path_ends,
    poses_near_path_ends,
    random_neighbor_inputs,
    random_planner_inputs,
    random_ppo_inputs,
    random_step_inputs,
)

import vectorizedmultiagentsimulator_tpu_torch as vmt_torch
from vectorizedmultiagentsimulator_tpu_torch.examples import torch_ppo
from vectorizedmultiagentsimulator_tpu_torch.ops import (
    football_policy_cuda,
    physics_cuda,
    ppo_update_cuda,
    raycast_cuda,
    road_geometry,
    road_geometry_cuda,
)

pytestmark = pytest.mark.cuda

B = 2048
# Physics kernel vs plain, one step from identical inputs: fp32 force sums
# in another order, held by torch_helpers.physics_diff at 1e-4 + 1e-4|ref|
# (PHYS_ATOL, PHYS_RTOL; see chip_smoke.py).

# A kernel world with every per-entity feature the kernel covers: world
# and per-entity static gravity, per-env dyn_gravity, linear and angular
# friction, drag overrides, max_speed, v_range, a hollow movable box in a
# box-box pair, and several substeps.
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
        dict(name="hb", shape=("box", 0.5, 0.4, True), movable=True,
             rotatable=True, mass=2.0, angular_friction=0.05),
    ],
    spread=0.3,
)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    physics_cuda.build()
    raycast_cuda.build()
    football_policy_cuda.build()
    road_geometry_cuda.build()


def _compare(world, inputs, stiff=False):
    """One launch against the plain version: within 1e-4 + 1e-4|plain|, or,
    for a ``stiff`` joint world, torch_helpers.physics_diff's float64 rule
    where it exceeds that."""
    assert world._use_kernel
    before = physics_cuda.LAUNCHES
    with torch.no_grad():
        got = physics_cuda.fused_step(world, *inputs)
    torch.cuda.synchronize()
    assert physics_cuda.LAUNCHES == before + 1
    report = physics_diff(world, inputs, got, stiff=stiff)
    assert report["ok"], report


@pytest.mark.parametrize("cfg", ["spheres", "clamps", "hollow_box", "features",
                                 "boxes_lines", "gravity_friction"])
def test_kernel_matches_plain(cuda, cfg):
    spec = FEATURES if cfg == "features" else CONFIGS[cfg]
    world, _ = build_world(spec, B, device="cuda")
    if cfg == "features":
        assert world._dyn_gravity_names == ["a3"]
        assert len(world._pairs["bb"]) == 1
    _compare(world, random_step_inputs(world, spec["spread"], seed=11))


def test_kernel_matches_plain_balance(cuda):
    """Balance's line-sphere, box-sphere and box-line pairs, from its
    reset state and from random inputs."""
    env = vmt_torch.make_env("balance", num_envs=B, device="cuda", seed=0)
    w, s = env.world, env.world.state
    assert all(len(w._pairs[c]) for c in ("ss", "bs", "ls", "bl"))
    _compare(w, (s.pos, s.vel, s.rot, s.ang_vel, s.force, s.torque,
                 physics_cuda.stacked_dyn_gravity(w, s.extras)))
    _compare(w, random_step_inputs(w, 0.5, seed=15))


@pytest.mark.parametrize("name", ["joints", "joints_static_rotation"])
def test_kernel_matches_plain_joints(cuda, name):
    """The joint branch on the two joint worlds that take the kernel (the
    ``joints`` config; the static fixed rotation 0.3 and a dist-0
    constraint that does not rotate), posed as the goldens are (the joint
    observers place the joint landmarks): within 1e-4 + 1e-4|plain|; two
    launches bit-identical."""
    spec = CONFIGS[name] if name in CONFIGS else JOINTS_STATIC_ROTATION
    world, ents = build_world(spec, B, device="cuda")
    assert len(world._ordered_constraints) and world._use_kernel
    inputs = posed_step_inputs(world, ents, spec, seed=13)
    with torch.no_grad():
        a = physics_cuda.fused_step(world, *inputs)
        b = physics_cuda.fused_step(world, *inputs)
    report = physics_diff(world, inputs, a)
    assert report["ok"], report
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("scenario", ["asym_joint", "ball_trajectory",
                                      "buzz_wire", "joint_passage",
                                      "joint_passage_size"])
def test_kernel_matches_plain_joint_scenarios(cuda, scenario):
    """Each joint scenario's world from its reset state and from it with
    every pose jittered, which stretches every constraint (both within
    1e-4 + 1e-4|plain|), and from random inputs (torch_helpers.
    physics_diff's float64 rule where a stiff world exceeds that)."""
    env = vmt_torch.make_env(scenario, num_envs=B, device="cuda", seed=0)
    w, s = env.world, env.world.state
    assert w._use_kernel
    reset = (s.pos, s.vel, s.rot, s.ang_vel, s.force, s.torque,
             physics_cuda.stacked_dyn_gravity(w, s.extras))
    _compare(w, reset)
    _compare(w, jittered_inputs(reset, seed=17))
    _compare(w, random_step_inputs(w, 0.5, seed=16), stiff=True)


@pytest.mark.parametrize("scenario,kwargs", [
    ("waterfall", {}), ("physics_joints_fixed_rotation", {})])
def test_joint_worlds_on_the_plain_route(cuda, scenario, kwargs):
    """waterfall (over the size guard, rotations inferred per env) and
    joints_fixed_rotation step through the plain version on the card: no
    physics launch, finite state."""
    if scenario == "waterfall":
        env = vmt_torch.make_env(scenario, num_envs=64, device="cuda",
                                 seed=0)
        world = env.world
        step = lambda: env.step(env.get_random_actions())  # noqa: E731
    else:
        world, ents = build_world(CONFIGS["joints_fixed_rotation"], 64,
                                  device="cuda")
        for e in ents.values():  # the joint observer writes the rotation
            e.set_pos(torch.rand((64, 2), device="cuda") * 0.5)
        assert any(k.startswith("joint_fixed_rotation")
                   for k in world.state.extras)
        step = world.step
    assert not world._use_kernel
    before = physics_cuda.LAUNCHES
    for _ in range(3):
        step()
    assert physics_cuda.LAUNCHES == before
    assert bool(torch.isfinite(world.state.pos).all())


FIVE_A_SIDE = dict(n_blue_agents=5, n_red_agents=5)


@pytest.mark.parametrize("scenario,kwargs,planners", [
    ("transport", {}, 0), ("simple_spread", {}, 0), ("navigation", {}, 0),
    ("flocking", {}, 0), ("balance", {}, 0), ("football", FIVE_A_SIDE, 1),
    ("joint_passage", {}, 0), ("buzz_wire", {}, 0)])
def test_main_path_one_launch_per_step_no_sync(cuda, scenario, kwargs,
                                                planners):
    """One physics launch a step, one ray-cast launch per LIDAR measure
    (one LIDAR per agent), one planner launch per AI team and step, and no
    host sync over 5 steps."""
    env = vmt_torch.make_env(scenario, num_envs=B, device="cuda", seed=0,
                             **kwargs)
    _compare(env.world, random_step_inputs(env.world, 0.3, seed=12),
             stiff=scenario in ("joint_passage", "buzz_wire"))
    lidars = sum(len(a.sensors) for a in env.agents)
    actions = [env.get_random_actions() for _ in range(5)]
    torch.cuda.synchronize()
    steps, casts = physics_cuda.LAUNCHES, raycast_cuda.LAUNCHES
    plans = football_policy_cuda.LAUNCHES
    torch.cuda.set_sync_debug_mode("error")
    try:
        for a in actions:
            obs, rews, dones, _ = env.step(a)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert physics_cuda.LAUNCHES == steps + 5
    assert raycast_cuda.LAUNCHES == casts + 5 * lidars
    assert football_policy_cuda.LAUNCHES == plans + 5 * planners
    assert all(bool(torch.isfinite(o).all()) for o in obs)


@pytest.mark.parametrize("T,has_noise", [(1, False), (3, False), (5, False),
                                         (5, True)])
def test_planner_kernel_matches_plain(cuda, T, has_noise):
    """The planner kernel against its plain version from the same random
    inputs: rows that pick the same candidate within 1e-6, any other pick
    only at a near tie; a second launch gives the same bits."""
    p = football_policy_cuda.PlannerParams(**planner_fields(
        T, has_noise=has_noise))
    inputs = [None if x is None else torch.as_tensor(x, device="cuda")
              for x in random_planner_inputs(B, T, 2, has_noise, seed=T)]
    before = football_policy_cuda.LAUNCHES
    got = football_policy_cuda.fused_best_positions(p, *inputs)
    again = football_policy_cuda.fused_best_positions(p, *inputs)
    torch.cuda.synchronize()
    assert football_policy_cuda.LAUNCHES == before + 2
    assert torch.equal(got, again)
    same_err, flips, not_ties, gap = planner_selection_diff(
        football_policy_cuda, p, inputs, got)
    assert same_err <= 1e-6 and not_ties == 0, (same_err, flips, gap)
    with pytest.raises(ValueError, match="mixed devices"):
        football_policy_cuda.fused_best_positions(p, inputs[0].cpu(),
                                                  *inputs[1:])
    strided = torch.zeros((B, T, 4), device="cuda")[..., :2]
    strided.copy_(inputs[0])
    with pytest.raises(ValueError, match="contiguous"):
        football_policy_cuda.fused_best_positions(p, strided, *inputs[1:])


def _cast_scene(seed, axis_aligned=False):
    """A 30k-env scene of 2 boxes, 2 spheres and 2 lines around an origin
    agent (entity 6), on the card, with its cast table."""
    world, _ = build_world(dict(
        agents=[dict(name="a", shape=("sphere", 0.03))],
        landmarks=[dict(name="b0", shape=("box", 0.4, 0.2, False)),
                   dict(name="b1", shape=("box", 0.3, 0.3, False)),
                   dict(name="s0", shape=("sphere", 0.15)),
                   dict(name="s1", shape=("sphere", 0.25)),
                   dict(name="l0", shape=("line", 0.6)),
                   dict(name="l1", shape=("line", 0.9))],
    ), 30_000, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(seed)
    pos = torch.rand((30_000, 7, 2), generator=g, device="cuda") * 1.6 - 0.8
    rot = torch.rand((30_000, 7, 1), generator=g, device="cuda") * 6.3 - 3.15
    angles = torch.rand((12,), generator=g, device="cuda") * 6.3 - 3.15
    if axis_aligned:
        rot[:, :2] = 0.0
        angles = torch.tensor([0.0, math.pi / 2, math.pi, -math.pi / 2] * 3,
                              device="cuda")
        pos[:, 0] = torch.tensor([0.1, 0.0], device="cuda")
        pos[:, 6, 1] = torch.tensor([0.1, -0.1], device="cuda").repeat(15_000)
    table = raycast_cuda.cast_table(world, [2, 3], [0, 1], [4, 5])
    return pos, rot, angles, table


@pytest.mark.parametrize("axis_aligned", [False, True])
def test_raycast_kernel_matches_plain(cuda, axis_aligned):
    pos, rot, angles, table = _cast_scene(16, axis_aligned)
    before = raycast_cuda.LAUNCHES
    for ang in (angles, angles[None] + rot[:, 6]):  # relative, world frame
        got = raycast_cuda.fused_cast_rays(pos, rot, ang, 6, table, 1.5)
        ref = raycast_cuda.cast_rays_plain(pos, rot, ang, 6, table, 1.5)
        torch.cuda.synchronize()
        assert int(((got == 1.5) != (ref == 1.5)).sum()) == 0
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    assert raycast_cuda.LAUNCHES == before + 2


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
    many, _ = build_world(MANY_ENTITIES, 8, device="cuda")
    with pytest.raises(RuntimeError, match="does not step through the kernel"):
        physics_cuda.fused_step(
            many, *random_step_inputs(many, 0.3, seed=14)
        )

    pos, rot, angles, table = _cast_scene(17)
    pos, rot = pos[:8].contiguous(), rot[:8].contiguous()
    with pytest.raises(ValueError, match="mixed devices"):
        raycast_cuda.fused_cast_rays(pos.cpu(), rot, angles, 6, table, 1.5)
    with pytest.raises(TypeError, match="float32"):
        raycast_cuda.fused_cast_rays(pos, rot, angles.double(), 6, table, 1.5)
    with pytest.raises(ValueError, match="contiguous"):
        raycast_cuda.fused_cast_rays(pos, rot, torch.zeros(
            (12, 8), device="cuda").t(), 6, table, 1.5)
    with pytest.raises(ValueError, match="origin entity"):
        raycast_cuda.fused_cast_rays(pos, rot, angles, 7, table, 1.5)


@pytest.mark.parametrize("scenario", [
    "transport", "simple_spread", "navigation", "flocking", "balance",
    "dispersion", "simple_speaker_listener", "football", "road_traffic"])
def test_masked_reset_no_sync(cuda, scenario):
    """``reset_at`` with a bool mask (the trainer's reset in every step)
    reads nothing from the device and leaves the other envs alone."""
    env = vmt_torch.make_env(scenario, num_envs=B, device="cuda", seed=0)
    env.step(env.get_random_actions())
    mask = torch.rand((B,), device="cuda") > 0.5
    before = env.world.state.pos.clone()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        obs = env.reset_at(mask)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    after = env.world.state.pos
    assert torch.equal(after[~mask], before[~mask])
    assert bool((env.steps == torch.where(mask, 0, 1)).all())
    assert all(bool(torch.isfinite(o).all()) for o in obs)


# Per gradient, as a share of its largest entry, and per loss sum: fp32
# sums of either sign in another order, and the card's tanhf/expf against
# the library's (see chip_smoke.py).
PPO_GRAD_TOL, PPO_SUM_RTOL, PPO_SUM_ATOL_PER_SAMPLE = 2e-3, 1e-4, 1e-6


@pytest.mark.parametrize("name,fields,nb_tot", [
    ("gaussian", dict(obs_d=15, act_w=2, hidden=64, lb=256, mb=8192), 64),
    ("flat_categorical",
     dict(obs_d=15, act_w=1, hidden=64, lb=256, mb=8192, n_logits=9), 64),
    ("multidiscrete",
     dict(obs_d=15, act_w=2, hidden=64, lb=256, mb=8192, n_logits=3), 64),
    ("ragged_tile_norm_n",
     dict(obs_d=6, act_w=1, hidden=16, lb=8, mb=1000, norm_n=4000), 300),
    # Wider trunks run with tiles of 64, 32 and 16 samples.
    ("hidden96", dict(obs_d=15, act_w=2, hidden=96, lb=256, mb=8192), 64),
    ("hidden128", dict(obs_d=15, act_w=2, hidden=128, lb=256, mb=8192), 64),
    ("hidden128_multidiscrete",
     dict(obs_d=15, act_w=2, hidden=128, lb=8, mb=1000, n_logits=3), 300),
])
def test_ppo_kernel_matches_plain(cuda, name, fields, nb_tot):
    spec = ppo_update_cuda.PPOUpdateSpec(clip_eps=0.2, vf_coef=0.5,
                                         ent_coef=0.01, **fields)
    packed, perm, stats, params = random_ppo_inputs(spec, nb_tot, seed=21)
    inputs = (torch.as_tensor(packed, device="cuda"),
              torch.as_tensor(perm, device="cuda"),
              torch.as_tensor(stats, device="cuda"),
              tuple(torch.as_tensor(p, device="cuda") for p in params))
    before = ppo_update_cuda.LAUNCHES
    got_g, got_s = ppo_update_cuda.minibatch_update(spec, *inputs)
    rep_g, rep_s = ppo_update_cuda.minibatch_update(spec, *inputs)
    ref_g, ref_s = ppo_update_cuda.minibatch_update_plain(spec, *inputs)
    torch.cuda.synchronize()
    assert ppo_update_cuda.LAUNCHES == before + 2
    for a, b in zip(got_g + got_s, rep_g + rep_s):
        assert torch.equal(a, b)  # no float atomics: the same bits
    for i, (g, r) in enumerate(zip(got_g, ref_g)):
        assert g.shape == r.shape
        assert float((g - r).abs().max()) <= PPO_GRAD_TOL * float(
            r.abs().max()) + 1e-12, f"grad {i}"
    for g, r in zip(got_s, ref_s):
        assert abs(float(g) - float(r)) <= (
            PPO_SUM_RTOL * abs(float(r)) + PPO_SUM_ATOL_PER_SAMPLE * spec.mb)
    with pytest.raises(ValueError, match="mixed devices"):
        ppo_update_cuda.minibatch_update(spec, inputs[0].cpu(), *inputs[1:])
    with pytest.raises(TypeError, match="int32"):
        ppo_update_cuda.minibatch_update(spec, inputs[0], inputs[1].long(),
                                         *inputs[2:])


@pytest.mark.parametrize("scenario,kwargs,casts", [
    ("transport", {}, 0),
    ("transport", dict(continuous_actions=False, multidiscrete_actions=True),
     0),
    ("navigation", {}, 8),
])
def test_train_step_launch_counts_no_sync(cuda, scenario, kwargs, casts):
    """Two training iterations on the card with no host sync: one PPO
    launch per epoch and minibatch, one physics launch per rollout step,
    two casts per LIDAR and step (the step's observation and the masked
    reset's)."""
    cfg = torch_ppo.PPOConfig(rollout_steps=8, epochs=2, minibatches=2,
                              fused_block=256)
    env, step, trainer = torch_ppo.init_training(scenario, 256, 0, cfg,
                                                 **kwargs)
    assert trainer.fused and env.device.type == "cuda"
    trainer, _ = step(trainer)  # builds the kernel for this head
    before = [p.detach().clone() for p in trainer.model.ordered_parameters()]
    torch.cuda.synchronize()
    counts = (ppo_update_cuda.LAUNCHES, physics_cuda.LAUNCHES,
              raycast_cuda.LAUNCHES)
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            trainer, metrics = step(trainer)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert ppo_update_cuda.LAUNCHES == counts[0] + 2 * 4
    assert physics_cuda.LAUNCHES == counts[1] + 2 * 8
    assert raycast_cuda.LAUNCHES == counts[2] + 2 * 8 * casts
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["mean_reward"]))
    assert any(not torch.equal(p, b) for p, b in
               zip(trainer.model.ordered_parameters(), before))


def test_ppo_kernel_refuses_a_trunk_it_does_not_take(cuda):
    """On the card a spec the kernel does not take raises, in the wrapper
    and when a trainer is built: nothing trains through another path."""
    spec = ppo_update_cuda.PPOUpdateSpec(
        obs_d=15, act_w=2, hidden=256, lb=256, mb=8192, clip_eps=0.2,
        vf_coef=0.5, ent_coef=0.01)
    packed, perm, stats, params = random_ppo_inputs(spec, 64, seed=22)
    with pytest.raises(ValueError, match="does not take"):
        ppo_update_cuda.minibatch_update(
            spec, torch.as_tensor(packed, device="cuda"),
            torch.as_tensor(perm, device="cuda"),
            torch.as_tensor(stats, device="cuda"),
            tuple(torch.as_tensor(p, device="cuda") for p in params))
    with pytest.raises(ValueError, match="does not take"):
        torch_ppo.init_training(
            "transport", 256, 0,
            torch_ppo.PPOConfig(rollout_steps=8, hidden=256, fused_block=256))


ROAD_MAP3 = dict(map_type="3", n_agents=10)


@pytest.mark.parametrize("kwargs,poses", [
    ({}, "reset"), ({}, "jitter"), ({}, "last"), (ROAD_MAP3, "reset"),
    (ROAD_MAP3, "ends")])
def test_road_geometry_kernels_match_plain(cuda, kwargs, poses):
    """The agent-geometry and pair kernels against geometry_plain
    (torch_helpers.geometry_diff; on path vertices, at reset or just before
    the paths' ends, no index moves and no flag flips), with and without
    collisions, and two
    launches bit-identical; the neighbour kernel at the same poses (nd
    bit-equal)."""
    env = vmt_torch.make_env("road_traffic", num_envs=B, device="cuda",
                             seed=0, **kwargs)
    sc, s = env.scenario, env.world.state
    pos, rot = s.pos, s.rot[..., 0]
    if poses == "jitter":
        g = torch.Generator(device="cuda").manual_seed(3)
        pos = (pos + (torch.rand(pos.shape, generator=g, device="cuda")
                      - 0.5) * 0.2).contiguous()
        rot = (rot + (torch.rand(rot.shape, generator=g, device="cuda")
                      - 0.5)).contiguous()
    elif poses == "ends":
        pos, rot = poses_at_path_ends(sc._tables, sc.path_id, seed=4)
    elif poses == "last":
        pos, rot = poses_near_path_ends(sc._tables, sc.path_id, seed=4)
    before = dict(road_geometry_cuda.LAUNCHES)
    got = road_geometry_cuda.fused_geometry(sc._tables, True, pos, rot,
                                            sc.path_id)
    again = road_geometry_cuda.fused_geometry(sc._tables, True, pos, rot,
                                              sc.path_id)
    bare = road_geometry_cuda.fused_geometry(sc._tables, False, pos, rot,
                                             sc.path_id)
    ref = road_geometry.geometry_plain(sc._tables, True, pos, rot, sc.path_id)
    torch.cuda.synchronize()
    assert road_geometry_cuda.LAUNCHES["agent_geometry"] == (
        before["agent_geometry"] + 3)
    assert road_geometry_cuda.LAUNCHES["pair_collisions"] == (
        before["pair_collisions"] + 2)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert all(torch.equal(a, b) for a, b in zip(got, bare))
    report = geometry_diff(sc._tables, pos, rot, sc.path_id, got, ref)
    assert report["bad"] == 0, report
    if poses in ("reset", "last"):
        assert report["moved"] == report["flipped"] == 0, report
        assert torch.equal(got[4], ref[4]) and torch.equal(got[0], ref[0])
    if poses == "ends":
        assert float(ref[7].sum()) > 0 and float(ref[8].sum()) > 0
    args = (sc.n_agents, sc.n_nearing_agents_observed,
            (sc.l_f + sc.l_r) / 2.0, sc.agent_width / 2.0, pos, rot, s.vel,
            sc.distances_agents / sc.normalizer_distance_lanelet)
    got = road_geometry_cuda.fused_neighbor_obs(*args)
    ref = road_geometry.neighbor_obs_plain(*args)
    report = neighbor_diff(got, ref)
    assert report["nd_equal"] and report["bad"] == 0, report


def test_neighbor_kernel_matches_plain_random(cuda):
    args = [torch.as_tensor(x, device="cuda")
            for x in random_neighbor_inputs(B, 20, seed=5)]
    before = road_geometry_cuda.LAUNCHES["neighbor_obs"]
    got = road_geometry_cuda.fused_neighbor_obs(20, 2, 0.08, 0.04, *args)
    ref = road_geometry.neighbor_obs_plain(20, 2, 0.08, 0.04, *args)
    torch.cuda.synchronize()
    assert road_geometry_cuda.LAUNCHES["neighbor_obs"] == before + 1
    report = neighbor_diff(got, ref)
    assert report["nd_equal"] and report["bad"] == 0, report
    with pytest.raises(ValueError, match="mixed devices"):
        road_geometry_cuda.fused_neighbor_obs(20, 2, 0.08, 0.04,
                                              args[0].cpu(), *args[1:])
    with pytest.raises(ValueError, match="contiguous"):
        road_geometry_cuda.fused_neighbor_obs(
            20, 2, 0.08, 0.04, args[0], args[1], args[2],
            args[3].transpose(1, 2))


def test_road_autograd_is_the_plain_versions(cuda):
    """Gradients through both wrappers on CUDA tensors equal those through
    the plain versions on the card (the backward re-runs them)."""
    env = vmt_torch.make_env("road_traffic", num_envs=64, device="cuda",
                             seed=0)
    sc, s = env.scenario, env.world.state
    g = torch.Generator(device="cuda").manual_seed(6)
    pos0 = s.pos + (torch.rand(s.pos.shape, generator=g, device="cuda")
                    - 0.5) * 0.2
    rot0 = s.rot[..., 0].clone()

    def geometry_grads(fn):
        pos = pos0.clone().requires_grad_(True)
        rot = rot0.clone().requires_grad_(True)
        out = fn(sc._tables, True, pos, rot, sc.path_id)
        sum((o**2).sum() for o in out).backward()
        return pos.grad, rot.grad

    for got, ref in zip(geometry_grads(road_geometry_cuda.fused_geometry),
                        geometry_grads(road_geometry.geometry_plain)):
        assert bool(torch.isfinite(got).all()) and float(got.abs().sum()) > 0
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
    args = [torch.as_tensor(x, device="cuda")
            for x in random_neighbor_inputs(64, 6, seed=7)]

    def neighbor_grads(fn):
        leaves = [x.clone().requires_grad_(True) for x in args]
        out = fn(6, 2, 0.08, 0.04, *leaves)
        sum((o**2).sum() for o in out).backward()
        return [x.grad for x in leaves]

    for got, ref in zip(neighbor_grads(road_geometry_cuda.fused_neighbor_obs),
                        neighbor_grads(road_geometry.neighbor_obs_plain)):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)


@pytest.mark.parametrize("kwargs,agent_geometry", [({}, 1), (ROAD_MAP3, 2)])
def test_road_traffic_launches_no_sync(cuda, kwargs, agent_geometry):
    """road_traffic on the card: a physics launch, one of each road kernel
    a step (map '3' re-places agents in done(): a second agent-geometry
    launch), and no host sync over 5 steps."""
    env = vmt_torch.make_env("road_traffic", num_envs=B, device="cuda",
                             seed=0, **kwargs)
    actions = [env.get_random_actions() for _ in range(5)]
    torch.cuda.synchronize()
    steps = physics_cuda.LAUNCHES
    road = dict(road_geometry_cuda.LAUNCHES)
    torch.cuda.set_sync_debug_mode("error")
    try:
        for a in actions:
            obs, rews, dones, _ = env.step(a)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert physics_cuda.LAUNCHES == steps + 5
    expected = {"agent_geometry": 5 * agent_geometry, "pair_collisions": 5,
                "neighbor_obs": 5}
    assert {k: road_geometry_cuda.LAUNCHES[k] - road[k]
            for k in road} == expected
    assert all(o.shape == (B, 32) and bool(torch.isfinite(o).all())
               for o in obs)
