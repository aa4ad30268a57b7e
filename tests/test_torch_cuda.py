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
    functional_checks,
    geometry_diff,
    graph_kernels,
    jittered_inputs,
    kept_graphs,
    neighbor_diff,
    physics_diff,
    planner_fields,
    planner_selection_diff,
    posed_step_inputs,
    poses_at_chunk_margins,
    poses_at_path_ends,
    poses_near_path_ends,
    poses_near_self,
    random_map_poses,
    random_neighbor_inputs,
    random_planner_inputs,
    random_ppo_inputs,
    random_step_inputs,
    strided_planner_views,
    tied_planner_inputs,
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


@pytest.mark.parametrize("lanes", [1, 2, 4, 8])
@pytest.mark.parametrize("scenario", ["joint_passage", "football"])
def test_kernel_matches_plain_at_every_lane_group(cuda, scenario, lanes):
    """The physics kernel with each lane group, not only the one chosen at
    finalize: from random inputs within 1e-4 + 1e-4|plain| (joint_passage
    by the float64 rule where it exceeds that), two launches
    bit-identical."""
    kwargs = dict(n_blue_agents=5, n_red_agents=5) if scenario == "football" \
        else {}
    env = vmt_torch.make_env(scenario, num_envs=B, device="cuda", seed=0,
                             **kwargs)
    w = env.world
    inputs = random_step_inputs(w, 1.0 if scenario == "football" else 0.5,
                                seed=18)
    with physics_cuda.lanes(w, lanes):
        _compare(w, inputs, stiff=scenario == "joint_passage")
        with torch.no_grad():
            a = physics_cuda.fused_step(w, *inputs)
            b = physics_cuda.fused_step(w, *inputs)
        assert all(torch.equal(x, y) for x, y in zip(a, b))


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
    ("joint_passage", {}, 0), ("buzz_wire", {}, 0), ("discovery", {}, 0),
    ("sampling", {}, 0)])
def test_main_path_one_launch_per_step_no_sync(cuda, scenario, kwargs,
                                                planners):
    """One physics launch a step, one ray-cast launch per LIDAR group and
    step (navigation's and flocking's four LIDARs are one group, as are
    discovery's five and sampling's three), one planner launch per AI team
    and step, and no host sync over 5 steps (discovery's respawn
    included)."""
    env = vmt_torch.make_env(scenario, num_envs=B, device="cuda", seed=0,
                             **kwargs)
    _compare(env.world, random_step_inputs(env.world, 0.3, seed=12),
             stiff=scenario in ("joint_passage", "buzz_wire"))
    lidars = sum(len(a.sensors) for a in env.agents)
    groups = len({id(g) for g, _ in env.world._lidar_groups.values()})
    assert groups == (1 if lidars else 0)
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
    assert raycast_cuda.LAUNCHES == casts + 5 * groups
    assert football_policy_cuda.LAUNCHES == plans + 5 * planners
    assert all(bool(torch.isfinite(o).all()) for o in obs)


@pytest.mark.parametrize("T,has_noise", [(1, False), (3, False), (5, False),
                                         (5, True)])
def test_planner_kernel_matches_plain(cuda, T, has_noise):
    """The planner kernel against its plain version from the same random
    inputs, with exact ties (torch_helpers.tied_planner_inputs), the draws
    scaled in the kernel, curr_target, the ball and the nets as strided
    views of a stacked state: rows that pick the same candidate within
    1e-6, any other pick only at a near tie; a second launch gives the
    same bits."""
    p = football_policy_cuda.PlannerParams(**planner_fields(
        T, has_noise=has_noise), sigma=0.55, spread=1.3, noise_scale=0.1)
    inputs = [None if x is None else torch.as_tensor(x, device="cuda")
              for x in tied_planner_inputs(
                  random_planner_inputs(B, T, 2, has_noise, seed=T))]
    views = strided_planner_views(inputs)
    before = football_policy_cuda.LAUNCHES
    got = football_policy_cuda.fused_best_positions(p, *views)
    again = football_policy_cuda.fused_best_positions(p, *views)
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


GRAPH_PATHS = [
    # (scenario, kwargs, ray casts, planner launches, road launches a step)
    ("transport", {}, 0, 0, 0), ("simple_spread", {}, 0, 0, 0),
    ("navigation", {}, 1, 0, 0), ("flocking", {}, 1, 0, 0),
    ("balance", {}, 0, 0, 0), ("football", FIVE_A_SIDE, 0, 1, 0),
    ("joint_passage", {}, 0, 0, 0), ("buzz_wire", {}, 0, 0, 0),
    ("road_traffic", {}, 0, 0, 1),
    # discovery respawns covered targets inside reward() (a spawner of
    # fixed rounds), or with targets_respawn=False draws a place outside
    # the arena every step; sampling scatters into its visited grid
    ("discovery", {}, 1, 0, 0),
    ("discovery", dict(targets_respawn=False), 1, 0, 0),
    ("sampling", {}, 1, 0, 0)] + [
    (name, {}, 0, 0, 0) for name in (
        "simple", "simple_adversary", "simple_crypto", "simple_push",
        "simple_reference", "simple_tag", "simple_world_comm", "wheel",
        "passage", "ball_passage", "reverse_transport", "dropout",
        "give_way", "multi_give_way", "wind_flocking", "circle_trajectory",
        "line_trajectory", "goal", "vel_control", "diff_drive", "drone",
        "het_mass", "pollock")] + [
    # road_traffic on map '2' (its history ring and initial-state buffer
    # written in place by the captured steps)
    ("road_traffic", dict(map_type="2"), 0, 0, 1),
    # pollock's 15 LIDARs measured one ray cast a ray (16 rays each)
    ("pollock", dict(lidar=True, vectorized_lidar=False), 15 * 16, 0, 0)]


@pytest.mark.parametrize("scenario,kwargs,casts,plans,road", GRAPH_PATHS)
def test_graph_rollout_matches_eager(cuda, scenario, kwargs, casts, plans,
                                     road, B=256, n_steps=5):
    """``rollout`` as a CUDA graph against its eager loop on the card, from
    one state and one generator state: two calls in a row (capture and
    replay, then a replay from the graph's own final state), every output,
    the final state and both generators' states equal to the bit.  Each
    replay runs (the captured graph's kernel nodes, by name) one physics
    kernel a step (none on het_mass's and pollock's plain route), one ray
    cast a LIDAR group, one planner kernel a
    scripted team and one kernel of each road kernel; the wrappers' host
    counts hold the capture's launches (its warm-up step and its steps)
    and no replay's."""
    from vectorizedmultiagentsimulator_tpu_torch import ops
    from vectorizedmultiagentsimulator_tpu_torch.parallel import rollout
    from vectorizedmultiagentsimulator_tpu_torch.parallel.rollout import (
        _flatten,
        _tensors,
    )

    env = vmt_torch.make_env(scenario, num_envs=B, device="cuda", seed=0,
                             **kwargs)
    env.step(env.get_random_actions())
    w = env.world
    start, world_rng = w.state.clone(), w.generator.get_state()
    g = torch.Generator(device="cuda").manual_seed(3)
    policy_rng = g.get_state()
    runs = {}
    with kept_graphs():
        for graph in (True, False):
            w.bind(start.clone())
            w.generator.set_state(world_rng)
            g.set_state(policy_rng)
            runs[graph] = []

            def call():
                traj = rollout(env, n_steps=n_steps, generator=g,
                               graph=graph)[1]
                # the graph's final state lives in buffers the next call
                # of the same graph writes over: keep a copy
                runs[graph].append((_flatten(traj)[0],
                                    _tensors(w.state.clone()),
                                    w.generator.get_state(), g.get_state()))

            before = ops.launch_counts()
            call()
            call()
            if graph:
                counts = {k: n - before[k]
                          for k, n in ops.launch_counts().items()
                          if n != before[k]}
        (captured,) = env._rollout_graphs.values()
        replayed = graph_kernels(captured.graph)
    for (gl, gs, gr, gp), (el, es, er, ep) in zip(runs[True], runs[False]):
        assert all(torch.equal(x, y) for x, y in zip(gl, el))
        assert all(torch.equal(x, es[k]) for k, x in gs.items())
        assert torch.equal(gr, er) and torch.equal(gp, ep)
    per_step = {"physics_step": int(w._use_kernel), "raycast": casts,
                "football_policy": plans}
    per_step.update(dict.fromkeys(road_geometry_cuda.KERNELS, road))
    per_step = {k: n for k, n in per_step.items() if n}
    assert replayed == {k: n * n_steps for k, n in per_step.items()}
    assert counts == {k: n * (n_steps + 1) for k, n in per_step.items()}


def test_graph_cache_keeps_one_graph(cuda, B=256, n_steps=3):
    """A fresh policy at each call (a new lambda) replaces the env's graph
    rather than adding one; fresh generators with one policy replay the
    same graph, and each generator ends where the eager loop leaves it."""
    from vectorizedmultiagentsimulator_tpu_torch.parallel import rollout

    env = vmt_torch.make_env("transport", num_envs=B, device="cuda", seed=0)
    for seed in range(3):
        rollout(env, lambda obs, gen: env.get_random_actions(gen),
                n_steps=n_steps,
                generator=torch.Generator(device="cuda").manual_seed(seed))
        assert len(env._rollout_graphs) == 1

    def policy(obs, gen):
        return env.get_random_actions(gen)

    graphs = []
    for seed in range(2):
        ends = []
        for graph in (True, False):
            g = torch.Generator(device="cuda").manual_seed(seed)
            rollout(env, policy, n_steps=n_steps, generator=g, graph=graph)
            ends.append(g.get_state())
        assert torch.equal(*ends)
        graphs.append(next(iter(env._rollout_graphs.values())))
    assert len(env._rollout_graphs) == 1 and graphs[0] is graphs[1]


def test_benchmark_step_on_the_card(cuda):
    """``benchmark_step`` times graph replays: finite, plausible, and the
    same graph serves a second call with new actions."""
    from vectorizedmultiagentsimulator_tpu_torch.utils.profiling import (
        benchmark_step,
        uniform_actions,
    )

    env = vmt_torch.make_env("transport", num_envs=B, device="cuda", seed=0)
    out = benchmark_step(env, n_steps=20, n_repeats=2)
    assert set(out) == {"wall_s", "env_steps_per_s", "agent_steps_per_s",
                        "times"}
    assert len(out["times"]) == 2 and out["wall_s"] == min(out["times"])
    assert out["agent_steps_per_s"] == out["env_steps_per_s"] * 4
    graphs = len(env._rollout_graphs)
    benchmark_step(env, n_steps=20, n_repeats=1,
                   actions=uniform_actions(env, seed=1))
    assert len(env._rollout_graphs) == graphs


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


@pytest.mark.parametrize("axis_aligned", [False, True])
def test_raycast_kernel_batched_matches_plain(cuda, axis_aligned):
    """One launch from seven origins (the agent and every landmark, each
    skipping itself) against the plain version origin by origin; a second
    launch gives the same bits, and one launch from the agent alone the
    same bits as its slice."""
    pos, rot, angles, _ = _cast_scene(18, axis_aligned)
    world, _ = build_world(dict(
        agents=[dict(name="a", shape=("sphere", 0.03))],
        landmarks=[dict(name="b0", shape=("box", 0.4, 0.2, False)),
                   dict(name="b1", shape=("box", 0.3, 0.3, False)),
                   dict(name="s0", shape=("sphere", 0.15)),
                   dict(name="s1", shape=("sphere", 0.25)),
                   dict(name="l0", shape=("line", 0.6)),
                   dict(name="l1", shape=("line", 0.9))],
    ), 8, device="cuda")
    table = raycast_cuda.cast_table(world, [2, 3, 6], [0, 1], [4, 5])
    origins = (6, 2, 0, 4, 3, 1, 5)
    before = raycast_cuda.LAUNCHES
    got = raycast_cuda.fused_cast_rays(pos, rot, angles, origins, table, 1.5)
    again = raycast_cuda.fused_cast_rays(pos, rot, angles, origins, table,
                                         1.5)
    alone = raycast_cuda.fused_cast_rays(pos, rot, angles, 6, table, 1.5)
    ref = raycast_cuda.cast_rays_plain(pos, rot, angles, origins, table, 1.5)
    torch.cuda.synchronize()
    assert raycast_cuda.LAUNCHES == before + 3
    assert got.shape == (7, 30_000, 12)
    assert torch.equal(got, again) and torch.equal(got[0], alone)
    assert int(((got == 1.5) != (ref == 1.5)).sum()) == 0
    assert int((ref < 1.5).sum()) > 10_000
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("scenario", ["navigation", "flocking"])
def test_grouped_lidars_match_plain_per_origin(cuda, scenario):
    """After 10 steps every agent's LIDAR, cast in one launch for the
    group, against the plain version from that agent over its own table.
    The step's observations cast the group already: measures read that
    launch until a pose is written, and then cast once anew."""
    env = vmt_torch.make_env(scenario, num_envs=B, device="cuda", seed=0)
    for _ in range(10):
        env.step(env.get_random_actions())
    w, s = env.world, env.world.state
    agents = [a for a in w.agents if a.sensors]
    before = raycast_cuda.LAUNCHES
    for a in agents:
        a.sensors[0].measure()
    assert raycast_cuda.LAUNCHES == before
    s.pos = s.pos.clone()
    got = [a.sensors[0].measure() for a in agents]
    assert raycast_cuda.LAUNCHES == before + 1
    hits = 0
    for a, g in zip(agents, got):
        x = a.sensors[0]
        own = [e.index for e in w.entities
               if x.entity_filter(e) and e is not a]
        ref = raycast_cuda.cast_rays_plain(
            s.pos, s.rot, x._angles, a.index,
            raycast_cuda.cast_table(w, own, [], []), x._max_range)
        cap = x._max_range
        assert int(((g == cap) != (ref == cap)).sum()) == 0
        torch.testing.assert_close(g, ref, rtol=1e-5, atol=1e-5)
        hits += int((ref < cap).sum())
    assert hits > 0


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
    "dispersion", "simple_speaker_listener", "football", "road_traffic",
    "discovery", "sampling", "give_way", "wind_flocking", "drone",
    "het_mass"])
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
    # Wider trunks run with tiles of 64, 32 and 16 samples, from about
    # hidden 160 to 256 over a cluster of 4 blocks, from about 260 with the
    # gradient sums in device memory and the weights read from there too;
    # widths that are not a multiple of 16 are padded.
    ("hidden96", dict(obs_d=15, act_w=2, hidden=96, lb=256, mb=8192), 64),
    ("hidden128", dict(obs_d=15, act_w=2, hidden=128, lb=256, mb=8192), 64),
    ("hidden128_multidiscrete",
     dict(obs_d=15, act_w=2, hidden=128, lb=8, mb=1000, n_logits=3), 300),
    ("hidden100", dict(obs_d=22, act_w=2, hidden=100, lb=256, mb=8192), 64),
    ("hidden160", dict(obs_d=15, act_w=2, hidden=160, lb=256, mb=8192), 64),
    ("hidden256", dict(obs_d=15, act_w=2, hidden=256, lb=256, mb=8192), 64),
    ("hidden300", dict(obs_d=15, act_w=2, hidden=300, lb=256, mb=8192), 64),
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


def test_ppo_cluster_layout_at_the_training_cells_shapes(cuda):
    """transport.train's update (obs_d 15, two actions, hidden 256, blocks
    of 4096 samples) at a 65,536-sample minibatch: the cluster layout, one
    launch counted under it a call, the same bits from two launches, the
    plain version's gradients within PPO_GRAD_TOL."""
    spec = ppo_update_cuda.PPOUpdateSpec(
        obs_d=15, act_w=2, hidden=256, lb=4096, mb=65536, clip_eps=0.2,
        vf_coef=0.5, ent_coef=0.01)
    layout = ppo_update_cuda.layout(spec)
    assert layout == (64, False, False, False, ppo_update_cuda.CLUSTER)
    packed, perm, stats, params = random_ppo_inputs(spec, 32, seed=23)
    inputs = (torch.as_tensor(packed, device="cuda"),
              torch.as_tensor(perm, device="cuda"),
              torch.as_tensor(stats, device="cuda"),
              tuple(torch.as_tensor(p, device="cuda") for p in params))
    counts = dict(ppo_update_cuda.LAUNCHES_BY_LAYOUT)
    got_g, got_s = ppo_update_cuda.minibatch_update(spec, *inputs)
    assert ppo_update_cuda.LAUNCHES_BY_LAYOUT.get(layout, 0) == (
        counts.get(layout, 0) + 1)
    rep_g, rep_s = ppo_update_cuda.minibatch_update(spec, *inputs)
    assert ppo_update_cuda.LAUNCHES_BY_LAYOUT == {
        **counts, layout: counts.get(layout, 0) + 2}
    ref_g, ref_s = ppo_update_cuda.minibatch_update_plain(spec, *inputs)
    torch.cuda.synchronize()
    for a, b in zip(got_g + got_s, rep_g + rep_s):
        assert torch.equal(a, b)  # no float atomics: the same bits
    for i, (g, r) in enumerate(zip(got_g, ref_g)):
        assert float((g - r).abs().max()) <= PPO_GRAD_TOL * float(
            r.abs().max()) + 1e-12, f"grad {i}"
    for g, r in zip(got_s, ref_s):
        assert abs(float(g) - float(r)) <= (
            PPO_SUM_RTOL * abs(float(r)) + PPO_SUM_ATOL_PER_SAMPLE * spec.mb)


@pytest.mark.parametrize("scenario,kwargs,casts", [
    ("transport", {}, 0),
    ("transport", dict(continuous_actions=False, multidiscrete_actions=True),
     0),
    ("navigation", {}, 2),
])
def test_train_step_launch_counts_no_sync(cuda, scenario, kwargs, casts):
    """Two training iterations on the card with no host sync: one PPO
    launch per epoch and minibatch, one physics launch per rollout step,
    two casts per LIDAR group and step (the step's observation and the
    masked reset's, each casting navigation's four LIDARs at once)."""
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
    """On the card a spec the kernel does not take (a trunk whose fp32
    activation tiles alone overflow a block's shared memory) raises, in the
    wrapper and when a trainer is built: nothing trains through another
    path.  Hidden 256 trains through the kernel."""
    spec = ppo_update_cuda.PPOUpdateSpec(
        obs_d=15, act_w=2, hidden=1100, lb=256, mb=8192, clip_eps=0.2,
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
            torch_ppo.PPOConfig(rollout_steps=8, hidden=1100,
                                fused_block=256))
    _, step, trainer = torch_ppo.init_training(
        "transport", 256, 0,
        torch_ppo.PPOConfig(rollout_steps=8, hidden=256, fused_block=256))
    before = ppo_update_cuda.LAUNCHES
    trainer, metrics = step(trainer)
    assert trainer.fused and ppo_update_cuda.LAUNCHES == before + 16
    assert np.isfinite(float(metrics["loss"]))


ROAD_MAP3 = dict(map_type="3", n_agents=10)


@pytest.mark.parametrize("kwargs,poses,lanes", [
    ({}, "reset", None), ({}, "jitter", None), ({}, "last", None),
    ({}, "random", None), (ROAD_MAP3, "reset", None),
    (ROAD_MAP3, "ends", None), (ROAD_MAP3, "random", None),
    ({}, "jitter", 4), ({}, "jitter", 8), ({}, "jitter", 16),
    ({}, "jitter", 32)])
def test_road_geometry_kernels_match_plain(cuda, kwargs, poses, lanes):
    """The agent-geometry and pair kernels against geometry_plain
    (torch_helpers.geometry_diff; on path vertices, at reset or just before
    the paths' ends, no index moves and no flag flips), with and without
    collisions, and two launches bit-identical; poses uniform over the map
    with random path ids (``random``); the agent kernel at each lane group
    (``lanes``); the neighbour kernel at the same poses (nd bit-equal)."""
    env = vmt_torch.make_env("road_traffic", num_envs=B, device="cuda",
                             seed=0, **kwargs)
    sc, s = env.scenario, env.world.state
    pos, rot, path_id = s.pos, s.rot[..., 0], sc.path_id
    if poses == "random":
        pos, rot, path_id = random_map_poses(sc._tables, B, sc.n_agents,
                                             seed=3)
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
    with road_geometry_cuda.agent_variant(sc._tables, lanes=lanes):
        got = road_geometry_cuda.fused_geometry(sc._tables, True, pos, rot,
                                                path_id)
        again = road_geometry_cuda.fused_geometry(sc._tables, True, pos, rot,
                                                  path_id)
        bare = road_geometry_cuda.fused_geometry(sc._tables, False, pos, rot,
                                                 path_id)
    ref = road_geometry.geometry_plain(sc._tables, True, pos, rot, path_id)
    torch.cuda.synchronize()
    assert road_geometry_cuda.LAUNCHES["agent_geometry"] == (
        before["agent_geometry"] + 3)
    assert road_geometry_cuda.LAUNCHES["pair_collisions"] == (
        before["pair_collisions"] + 2)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert all(torch.equal(a, b) for a, b in zip(got, bare))
    assert torch.equal(got[9], got[9].transpose(1, 2))
    report = geometry_diff(sc._tables, pos, rot, path_id, got, ref)
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


@pytest.mark.parametrize("poses", ["random", "chunk margins", "near itself"])
def test_agent_geometry_variants_are_bit_identical(cuda, poses):
    """Every lane group, culling and not, tables through L1 and staged in
    shared memory: the agent kernel's outputs equal the default launch's
    to the bit, and the default against geometry_plain by geometry_diff
    (no moved index or flipped flag where culling is tight)."""
    env = vmt_torch.make_env("road_traffic", num_envs=B, device="cuda",
                             seed=0)
    tables = env.scenario._tables
    A = tables.A
    pos, rot, pid = {
        "random": lambda: random_map_poses(tables, B, A, seed=4),
        "chunk margins": lambda: poses_at_chunk_margins(
            tables, road_geometry_cuda.AGENT_LANES, 64, A, seed=4),
        "near itself": lambda: poses_near_self(tables, 64, A, seed=4),
    }[poses]()
    got = road_geometry_cuda.launch_agent_geometry(tables, True, pos, rot,
                                                   pid)
    ref = road_geometry.geometry_plain(tables, True, pos, rot, pid)
    report = geometry_diff(tables, pos, rot, pid,
                           got[:5] + ref[5:6] + got[5:] + ref[9:], ref)
    assert report["bad"] == 0, report
    if poses != "random":
        assert report["moved"] == report["flipped"] == 0, report
    for lanes in road_geometry_cuda.LANE_GROUPS:
        for cull in (True, False):
            for staged in (False, True):
                with road_geometry_cuda.agent_variant(
                        tables, lanes=lanes, cull=cull, staged=staged):
                    other = road_geometry_cuda.launch_agent_geometry(
                        tables, True, pos, rot, pid)
                torch.cuda.synchronize()
                assert all(torch.equal(a, b) for a, b in zip(got, other)), (
                    lanes, cull, staged)


@pytest.mark.parametrize("A,k", [(6, 1), (6, 2), (20, 1), (20, 2), (33, 1),
                                 (33, 2), (64, 1), (64, 2)])
def test_neighbor_kernel_matches_plain_random(cuda, A, k):
    """A warp per env at A = 6 to 64 (two agents a lane past 32), from
    random inputs and from the same with every other env's dn on a coarse
    grid (rounds meet ties): nd bit-equal to the plain version, the rest
    within 1e-5 + 1e-5|ref|; a second launch gives the same bits."""
    pos, rot, vel, dn = random_neighbor_inputs(B, A, seed=5)
    tied = dn.copy()
    tied[::2] = np.round(tied[::2] * 2) / 2
    for d in (tied, dn):
        args = [torch.as_tensor(x, device="cuda")
                for x in (pos, rot, vel, d)]
        before = road_geometry_cuda.LAUNCHES["neighbor_obs"]
        got = road_geometry_cuda.fused_neighbor_obs(A, k, 0.08, 0.04, *args)
        again = road_geometry_cuda.fused_neighbor_obs(A, k, 0.08, 0.04,
                                                      *args)
        ref = road_geometry.neighbor_obs_plain(A, k, 0.08, 0.04, *args)
        torch.cuda.synchronize()
        assert road_geometry_cuda.LAUNCHES["neighbor_obs"] == before + 2
        report = neighbor_diff(got, ref)
        assert report["nd_equal"] and report["bad"] == 0, report
        assert all(torch.equal(a, b) for a, b in zip(got, again))
    if (A, k) != (20, 2):
        return
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


@pytest.mark.parametrize("kwargs,agent_geometry", [
    ({}, 1), (ROAD_MAP3, 2), (dict(map_type="2"), 1)])
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


@pytest.mark.parametrize("scenario,kwargs,launches", [
    ("navigation", {}, {"physics_step": 1, "raycast": 1}),
    ("football", dict(n_blue_agents=5, n_red_agents=5),
     {"physics_step": 1, "football_policy": 1}),
    ("road_traffic", dict(map_type="2"),
     {"physics_step": 1, "agent_geometry": 1, "pair_collisions": 1,
      "neighbor_obs": 1})])
def test_functional_api_on_the_card(cuda, scenario, kwargs, launches):
    """``torch_helpers.functional_checks`` on the card over 3 steps
    (``step_fn`` equal to ``env.step`` to the bit, input states unchanged,
    two branches equal), then one ``step_fn`` with no host sync and the
    path's launches."""
    from vectorizedmultiagentsimulator_tpu_torch import ops

    env = vmt_torch.make_env(scenario, num_envs=B, device="cuda", seed=0,
                             **kwargs)
    g = torch.Generator(device="cuda").manual_seed(1)
    actions = [env.get_random_actions(g) for _ in range(3)]
    functional_checks(env, actions)
    state = env.state
    torch.cuda.synchronize()
    before = ops.launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        env.step_fn(state, actions[0])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    after = ops.launch_counts()
    assert {k: after[k] - before[k] for k in launches} == launches
