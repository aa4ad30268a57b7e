#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of the repository

Phases, one line each:
  1. the card (nvidia-smi name and power limit), the torch/CUDA versions,
     and the build of the kernels, csrc/physics_step.cu, csrc/raycast.cu,
     csrc/football_policy.cu, csrc/road_geometry.cu (three kernels) and
     csrc/ppo_update.cu (the last once per network shape of PPO_BUILDS; one
     nvcc each, all started together), with ptxas' registers and spills
     and the PPO kernel's shared memory;
  2. each kernel against its plain PyTorch version from identical inputs
     on the card.  Physics, one step: the `spheres`, `clamps`,
     `boxes_lines`, `hollow_box` and `gravity_friction` worlds of
     tests/physics_configs.py at 4096 envs, and every main path below at
     30k envs from its reset state, from random inputs and after 10 steps.
     Joints: the `joints` world and torch_helpers.JOINTS_STATIC_ROTATION
     (static fixed rotations) at 4096 envs, posed as the goldens are (held
     at 1e-4 + 1e-4|ref|) and from random inputs; asym_joint,
     ball_trajectory and joint_passage_size at 4096 envs and the two joint
     main paths from their reset states and from those jittered by up to
     3e-2 in position and rotation, which stretches every constraint (both
     held at 1e-4 + 1e-4|ref|), from random inputs and after 10 steps,
     where a stiff world that exceeds that is held env by env to 4 x the
     env's max |plain32 - plain64| (from the inputs and 8 copies nudged by
     an ulp) + 1e-4 + 1e-4|ref|, all but 1/1000 of the envs, and every
     output to 4 x max |plain32 - plain64| + 1e-4 (torch_helpers.
     physics_diff; the numbers printed); two launches bit-identical on
     each joint world.
     Ray cast: every agent's LIDAR of each main path after those 10 steps,
     the tests/golden/raycast.npz scene tiled to 30k envs with random poses,
     and axis-aligned rays against unrotated boxes; each line counts the
     rays that hit and the rays where one side hits and the other misses.
     Then each kernel's time beside its plain version's (physics at each
     main path, the ray cast at navigation@30k).  PPO update: one minibatch
     at transport@4096's shapes in Gaussian, flat-categorical and
     multidiscrete mode, with a 1-wide action, with norm_n != mb, with a
     ragged last tile, with hidden sizes of 96 and 128 (smaller tiles), at
     the shapes of every training run of phases 3 to 5 from random data,
     and on the packed rollout of a real rollout of each training path of
     phase 3 (transport@4096 over 64 steps, navigation@4096 over 16); max
     |kernel - plain| of every gradient and sum, two launches bit-identical,
     then the time of a launch (CUDA events and the profiler's device
     time), its bound and the plain version's time.  Football's planner:
     random inputs at 30k envs for 1, 3 and 5 teammates, with and without
     value noise, and the real inputs of football 5v5@30k after 10 steps;
     for each, max |kernel - plain| over the rows that pick the plain
     version's candidate, the rows that pick another (each must be a near
     tie: its value within 1e-6 of the best), the time of a launch (CUDA
     events and device time), the plain version's time and the bound.
     Road geometry (the agent-geometry, pair and neighbour kernels): road_
     traffic@10k from its reset poses (agents on path vertices: the closest
     index and every flag must equal the plain version's), from jittered
     poses, on vertices just before the paths' ends (the short-term path
     wraps around a loop; exact too) and after 10 steps, and a map '3'
     world (10 agents) from the same poses, across its entry and exit
     segments and after 10 steps
     (torch_helpers.geometry_diff: continuous outputs within 1e-5 +
     1e-5|ref|, a moved index or flipped flag only at a near tie or
     touch); the neighbour kernel on each of those and on random inputs
     (nd bit-equal); two launches bit-identical; then each kernel's time
     (CUDA events and device time), its plain version's and its bound;
  3. the main paths: make_env(name, num_envs, device="cuda") for
     transport, simple_spread, navigation, flocking, balance, football
     (5v5, the red team's scripted AI), joint_passage and buzz_wire (the
     physics kernel's joint branch) at 30k envs and road_traffic (20
     vehicles, the CPM-Lab map) at 10k, reset, 100 env.step calls under
     torch.cuda.set_sync_debug_mode("error") (any host sync fails the run);
     outputs finite and of the JAX package's shapes; exactly one physics
     launch per step, one ray-cast launch per LIDAR measure (4 a step in
     navigation and flocking, none elsewhere), one planner launch per AI
     team and step (football) and one launch of each road kernel a step
     (road_traffic), each count set to 0 just before the run and read just
     after; road_traffic with map '3' (10 agents), whose done() re-places
     agents every step, likewise (two agent-geometry launches a step).
     Then each CUDA env against the CPU env (plain path) from one state
     over 10 steps at 64 envs, football's two envs fed the same planner
     samples, road_traffic's without observation noise, the joint paths
     at tests/test_scenario_parity.py's tolerance of the scenario.  The
     joint worlds that take the plain path: waterfall at 64 envs and the
     `joints_fixed_rotation` world (rotation inferred per env), no physics
     launch in 10 steps, finite state.  Then training:
     init_training("transport", 4096) at the PPOConfig defaults and 3
     train_step calls under the same sync check: 16 PPO-update launches and
     64 physics launches an iteration, finite loss and reward, parameters
     changed, the spawner's give-ups printed; the same for navigation (ray
     casts in the rollout) with 16-step rollouts;
  4. env-steps/s of each 100-step rollout through the kernels and with
     the kernels forced off (the world on its plain physics, the ray cast
     on cast_rays_plain, the planner on best_positions_plain, the road
     geometry on geometry_plain and neighbor_obs_plain), in turns
     (kernel, plain, plain, kernel), timed with CUDA events; then
     training env-steps/s of simple_spread@4096,
     transport@4096 and transport@16384 with the PPO kernel and with the
     autograd update, in turns, and the rollout and update time of an
     iteration;
  5. a torch.profiler trace of 20 steady steps of each main path,
     kernels on and off: wall ms a step (CUDA events, without the
     profiler), device busy ms a step, idle share, device kernels a step,
     and each kernel's device ms a step; then for each training cell the
     host's enqueue time of a rollout step split into env.step, the masked
     reset and the rest, and one training iteration under the profiler.

The line before the last is a JSON object describing each kernel; the last
line is {"ok": true, "device": {...}}.  Without CUDA, or without the
package beside it, the script fails before printing any result.

    python3 chip_smoke.py --ab PARENT_ROOT [PAIRS]

compares this checkout's package with another checkout's (for example the
parent commit unpacked with `git archive` into a gitignored directory) on
one card: PAIRS (default 10) alternating pairs of processes, each running
two 100-step rollouts of transport and simple_spread at 30k envs and 200
back-to-back physics wrapper calls; it prints each run and a JSON summary.
"""
import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
N_ENVS = 30_000
N_STEPS = 100
# Phase 5's steady window a path: joint_passage's plain path launches
# 13,000 device kernels a step, and the profiler's events cost host time.
PROFILE_STEPS = 20
# Physics kernel vs plain, one step from identical inputs: the two sum
# each entity's fp32 forces in another order, and the card's libm is not
# the CPU's; contact penalties (collision_force 100 over a 1e-3 margin)
# turn a one-ulp force difference into ~1e-6 of velocity.  1e-4 absolute
# plus 1e-4 relative leaves two orders of magnitude over that.
ATOL = 1e-4
RTOL = 1e-4
# Ray cast kernel vs plain: the same operations in the same order (the
# kernel is built with -fmad=false), so only the card's elementwise
# kernels against the kernel's inlined libm calls differ; a hit/miss flip
# would move a ray by up to max_range and is counted separately.
CAST_TOL = 1e-5
# The scenarios the physics kernel already ran before the ray cast was
# ported, compared across commits by --ab.
AB_SCENARIOS = ("transport", "simple_spread")
# (scenario, envs, agents, obs width, ray-cast launches a step, planner
# launches a step, road-kernel launches a step: agent geometry, pair,
# neighbour).  road_traffic runs at 10k envs: the plain version's [B, A, 5,
# 184] fp32 intermediates, several alive at once, are 0.74 GB each there.
MAIN_PATHS = [
    ("transport", N_ENVS, 4, 11, 0, 0, (0, 0, 0)),
    ("simple_spread", N_ENVS, 3, 14, 0, 0, (0, 0, 0)),
    ("navigation", N_ENVS, 4, 18, 4, 0, (0, 0, 0)),
    ("flocking", N_ENVS, 4, 18, 4, 0, (0, 0, 0)),
    ("balance", N_ENVS, 3, 16, 0, 0, (0, 0, 0)),
    ("football", N_ENVS, 5, 88, 0, 1, (0, 0, 0)),
    ("joint_passage", N_ENVS, 2, 10, 0, 0, (0, 0, 0)),
    ("buzz_wire", N_ENVS, 2, 6, 0, 0, (0, 0, 0)),
    ("road_traffic", 10_000, 20, 32, 0, 0, (1, 1, 1)),
]
# The joint worlds (joint_force 900 over 10-15 substeps): an ulp grows
# about 2x a substep, so from inputs far from rest (random, or after 10
# random steps) the kernel is held to torch_helpers.physics_diff's float64
# rule where it exceeds ATOL + RTOL|ref|; from the reset state jittered
# (torch_helpers.jittered_inputs) it is held at ATOL + RTOL|ref|.
STIFF_PATHS = ("joint_passage", "buzz_wire")
# The other joint scenarios of phase 2, at 4096 envs.
JOINT_WORLDS = ("asym_joint", "ball_trajectory", "joint_passage_size")
PATH_ENVS = {path[0]: path[1] for path in MAIN_PATHS}
# road_traffic on map '3' (the intersection, 10 agents): its done()
# re-places the agents that leave through an entry or exit segment every
# step, one more agent-geometry launch a step.
ROAD_MAP3 = dict(map_type="3", n_agents=10)
# A main path's make_env kwargs beyond the defaults: football 5v5, the
# reference's benchmark configuration (BASELINE.md), the red team scripted.
PATH_KWARGS = {"football": dict(n_blue_agents=5, n_red_agents=5)}
# Phase 2's random physics inputs put every entity in [-spread, spread]^2:
# 0.3 by default; football's 23 entities (10 walls and goal lines) at 0.3
# press each sphere against up to ten lines at once, whose opposed contact
# forces cancel to a residue that no fp32 sum order keeps (its pitch is
# 3 x 1.5), so it is held at 1.0 and dense_contacts prints 0.3.
PATH_SPREAD = {"football": 1.0}
# cuda_vs_cpu's extra kwargs: the two envs' generators differ, so
# road_traffic's observation noise is off there.
CPU_COMPARE_KWARGS = {"road_traffic": dict(is_add_noise=False)}
# cuda_vs_cpu's tolerance: (base, growth a step, steps compared, share of
# envs that may diverge), tests/test_scenario_parity.py's _DEFAULT, or its
# _STIFF for buzz_wire (15 substeps at joint_force 900: an ulp of the
# card's sums grows to about 1e-3 in one step).
CPU_COMPARE_TOL = {"buzz_wire": (3e-3, 2.2, 4, 0.5),
                   "joint_passage": (5e-4, 1.6, 10, 0.25)}
# Paths whose step ends on discrete crossing flags (a collision ends the
# episode): an ulp of the card's cos/sin against the CPU's can flip a
# touching crossing, so, as for a scripted AI's near ties, an env may leave
# cuda_vs_cpu's comparison (counted and printed; at most 1/8 of them).
DISCRETE_FLAGS = ("road_traffic",)
# The H100 SXM's published rates (NVIDIA's data sheet): device
# memory and fp32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# Arithmetic per pair class and substep of csrc/physics_step.cu (per joint
# constraint, and the fixed-rotation torque of one that does not rotate), and per
# ray and entity class of csrc/raycast.cu (each sqrt, sin, cos, exp, log
# and division counted as one operation), counted from the sources.
PHYSICS_OPS = {"ss": 29, "bs": 131, "ls": 42, "ll": 133, "bl": 470,
               "bb": 3300, "entity": 25, "joint": 102, "joint_fixed": 17}
CAST_OPS = {"ray": 3, "sphere": 37, "box": 55, "line": 28}
# The same for csrc/football_policy.cu: per candidate and teammate, plus
# the teammate-repulsion term per candidate, teammate and other teammate.
PLANNER_OPS = {"candidate": 91, "pair": 11}
# The same for csrc/road_geometry.cu: one segment distance with its running
# minimum, one strict crossing test, one rectangle (cos, sin, 5 corners),
# one short-term point, and a neighbour round besides its A compares.
ROAD_OPS = {"seg": 26, "cross": 29, "rect": 42, "short": 8, "neighbor": 92}
# bf16 products with fp32 accumulation in the tensor cores (the same sheet).
BF16_FLOP_PER_S = 989e12
# Planner kernel vs plain: a row that picks the plain version's candidate
# outputs that candidate, made by the same two operations (a sum, a clamp)
# on both sides, so it must agree to the bit; 1e-6 leaves an ulp of room.
# A row that picks another candidate moves by up to the pitch's width and
# is allowed only at a near tie (torch_helpers.planner_selection_diff).
PLANNER_ATOL = 1e-6
# PPO-update kernel vs plain, one minibatch from identical inputs.  Both sum
# 262,144 per-sample terms of either sign in fp32, the kernel per tile and
# block in a fixed order, the plain version inside a library matrix product,
# and the card's tanhf/expf are not the library's, which now and then moves
# an activation across a bf16 rounding step (2^-9 relative) before a trunk
# product.  So each gradient is held to a share of its own largest entry,
# and each loss sum to a relative error plus an absolute one that grows
# with the number of O(1) terms summed.
PPO_GRAD_TOL = 2e-3      # x max |plain gradient|, per gradient
PPO_SUM_RTOL = 1e-4
PPO_SUM_ATOL_PER_SAMPLE = 1e-6
# Network shapes (obs_d, act_w, n_logits, hidden) that this run launches
# the PPO kernel with; the source is compiled once for each.
PPO_BUILDS = {
    "transport": (15, 2, 0, 64),
    "transport flat categorical": (15, 1, 9, 64),
    "transport multidiscrete": (15, 2, 3, 64),
    "simple_spread": (17, 2, 0, 64),
    "1-wide action": (15, 1, 0, 64),
    "navigation": (22, 2, 0, 64),
    "transport hidden 96": (15, 2, 0, 96),
    "transport hidden 128": (15, 2, 0, 128),
    "transport multidiscrete hidden 128": (15, 2, 3, 128),
}
# (scenario, envs, rollout steps, iterations, ray casts a step) of the
# training runs of phase 3; a step observes once and once more in its
# masked reset, so it casts each LIDAR twice.
TRAIN_PATHS = [("transport", 4096, 64, 3, 0), ("navigation", 4096, 16, 2, 8)]
TRAIN_CELLS = [("simple_spread", 4096), ("transport", 4096),
               ("transport", 16384)]
# The specs phase 2 held to the plain version; a training run of a later
# phase whose spec is not among them fails.
PPO_COMPARED = set()


def log(msg):
    print(msg, flush=True)


def make_path_env(name, num_envs=None, device="cuda", seed=0, **kwargs):
    """make_env of a main path at its env count (or ``num_envs``), with its
    PATH_KWARGS and ``kwargs``."""
    import vectorizedmultiagentsimulator_tpu_torch as vmt

    return vmt.make_env(name, num_envs=num_envs or PATH_ENVS[name],
                        device=device, seed=seed,
                        **PATH_KWARGS.get(name, {}), **kwargs)


def kernel_name(line):
    """The kernel's name in a ptxas "Compiling entry function" line, read
    from its mangled name's length-prefixed identifiers."""
    mangled = line.split("'")[1]
    i = 0
    while i < len(mangled):
        digits = re.match(r"\d+", mangled[i:])
        if digits is None:
            i += 1
            continue
        start = i + len(digits.group())
        name = mangled[start:start + int(digits.group())]
        if name.endswith("kernel"):
            return name
        i = start + len(name)
    return mangled


def cuda_time_ms(fn, iters):
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(got, ref, atol, rtol):
    """(max abs difference, whether every element is within tolerance)."""
    worst, ok = 0.0, True
    for g, r in zip(got, ref):
        d = (g - r).abs()
        worst = max(worst, float(d.max()) if d.numel() else 0.0)
        ok = ok and bool((d <= atol + rtol * r.abs()).all())
    return worst, ok


def kernel_vs_plain(world, inputs, label, stiff=False):
    """One launch against the plain version at ATOL + RTOL|ref| or, for a
    ``stiff`` joint world that exceeds that, torch_helpers.physics_diff's
    float64 rule.  Returns (max |kernel - plain|, whether the float64 rule
    decided)."""
    import torch
    from torch_helpers import physics_diff
    from vectorizedmultiagentsimulator_tpu_torch.ops import physics_cuda

    assert world._use_kernel, f"{label}: world does not step through the kernel"
    with torch.no_grad():
        got = physics_cuda.fused_step(world, *inputs)
    torch.cuda.synchronize()
    report = physics_diff(world, inputs, got, stiff=stiff)
    pairs = " ".join(f"{c}={len(p)}" for c, p in world._pairs.items() if len(p))
    joints = len(world._ordered_constraints)
    extra = ""
    if "bound" in report:
        extra = (f" ({report['bad']} elements over {ATOL} + {RTOL}|ref|;"
                 f" float64 rule: max|plain32-plain64| ="
                 f" {report['plain_f64_err']:.3e}, bound {report['bound']:.3e};"
                 f" envs beyond 4 x their own |plain32-plain64|:"
                 f" {report['bad_envs']} of {world.batch_dim} (at most"
                 f" {report['allowed_envs']}), largest excess/sensitivity"
                 f" {report['env_ratio']:.3g})")
    log(f"[2] physics {label}: B={world.batch_dim} N={world._n_entities}"
        f" {pairs}{f' joints={joints}' if joints else ''} max|kernel-plain|"
        f" pos/vel/rot/ang_vel = {report['max_abs_err']:.3e}{extra}")
    if not report["ok"]:
        raise AssertionError(f"{label}: kernel disagrees with plain: {report}")
    return report["max_abs_err"], "bound" in report


def bit_identical(world, inputs, label):
    """Two launches from the same inputs give the same bits."""
    import torch
    from vectorizedmultiagentsimulator_tpu_torch.ops import physics_cuda

    with torch.no_grad():
        a = physics_cuda.fused_step(world, *inputs)
        b = physics_cuda.fused_step(world, *inputs)
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError(f"{label}: two launches differ")
    log(f"[2] physics {label}: two launches bit-identical")


def dense_contacts(name, spread=0.3):
    """Printed, not held: the physics of ``name`` at 30k envs from random
    inputs at ``spread``, the kernel against the plain version on the card,
    and the plain version on the card against the same on the CPU (the
    same function summed in another order)."""
    import torch
    from torch_helpers import random_step_inputs
    from vectorizedmultiagentsimulator_tpu_torch.ops import physics_cuda

    w_g = make_path_env(name, N_ENVS).world
    w_c = make_path_env(name, N_ENVS, device="cpu").world
    inputs = random_step_inputs(w_g, spread, seed=3)
    with torch.no_grad():
        got = physics_cuda.fused_step(w_g, *inputs)
        ref = physics_cuda.step_plain(w_g, *inputs)
        cpu = physics_cuda.step_plain(w_c, *[x.cpu() for x in inputs])
    torch.cuda.synchronize()
    cpu = [x.cuda() for x in cpu]
    for label, a, b in (("kernel vs plain", got, ref),
                        ("plain vs plain on the CPU", ref, cpu)):
        worst = max(float((x - y).abs().max()) for x, y in zip(a, b))
        over = sum(int(((x - y).abs() > ATOL + RTOL * y.abs()).sum())
                   for x, y in zip(a, b))
        log(f"[2] physics {name}@{N_ENVS} random at spread {spread} (not"
            f" held): {label} max|diff| {worst:.3e}, {over} elements over"
            f" {ATOL} + {RTOL}|ref|")


def state_inputs(world):
    """The physics-step inputs of ``world``'s current state."""
    from vectorizedmultiagentsimulator_tpu_torch.ops import physics_cuda

    s = world.state
    return (s.pos, s.vel, s.rot, s.ang_vel, s.force, s.torque,
            physics_cuda.stacked_dyn_gravity(world, s.extras))


def cast_vs_plain(pos, rot, angles, origin, table, max_range, label):
    import torch
    from vectorizedmultiagentsimulator_tpu_torch.ops import raycast_cuda

    with torch.no_grad():
        got = raycast_cuda.fused_cast_rays(pos, rot, angles, origin, table,
                                           max_range)
        ref = raycast_cuda.cast_rays_plain(pos, rot, angles, origin, table,
                                           max_range)
    torch.cuda.synchronize()
    err, ok = max_err([got], [ref], CAST_TOL, CAST_TOL)
    cap = torch.tensor(max_range, dtype=torch.float32, device=got.device)
    flips = int(((got == cap) != (ref == cap)).sum())
    hits = int((ref < cap).sum())
    log(f"[2] ray cast {label}: B={pos.shape[0]} R={got.shape[1]}"
        f" spheres={len(table.sphere_idx)} boxes={len(table.box_idx)}"
        f" lines={len(table.line_idx)} hits={hits}"
        f" max|kernel-plain| = {err:.3e}, hit/miss disagreements {flips}")
    if not ok or flips:
        raise AssertionError(
            f"{label}: ray-cast kernel disagrees with plain beyond"
            f" {CAST_TOL} + {CAST_TOL}|ref| or on a hit ({flips} flips)"
        )
    return err


def physics_bound_ms(world, inputs):
    """The least time of one physics step on the H100: the bytes of its
    inputs and outputs over the memory rate, or its arithmetic over the
    fp32 rate, whichever is larger; returns (ms, "bytes" | "operations")."""
    moved = sum(x.numel() * x.element_size() for x in inputs)
    moved += sum(x.numel() * x.element_size() for x in inputs[:4])  # outputs
    moved += sum(x.numel() * x.element_size()
                 for x in world._kernel_tables.tensors)
    per_env = sum(PHYSICS_OPS[c] * len(p) for c, p in world._pairs.items())
    per_env += PHYSICS_OPS["entity"] * world._n_entities
    per_env += PHYSICS_OPS["joint"] * len(world._ordered_constraints)
    per_env += PHYSICS_OPS["joint_fixed"] * int((~world._joint_rotate).sum())
    ops = world.batch_dim * world._substeps * per_env
    return bound(moved, ops)


def cast_bound_ms(pos, angles, table, heading):
    """The same for one ray cast: the origin's and each cast entity's
    pose, the angles and the distances written."""
    B, R = pos.shape[0], angles.shape[-1]
    ns, nb, nl = (len(table.sphere_idx), len(table.box_idx),
                  len(table.line_idx))
    moved = B * (8 + 4 * heading + 8 * ns + 12 * (nb + nl))
    moved += angles.numel() * 4 + B * R * 4
    moved += sum(x.numel() * x.element_size() for x in table.tensors)
    ops = B * R * (CAST_OPS["ray"] + CAST_OPS["sphere"] * ns
                   + CAST_OPS["box"] * nb + CAST_OPS["line"] * nl)
    return bound(moved, ops)


def bound(moved, ops):
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main_path(name, envs, agents, obs_dim, casts_per_step, plans_per_step,
              road_per_step, label=None, **kwargs):
    """N_STEPS steps of make_env(name, envs, **kwargs) on the card with no
    host sync; returns the physics, ray-cast and planner launches and the
    road kernels' launches counted in that run."""
    import torch
    from vectorizedmultiagentsimulator_tpu_torch.ops import (
        football_policy_cuda,
        physics_cuda,
        raycast_cuda,
        road_geometry_cuda,
    )

    label = label or f"{name}@{envs}"
    env = make_path_env(name, envs, **kwargs)
    env.reset()
    assert env.world._use_kernel, f"{name} does not step through the kernel"
    g = torch.Generator(device="cuda").manual_seed(1)
    sizes = [env.get_agent_action_size(a) for a in env.agents]
    give_ups_before = env.world.spawn_give_ups.clone()
    torch.cuda.synchronize()
    physics_cuda.LAUNCHES = 0
    raycast_cuda.LAUNCHES = 0
    football_policy_cuda.LAUNCHES = 0
    road_geometry_cuda.LAUNCHES.update(
        dict.fromkeys(road_geometry_cuda.KERNELS, 0))
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(N_STEPS):
            actions = [
                torch.rand((envs, s), generator=g, device="cuda") * 2 - 1
                for s in sizes
            ]
            obs, rews, dones, _ = env.step(actions)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    steps, casts = physics_cuda.LAUNCHES, raycast_cuda.LAUNCHES
    plans = football_policy_cuda.LAUNCHES
    road = tuple(road_geometry_cuda.LAUNCHES[k]
                 for k in road_geometry_cuda.KERNELS)
    torch.cuda.synchronize()
    assert len(obs) == agents and len(rews) == agents
    for o, r in zip(obs, rews):
        assert tuple(o.shape) == (envs, obs_dim), o.shape
        assert tuple(r.shape) == (envs,), r.shape
        assert bool(torch.isfinite(o).all()) and bool(torch.isfinite(r).all())
    assert tuple(dones.shape) == (envs,) and dones.dtype == torch.bool
    s = env.world.state
    for f in ("pos", "vel", "rot", "ang_vel"):
        assert bool(torch.isfinite(getattr(s, f)).all()), f
    expected = (N_STEPS, N_STEPS * casts_per_step, N_STEPS * plans_per_step,
                tuple(N_STEPS * r for r in road_per_step))
    if (steps, casts, plans, road) != expected:
        raise AssertionError(
            f"{label}: {steps} physics, {casts} ray-cast, {plans} planner and"
            f" {road} road-kernel launches in {N_STEPS} steps (expected"
            f" {expected})"
        )
    log(f"[3] {label}: {N_STEPS} steps, no host sync, obs"
        f" {agents}x[{envs}, {obs_dim}] finite, physics launches {steps},"
        f" ray-cast launches {casts}, planner launches {plans}, road"
        f" launches (agent geometry, pair, neighbour) {road}; dones in the"
        f" last step {int(dones.sum())}, placement give-ups"
        f" {int(env.world.spawn_give_ups - give_ups_before)}")
    return steps, casts, plans, road


def cuda_vs_cpu(name, n_envs=64, n_steps=10):
    """The whole step on the card (kernels) against the CPU env (plain
    path) from one injected state, at the parity tests' tolerance
    (5e-4 growing x1.6 a step, plus 2e-3 relative).  A scripted AI's two
    envs draw the same planner samples.  Its choices (the nearest agent to
    the ball, the best of three candidates) are discrete, so an env whose
    state differs by an ulp can take another branch where two options tie;
    as in the golden tests, such an env leaves the comparison (it is
    counted and printed), and at most 1/8 of the envs may."""
    import torch
    from vectorizedmultiagentsimulator_tpu_torch.utils import (
        state_from_numpy,
        state_to_numpy,
    )

    kwargs = CPU_COMPARE_KWARGS.get(name, {})
    env_g = make_path_env(name, n_envs, **kwargs)
    env_c = make_path_env(name, n_envs, device="cpu", **kwargs)
    state_from_numpy(env_c, state_to_numpy(env_g))
    scripted = getattr(env_c.scenario, "red_controller", None) is not None
    if scripted:
        policy = env_c.scenario.red_controller
        z = torch.randn((n_steps, n_envs, len(policy.teammates),
                         policy.nsamples, 2),
                        generator=torch.Generator().manual_seed(3))
        for env in (env_g, env_c):
            feed = iter(z.to(env.device))
            env.scenario.red_controller.planner_normals = (
                lambda B, T, feed=feed: next(feed))
    g = torch.Generator().manual_seed(2)
    worst = 0.0
    diverged = torch.zeros((n_envs,), dtype=torch.bool)
    base, growth, compared, share = CPU_COMPARE_TOL.get(
        name, (5e-4, 1.6, n_steps, 0.0))
    for t in range(n_steps):
        acts = [
            torch.rand((n_envs, env_c.get_agent_action_size(a)), generator=g)
            * 2 - 1
            for a in env_c.agents
        ]
        out_g = env_g.step([a.cuda() for a in acts])
        out_c = env_c.step(acts)
        for x in out_g[0] + out_g[1] + out_c[0] + out_c[1]:
            assert bool(torch.isfinite(x).all()), f"{name}: not finite"
        if t >= compared:
            continue
        atol = base * growth**t
        for xg, xc in zip(out_g[0] + out_g[1], out_c[0] + out_c[1]):
            d = (xg.cpu() - xc).abs()
            bad = d > atol + 2e-3 * xc.abs()
            diverged |= bad.reshape(n_envs, -1).any(dim=1)
            if bool((~diverged).any()):
                worst = max(worst, float(d[~diverged].max()))
        diverged |= out_g[2].cpu() != out_c[2]
        allowed = n_envs // 8 if scripted or name in DISCRETE_FLAGS else 0
        allowed = max(allowed, int(share * n_envs))
        if int(diverged.sum()) > allowed:
            raise AssertionError(
                f"{name}: cuda and cpu differ at step {t} in"
                f" {int(diverged.sum())} of {n_envs} envs")
    log(f"[3] {name}@{n_envs}: cuda (kernels) vs cpu (plain) over {n_steps}"
        f" steps (compared over {min(compared, n_steps)}), max |diff| obs/rew"
        f" = {worst:.3e}"
        f" ({int(diverged.sum())} of {n_envs} envs left the comparison)")


def plain_route_joints(n_envs=64, n_steps=10):
    """The joint worlds that step through the plain version: waterfall
    (over the size guard, rotations inferred per env) and the
    joints_fixed_rotation world (rotation inferred per env): no physics
    launch in ``n_steps`` steps, finite state."""
    import torch
    from physics_configs import CONFIGS
    from torch_helpers import build_world
    from vectorizedmultiagentsimulator_tpu_torch.ops import physics_cuda

    env = make_path_env("waterfall", n_envs)
    world, ents = build_world(CONFIGS["joints_fixed_rotation"], n_envs,
                              device="cuda")
    g = torch.Generator(device="cuda").manual_seed(9)
    for e in ents.values():  # the joint observer writes the rotation
        e.set_pos(torch.rand((n_envs, 2), generator=g, device="cuda") * 0.5)
    assert any(k.startswith("joint_fixed_rotation") for k in world.state.extras)
    for label, w in (("waterfall", env.world),
                     ("joints_fixed_rotation", world)):
        assert not w._use_kernel, f"{label} takes the kernel"
    physics_cuda.LAUNCHES = 0
    for _ in range(n_steps):
        obs, rews, dones, _ = env.step(env.get_random_actions())
        world.step()
    torch.cuda.synchronize()
    if physics_cuda.LAUNCHES:
        raise AssertionError(
            f"plain-route joint worlds launched the kernel"
            f" {physics_cuda.LAUNCHES} times")
    for x in list(obs) + list(rews) + [env.world.state.pos, world.state.pos]:
        assert bool(torch.isfinite(x).all())
    log(f"[3] plain route: waterfall@{n_envs} ({len(env.world._pairs['bb'])}"
        f" box-box pairs, {len(env.world._ordered_constraints)} joint"
        f" constraints) and joints_fixed_rotation@{n_envs}: {n_steps} steps,"
        f" physics launches {physics_cuda.LAUNCHES}, outputs finite")


@contextlib.contextmanager
def kernels(env, on):
    """Run ``env`` through the step's kernels, or with them forced off: the
    world on its plain physics, every ray cast on ``cast_rays_plain``, the
    planner on ``best_positions_plain`` and the road geometry on
    ``geometry_plain`` and ``neighbor_obs_plain``."""
    from vectorizedmultiagentsimulator_tpu_torch.ops import (
        football_policy_cuda,
        raycast_cuda,
        road_geometry,
        road_geometry_cuda,
    )

    fused = raycast_cuda.fused_cast_rays
    planner = football_policy_cuda.fused_best_positions
    geometry = road_geometry_cuda.fused_geometry
    neighbors = road_geometry_cuda.fused_neighbor_obs
    env.world._use_kernel = on
    if not on:
        raycast_cuda.fused_cast_rays = raycast_cuda.cast_rays_plain
        football_policy_cuda.fused_best_positions = (
            football_policy_cuda.best_positions_plain)
        road_geometry_cuda.fused_geometry = road_geometry.geometry_plain
        road_geometry_cuda.fused_neighbor_obs = (
            road_geometry.neighbor_obs_plain)
    try:
        yield
    finally:
        raycast_cuda.fused_cast_rays = fused
        football_policy_cuda.fused_best_positions = planner
        road_geometry_cuda.fused_geometry = geometry
        road_geometry_cuda.fused_neighbor_obs = neighbors
        env.world._use_kernel = True


def random_actions(env, n, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    return [
        [torch.rand((env.num_envs, env.get_agent_action_size(a)), generator=g,
                    device="cuda") * 2 - 1 for a in env.agents]
        for _ in range(n)
    ]


def timed_rollout(env, actions):
    """env-steps/s of ``actions`` stepped after 10 warm-up steps."""
    import torch

    for a in actions[:10]:
        env.step(a)
    torch.cuda.synchronize()
    ms = cuda_time_ms(lambda it=iter(actions): env.step(next(it)), len(actions))
    return env.num_envs / (ms / 1e3)


def rollout_rate(env, actions, on):
    with kernels(env, on):
        return timed_rollout(env, actions)


def profile_steps(env, actions, on):
    """(wall ms a step without the profiler, device busy ms a step, idle
    share, device kernels a step, {kernel: device ms a step})."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    n = len(actions)
    with kernels(env, on):
        for a in actions[:10]:
            env.step(a)
        torch.cuda.synchronize()
        wall = cuda_time_ms(lambda it=iter(actions): env.step(next(it)), n)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for a in actions:
                env.step(a)
            torch.cuda.synchronize()
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in device) / 1e3 / n
    named = {}
    for key, tag in (("physics_step_kernel", "physics"),
                     ("cast_rays_kernel", "raycast"),
                     ("best_positions_kernel", "planner"),
                     ("agent_geometry_kernel", "agent_geometry"),
                     ("pair_collisions_kernel", "pair_collisions"),
                     ("neighbor_obs_kernel", "neighbor_obs")):
        named[tag] = sum(e.time_range.elapsed_us() for e in device
                         if key in e.name) / 1e3 / n
    return wall, busy, 1.0 - busy / wall, len(device) / n, named


def rate_worker(root):
    """``--rate ROOT``: for each scenario of AB_SCENARIOS, two N_STEPS-step
    rollouts' env-steps/s and the physics wrapper's time per call (200
    back-to-back calls from the reset state, CUDA events) of the port
    package found at ROOT; one JSON line."""
    sys.path.insert(0, os.path.abspath(root))
    import torch
    import vectorizedmultiagentsimulator_tpu_torch as vmt
    from vectorizedmultiagentsimulator_tpu_torch.ops import physics_cuda

    assert vmt.__file__.startswith(os.path.abspath(root)), vmt.__file__
    out = {}
    for name in AB_SCENARIOS:
        env = vmt.make_env(name, num_envs=N_ENVS, device="cuda", seed=0)
        actions = random_actions(env, N_STEPS, seed=7)
        rates = [timed_rollout(env, actions) for _ in range(2)]
        w = env.world
        inputs = state_inputs(w)
        with torch.no_grad():
            for _ in range(10):
                physics_cuda.fused_step(w, *inputs)
            call_ms = cuda_time_ms(
                lambda: physics_cuda.fused_step(w, *inputs), 200)
        out[name] = {"rates": rates, "call_ms": call_ms}
        del env, actions, w, inputs
    print(json.dumps(out), flush=True)


def ab(parent_root, pairs):
    """``--ab PARENT_ROOT [PAIRS]``: the rollout rates and wrapper times of
    this checkout's package against the one at PARENT_ROOT, one process
    each, in ``pairs`` alternating pairs (parent, change, change, parent,
    ...) on this card."""
    import statistics

    runs = {"parent": [], "change": []}
    for k in range(pairs):
        for who in (("parent", "change") if k % 2 == 0 else ("change", "parent")):
            root = parent_root if who == "parent" else ROOT
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--rate", root],
                capture_output=True, text=True, timeout=300, check=True,
            )
            got = json.loads(proc.stdout.strip().splitlines()[-1])
            runs[who].append(got)
            log(f"[ab] pair {k} {who}: " + ", ".join(
                f"{n} env-steps/s {r['rates'][0]:.6g} {r['rates'][1]:.6g},"
                f" wrapper {r['call_ms']:.4f} ms/call" for n, r in got.items()))
    summary = {}
    for name in AB_SCENARIOS:
        row = {}
        for who, got in runs.items():
            rates = [statistics.mean(g[name]["rates"]) for g in got]
            calls = [g[name]["call_ms"] for g in got]
            row[who] = {"rate_median": statistics.median(rates),
                        "rate_min": min(rates), "rate_max": max(rates),
                        "call_ms_median": statistics.median(calls),
                        "call_ms_min": min(calls), "call_ms_max": max(calls)}
        row["pairs_change_faster"] = sum(
            statistics.mean(c[name]["rates"]) > statistics.mean(p[name]["rates"])
            for c, p in zip(runs["change"], runs["parent"]))
        row["pairs_change_call_faster"] = sum(
            c[name]["call_ms"] < p[name]["call_ms"]
            for c, p in zip(runs["change"], runs["parent"]))
        summary[name] = row
    print(json.dumps({"ab_pairs": pairs, "summary": summary}), flush=True)


def ppo_spec(shape, lb=4096, mb=262144, norm_n=0):
    """The PPOUpdateSpec of a PPO_BUILDS shape at the PPOConfig defaults."""
    from vectorizedmultiagentsimulator_tpu_torch.ops import ppo_update_cuda

    od, aw, nl, hidden = shape
    return ppo_update_cuda.PPOUpdateSpec(
        obs_d=od, act_w=aw, hidden=hidden, lb=lb, mb=mb, clip_eps=0.2,
        vf_coef=0.5, ent_coef=0.01, n_logits=nl, norm_n=norm_n)


def train_spec(name, num_envs, rollout_steps=64):
    """The spec of init_training(name, num_envs) at the PPOConfig defaults
    with ``rollout_steps``-step rollouts: 4 minibatches an epoch."""
    n_agents = {path[0]: path[2] for path in MAIN_PATHS}[name]
    return ppo_spec(PPO_BUILDS[name],
                    mb=rollout_steps * n_agents * num_envs // 4)


def ppo_vs_plain(spec, inputs, label):
    """One minibatch through the kernel, twice, and through the plain
    version; returns the largest |kernel - plain| over the gradients."""
    import torch
    from vectorizedmultiagentsimulator_tpu_torch.ops import ppo_update_cuda

    PPO_COMPARED.add(spec)
    got_g, got_s = ppo_update_cuda.minibatch_update(spec, *inputs)
    rep_g, rep_s = ppo_update_cuda.minibatch_update(spec, *inputs)
    ref_g, ref_s = ppo_update_cuda.minibatch_update_plain(spec, *inputs)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got_g + got_s, rep_g + rep_s))
    names = ("W1", "b1", "W2", "b2", "Wm", "bm", "log_std", "Wv", "bv", "Wv2",
             "bv2")
    worst_abs, worst_share, bad = 0.0, 0.0, []
    for name, g, r in zip(names, got_g, ref_g):
        assert bool(torch.isfinite(g).all()), f"{label}: d{name} not finite"
        d = float((g - r).abs().max())
        scale = float(r.abs().max())
        worst_abs = max(worst_abs, d)
        if scale > 0:
            worst_share = max(worst_share, d / scale)
        if d > PPO_GRAD_TOL * scale + 1e-12:
            bad.append(f"d{name} {d:.3e} of {scale:.3e}")
    sum_errs = []
    for name, g, r in zip(("pg", "vf", "ent"), got_s, ref_s):
        d, r = abs(float(g) - float(r)), abs(float(r))
        sum_errs.append(d)
        if d > PPO_SUM_RTOL * r + PPO_SUM_ATOL_PER_SAMPLE * spec.mb:
            bad.append(f"{name}_sum {d:.3e} of {r:.3e}")
    log(f"[2] ppo update {label}: D={spec.d} n={inputs[0].shape[1]}"
        f" mb={spec.mb} lb={spec.lb} norm={spec.norm}"
        f" max|kernel-plain| gradients {worst_abs:.3e}"
        f" ({worst_share:.3e} of the gradient's largest entry), sums pg/vf/ent"
        f" {sum_errs[0]:.3e} {sum_errs[1]:.3e} {sum_errs[2]:.3e};"
        f" repeat launch bit-identical: {same}")
    if bad or not same:
        raise AssertionError(
            f"{label}: PPO kernel disagrees with plain ({'; '.join(bad)})"
            f" or a repeat launch differs (identical: {same})"
        )
    return worst_abs


def ppo_random_case(spec, nb_tot, seed):
    import torch
    from torch_helpers import random_ppo_inputs

    packed, perm, stats, params = random_ppo_inputs(spec, nb_tot, seed)
    to = lambda x: torch.as_tensor(x, device="cuda")
    return to(packed), to(perm), to(stats), tuple(to(p) for p in params)


def ppo_bound_ms(spec, inputs):
    """The least time of one minibatch update on the H100.  Bytes: the
    minibatch's columns of the packed rollout, the block indices, the
    statistics and the parameters read once, the gradients and sums written
    once.  Operations: the trunk's products (bf16 operands, fp32 sums: W1,
    Wv, W2 forward, and dW1, dWv, dW2, dh1 backward) at the tensor cores'
    bf16 rate, and the fp32 heads (Wm, Wv2 and their three backward
    products) and the elementwise work (3H tanh and their derivatives, the
    loss head) at the fp32 rate; returns (ms, by, ms if every product ran at
    the fp32 rate, as this kernel's do)."""
    od, H, hw = spec.obs_d, spec.hidden, spec.mask_w
    n_params = sum(p.numel() for p in inputs[3])
    moved = 4 * (spec.d * spec.mb + spec.mb // spec.lb + 2 + 2 * n_params + 3)
    trunk = 2 * (4 * od * H + 3 * H * H) * spec.mb
    rest = (2 * (3 * H * hw + 2 * H) + 15 * H + 30 * hw) * spec.mb
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = (trunk / BF16_FLOP_PER_S + rest / FP32_FLOP_PER_S) * 1e3
    t_fp32 = (trunk + rest) / FP32_FLOP_PER_S * 1e3
    ms, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return ms, by, t_fp32


def device_ms(fn, iters, key):
    """Device time of one call's kernels whose name holds ``key``, from a
    torch.profiler trace of ``iters`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and key in e.name) / 1e3 / iters


def train_path(name, num_envs, rollout_steps, iters, casts_per_step):
    """``iters`` training iterations of init_training(name, num_envs) on the
    card with no host sync; returns the (PPO, physics, ray-cast) launches
    counted in that run."""
    import torch
    from vectorizedmultiagentsimulator_tpu_torch.examples import torch_ppo
    from vectorizedmultiagentsimulator_tpu_torch.ops import (
        physics_cuda,
        ppo_update_cuda,
        raycast_cuda,
    )

    cfg = torch_ppo.PPOConfig(rollout_steps=rollout_steps)
    env, train_step, trainer = torch_ppo.init_training(name, num_envs, seed=0,
                                                       cfg=cfg)
    assert trainer.fused and env.world._use_kernel, f"{name}: not on the kernels"
    assert trainer.spec == train_spec(name, num_envs, rollout_steps), trainer.spec
    assert trainer.spec in PPO_COMPARED, f"{trainer.spec} was not compared"
    before = [p.detach().clone() for p in trainer.model.ordered_parameters()]
    give_ups_before = env.world.spawn_give_ups.clone()
    metrics = []
    torch.cuda.synchronize()
    ppo_update_cuda.LAUNCHES = physics_cuda.LAUNCHES = raycast_cuda.LAUNCHES = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(iters):
            trainer, m = train_step(trainer)
            metrics.append(m)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    counts = (ppo_update_cuda.LAUNCHES, physics_cuda.LAUNCHES,
              raycast_cuda.LAUNCHES)
    torch.cuda.synchronize()
    expected = (iters * cfg.epochs * cfg.minibatches, iters * rollout_steps,
                iters * rollout_steps * casts_per_step)
    if counts != expected:
        raise AssertionError(
            f"{name}: (PPO, physics, ray-cast) launches {counts} in {iters}"
            f" iterations, expected {expected}"
        )
    losses = [float(m["loss"]) for m in metrics]
    rewards = [float(m["mean_reward"]) for m in metrics]
    assert all(math.isfinite(x) for x in losses + rewards), (losses, rewards)
    moved = max(float((p.detach() - b).abs().max())
                for p, b in zip(trainer.model.ordered_parameters(), before))
    assert moved > 0 and all(
        bool(torch.isfinite(p).all()) for p in trainer.model.parameters())
    give_ups = int(env.world.spawn_give_ups - give_ups_before)
    log(f"[3] train {name}@{num_envs}: {iters} iterations of {rollout_steps}"
        f" steps x {cfg.epochs} epochs x {cfg.minibatches} minibatches of"
        f" {trainer.spec.mb} samples (lb {trainer.spec.lb}), no host sync;"
        f" PPO launches {counts[0]}, physics launches {counts[1]}, ray-cast"
        f" launches {counts[2]}; loss {' '.join(f'{x:+.5f}' for x in losses)};"
        f" mean reward {' '.join(f'{x:+.5f}' for x in rewards)}; max"
        f" |parameter change| {moved:.3e}; spawner give-ups {give_ups}")
    return counts


def train_rates(name, num_envs, iters=2):
    """Training env-steps/s of one cell with the PPO kernel and with the
    autograd update, in turns (kernel, autograd, autograd, kernel), each
    turn ``iters`` iterations after one warm-up; the rollout (with GAE and
    packing) and the update are timed apart on the host clock, each ended
    by a synchronize."""
    import torch
    from vectorizedmultiagentsimulator_tpu_torch.examples import torch_ppo

    trainers = {}
    for fused in (True, False):
        cfg = torch_ppo.PPOConfig(fused_update=fused)
        trainers[fused] = torch_ppo.init_training(name, num_envs, seed=0,
                                                  cfg=cfg)[2]
        assert trainers[fused].fused == fused
        assert trainers[fused].spec in PPO_COMPARED, trainers[fused].spec
        trainers[fused].train_step()
    torch.cuda.synchronize()
    rows = {True: [], False: []}
    for fused in (True, False, False, True):
        tr, roll_s, upd_s = trainers[fused], 0.0, 0.0
        for _ in range(iters):
            t0 = time.perf_counter()
            packed, _ = tr.collect()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            loss = tr.update(packed)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            roll_s += t1 - t0
            upd_s += t2 - t1
        assert math.isfinite(float(loss))
        steps = iters * tr.cfg.rollout_steps * num_envs
        rows[fused].append((steps / (roll_s + upd_s), roll_s / iters * 1e3,
                            upd_s / iters * 1e3))
    for fused, tag in ((True, "PPO kernel"), (False, "autograd update")):
        log(f"[4] train {name}@{num_envs} {tag}: env-steps/s "
            + " ".join(f"{r[0]:.6g}" for r in rows[fused])
            + "; rollout ms/iteration "
            + " ".join(f"{r[1]:.2f}" for r in rows[fused])
            + "; update ms/iteration "
            + " ".join(f"{r[2]:.2f}" for r in rows[fused]))
    del trainers


def profile_training(name, num_envs):
    """Where one training iteration's time goes: the host's enqueue time of
    one rollout split into env.step, the masked reset and the rest (policy,
    sampling, padding, GAE, packing), timed without a synchronize; then the
    wall of an iteration (host clock, ended by a synchronize) and a
    torch.profiler trace of one iteration for the device's side."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from vectorizedmultiagentsimulator_tpu_torch.examples import torch_ppo

    env, _, trainer = torch_ppo.init_training(name, num_envs, seed=0)
    assert trainer.fused and trainer.spec in PPO_COMPARED, trainer.spec
    trainer.train_step()
    torch.cuda.synchronize()
    spent = {"step": 0.0, "reset_at": 0.0}

    def timed(key, fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            spent[key] += time.perf_counter() - t0
            return out
        return call

    env.step, env.reset_at = timed("step", env.step), timed("reset_at", env.reset_at)
    t0 = time.perf_counter()
    packed, _ = trainer.collect()
    enqueue = time.perf_counter() - t0
    del env.step, env.reset_at  # back to the class's methods
    trainer.update(packed)
    torch.cuda.synchronize()
    T = trainer.cfg.rollout_steps
    log(f"[5] train {name}@{num_envs} rollout, host enqueue ms a step:"
        f" env.step {spent['step'] / T * 1e3:.3f}, masked reset"
        f" {spent['reset_at'] / T * 1e3:.3f}, policy/sampling/padding/GAE/"
        f"packing {(enqueue - sum(spent.values())) / T * 1e3:.3f},"
        f" all {enqueue / T * 1e3:.3f}")
    t0 = time.perf_counter()
    trainer.train_step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.train_step()
        torch.cuda.synchronize()
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in device) / 1e3
    named = {
        tag: sum(e.time_range.elapsed_us() for e in device if key in e.name) / 1e3
        for key, tag in (("ppo_", "ppo"), ("physics_step_kernel", "physics"),
                         ("cast_rays_kernel", "raycast"))
    }
    log(f"[5] train {name}@{num_envs} one iteration: wall {wall:.2f} ms"
        f" (without the profiler), device busy {busy:.2f} ms, idle share"
        f" {1.0 - busy / wall:.4f}, {len(device)} device kernels, PPO kernels"
        f" {named['ppo']:.3f} ms, physics kernel {named['physics']:.3f} ms,"
        f" ray-cast kernel {named['raycast']:.3f} ms")


def ppo_phase_2(errs):
    """Phase 2 for the PPO kernel; returns (ms, plain_ms, bound_ms, by)."""
    import torch
    from vectorizedmultiagentsimulator_tpu_torch.examples import torch_ppo
    from vectorizedmultiagentsimulator_tpu_torch.ops import ppo_update_cuda

    transport = ppo_spec(PPO_BUILDS["transport"])
    cases = [
        ("transport@4096 Gaussian", transport, 256),
        ("transport@4096 flat categorical",
         ppo_spec(PPO_BUILDS["transport flat categorical"]), 256),
        ("transport@4096 multidiscrete",
         ppo_spec(PPO_BUILDS["transport multidiscrete"]), 256),
        ("1-wide action", ppo_spec(PPO_BUILDS["1-wide action"]), 256),
        ("norm_n = 4 mb", ppo_spec(PPO_BUILDS["transport"],
                                   norm_n=4 * 262144), 256),
        ("ragged last tile", ppo_spec(PPO_BUILDS["transport"], lb=8,
                                      mb=1000), 300),
    ]
    # A wider trunk is compiled with a smaller tile.
    for key in ("transport hidden 96", "transport hidden 128",
                "transport multidiscrete hidden 128"):
        spec = ppo_spec(PPO_BUILDS[key])
        cases.append((f"{key} (tile {ppo_update_cuda.tile_size(spec)})", spec,
                      256))
    # Every training run of the later phases, at its own shapes.
    runs = [(name, num_envs, steps) for name, num_envs, steps, *_ in TRAIN_PATHS]
    runs += [(name, num_envs, 64) for name, num_envs in TRAIN_CELLS]
    for name, num_envs, steps in runs:
        spec = train_spec(name, num_envs, steps)
        if all(spec != case[1] for case in cases):
            cases.append((f"{name}@{num_envs}, {steps} steps", spec,
                          4 * spec.mb // spec.lb))
    timed = None
    for seed, (label, spec, nb_tot) in enumerate(cases):
        inputs = ppo_random_case(spec, nb_tot, 20 + seed)
        errs.append(ppo_vs_plain(spec, inputs, label))
        if timed is None:
            timed = inputs
        if spec.hidden > 64:
            wide_ms = cuda_time_ms(
                lambda: ppo_update_cuda.minibatch_update(spec, *inputs), 5)
            log(f"[2] ppo update {label}: kernel {wide_ms:.4f} ms a launch of"
                f" {spec.mb} samples, {ppo_bound_ms(spec, inputs)[2]:.5f} ms at"
                f" the fp32 rate")
        del inputs
    # The packed rollout of a real rollout of each training path of phase 3,
    # with its own parameters and statistics.
    for name, num_envs, steps, *_ in TRAIN_PATHS:
        spec = train_spec(name, num_envs, steps)
        env, _, trainer = torch_ppo.init_training(
            name, num_envs, seed=0,
            cfg=torch_ppo.PPOConfig(rollout_steps=steps))
        assert trainer.spec == spec, trainer.spec
        packed, _ = trainer.collect()
        nb_tot, nbm = trainer.n // spec.lb, spec.mb // spec.lb
        perm = torch.randperm(
            nb_tot, device="cuda",
            generator=torch.Generator(device="cuda").manual_seed(9),
        )[:nbm].to(torch.int32)
        adv = packed[spec.obs_d + spec.act_w + 1].reshape(
            nb_tot, spec.lb)[perm.long()]
        stats = torch.stack([adv.mean(),
                             1.0 / (adv.std(unbiased=False) + 1e-8)])
        errs.append(ppo_vs_plain(
            spec, (packed, perm, stats, trainer.model.kernel_params()),
            f"{name}@{num_envs}, a real {steps}-step rollout"))
        del env, trainer, packed

    call = lambda: ppo_update_cuda.minibatch_update(transport, *timed)
    plain = lambda: ppo_update_cuda.minibatch_update_plain(transport, *timed)
    for _ in range(3):
        call()
        plain()
    ms = cuda_time_ms(call, 20)
    dev_ms = device_ms(call, 5, "ppo_")
    plain_ms = cuda_time_ms(plain, 5)
    bound_ms, by, fp32_ms = ppo_bound_ms(transport, timed)
    log(f"[2] ppo update at transport@4096 (one minibatch of {transport.mb}"
        f" samples): kernel {ms:.4f} ms a launch (CUDA events), {dev_ms:.4f}"
        f" ms device time (update and reduce kernels), plain {plain_ms:.4f}"
        f" ms, bound {bound_ms:.5f} ms ({by}; trunk products at the bf16"
        f" tensor-core rate, the rest at the fp32 rate), {fp32_ms:.5f} ms if"
        f" every product ran at the fp32 rate as this kernel's do")
    return ms, plain_ms, bound_ms, by


def planner_bound_ms(p, B):
    """The least time of one planner call on the H100: each operand read
    once and the best positions written once over the memory rate, or its
    arithmetic (PLANNER_OPS) over the fp32 rate; returns (ms, "bytes" |
    "operations")."""
    T, S = p.T, p.S
    floats = 2 * T + 2 * T + 2 * T * S + 6 + 2 * T
    if p.has_noise:
        floats += T * (S + 1)
    ops = B * T * (S + 1) * (PLANNER_OPS["candidate"] + PLANNER_OPS["pair"] * T)
    return bound(4 * B * floats, ops)


def planner_vs_plain(p, inputs, label):
    """The planner kernel against its plain version on ``inputs`` (CUDA
    tensors), then its time; returns (max |kernel - plain| over all rows,
    kernel ms, plain ms, bound ms, bound by)."""
    import torch
    from torch_helpers import planner_selection_diff
    from vectorizedmultiagentsimulator_tpu_torch.ops import (
        football_policy_cuda as fpc,
    )

    with torch.no_grad():
        got = fpc.fused_best_positions(p, *inputs)
        again = fpc.fused_best_positions(p, *inputs)
        ref = fpc.best_positions_plain(p, *inputs)
        torch.cuda.synchronize()
        same_err, flips, not_ties, gap = planner_selection_diff(
            fpc, p, inputs, got)
        err = float((got - ref).abs().max())
        ms = cuda_time_ms(lambda: fpc.fused_best_positions(p, *inputs), 200)
        dev_ms = device_ms(lambda: fpc.fused_best_positions(p, *inputs), 20,
                           "best_positions_kernel")
        plain_ms = cuda_time_ms(lambda: fpc.best_positions_plain(p, *inputs),
                                50)
    bound_ms, by = planner_bound_ms(p, inputs[0].shape[0])
    log(f"[2] planner {label}: B={inputs[0].shape[0]} T={p.T} S={p.S}"
        f" noise={p.has_noise} max|kernel-plain| {err:.3e} (rows with the"
        f" plain version's pick {same_err:.3e}), rows with another pick"
        f" {flips} (largest value gap {gap:.3e}, {not_ties} not near ties),"
        f" repeat launch bit-identical: {torch.equal(got, again)}; kernel"
        f" {ms:.5f} ms a call (CUDA events), {dev_ms:.5f} ms device, plain"
        f" {plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({by})")
    if same_err > PLANNER_ATOL or not_ties or not torch.equal(got, again):
        raise AssertionError(
            f"{label}: planner kernel disagrees with plain beyond"
            f" {PLANNER_ATOL}, or picks another candidate away from a near"
            f" tie ({not_ties} rows), or repeats differently")
    return err, ms, plain_ms, bound_ms, by


def planner_phase_2(errs, real_inputs):
    """Phase 2 for the planner kernel: random inputs at N_ENVS for 1, 3 and
    5 teammates with and without value noise, then ``real_inputs`` (the
    football path's after 10 steps); returns the latter's (ms, plain_ms,
    bound_ms, by)."""
    import torch
    from torch_helpers import planner_fields, random_planner_inputs
    from vectorizedmultiagentsimulator_tpu_torch.ops import (
        football_policy_cuda as fpc,
    )

    for T in (1, 3, 5):
        for noise in (False, True):
            p = fpc.PlannerParams(**planner_fields(T, has_noise=noise))
            inputs = [
                None if x is None else torch.as_tensor(x, device="cuda")
                for x in random_planner_inputs(N_ENVS, T, 2, noise, seed=T)
            ]
            errs.append(planner_vs_plain(p, inputs, "random inputs")[0])
    err, ms, plain_ms, bound_ms, by = planner_vs_plain(
        real_inputs[0], real_inputs[1:],
        f"football 5v5@{N_ENVS} after 10 steps")
    errs.append(err)
    return ms, plain_ms, bound_ms, by


def road_inputs(env):
    """The road kernels' operands of ``env``'s current state: ``(tables,
    pos, rot, path_id)`` and the neighbour kernel's ``(A, k, half_l, half_w,
    pos, rot, vel, dn)``, as the scenario passes them."""
    sc, s = env.scenario, env.world.state
    rot = s.rot[..., 0]
    geometry = (sc._tables, s.pos, rot, sc.path_id)
    neighbors = (sc.n_agents, sc.n_nearing_agents_observed,
                 (sc.l_f + sc.l_r) / 2.0, sc.agent_width / 2.0, s.pos, rot,
                 s.vel, sc.distances_agents / sc.normalizer_distance_lanelet)
    return geometry, neighbors


def geometry_vs_plain(tables, pos, rot, path_id, label, exact=False):
    """The agent-geometry and pair kernels (with collisions, twice, and
    without) against geometry_plain on the card; with ``exact`` (poses on
    path vertices) no index may move and no flag flip.  Returns the largest
    |kernel - plain| of each kernel's outputs."""
    import torch
    from torch_helpers import geometry_diff
    from vectorizedmultiagentsimulator_tpu_torch.ops import road_geometry as rg
    from vectorizedmultiagentsimulator_tpu_torch.ops import (
        road_geometry_cuda as rgc,
    )

    with torch.no_grad():
        got = rgc.launch_geometry(tables, True, pos, rot, path_id)
        again = rgc.launch_geometry(tables, True, pos, rot, path_id)
        bare = rgc.launch_geometry(tables, False, pos, rot, path_id)
        ref = rg.geometry_plain(tables, True, pos, rot, path_id)
        torch.cuda.synchronize()
        report = geometry_diff(tables, pos, rot, path_id, got, ref)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        same = same and all(torch.equal(a, b) for a, b in zip(got, bare))

        def err(idx):
            return max(float((got[i] - ref[i]).abs().max()) for i in idx)

        agent_err, pair_err = err((0, 1, 2, 3, 4, 6, 7, 8)), err((5, 9))
        flags = [int(ref[i].sum()) for i in (6, 7, 8, 9)]
    log(f"[2] road geometry {label}: B={pos.shape[0]} A={pos.shape[1]}"
        f" crossings in the plain version (lanelets, entry, exit, agent"
        f" pairs) {flags}; max|kernel-plain| agent geometry {agent_err:.3e},"
        f" pair {pair_err:.3e}; closest index moved in {report['moved']}"
        f" rows, flags flipped {report['flipped']}, of those not near a tie"
        f" or touch (with out-of-tolerance elements) {report['bad']}; repeat"
        f" and collision-free launches bit-identical: {same}")
    exact_ok = not exact or (report["moved"] == 0 and report["flipped"] == 0
                             and torch.equal(got[0], ref[0])
                             and torch.equal(got[4], ref[4]))
    if report["bad"] or not same or not exact_ok:
        raise AssertionError(
            f"{label}: road geometry kernels disagree with plain ({report},"
            f" repeat identical {same}, exact {exact_ok})")
    return agent_err, pair_err


def neighbors_vs_plain(args, label):
    """The neighbour kernel (twice) against neighbor_obs_plain on the card:
    nd bit-equal, the rest within 1e-5 + 1e-5|ref|; returns the largest
    |kernel - plain|."""
    import torch
    from torch_helpers import neighbor_diff
    from vectorizedmultiagentsimulator_tpu_torch.ops import road_geometry as rg
    from vectorizedmultiagentsimulator_tpu_torch.ops import (
        road_geometry_cuda as rgc,
    )

    with torch.no_grad():
        got = rgc.fused_neighbor_obs(*args)
        again = rgc.fused_neighbor_obs(*args)
        ref = rg.neighbor_obs_plain(*args)
        torch.cuda.synchronize()
        report = neighbor_diff(got, ref)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
    log(f"[2] neighbour obs {label}: B={args[4].shape[0]} A={args[0]}"
        f" k={args[1]} nd bit-equal {report['nd_equal']}, max|kernel-plain|"
        f" {report['max_abs_err']:.3e}, out of tolerance {report['bad']};"
        f" repeat launch bit-identical: {same}")
    if not report["nd_equal"] or report["bad"] or not same:
        raise AssertionError(f"{label}: neighbour kernel disagrees with plain"
                             f" ({report}, repeat identical {same})")
    return report["max_abs_err"]


def road_bounds_ms(tables, pos, rot, path_id, neighbor_args):
    """The least time of each road kernel's call on the H100 for these
    inputs, (ms, "bytes" | "operations") each: every operand read once and
    every output written once, the path tables once; the operations
    (ROAD_OPS) this data needs.  Agent geometry: every real centre-line
    segment, then those up to the first within 1e-5 of the least distance,
    5 points against every real segment of each boundary and, with
    collisions, 4 edges against each of them where no edge crosses (one
    test where one does, which only lowers the bound), 8 entry/exit tests
    on paths that are not loops.  Pair: each agent's rectangle and, per
    other agent, its rectangle and 16 tests (1 where they cross).
    Neighbour: k rounds of A compares and a neighbour's work."""
    import torch
    from vectorizedmultiagentsimulator_tpu_torch.ops import road_geometry as rg

    O = ROAD_OPS
    B, A = pos.shape[:2]
    with torch.no_grad():
        pid = path_id.long()
        n = tables.n_points[pid].long()
        seg_c = torch.clamp_min(n - 1, 1)
        _, first_plus_1 = rg.get_perpendicular_distances(
            pos, tables.center[pid], tables.n_points[pid])
        seg_b = (torch.clamp_min(tables.n_left[pid].long() - 1, 1)
                 + torch.clamp_min(tables.n_right[pid].long() - 1, 1))
        ref = rg.geometry_plain(tables, True, pos, rot, path_id)
        lane = ref[6] > 0.5
        ops = ((seg_c + first_plus_1) * O["seg"] + seg_b * 5 * O["seg"]
               + torch.where(lane, 1, seg_b * 4) * O["cross"] + O["rect"]
               + tables.K * O["short"])
        if tables.entry_exit:
            ops = ops + (~tables.is_loop[pid]).long() * 8 * O["cross"]
        table_bytes = sum(x.numel() * x.element_size()
                          for x in tables.kernel_tensors)
        agent = bound(B * A * (16 + 4 * (1 + 5 + 5 + 1 + 2 * tables.K + 3))
                      + table_bytes, float(ops.sum()))
        hits = int(ref[9].sum())
        pair_ops = (B * A * A * O["rect"]
                    + O["cross"] * (16 * (B * A * (A - 1) - hits) + hits))
        pair = bound(B * A * (12 + 4 * (10 + A)), pair_ops)
    k = neighbor_args[1]
    neighbor = bound(B * A * (20 + 4 * A) + B * A * k * 14 * 4,
                     B * A * (3 + k * (A + O["neighbor"])))
    return {"agent_geometry": agent, "pair_collisions": pair,
            "neighbor_obs": neighbor}


def road_phase_2(errs):
    """Phase 2 for the road kernels: the cases of the docstring; returns
    {kernel: (ms, plain_ms, bound_ms, bound_by)} at road_traffic@10k after
    10 steps, the main path's inputs."""
    import numpy as np
    import torch
    from torch_helpers import (
        poses_at_path_ends,
        poses_near_path_ends,
        random_neighbor_inputs,
    )
    from vectorizedmultiagentsimulator_tpu_torch.ops import road_geometry as rg
    from vectorizedmultiagentsimulator_tpu_torch.ops import (
        road_geometry_cuda as rgc,
    )

    envs = PATH_ENVS["road_traffic"]
    for kwargs, tag in ((dict(), ""), (ROAD_MAP3, " map '3' (10 agents)")):
        env = make_path_env("road_traffic", envs, **kwargs)
        label = f"road_traffic@{envs}{tag}"
        (tables, pos, rot, pid), nargs = road_inputs(env)
        errs["geometry"].append(geometry_vs_plain(
            tables, pos, rot, pid, f"{label} reset poses", exact=True))
        errs["neighbor_obs"].append(neighbors_vs_plain(
            nargs, f"{label} reset poses"))
        g = torch.Generator(device="cuda").manual_seed(4)
        jpos = (pos + (torch.rand(pos.shape, generator=g, device="cuda")
                       - 0.5) * 0.2).contiguous()
        jrot = (rot + (torch.rand(rot.shape, generator=g, device="cuda")
                       - 0.5)).contiguous()
        errs["geometry"].append(geometry_vs_plain(
            tables, jpos, jrot, pid, f"{label} jittered poses"))
        lpos, lrot = poses_near_path_ends(tables, pid, seed=6)
        errs["geometry"].append(geometry_vs_plain(
            tables, lpos, lrot, pid,
            f"{label} on vertices before the paths' ends", exact=True))
        if tables.entry_exit:
            epos, erot = poses_at_path_ends(tables, pid, seed=5)
            errs["geometry"].append(geometry_vs_plain(
                tables, epos, erot, pid,
                f"{label} across entry and exit segments"))
        for a in random_actions(env, 10, seed=5):
            env.step(a)
        (tables, pos, rot, pid), nargs = road_inputs(env)
        errs["geometry"].append(geometry_vs_plain(
            tables, pos, rot, pid, f"{label} after 10 steps"))
        errs["neighbor_obs"].append(neighbors_vs_plain(
            nargs, f"{label} after 10 steps"))
        if not tag:
            main_inputs = (tables, pos, rot, pid, nargs)
        del env
    inputs = [torch.as_tensor(x, device="cuda")
              for x in random_neighbor_inputs(envs, 20, seed=6)]
    errs["neighbor_obs"].append(neighbors_vs_plain(
        (20, 2, 0.08, 0.04, *inputs), f"random inputs at {envs}"))

    tables, pos, rot, pid, nargs = main_inputs
    calls = {
        "agent_geometry": (
            lambda: rgc.launch_agent_geometry(tables, True, pos, rot, pid),
            lambda: rg.agent_geometry_plain(tables, True, pos, rot, pid)),
        "pair_collisions": (
            lambda: rgc.launch_pair_collisions(tables, pos, rot),
            lambda: rg.pair_collisions_plain(tables, pos, rot)),
        "neighbor_obs": (lambda: rgc.fused_neighbor_obs(*nargs),
                         lambda: rg.neighbor_obs_plain(*nargs)),
    }
    bounds = road_bounds_ms(tables, pos, rot, pid, nargs)
    times = {}
    with torch.no_grad():
        for name, (call, plain) in calls.items():
            for _ in range(3):
                call()
                plain()
            ms = cuda_time_ms(call, 50)
            dev_ms = device_ms(call, 10, f"{name}_kernel")
            plain_ms = cuda_time_ms(plain, 10)
            bound_ms, by = bounds[name]
            times[name] = (ms, plain_ms, bound_ms, by)
            log(f"[2] {name} kernel at road_traffic@{envs} after 10 steps:"
                f" {ms:.5f} ms a call (CUDA events), {dev_ms:.5f} ms device,"
                f" plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({by})")
    return times


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA GPU; none is available")
    if sys.argv[1:2] == ["--rate"]:
        return rate_worker(sys.argv[2])
    if sys.argv[1:2] == ["--ab"]:
        return ab(sys.argv[2], int(sys.argv[3]) if len(sys.argv) > 3 else 10)
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import numpy as np
    from vectorizedmultiagentsimulator_tpu_torch.ops import (
        football_policy_cuda,
        physics_cuda,
        ppo_update_cuda,
        raycast_cuda,
        road_geometry_cuda,
    )
    from physics_configs import CONFIGS
    from torch_helpers import (
        JOINTS_STATIC_ROTATION,
        build_world,
        jittered_inputs,
        posed_step_inputs,
        random_step_inputs,
    )

    # Plain versions multiply in full fp32.
    torch.backends.cuda.matmul.allow_tf32 = False

    t_run = time.perf_counter()

    def phase_time(k):
        log(f"[time] phases 1-{k} took {time.perf_counter() - t_run:.1f} s")

    # ---- 1: card, versions, build ---- #
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"[1] torch {torch.__version__} CUDA {torch.version.cuda}"
        f" device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    ppo_specs = {k: ppo_spec(v) for k, v in PPO_BUILDS.items()}
    builds = [physics_cuda.build, raycast_cuda.build,
              football_policy_cuda.build, road_geometry_cuda.build] + [
        (lambda sp=sp: ppo_update_cuda.build(sp)) for sp in ppo_specs.values()
    ]
    with ThreadPoolExecutor(len(builds)) as pool:
        libs = list(pool.map(lambda build: build(), builds))
    physics_cuda._library()
    raycast_cuda._library()
    football_policy_cuda._library()
    for symbol in ("vmt_road_agent_geometry", "vmt_road_pair_collisions",
                   "vmt_road_neighbor_obs"):
        road_geometry_cuda._library(symbol)
    log(f"[1] built {len(libs)} libraries ("
        f"{', '.join(sorted({os.path.basename(p) for p in libs}))}) in"
        f" {time.perf_counter() - t0:.2f} s")
    tags = ["physics_step", "raycast", "football_policy", "road_geometry"] + [
        f"ppo_update {k} {PPO_BUILDS[k]}" for k in ppo_specs]
    for tag, lib in zip(tags, libs):
        with open(os.path.join(os.path.dirname(lib), "build.log")) as f:
            for line in f:
                if "Compiling entry function" in line:
                    log(f"[1] ptxas {tag}: entry {kernel_name(line)}")
                if "registers" in line or "spill" in line:
                    log(f"[1] ptxas {tag}: {line.strip()}")
    for k, sp in ppo_specs.items():
        tile = ppo_update_cuda.tile_size(sp)
        log(f"[1] ppo_update {k}: tiles of {tile} samples,"
            f" {ppo_update_cuda.smem_bytes(sp, tile)} bytes of dynamic shared"
            f" memory a block, {ppo_update_cuda.flat_size(sp)} gradient"
            f" entries and sums")

    phase_time(1)

    # ---- 2: kernels vs plain on the card ---- #
    errs, stiff_errs, cast_errs, planner_errs, times = [], [], [], [], {}

    def held(result):
        """File a comparison's error under the rule that held it."""
        err, by_f64 = result
        (stiff_errs if by_f64 else errs).append(err)

    for cfg in ("spheres", "clamps", "boxes_lines", "hollow_box",
                "gravity_friction"):
        w, _ = build_world(CONFIGS[cfg], 4096, device="cuda")
        held(kernel_vs_plain(
            w, random_step_inputs(w, spread=CONFIGS[cfg]["spread"], seed=4), cfg
        ))
    # The joint branch: the two joint worlds that take the kernel, posed as
    # the goldens are (held at ATOL + RTOL|ref|) and from random inputs;
    # then the other joint scenarios at 4096 envs.
    for label, spec in (("joints", CONFIGS["joints"]),
                        ("joints_static_rotation", JOINTS_STATIC_ROTATION)):
        w, ents = build_world(spec, 4096, device="cuda")
        p_inputs = posed_step_inputs(w, ents, spec, seed=4)
        held(kernel_vs_plain(w, p_inputs, f"{label} posed"))
        held(kernel_vs_plain(
            w, random_step_inputs(w, spec["spread"], seed=4,
                                  rot_spread=spec.get("rot_spread", math.pi)),
            f"{label} random", stiff=True))
        bit_identical(w, p_inputs, label)
    for name in JOINT_WORLDS:
        env = make_path_env(name, 4096)
        w = env.world
        label = f"{name}@4096"
        held(kernel_vs_plain(w, state_inputs(w), f"{label} reset"))
        held(kernel_vs_plain(w, jittered_inputs(state_inputs(w), seed=9),
                             f"{label} reset jittered"))
        r_inputs = random_step_inputs(w, spread=0.5, seed=3)
        held(kernel_vs_plain(w, r_inputs, f"{label} random", stiff=True))
        for a in random_actions(env, 10, seed=5):
            env.step(a)
        held(kernel_vs_plain(w, state_inputs(w), f"{label} 10 steps",
                             stiff=True))
        bit_identical(w, r_inputs, label)
        del env, w, r_inputs
    for name, *_ in MAIN_PATHS:
        # Each main path at its own shapes: from its reset state, from
        # random inputs, and after 10 steps (so that LIDAR rays hit), where
        # every agent's LIDAR is cast too.
        env = make_path_env(name)
        w = env.world
        label = f"{name}@{env.num_envs}"
        stiff = name in STIFF_PATHS
        held(kernel_vs_plain(w, state_inputs(w), f"{label} reset"))
        if stiff:
            # At rest every joint force is 0: stretch each constraint.
            held(kernel_vs_plain(w, jittered_inputs(state_inputs(w), seed=9),
                                 f"{label} reset jittered"))
        r_inputs = random_step_inputs(w, spread=PATH_SPREAD.get(name, 0.3),
                                      seed=3)
        held(kernel_vs_plain(w, r_inputs, f"{label} random", stiff=stiff))
        if stiff:
            bit_identical(w, r_inputs, label)
        # The planner's operands in the last of the 10 steps.
        planner = football_policy_cuda.fused_best_positions
        captured = []

        def capture(*args):
            captured[:] = args
            return planner(*args)

        football_policy_cuda.fused_best_positions = capture
        try:
            for a in random_actions(env, 10, seed=5):
                env.step(a)
        finally:
            football_policy_cuda.fused_best_positions = planner
        if name == "football":
            planner_real = list(captured)
            dense_contacts(name)
        held(kernel_vs_plain(w, state_inputs(w), f"{label} 10 steps",
                             stiff=stiff))
        s = w.state
        for agent in env.agents:
            for lidar in agent.sensors:
                table = w._cast_tables[(agent.index, lidar.entity_filter)]
                cast_args = (s.pos, s.rot, lidar._angles, agent.index, table,
                             lidar._max_range)
                cast_errs.append(cast_vs_plain(
                    *cast_args, f"{label} 10 steps, {agent.name}'s LIDAR"
                ))
        with torch.no_grad():
            kernel_ms = cuda_time_ms(
                lambda: physics_cuda.fused_step(w, *r_inputs), 50)
            plain_ms = cuda_time_ms(
                lambda: physics_cuda.step_plain(w, *r_inputs), 50)
            times[name] = (kernel_ms, plain_ms, physics_bound_ms(w, r_inputs))
            log(f"[2] physics step at {label}: kernel {kernel_ms:.4f} ms,"
                f" plain {plain_ms:.4f} ms, bound {times[name][2][0]:.5f} ms"
                f" ({times[name][2][1]})")
            if name == "navigation":
                # One LIDAR of the path, as the main path casts it.
                cast_ms = cuda_time_ms(
                    lambda: raycast_cuda.fused_cast_rays(*cast_args), 200)
                cast_plain_ms = cuda_time_ms(
                    lambda: raycast_cuda.cast_rays_plain(*cast_args), 200)
                cast_bound, cast_by = cast_bound_ms(s.pos, lidar._angles,
                                                    table, True)
                log(f"[2] ray cast at {label} (one LIDAR, 12 rays,"
                    f" {len(table.sphere_idx)} spheres): kernel"
                    f" {cast_ms:.4f} ms, plain {cast_plain_ms:.4f} ms, bound"
                    f" {cast_bound:.5f} ms ({cast_by})")
        del env, w, s, r_inputs
    # The physics row of the kernels line: transport@30k, as in the earlier
    # slices, and joint_passage@30k, the path of the joint branch, under
    # "joint_path" (every path's time is printed above).
    kernel_ms, plain_ms, (phys_bound, phys_by) = times["transport"]

    golden = np.load(os.path.join(ROOT, "tests", "golden", "raycast.npz"))
    gw, _ = build_world(dict(
        agents=[dict(name="a", shape=("sphere", 0.03))],
        landmarks=[dict(name="b0", shape=("box", 0.4, 0.2, False)),
                   dict(name="b1", shape=("box", 0.3, 0.3, False)),
                   dict(name="s0", shape=("sphere", 0.15)),
                   dict(name="s1", shape=("sphere", 0.25)),
                   dict(name="li0", shape=("line", 0.6)),
                   dict(name="li1", shape=("line", 0.9))],
    ), N_ENVS, device="cuda")
    reps = -(-N_ENVS // golden["angles"].shape[0])

    def tiled(key):
        x = torch.as_tensor(golden[key], device="cuda")
        return x.repeat((reps,) + (1,) * (x.ndim - 1))[:N_ENVS]

    g = torch.Generator(device="cuda").manual_seed(6)
    names = [e.name for e in gw.entities]
    pos = torch.stack([tiled(f"{n}_0") for n in names], dim=1)
    rot = torch.stack([tiled(f"{n}_1") for n in names], dim=1)
    pos = pos + (torch.rand(pos.shape, generator=g, device="cuda") - 0.5) * 0.2
    rot = rot + (torch.rand(rot.shape, generator=g, device="cuda") - 0.5)
    origin = names.index("a")
    gtable = raycast_cuda.cast_table(
        gw, [names.index("s0"), names.index("s1")],
        [names.index("b0"), names.index("b1")],
        [names.index("li0"), names.index("li1")],
    )
    cast_errs.append(cast_vs_plain(
        pos, rot, tiled("angles").contiguous(), origin, gtable, 1.5,
        f"golden scene tiled to {N_ENVS}",
    ))
    # Axis-aligned rays against unrotated boxes; half of the origins lie on
    # the line of b0's +-width side, so the ray along +x grazes it.
    rot[:, :2] = 0.0
    pos[:, 0] = torch.tensor([0.1, 0.0], device="cuda")
    pos[:, origin] = torch.tensor([[-0.5, 0.1], [-0.5, -0.1]],
                                  device="cuda").repeat(N_ENVS // 2, 1)
    axis = torch.tensor([0.0, math.pi / 2, math.pi, -math.pi / 2] * 3,
                        device="cuda")
    rot[:, origin] = 0.0
    cast_errs.append(cast_vs_plain(
        pos, rot, axis, origin, gtable, 1.5, "axis-aligned rays, unrotated boxes"
    ))
    del gw, pos, rot
    plan_ms, plan_plain_ms, plan_bound, plan_by = planner_phase_2(
        planner_errs, planner_real)
    del planner_real
    road_errs = {"geometry": [], "neighbor_obs": []}
    road_times = road_phase_2(road_errs)
    ppo_errs = []
    ppo_ms, ppo_plain_ms, ppo_bound, ppo_by = ppo_phase_2(ppo_errs)

    phase_time(2)

    # ---- 3: the main paths ---- #
    launches = {"physics_step": 0, "raycast": 0, "football_policy": 0,
                "ppo_update": 0}
    launches.update(dict.fromkeys(road_geometry_cuda.KERNELS, 0))
    road_map3 = ("road_traffic", PATH_ENVS["road_traffic"], 10, 32, 0, 0,
                 (2, 1, 1))
    for path, kwargs in [(p, {}) for p in MAIN_PATHS] + [(road_map3,
                                                          ROAD_MAP3)]:
        label = (f"road_traffic@{path[1]} map '3' (10 agents)" if kwargs
                 else None)
        steps, cast_count, plan_count, road = main_path(*path, label=label,
                                                        **kwargs)
        launches["physics_step"] += steps
        launches["raycast"] += cast_count
        launches["football_policy"] += plan_count
        for kernel, count in zip(road_geometry_cuda.KERNELS, road):
            launches[kernel] += count
    plain_route_joints()
    for name, *_ in MAIN_PATHS:
        cuda_vs_cpu(name)
    for path in TRAIN_PATHS:
        updates, steps, cast_count = train_path(*path)
        launches["ppo_update"] += updates
        launches["physics_step"] += steps
        launches["raycast"] += cast_count

    phase_time(3)

    # ---- 4: rollout rates, kernels on vs off, in turns ---- #
    for name, *_ in MAIN_PATHS:
        env = make_path_env(name)
        actions = random_actions(env, N_STEPS, seed=7)
        rates = {True: [], False: []}
        for on in (True, False, False, True):
            rates[on].append(rollout_rate(env, actions, on))
        log(f"[4] {name}@{env.num_envs} {N_STEPS}-step rollout env-steps/s:"
            f" kernels {rates[True][0]:.6g} {rates[True][1]:.6g},"
            f" plain {rates[False][0]:.6g} {rates[False][1]:.6g}")
        del env, actions
    for name, num_envs in TRAIN_CELLS:
        train_rates(name, num_envs)

    phase_time(4)

    # ---- 5: where a step's time goes ---- #
    for name, *_ in MAIN_PATHS:
        env = make_path_env(name)
        actions = random_actions(env, PROFILE_STEPS, seed=8)
        for on in (True, False):
            wall, busy, idle, n_kernels, named = profile_steps(env, actions, on)
            log(f"[5] {name}@{env.num_envs} {'kernels' if on else 'plain'}:"
                f" wall {wall:.4f} ms/step, device busy {busy:.4f} ms/step,"
                f" idle share {idle:.4f}, {n_kernels:.1f} device"
                f" kernels/step, physics kernel {named['physics']:.4f}"
                f" ms/step, ray-cast kernel {named['raycast']:.4f} ms/step,"
                f" planner kernel {named['planner']:.4f} ms/step, road"
                f" kernels (agent geometry, pair, neighbour)"
                f" {named['agent_geometry']:.4f}"
                f" {named['pair_collisions']:.4f}"
                f" {named['neighbor_obs']:.4f} ms/step")
        del env, actions
    for name, num_envs in TRAIN_CELLS:
        profile_training(name, num_envs)
    phase_time(5)

    print(json.dumps({"kernels": [
        {
            "name": "physics_step",
            "covers": "six contact classes and joint constraints",
            "path": f"transport@{PATH_ENVS['transport']}",
            "route": "cuda",
            "source": "vectorizedmultiagentsimulator_tpu_torch/csrc/physics_step.cu",
            "replaces": "vectorizedmultiagentsimulator_tpu/ops/physics_pallas.py:93",
            "launches": launches["physics_step"],
            # Over the comparisons held at ATOL + RTOL|ref|; those of stiff
            # joint worlds held by the float64 rule come next.
            "max_abs_err": max(errs),
            "max_abs_err_float64_rule": max(stiff_errs, default=0.0),
            "ms": kernel_ms,
            "plain_ms": plain_ms,
            "bound_ms": phys_bound,
            "bound_by": phys_by,
            "library_ms": None,
            "joint_path": {
                "path": f"joint_passage@{PATH_ENVS['joint_passage']}",
                "ms": times["joint_passage"][0],
                "plain_ms": times["joint_passage"][1],
                "bound_ms": times["joint_passage"][2][0],
                "bound_by": times["joint_passage"][2][1],
            },
        },
        {
            "name": "raycast",
            "route": "cuda",
            "source": "vectorizedmultiagentsimulator_tpu_torch/csrc/raycast.cu",
            "replaces": "vectorizedmultiagentsimulator_tpu/ops/raycast_pallas.py:47",
            "launches": launches["raycast"],
            "max_abs_err": max(cast_errs),
            "ms": cast_ms,
            "plain_ms": cast_plain_ms,
            "bound_ms": cast_bound,
            "bound_by": cast_by,
            "library_ms": None,
        },
        {
            "name": "football_policy",
            "route": "cuda",
            "source": "vectorizedmultiagentsimulator_tpu_torch/csrc/football_policy.cu",
            "replaces": "vectorizedmultiagentsimulator_tpu/ops/football_policy_pallas.py:196",
            "launches": launches["football_policy"],
            "max_abs_err": max(planner_errs),
            "ms": plan_ms,
            "plain_ms": plan_plain_ms,
            "bound_ms": plan_bound,
            "bound_by": plan_by,
            # No single PyTorch call computes the planner's choice.
            "library_ms": None,
        },
        {
            "name": "ppo_update",
            "route": "cuda",
            "source": "vectorizedmultiagentsimulator_tpu_torch/csrc/ppo_update.cu",
            "replaces": "vectorizedmultiagentsimulator_tpu/ops/ppo_update_pallas.py:291",
            "launches": launches["ppo_update"],
            "max_abs_err": max(ppo_errs),
            "ms": ppo_ms,
            "plain_ms": ppo_plain_ms,
            "bound_ms": ppo_bound,
            "bound_by": ppo_by,
            # No single PyTorch call computes a PPO minibatch's gradients.
            "library_ms": None,
        },
    ] + [
        {
            "name": name,
            "route": "cuda",
            "source": "vectorizedmultiagentsimulator_tpu_torch/csrc/road_geometry.cu",
            "replaces": f"vectorizedmultiagentsimulator_tpu/ops/road_geometry_pallas.py:{line}",
            "launches": launches[name],
            "max_abs_err": err,
            "ms": road_times[name][0],
            "plain_ms": road_times[name][1],
            "bound_ms": road_times[name][2],
            "bound_by": road_times[name][3],
            # No single PyTorch call computes road_traffic's geometry.
            "library_ms": None,
        }
        for name, line, err in (
            ("agent_geometry", 183,
             max(e[0] for e in road_errs["geometry"])),
            ("pair_collisions", 479,
             max(e[1] for e in road_errs["geometry"])),
            ("neighbor_obs", 551, max(road_errs["neighbor_obs"])),
        )
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
