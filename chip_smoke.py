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
     its envs (30k; road_traffic and discovery 10k) from its reset state,
     from random inputs and after 10 steps.
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
     Ray cast: every LIDAR group of each main path after those 10 steps
     (navigation's and flocking's four LIDARs, one launch from the four
     agents, each skipping itself; discovery's five target LIDARs over its
     seven targets) and its first agent's LIDAR alone (one origin), the
     tests/golden/raycast.npz scene tiled to 30k envs with
     random poses, axis-aligned rays against unrotated boxes, and the
     golden shapes on the edge of the kernel's reach test
     (torch_helpers.poses_at_cast_reach), each from the agent alone and
     from every entity of the scene in one launch;
     each against the plain version from each origin over its own table,
     two launches bit-identical; each line counts the rays that hit and
     the rays where one side hits and the other misses.
     Each main path's random inputs again with the physics kernel forced to
     one lane an env (the lane group is chosen at finalize).  Then each
     kernel's time beside its plain version's (physics at each main path,
     with the device time at each lane group 1, 2, 4 and 8; the ray cast at
     navigation@30k and flocking@30k, the group's launch and one LIDAR's,
     and the host time of a step's LIDAR measures).  PPO update: one minibatch
     at transport@4096's shapes in Gaussian, flat-categorical and
     multidiscrete mode, with a 1-wide action, with norm_n != mb, with a
     ragged last tile, with hidden sizes of 96, 100 (padded to 112), 128,
     176, 256 and 300 (smaller tiles; at 176 and 256 a cluster of 4 blocks
     a tile, each with a quarter of the hidden units and the sums on chip,
     at 300 the gradient sums in device memory and the trunk weights read
     from there too), at 1536 and 2048 (the
     activation tiles in device memory too; one minibatch of a real
     transport@256 rollout with the trainer's own parameters, and each
     one's time, bound and plain time), at
     the shapes of every training run of phases 3 to 5 from random data,
     and on the packed rollout of a real rollout of each training path of
     phase 3 (transport@4096 over 64 steps, navigation@4096 over 16); max
     |kernel - plain| of every gradient and sum, two launches bit-identical,
     then the time of a launch (CUDA events and the profiler's device
     time), its bound and the plain version's time, at transport@4096 and
     at the same shapes with hidden 256.  Football's planner:
     random inputs at 30k envs for 1, 3 and 5 teammates, with and without
     value noise, a third of the envs with exact ties (mirrored
     candidates), the draws scaled in the kernel, curr_target, the ball
     and the nets strided views of a stacked state, and the real inputs of
     football 5v5@30k after 10 steps; for each, max |kernel - plain| over
     the rows that pick the plain version's candidate, the rows that pick
     another (each must be a near tie: its value within 1e-6 of the best),
     the time of a launch (CUDA events and device time), the plain
     version's time and the bound; then the device time of a launch at
     1, 2 and 4 lanes a row, the envs read through L1 and staged in shared
     memory, each equal to the plain version.
     Road geometry (the agent-geometry, pair and neighbour kernels): road_
     traffic@10k from its reset poses (agents on path vertices: the closest
     index and every flag must equal the plain version's), from jittered
     poses, on vertices just before the paths' ends (the short-term path
     wraps around a loop; exact too), from poses uniform over the map with
     random headings and path ids (most agents far from their path, where
     culling skips most chunks) and after 10 steps, and a map '3' world
     (10 agents) from the same poses, across its entry and exit segments
     and after 10 steps; at 1024 envs, poses a margin's width from a chunk's
     box at each lane group and poses where a path passes near itself (no
     closest index may move there); and road_traffic@10k on map '2' after
     10 steps and a masked reset in which some envs replayed a recorded
     state (their poses, path and point ids), where every output of the
     three kernels must be the plain version's bits
     (torch_helpers.geometry_diff: continuous outputs within 1e-5 +
     1e-5|ref|, a moved index or flipped flag only at a near tie or
     touch); the pair matrix equal to its transpose; the neighbour kernel
     on each of those and on random inputs at 6, 20, 33 and 64 agents with
     1 and 2 neighbours, half the envs with ties (nd bit-equal); two launches
     bit-identical; then each kernel's time (CUDA events and device time),
     its plain version's and its bound (the agent kernel's from the chunks
     its culling keeps for these inputs, the pair kernel's from the pairs
     whose boxes meet), with the every-segment bound beside it; then the
     agent kernel's ms a launch at 4, 8, 16 and 32 lanes an agent, tables
     through L1 and staged in shared memory, with culling and without;
  3. the main paths: make_env(name, num_envs, device="cuda") for
     transport, simple_spread, navigation, flocking, balance, football
     (5v5, the red team's scripted AI), joint_passage and buzz_wire (the
     physics kernel's joint branch) at 30k envs, road_traffic (20
     vehicles, the CPM-Lab map) at 10k on map '1' and on map '2' (which
     records the state 10 steps before each agent-agent collision and
     starts 20 % of resets from a recorded one) and discovery (5 agents, 7
     targets) at 10k, reset, 100 env.step calls under
     torch.cuda.set_sync_debug_mode("error") (any host sync fails the run);
     outputs finite and of the JAX package's shapes; exactly one physics
     launch per step, one ray-cast launch per LIDAR group and step (1 a
     step in navigation, flocking and discovery, none elsewhere), one
     planner launch per AI team and step (football) and one launch of each
     road kernel a step (road_traffic), each count set to 0 just before
     the run and read just after; discovery's covered targets counted on
     the card (some must respawn); then a masked reset of about half the
     envs under the same check (on map '2' some of them must start from a
     recorded state, counted); road_traffic with map '3' (10 agents),
     whose done() re-places agents every step, likewise (two
     agent-geometry launches a step).  The other scenarios
     (OTHER_PATHS: the MPE suite, sampling, wheel, passage, ball_passage,
     reverse_transport, dropout; give_way, multi_give_way, wind_flocking
     and the debug circle_trajectory, line_trajectory, goal, vel_control,
     diff_drive, drone, het_mass and pollock, the last two on the plain
     physics as the JAX package routes them, pollock with its 15 LIDARs
     measured one ray cast a ray) likewise over 10 steps at 1024 envs;
     pollock's ray-by-ray LIDAR measure against the grouped one, to the
     bit.
     Then each CUDA env against the CPU env (plain path) from one state
     over 10 steps at 64 envs, football's two envs fed the same planner
     samples, road_traffic's without observation noise, discovery's
     covered targets leaving the arena (targets_respawn=False), the joint
     paths at tests/test_scenario_parity.py's tolerance of the scenario.  The
     joint worlds that take the plain path: waterfall at 64 envs and the
     `joints_fixed_rotation` world (rotation inferred per env), no physics
     launch in 10 steps, finite state.  Then training:
     init_training("transport", 4096) at the PPOConfig defaults and 3
     train_step calls under the same sync check: 16 PPO-update launches and
     64 physics launches an iteration, finite loss and reward, parameters
     changed, the spawner's give-ups printed; the same for navigation (ray
     casts in the rollout) with 16-step rollouts, and for transport@4096
     with a hidden-256 trunk (16-step rollouts, one iteration);
  4. env-steps/s of each 100-step rollout through the kernels and of
     50 steps with the kernels forced off (the world on its plain physics,
     the ray cast on cast_rays_plain, the planner on best_positions_plain,
     the road geometry on geometry_plain and neighbor_obs_plain), in turns
     (kernel, plain, plain, kernel), timed with CUDA events (map '2':
     the kernels only, NO_PLAIN_WINDOWS); then
     training env-steps/s of simple_spread@4096,
     transport@4096 and transport@16384 with the PPO kernel and with the
     autograd update, in turns, and the rollout and update time of an
     iteration;
  5. a torch.profiler trace of 20 steady steps of each main path with
     the kernels on and 10 with them off (but map '2') (and of discovery with
     targets_respawn=False, kernels on: its step without the respawn):
     wall ms a step (CUDA events, without the profiler), device busy ms a
     step, idle share, device kernels a step,
     and each kernel's device ms a step; then for each training cell the
     host's enqueue time of a rollout step split into env.step, the masked
     reset and the rest, and one training iteration under the profiler;
  6. the rollout as a CUDA graph (parallel/rollout.py): on every main path
     (map '2' from a state after a reset that replayed recorded states)
     and every scenario of OTHER_PATHS at 1024 envs, and transport at 30k,
     two 10-step graph rollouts in a row (capture and replay, then a
     replay from the graph's own final
     state) against the eager loop from the same state and generator
     states: every output, the final state and the world generator's
     state equal to the bit, and the replayed launches a step those of
     phase 3 (each count set to 0 just before and read just after); then
     each main path at its own envs, 50-step rollouts eager and as a
     graph in turns (eager, graph, graph, eager): env-steps/s, the
     capture's time and peak memory, and 20 graph steps under the
     profiler (wall, device busy, idle share, device kernels and launches
     a replayed step); each scenario of OTHER_PATHS at 30k: make_env's
     seconds and peak memory (its first reset: sampling's normalize_pdf),
     a masked reset's ms and peak memory, and the graph alone (a 25-step
     rollout captured and replayed twice: env-steps/s, capture s, peak
     memory; its graph-vs-eager check above without the profiler's
     traces);
     then the port bench once
     (`python -m vectorizedmultiagentsimulator_tpu_torch.bench`,
     transport@30k);
  7. the edges: make_env(..., wrapper="gym") and wrapper="rllib" (plain
     classes where gym and ray are absent), and "gymnasium" and
     "gymnasium_vec" where gymnasium is installed (else a line saying the
     CPU tests hold them), on transport, navigation and football 5v5 at
     30k after 10 steps: one step through each wrapper against the
     unwrapped env's from the same state, generator state and actions
     (env 0 for the single-env wrappers, all 30k envs for rllib's
     vector_step and gymnasium_vec), every output equal to the bit, and the
     ms a step of each beside the unwrapped step's; rgb_array frames of
     navigation, football 5v5 and joint_passage at 30k and road_traffic
     (map '1') at 10k after 10 steps, of the other scenarios that draw
     (EDGE_FRAME_OTHERS) at 64 envs with their LIDAR rays after 3 steps,
     and of navigation with its LIDAR
     rays after a 10-step graph rollout, each against the frame the port
     renders on the CPU from the same env-0 state (0 differing pixels) and
     made with one host sync, its device-to-host copy (counted by
     torch.cuda.set_sync_debug_mode("warn")), the rays
     present, and the ms a frame at 30k and at 64 envs; checkpoints of
     transport@30k and road_traffic map '2'@10k: 20 steps, save_env, 20
     more, restored into a fresh env (and, through rollout's graph, into
     the env holding the captured graph) and 20 steps equal to the bit
     (outputs, final state, generator), eagerly and through the graph,
     with the file's bytes and the ms to save and to restore;
  8. multi-device and gradients: (a) the gradient of a 3-step rollout loss
     (tests/test_torch_grad.py's: the mean of every observation and reward
     over the steps, with respect to the first action applied every step)
     at 1024 envs of transport, navigation, balance, joint_passage,
     discovery and road_traffic (map '1', 4 agents), through the kernels'
     autograd.Functions on the card, against the CPU port's from the same
     state (GRAD_TOL; joint_passage's chaotic gradient by the share of
     envs it moves, against the CPU's own under an ulp of the positions:
     this holds the forwards and what they save, the backward being the
     same plain version on both sides), with each path kernel's launches
     in the forward
     (above 0; the backward, the plain versions, launches none), finite
     and nonzero; (b) two worker processes on the one card over gloo
     (parallel.run_workers; parallel.init_distributed): transport@30k,
     navigation@30k and road_traffic@10k (noise off) split 2 x B/2, 10
     steps of each rank's shard equal to the one-process env's rows to the
     bit (outputs, state fields, extras), then a masked reset of every env
     that draws differently on the two ranks; the data-parallel trainer at
     transport@4096 (2 x 2048): one update of 1 epoch x 1 minibatch from
     one packed rollout split by env (norm_n = 2 x mb) against the
     one-process update (PPO_GRAD_TOL), then one full iteration at the
     PPOConfig defaults, its wall, the ms of a minibatch's all-reduces, and
     the parameters bit-identical on the two ranks; (c) an NCCL world of one
     rank: one data-parallel iteration equal to the plain Trainer's to the
     bit, with no host sync (torch.cuda.set_sync_debug_mode("error"));
  9. the functional API (Environment.state, step_fn, reset_at_fn) at
     transport@30k, navigation@30k, football 5v5@30k and road_traffic map
     '2'@10k: 10 step_fn calls from env.state with a generator equal to
     10 env.step calls from the same state and generator state to the bit
     (outputs, every state leaf, the generator), the input states (of the
     step_fn calls and of a reset_at_fn of the last step's dones and every
     third env) equal to clones taken before, two branches with equal
     generator states equal, reset_at_fn equal to env.reset_at; one
     step_fn's launches (one physics kernel, one ray cast on navigation,
     one planner on football, one of each road kernel on map '2'); a
     step_fn and a masked reset_at_fn, the generators' states read and
     set, with no host sync; ms a step_fn call beside an env.step (CUDA
     events, in turns) and, on map '2', of the copy of its two in-place
     buffers that a step_fn from a state it does not own makes; a CUDA
     graph of 10 step_fn calls at transport@30k equal to the eager calls
     to the bit, its kernel nodes counted by name; the gradient of a
     3-call loss with respect to the initial pos and vel at 1024 envs of
     transport and navigation, card against CPU port within GRAD_TOL.

The line before the last is a JSON object describing each kernel; the last
line is {"ok": true, "device": {...}}.  Without CUDA, or without the
package beside it, the script fails before printing any result.

    python3 chip_smoke.py --ab PARENT_ROOT [PAIRS [GROUP,...]]

compares this checkout's package with another checkout's (for example the
parent commit unpacked with `git archive` into a gitignored directory) on
one card: PAIRS (default 10) alternating pairs of processes, each running
the groups named (all by default): "joint", two 100-step rollouts of
joint_passage and buzz_wire at 30k envs with the physics wrapper's time
per call and its kernel's device time; "road", two of road_traffic at 10k
with the agent-geometry, pair and neighbour kernels' device time a launch;
"lidar", two of navigation and flocking at 30k with the ray cast's device
time and launches a step; "football", two of football 5v5 at 30k with the
device busy time, device kernels and planner kernel time a step; "train",
two training iterations of transport@16384 (update and iteration ms);
"ppo", one PPO minibatch at transport@4096's shapes at hidden 64, 256 and
300 (ms a call and device ms); it prints each run and a JSON summary.
"""
import contextlib
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
N_ENVS = 30_000
N_STEPS = 100
# Phase 5's steady window a path: joint_passage's plain path launches
# 13,000 device kernels a step, and the profiler's events cost host time.
PROFILE_STEPS = 20
# The plain versions' windows in phases 4 (steps timed) and 5 (steps
# profiled): a plain joint or road step takes 60-110 ms, and the script
# must stay well inside its time limit as the slices add paths.
PLAIN_STEPS = 50
PLAIN_PROFILE_STEPS = 10
# The main paths whose plain windows phases 4 and 5 leave out: map '2''s
# plain step is map '1''s with the buffers' writes (about 30 small kernels
# a step), and its windows cost about 40 s of the run.
NO_PLAIN_WINDOWS = ("road_traffic_map2",)
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
# The stepping paths that --ab compares across commits: the two joint
# paths, whose physics launch is the largest share of their device time;
# and the training cell it times (update and iteration ms).
AB_SCENARIOS = ("joint_passage", "buzz_wire")
AB_TRAIN = ("transport", 16384)
# And road_traffic@10k: env-steps/s and its agent-geometry, pair and
# neighbour kernels' device ms a launch.
AB_ROAD = ("road_traffic", 10_000)
# And the LIDAR paths at 30k envs: env-steps/s, the ray cast's device ms
# and launches a step.
AB_LIDAR = ("navigation", "flocking")
# The groups --ab runs by default (rate_worker), football 5v5@30k's step
# and planner among them.
AB_GROUPS = ("joint", "road", "lidar", "football", "train", "ppo")
# The PPO kernel's hidden sizes of the "ppo" group: the three layouts
# that keep the activation tiles in shared memory.
AB_PPO_HIDDEN = (64, 256, 300)
# (scenario, envs, agents, obs width, ray-cast launches a step (one a LIDAR
# group: navigation's and flocking's four LIDARs are one), planner
# launches a step, road-kernel launches a step: agent geometry, pair,
# neighbour).  road_traffic runs at 10k envs: the plain version's [B, A, 5,
# 184] fp32 intermediates, several alive at once, are 0.74 GB each there.
# discovery runs at the 10k of BASELINE.md's "navigation/discovery with
# LIDAR @10k" and of the JAX package's own cell (BENCHMARKS.md:21): 5
# agents whose five target LIDARs (15 rays over 7 targets) are one group,
# covered targets respawned inside reward() by a spawner of fixed rounds.
MAIN_PATHS = [
    ("transport", N_ENVS, 4, 11, 0, 0, (0, 0, 0)),
    ("simple_spread", N_ENVS, 3, 14, 0, 0, (0, 0, 0)),
    ("navigation", N_ENVS, 4, 18, 1, 0, (0, 0, 0)),
    ("flocking", N_ENVS, 4, 18, 1, 0, (0, 0, 0)),
    ("balance", N_ENVS, 3, 16, 0, 0, (0, 0, 0)),
    ("football", N_ENVS, 5, 88, 0, 1, (0, 0, 0)),
    ("joint_passage", N_ENVS, 2, 10, 0, 0, (0, 0, 0)),
    ("buzz_wire", N_ENVS, 2, 6, 0, 0, (0, 0, 0)),
    ("road_traffic", 10_000, 20, 32, 0, 0, (1, 1, 1)),
    ("discovery", 10_000, 5, 19, 1, 0, (0, 0, 0)),
    # road_traffic on map '2' (SCENARIO_OF, PATH_KWARGS): the way its
    # users train, recording the state 10 steps before each agent-agent
    # collision and starting 20 % of resets from a recorded state.
    ("road_traffic_map2", 10_000, 20, 32, 0, 0, (1, 1, 1)),
]
# The other scenarios of the slice (the MPE suite, sampling, wheel,
# passage, ball_passage, reverse_transport, dropout), in MAIN_PATHS' form
# with no agent count or obs width (their agents observe different
# widths): each steps GRAPH_STEPS steps at GRAPH_ENVS envs under the sync
# check in phase 3 and against the CPU env at 64 envs; phase 6 holds its
# graph rollout to the eager loop at GRAPH_ENVS and times the graph at
# N_ENVS, BASELINE.md's "full MPE suite @30k".
OTHER_PATHS = [
    (name, N_ENVS, None, None, casts, 0, (0, 0, 0)) for name, casts in (
        ("simple", 0), ("simple_adversary", 0), ("simple_crypto", 0),
        ("simple_push", 0), ("simple_reference", 0), ("simple_tag", 0),
        ("simple_world_comm", 0), ("sampling", 1), ("wheel", 0),
        ("passage", 0), ("ball_passage", 0), ("reverse_transport", 0),
        ("dropout", 0),
        # The velocity-controlled scenarios, the debug dynamics
        # showcases, and pollock with a 16-ray LIDAR on each of its 15
        # agents measured one ray cast a ray (PATH_KWARGS).
        ("give_way", 0), ("multi_give_way", 0), ("wind_flocking", 0),
        ("circle_trajectory", 0), ("line_trajectory", 0), ("goal", 0),
        ("vel_control", 0), ("diff_drive", 0), ("drone", 0),
        ("het_mass", 0), ("pollock", 15 * 16))
]
# The paths that step through the plain physics, as the JAX package's guard
# routes them: het_mass's per-env mass, pollock's weighted pair cost x
# substeps over the guard (ops/physics_cuda.step_supported).
PLAIN_ROUTE = ("het_mass", "pollock")
# Phase 6: the graph rollout against the eager loop on every main path at
# GRAPH_ENVS envs over GRAPH_STEPS steps (and transport at N_ENVS), twice
# in a row; then each path's eager and graph rates at its own envs.
GRAPH_ENVS = 1024
GRAPH_STEPS = 10
# Phase 6's rollouts that time each main path eager and as a graph: a
# road_traffic eager step takes about 70 ms at 10k envs, and its three
# eager rollouts and its capture are most of the phase's time.
GRAPH_RATE_STEPS = 50
# The graph rollouts that time OTHER_PATHS at N_ENVS; pollock's plain
# physics over 45 entities takes about 0.75 s a step at 30k (its capture of
# 25 steps took 23.7 s, each replay 19 s), so it rolls POLLOCK_STEPS.
OTHER_STEPS = 25
POLLOCK_STEPS = 5
# The joint worlds (joint_force 900 over 10-15 substeps): an ulp grows
# about 2x a substep, so from inputs far from rest (random, or after 10
# random steps) the kernel is held to torch_helpers.physics_diff's float64
# rule where it exceeds ATOL + RTOL|ref|; from the reset state jittered
# (torch_helpers.jittered_inputs) it is held at ATOL + RTOL|ref|.
STIFF_PATHS = ("joint_passage", "buzz_wire")
# The other joint scenarios of phase 2, at 4096 envs.
JOINT_WORLDS = ("asym_joint", "ball_trajectory", "joint_passage_size")
PATH_ENVS = {path[0]: path[1] for path in MAIN_PATHS + OTHER_PATHS}
# road_traffic on map '3' (the intersection, 10 agents): its done()
# re-places the agents that leave through an entry or exit segment every
# step, one more agent-geometry launch a step.
ROAD_MAP3 = dict(map_type="3", n_agents=10)
# A main path's make_env kwargs beyond the defaults: football 5v5, the
# reference's benchmark configuration (BASELINE.md), the red team scripted.
PATH_KWARGS = {"football": dict(n_blue_agents=5, n_red_agents=5),
               "road_traffic_map2": dict(map_type="2"),
               "pollock": dict(lidar=True, vectorized_lidar=False)}
# The scenario of a path whose name is not a scenario's.
SCENARIO_OF = {"road_traffic_map2": "road_traffic"}
# Phase 2's random physics inputs put every entity in [-spread, spread]^2:
# 0.3 by default; football's 23 entities (10 walls and goal lines) at 0.3
# press each sphere against up to ten lines at once, whose opposed contact
# forces cancel to a residue that no fp32 sum order keeps (its pitch is
# 3 x 1.5), so it is held at 1.0 and dense_contacts prints 0.3.
PATH_SPREAD = {"football": 1.0}
# cuda_vs_cpu's extra kwargs: the two envs' generators differ, so
# road_traffic's observation noise is off there, and discovery's covered
# targets leave the arena (targets_respawn=False) instead of respawning at
# places each generator draws for itself.
CPU_COMPARE_KWARGS = {"road_traffic": dict(is_add_noise=False),
                      "road_traffic_map2": dict(is_add_noise=False),
                      "discovery": dict(targets_respawn=False)}
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
DISCRETE_FLAGS = ("road_traffic", "road_traffic_map2")
# The H100 SXM's published rates (NVIDIA's data sheet): device
# memory and fp32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# Arithmetic per pair class and substep of csrc/physics_step.cu (per joint
# constraint, and the fixed-rotation torque of one that does not rotate), and per
# ray and entity class of csrc/raycast.cu, with each box's and line's trig
# once an env ("box_env", "line_env") and each (env, origin, entity)'s
# reach test ("reach") (each sqrt, sin, cos, exp, log and division
# counted as one operation), counted from the sources.
PHYSICS_OPS = {"ss": 29, "bs": 131, "ls": 42, "ll": 133, "bl": 470,
               "bb": 3300, "entity": 25, "joint": 102, "joint_fixed": 17}
CAST_OPS = {"ray": 3, "sphere": 37, "box": 50, "line": 24, "box_env": 5,
            "line_env": 4, "reach": 15}
# The same for csrc/football_policy.cu: per candidate and teammate (the
# draws' scaling included), and the teammate-repulsion term per candidate,
# teammate and other teammate (the agent's own term is left out).
PLANNER_OPS = {"candidate": 96, "pair": 11}
# The same for csrc/road_geometry.cu: one segment distance with its running
# minimum, one strict crossing test, one rectangle (cos, sin, 5 corners),
# the box of an agent's points, one short-term point, a neighbour round
# besides its A compares; a point's distance to a chunk's box with its
# compare ("box"), the agent's box against a boundary chunk's (the margin
# test and the box gap, "gap"), two rectangles' boxes against each other
# ("meet").
ROAD_OPS = {"seg": 26, "cross": 29, "rect": 42, "bounds": 16, "short": 8,
            "neighbor": 92, "box": 13, "gap": 25, "meet": 12}
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
    "transport hidden 100": (15, 2, 0, 100),
    "transport hidden 128": (15, 2, 0, 128),
    "transport multidiscrete hidden 128": (15, 2, 3, 128),
    "transport hidden 176": (15, 2, 0, 176),
    "transport multidiscrete hidden 192": (15, 2, 3, 192),
    "transport hidden 256": (15, 2, 0, 256),
    "transport hidden 300": (15, 2, 0, 300),
    "transport hidden 1536": (15, 2, 0, 1536),
    "transport hidden 2048": (15, 2, 0, 2048),
}
# The shapes phase 2 holds beside the default one: wider trunks take
# smaller tiles (64, 32, 16 samples), a hidden size that is not a multiple
# of 16 is padded, from about hidden 160 to 256 a cluster of 4 blocks
# shares each tile (176: 48 units a block, 192 multidiscrete, 256: 64 a
# block), and from about 260 the gradient sums live in device memory and
# the trunk weights are read from there too.
PPO_WIDE = ("transport hidden 96", "transport hidden 100",
            "transport hidden 128", "transport multidiscrete hidden 128",
            "transport hidden 176", "transport multidiscrete hidden 192",
            "transport hidden 256", "transport hidden 300")
# (scenario, envs, rollout steps, iterations, ray casts a step, hidden) of
# the training runs of phase 3; a step observes once and once more in its
# masked reset, so it casts its LIDAR group twice.  The last trains a
# hidden-256 trunk through the kernel.
# The hidden sizes past 1,040 phase 2 holds (the fourth layout: activation
# tiles and hidden-size vectors in device memory).
PPO_GLOBAL_TILES = (1536, 2048)
TRAIN_PATHS = [("transport", 4096, 64, 3, 0, 64),
               ("navigation", 4096, 16, 2, 2, 64),
               ("transport", 4096, 16, 1, 0, 256)]
TRAIN_CELLS = [("simple_spread", 4096), ("transport", 4096),
               ("transport", 16384)]
# The specs phase 2 held to the plain version; a training run of a later
# phase whose spec is not among them fails.
PPO_COMPARED = set()


# Phase 8.  The gradient paths and their kwargs (road_traffic as
# tests/test_grad.py differentiates it), at GRAD_ENVS envs over GRAD_STEPS
# steps, and the kernels each one's forward launches.
GRAD_PATHS = [("transport", {}), ("navigation", {}), ("balance", {}),
              ("joint_passage", {}), ("discovery", {}),
              ("road_traffic", dict(n_agents=4, map_type="1"))]
GRAD_ENVS = 1024
GRAD_STEPS = 3
GRAD_KERNELS = {
    "navigation": ("physics_step", "raycast"),
    "discovery": ("physics_step", "raycast"),
    "road_traffic": ("physics_step", "agent_geometry", "pair_collisions",
                     "neighbor_obs"),
}
# The card's gradient against the CPU's, as a share of the CPU gradient's
# largest entry.  The backward is the same plain version on both sides, at
# the forward's saved inputs, so this holds the kernels' forwards and the
# inputs they save for the backward (and the plain backward on the card's
# tensors), not the backward's formulas: tests/test_torch_grad.py holds
# those against jax.grad on the CPU.  The forward kernels and the card's
# libm differ from the CPU's by ulps, which 3 steps of soft contacts and
# ray casts amplify: discovery's gradient (largest entry 7.6e-5) differed
# by 9.6e-5 of it on an H100 (PERF.md §6), the others by at most 4.7e-7.
# Held at 1e-3, 10x that; a wrong forward or a wrong saved input moves it
# by O(1).  joint_passage's stiff joints (joint_force 900, 10 substeps)
# make its gradient chaotic: an ulp of the positions moves the CPU's own
# gradient by more than 1e-3 of its largest entry in about a fifth of the
# envs (phase 8 prints the share), and the card's forward differs from the
# CPU's by more than an ulp.  So it is held by share: the share of envs
# whose card gradient differs from the CPU's by more than GRAD_STIFF_DIFF
# of the largest entry may be at most the smallest such share of
# GRAD_NUDGES copies of the state with every position moved by an ulp (the
# card's forward may move the gradient no more than an ulp of the state
# does).
GRAD_TOL = 1e-3
GRAD_STIFF = ("joint_passage",)
GRAD_STIFF_DIFF = 1e-3
GRAD_NUDGES = 2
# The paths split over two ranks, the steps compared, the data-parallel
# training cell, and the workers' time limit (a hung rank fails the run).
SPLIT_PATHS = (("transport", N_ENVS), ("navigation", N_ENVS),
               ("road_traffic", 10_000))
SPLIT_STEPS = 10
DP_CELL = ("transport", 4096)
DP_TIMEOUT_S = 300
# Phase 9.  The functional API (Environment.state, step_fn, reset_at_fn) on
# these main paths at their own envs over FUNC_STEPS steps; a CUDA graph of
# FUNC_STEPS step_fn calls at FUNC_GRAPH_PATH; the gradient with respect to
# the initial pos and vel through FUNC_STEPS_GRAD step_fn calls at
# GRAD_ENVS envs on FUNC_GRAD_PATHS, card against CPU at GRAD_TOL; ms a
# call over FUNC_TIME_ITERS calls.
FUNC_PATHS = ("transport", "navigation", "football", "road_traffic_map2")
FUNC_STEPS = 10
FUNC_GRAPH_PATH = "transport"
FUNC_GRAD_PATHS = ("transport", "navigation")
FUNC_STEPS_GRAD = 3
FUNC_TIME_ITERS = 20


_T0 = time.perf_counter()


def log(msg):
    """Print ``msg``; a phase's line (``[4] ...``) ends with the seconds
    since the script started, so the log shows where the run's time goes."""
    if msg[:1] == "[" and msg[1:2].isdigit():
        msg = f"{msg} [{time.perf_counter() - _T0:.1f} s]"
    print(msg, flush=True)


def make_path_env(name, num_envs=None, device="cuda", seed=0, **kwargs):
    """make_env of a main path at its env count (or ``num_envs``), with its
    PATH_KWARGS and ``kwargs``."""
    import vectorizedmultiagentsimulator_tpu_torch as vmt

    return vmt.make_env(SCENARIO_OF.get(name, name),
                        num_envs=num_envs or PATH_ENVS[name],
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
    lanes = world._kernel_tables.structs[1].lanes
    log(f"[2] physics {label}: B={world.batch_dim} N={world._n_entities}"
        f" {pairs}{f' joints={joints}' if joints else ''} lanes={lanes}"
        f" max|kernel-plain|"
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


def cast_vs_plain(pos, rot, angles, origins, table, max_range, label):
    """The ray-cast kernel (twice: the two launches must give the same
    bits) against cast_rays_plain from each origin over its own table
    (the table without the origin), within CAST_TOL + CAST_TOL|ref| and
    with no ray that hits on one side and misses on the other; returns the
    largest |kernel - plain|."""
    import torch
    from vectorizedmultiagentsimulator_tpu_torch.ops import raycast_cuda

    with torch.no_grad():
        got = raycast_cuda.fused_cast_rays(pos, rot, angles, origins, table,
                                           max_range)
        again = raycast_cuda.fused_cast_rays(pos, rot, angles, origins,
                                             table, max_range)
        ref = raycast_cuda.cast_rays_plain(pos, rot, angles, origins, table,
                                           max_range)
    torch.cuda.synchronize()
    err, ok = max_err([got], [ref], CAST_TOL, CAST_TOL)
    same = torch.equal(got, again)
    cap = torch.tensor(max_range, dtype=torch.float32, device=got.device)
    flips = int(((got == cap) != (ref == cap)).sum())
    hits = int((ref < cap).sum())
    n_origins = 1 if isinstance(origins, int) else len(origins)
    log(f"[2] ray cast {label}: O={n_origins} B={pos.shape[0]}"
        f" R={angles.shape[-1]} spheres={len(table.sphere_idx)}"
        f" boxes={len(table.box_idx)} lines={len(table.line_idx)}"
        f" hits={hits} max|kernel-plain| = {err:.3e}, hit/miss"
        f" disagreements {flips}, two launches bit-identical: {same}")
    if not ok or flips or not same:
        raise AssertionError(
            f"{label}: ray-cast kernel disagrees with plain beyond"
            f" {CAST_TOL} + {CAST_TOL}|ref| or on a hit ({flips} flips), or"
            f" two launches differ ({not same})"
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


def cast_bound_ms(pos, angles, origins, table, max_range):
    """The same for one ray-cast launch: the staged poses (the cast
    entities and the origins, x, y and rot each) read once an env, the
    angles, and the O x B x R distances written; the operations these
    poses need: each ray's angle and direction, each (env, origin,
    entity)'s reach test, each box's and line's trig once an env, and each
    ray's test of the entities in its origin's reach (csrc/raycast.cu's
    rule, without its margin)."""
    import math
    import torch

    B, R = pos.shape[0], angles.shape[-1]
    origins = (origins,) if isinstance(origins, int) else tuple(origins)
    s, b, l = table.entities
    radius, b_len, b_wid, l_len = table.sizes
    cast = s + b + l
    staged = len(set(cast + origins))
    moved = B * staged * 12 + angles.numel() * 4 + len(origins) * B * R * 4
    reach = torch.tensor(
        list(radius) + [0.5 * math.hypot(x, y) for x, y in zip(b_len, b_wid)]
        + [0.5 * x for x in l_len], device=pos.device)
    cost = torch.tensor([CAST_OPS["sphere"]] * len(s)
                        + [CAST_OPS["box"]] * len(b)
                        + [CAST_OPS["line"]] * len(l),
                        dtype=torch.float64, device=pos.device)
    ent = torch.tensor(cast, dtype=torch.long, device=pos.device)
    in_reach = 0.0
    for o in origins:
        d = (pos[:, ent] - pos[:, o:o + 1]).norm(dim=-1)  # [B, C]
        near = (d <= max_range + reach) & (ent != o)
        in_reach += float((near.double() * cost).sum())
    ops = (len(origins) * B * R * CAST_OPS["ray"] + R * in_reach
           + B * (CAST_OPS["box_env"] * len(b) + CAST_OPS["line_env"] * len(l))
           + len(origins) * B * len(cast) * CAST_OPS["reach"])
    return bound(moved, ops)


def cast_times(args, label):
    """A ray-cast launch's ms a call (CUDA events over 200 back-to-back
    calls), device ms (the profiler), the plain version's ms and the
    bound, at ``args`` = (pos, rot, angles, origins, table, max_range)."""
    import torch
    from vectorizedmultiagentsimulator_tpu_torch.ops import raycast_cuda

    with torch.no_grad():
        call = lambda: raycast_cuda.fused_cast_rays(*args)
        plain = lambda: raycast_cuda.cast_rays_plain(*args)
        for _ in range(3):
            call()
            plain()
        t = {"ms": cuda_time_ms(call, 200),
             "device_ms": device_ms(call, 20, "cast_rays_kernel"),
             "plain_ms": cuda_time_ms(plain, 20)}
    t["bound_ms"], t["bound_by"] = cast_bound_ms(args[0], args[2], args[3],
                                                 args[4], args[5])
    log(f"[2] ray cast at {label}: {t['ms']:.5f} ms a call (CUDA events),"
        f" {t['device_ms']:.5f} ms device, plain {t['plain_ms']:.4f} ms,"
        f" bound {t['bound_ms']:.5f} ms ({t['bound_by']})")
    return t


def measure_enqueue_ms(env, iters=200):
    """Host ms (perf_counter, no synchronize) of one step's LIDAR
    measures: every agent's Lidar.measure after a pose write (one grouped
    launch, the other agents reading its slices), and the same LIDARs as
    one single-origin wrapper call each (the layout before grouping)."""
    import torch
    from vectorizedmultiagentsimulator_tpu_torch.ops import raycast_cuda

    w = env.world
    s = w.state
    lidars = [x for a in w.agents for x in a.sensors]
    group = w._lidar_groups[(lidars[0], lidars[0].agent,
                             lidars[0].entity_filter)][0]
    poses = (s.pos, s.pos.clone())
    out = {}
    with torch.no_grad():
        for key in ("grouped", "single", "grouped", "single"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(iters):
                s.pos = poses[i % 2]  # a pose write: the cache is stale
                if key == "grouped":
                    for x in lidars:
                        x.measure()
                else:
                    for x in lidars:
                        raycast_cuda.fused_cast_rays(
                            s.pos, s.rot, x._angles, x.agent.index,
                            group.table, x._max_range)
            out.setdefault(key, []).append(
                (time.perf_counter() - t0) * 1e3 / iters)
            torch.cuda.synchronize()
    s.pos = poses[0]
    return out


def bound(moved, ops):
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main_path(name, envs, agents, obs_dim, casts_per_step, plans_per_step,
              road_per_step, label=None, n_steps=N_STEPS, **kwargs):
    """``n_steps`` steps of make_env(name, envs, **kwargs) on the card with
    no host sync (agents and obs widths checked where given), then a
    masked reset of about half the envs under the same check; returns
    the physics, ray-cast and planner launches and the road kernels'
    launches counted in the steps.  A scenario that respawns covered
    targets (discovery) counts the respawns on the card and must make
    some."""
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
    kernel_route = name not in PLAIN_ROUTE
    assert env.world._use_kernel == kernel_route, (
        f"{name}: the physics route is not the JAX package's")
    g = torch.Generator(device="cuda").manual_seed(1)
    sizes = [env.get_agent_action_size(a) for a in env.agents]
    give_ups_before = env.world.spawn_give_ups.clone()
    respawning = getattr(env.scenario, "targets_respawn", False)
    respawns = torch.zeros((), dtype=torch.int64, device="cuda")
    torch.cuda.synchronize()
    physics_cuda.LAUNCHES = 0
    raycast_cuda.LAUNCHES = 0
    football_policy_cuda.LAUNCHES = 0
    road_geometry_cuda.LAUNCHES.update(
        dict.fromkeys(road_geometry_cuda.KERNELS, 0))
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(n_steps):
            actions = [
                torch.rand((envs, s), generator=g, device="cuda") * 2 - 1
                for s in sizes
            ]
            obs, rews, dones, _ = env.step(actions)
            if respawning:
                respawns += env.scenario.covered_targets.sum()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    steps, casts = physics_cuda.LAUNCHES, raycast_cuda.LAUNCHES
    plans = football_policy_cuda.LAUNCHES
    road = tuple(road_geometry_cuda.LAUNCHES[k]
                 for k in road_geometry_cuda.KERNELS)
    torch.cuda.synchronize()
    assert agents is None or (len(obs) == agents and len(rews) == agents)
    for o, r in zip(obs, rews):
        assert obs_dim is None or tuple(o.shape) == (envs, obs_dim), o.shape
        assert tuple(r.shape) == (envs,), r.shape
        assert bool(torch.isfinite(o).all()) and bool(torch.isfinite(r).all())
    assert tuple(dones.shape) == (envs,) and dones.dtype == torch.bool
    s = env.world.state
    for f in ("pos", "vel", "rot", "ang_vel"):
        assert bool(torch.isfinite(getattr(s, f)).all()), f
    expected = (n_steps if kernel_route else 0, n_steps * casts_per_step,
                n_steps * plans_per_step,
                tuple(n_steps * r for r in road_per_step))
    if (steps, casts, plans, road) != expected:
        raise AssertionError(
            f"{label}: {steps} physics, {casts} ray-cast, {plans} planner and"
            f" {road} road-kernel launches in {n_steps} steps (expected"
            f" {expected})"
        )
    if respawning and not int(respawns):
        raise AssertionError(f"{label}: no target respawned in {n_steps}"
                             f" steps")
    # A masked reset (the trainer's, of the envs a mask names) under the
    # same check; on map '2' some reset envs must replay a recorded state.
    recorded = recorded_rows(env)
    mask = torch.rand((envs,), generator=g, device="cuda") > 0.5
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        reset_obs = env.reset_at(mask)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(bool(torch.isfinite(o).all()) for o in reset_obs)
    replays = ""
    if recorded is not None:
        n_replayed = int(replayed_envs(env, mask, recorded).sum())
        replays = (f", {n_replayed} of them from a recorded state (envs with"
                   f" a recorded state {int((recorded[1] > 0).sum())})")
        if not n_replayed:
            raise AssertionError(f"{label}: no reset env replayed a recorded"
                                 f" state")
    lanes = (env.world._kernel_tables.structs[1].lanes if kernel_route
             else "none (the plain route)")
    log(f"[3] {label}: physics lanes an env {lanes}; {n_steps} steps, no"
        f" host sync, obs {len(obs)}x[{envs}, "
        f"{'/'.join(sorted({str(o.shape[1]) for o in obs}))}] finite,"
        f" physics launches {steps},"
        f" ray-cast launches {casts}, planner launches {plans}, road"
        f" launches (agent geometry, pair, neighbour) {road}; dones in the"
        f" last step {int(dones.sum())}, placement give-ups"
        f" {int(env.world.spawn_give_ups - give_ups_before)}"
        + (f", targets respawned {int(respawns)}" if respawning else "")
        + f"; masked reset of {int(mask.sum())} envs{replays}, no host sync")
    return steps, casts, plans, road


def recorded_rows(env):
    """A map '2' road_traffic env's initial-state buffer and its lengths
    (copies), or None for any other env."""
    if getattr(env.scenario, "map_type", None) != "2":
        return None
    return env.scenario.isb_buf.clone(), env.scenario.isb_len.clone()


def replayed_envs(env, mask, recorded):
    """``[B]`` bool: the envs of ``mask`` whose agents' positions are, all
    of them, one of the env's rows of ``recorded`` (``recorded_rows``
    before the reset): the envs that started from a recorded state."""
    import torch

    rows, lengths = recorded
    pos = env.world.state.pos  # road_traffic: the agents only
    same = (rows[..., :2] == pos[:, None]).all(-1).all(-1)  # [B, S]
    valid = (torch.arange(rows.shape[1], device=rows.device)[None]
             < lengths[:, None])
    return mask & (same & valid).any(-1)


def replayed_state(env, steps=10, seed=5):
    """``env`` (road_traffic on map '2') after ``steps`` random steps and a
    masked reset of about half its envs; returns how many reset envs
    started from a recorded state."""
    import torch

    for a in random_actions(env, steps, seed=seed):
        env.step(a)
    recorded = recorded_rows(env)
    mask = torch.rand((env.num_envs,), device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(
                          seed)) > 0.5
    env.reset_at(mask)
    return int(replayed_envs(env, mask, recorded).sum())


def lidar_forms_equal(n_envs=1024, steps=3):
    """pollock with its LIDARs on the card: ``Lidar.measure(vectorized=
    False)`` (one ray-cast launch a ray) equal to the grouped measure (one
    launch for the 15 LIDARs) to the bit, after ``steps`` steps."""
    import torch

    env = make_path_env("pollock", n_envs)
    for a in random_actions(env, steps, seed=6):
        env.step(a)
    lidars = [a.sensors[0] for a in env.world.agents]
    with torch.no_grad():
        grouped = [x.measure() for x in lidars]
        single = [x.measure(vectorized=False) for x in lidars]
    same = all(torch.equal(a, b) for a, b in zip(grouped, single))
    hits = sum(int((a < 0.5).sum()) for a in grouped)
    log(f"[3] pollock@{n_envs} after {steps} steps: {len(lidars)} LIDARs of"
        f" 16 rays, one ray cast a ray against one launch for all, equal to"
        f" the bit: {same} ({hits} rays hit)")
    if not same or not hits:
        raise AssertionError("pollock: the ray-by-ray LIDAR measure differs"
                             " from the grouped one (or no ray hit)")


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
                     ("agent_geometry", "agent_geometry"),
                     ("pair_collisions_kernel", "pair_collisions"),
                     ("neighbor_obs_kernel", "neighbor_obs")):
        named[tag] = sum(e.time_range.elapsed_us() for e in device
                         if key in e.name) / 1e3 / n
    return wall, busy, 1.0 - busy / wall, len(device) / n, named


def road_rates(vmt, out):
    """rate_worker's "road" group into ``out``."""
    import torch
    from vectorizedmultiagentsimulator_tpu_torch.ops import road_geometry_cuda

    name, num_envs = AB_ROAD
    env = vmt.make_env(name, num_envs=num_envs, device="cuda", seed=0)
    actions = random_actions(env, N_STEPS, seed=7)
    out[f"{name}@{num_envs} env-steps/s"] = sum(
        timed_rollout(env, actions) for _ in range(2)) / 2
    (tables, pos, rot, pid), _ = road_inputs(env)
    for kernel, call in (
            ("agent_geometry", lambda: road_geometry_cuda.launch_agent_geometry(
                tables, True, pos, rot, pid)),
            ("pair_collisions", lambda: road_geometry_cuda.launch_pair_collisions(
                tables, pos, rot))):
        with torch.no_grad():
            for _ in range(3):
                call()
            out[f"{name}@{num_envs} {kernel} ms/call"] = cuda_time_ms(call,
                                                                      50)
            out[f"{name}@{num_envs} {kernel} device ms"] = device_ms(
                call, 20, kernel)
    nargs = road_inputs(env)[1]
    call = lambda: road_geometry_cuda.fused_neighbor_obs(*nargs)
    with torch.no_grad():
        for _ in range(3):
            call()
        out[f"{name}@{num_envs} neighbor_obs ms/call"] = cuda_time_ms(call,
                                                                      50)
        out[f"{name}@{num_envs} neighbor_obs device ms"] = device_ms(
            call, 20, "neighbor_obs_kernel")
    del env, actions, nargs, call


def rate_worker(root, groups=AB_GROUPS):
    """``--rate ROOT [GROUP,...]``: with the port package found at ROOT, for
    the groups named (AB_GROUPS by default): "joint", for each
    scenario of AB_SCENARIOS at 30k envs two N_STEPS-step rollouts'
    env-steps/s and the physics wrapper's time per call and its kernel's
    device time (back-to-back calls from the reset state); "road", for
    AB_ROAD two rollouts' env-steps/s and the agent-geometry, pair and
    neighbour wrappers' time per call and kernels' device time at the state
    they end in; "lidar", for AB_LIDAR two rollouts' env-steps/s and the ray cast's
    device ms and launches a step over 20 more steps; "football", for
    football 5v5@30k two rollouts' env-steps/s, then over PROFILE_STEPS
    more steps under the profiler the device busy ms, device kernels and
    planner kernel ms a step (the planner's launch and the small kernels
    around it); "train", for AB_TRAIN at the PPOConfig defaults, after one
    warm-up iteration, two iterations' update ms and whole-iteration ms
    (host clock, each ended by a synchronize); "ppo", for each hidden
    size of AB_PPO_HIDDEN one minibatch at transport@4096's shapes from
    random inputs (phase 2's), ms a call and device ms; one JSON line of
    {metric: value}."""
    sys.path.insert(0, os.path.abspath(root))
    sys.path.insert(1, os.path.join(ROOT, "tests"))
    import torch
    import vectorizedmultiagentsimulator_tpu_torch as vmt
    from vectorizedmultiagentsimulator_tpu_torch.examples import torch_ppo
    from vectorizedmultiagentsimulator_tpu_torch.ops import (
        physics_cuda,
        raycast_cuda,
        road_geometry_cuda,
    )

    assert vmt.__file__.startswith(os.path.abspath(root)), vmt.__file__
    out = {}
    for name in AB_SCENARIOS if "joint" in groups else ():
        env = vmt.make_env(name, num_envs=N_ENVS, device="cuda", seed=0)
        actions = random_actions(env, N_STEPS, seed=7)
        rates = [timed_rollout(env, actions) for _ in range(2)]
        w = env.world
        inputs = state_inputs(w)
        step = lambda: physics_cuda.fused_step(w, *inputs)
        with torch.no_grad():
            for _ in range(10):
                step()
            call_ms = cuda_time_ms(step, 200)
            dev_ms = device_ms(step, 20, "physics_step_kernel")
        out[f"{name} env-steps/s"] = sum(rates) / 2
        out[f"{name} physics ms/call"] = call_ms
        out[f"{name} physics device ms"] = dev_ms
        del env, actions, w, inputs, step
    if "road" in groups:
        road_rates(vmt, out)
    for name in AB_LIDAR if "lidar" in groups else ():
        env = vmt.make_env(name, num_envs=N_ENVS, device="cuda", seed=0)
        actions = random_actions(env, N_STEPS, seed=7)
        out[f"{name} env-steps/s"] = sum(
            timed_rollout(env, actions) for _ in range(2)) / 2
        # The ray cast's device ms and launches a step, over 20 steps.
        with torch.no_grad():
            before = raycast_cuda.LAUNCHES
            it = iter(actions[:20])
            out[f"{name} ray-cast device ms/step"] = device_ms(
                lambda: env.step(next(it)), 20, "cast_rays_kernel")
            out[f"{name} ray-cast launches/step"] = (
                raycast_cuda.LAUNCHES - before) / 20
        del env, actions
    if "football" in groups:
        env = vmt.make_env("football", num_envs=N_ENVS, device="cuda", seed=0,
                           **PATH_KWARGS["football"])
        actions = random_actions(env, N_STEPS, seed=7)
        out["football env-steps/s"] = sum(
            timed_rollout(env, actions) for _ in range(2)) / 2
        _, busy, _, n_kernels, named = profile_steps(
            env, actions[:PROFILE_STEPS], True)
        out["football device busy ms/step"] = busy
        out["football device kernels/step"] = n_kernels
        out["football planner device ms/step"] = named["planner"]
        del env, actions
    for hidden in AB_PPO_HIDDEN if "ppo" in groups else ():
        from vectorizedmultiagentsimulator_tpu_torch.ops import (
            ppo_update_cuda,
        )

        spec = ppo_spec(PPO_BUILDS["transport"][:3] + (hidden,))
        inputs = ppo_random_case(spec, 256, 20)
        call = lambda: ppo_update_cuda.minibatch_update(spec, *inputs)  # noqa: E731
        for _ in range(3):
            call()
        out[f"ppo hidden {hidden} ms/call"] = cuda_time_ms(call, 10)
        out[f"ppo hidden {hidden} device ms"] = device_ms(call, 5, "ppo_")
        del inputs
    if "train" not in groups:
        print(json.dumps(out), flush=True)
        return
    name, num_envs = AB_TRAIN
    _, _, tr = torch_ppo.init_training(name, num_envs, seed=0)
    tr.train_step()
    torch.cuda.synchronize()
    update_s = iteration_s = 0.0
    for _ in range(2):
        t0 = time.perf_counter()
        packed, _ = tr.collect()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        tr.update(packed)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        update_s += t2 - t1
        iteration_s += t2 - t0
    out[f"train {name}@{num_envs} update ms"] = update_s / 2 * 1e3
    out[f"train {name}@{num_envs} iteration ms"] = iteration_s / 2 * 1e3
    print(json.dumps(out), flush=True)


def ab(parent_root, pairs, groups=AB_GROUPS):
    """``--ab PARENT_ROOT [PAIRS [GROUP,...]]``: ``rate_worker``'s numbers
    for ``groups`` of this checkout's package against the one at
    PARENT_ROOT, one process each, in ``pairs`` alternating pairs (parent,
    change, change, parent, ...) on this card."""
    import statistics

    runs = {"parent": [], "change": []}
    for k in range(pairs):
        for who in (("parent", "change") if k % 2 == 0 else ("change", "parent")):
            root = parent_root if who == "parent" else ROOT
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--rate", root,
                 ",".join(groups)],
                capture_output=True, text=True, timeout=600, check=True,
            )
            got = json.loads(proc.stdout.strip().splitlines()[-1])
            runs[who].append(got)
            log(f"[ab] pair {k} {who}: "
                + ", ".join(f"{m} {v:.6g}" for m, v in got.items()))
    summary = {}
    for metric in runs["change"][0]:
        row = {}
        for who, got in runs.items():
            vals = [g[metric] for g in got]
            row[who] = {"median": statistics.median(vals), "min": min(vals),
                        "max": max(vals)}
        higher = metric.endswith("/s")
        row["pairs_change_better"] = sum(
            (c[metric] > p[metric]) if higher else (c[metric] < p[metric])
            for c, p in zip(runs["change"], runs["parent"]))
        summary[metric] = row
    print(json.dumps({"ab_pairs": pairs, "summary": summary}), flush=True)


def ppo_spec(shape, lb=4096, mb=262144, norm_n=0):
    """The PPOUpdateSpec of a PPO_BUILDS shape at the PPOConfig defaults."""
    from vectorizedmultiagentsimulator_tpu_torch.ops import ppo_update_cuda

    od, aw, nl, hidden = shape
    return ppo_update_cuda.PPOUpdateSpec(
        obs_d=od, act_w=aw, hidden=hidden, lb=lb, mb=mb, clip_eps=0.2,
        vf_coef=0.5, ent_coef=0.01, n_logits=nl, norm_n=norm_n)


def train_spec(name, num_envs, rollout_steps=64, hidden=64):
    """The spec of init_training(name, num_envs) at the PPOConfig defaults
    with ``rollout_steps``-step rollouts and a ``hidden``-wide trunk: 4
    minibatches an epoch."""
    n_agents = {path[0]: path[2] for path in MAIN_PATHS}[name]
    return ppo_spec(PPO_BUILDS[name][:3] + (hidden,),
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


def train_path(name, num_envs, rollout_steps, iters, casts_per_step, hidden):
    """``iters`` training iterations of init_training(name, num_envs) with a
    ``hidden``-wide trunk on the card with no host sync; returns the (PPO,
    physics, ray-cast) launches counted in that run."""
    import torch
    from vectorizedmultiagentsimulator_tpu_torch.examples import torch_ppo
    from vectorizedmultiagentsimulator_tpu_torch.ops import (
        physics_cuda,
        ppo_update_cuda,
        raycast_cuda,
    )

    cfg = torch_ppo.PPOConfig(rollout_steps=rollout_steps, hidden=hidden)
    env, train_step, trainer = torch_ppo.init_training(name, num_envs, seed=0,
                                                       cfg=cfg)
    assert trainer.fused and env.world._use_kernel, f"{name}: not on the kernels"
    assert trainer.spec == train_spec(name, num_envs, rollout_steps,
                                      hidden), trainer.spec
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
    log(f"[3] train {name}@{num_envs} hidden {hidden}: {iters} iterations of"
        f" {rollout_steps} steps x {cfg.epochs} epochs x {cfg.minibatches}"
        f" minibatches of"
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


def ppo_layout(spec):
    from vectorizedmultiagentsimulator_tpu_torch.ops import ppo_update_cuda

    tile, global_sums, global_weights, global_tiles, cluster = (
        ppo_update_cuda.layout(spec))
    where = lambda g: "device" if g else "shared"  # noqa: E731
    return (f"tile {tile}, sums in {where(global_sums)} memory, trunk"
            f" weights in {where(global_weights)} memory, activation tiles"
            f" in {where(global_tiles)} memory,"
            f" {ppo_update_cuda.blocks_per_sm(spec)} block(s) an SM,"
            f" {cluster} block(s) a tile")


def ppo_real_case(name, num_envs, steps, hidden):
    """The spec and one minibatch's inputs of init_training(name, num_envs)
    with a ``hidden``-wide trunk: a real ``steps``-step rollout's packed
    columns, a shuffle of its blocks, its advantage statistics and the
    trainer's parameters."""
    import torch
    from vectorizedmultiagentsimulator_tpu_torch.examples import torch_ppo

    env, _, trainer = torch_ppo.init_training(
        name, num_envs, seed=0,
        cfg=torch_ppo.PPOConfig(rollout_steps=steps, hidden=hidden))
    spec = trainer.spec
    packed, _ = trainer.collect()
    nb_tot, nbm = trainer.n // spec.lb, spec.mb // spec.lb
    perm = torch.randperm(
        nb_tot, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(9),
    )[:nbm].to(torch.int32)
    adv = packed[spec.obs_d + spec.act_w + 1].reshape(
        nb_tot, spec.lb)[perm.long()]
    stats = torch.stack([adv.mean(), 1.0 / (adv.std(unbiased=False) + 1e-8)])
    return spec, (packed, perm, stats, trainer.model.kernel_params())


def ppo_times(spec, inputs, label):
    """A launch's time (CUDA events over back-to-back calls), its device
    time (the update and reduce kernels, profiler), the plain version's
    time, the bound and the line of every product at the fp32 rate, all
    printed; returns them as a dict."""
    from vectorizedmultiagentsimulator_tpu_torch.ops import ppo_update_cuda

    call = lambda: ppo_update_cuda.minibatch_update(spec, *inputs)
    plain = lambda: ppo_update_cuda.minibatch_update_plain(spec, *inputs)
    for _ in range(3):
        call()
        plain()
    ms = cuda_time_ms(call, 20)
    dev_ms = device_ms(call, 5, "ppo_")
    plain_ms = cuda_time_ms(plain, 5)
    bound_ms, by, fp32_ms = ppo_bound_ms(spec, inputs)
    log(f"[2] ppo update at {label} (one minibatch of {spec.mb} samples,"
        f" hidden {spec.hidden}, {ppo_layout(spec)}): kernel {ms:.4f} ms a"
        f" launch (CUDA events), {dev_ms:.4f} ms device time (update and"
        f" reduce kernels), plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms"
        f" ({by}; trunk products at the bf16 tensor-core rate, the rest at"
        f" the fp32 rate), {fp32_ms:.5f} ms if every product ran at the fp32"
        f" rate")
    return {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by, "fp32_rate_ms": fp32_ms}


def ppo_phase_2(errs):
    """Phase 2 for the PPO kernel; returns the times of transport@4096's
    minibatch, of the same at hidden 256, and of each PPO_GLOBAL_TILES
    width's real minibatch (``ppo_times``)."""
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
    for key in PPO_WIDE:
        spec = ppo_spec(PPO_BUILDS[key])
        cases.append((f"{key} ({ppo_layout(spec)})", spec, 256))
    # Every training run of the later phases, at its own shapes.
    runs = [(name, num_envs, steps, hidden)
            for name, num_envs, steps, _, _, hidden in TRAIN_PATHS]
    runs += [(name, num_envs, 64, 64) for name, num_envs in TRAIN_CELLS]
    for name, num_envs, steps, hidden in runs:
        spec = train_spec(name, num_envs, steps, hidden)
        if all(spec != case[1] for case in cases):
            cases.append((f"{name}@{num_envs}, {steps} steps, hidden {hidden}",
                          spec, 4 * spec.mb // spec.lb))
    timed = None
    for seed, (label, spec, nb_tot) in enumerate(cases):
        inputs = ppo_random_case(spec, nb_tot, 20 + seed)
        errs.append(ppo_vs_plain(spec, inputs, label))
        if timed is None:
            timed = inputs
        if spec == ppo_spec(PPO_BUILDS["transport hidden 256"]):
            wide = ppo_times(spec, inputs, f"transport@4096 hidden 256")
        elif spec.hidden > 64:
            wide_ms = cuda_time_ms(
                lambda: ppo_update_cuda.minibatch_update(spec, *inputs), 5)
            log(f"[2] ppo update {label}: kernel {wide_ms:.4f} ms a launch of"
                f" {spec.mb} samples, {ppo_bound_ms(spec, inputs)[2]:.5f} ms at"
                f" the fp32 rate")
        del inputs
    # The packed rollout of a real rollout of each training path of phase 3,
    # with its own parameters and statistics.
    for name, num_envs, steps, _, _, hidden in TRAIN_PATHS:
        spec, inputs = ppo_real_case(name, num_envs, steps, hidden)
        assert spec == train_spec(name, num_envs, steps, hidden), spec
        errs.append(ppo_vs_plain(
            spec, inputs, f"{name}@{num_envs} hidden {hidden}, a real"
            f" {steps}-step rollout"))
        del inputs
    # Past hidden 1,040 (activation tiles in device memory): a real
    # rollout of transport@256 over 16 steps (one minibatch of 4096
    # samples) with the trainer's own initial parameters.
    global_tiles = {}
    for hidden in PPO_GLOBAL_TILES:
        spec, inputs = ppo_real_case("transport", 256, 16, hidden)
        assert ppo_update_cuda.layout(spec)[3], ppo_layout(spec)
        errs.append(ppo_vs_plain(
            spec, inputs, f"transport@256 hidden {hidden} ({ppo_layout(spec)}),"
            " a real 16-step rollout"))
        global_tiles[hidden] = ppo_times(spec, inputs,
                                         f"transport@256 hidden {hidden}")
        del inputs

    return (ppo_times(transport, timed, "transport@4096"), wide,
            global_tiles)


def planner_bound_ms(p, B):
    """The least time of one planner call on the H100: each operand the
    kernel reads read once (agents_pos, curr_target, the normals, the
    ball's and nets' positions, the value noise) and the best positions
    written once over the memory rate, or its arithmetic (PLANNER_OPS: each
    candidate, each other teammate of each candidate) over the fp32 rate;
    returns (ms, "bytes" | "operations")."""
    T, S = p.T, p.S
    floats = 2 * T + 2 * T + 2 * T * S + 6 + 2 * T
    if p.has_noise:
        floats += T * (S + 1)
    ops = B * T * (S + 1) * (PLANNER_OPS["candidate"]
                             + PLANNER_OPS["pair"] * (T - 1))
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
    5 teammates with and without value noise, a third of the envs with
    exact ties (torch_helpers.tied_planner_inputs), the draws scaled in the
    kernel, curr_target, the ball and the nets strided views (torch_helpers.
    strided_planner_views), then ``real_inputs`` (the
    football path's after 10 steps); returns the latter's (ms, plain_ms,
    bound_ms, by)."""
    import torch
    from torch_helpers import (
        planner_fields,
        random_planner_inputs,
        strided_planner_views,
        tied_planner_inputs,
    )
    from vectorizedmultiagentsimulator_tpu_torch.ops import (
        football_policy_cuda as fpc,
    )

    for T in (1, 3, 5):
        for noise in (False, True):
            p = fpc.PlannerParams(**planner_fields(T, has_noise=noise),
                                  sigma=0.55, spread=1.3, noise_scale=0.1)
            inputs = [
                None if x is None else torch.as_tensor(x, device="cuda")
                for x in tied_planner_inputs(random_planner_inputs(
                    N_ENVS, T, 2, noise, seed=T))
            ]
            errs.append(planner_vs_plain(
                p, strided_planner_views(inputs),
                "random inputs with exact ties, strided views")[0])
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
    path vertices) no index may move and no flag flip, with ``exact ==
    "index"`` (poses where culling is tight) no index may move.  Returns
    the largest |kernel - plain| of each kernel's outputs."""
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
        symmetric = torch.equal(got[9], got[9].transpose(1, 2))

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
        f" and collision-free launches bit-identical: {same}; pair matrix"
        f" equal to its transpose: {symmetric}")
    exact_ok = not exact or report["moved"] == 0
    if exact is True:
        exact_ok = exact_ok and (report["flipped"] == 0
                                 and torch.equal(got[0], ref[0])
                                 and torch.equal(got[4], ref[4]))
    if report["bad"] or not same or not exact_ok or not symmetric:
        raise AssertionError(
            f"{label}: road geometry kernels disagree with plain ({report},"
            f" repeat identical {same}, exact {exact_ok}, symmetric"
            f" {symmetric})")
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


def culled_work(tables, pos, rot, path_id, lanes):
    """What csrc/road_geometry.cu's chunk rule leaves of the agent kernel's
    work (with collisions) for these poses, reckoned from the chunk boxes
    at ``lanes`` with the kernel's rule: for each polyline the chunk whose
    box is nearest the agent's centre gives D_v, the least distance of
    each point v over its segments; on the centre line a chunk is kept
    when its box lies within D + 1e-5 + 1e-4 of the centre, on a boundary
    when the agent's box meets it (both grown by 1e-4) or some point v
    lies within D_v + 1e-5 + 1e-4 of it (tested only where the agent's box
    does).  Returns [B, A] counts: "seg_c" and "seg_b", the real segments
    of the kept chunks of the centre line and of both boundaries; "box"
    and "gap", the box tests (a few decisions that differ at the margin
    from the kernel's do not matter to a count)."""
    import torch
    from vectorizedmultiagentsimulator_tpu_torch.ops import road_geometry as rg
    from vectorizedmultiagentsimulator_tpu_torch.ops import (
        road_geometry_cuda as rgc,
    )

    tol = 1e-5 + 1e-4
    boxes = rgc.lane_boxes(tables, lanes)
    B, A = pos.shape[:2]
    N, G = B * A, lanes
    pid = path_id.reshape(N).long()
    verts = rg.get_rectangle_vertices(pos, rot, tables.width, tables.length)
    pts = torch.cat([pos[:, :, None], verts[..., :4, :]], dim=2).reshape(
        N, 5, 2)
    rbox = torch.cat([pts.amin(1), pts.amax(1)], dim=-1)  # [N, 4]
    out = {k: torch.zeros(N, device=pos.device)
           for k in ("seg_c", "seg_b", "box", "gap")}
    C = boxes.shape[2]
    c_idx = torch.arange(C, device=pos.device)
    for r, (table, counts) in enumerate((
            (tables.center, tables.n_points), (tables.left, tables.n_left),
            (tables.right, tables.n_right))):
        n_seg = torch.clamp_min(counts[pid].long() - 1, 1)  # [N]
        nch = (n_seg + G - 1) // G
        valid = c_idx[None] < nch[:, None]  # [N, C]
        bx = boxes[pid, r]  # [N, C, 4]
        p = pts[:, :1] if r == 0 else pts  # [N, V, 2]
        x, y = p[..., 0, None], p[..., 1, None]
        dx = torch.clamp_min(torch.maximum(bx[:, None, :, 0] - x,
                                           x - bx[:, None, :, 2]), 0)
        dy = torch.clamp_min(torch.maximum(bx[:, None, :, 1] - y,
                                           y - bx[:, None, :, 3]), 0)
        L = torch.sqrt(dx * dx + dy * dy).masked_fill(~valid[:, None],
                                                      torch.inf)
        c0 = L[:, 0].argmin(-1)  # [N]
        first = c0 * G
        idx = torch.clamp(first[:, None] + torch.arange(
            G + 1, device=pos.device)[None], max=table.shape[1] - 1)
        rows = table[pid[:, None], idx]  # [N, G + 1, 2]
        n_pts = torch.clamp(n_seg - first, max=G) + 1
        D, _ = rg.get_perpendicular_distances(
            p, rows[:, None].expand(-1, p.shape[1], -1, -1),
            n_pts[:, None].expand(-1, p.shape[1]))
        lim = (D + tol)[..., None]  # [N, V, 1]
        is_c0 = c_idx[None] == c0[:, None]
        if r == 0:
            keep = (L[:, 0] <= lim[:, 0]) | is_c0
            out["box"] += 2 * nch
        else:
            meet = ((rbox[:, None, 0] - 1e-4 <= bx[..., 2] + 1e-4)
                    & (bx[..., 0] - 1e-4 <= rbox[:, None, 2] + 1e-4)
                    & (rbox[:, None, 1] - 1e-4 <= bx[..., 3] + 1e-4)
                    & (bx[..., 1] - 1e-4 <= rbox[:, None, 3] + 1e-4))
            gx = torch.clamp_min(torch.maximum(bx[..., 0] - rbox[:, None, 2],
                                               rbox[:, None, 0] - bx[..., 2]),
                                 0)
            gy = torch.clamp_min(torch.maximum(bx[..., 1] - rbox[:, None, 3],
                                               rbox[:, None, 1] - bx[..., 3]),
                                 0)
            near = torch.sqrt(gx * gx + gy * gy) <= lim.amax(1)
            tested = valid & ~is_c0 & ~meet & near
            keep = is_c0 | (valid & (meet | (tested
                                             & (L <= lim).any(1))))
            out["box"] += nch + 5 * tested.sum(-1)
            out["gap"] += nch - 1
        segs = torch.clamp(n_seg[:, None] - c_idx[None] * G, 0, G)
        out["seg_c" if r == 0 else "seg_b"] += (segs * (keep & valid)).sum(-1)
    return {k: v.reshape(B, A) for k, v in out.items()}


def road_bounds_ms(tables, pos, rot, path_id, neighbor_args):
    """The least time of each road kernel's call on the H100 for these
    inputs, (ms, "bytes" | "operations") each, and for the agent and pair
    kernels also the every-segment count's (``all_segments``): every
    operand read once and every output written once, the path tables and
    chunk boxes once; the operations (ROAD_OPS) this data needs.  Agent
    geometry: the rectangle and its box, K short-term points, the box tests
    and the real segments of the chunks culled_work keeps at the kernel's
    lane group, each centre-line segment's distance once, 5 points' against
    each kept boundary segment and, with collisions, 4 edges' crossing
    tests (one test where an edge crosses, which only lowers the bound), 8
    entry/exit tests on paths that are not loops; every real segment in
    the every-segment count.  Pair: each agent's rectangle and its box,
    each unordered pair's box test, and 16 crossing tests (1 where they
    cross) where the boxes meet; every pair's 16 in the every-segment
    count.  Neighbour: k rounds of A compares and a neighbour's work."""
    import torch
    from vectorizedmultiagentsimulator_tpu_torch.ops import road_geometry as rg

    O = ROAD_OPS
    B, A = pos.shape[:2]
    with torch.no_grad():
        pid = path_id.long()
        ref = rg.geometry_plain(tables, True, pos, rot, path_id)
        lane = ref[6] > 0.5
        work = culled_work(tables, pos, rot, path_id, tables.struct.lanes)
        fixed = O["rect"] + O["bounds"] + tables.K * O["short"]
        if tables.entry_exit:
            fixed = fixed + (~tables.is_loop[pid]).long() * 8 * O["cross"]
        ops = (work["seg_c"] * O["seg"] + work["seg_b"] * 5 * O["seg"]
               + torch.where(lane, 1, work["seg_b"] * 4) * O["cross"]
               + work["box"] * O["box"] + work["gap"] * O["gap"] + fixed)
        seg_c = torch.clamp_min(tables.n_points[pid].long() - 1, 1)
        seg_b = (torch.clamp_min(tables.n_left[pid].long() - 1, 1)
                 + torch.clamp_min(tables.n_right[pid].long() - 1, 1))
        ops_all = (seg_c * O["seg"] + seg_b * 5 * O["seg"]
                   + torch.where(lane, 1, seg_b * 4) * O["cross"] + fixed)
        table_bytes = sum(x.numel() * x.element_size()
                          for x in tables.kernel_tensors)
        moved = B * A * (16 + 4 * (1 + 5 + 5 + 1 + 2 * tables.K + 3))
        agent = bound(moved + table_bytes, float(ops.sum()))
        agent_all = bound(moved + table_bytes, float(ops_all.sum()))
        # Each unordered pair once: the upper triangle.
        upper = torch.triu(torch.ones((A, A), dtype=torch.bool,
                                      device=pos.device), diagonal=1)
        hits = int((ref[9] > 0.5)[:, upper].sum())
        v = ref[5][..., :4, :]
        lo, hi = v.amin(2), v.amax(2)  # [B, A, 2]
        meet = ((lo[:, :, None] - 1e-4 <= hi[:, None] + 1e-4)
                & (lo[:, None] - 1e-4 <= hi[:, :, None] + 1e-4)).all(-1)
        met = int(meet[:, upper].sum())
        n_pairs = B * A * (A - 1) // 2
        pair_bytes = B * A * (12 + 4 * (10 + A))
        pair = bound(pair_bytes, B * A * (O["rect"] + O["bounds"])
                     + n_pairs * O["meet"]
                     + O["cross"] * (16 * (met - hits) + hits))
        pair_all = bound(pair_bytes, B * A * O["rect"]
                         + O["cross"] * (16 * (n_pairs - hits) + hits))
    k = neighbor_args[1]
    neighbor = bound(B * A * (20 + 4 * A) + B * A * k * 14 * 4,
                     B * A * (3 + k * (A + O["neighbor"])))
    log(f"[2] road bounds at B={B} A={A}: agent geometry, per agent, kept"
        f" segments {float(work['seg_c'].float().mean()):.2f} of"
        f" {float(seg_c.float().mean()):.2f} on the centre line and"
        f" {float(work['seg_b'].float().mean()):.2f} of"
        f" {float(seg_b.float().mean()):.2f} on the boundaries, box tests"
        f" {float((work['box'] + work['gap']).float().mean()):.2f},"
        f" {float(ops.float().mean()):.1f} operations (every segment"
        f" {float(ops_all.float().mean()):.1f}); pair: {met} of {n_pairs}"
        f" pairs' boxes meet, {hits} cross")
    return {"agent_geometry": agent + (agent_all[0],),
            "pair_collisions": pair + (pair_all[0],),
            "neighbor_obs": neighbor + (None,)}


def road_phase_2(errs):
    """Phase 2 for the road kernels: the cases of the docstring; returns
    {kernel: (ms, plain_ms, bound_ms, bound_by, bound_all_segments_ms,
    device_ms)} at road_traffic@10k after 10 steps, the main path's inputs,
    and the agent kernel's ms a launch at each layout, {(lanes, staged,
    cull): (CUDA events ms, device ms)}."""
    import numpy as np
    import torch
    from torch_helpers import (
        poses_at_chunk_margins,
        poses_at_path_ends,
        poses_near_path_ends,
        poses_near_self,
        random_map_poses,
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
        errs["geometry"].append(geometry_vs_plain(
            *(tables,) + random_map_poses(tables, envs, tables.A, seed=7),
            f"{label} random-map poses (uniform over the map, random"
            f" headings and path ids)"))
        if not tag:
            # Where culling is tight, at each lane group's chunks: a
            # point on a chunk's box or a few margins from it, and a path
            # passing near itself; no closest index may move.
            for lanes in rgc.LANE_GROUPS:
                with rgc.agent_variant(tables, lanes=lanes):
                    errs["geometry"].append(geometry_vs_plain(
                        *(tables,) + poses_at_chunk_margins(
                            tables, lanes, 1024, tables.A, seed=lanes),
                        f"{label} {lanes} lanes, poses at chunk margins",
                        exact="index"))
            errs["geometry"].append(geometry_vs_plain(
                *(tables,) + poses_near_self(tables, 1024, tables.A, seed=9),
                f"{label} poses where a path passes near itself",
                exact="index"))
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
    # Map '2' after a reset that replayed recorded states: the replayed
    # poses, path and point ids feed the kernels, whose every output must be
    # the plain version's bits.
    env = make_path_env("road_traffic_map2", envs)
    n_replayed = replayed_state(env)
    label = (f"road_traffic@{envs} map '2' after a reset ({n_replayed} envs"
             f" replayed a recorded state)")
    (tables, pos, rot, pid), nargs = road_inputs(env)
    replay_errs = geometry_vs_plain(tables, pos, rot, pid, label)
    replay_errs += (neighbors_vs_plain(nargs, label),)
    errs["geometry"].append(replay_errs[:2])
    errs["neighbor_obs"].append(replay_errs[2])
    if not n_replayed or any(replay_errs):
        raise AssertionError(f"{label}: no replay, or the road kernels are"
                             f" not bit-equal to their plain versions"
                             f" ({replay_errs})")
    del env
    # Random inputs at A = 6 to 64 (past 32 a lane takes two agents), and
    # the same with every other env's dn on a grid of 0.5, so that rounds
    # meet ties.
    for A in (6, 20, 33, 64):
        pos_, rot_, vel_, dn_ = random_neighbor_inputs(envs, A, seed=6)
        tied = dn_.copy()
        tied[::2] = np.round(tied[::2] * 2) / 2
        for k in (1, 2):
            for d, tag in ((dn_, ""), (tied, ", half the envs with ties")):
                inputs = [torch.as_tensor(x, device="cuda")
                          for x in (pos_, rot_, vel_, d)]
                errs["neighbor_obs"].append(neighbors_vs_plain(
                    (A, k, 0.08, 0.04, *inputs),
                    f"random inputs at {envs}, A={A} k={k}{tag}"))

    tables, pos, rot, pid, nargs = main_inputs
    agent_call = lambda: rgc.launch_agent_geometry(tables, True, pos, rot,
                                                   pid)
    calls = {
        "agent_geometry": (
            agent_call,
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
            dev_ms = device_ms(call, 10, name)
            plain_ms = cuda_time_ms(plain, 10)
            bound_ms, by, all_ms = bounds[name]
            times[name] = (ms, plain_ms, bound_ms, by, all_ms, dev_ms)
            log(f"[2] {name} kernel at road_traffic@{envs} after 10 steps:"
                f" {ms:.5f} ms a call (CUDA events), {dev_ms:.5f} ms device,"
                f" plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({by})"
                + ("" if all_ms is None else
                   f", every-segment bound {all_ms:.5f} ms"))
        # The agent kernel's layouts at the same inputs: ms a launch (CUDA
        # events over 30 back-to-back launches, and the profiler's device
        # time, which can drop events) at each lane group, tables through
        # L1 and staged in shared memory, with chunk culling and without
        # (the lane groups alone).
        layouts = {}
        for lanes in rgc.LANE_GROUPS:
            for staged in (False, True):
                for cull in (True, False):
                    with rgc.agent_variant(tables, lanes=lanes, cull=cull,
                                           staged=staged):
                        for _ in range(2):
                            agent_call()
                        layouts[(lanes, staged, cull)] = (
                            cuda_time_ms(agent_call, 30),
                            device_ms(agent_call, 10, "agent_geometry"))
            log(f"[2] agent_geometry kernel at road_traffic@{envs} after 10"
                f" steps, {lanes} lanes an agent, ms a launch (CUDA events /"
                f" device): tables through L1"
                f" %.5f / %.5f culled, %.5f / %.5f every segment; staged in"
                f" shared memory %.5f / %.5f culled, %.5f / %.5f every"
                f" segment" % (layouts[(lanes, False, True)]
                               + layouts[(lanes, False, False)]
                               + layouts[(lanes, True, True)]
                               + layouts[(lanes, True, False)]))
    return times, layouts


def graph_vs_eager(path, envs, steps=GRAPH_STEPS, trace=True):
    """The graph rollout (parallel/rollout.py on the card) against the eager
    loop from one state and one generator state each: make_env(path) after
    3 random steps, ``rollout(env, n_steps=steps, generator=g)`` twice in a
    row (a capture and a replay, then a replay from the graph's own final
    state), against ``graph=False`` twice from the same start.  Every
    collected output, the final states and both generators' states must be
    equal to the bit (the second calls agree only if each replay draws the
    numbers the eager loop draws next).  The kernels each replay runs, the
    kernel nodes of the captured graph counted by name
    (torch_helpers.graph_kernels), must be the path's launches a step
    (MAIN_PATHS) times ``steps``, and with ``trace`` a third graph call's
    profiler trace (torch_helpers.traced_launches) must show each of those
    kernels run on the card, no more often (the profiler now and then
    drops a kernel's record of a replay, so its count is shown, not held
    equal);
    the wrappers' host counts, set to 0 just before the graph calls and
    read just after, must be the capture's: its warm-up step and its
    ``steps`` steps, each with the path's launches.  Returns (host counts,
    replayed kernels a step)."""
    import torch
    from torch_helpers import graph_kernels, kept_graphs, traced_launches
    from vectorizedmultiagentsimulator_tpu_torch import ops
    from vectorizedmultiagentsimulator_tpu_torch.parallel import rollout
    from vectorizedmultiagentsimulator_tpu_torch.parallel.rollout import (
        _flatten,
        _tensors,
    )

    name, _, _, _, casts, plans, road = path
    label = f"{name}@{envs}"
    env = make_path_env(name, envs)
    for a in random_actions(env, 3, seed=1):
        env.step(a)
    if recorded_rows(env) is not None:
        # Map '2': the rollouts start after a reset that replayed states.
        label += f" ({replayed_state(env)} envs replayed a recorded state)"
    w = env.world
    start, world_rng = w.state.clone(), w.generator.get_state()
    g = torch.Generator(device="cuda").manual_seed(5)
    policy_rng = g.get_state()
    torch.cuda.synchronize()
    runs = {}
    with kept_graphs():
        for graph in (True, False):
            w.bind(start.clone())
            w.generator.set_state(world_rng)
            g.set_state(policy_rng)
            runs[graph] = []

            def call():
                traj = rollout(env, n_steps=steps, generator=g,
                               graph=graph)[1]
                runs[graph].append((_flatten(traj)[0], w.state.clone(),
                                    w.generator.get_state(), g.get_state()))

            if graph:
                ops.set_launch_counts(dict.fromkeys(ops.launch_counts(), 0))
            call()
            call()
            if graph:
                counts = {k: n for k, n in ops.launch_counts().items() if n}
        # What a replay runs: the kernel nodes of the graph, by name.
        (captured_graph,) = env._rollout_graphs.values()
        replayed = {k: n / steps
                    for k, n in graph_kernels(captured_graph.graph).items()}
        # And what the profiler sees of one more graph call (the most of
        # three traces).
        traced = {k: n / steps for k, n in traced_launches(
            lambda: rollout(env, n_steps=steps, generator=g)).items()
        } if trace else None
    env._rollout_graphs.clear()
    unequal = []
    for k, ((gl, gs, gr, gp), (el, es, er, ep)) in enumerate(
            zip(runs[True], runs[False])):
        unequal += [f"call {k} output {i}" for i, (x, y) in
                    enumerate(zip(gl, el)) if not torch.equal(x, y)]
        unequal += [f"call {k} state {f}" for f, x in _tensors(gs).items()
                    if not torch.equal(x, _tensors(es)[f])]
        if not torch.equal(gr, er):
            unequal.append(f"call {k} world generator state")
        if not torch.equal(gp, ep):
            unequal.append(f"call {k} policy generator state")
    expected = {"physics_step": int(name not in PLAIN_ROUTE), "raycast": casts,
                "football_policy": plans,
                "agent_geometry": road[0], "pair_collisions": road[1],
                "neighbor_obs": road[2]}
    expected = {k: n for k, n in expected.items() if n}
    captured = {k: n * (steps + 1) for k, n in expected.items()}
    log(f"[6] {label}: graph vs eager over 2 x {steps} steps,"
        f" {len(runs[True][0][0])} outputs a call: equal to the bit"
        f" {not unequal} (differ: {unequal[:4]}), kernels a replayed step"
        f" (graph nodes) {replayed}, (profiler trace) {traced}, host launch"
        f" counts of the capture {counts}")
    if (unequal or replayed != expected or counts != captured
            or (trace and (traced.keys() != expected.keys() or any(
                n > expected[k] for k, n in traced.items())))):
        raise AssertionError(
            f"{label}: the graph rollout differs from the eager loop"
            f" ({unequal[:8]}), or a replayed step ran {replayed} kernels"
            f" ({traced} in the profiler trace), not {expected}, or the"
            f" capture counted {counts}, not {captured}")
    return counts, replayed


def graph_rates(name, envs):
    """GRAPH_RATE_STEPS-step rollouts (default policy, nothing collected)
    eager and as a graph, in turns (eager, graph, graph, eager) after a
    warm-up of each: env-steps/s; the graph's capture time and peak memory; then
    PROFILE_STEPS graph steps under torch.profiler: wall ms a step (CUDA
    events, without the profiler), device busy ms a step, idle share,
    device kernels a step, and the port's kernels a replayed step (by name
    in the trace)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from torch_helpers import KERNEL_NAMES
    from vectorizedmultiagentsimulator_tpu_torch.parallel import rollout

    env = make_path_env(name, envs)
    run = lambda graph, n=GRAPH_RATE_STEPS: rollout(  # noqa: E731
        env, n_steps=n, collect=(), graph=graph)
    run(False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run(True)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    rates = {True: [], False: []}
    for graph in (False, True, True, False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(graph)
        torch.cuda.synchronize()
        rates[graph].append(
            envs * GRAPH_RATE_STEPS / (time.perf_counter() - t0))
    run(True, PROFILE_STEPS)
    wall = cuda_time_ms(lambda: run(True, PROFILE_STEPS), 3) / PROFILE_STEPS
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(True, PROFILE_STEPS)
        torch.cuda.synchronize()
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in device) / 1e3 / PROFILE_STEPS
    launches = {k: sum(key in e.name for e in device) / PROFILE_STEPS
                for k, key in KERNEL_NAMES.items()}
    launches = {k: n for k, n in launches.items() if n}
    out = {"eager": rates[False], "graph": rates[True], "capture_s": capture_s,
           "peak_gib": peak, "wall_ms": wall, "busy_ms": busy,
           "idle": 1.0 - busy / wall if device else None,
           "kernels": len(device) / PROFILE_STEPS, "launches": launches}
    log(f"[6] {name}@{envs} {GRAPH_RATE_STEPS}-step rollout env-steps/s:"
        " eager"
        f" {rates[False][0]:.6g} {rates[False][1]:.6g}, graph"
        f" {rates[True][0]:.6g} {rates[True][1]:.6g}; capture {capture_s:.2f}"
        f" s, peak {peak:.3f} GiB; graph {PROFILE_STEPS} steps: wall"
        f" {wall:.4f} ms/step, device busy {busy:.4f} ms/step, idle share"
        + (f" {out['idle']:.4f}" if device else " not measured (no device"
           " events in the trace)")
        + f", {out['kernels']:.1f} device kernels/step, launches a replayed"
        f" step (profiler trace) {launches}")
    return out


def graph_rate(name, envs, steps):
    """The cost of the env's construction (make_env with its first reset:
    seconds and peak memory) and of a masked reset of about half the envs
    (ms, CUDA events over 3, and peak memory); then the graph rollout's
    env-steps/s alone: a ``steps``-step rollout (default policy, nothing
    collected) captured, then replayed twice; the capture's time and peak
    memory."""
    import torch
    from vectorizedmultiagentsimulator_tpu_torch.parallel import rollout

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    env = make_path_env(name, envs)
    torch.cuda.synchronize()
    make_s = time.perf_counter() - t0
    make_peak = torch.cuda.max_memory_allocated() / 2**30
    mask = torch.rand((envs,), device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(4)
                      ) > 0.5
    torch.cuda.reset_peak_memory_stats()
    reset_ms = cuda_time_ms(lambda: env.reset_at(mask), 3)
    reset_peak = torch.cuda.max_memory_allocated() / 2**30
    run = lambda: rollout(env, n_steps=steps, collect=())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    rates = []
    for _ in range(2):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        rates.append(envs * steps / (time.perf_counter() - t0))
    log(f"[6] {name}@{envs}: make_env {make_s:.2f} s, peak {make_peak:.3f}"
        f" GiB; masked reset of {int(mask.sum())} envs"
        f" {reset_ms:.3f} ms, peak {reset_peak:.3f} GiB; {steps}-step graph"
        f" rollout env-steps/s {rates[0]:.6g} {rates[1]:.6g}; capture"
        f" {capture_s:.2f} s, peak {peak:.3f} GiB")
    env._rollout_graphs.clear()
    return rates


def port_bench():
    """``python -m vectorizedmultiagentsimulator_tpu_torch.bench`` once
    (transport@30k, bench.py's workload); returns its JSON result."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "vectorizedmultiagentsimulator_tpu_torch.bench"],
        cwd=ROOT, capture_output=True, text=True, timeout=600, check=True)
    lines = proc.stdout.strip().splitlines()
    result = json.loads(lines[-1])
    if set(result) != {"metric", "value", "unit", "vs_baseline"} or not (
            result["value"] > 0):
        raise AssertionError(f"port bench printed {lines[-1]!r}")
    log(f"[6] port bench ({time.perf_counter() - t0:.1f} s): {lines[0]};"
        f" {lines[-1]}")
    return result


# --------------------------------------------------------------------- #
# Phase 7: the edges (wrappers, frames, checkpoints) on the card
# --------------------------------------------------------------------- #
# The scenes of each part, at their main paths' widths (PATH_ENVS).
EDGE_WRAP_SCENES = ("transport", "navigation", "football")
EDGE_FRAME_SCENES = ("navigation", "football", "road_traffic",
                     "joint_passage")
EDGE_CKPT_SCENES = ("transport", "road_traffic_map2")
# The other scenarios that draw with an extra_render (or hide eaten food),
# one frame each at FRAME_SMALL_ENVS envs against the CPU's.
EDGE_FRAME_OTHERS = ("discovery", "multi_give_way", "passage",
                     "ball_passage", "joint_passage_size", "ball_trajectory",
                     "asym_joint", "simple_tag", "drone", "diff_drive",
                     "kinematic_bicycle", "line_trajectory",
                     "circle_trajectory", "wind_flocking", "sampling",
                     "dispersion")
EDGE_STEPS = 10
CKPT_STEPS = 20
# A frame's time at the main path's envs and at this many.
FRAME_SMALL_ENVS = 64


def load_rows(dst, src, n):
    """``dst``'s state := the first ``n`` envs of ``src``'s, and ``dst``'s
    world generator the state of ``src``'s."""
    s, d = src.world.state, dst.world.state
    for f in ("pos", "vel", "rot", "ang_vel", "force", "torque", "c", "u",
              "action_c", "steps"):
        setattr(d, f, getattr(s, f)[:n].clone())
    d.extras = {k: v[:n].clone() for k, v in s.extras.items()}
    dst.world.generator.set_state(src.world.generator.get_state())


def same_bits(got, want):
    """Whether two numpy arrays (or Python scalars) hold the same bits."""
    import numpy as np

    got, want = np.asarray(got), np.asarray(want)
    return (got.shape == want.shape and got.dtype == want.dtype
            and got.tobytes() == want.tobytes())


def host_ms(fn, iters=5):
    """Host ms of one ``fn()`` that ends on the host (a median of
    ``iters``)."""
    import torch

    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def wrapper_vs_plain(name, kind, big):
    """``kind``'s step against the unwrapped env's from the same state,
    generator state and actions (env 0 of ``big``'s state for the
    single-env wrappers, all its envs for the vectorized ones): every
    output equal to the bit; returns (wrapper ms a step, unwrapped ms a
    step)."""
    import numpy as np
    import torch
    from vectorizedmultiagentsimulator_tpu_torch.utils import TorchUtils

    single = kind in ("gym", "gymnasium")
    n = 1 if single else big.num_envs
    tt = kind.startswith("gymnasium")
    wrapped = make_path_env(name, n, wrapper=kind, terminated_truncated=tt)
    plain = make_path_env(name, n, terminated_truncated=tt)
    base = wrapped.env if kind == "rllib" else wrapped.unwrapped
    sizes = [plain.get_agent_action_size(a) for a in plain.agents]
    rng = np.random.RandomState(3)

    def actions():
        return [rng.uniform(-1, 1, (n, s)).astype(np.float32) for s in sizes]

    def wrapped_step(acts):
        if kind == "rllib":
            return wrapped.vector_step(
                [[a[j] for a in acts] for j in range(n)])
        return wrapped.step([a[0] for a in acts] if single else acts)

    def plain_step(acts):
        return plain.step([torch.as_tensor(a, device="cuda") for a in acts])

    acts = actions()
    for env in (base, plain):
        load_rows(env, big, n)
    got = wrapped_step(acts)
    want = TorchUtils.to_numpy(plain_step(acts))
    obs_w, rews_w = want[0], want[1]
    bad = []
    if kind == "rllib":
        obs, rews, dones, infos = got
        total = np.zeros(n)
        for r in rews_w:
            total = total + r.astype(np.float64)
        if not all(same_bits(np.stack([o[i] for o in obs]), obs_w[i])
                   for i in range(len(obs_w))):
            bad.append("obs")
        if not same_bits(np.asarray(rews), total / len(rews_w)):
            bad.append("rews")
        if not same_bits(dones, want[2]):
            bad.append("dones")
        for j in (0, n // 2, n - 1):
            for i, agent in enumerate(plain.agents):
                for k, v in infos[j][agent.name].items():
                    # a Python scalar where the value is one per env
                    v = np.asarray(v)
                    if not same_bits(v, want[3][i][k][j].astype(v.dtype)):
                        bad.append(f"info {agent.name}.{k} env {j}")
    else:
        obs, rews, *flags, info = got
        rows = (lambda x: x[0]) if single else (lambda x: x)  # noqa: E731
        if not all(same_bits(o, rows(w)) for o, w in zip(obs, obs_w)):
            bad.append("obs")
        if not all(same_bits(r, rows(w).item() if single else rows(w))
                   for r, w in zip(rews, rews_w)):
            bad.append("rews")
        for f, w in zip(flags, want[2:-1]):
            if not same_bits(f, rows(w).item() if single else rows(w)):
                bad.append("flags")
        for i, agent in enumerate(plain.agents):
            for k, v in info[agent.name].items():
                if not same_bits(v, rows(want[-1][i][k])):
                    bad.append(f"info {agent.name}.{k}")
    if bad:
        raise AssertionError(f"[7] {name} {kind}: outputs differ from the"
                             f" unwrapped env's: {bad}")
    ms = host_ms(lambda: wrapped_step(acts), iters=3)
    plain_ms = host_ms(lambda: plain_step(acts), iters=3)
    log(f"[7] {name}@{n} wrapper {kind}: every output equal to the bit to"
        f" the unwrapped env's step; {ms:.3f} ms a step through the wrapper,"
        f" {plain_ms:.3f} ms unwrapped (host clock to a synchronized end)")
    return ms, plain_ms


def host_syncs(fn):
    """The synchronizing CUDA operations ``fn()`` makes (a device-to-host
    copy is one), counted by the warnings of
    ``torch.cuda.set_sync_debug_mode("warn")``."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def frame_vs_cpu(name, env, label, sensors=False):
    """``env``'s frame of env 0 against the frame the port renders on the
    CPU from the same env-0 state (state_to_numpy / state_from_numpy into
    a one-env CPU env): differing pixels, held at 0; one host sync a frame,
    its device-to-host copy.  Returns (the frame, its host ms)."""
    from vectorizedmultiagentsimulator_tpu_torch.utils import (
        state_from_numpy,
        state_to_numpy,
    )

    arrays = state_to_numpy(env)
    row = {f: a[:1] for f, a in arrays.items() if f != "extras"}
    row["extras"] = {k: v[:1] for k, v in arrays["extras"].items()}
    cpu = make_path_env(name, 1, device="cpu")
    state_from_numpy(cpu, row)
    got = env.render(mode="rgb_array", env_index=0, render_sensors=sensors)
    want = cpu.render(mode="rgb_array", env_index=0, render_sensors=sensors)
    differ = int((got != want).any(axis=-1).sum())
    copies = host_syncs(lambda: env.render(mode="rgb_array",
                                           render_sensors=sensors))
    ms = host_ms(lambda: env.render(mode="rgb_array", render_sensors=sensors))
    log(f"[7] frame {label}: {got.shape[1]}x{got.shape[0]}, {differ}"
        f" pixels differ from the CPU's frame of the same state,"
        f" {copies} host sync(s) a frame (its one device-to-host copy),"
        f" {ms:.2f} ms a frame")
    if differ or copies != 1:
        raise AssertionError(f"[7] frame {label}: {differ} pixels differ,"
                             f" {copies} host syncs")
    return got, ms


def step_outputs(outs):
    """A step's observations, rewards and dones as one flat tensor."""
    import torch

    obs, rews, dones = outs[:3]
    return torch.cat([x.reshape(-1).float() for x in list(obs) + list(rews)]
                     + [dones.reshape(-1).float()])


def traj_outputs(traj):
    import torch

    return torch.cat([x.reshape(-1).float() for x in
                      list(traj["obs"]) + list(traj["rews"])
                      + [traj["dones"]]])


def state_equal(a, b):
    import torch

    fields = ("pos", "vel", "rot", "ang_vel", "force", "torque", "c", "u",
              "action_c", "steps")
    return (all(torch.equal(getattr(a, f), getattr(b, f)) for f in fields)
            and a.extras.keys() == b.extras.keys()
            and all(torch.equal(a.extras[k], b.extras[k]) for k in a.extras))


def checkpoint_check(name, path):
    """CKPT_STEPS steps, save_env, CKPT_STEPS more; a fresh env restored
    from the file steps the same CKPT_STEPS to the bit (outputs, final
    state, generator).  Eagerly (random actions from the world's
    generator), then through rollout's graph, the policy drawing from the
    world's generator: restored into the env that holds the captured graph
    (a replay from the restored generator state) and into a fresh env (a
    new capture).  Returns (file bytes, save ms, restore ms)."""
    import torch
    from vectorizedmultiagentsimulator_tpu_torch.parallel import rollout
    from vectorizedmultiagentsimulator_tpu_torch.utils import checkpoint

    def eager(env):
        return torch.cat([step_outputs(env.step(env.get_random_actions()))
                          for _ in range(CKPT_STEPS)])

    def graph(env):
        _, traj = rollout(env, n_steps=CKPT_STEPS,
                          generator=env.world.generator)
        return traj_outputs(traj)

    label = f"{name}@{PATH_ENVS[name]}"
    results = {}
    for how, run in (("eager", eager), ("graph", graph)):
        env = make_path_env(name)
        run(env)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        checkpoint.save_env(path, env)
        save_ms = (time.perf_counter() - t0) * 1e3
        want = run(env)
        want_state = env.world.state
        want_rng = env.world.generator.get_state()
        envs = [make_path_env(name, seed=7)] + ([env] if how == "graph"
                                                else [])
        for target in envs:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            checkpoint.restore_env(path, target)
            torch.cuda.synchronize()
            restore_ms = (time.perf_counter() - t0) * 1e3
            got = run(target)
            ok = (torch.equal(got, want)
                  and state_equal(target.world.state, want_state)
                  and torch.equal(target.world.generator.get_state(),
                                  want_rng))
            where = "the graph's own env" if target is env else "a fresh env"
            if not ok:
                raise AssertionError(f"[7] checkpoint {label} {how}: {where}"
                                     " does not continue to the bit")
            log(f"[7] checkpoint {label} {how}: restored into {where},"
                f" {CKPT_STEPS} steps equal to the bit (outputs, final"
                f" state, generator)")
        results[how] = (os.path.getsize(path), save_ms, restore_ms)
        del env, envs, want, want_state
    size, save_ms, restore_ms = results["eager"]
    log(f"[7] checkpoint {label}: {size} bytes, save {save_ms:.1f} ms,"
        f" restore {restore_ms:.1f} ms (eager); graph path save"
        f" {results['graph'][1]:.1f} ms, restore {results['graph'][2]:.1f}"
        f" ms")
    return results


def edges_phase(tmp):
    """Phase 7: the wrappers, frames and checkpoints on the card."""
    import importlib.util

    import torch
    from vectorizedmultiagentsimulator_tpu_torch.parallel import rollout

    kinds = ["gym", "rllib"]
    if importlib.util.find_spec("gymnasium") is not None:
        kinds += ["gymnasium", "gymnasium_vec"]
    else:
        log("[7] gymnasium is not installed here: the CPU tests"
            " (tests/test_torch_wrappers.py) hold the gymnasium and"
            " gymnasium_vec wrappers")
    for name in EDGE_WRAP_SCENES:
        big = make_path_env(name)
        for a in random_actions(big, EDGE_STEPS, seed=11):
            big.step(a)
        for kind in kinds:
            wrapper_vs_plain(name, kind, big)
        del big

    frame_ms = {}
    for name in EDGE_FRAME_SCENES:
        env = make_path_env(name)
        for a in random_actions(env, EDGE_STEPS, seed=12):
            env.step(a)
        _, frame_ms[name] = frame_vs_cpu(
            name, env, f"{name}@{env.num_envs} after {EDGE_STEPS} steps")
        del env
    for name in EDGE_FRAME_OTHERS:
        env = make_path_env(name, FRAME_SMALL_ENVS)
        for a in random_actions(env, 3, seed=12):
            env.step(a)
        frame_vs_cpu(name, env, f"{name}@{FRAME_SMALL_ENVS} after 3 steps",
                     sensors=True)
        del env
    # navigation after a graph rollout (the LIDAR casts dropped): the rays
    # of the last step, as the CPU draws them from the same state.
    env = make_path_env("navigation")
    rollout(env, n_steps=EDGE_STEPS)
    rays, _ = frame_vs_cpu("navigation", env,
                           f"navigation@{env.num_envs} with its LIDAR rays"
                           f" after a {EDGE_STEPS}-step graph rollout",
                           sensors=True)
    plain = env.render(mode="rgb_array")
    ray_pixels = int((rays != plain).any(axis=-1).sum())
    log(f"[7] navigation's LIDAR rays after the graph rollout: {ray_pixels}"
        " pixels differ from the frame without them")
    if ray_pixels < 100:
        raise AssertionError("[7] the frame after a graph rollout draws no"
                             " LIDAR rays")
    small = make_path_env("navigation", FRAME_SMALL_ENVS)
    for a in random_actions(small, EDGE_STEPS, seed=12):
        small.step(a)
    small_ms = host_ms(lambda: small.render(mode="rgb_array"))
    big_ms = host_ms(lambda: env.render(mode="rgb_array"))
    log(f"[7] navigation frame: {big_ms:.2f} ms at {env.num_envs} envs,"
        f" {small_ms:.2f} ms at {FRAME_SMALL_ENVS} envs")
    del env, small
    torch.cuda.empty_cache()

    ckpt = {}
    for name in EDGE_CKPT_SCENES:
        ckpt[name] = checkpoint_check(
            name, os.path.join(tmp, f"{name}.npz"))
    return {"frame_ms": frame_ms, "navigation_frame_ms": {
        str(PATH_ENVS["navigation"]): big_ms,
        str(FRAME_SMALL_ENVS): small_ms}, "checkpoints": ckpt}


def rollout_loss(env, steps=GRAD_STEPS):
    """``(first, loss)``: the first action (0.1 everywhere, every step's
    action) and the rollout loss of tests/test_torch_grad.py."""
    import torch

    sizes = [env.get_agent_action_size(a) for a in env.agents]
    first = torch.full((env.num_envs, sum(sizes)), 0.1, device=env.device,
                       requires_grad=True)
    actions = list(torch.split(first, sizes, dim=1))
    total = 0.0
    for _ in range(steps):
        obs, rews, _, _ = env.step(actions)
        total = total + sum(o.mean() for o in obs) + sum(
            r.mean() for r in rews)
    return first, total


def grad_vs_cpu(name, kwargs):
    """Phase 8 (a): the rollout loss's gradient on the card (the kernels'
    forwards, the plain versions' backwards) against the CPU port's from
    the same state; returns the forward's launches and max |diff| / max
    |cpu gradient|."""
    import torch
    from vectorizedmultiagentsimulator_tpu_torch.ops import (
        launch_counts,
        set_launch_counts,
    )
    from vectorizedmultiagentsimulator_tpu_torch.utils import (
        state_from_numpy,
        state_to_numpy,
    )

    kwargs = dict(kwargs, **CPU_COMPARE_KWARGS.get(name, {}))
    env_g = make_path_env(name, GRAD_ENVS, grad_enabled=True, **kwargs)
    env_c = make_path_env(name, GRAD_ENVS, device="cpu", grad_enabled=True,
                          **kwargs)
    state_from_numpy(env_c, state_to_numpy(env_g))
    torch.cuda.synchronize()
    set_launch_counts(dict.fromkeys(launch_counts(), 0))
    t0 = time.perf_counter()
    first, loss = rollout_loss(env_g)
    forward = launch_counts()
    (grad,) = torch.autograd.grad(loss, first)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    assert launch_counts() == forward, (
        f"{name}: the backward launched kernels")
    arrays = state_to_numpy(env_c)
    first_c, loss_c = rollout_loss(env_c)
    (ref,) = torch.autograd.grad(loss_c, first_c)
    grad = grad.cpu()
    assert bool(torch.isfinite(grad).all()), f"{name}: gradient not finite"
    scale = float(ref.abs().max())
    diff = (grad - ref).abs().amax(dim=1)
    err = float(diff.max())
    need = GRAD_KERNELS.get(name, ("physics_step",))
    launched = {k: forward[k] for k in need}
    rule = f"held at {GRAD_TOL:g}"
    bad = int((diff > GRAD_TOL * scale).sum())
    if name in GRAD_STIFF:
        shares = []
        for k in range(GRAD_NUDGES):
            env_n = make_path_env(name, GRAD_ENVS, device="cpu",
                                  grad_enabled=True, **kwargs)
            pos = torch.from_numpy(arrays["pos"])
            up = torch.rand(pos.shape,
                            generator=torch.Generator().manual_seed(k)) < 0.5
            nudged = torch.where(up, torch.nextafter(pos, pos + 1),
                                 torch.nextafter(pos, pos - 1))
            state_from_numpy(env_n, dict(arrays, pos=nudged.numpy()))
            first_n, loss_n = rollout_loss(env_n)
            (g_n,) = torch.autograd.grad(loss_n, first_n)
            moved = (g_n - ref).abs().amax(dim=1) > GRAD_STIFF_DIFF * scale
            shares.append(float(moved.float().mean()))
        share = float((diff > GRAD_STIFF_DIFF * scale).float().mean())
        limit = min(shares)
        bad = int(share > limit)
        rule = (f"chaotic: {share:.4f} of the envs beyond {GRAD_STIFF_DIFF:g}"
                f" of the largest entry, against {shares} for the CPU"
                f" with every position moved by an ulp; held at their"
                f" smallest, {limit:.4f}")
    log(f"[8] gradient {name}@{GRAD_ENVS} ({GRAD_STEPS} steps): card vs cpu"
        f" max |diff| {err:.3e} of max |gradient| {scale:.3e}"
        f" ({err / scale:.3e}, {rule}); loss card"
        f" {float(loss.detach()):.6f} cpu {float(loss_c.detach()):.6f};"
        f" forward launches {launched}; forward + backward on the card"
        f" {ms:.1f} ms")
    assert scale > 0 and float(grad.abs().max()) > 0, f"{name}: zero gradient"
    assert all(n > 0 for n in launched.values()), (
        f"{name}: a kernel of the path was not launched: {launched}")
    assert bad == 0, f"{name}: card gradient != cpu gradient"
    return forward, err / scale


def split_checks(mesh):
    """Phase 8 (b) on one rank: each SPLIT_PATHS path split over the mesh,
    SPLIT_STEPS steps of this rank's shard against its rows of the
    one-process env (to the bit), then a masked reset of every env; returns
    ``{path: {...}}``."""
    import torch
    from vectorizedmultiagentsimulator_tpu_torch.ops import launch_counts
    from vectorizedmultiagentsimulator_tpu_torch.parallel import (
        shard_environment,
    )
    from vectorizedmultiagentsimulator_tpu_torch.utils import STATE_FIELDS

    out = {}
    for name, B in SPLIT_PATHS:
        env = make_path_env(name, B, **CPU_COMPARE_KWARGS.get(name, {}))
        local = shard_environment(env, mesh)
        n = B // mesh.size
        rows = slice(mesh.rank * n, (mesh.rank + 1) * n)
        g = torch.Generator(device="cuda").manual_seed(11)
        sizes = [env.get_agent_action_size(a) for a in env.agents]
        differ, launches = [], {}
        for t in range(SPLIT_STEPS):
            acts = [torch.rand((B, k), generator=g, device="cuda") * 2 - 1
                    for k in sizes]
            want = env.step(acts)
            before = launch_counts()
            got = local.step([a[rows] for a in acts])
            for k, v in launch_counts().items():
                launches[k] = launches.get(k, 0) + v - before[k]
            pairs = [(f"obs {i}", x, y[rows]) for i, (x, y) in
                     enumerate(zip(got[0], want[0]))]
            pairs += [(f"rew {i}", x, y[rows]) for i, (x, y) in
                      enumerate(zip(got[1], want[1]))]
            pairs += [("done", got[2], want[2][rows])]
            s, w = local.world.state, env.world.state
            pairs += [(f, getattr(s, f), getattr(w, f)[rows])
                      for f in STATE_FIELDS]
            pairs += [(k, v, w.extras[k][rows]) for k, v in s.extras.items()]
            differ += [f"step {t} {k}" for k, x, y in pairs
                       if not torch.equal(x, y)]
        local.reset_at(torch.ones((n,), dtype=torch.bool, device="cuda"))
        pos = torch.zeros((mesh.size,) + tuple(local.world.state.pos.shape),
                          device="cuda")
        pos[mesh.rank] = local.world.state.pos
        mesh.all_reduce(pos)
        out[name] = {"envs": B, "local_envs": n, "differ": differ[:10],
                     "n_differ": len(differ),
                     "ranks_reset_differ": not torch.equal(pos[0], pos[1]),
                     "launches": {k: v for k, v in launches.items() if v}}
        del env, local
    return out


def dp_update_check(mesh):
    """Phase 8 (b): one update of 1 epoch x 1 minibatch at DP_CELL from one
    packed one-process rollout, split by env: the data-parallel gradient
    (its kernel at norm_n = mb x ranks, then one all-reduce) against the
    one-process kernel's."""
    import torch
    from vectorizedmultiagentsimulator_tpu_torch.examples import torch_ppo
    from vectorizedmultiagentsimulator_tpu_torch.ops import ppo_update_cuda

    name, B = DP_CELL
    cfg = torch_ppo.PPOConfig(epochs=1, minibatches=1)
    _, _, one = torch_ppo.init_training(name, B, 0, cfg)
    packed, _ = one.collect()

    def grads_of(trainer, packed_fm):
        spec = trainer.spec
        adv = packed_fm[spec.obs_d + spec.act_w + 1].reshape(-1, spec.lb)
        pm = torch.arange(spec.mb // spec.lb, dtype=torch.int32,
                          device="cuda")
        return trainer.minibatch_grads(packed_fm, pm, adv.sum(1),
                                       (adv * adv).sum(1))

    ref, ref_sums = grads_of(one, packed)
    _, _, dp = torch_ppo.init_training(name, B, 0, cfg, mesh=mesh)
    with torch.no_grad():
        for p, q in zip(dp.model.ordered_parameters(),
                        one.model.ordered_parameters()):
            p.copy_(q)
    before = ppo_update_cuda.LAUNCHES
    got, sums = grads_of(dp, torch_ppo.shard_packed(packed, B, mesh))
    launches = ppo_update_cuda.LAUNCHES - before
    rel = max(float((g - r).abs().max() / r.abs().max())
              for g, r in zip(got, ref))
    abs_err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    # phase 2's rule for a loss sum: a relative error and an absolute one
    # that grows with the O(1) terms summed
    sums_ok = all(
        abs(float(a) - float(b)) <= PPO_SUM_RTOL * abs(float(b))
        + PPO_SUM_ATOL_PER_SAMPLE * one.spec.mb
        for a, b in zip(sums, ref_sums))
    sums_err = max(abs(float(a) - float(b)) for a, b in zip(sums, ref_sums))
    return {"norm_n": dp.spec.norm_n, "mb": dp.spec.mb,
            "one_process_mb": one.spec.mb, "launches": launches,
            "max_abs_err": abs_err, "max_rel_err": rel,
            "sums_abs_err": sums_err, "sums_ok": sums_ok}


def dp_iteration(mesh):
    """Phase 8 (b): the data-parallel trainer at DP_CELL with the PPOConfig
    defaults, one iteration after one warm-up: its wall, its launches, the
    ms of one minibatch's all-reduces (the advantage sums, then the flat
    gradients and sums), and whether the parameters are bit-identical on
    every rank."""
    import torch
    from vectorizedmultiagentsimulator_tpu_torch.examples import torch_ppo
    from vectorizedmultiagentsimulator_tpu_torch.ops import (
        launch_counts,
    )

    name, B = DP_CELL
    _, step, trainer = torch_ppo.init_training(name, B, 0,
                                               torch_ppo.PPOConfig(),
                                               mesh=mesh)
    trainer, _ = step(trainer)
    torch.cuda.synchronize()
    before = launch_counts()
    t0 = time.perf_counter()
    trainer, metrics = step(trainer)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    launches = {k: v - before[k] for k, v in launch_counts().items()
                if v - before[k]}
    flat = torch.cat([p.detach().reshape(-1)
                      for p in trainer.model.ordered_parameters()])
    rank0 = mesh.broadcast(flat.clone(), 0)
    differ = mesh.all_reduce(
        torch.tensor([0.0 if torch.equal(flat, rank0) else 1.0],
                     device="cuda"))
    grads = [torch.zeros_like(p) for p in trainer.model.ordered_parameters()]
    stats, sums = torch.zeros(2, device="cuda"), torch.zeros(3, device="cuda")
    reps = 16
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        mesh.all_reduce(stats)
        trainer.reduce_update(grads, sums)
    torch.cuda.synchronize()
    reduce_ms = (time.perf_counter() - t0) * 1e3 / reps
    return {"wall_ms": wall, "launches": launches,
            "ranks_with_other_params": int(differ.item()),
            "allreduce_ms_per_minibatch": reduce_ms,
            "flat_floats": flat.numel() + 3,
            "loss": float(metrics["loss"]),
            "mean_reward": float(metrics["mean_reward"])}


def world_of_one(mesh):
    """Phase 8 (c): an NCCL world of one rank: one data-parallel iteration
    at DP_CELL under torch.cuda.set_sync_debug_mode("error") against the
    plain Trainer's, parameters and metrics to the bit."""
    import torch
    from vectorizedmultiagentsimulator_tpu_torch.examples import torch_ppo
    from vectorizedmultiagentsimulator_tpu_torch.ops import launch_counts

    name, B = DP_CELL
    cfg = torch_ppo.PPOConfig()
    _, step_p, plain = torch_ppo.init_training(name, B, 0, cfg)
    plain, m_plain = step_p(plain)
    _, step_d, dp = torch_ppo.init_training(name, B, 0, cfg, mesh=mesh)
    torch.cuda.synchronize()
    before = launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        dp, m_dp = step_d(dp)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    launches = {k: v - before[k] for k, v in launch_counts().items()
                if v - before[k]}
    torch.cuda.synchronize()
    same = all(torch.equal(p, q) for p, q in zip(
        plain.model.ordered_parameters(), dp.model.ordered_parameters()))
    same_metrics = all(torch.equal(m_plain[k], m_dp[k]) for k in m_plain)
    return {"params_equal": same, "metrics_equal": same_metrics,
            "norm_n": dp.spec.norm_n, "launches": launches}


def dp_worker(backend, rank, world, port, out):
    """One rank of phase 8's worlds on the card (``--dp-worker``): joins
    the process group and writes its results to ``out/rank<rank>.json``."""
    import torch
    from vectorizedmultiagentsimulator_tpu_torch.parallel import (
        init_distributed,
    )

    mesh = init_distributed(backend, int(rank), int(world),
                            init_method=f"tcp://localhost:{port}",
                            device="cuda:0", timeout_s=DP_TIMEOUT_S)
    torch.backends.cuda.matmul.allow_tf32 = False
    if backend == "gloo":
        result = {"split": split_checks(mesh),
                  "update": dp_update_check(mesh),
                  "iteration": dp_iteration(mesh)}
    else:
        result = {"world_of_one": world_of_one(mesh)}
    torch.distributed.destroy_process_group()
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)


def run_world(backend, n, tmp):
    """``n`` ranks of dp_worker over ``backend``, each its own process on
    the one card; returns their results."""
    from vectorizedmultiagentsimulator_tpu_torch.parallel import run_workers
    from vectorizedmultiagentsimulator_tpu_torch.parallel.distributed import (
        free_port,
    )

    out = os.path.join(tmp, backend)
    os.makedirs(out)
    port = str(free_port())
    t0 = time.perf_counter()
    run_workers([[sys.executable, os.path.abspath(__file__), "--dp-worker",
                  backend, str(r), str(n), port, out] for r in range(n)],
                DP_TIMEOUT_S, cwd=ROOT)
    log(f"[8] {backend}: {n} worker processes took"
        f" {time.perf_counter() - t0:.1f} s")
    results = []
    for r in range(n):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            results.append(json.load(f))
    return results


def phase_8():
    """Phase 8: gradients through the step on the card, and the env batch
    split over ranks with the data-parallel trainer (two gloo ranks on the
    one card, an NCCL world of one).  Returns the figures of the kernels
    line."""
    import torch

    launches, grad_errs = {}, {}
    for name, kwargs in GRAD_PATHS:
        forward, grad_errs[name] = grad_vs_cpu(name, kwargs)
        for k, v in forward.items():
            launches[k] = launches.get(k, 0) + v
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        gloo = run_world("gloo", 2, tmp)
        nccl = run_world("nccl", 1, tmp)[0]["world_of_one"]
    for r, res in enumerate(gloo):
        for name, sp in res["split"].items():
            log(f"[8] gloo rank {r}: {name}@{sp['envs']} split 2 x"
                f" {sp['local_envs']}: {SPLIT_STEPS} steps of the shard vs"
                f" the one-process env's rows, {sp['n_differ']} tensors"
                f" differ {sp['differ']}; launches {sp['launches']}; a"
                f" masked reset of every env draws differently on the two"
                f" ranks: {sp['ranks_reset_differ']}")
            assert sp["n_differ"] == 0, f"{name}: shard != global rows"
            assert sp["ranks_reset_differ"], f"{name}: ranks drew alike"
            for k, v in sp["launches"].items():
                launches[k] = launches.get(k, 0) + v
            need = GRAD_KERNELS.get(name, ("physics_step",))
            assert all(sp["launches"].get(k, 0) > 0 for k in need), name
        up, it = res["update"], res["iteration"]
        log(f"[8] gloo rank {r}: data-parallel update at"
            f" {DP_CELL[0]}@{DP_CELL[1]} (1 epoch x 1 minibatch, mb"
            f" {up['mb']} a rank, norm_n {up['norm_n']}, one-process mb"
            f" {up['one_process_mb']}): max |diff| {up['max_abs_err']:.3e},"
            f" {up['max_rel_err']:.3e} of a gradient's largest entry (held"
            f" at {PPO_GRAD_TOL}), loss sums max |diff|"
            f" {up['sums_abs_err']:.3e} (phase 2's rule:"
            f" {up['sums_ok']}); PPO launches {up['launches']}")
        assert up["norm_n"] == 2 * up["mb"] == up["one_process_mb"]
        assert up["launches"] == 1
        assert up["max_rel_err"] <= PPO_GRAD_TOL, "DP update != one process"
        assert up["sums_ok"], "DP loss sums != one process"
        log(f"[8] gloo rank {r}: one data-parallel iteration at the"
            f" PPOConfig defaults: wall {it['wall_ms']:.2f} ms, all-reduces"
            f" {it['allreduce_ms_per_minibatch']:.4f} ms a minibatch"
            f" ({it['flat_floats']} floats + 2), launches {it['launches']};"
            f" ranks whose parameters differ from rank 0's:"
            f" {it['ranks_with_other_params']}; loss {it['loss']:+.5f},"
            f" mean reward {it['mean_reward']:+.5f}")
        assert it["ranks_with_other_params"] == 0
        assert it["launches"].get("ppo_update") == 16
        for k, v in [("ppo_update", up["launches"])] + list(
                it["launches"].items()):
            launches[k] = launches.get(k, 0) + v
    log(f"[8] nccl world of one: a data-parallel iteration (norm_n"
        f" {nccl['norm_n']}) vs the plain Trainer's: parameters equal to the"
        f" bit {nccl['params_equal']}, metrics {nccl['metrics_equal']}; no"
        f" host sync under set_sync_debug_mode('error'); launches"
        f" {nccl['launches']}")
    assert nccl["params_equal"] and nccl["metrics_equal"]
    for k, v in nccl["launches"].items():
        launches[k] = launches.get(k, 0) + v
    log(f"[8] phase 8 launches (the gradient forwards; both gloo ranks'"
        f" sharded steps, data-parallel update and iteration; the NCCL"
        f" rank's iteration): {launches}")
    up0, it0 = gloo[0]["update"], gloo[0]["iteration"]
    return launches, {
        "path": f"{DP_CELL[0]}@{DP_CELL[1]} over 2 gloo ranks on one card",
        "norm_n": up0["norm_n"], "mb": up0["mb"],
        "max_abs_err": max(g["update"]["max_abs_err"] for g in gloo),
        "max_rel_err": max(g["update"]["max_rel_err"] for g in gloo),
        "allreduce_ms": max(g["iteration"]["allreduce_ms_per_minibatch"]
                            for g in gloo),
        "iteration_ms": it0["wall_ms"],
        "launches_per_rank": it0["launches"].get("ppo_update"),
        "nccl_world_of_one_bit_equal": nccl["params_equal"],
        "grad_max_rel_err": grad_errs,
    }


def path_of(name):
    return next(p for p in MAIN_PATHS if p[0] == name)


def functional_path(name):
    """Phase 9 on one path: torch_helpers.functional_checks over FUNC_STEPS
    steps (step_fn equal to env.step to the bit, outputs and every state
    leaf; input states unchanged; two branches equal; reset_at_fn equal to
    env.reset_at), one step_fn's launches against the path's a step, a
    step_fn and a masked reset_at_fn with no host sync (the generators'
    states read and set inside the check too), and the ms of a step_fn
    call beside an env.step's (CUDA events); on map '2' the ms of the
    copies of its two in-place buffers that a step_fn from a state it
    does not own makes.  Returns ({kernel: launches}, figures)."""
    import torch
    from torch_helpers import (
        differing_leaves,
        functional_checks,
        generator_at,
        reset_mask,
    )
    from vectorizedmultiagentsimulator_tpu_torch.ops import (
        launch_counts,
        set_launch_counts,
    )

    _, envs, _, _, casts, plans, road = path_of(name)
    label = f"{name}@{envs}"
    env = make_path_env(name)
    for a in random_actions(env, 3, seed=21):
        env.step(a)
    if recorded_rows(env) is not None:
        label += f" ({replayed_state(env)} envs replayed a recorded state)"
    actions = random_actions(env, FUNC_STEPS, seed=22)
    torch.cuda.synchronize()
    set_launch_counts(dict.fromkeys(launch_counts(), 0))
    s0, s_end, outs = functional_checks(env, actions)
    launches = launch_counts()

    state = env.state
    state_copy = state.clone()
    g0 = env.world.generator.get_state()
    torch.cuda.synchronize()
    set_launch_counts(dict.fromkeys(launch_counts(), 0))
    torch.cuda.set_sync_debug_mode("error")
    try:
        g = generator_at(g0, "cuda")
        new, o = env.step_fn(state, actions[0], generator=g)
        one = launch_counts()
        env.reset_at_fn(new, reset_mask(env, o), generator=g)
        g.set_state(g0)
        g.get_state()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = {"physics_step": 1, "raycast": casts, "football_policy": plans,
            "agent_geometry": road[0], "pair_collisions": road[1],
            "neighbor_obs": road[2]}
    got = {k: one.get(k, 0) for k in want}
    if got != want:
        raise AssertionError(f"[9] {label}: a step_fn launched {got},"
                             f" expected {want}")
    for k, v in one.items():
        launches[k] = launches.get(k, 0) + v

    step_ms, fn_ms = [], []
    for turn in (step_ms, fn_ms, fn_ms, step_ms):
        if turn is step_ms:
            env.state = state
            turn.append(cuda_time_ms(lambda: env.step(actions[0]),
                                     FUNC_TIME_ITERS))
        else:
            turn.append(cuda_time_ms(
                lambda: env.step_fn(state, actions[0]), FUNC_TIME_ITERS))
    figures = {"step_fn_ms": fn_ms, "step_ms": step_ms}
    copy = ""
    if recorded_rows(env) is not None:
        bufs = [state.extras[f"scenario.{k}"] for k in ("state_hist",
                                                        "isb_buf")]
        mb = sum(b.numel() * b.element_size() for b in bufs) / 1e6
        copy_ms = cuda_time_ms(lambda: [b.clone() for b in bufs],
                               FUNC_TIME_ITERS)
        figures.update(copy_ms=copy_ms, copy_mb=mb)
        copy = (f"; a step_fn from a state it does not own copies the ring"
                f" and the initial-state buffer first: {mb:.1f} MB,"
                f" {copy_ms:.4f} ms")
    bad = differing_leaves(state, state_copy)
    assert not bad, f"[9] {label}: the timed calls changed a state: {bad}"
    log(f"[9] {label}: {FUNC_STEPS} step_fn calls equal to env.step to the"
        f" bit (outputs, every state leaf, the generator), the input states"
        f" unchanged, two branches equal, reset_at_fn equal to env.reset_at;"
        f" a step_fn launched {got}, a step_fn and a masked reset_at_fn no"
        f" host sync; ms a call (CUDA events, {FUNC_TIME_ITERS} calls, in"
        f" turns): step_fn {fn_ms[0]:.4f} {fn_ms[1]:.4f}, env.step"
        f" {step_ms[0]:.4f} {step_ms[1]:.4f}{copy}")
    del env, s0, s_end, outs, state, state_copy, new
    return launches, figures


def step_fn_graph():
    """Phase 9: FUNC_STEPS step_fn calls at FUNC_GRAPH_PATH captured as one
    CUDA graph (the generator registered through
    rollout.register_generators) against the same calls eagerly: every
    output and the final state equal to the bit, and the graph's kernel
    nodes by name (torch_helpers.graph_kernels) one physics kernel a
    call.  Returns the capture's launch counts."""
    import torch
    from torch_helpers import (
        differing_leaves,
        generator_at,
        graph_kernels,
        kept_graphs,
    )
    from vectorizedmultiagentsimulator_tpu_torch.ops import (
        launch_counts,
        set_launch_counts,
    )
    from vectorizedmultiagentsimulator_tpu_torch.parallel.rollout import (
        register_generators,
    )

    name = FUNC_GRAPH_PATH
    env = make_path_env(name)
    for a in random_actions(env, 3, seed=23):
        env.step(a)
    actions = random_actions(env, FUNC_STEPS, seed=24)
    static = env.state.clone()
    g0 = env.world.generator.get_state()

    def calls(state, generator):
        outs = []
        for a in actions:
            state, o = env.step_fn(state, a, generator=generator)
            outs.append(o)
        return state, outs

    with torch.no_grad():
        want = calls(static, generator_at(g0, "cuda"))
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            env.step_fn(static, actions[0], generator=generator_at(g0, "cuda"))
        torch.cuda.current_stream().wait_stream(side)
        g = generator_at(g0, "cuda")
        set_launch_counts(dict.fromkeys(launch_counts(), 0))
        with kept_graphs():
            graph = torch.cuda.CUDAGraph()
            register_generators(graph, [g])
            env.world.drop_cast_caches()
            with torch.cuda.graph(graph):
                got = calls(static, g)
            env.world.drop_cast_caches()
            captured = launch_counts()
            g.set_state(g0)
            graph.replay()
            torch.cuda.synchronize()
            nodes = graph_kernels(graph)
            bad = differing_leaves(got, want)
            del got
    assert not bad, f"[9] step_fn graph {name}: differs from eager: {bad}"
    if nodes.get("physics_step") != FUNC_STEPS:
        raise AssertionError(f"[9] step_fn graph {name}: kernel nodes {nodes}")
    log(f"[9] a CUDA graph of {FUNC_STEPS} step_fn calls at"
        f" {name}@{env.num_envs}: every output and the final state equal to"
        f" the eager calls to the bit; kernel nodes by name {nodes}")
    return captured


def state_loss(env, actions):
    """``((pos, vel), loss)``: the rollout loss (the mean of every
    observation and reward, each step) over step_fn calls from env.state,
    with its initial pos and vel as leaves that require a gradient."""
    s0 = env.state
    leaves = tuple(x.clone().requires_grad_(True) for x in (s0.pos, s0.vel))
    state, total = s0.replace(pos=leaves[0], vel=leaves[1]), 0.0
    for a in actions:
        state, (obs, rews, _, _) = env.step_fn(state, a)
        total = total + sum(o.mean() for o in obs) + sum(
            r.mean() for r in rews)
    return leaves, total


def state_grad_vs_cpu(name):
    """Phase 9: the gradient of state_loss with respect to the initial pos
    and vel on the card (the kernels' forwards) against the CPU port's
    from the same state and actions, as a share of the CPU gradient's
    largest entry (GRAD_TOL).  Returns (forward launches, error)."""
    import torch
    from vectorizedmultiagentsimulator_tpu_torch.ops import (
        launch_counts,
        set_launch_counts,
    )
    from vectorizedmultiagentsimulator_tpu_torch.utils import (
        state_from_numpy,
        state_to_numpy,
    )

    kwargs = CPU_COMPARE_KWARGS.get(name, {})
    env_g = make_path_env(name, GRAD_ENVS, grad_enabled=True, **kwargs)
    env_c = make_path_env(name, GRAD_ENVS, device="cpu", grad_enabled=True,
                          **kwargs)
    state_from_numpy(env_c, state_to_numpy(env_g))
    actions = random_actions(env_g, FUNC_STEPS_GRAD, seed=25)
    torch.cuda.synchronize()
    set_launch_counts(dict.fromkeys(launch_counts(), 0))
    leaves, total = state_loss(env_g, actions)
    forward = launch_counts()
    grads = torch.autograd.grad(total, leaves)
    torch.cuda.synchronize()
    assert launch_counts() == forward, f"{name}: the backward launched kernels"
    leaves, total = state_loss(env_c, [[a.cpu() for a in acts]
                                       for acts in actions])
    refs = torch.autograd.grad(total, leaves)
    errs = []
    for f, got, ref in zip(("pos", "vel"), grads, refs):
        got = got.cpu()
        scale = float(ref.abs().max())
        assert bool(torch.isfinite(got).all()) and scale > 0, (name, f)
        errs.append(float((got - ref).abs().max()) / scale)
    need = {"physics_step": FUNC_STEPS_GRAD,
            "raycast": FUNC_STEPS_GRAD * path_of(name)[4]}
    launched = {k: forward.get(k, 0) for k in need}
    log(f"[9] state gradient {name}@{GRAD_ENVS} ({FUNC_STEPS_GRAD} step_fn"
        f" calls, with respect to the initial pos and vel): card vs cpu max"
        f" |diff| {errs[0]:.3e} and {errs[1]:.3e} of the largest entry"
        f" (held at {GRAD_TOL:g}); forward launches {launched}, backward"
        f" none")
    assert launched == need, f"{name}: forward launches {launched}"
    assert max(errs) <= GRAD_TOL, f"{name}: card state gradient != cpu"
    return forward, max(errs)


def phase_9(smi):
    """Phase 9: the functional API on the card.  Returns (launches of the
    functional calls, figures)."""
    import torch

    t0 = time.perf_counter()
    launches, figures = {}, {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    for name in FUNC_PATHS:
        counts, figures[name] = functional_path(name)
        add(counts)
        torch.cuda.empty_cache()
    add(step_fn_graph())
    torch.cuda.empty_cache()
    grad_errs = {}
    for name in FUNC_GRAD_PATHS:
        counts, grad_errs[name] = state_grad_vs_cpu(name)
        add(counts)
    figures["state_grad_max_rel_err"] = grad_errs
    seconds = time.perf_counter() - t0
    figures["seconds"] = seconds
    log(f"[9] phase 9 on {smi}: step_fn ms a call "
        + ", ".join(f"{n} {figures[n]['step_fn_ms'][0]:.4f} (env.step"
                    f" {figures[n]['step_ms'][0]:.4f})" for n in FUNC_PATHS)
        + f"; map '2''s buffer copy"
        f" {figures['road_traffic_map2']['copy_ms']:.4f} ms; launches"
        f" {launches}; {seconds:.1f} s")
    return launches, figures


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA GPU; none is available")
    if sys.argv[1:2] == ["--rate"]:
        return rate_worker(sys.argv[2], tuple(sys.argv[3].split(",")))
    if sys.argv[1:2] == ["--ab"]:
        return ab(sys.argv[2], int(sys.argv[3]) if len(sys.argv) > 3 else 10,
                  tuple(sys.argv[4].split(",")) if len(sys.argv) > 4
                  else AB_GROUPS)
    sys.path.insert(0, ROOT)
    if sys.argv[1:2] == ["--dp-worker"]:
        return dp_worker(*sys.argv[2:7])
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
        poses_at_cast_reach,
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
        log(f"[1] ppo_update {k}: {ppo_layout(sp)},"
            f" {ppo_update_cuda.smem_bytes(sp, *ppo_update_cuda.layout(sp))}"
            f" bytes of dynamic shared memory a block,"
            f" {ppo_update_cuda.flat_size(sp)} gradient entries and sums")

    phase_time(1)

    # ---- 2: kernels vs plain on the card ---- #
    errs, stiff_errs, cast_errs, planner_errs, times = [], [], [], [], {}
    cast_t = {}

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
        # One thread an env, the first design's order of the sums.
        with physics_cuda.lanes(w, 1):
            held(kernel_vs_plain(w, r_inputs, f"{label} random, forced 1 lane",
                                 stiff=stiff))
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
        # Every LIDAR group of the path (navigation's and flocking's four
        # agents are one), cast in one launch from all its agents, against
        # the plain version from each agent over its own table.
        groups = list({id(g): g for g, _ in w._lidar_groups.values()}
                      .values())
        for grp in groups:
            cast_args = (s.pos, s.rot, grp.angles, grp.origins, grp.table,
                         grp.max_range)
            cast_errs.append(cast_vs_plain(
                *cast_args, f"{label} 10 steps, the LIDARs of"
                f" {len(grp.origins)} agents in one launch"))
            # The first agent's LIDAR alone (one origin, as World.cast_rays
            # launches it).
            single_args = cast_args[:3] + (grp.origins[0],) + cast_args[4:]
            cast_errs.append(cast_vs_plain(
                *single_args, f"{label} 10 steps, one agent's LIDAR alone"))
            cast_t[name] = {"batched": cast_times(
                cast_args, f"{label} after 10 steps, {len(grp.origins)}"
                f" LIDARs in one launch"), "single": cast_times(
                single_args, f"{label} after 10 steps, one LIDAR (O = 1)")}
        if groups:
            enqueue = measure_enqueue_ms(env)
            cast_t[name]["enqueue_ms"] = enqueue
            log(f"[2] ray cast at {label}: host ms (no synchronize) of a"
                f" step's {len(groups[0].origins)} LIDAR measures after a"
                f" pose write, grouped (one launch)"
                f" {' '.join(f'{x:.4f}' for x in enqueue['grouped'])}; as"
                f" one single-origin wrapper call each"
                f" {' '.join(f'{x:.4f}' for x in enqueue['single'])}")
        with torch.no_grad():
            step = lambda: physics_cuda.fused_step(w, *r_inputs)
            kernel_ms = cuda_time_ms(step, 50)
            plain_ms = cuda_time_ms(
                lambda: physics_cuda.step_plain(w, *r_inputs), 50)
            times[name] = (kernel_ms, plain_ms, physics_bound_ms(w, r_inputs),
                           w._kernel_tables.structs[1].lanes)
            # Device time at each lane group the kernel takes, the one
            # chosen at finalize among them.
            sweep = {}
            for group in (1, 2, 4, 8):
                with physics_cuda.lanes(w, group):
                    sweep[group] = device_ms(step, 20, "physics_step_kernel")
            log(f"[2] physics step at {label}: kernel {kernel_ms:.4f} ms a"
                f" call with {times[name][3]} lanes an env, plain"
                f" {plain_ms:.4f} ms, bound {times[name][2][0]:.5f} ms"
                f" ({times[name][2][1]}); device ms a launch with 1/2/4/8"
                f" lanes " + " ".join(f"{v:.4f}" for v in sweep.values()))
        del env, w, s, r_inputs
    # The physics row of the kernels line: transport@30k, as in the earlier
    # slices, and joint_passage@30k, the path of the joint branch, under
    # "joint_path" (every path's time is printed above).
    kernel_ms, plain_ms, (phys_bound, phys_by), _ = times["transport"]

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
    # Every entity of the scene an origin of one launch over all seven,
    # each skipping itself, with the golden's first base angles.
    everyone = raycast_cuda.cast_table(
        gw, [names.index(n) for n in ("s0", "s1", "a")],
        [names.index("b0"), names.index("b1")],
        [names.index("li0"), names.index("li1")],
    )
    origins = tuple(names.index(n) for n in ("a", "s0", "b0", "li0", "s1",
                                             "b1", "li1"))
    base = torch.as_tensor(golden["angles"][0], device="cuda")
    cast_errs.append(cast_vs_plain(
        pos, rot, base, origins, everyone, 1.5,
        f"golden scene tiled to {N_ENVS}, every entity an origin",
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
    cast_errs.append(cast_vs_plain(
        pos, rot, axis, origins, everyone, 1.5,
        "axis-aligned rays, unrotated boxes, every entity an origin"
    ))
    # Every other entity on the edge of the kernel's reach test from the
    # agent (torch_helpers.poses_at_cast_reach): its culling must change
    # nothing.
    rpos, rrot = (torch.as_tensor(x, device="cuda") for x in
                  poses_at_cast_reach(gw, origin, golden["angles"][0], 1.5,
                                      seed=8, B=N_ENVS))
    cast_errs.append(cast_vs_plain(
        rpos, rrot, base, origin, gtable, 1.5,
        "golden shapes on the edge of the reach test"))
    cast_errs.append(cast_vs_plain(
        rpos, rrot, base, origins, everyone, 1.5,
        "golden shapes on the edge of the reach test, every entity an"
        " origin"))
    del gw, pos, rot, rpos, rrot
    plan_ms, plan_plain_ms, plan_bound, plan_by = planner_phase_2(
        planner_errs, planner_real)
    del planner_real
    road_errs = {"geometry": [], "neighbor_obs": []}
    road_times, road_layouts = road_phase_2(road_errs)
    ppo_errs = []
    ppo_t, ppo_wide, ppo_global_tiles = ppo_phase_2(ppo_errs)

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
    # The other scenarios of the slice, GRAPH_STEPS steps at GRAPH_ENVS.
    for path in OTHER_PATHS:
        steps, cast_count, _, _ = main_path(
            path[0], GRAPH_ENVS, *path[2:], n_steps=GRAPH_STEPS)
        launches["physics_step"] += steps
        launches["raycast"] += cast_count
    plain_route_joints()
    lidar_forms_equal()
    for name, *_ in MAIN_PATHS + OTHER_PATHS:
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
        turns = ((True, True) if name in NO_PLAIN_WINDOWS
                 else (True, False, False, True))
        for on in turns:
            rates[on].append(rollout_rate(
                env, actions if on else actions[:PLAIN_STEPS], on))
        log(f"[4] {name}@{env.num_envs} rollout env-steps/s: kernels"
            f" ({N_STEPS} steps) {rates[True][0]:.6g} {rates[True][1]:.6g},"
            f" plain ({PLAIN_STEPS} steps) "
            + " ".join(f"{r:.6g}" for r in rates[False]))
        del env, actions
    for name, num_envs in TRAIN_CELLS:
        train_rates(name, num_envs)

    phase_time(4)

    # ---- 5: where a step's time goes ---- #
    # discovery again with targets_respawn=False (no spawner in its step):
    # what the respawn costs a step.
    for name, kwargs in [(p[0], {}) for p in MAIN_PATHS] + [
            ("discovery", dict(targets_respawn=False))]:
        env = make_path_env(name, **kwargs)
        actions = random_actions(env, PROFILE_STEPS, seed=8)
        plain = not kwargs and name not in NO_PLAIN_WINDOWS
        for on in (True, False) if plain else (True,):
            wall, busy, idle, n_kernels, named = profile_steps(
                env, actions if on else actions[:PLAIN_PROFILE_STEPS], on)
            log(f"[5] {name}@{env.num_envs}"
                f"{' targets_respawn=False' if kwargs else ''}"
                f" {'kernels' if on else 'plain'}:"
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

    # ---- 6: the rollout as a CUDA graph, the port bench ---- #
    # every path at GRAPH_ENVS, then transport at its full N_ENVS
    for path, envs in ([(p, GRAPH_ENVS) for p in MAIN_PATHS]
                       + [(MAIN_PATHS[0], N_ENVS)]):
        graph_vs_eager(path, envs)
    # The other scenarios: the exact count of the graph's kernel nodes
    # without the profiler's traces, and their graph rates over
    # OTHER_STEPS-step rollouts (passage's capture of 100 steps took 28 s).
    for path in OTHER_PATHS:
        graph_vs_eager(path, GRAPH_ENVS, trace=False)
    for name, *_ in MAIN_PATHS:
        graph_rates(name, PATH_ENVS[name])
    for name, *_ in OTHER_PATHS:
        graph_rate(name, PATH_ENVS[name],
                   POLLOCK_STEPS if name == "pollock" else OTHER_STEPS)
    port_bench()
    phase_time(6)

    # ---- 7: the edges: wrappers, frames, checkpoints ---- #
    with tempfile.TemporaryDirectory() as tmp:
        edges_phase(tmp)
    phase_time(7)

    # ---- 8: multi-device and gradients ---- #
    launches_8, data_parallel = phase_8()
    phase_time(8)

    # ---- 9: the functional API ---- #
    launches_9, functional = phase_9(smi)
    phase_time(9)

    line = {"kernels": [
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
            "lanes": times["transport"][3],
            "joint_path": {
                "lanes": times["joint_passage"][3],
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
            # navigation@30k after 10 steps: its four LIDARs in one launch,
            # as the main path casts them.
            "path": f"navigation@{PATH_ENVS['navigation']}",
            "ms": cast_t["navigation"]["batched"]["ms"],
            "device_ms": cast_t["navigation"]["batched"]["device_ms"],
            "plain_ms": cast_t["navigation"]["batched"]["plain_ms"],
            "bound_ms": cast_t["navigation"]["batched"]["bound_ms"],
            "bound_by": cast_t["navigation"]["batched"]["bound_by"],
            # No single PyTorch call computes a ray cast.
            "library_ms": None,
            # One LIDAR alone (O = 1, as World.cast_rays launches it), and
            # flocking@30k's group and single LIDAR; host ms of a step's
            # measures, grouped and as single-origin calls.
            "single_origin": cast_t["navigation"]["single"],
            "flocking": cast_t["flocking"],
            # discovery@10k: its five target LIDARs (15 rays over 7
            # targets) in one launch, and one alone.
            "discovery": cast_t["discovery"],
            "enqueue_ms": cast_t["navigation"]["enqueue_ms"],
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
            "ms": ppo_t["ms"],
            "plain_ms": ppo_t["plain_ms"],
            "bound_ms": ppo_t["bound_ms"],
            "bound_by": ppo_t["bound_by"],
            "device_ms": ppo_t["device_ms"],
            # The same minibatch at hidden 256 (a cluster of 4 blocks a
            # tile).
            "hidden_256": ppo_wide,
            # Past hidden 1,040 (activation tiles in device memory): one
            # minibatch of a real transport@256 rollout.
            **{f"hidden_{h}": t for h, t in ppo_global_tiles.items()},
            # No single PyTorch call computes a PPO minibatch's gradients.
            "library_ms": None,
            # Phase 8: the data-parallel trainer (norm_n = mb x ranks), its
            # update against the one-process update, the all-reduces' ms.
            "data_parallel": data_parallel,
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
            "device_ms": road_times[name][5],
            "plain_ms": road_times[name][1],
            "bound_ms": road_times[name][2],
            "bound_by": road_times[name][3],
            # No single PyTorch call computes road_traffic's geometry.
            "library_ms": None,
            **({} if road_times[name][4] is None else
               {"bound_all_segments_ms": road_times[name][4]}),
            **({} if name != "agent_geometry" else {
                "lanes": road_geometry_cuda.AGENT_LANES,
                "staged": road_geometry_cuda.STAGED,
                # ms a launch (CUDA events, device) at each (lanes,
                # tables, culling) layout.
                "layouts_ms": {
                    f"{g} lanes, {'staged' if st else 'L1'},"
                    f" {'culled' if c else 'every segment'}": list(ms)
                    for (g, st, c), ms in road_layouts.items()},
            }),
        }
        for name, line, err in (
            ("agent_geometry", 183,
             max(e[0] for e in road_errs["geometry"])),
            ("pair_collisions", 479,
             max(e[1] for e in road_errs["geometry"])),
            ("neighbor_obs", 551, max(road_errs["neighbor_obs"])),
        )
    ]}
    for entry in line["kernels"]:
        # Phase 8's launches: the gradient forwards, and each worker's
        # sharded steps and data-parallel training.
        entry["phase_8_launches"] = launches_8.get(entry["name"], 0)
        # Phase 9's: the functional calls, the step_fn graph's capture and
        # the state gradients' forwards.
        entry["phase_9_launches"] = launches_9.get(entry["name"], 0)
    line["functional"] = functional
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
