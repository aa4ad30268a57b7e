#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of the repository

Phases, one line each:
  1. the card (nvidia-smi name and power limit), the torch/CUDA versions,
     and the build of both kernels, csrc/physics_step.cu and
     csrc/raycast.cu (one nvcc each, started together), with ptxas'
     registers and spills;
  2. each kernel against its plain PyTorch version from identical inputs
     on the card.  Physics, one step: the `spheres`, `clamps`,
     `boxes_lines`, `hollow_box` and `gravity_friction` worlds of
     tests/physics_configs.py at 4096 envs, and every main path below at
     30k envs from its reset state, from random inputs and after 10 steps.
     Ray cast: every agent's LIDAR of each main path after those 10 steps,
     the tests/golden/raycast.npz scene tiled to 30k envs with random poses,
     and axis-aligned rays against unrotated boxes; each line counts the
     rays that hit and the rays where one side hits and the other misses.
     Then each kernel's time beside its plain version's (physics at each
     main path, the ray cast at navigation@30k);
  3. the main paths: make_env(name, num_envs=30_000, device="cuda") for
     transport, simple_spread, navigation, flocking and balance, reset,
     200 env.step calls under torch.cuda.set_sync_debug_mode("error") (any
     host sync fails the run); outputs finite and of the JAX package's
     shapes; exactly one physics launch per step and one ray-cast launch
     per LIDAR measure (4 a step in navigation and flocking, none
     elsewhere), each count set to 0 just before the run and read just
     after.  Then each CUDA env against the CPU env (plain path) from one
     state over 10 steps at 64 envs;
  4. env-steps/s of each 200-step rollout through the kernels and with
     both kernels forced off (the world on its plain physics, the ray cast
     on cast_rays_plain), in turns (kernel, plain, plain, kernel), timed
     with CUDA events;
  5. a torch.profiler trace of 50 steady steps of each scenario at 30k,
     kernels on and off: wall ms a step (CUDA events, without the
     profiler), device busy ms a step, idle share, device kernels a step,
     and each kernel's device ms a step.

The line before the last is a JSON object describing each kernel; the last
line is {"ok": true, "device": {...}}.  Without CUDA, or without the
package beside it, the script fails before printing any result.

    python3 chip_smoke.py --ab PARENT_ROOT [PAIRS]

compares this checkout's package with another checkout's (for example the
parent commit unpacked with `git archive` into a gitignored directory) on
one card: PAIRS (default 10) alternating pairs of processes, each running
two 200-step rollouts of transport and simple_spread at 30k envs and 200
back-to-back physics wrapper calls; it prints each run and a JSON summary.
"""
import contextlib
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
N_ENVS = 30_000
N_STEPS = 200
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
# (scenario, agents, obs width, ray-cast launches a step)
MAIN_PATHS = [
    ("transport", 4, 11, 0),
    ("simple_spread", 3, 14, 0),
    ("navigation", 4, 18, 4),
    ("flocking", 4, 18, 4),
    ("balance", 3, 16, 0),
]
# The H100 SXM's published rates (NVIDIA's data sheet): device
# memory and fp32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# Arithmetic per pair class and substep of csrc/physics_step.cu, and per
# ray and entity class of csrc/raycast.cu (each sqrt, sin, cos, exp, log
# and division counted as one operation), counted from the sources.
PHYSICS_OPS = {"ss": 29, "bs": 131, "ls": 42, "ll": 133, "bl": 470,
               "bb": 3300, "entity": 25}
CAST_OPS = {"ray": 3, "sphere": 37, "box": 55, "line": 28}


def log(msg):
    print(msg, flush=True)


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


def kernel_vs_plain(world, inputs, label):
    import torch
    from vectorizedmultiagentsimulator_tpu_torch.ops import physics_cuda

    assert world._use_kernel, f"{label}: world does not step through the kernel"
    with torch.no_grad():
        got = physics_cuda.fused_step(world, *inputs)
        ref = physics_cuda.step_plain(world, *inputs)
    torch.cuda.synchronize()
    err, ok = max_err(got, ref, ATOL, RTOL)
    pairs = " ".join(f"{c}={len(p)}" for c, p in world._pairs.items() if len(p))
    log(f"[2] physics {label}: B={world.batch_dim} N={world._n_entities}"
        f" {pairs} max|kernel-plain| pos/vel/rot/ang_vel = {err:.3e}")
    if not ok:
        raise AssertionError(
            f"{label}: kernel disagrees with plain beyond {ATOL} + {RTOL}|ref|"
        )
    return err


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


def main_path(name, n_agents, obs_dim, casts_per_step):
    """200 steps of make_env(name) at 30k envs on the card with no host
    sync; returns the physics and ray-cast launches counted in that run."""
    import torch
    import vectorizedmultiagentsimulator_tpu_torch as vmt
    from vectorizedmultiagentsimulator_tpu_torch.ops import (
        physics_cuda,
        raycast_cuda,
    )

    env = vmt.make_env(name, num_envs=N_ENVS, device="cuda", seed=0)
    env.reset()
    assert env.world._use_kernel, f"{name} does not step through the kernel"
    g = torch.Generator(device="cuda").manual_seed(1)
    sizes = [env.get_agent_action_size(a) for a in env.agents]
    torch.cuda.synchronize()
    physics_cuda.LAUNCHES = 0
    raycast_cuda.LAUNCHES = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(N_STEPS):
            actions = [
                torch.rand((N_ENVS, s), generator=g, device="cuda") * 2 - 1
                for s in sizes
            ]
            obs, rews, dones, _ = env.step(actions)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    steps, casts = physics_cuda.LAUNCHES, raycast_cuda.LAUNCHES
    torch.cuda.synchronize()
    assert len(obs) == n_agents and len(rews) == n_agents
    for o, r in zip(obs, rews):
        assert tuple(o.shape) == (N_ENVS, obs_dim), o.shape
        assert tuple(r.shape) == (N_ENVS,), r.shape
        assert bool(torch.isfinite(o).all()) and bool(torch.isfinite(r).all())
    assert tuple(dones.shape) == (N_ENVS,) and dones.dtype == torch.bool
    s = env.world.state
    for f in ("pos", "vel", "rot", "ang_vel"):
        assert bool(torch.isfinite(getattr(s, f)).all()), f
    if steps != N_STEPS or casts != N_STEPS * casts_per_step:
        raise AssertionError(
            f"{name}: {steps} physics and {casts} ray-cast launches in"
            f" {N_STEPS} steps (expected {N_STEPS} and"
            f" {N_STEPS * casts_per_step})"
        )
    log(f"[3] {name}@{N_ENVS}: {N_STEPS} steps, no host sync, obs"
        f" {n_agents}x[{N_ENVS}, {obs_dim}] finite, physics launches {steps},"
        f" ray-cast launches {casts}")
    return steps, casts


def cuda_vs_cpu(name, n_envs=64, n_steps=10):
    """The whole step on the card (kernels) against the CPU env (plain
    path) from one injected state, at the parity tests' tolerance
    (5e-4 growing x1.6 a step, plus 2e-3 relative)."""
    import torch
    import vectorizedmultiagentsimulator_tpu_torch as vmt
    from vectorizedmultiagentsimulator_tpu_torch.utils import (
        state_from_numpy,
        state_to_numpy,
    )

    env_g = vmt.make_env(name, num_envs=n_envs, device="cuda", seed=0)
    env_c = vmt.make_env(name, num_envs=n_envs, device="cpu", seed=0)
    state_from_numpy(env_c, state_to_numpy(env_g))
    g = torch.Generator().manual_seed(2)
    worst = 0.0
    for t in range(n_steps):
        acts = [
            torch.rand((n_envs, env_c.get_agent_action_size(a)), generator=g)
            * 2 - 1
            for a in env_c.agents
        ]
        out_g = env_g.step([a.cuda() for a in acts])
        out_c = env_c.step(acts)
        atol = 5e-4 * 1.6**t
        for xg, xc in zip(out_g[0] + out_g[1], out_c[0] + out_c[1]):
            d = (xg.cpu() - xc).abs()
            worst = max(worst, float(d.max()))
            if not bool((d <= atol + 2e-3 * xc.abs()).all()):
                raise AssertionError(f"{name}: cuda and cpu differ at step {t}")
        assert bool((out_g[2].cpu() == out_c[2]).all()), f"{name}: dones differ"
    log(f"[3] {name}@{n_envs}: cuda (kernels) vs cpu (plain) over {n_steps}"
        f" steps, max |diff| obs/rew = {worst:.3e}")


@contextlib.contextmanager
def kernels(env, on):
    """Run ``env`` through both kernels, or with both forced off: the world
    on its plain physics and every ray cast on ``cast_rays_plain``."""
    from vectorizedmultiagentsimulator_tpu_torch.ops import raycast_cuda

    fused = raycast_cuda.fused_cast_rays
    env.world._use_kernel = on
    if not on:
        raycast_cuda.fused_cast_rays = raycast_cuda.cast_rays_plain
    try:
        yield
    finally:
        raycast_cuda.fused_cast_rays = fused
        env.world._use_kernel = True


def random_actions(env, n, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    return [
        [torch.rand((N_ENVS, env.get_agent_action_size(a)), generator=g,
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
    return N_ENVS / (ms / 1e3)


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
                     ("cast_rays_kernel", "raycast")):
        named[tag] = sum(e.time_range.elapsed_us() for e in device
                         if key in e.name) / 1e3 / n
    return wall, busy, 1.0 - busy / wall, len(device) / n, named


def rate_worker(root):
    """``--rate ROOT``: for each scenario of AB_SCENARIOS, two 200-step
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
    import vectorizedmultiagentsimulator_tpu_torch as vmt
    from vectorizedmultiagentsimulator_tpu_torch.ops import (
        physics_cuda,
        raycast_cuda,
    )
    from physics_configs import CONFIGS
    from torch_helpers import build_world, random_step_inputs

    # ---- 1: card, versions, build ---- #
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"[1] torch {torch.__version__} CUDA {torch.version.cuda}"
        f" device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        libs = list(pool.map(lambda m: m.build(), (physics_cuda, raycast_cuda)))
    physics_cuda._library()
    raycast_cuda._library()
    log(f"[1] built {', '.join(os.path.relpath(p, ROOT) for p in libs)} in"
        f" {time.perf_counter() - t0:.2f} s")
    for lib in libs:
        with open(os.path.join(os.path.dirname(lib), "build.log")) as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    log(f"[1] ptxas {os.path.basename(lib)}: {line.strip()}")

    # ---- 2: kernels vs plain on the card ---- #
    errs, cast_errs, times = [], [], {}
    for cfg in ("spheres", "clamps", "boxes_lines", "hollow_box",
                "gravity_friction"):
        w, _ = build_world(CONFIGS[cfg], 4096, device="cuda")
        errs.append(kernel_vs_plain(
            w, random_step_inputs(w, spread=CONFIGS[cfg]["spread"], seed=4), cfg
        ))
    for name, *_ in MAIN_PATHS:
        # Each main path at its own shapes: from its reset state, from
        # random inputs, and after 10 steps (so that LIDAR rays hit), where
        # every agent's LIDAR is cast too.
        env = vmt.make_env(name, num_envs=N_ENVS, device="cuda", seed=0)
        w = env.world
        label = f"{name}@{N_ENVS}"
        errs.append(kernel_vs_plain(w, state_inputs(w), f"{label} reset"))
        r_inputs = random_step_inputs(w, spread=0.3, seed=3)
        errs.append(kernel_vs_plain(w, r_inputs, f"{label} random"))
        for a in random_actions(env, 10, seed=5):
            env.step(a)
        errs.append(kernel_vs_plain(w, state_inputs(w), f"{label} 10 steps"))
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

    # ---- 3: the main paths ---- #
    launches = {"physics_step": 0, "raycast": 0}
    for name, n_agents, obs_dim, casts in MAIN_PATHS:
        steps, cast_count = main_path(name, n_agents, obs_dim, casts)
        launches["physics_step"] += steps
        launches["raycast"] += cast_count
    for name, *_ in MAIN_PATHS:
        cuda_vs_cpu(name)

    # ---- 4: rollout rates, kernels on vs off, in turns ---- #
    for name, *_ in MAIN_PATHS:
        env = vmt.make_env(name, num_envs=N_ENVS, device="cuda", seed=0)
        actions = random_actions(env, N_STEPS, seed=7)
        rates = {True: [], False: []}
        for on in (True, False, False, True):
            rates[on].append(rollout_rate(env, actions, on))
        log(f"[4] {name}@{N_ENVS} {N_STEPS}-step rollout env-steps/s:"
            f" kernels {rates[True][0]:.6g} {rates[True][1]:.6g},"
            f" plain {rates[False][0]:.6g} {rates[False][1]:.6g}")
        del env, actions

    # ---- 5: where a step's time goes ---- #
    for name, *_ in MAIN_PATHS:
        env = vmt.make_env(name, num_envs=N_ENVS, device="cuda", seed=0)
        actions = random_actions(env, 50, seed=8)
        for on in (True, False):
            wall, busy, idle, n_kernels, named = profile_steps(env, actions, on)
            log(f"[5] {name}@{N_ENVS} {'kernels' if on else 'plain'}: wall"
                f" {wall:.4f} ms/step, device busy {busy:.4f} ms/step, idle"
                f" share {idle:.4f}, {n_kernels:.1f} device kernels/step,"
                f" physics kernel {named['physics']:.4f} ms/step, ray-cast"
                f" kernel {named['raycast']:.4f} ms/step")
        del env, actions

    print(json.dumps({"kernels": [
        {
            "name": "physics_step",
            "route": "cuda",
            "source": "vectorizedmultiagentsimulator_tpu_torch/csrc/physics_step.cu",
            "replaces": "vectorizedmultiagentsimulator_tpu/ops/physics_pallas.py:93",
            "launches": launches["physics_step"],
            "max_abs_err": max(errs),
            "ms": kernel_ms,
            "plain_ms": plain_ms,
            "bound_ms": phys_bound,
            "bound_by": phys_by,
            "library_ms": None,
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
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
