#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of the repository

Phases, one line each:
  1. the card (nvidia-smi name and power limit), the torch/CUDA versions,
     and the build of the physics kernel from csrc/physics_step.cu;
  2. the kernel against its plain PyTorch version, one step from identical
     inputs on the card, for the transport world at 30k envs and the
     `spheres` and `clamps` worlds of tests/physics_configs.py at 4096;
     and the kernel's time beside the plain version's at transport@30k;
  3. the main path: make_env("transport", num_envs=30_000, device="cuda"),
     reset, 200 env.step calls under torch.cuda.set_sync_debug_mode
     ("error") (any host sync fails the run); outputs finite and of the
     JAX package's shapes; exactly one kernel launch per step.  The same
     for simple_spread@30k.  Then the CUDA env against the CPU env (plain
     path) from one state over 10 steps at 64 envs;
  4. env-steps/s of the 200-step rollout through the kernel and with the
     world forced onto the plain path, in turns (kernel, plain, plain,
     kernel), timed with CUDA events.

The line before the last is a JSON object describing each kernel; the last
line is {"ok": true, "device": {...}}.  Without CUDA, or without the
package beside it, the script fails before printing any result.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
N_ENVS = 30_000
N_STEPS = 200
# Kernel vs plain, one step from identical inputs: the two sum each
# entity's fp32 forces in another order, and the card's libm is not the
# CPU's; contact penalties (collision_force 100 over a 1e-3 margin) turn
# a one-ulp force difference into ~1e-6 of velocity.  1e-4 absolute plus
# 1e-4 relative leaves two orders of magnitude over that.
ATOL = 1e-4
RTOL = 1e-4


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


def max_err(got, ref):
    """(max abs difference, whether every element is within tolerance)."""
    worst, ok = 0.0, True
    for g, r in zip(got, ref):
        d = (g - r).abs()
        worst = max(worst, float(d.max()) if d.numel() else 0.0)
        ok = ok and bool((d <= ATOL + RTOL * r.abs()).all())
    return worst, ok


def kernel_vs_plain(world, inputs, label):
    import torch
    from vectorizedmultiagentsimulator_tpu_torch.ops import physics_cuda

    assert world._use_kernel, f"{label}: world does not step through the kernel"
    with torch.no_grad():
        got = physics_cuda.fused_step(world, *inputs)
        ref = physics_cuda.step_plain(world, *inputs)
    torch.cuda.synchronize()
    err, ok = max_err(got, ref)
    log(f"[2] {label}: B={world.batch_dim} N={world._n_entities}"
        f" ss={len(world._pairs['ss'])} bs={len(world._pairs['bs'])}"
        f" max|kernel-plain| pos/vel/rot/ang_vel = {err:.3e}")
    if not ok:
        raise AssertionError(
            f"{label}: kernel disagrees with plain beyond {ATOL} + {RTOL}|ref|"
        )
    return err


def main_path(name, n_agents, obs_dim):
    """200 steps of make_env(name) at 30k envs on the card with no host
    sync; returns the kernel launches counted in that run."""
    import torch
    import vectorizedmultiagentsimulator_tpu_torch as vmt
    from vectorizedmultiagentsimulator_tpu_torch.ops import physics_cuda

    env = vmt.make_env(name, num_envs=N_ENVS, device="cuda", seed=0)
    env.reset()
    assert env.world._use_kernel, f"{name} does not step through the kernel"
    g = torch.Generator(device="cuda").manual_seed(1)
    sizes = [env.get_agent_action_size(a) for a in env.agents]
    torch.cuda.synchronize()
    physics_cuda.LAUNCHES = 0
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
    launches = physics_cuda.LAUNCHES
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
    if launches != N_STEPS:
        raise AssertionError(
            f"{name}: {launches} kernel launches in {N_STEPS} steps"
        )
    log(f"[3] {name}@{N_ENVS}: {N_STEPS} steps, no host sync, obs"
        f" {n_agents}x[{N_ENVS}, {obs_dim}] finite, kernel launches {launches}")
    return launches


def cuda_vs_cpu(name, n_envs=64, n_steps=10):
    """The whole step on the card (kernel) against the CPU env (plain
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
    log(f"[3] {name}@{n_envs}: cuda (kernel) vs cpu (plain) over {n_steps}"
        f" steps, max |diff| obs/rew = {worst:.3e}")


def rollout_rate(env, actions, use_kernel):
    import torch

    env.world._use_kernel = use_kernel
    for a in actions[:10]:
        env.step(a)
    torch.cuda.synchronize()
    ms = cuda_time_ms(lambda it=iter(actions): env.step(next(it)), len(actions))
    return N_ENVS / (ms / 1e3)


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA GPU; none is available")
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import vectorizedmultiagentsimulator_tpu_torch as vmt
    from vectorizedmultiagentsimulator_tpu_torch.ops import physics_cuda
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
    lib = physics_cuda.build()
    physics_cuda._library()
    log(f"[1] built {os.path.relpath(lib, ROOT)} in"
        f" {time.perf_counter() - t0:.2f} s")
    with open(os.path.join(os.path.dirname(lib), "build.log")) as f:
        for line in f:
            if "registers" in line or "spill" in line:
                log("[1] ptxas: " + line.strip())

    # ---- 2: kernel vs plain on the card ---- #
    errs = []
    env = vmt.make_env("transport", num_envs=N_ENVS, device="cuda", seed=0)
    tw = env.world
    t_inputs = random_step_inputs(tw, spread=0.3, seed=3)
    errs.append(kernel_vs_plain(tw, t_inputs, f"transport@{N_ENVS}"))
    s = tw.state
    reset_inputs = (s.pos, s.vel, s.rot, s.ang_vel, s.force, s.torque,
                    physics_cuda.stacked_dyn_gravity(tw, s.extras))
    errs.append(kernel_vs_plain(tw, reset_inputs, f"transport@{N_ENVS} reset"))
    for cfg in ("spheres", "clamps"):
        w, _ = build_world(CONFIGS[cfg], 4096, device="cuda")
        errs.append(kernel_vs_plain(
            w, random_step_inputs(w, spread=CONFIGS[cfg]["spread"], seed=4), cfg
        ))
    with torch.no_grad():
        kernel_ms = cuda_time_ms(lambda: physics_cuda.fused_step(tw, *t_inputs), 50)
        plain_ms = cuda_time_ms(lambda: physics_cuda.step_plain(tw, *t_inputs), 50)
    log(f"[2] transport@{N_ENVS} one physics step: kernel {kernel_ms:.4f} ms,"
        f" plain {plain_ms:.4f} ms")
    del env, tw, t_inputs, reset_inputs, s

    # ---- 3: the main path ---- #
    launches = main_path("transport", 4, 11)
    main_path("simple_spread", 3, 14)
    cuda_vs_cpu("transport")
    cuda_vs_cpu("simple_spread")

    # ---- 4: rollout rates, kernel vs plain, in turns ---- #
    for name in ("transport", "simple_spread"):
        env = vmt.make_env(name, num_envs=N_ENVS, device="cuda", seed=0)
        g = torch.Generator(device="cuda").manual_seed(5)
        actions = [
            [torch.rand((N_ENVS, env.get_agent_action_size(a)), generator=g,
                        device="cuda") * 2 - 1 for a in env.agents]
            for _ in range(N_STEPS)
        ]
        rates = {"kernel": [], "plain": []}
        for mode in ("kernel", "plain", "plain", "kernel"):
            rates[mode].append(rollout_rate(env, actions, mode == "kernel"))
        log(f"[4] {name}@{N_ENVS} {N_STEPS}-step rollout env-steps/s:"
            f" kernel {rates['kernel'][0]:.6g} {rates['kernel'][1]:.6g},"
            f" plain {rates['plain'][0]:.6g} {rates['plain'][1]:.6g}")
        del env, actions

    print(json.dumps({"kernels": [{
        "name": "physics_step",
        "route": "cuda",
        "source": "vectorizedmultiagentsimulator_tpu_torch/csrc/physics_step.cu",
        "replaces": "vectorizedmultiagentsimulator_tpu/ops/physics_pallas.py:93",
        "launches": launches,
        "max_abs_err": max(errs),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
