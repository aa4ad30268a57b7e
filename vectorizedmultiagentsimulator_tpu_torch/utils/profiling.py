"""Timing and tracing of steps on the card: the counterpart of the JAX
package's ``utils/profiling.py``.

``benchmark_step`` times replays of a CUDA graph of ``env.step``
(``parallel/rollout.py``) on the host clock, each ended by
``torch.cuda.synchronize()``, as the JAX version times its scan ended by
``block_until_ready``.  ``trace`` and ``profile_step`` record a
``torch.profiler`` trace of the card and the host.  A measurement needs the
card: on a CPU env they raise.
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Optional, Sequence

import torch

from vectorizedmultiagentsimulator_tpu_torch.parallel.rollout import rollout


def uniform_actions(env, seed: int = 0) -> list:
    """Fixed actions uniform in [-1, 1] for every agent, drawn from
    ``seed`` on the env's device (the workload of the JAX package's
    ``benchmark_step`` and ``bench.py``)."""
    g = torch.Generator(device=env.device).manual_seed(seed)
    return [torch.rand((env.num_envs, env.get_agent_action_size(a)),
                       generator=g, device=env.device) * 2 - 1
            for a in env.agents]


class _FixedActions:
    """A policy that returns the same action buffers every step; new
    actions are copied into them, so that one captured graph serves every
    call with actions of these shapes."""

    def __init__(self, actions):
        self.buffers = [a.clone() for a in actions]

    def load(self, actions) -> bool:
        if [a.shape for a in actions] != [b.shape for b in self.buffers]:
            return False
        for b, a in zip(self.buffers, actions):
            if a is not b:
                b.copy_(a)
        return True

    def __call__(self, obs, generator):
        return self.buffers


def _first_leaf(obs) -> torch.Tensor:
    """The first tensor of an agent's observation (a tensor, or nested
    dicts of them)."""
    while isinstance(obs, dict):
        obs = next(iter(obs.values()))
    return obs


def _sink(env, outs):
    """A step's consumed outputs: the sum of every agent's first
    observation column and of every reward, as the JAX ``benchmark_step``
    and ``bench.py`` reduce them."""
    obs = outs[0].values() if isinstance(outs[0], dict) else outs[0]
    rews = outs[1].values() if isinstance(outs[1], dict) else outs[1]
    total = sum(_first_leaf(o)[:, 0].sum() for o in obs)
    return total + sum(r.sum() for r in rews)


def _policy(env, actions):
    """The env's fixed-action policy, loaded with ``actions``."""
    policy = env.__dict__.get("_benchmark_policy")
    if policy is None or not policy.load(actions):
        policy = env.__dict__["_benchmark_policy"] = _FixedActions(actions)
    return policy


def benchmark_step(
    env,
    n_steps: int = 100,
    n_repeats: int = 3,
    actions: Optional[Sequence[torch.Tensor]] = None,
    warmup: bool = True,
    chunk: Optional[int] = None,
):
    """Steady-state env-steps/s of ``env`` (a CUDA env): ``n_repeats``
    timings of ``n_steps`` steps with fixed ``actions`` (default
    ``uniform_actions(env)``), each a CUDA graph of ``chunk`` steps
    (default ``n_steps``) replayed ``n_steps / chunk`` times, on the host
    clock ended by ``torch.cuda.synchronize()``; with ``warmup`` one
    untimed run first (the graph is captured in the first run).  Each step's
    observations and rewards are consumed into a sink, checked finite
    after the timings.

    Returns ``{"wall_s", "env_steps_per_s", "agent_steps_per_s",
    "times"}``, the best of the timings."""
    if env.device.type != "cuda":
        raise RuntimeError(
            f"benchmark_step measures the card; this env is on {env.device}")
    policy = _policy(env, uniform_actions(env) if actions is None
                     else actions)

    def run():
        return rollout(env, policy, n_steps, collect=_sink, chunk=chunk)[1]

    if warmup:
        run()
        torch.cuda.synchronize()
    times = []
    for _ in range(n_repeats):
        t0 = time.perf_counter()
        sink = run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    if not bool(torch.isfinite(sink).all()):
        raise FloatingPointError(
            "benchmark_step: non-finite values in the rollout's outputs")
    best = min(times)
    if best * 1e3 < 1.0 and n_steps * env.num_envs > 1_000_000:
        raise RuntimeError(
            f"benchmark_step: implausible wall time {best:.6f}s for"
            f" {n_steps} steps x {env.num_envs} envs")
    eps = n_steps * env.num_envs / best
    return {
        "wall_s": best,
        "env_steps_per_s": eps,
        "agent_steps_per_s": eps * env.n_agents,
        "times": times,
    }


def _default_log_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "vmt_torch_profile")


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """A ``torch.profiler`` trace of the host and the card over the block;
    yields the profiler (``key_averages()`` sums by kernel) and writes its
    Chrome trace to ``log_dir/trace.json`` (default under the temporary
    directory)."""
    if not torch.cuda.is_available():
        raise RuntimeError("trace records the card; none is available")
    log_dir = log_dir or _default_log_dir()
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def profile_step(env, n_steps: int = 20, log_dir: Optional[str] = None):
    """A traced ``benchmark_step`` of ``n_steps`` steps (one timing after
    the warm-up); returns the trace's directory."""
    log_dir = log_dir or _default_log_dir()
    with trace(log_dir):
        benchmark_step(env, n_steps=n_steps, n_repeats=1, warmup=True)
    return log_dir
