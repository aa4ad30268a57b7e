"""The rollout traffic: one collector in a closed loop, as an RL user's
data collection runs.  Each call is the port's ``parallel.rollout`` of
``steps_per_call`` steps of ``num_envs`` envs (a CUDA graph replayed) with
the benchmark's policy (``policy.py``) inside the graph, collecting
``collect``; the caller waits for each call (a synchronize) before the
next, and each call goes on from the state the previous one left.  No env
is reset: both configurations end an episode only on success.

Set-up: the env at its size, the initial state drawn from the seed (the
configuration's reference, ``initial_state``) and set through the port's
state API, one call that captures the graph and one that replays it; then
the state is set back to the initial one.  The window: calls until
``--seconds`` have passed, each timed from the call to the synchronize
after it.

The comparison: ``check_calls`` calls, the first of the window and others
drawn from the seed, and of each ``check_rows`` envs drawn from the seed.
Before such a call the benchmark keeps those envs' state, after it those
envs' outputs (and, before it, the last observations of the call before).
Once the window has closed and the program is freed, the reference
steps each kept state through the same policy for ``steps_per_call``
steps.  The first call starts from the benchmark's own initial state;
the later ones from the program's state, the carry between calls being
checked by itself (``carry_gap``).
"""
from __future__ import annotations

import gc
import statistics
import time

import numpy as np

from portbench.common import (STATE_FIELDS, program_state, sub_seeds, sync,
                              take_rows)
from portbench.policy import LinearTanhPolicy
from portbench.reference import world as W
from portbench.result import Check, RunResult
from portbench.spec import Cell
from portbench.trace import graph_kernel_nodes, kept_graphs, profile

def cast(state: dict, dtype) -> dict:
    def c(v):
        return v.to(dtype) if v.is_floating_point() else v

    out = {f: c(state[f]) for f in STATE_FIELDS}
    out["extras"] = {k: c(v) for k, v in state["extras"].items()}
    return out


def reference_calls(cell: Cell, snaps: dict, plan: dict, policy,
                    n_steps: int, dtype) -> dict:
    """The reference's ``n_steps`` steps from each kept state, all kept
    calls' envs at once (envs are independent), under ``policy`` and
    computed in ``dtype``: for each call, (observations of its starting
    state [A, R, D], (obs [A, n, R, D], rews [A, n, R], dones [n, R]))."""
    import torch

    ref = cell.reference
    calls = sorted(snaps)
    st = {f: torch.cat([snaps[k][f] for k in calls]) for f in STATE_FIELDS}
    st["extras"] = {e: torch.cat([snaps[k]["extras"][e] for k in calls])
                    for e in snaps[calls[0]]["extras"]}
    st = cast(st, dtype)
    policy = policy.rows(torch.cat([plan[k] for k in calls]))
    T = W.Tables(cell.config, st["pos"].device, dtype)
    with torch.no_grad():
        obs = obs0 = ref.observe(T, st)
        steps = []
        for _ in range(n_steps):
            st, obs, rew, done = ref.step(T, st, policy(obs, st["steps"]))
            steps.append((obs.float(), rew.float(), done))
    outs = (torch.stack([o for o, _, _ in steps], 1),
            torch.stack([r for _, r, _ in steps], 1),
            torch.stack([d for _, _, d in steps]))
    sizes = [len(plan[k]) for k in calls]
    split = zip(obs0.float().split(sizes, 1),
                *(x.split(sizes, -1 if x.dim() < 4 else 2) for x in outs))
    return {k: (o0, (o, r, d)) for k, (o0, o, r, d) in zip(calls, split)}


def call_gaps(program, ref):
    """``[n_steps, R]``: each env's widest gap at each step between two
    sides' outputs (obs [A, n, R, D], rews [A, n, R], dones [n, R]): over
    its agents' observations and rewards, a done that differs counting 1.
    Non-finite gaps count as infinite."""
    import torch

    gap = (program[0] - ref[0]).abs().amax(dim=(0, 3))
    gap = torch.maximum(gap, (program[1] - ref[1]).abs().amax(0))
    gap = torch.maximum(gap, (program[2] != ref[2]).float())
    return torch.nan_to_num(gap, nan=float("inf"))


def compare(cell, plan, snaps, outs, carries, policy, n_steps, dtype):
    """The comparison's numbers over the kept calls: ``step0_gap``, the
    widest gap of any env at a call's first step; ``median_env_gap``, of
    the calls the largest median over envs of an env's widest gap over
    the call; ``carry_gap``, the widest gap between the reference's
    observations of a call's starting state and the program's last
    observations of the call before; ``widest_gap`` (reported, not
    compared), the widest of all."""
    import torch

    ref = reference_calls(cell, snaps, plan, policy, n_steps, dtype)
    step0 = median = widest = carry = 0.0
    for k in sorted(outs):
        obs0, ref_out = ref[k]
        gaps = call_gaps(outs[k], ref_out)
        step0 = max(step0, float(gaps[0].max()))
        median = max(median, float(gaps.amax(0).median()))
        widest = max(widest, float(gaps.max()))
        if k in carries:
            carry = max(carry, float(torch.nan_to_num(
                (carries[k] - obs0).abs().max(), nan=float("inf"))))
    return {"step0_gap": step0, "median_env_gap": median,
            "carry_gap": carry, "widest_gap": widest}


class Rollouts:
    """The program's side: the env, the policy and the timed call."""

    def __init__(self, cell: Cell, seed: int, device="cuda",
                 keep_graph: bool = False):
        import torch

        import vectorizedmultiagentsimulator_tpu_torch as vmt
        from vectorizedmultiagentsimulator_tpu_torch.parallel import rollout

        cfg, tr = cell.config, cell.traffic
        self.cell = cell
        self.n_steps = tr["steps_per_call"]
        self.num_envs = B = tr["num_envs"]
        s_state, s_policy, s_env, self.s_sample = sub_seeds(seed, 4)
        self.device = dev = torch.device(device)
        g = torch.Generator(device=dev)
        init = cell.reference.initial_state(cfg, B, g.manual_seed(s_state),
                                            dev)
        self.policy = LinearTanhPolicy(
            len(cfg["agents"]), cfg["obs_dim"], cfg["action_dim"], B,
            g.manual_seed(s_policy), dev)
        self.env = env = vmt.make_env(cfg["scenario"], num_envs=B,
                                      device=dev, seed=s_env, **cfg["kwargs"])
        self.start = program_state(env, init)
        env.state = self.start
        policy = self.policy

        def act(obs, generator):
            return list(policy(torch.stack(obs), env.world.state.steps)
                        .unbind(0))

        collect = tuple(tr["collect"])
        self.call = lambda: rollout(env, act, n_steps=self.n_steps,
                                    chunk=self.n_steps, collect=collect)[1]
        self.graphs = []
        if keep_graph:
            with kept_graphs(self.graphs):
                self.call()
        else:
            self.call()
        sync(dev)
        t0 = time.perf_counter()
        self.call()
        sync(dev)
        self.call_s = time.perf_counter() - t0
        env.state = self.start
        sync(dev)

    def plan(self, seconds: float) -> dict:
        """The calls to compare, each with its envs (a sorted device
        tensor): the first call and ``check_calls - 1`` drawn from the
        seed among those the window should reach (at four fifths of the
        warm call's rate)."""
        import torch

        tr = self.cell.traffic
        rng = np.random.default_rng(self.s_sample)
        reach = max(2, int(0.8 * seconds / max(self.call_s, 1e-6)))
        later = rng.choice(np.arange(1, reach), replace=False,
                           size=min(tr["check_calls"] - 1, reach - 1))
        out = {}
        for k in [0] + sorted(int(x) for x in later):
            rows = np.sort(rng.choice(self.num_envs, tr["check_rows"],
                                      replace=False))
            out[k] = torch.as_tensor(rows, device=self.device)
        return out

    def free(self):
        """Drop the env, its graph and its state."""
        import torch

        self.env = self.call = self.start = None
        self.graphs.clear()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()


def gather(traj, rows):
    """A call's outputs of the envs ``rows``: obs [A, n, R, D], rews
    [A, n, R], dones [n, R]."""
    import torch

    return (torch.stack([o[:, rows] for o in traj["obs"]]),
            torch.stack([r[:, rows] for r in traj["rews"]]),
            traj["dones"][:, rows])


def window(prog: Rollouts, seconds: float, plan: dict):
    """Calls until ``seconds`` have passed: (each call's seconds, the
    window's seconds, kept states, kept outputs, kept last observations)."""
    import torch

    snaps, outs, carries, times = {}, {}, {}, []
    env = prog.env
    dev = prog.device
    begin = time.perf_counter()
    while True:
        k = len(times)
        if k in plan:
            snaps[k] = take_rows(env.world.state, plan[k])
        t0 = time.perf_counter()
        traj = prog.call()
        sync(dev)
        t1 = time.perf_counter()
        times.append(t1 - t0)
        if k in plan:
            outs[k] = gather(traj, plan[k])
        if k + 1 in plan:
            carries[k + 1] = torch.stack([o[-1, plan[k + 1]]
                                          for o in traj["obs"]])
        if t1 - begin >= seconds:
            return times, t1 - begin, snaps, outs, carries


def run(cell: Cell, args, started: float, device="cuda") -> RunResult:
    import torch

    prog = Rollouts(cell, args.seed, device, keep_graph=bool(args.trace))
    plan = prog.plan(args.seconds)
    setup_s = time.perf_counter() - started
    times, window_s, snaps, outs, carries = window(prog, args.seconds, plan)
    res = RunResult(cell=cell, attempted=len(times))
    if prog.device.type == "cuda":
        res.memory_peak_bytes = torch.cuda.max_memory_allocated()
    n, B = prog.n_steps, prog.num_envs
    res.metrics = {
        "env_steps_per_s": len(times) * n * B / window_s,
        "rollout_ms_p95": 1e3 * (statistics.quantiles(
            times, n=100, method="inclusive")[94] if len(times) > 1
            else times[0]),
        "peak_mem_gib": res.memory_peak_bytes / 2**30,
        "setup_s": setup_s,
    }
    if args.trace:
        calls = cell.traffic["trace_calls"]
        res.trace = profile(prog.call, calls, warmup=1)
        res.trace.steps = calls * n
        (graph,) = prog.graphs
        res.graph_nodes = graph_kernel_nodes(graph)
        res.graph_steps = n
    prog.free()
    res.failed = sum(not bool(torch.isfinite(o).all())
                     for out in outs.values() for o in out[:2])
    got = compare(cell, plan, snaps, outs, carries, prog.policy, n,
                  torch.float32)
    res.checks = [Check(k, got[k], cell.limits[k]) for k in cell.limits]
    res.extra = {"widest_gap": got["widest_gap"], "calls_compared": len(outs)}
    return res


def calibrate(cell: Cell, seed: int, seconds: float, control: bool) -> dict:
    """One seed's readings for ``calibrate.py``: a short window at the
    cell's size, the program's numbers and, with ``control``, those of
    the bfloat16 reference put in the program's place from the same kept
    states."""
    import torch

    prog = Rollouts(cell, seed)
    plan = prog.plan(seconds)
    times, _, snaps, outs, carries = window(prog, seconds, plan)
    prog.free()
    n = prog.n_steps
    row = {"calls": len(times),
           "sound": compare(cell, plan, snaps, outs, carries, prog.policy, n,
                            torch.float32)}
    if control:
        low = reference_calls(cell, snaps, plan, prog.policy, n,
                              torch.bfloat16)
        row["control"] = compare(cell, plan, snaps,
                                 {k: low[k][1] for k in outs},
                                 {k: low[k][0] for k in carries},
                                 prog.policy, n, torch.float32)
    return row
