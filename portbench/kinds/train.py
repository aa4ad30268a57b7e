"""The training traffic: whole PPO iterations of the port's trainer
(``examples/torch_ppo.py``: ``init_training``, then per iteration
``Trainer.collect`` and ``Trainer.update``, the body of ``train_step``),
one process on one card, each iteration ended by reading its loss on the
host as a training loop that logs it does.

The benchmark feeds each iteration its action noise (standard normal
``[rollout_steps, A, B, act]``, ``collect(noises=)``) and its epoch
shuffles (a block permutation an epoch, ``update(perms=)``), drawn from
the seed on the device in a few calls, in place of the trainer's own
draws; it sets the initial env state (the configuration's reference,
``initial_state`` with the traffic's ``initial`` arguments) through the
port's state API, and the initial weights (``reference/ppo.py``'s
``init_params``) into the trainer's model.

Set-up builds the trainer and drives it through ``check_iterations``
iterations with that feed; those are compared, and the same trainer
then runs the window: iterations until ``--seconds`` have passed, the
window ending at the synchronize of the iteration in which they ran out.

The comparison, once the window has closed and the program is freed: the
reference trainer (``reference/ppo.py``) runs the same iterations from the
same state, weights and feed.  Numbers: ``loss_gap``, the largest
relative gap of an iteration's mean loss; ``moment_gap``, Adam's first
moment after the first iteration (what the optimizer holds of that
iteration's 16 clipped gradients), and ``change_gap``, the parameters'
change over the compared iterations, each the worst leaf's gap between
the program's norm and the reference's, over the larger of the
reference's norm of that leaf and of the median leaf; ``done_gap``, the
(step, env) done flags that differ.  Leaves whose reference moment is
under a thousandth of the median leaf's are left out of both.
"""
from __future__ import annotations

import gc
import statistics
import time

from portbench.common import program_state, sub_seeds, sync
from portbench.reference import ppo as ppo_ref
from portbench.reference import world as W
from portbench.result import Check, RunResult
from portbench.spec import Cell
from portbench.trace import profile


class Feed:
    """The benchmark's draws for each iteration, from one generator."""

    def __init__(self, seed, shape, n_blocks, epochs, device):
        import torch

        self.g = torch.Generator(device=device).manual_seed(seed)
        self.shape, self.n_blocks, self.epochs = shape, n_blocks, epochs
        self.device = device

    def __call__(self):
        import torch

        noises = torch.randn(self.shape, generator=self.g, device=self.device)
        perms = [torch.argsort(torch.rand(self.n_blocks, generator=self.g,
                                          device=self.device))
                 for _ in range(self.epochs)]
        return noises, perms


class Setup:
    """The inputs, drawn from the seed: the same for both sides."""

    def __init__(self, cell: Cell, seed: int, device):
        import torch

        cfg, tr = cell.config, cell.traffic
        self.cell, self.device = cell, torch.device(device)
        self.num_envs = tr["num_envs"]
        (self.s_state, self.s_params, self.s_feed,
         self.s_env) = sub_seeds(seed, 4)
        ppo = tr["ppo"]
        A = len(cfg["agents"])
        self.obs_d = cfg["obs_dim"] + A
        self.act_w = cfg["action_dim"]
        n = ppo["rollout_steps"] * A * self.num_envs
        self.feed_shape = (ppo["rollout_steps"], A, self.num_envs, self.act_w)
        self.n_blocks = n // ppo["fused_block"]

    def initial_state(self):
        import torch

        g = torch.Generator(device=self.device).manual_seed(self.s_state)
        return self.cell.reference.initial_state(
            self.cell.config, self.num_envs, g, self.device,
            **self.cell.traffic.get("initial", {}))

    def params(self):
        import torch

        g = torch.Generator(device=self.device).manual_seed(self.s_params)
        return ppo_ref.init_params(self.obs_d, self.act_w,
                                   self.cell.traffic["ppo"]["hidden"], g,
                                   self.device)

    def feed(self) -> Feed:
        return Feed(self.s_feed, self.feed_shape, self.n_blocks,
                    self.cell.traffic["ppo"]["epochs"], self.device)


class Training:
    """The program's side: the trainer, driven through the compared
    iterations."""

    def __init__(self, setup: Setup):
        import torch

        from vectorizedmultiagentsimulator_tpu_torch.examples.torch_ppo import (
            PPOConfig,
            init_training,
        )

        cell = setup.cell
        cfg, tr = cell.config, cell.traffic
        self.device = setup.device
        self.env, _, self.trainer = init_training(
            cfg["scenario"], num_envs=setup.num_envs, seed=setup.s_env,
            cfg=PPOConfig(**tr["ppo"]), device=self.device, **cfg["kwargs"])
        env, trainer = self.env, self.trainer
        env.state = program_state(env, setup.initial_state())
        trainer.obs = trainer.pad_obs(env.get_from_scenario(
            get_observations=True, get_rewards=False, get_infos=False,
            get_dones=False)[0])
        self.params0 = setup.params()
        with torch.no_grad():
            for name, p in zip(trainer.model.NAMES,
                               trainer.model.ordered_parameters()):
                p.copy_(self.params0[name].view_as(p))
        self.feed = setup.feed()
        losses, dones = [], []
        for i in range(tr["check_iterations"]):
            loss, _, traj = self.iteration()
            losses.append(loss)
            dones.append(traj["done"][:, 0].clone())
            if i == 0:
                moment = self.leaves(  # zero where Adam holds nothing
                    lambda p: trainer.optimizer.state[p].get(
                        "exp_avg", torch.zeros_like(p)))
        sync(self.device)
        self.readings = Readings(losses, dones, moment,
                                 self.leaves(lambda p: p))

    def leaves(self, get) -> dict:
        model = self.trainer.model
        return {name: get(p).detach().reshape(-1).clone()
                for name, p in zip(model.NAMES, model.ordered_parameters())}

    def iteration(self):
        """One iteration of the window's call: its feed drawn, the
        rollout with GAE and packing, the update, ``train_step``'s mean
        reward; ``(loss, mean reward, traj)`` on the device."""
        noises, perms = self.feed()
        packed, traj = self.trainer.collect(noises)
        loss = self.trainer.update(packed, perms)
        return loss, traj["rew"].mean(), traj

    def free(self):
        import torch

        self.env = self.trainer = self.feed = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()


class Readings:
    """What the comparison reads of one side's compared iterations: each
    iteration's loss and ``[T, B]`` dones, Adam's first moment after the
    first, and the parameters after the last (flat, by name)."""

    def __init__(self, losses, dones, moment, params_after):
        self.losses = [float(x) for x in losses]
        self.dones, self.moment = dones, moment
        self.params_after = params_after


def reference_readings(setup: Setup, trunk="bf16", fault=None) -> Readings:
    """The reference trainer's compared iterations from the same inputs:
    in the configuration's precision, or with ``trunk="fp8"`` (the control)
    or a planted ``fault`` (``reference/ppo.py``)."""
    cell = setup.cell
    T = W.Tables(cell.config, setup.device)
    ref = ppo_ref.Trainer(cell.reference, T, cell.traffic["ppo"],
                          setup.params(), setup.initial_state(), trunk, fault)
    feed = setup.feed()
    losses, dones = [], []
    for i in range(cell.traffic["check_iterations"]):
        loss, done = ref.iteration(*feed())
        losses.append(loss)
        dones.append(done[:, 0])
        if i == 0:
            moment = {k: v.reshape(-1).clone() for k, v in ref.adam.m.items()}
    return Readings(losses, dones, moment,
                    {k: v.reshape(-1) for k, v in ref.params.items()})


def norm_gap(prog: dict, ref: dict, keep) -> float:
    """The worst leaf's gap between the program's norm and the
    reference's, over the larger of the reference's norm of that leaf and
    of the median leaf; ``keep``: the leaves compared."""
    import torch

    p = {k: float(torch.linalg.norm(prog[k].float())) for k in keep}
    r = {k: float(torch.linalg.norm(ref[k].float())) for k in keep}
    median = statistics.median(r.values())
    gap = max(abs(p[k] - r[k]) / max(r[k], median) for k in keep)
    return gap if gap == gap else float("inf")


def numbers(got: Readings, ref: Readings, params0: dict) -> dict:
    """The comparison's numbers of ``got`` against the reference's."""
    import torch

    m_norm = {k: float(torch.linalg.norm(v)) for k, v in ref.moment.items()}
    floor = 1e-3 * statistics.median(m_norm.values())
    keep = [k for k in ppo_ref.NAMES if m_norm[k] >= floor]
    start = {k: params0[k].reshape(-1) for k in keep}
    loss_gap = max(abs(lp - lr) / abs(lr)
                   for lp, lr in zip(got.losses, ref.losses))
    return {
        "loss_gap": loss_gap if loss_gap == loss_gap else float("inf"),
        "moment_gap": norm_gap(got.moment, ref.moment, keep),
        "change_gap": norm_gap(
            {k: got.params_after[k] - start[k] for k in keep},
            {k: ref.params_after[k] - start[k] for k in keep}, keep),
        "done_gap": float(sum(int((a != b).sum())
                              for a, b in zip(got.dones, ref.dones))),
        "leaves_compared": len(keep),
    }


def run(cell: Cell, args, started: float, device="cuda") -> RunResult:
    import torch

    setup = Setup(cell, args.seed, device)
    prog = Training(setup)
    setup_s = time.perf_counter() - started
    T, B = cell.traffic["ppo"]["rollout_steps"], setup.num_envs
    iters = 0
    begin = time.perf_counter()
    while True:
        loss, mean_reward, _ = prog.iteration()
        float(loss), float(mean_reward)  # read, as a logging loop does
        iters += 1
        end = time.perf_counter()
        if end - begin >= args.seconds:
            break
    res = RunResult(cell=cell, attempted=iters)
    if prog.device.type == "cuda":
        res.memory_peak_bytes = torch.cuda.max_memory_allocated()
    res.metrics = {"train_env_steps_per_s": iters * T * B / (end - begin),
                   "peak_mem_gib": res.memory_peak_bytes / 2**30,
                   "setup_s": setup_s}
    if args.trace:
        res.trace = traced(prog, cell.traffic["trace_iterations"])
    prog.free()
    got = numbers(prog.readings, reference_readings(setup), prog.params0)
    res.checks = [Check(k, got[k], cell.limits[k]) for k in cell.limits]
    res.extra = {"leaves_compared": got["leaves_compared"],
                 "losses": prog.readings.losses}
    return res


def traced(prog: Training, iterations: int):
    """The traced run's readings: ``iterations`` iterations with the
    benchmark's spans, ``collect`` and ``update`` (each ended by a
    synchronize) and ``env.step`` (host seconds from call to return, no
    synchronize, by a wrapper on the env instance); then one iteration
    under the profiler, recording the device's operations only, since
    recording each of the eager rollout's host operations would slow the
    host that paces it."""
    import torch

    spans = {"collect": [], "update": [], "env.step": []}
    env = prog.env
    step = env.step

    def timed_step(actions):
        t0 = time.perf_counter()
        out = step(actions)
        spans["env.step"].append(time.perf_counter() - t0)
        return out

    env.step = timed_step
    try:
        for _ in range(iterations):
            noises, perms = prog.feed()
            t0 = time.perf_counter()
            packed, traj = prog.trainer.collect(noises)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            prog.trainer.update(packed, perms)
            torch.cuda.synchronize()
            spans["collect"].append(t1 - t0)
            spans["update"].append(time.perf_counter() - t1)
    finally:
        del env.step
    trace = profile(prog.iteration, 1, host_ops=False)
    trace.spans = spans
    trace.steps = prog.trainer.cfg.rollout_steps
    return trace


def calibrate(cell: Cell, seed: int, seconds: float, control: bool) -> dict:
    """One seed's readings for ``calibrate.py``: the program's compared
    iterations (no window: the readings need none) and its numbers; with
    ``control``, those of the float8 reference and of the reference with
    each planted fault, all against the reference."""
    del seconds
    setup = Setup(cell, seed, "cuda")
    prog = Training(setup)
    prog.free()
    ref = reference_readings(setup)
    row = {"sound": numbers(prog.readings, ref, prog.params0)}
    if control:
        row["control"] = numbers(reference_readings(setup, "fp8"), ref,
                                 prog.params0)
        row["faults"] = {f: numbers(reference_readings(setup, fault=f), ref,
                                    prog.params0)
                         for f in ("half_batch", "answer")}
    return row
