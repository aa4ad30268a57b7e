"""One rank of a two-process gloo world on the CPU, for
``tests/test_torch_multiprocess.py``.  It imports torch, numpy and the port
only, and takes its inputs from and writes its results to files in a
directory.

    python tests/torch_dp_worker.py <mode> <rank> <world_size> <port> <dir>

Modes:

* ``step_train``: dispersion@16 split over the ranks; 3 steps of the
  actions in ``actions.npy`` (``[steps, agents, 16, action]``), then a
  masked reset of every env, written to ``step_<rank>.npz``; then
  ``init_training(mesh=)`` trained 2 iterations, its parameters written to
  ``params_<rank>.npy``;
* ``grad``: the data-parallel trainer's gradients of one minibatch of
  every local sample of the packed rollout ``packed.npy`` (made by a
  one-process trainer of dispersion@16), at the parameters of
  ``params.npy``, through the kernel's path and through autograd, written
  to ``grad_<rank>.npz``.
"""
import os
import sys

import numpy as np
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import vectorizedmultiagentsimulator_tpu_torch as vmt  # noqa: E402
from vectorizedmultiagentsimulator_tpu_torch.examples import (  # noqa: E402
    torch_ppo,
)
from vectorizedmultiagentsimulator_tpu_torch.parallel import (  # noqa: E402
    init_distributed,
    shard_environment,
)

SCENARIO, B = "dispersion", 16
TRAIN = torch_ppo.PPOConfig(rollout_steps=8, epochs=1, minibatches=2,
                            hidden=16)
GRAD = torch_ppo.PPOConfig(rollout_steps=8, epochs=1, minibatches=1,
                           hidden=16)


def flat_params(trainer):
    return torch.cat([p.detach().reshape(-1)
                      for p in trainer.model.ordered_parameters()])


def step_train(mesh, out):
    env = vmt.make_env(SCENARIO, num_envs=B, device="cpu", seed=0)
    local = shard_environment(env, mesh)
    actions = np.load(os.path.join(out, "actions.npy"))
    n = B // mesh.size
    rows = slice(mesh.rank * n, (mesh.rank + 1) * n)
    obs, rews = [], []
    for step in actions:
        o, r, _, _ = local.step([torch.from_numpy(a[rows]) for a in step])
        obs.append(torch.stack(o).numpy())
        rews.append(torch.stack(r).numpy())
    local.reset_at(torch.ones((n,), dtype=torch.bool))
    np.savez(os.path.join(out, f"step_{mesh.rank}.npz"), obs=np.stack(obs),
             rews=np.stack(rews), reset_pos=local.world.state.pos.numpy())
    _, step, trainer = torch_ppo.init_training(SCENARIO, B, 0, TRAIN,
                                               device="cpu", mesh=mesh)
    assert trainer.fused and trainer.spec.norm_n == trainer.mb * mesh.size
    for _ in range(2):
        trainer, metrics = step(trainer)
        assert torch.isfinite(metrics["loss"])
    np.save(os.path.join(out, f"params_{mesh.rank}.npy"),
            flat_params(trainer).numpy())


def grad(mesh, out):
    _, _, trainer = torch_ppo.init_training(SCENARIO, B, 0, GRAD,
                                            device="cpu", mesh=mesh)
    flat = torch.from_numpy(np.load(os.path.join(out, "params.npy")))
    with torch.no_grad():
        for p, x in zip(trainer.model.ordered_parameters(),
                        trainer._split(flat)):
            p.copy_(x)
    packed = torch_ppo.shard_packed(
        torch.from_numpy(np.load(os.path.join(out, "packed.npy"))), B, mesh)
    spec = trainer.spec
    lb = spec.lb
    adv = packed[spec.obs_d + spec.act_w + 1].reshape(-1, lb)
    pm = torch.arange(spec.mb // lb, dtype=torch.int32)
    grads, sums = trainer.minibatch_grads(packed, pm, adv.sum(1),
                                          (adv * adv).sum(1))
    auto, loss = trainer.autograd_grads(packed.t())
    np.savez(os.path.join(out, f"grad_{mesh.rank}.npz"),
             fused=torch.cat([g.reshape(-1) for g in grads]).numpy(),
             sums=torch.stack(sums).numpy(),
             autograd=torch.cat([g.reshape(-1) for g in auto]).numpy(),
             loss=loss.numpy(), norm_n=spec.norm_n, mb=spec.mb, lb=lb)


def main():
    mode, rank, world, port, out = sys.argv[1:6]
    mesh = init_distributed("gloo", int(rank), int(world),
                            init_method=f"tcp://localhost:{port}",
                            device="cpu", timeout_s=60)
    {"step_train": step_train, "grad": grad}[mode](mesh, out)
    torch.distributed.destroy_process_group()
    bad = sorted(m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "flax", "vectorizedmultiagentsimulator_tpu"))
    assert not bad, bad
    print(f"WORKER_OK {mode} {rank}", flush=True)


if __name__ == "__main__":
    main()
