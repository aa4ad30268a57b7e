"""The env-batch split and the data-parallel trainer across two processes:
a gloo world of two ranks on the CPU (``tests/torch_dp_worker.py``, which
imports the port only), the port's counterpart of
``tests/test_multihost.py``.  Inputs and results go through files.

* dispersion@16 split 2 x 8: three steps of given actions equal the
  one-process env's rows to the bit, the ranks' resets differ, and two
  training iterations leave the parameters bit-identical on both ranks;
* one minibatch of every sample of a one-process rollout, split by env:
  the data-parallel gradient (kernel path and autograd) equals the
  one-process gradient, and the sum over the two shards of the JAX
  package's ``ppo_update_pallas.minibatch_update`` with ``norm_n`` (its
  Pallas kernel in interpret mode);
* in one process: the trainer under a mesh builds only its rank's envs.

Each world runs under ``parallel.run_workers`` with a 60 s limit: a hung
or failed rank fails the test instead of stalling the run.
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(__file__))

from vectorizedmultiagentsimulator_tpu.ops import (  # noqa: E402
    ppo_update_pallas as pup,
)
from vectorizedmultiagentsimulator_tpu_torch import make_env  # noqa: E402
from vectorizedmultiagentsimulator_tpu_torch.examples import (  # noqa: E402
    torch_ppo,
)
from vectorizedmultiagentsimulator_tpu_torch.parallel import (  # noqa: E402
    make_mesh,
    rank_seed,
    run_workers,
)
from vectorizedmultiagentsimulator_tpu_torch.utils import (  # noqa: E402
    state_to_numpy,
)
from vectorizedmultiagentsimulator_tpu_torch.parallel.distributed import (  # noqa: E402
    free_port,
)

import torch_dp_worker as worker  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(os.path.dirname(__file__), "torch_dp_worker.py")
TIMEOUT_S = 60
# The shards' sums in another order than the one-process sum: fp32
# rounding of ~500 terms, far below a factor from a wrong norm_n.
GRAD_RTOL = 1e-4
# autograd runs the trunk in bf16 (PPOConfig.trunk_dtype), and its
# gradient sums are rounded to bf16 where the products are: one rounding
# step of 2^-8 of the largest entry.
AUTOGRAD_RTOL = 2.0**-8


def _world(mode, out, n=2):
    port = str(free_port())
    env = dict(os.environ, OMP_NUM_THREADS="1")
    outs = run_workers(
        [[sys.executable, WORKER, mode, str(r), str(n), port, str(out)]
         for r in range(n)],
        TIMEOUT_S, env=env, cwd=ROOT)
    for r, text in enumerate(outs):
        assert f"WORKER_OK {mode} {r}" in text, text[-2000:]


def _close(got, ref, rtol, what):
    scale = np.abs(ref).max()
    err = np.abs(got - ref).max()
    assert err <= rtol * scale, f"{what}: max err {err} of scale {scale}"


def test_two_ranks_step_reset_and_train(tmp_path):
    env = make_env(worker.SCENARIO, num_envs=worker.B, device="cpu", seed=0)
    rng = np.random.RandomState(0)
    sizes = [env.get_agent_action_size(a) for a in env.agents]
    actions = np.stack([
        np.stack([rng.uniform(-1, 1, (worker.B, s)).astype(np.float32)
                  for s in sizes]) for _ in range(3)])
    np.save(tmp_path / "actions.npy", actions)
    ref_obs, ref_rews = [], []
    for step in actions:
        o, r, _, _ = env.step([torch.from_numpy(a) for a in step])
        ref_obs.append(torch.stack(o).numpy())
        ref_rews.append(torch.stack(r).numpy())
    ref_obs, ref_rews = np.stack(ref_obs), np.stack(ref_rews)

    _world("step_train", tmp_path)
    n = worker.B // 2
    got = [np.load(tmp_path / f"step_{r}.npz") for r in range(2)]
    for r, g in enumerate(got):
        rows = slice(r * n, (r + 1) * n)
        np.testing.assert_array_equal(g["obs"], ref_obs[:, :, rows])
        np.testing.assert_array_equal(g["rews"], ref_rews[:, :, rows])
    # each rank's generator is its own: a reset of every env draws anew
    assert not np.array_equal(got[0]["reset_pos"], got[1]["reset_pos"])
    p0, p1 = (np.load(tmp_path / f"params_{r}.npy") for r in range(2))
    np.testing.assert_array_equal(p0, p1)
    assert np.isfinite(p0).all()


def test_data_parallel_gradient_matches_one_process_and_jax(tmp_path,
                                                            monkeypatch):
    _, _, one = torch_ppo.init_training(worker.SCENARIO, worker.B, 0,
                                        worker.GRAD, device="cpu")
    assert one.fused
    packed, _ = one.collect()
    np.save(tmp_path / "packed.npy", packed.numpy())
    flat = torch.cat([p.detach().reshape(-1)
                      for p in one.model.ordered_parameters()])
    np.save(tmp_path / "params.npy", flat.numpy())
    spec, lb = one.spec, one.spec.lb
    adv = packed[spec.obs_d + spec.act_w + 1].reshape(-1, lb)
    pm = torch.arange(spec.mb // lb, dtype=torch.int32)
    ref_grads, ref_sums = one.minibatch_grads(packed, pm, adv.sum(1),
                                              (adv * adv).sum(1))
    ref_fused = torch.cat([g.reshape(-1) for g in ref_grads]).numpy()
    ref_auto, ref_loss = one.autograd_grads(packed.t())
    ref_auto = torch.cat([g.reshape(-1) for g in ref_auto]).numpy()

    _world("grad", tmp_path)
    got = [np.load(tmp_path / f"grad_{r}.npz") for r in range(2)]
    assert int(got[0]["norm_n"]) == 2 * int(got[0]["mb"]) == spec.mb
    for key in ("fused", "sums", "autograd", "loss"):
        np.testing.assert_array_equal(got[0][key], got[1][key])
    _close(got[0]["fused"], ref_fused, GRAD_RTOL, "kernel path")
    _close(got[0]["sums"], torch.stack(ref_sums).numpy(), GRAD_RTOL, "sums")
    _close(got[0]["autograd"], ref_auto, AUTOGRAD_RTOL, "autograd")
    _close(got[0]["loss"], ref_loss.numpy(), AUTOGRAD_RTOL, "loss")

    # The JAX package's kernel on each shard with the global norm_n and the
    # global advantage stats, summed over the shards.
    monkeypatch.setenv("VMT_PALLAS_INTERPRET", "1")
    mb_loc, lb_loc = int(got[0]["mb"]), int(got[0]["lb"])
    jspec = pup.PPOUpdateSpec(
        obs_d=spec.obs_d, act_w=spec.act_w, hidden=spec.hidden, lb=lb_loc,
        mb=mb_loc, clip_eps=spec.clip_eps, vf_coef=spec.vf_coef,
        ent_coef=spec.ent_coef, n_logits=spec.n_logits, norm_n=spec.mb)
    a = adv.reshape(-1).double()
    mean = a.mean()
    stats = np.array([mean, 1.0 / (np.sqrt((a * a).mean() - mean * mean)
                                   + 1e-8)], np.float32)
    params = tuple(jnp.asarray(p.numpy()) for p in one.model.kernel_params())
    total = 0.0
    for r in range(2):
        shard = torch_ppo.shard_packed(packed, worker.B,
                                       make_mesh(rank=r, world_size=2))
        g, _ = pup.minibatch_update(
            jspec, jnp.asarray(shard.numpy()),
            jnp.arange(mb_loc // lb_loc, dtype=jnp.int32), jnp.asarray(stats),
            params)
        total = total + np.concatenate([np.asarray(x).reshape(-1) for x in g])
    # As tests/test_torch_ppo.py holds the plain version to the Pallas
    # kernel: the same operations in another order, and a tanh an ulp off
    # can move an activation across a bf16 rounding step.
    _close(got[0]["fused"], total, 1e-3, "JAX shards' sum")


def test_init_training_builds_only_the_ranks_envs():
    """Under a mesh the trainer's env is the rank's B / n envs, built at
    that batch with the rank's seed: its reset state is that of such an
    env reset with rank_seed, a world of one trains as the plain trainer
    to the bit, and B % n raises."""
    cfg = torch_ppo.PPOConfig(rollout_steps=4, epochs=1, minibatches=2,
                              hidden=16)
    for r in range(2):
        env, _, trainer = torch_ppo.init_training(
            worker.SCENARIO, worker.B, 0, cfg, device="cpu",
            mesh=make_mesh(rank=r, world_size=2))
        assert env.num_envs == worker.B // 2
        ref = make_env(worker.SCENARIO, num_envs=worker.B // 2, device="cpu",
                       seed=rank_seed(0, r))
        ref.reset(seed=rank_seed(0, r))
        got, want = state_to_numpy(env), state_to_numpy(ref)
        got.update(got.pop("extras"))
        want.update(want.pop("extras"))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    _, step_1, one = torch_ppo.init_training(
        worker.SCENARIO, worker.B, 0, cfg, device="cpu",
        mesh=make_mesh(rank=0, world_size=1))
    _, step_p, plain = torch_ppo.init_training(worker.SCENARIO, worker.B, 0,
                                               cfg, device="cpu")
    one, m_one = step_1(one)
    plain, m_plain = step_p(plain)
    for p, q in zip(one.model.ordered_parameters(),
                    plain.model.ordered_parameters()):
        assert torch.equal(p, q)
    assert all(torch.equal(m_one[k], m_plain[k]) for k in m_plain)
    with pytest.raises(ValueError, match="divisible"):
        torch_ppo.init_training(worker.SCENARIO, 6, 0, cfg, device="cpu",
                                mesh=make_mesh(rank=0, world_size=4))


def test_nccl_refuses_two_ranks_on_one_device(tmp_path):
    """Two ranks that name one card: the device check on the rendezvous
    store raises on both before NCCL starts (no card needed)."""
    port = free_port()
    code = (
        "import sys; sys.path.insert(0, {root!r})\n"
        "from vectorizedmultiagentsimulator_tpu_torch.parallel import "
        "init_distributed\n"
        "try:\n"
        "    init_distributed('nccl', {{r}}, 2, init_method="
        "'tcp://localhost:{port}', device='cuda:0', timeout_s=60)\n"
        "except ValueError as e:\n"
        "    print('REFUSED', e)\n"
    ).format(root=ROOT, port=port)
    outs = run_workers([[sys.executable, "-c", code.format(r=r)]
                        for r in range(2)], TIMEOUT_S, cwd=ROOT)
    for text in outs:
        assert "REFUSED NCCL takes one rank a device" in text, text


def test_a_failed_rank_fails_the_run():
    with pytest.raises(RuntimeError, match="worker 1 exited 3"):
        run_workers([[sys.executable, "-c", "import time; time.sleep(60)"],
                     [sys.executable, "-c", "raise SystemExit(3)"]],
                    TIMEOUT_S)
    with pytest.raises(RuntimeError, match="more than 1 s"):
        run_workers([[sys.executable, "-c", "import time; time.sleep(60)"]],
                    1)
