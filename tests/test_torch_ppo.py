"""The port's PPO trainer (``examples/torch_ppo.py``) and the plain version
of its minibatch-update kernel (``ops/ppo_update_cuda.py``) against the JAX
package: the Pallas kernel in interpret mode and its jnp reference, flax's
``ActorCritic``, and one whole rollout-plus-updates iteration assembled from
the JAX package's pieces.  Inputs and noise are numpy arrays drawn from a
seed and handed to both sides.  Everything runs on the CPU at small sizes.
"""
import os
import sys

import numpy as np
import pytest
import torch

# The CPU tests run at small sizes, several test processes at once:
# PyTorch's intra-op threads would only contend with each other.
torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(__file__))

import jax
import jax.numpy as jnp

flax = pytest.importorskip("flax")
import optax  # noqa: E402
from torch_helpers import jax_state_arrays, random_ppo_inputs  # noqa: E402

import vectorizedmultiagentsimulator_tpu as vmt_jax  # noqa: E402
from vectorizedmultiagentsimulator_tpu.examples import jax_ppo  # noqa: E402
from vectorizedmultiagentsimulator_tpu.ops import (  # noqa: E402
    ppo_update_pallas as pup,
)
from vectorizedmultiagentsimulator_tpu_torch.examples import (  # noqa: E402
    torch_ppo,
)
from vectorizedmultiagentsimulator_tpu_torch.ops import (  # noqa: E402
    ppo_update_cuda as puc,
)
from vectorizedmultiagentsimulator_tpu_torch.utils import (  # noqa: E402
    ppo_params_from_numpy,
    ppo_params_to_numpy,
    state_from_numpy,
)

# name: (spec fields, blocks in the packed rollout)
CASES = {
    "gaussian": (dict(obs_d=6, act_w=2, hidden=8, lb=16, mb=64), 8),
    "aw1": (dict(obs_d=5, act_w=1, hidden=16, lb=32, mb=64), 4),
    "flat_categorical": (
        dict(obs_d=6, act_w=1, hidden=8, lb=16, mb=64, n_logits=5), 8),
    "multidiscrete": (
        dict(obs_d=6, act_w=3, hidden=16, lb=16, mb=64, n_logits=4), 8),
    "norm_n": (dict(obs_d=6, act_w=2, hidden=8, lb=16, mb=64, norm_n=256), 8),
}
COEFS = dict(clip_eps=0.2, vf_coef=0.5, ent_coef=0.01)


def _case(name):
    fields, nb_tot = CASES[name]
    spec = puc.PPOUpdateSpec(**fields, **COEFS)
    inputs = random_ppo_inputs(spec, nb_tot, seed=sorted(CASES).index(name))
    return spec, pup.PPOUpdateSpec(**fields, **COEFS), inputs


def _plain(spec, inputs):
    packed, perm, stats, params = inputs
    return puc.minibatch_update(
        spec, torch.from_numpy(packed), torch.from_numpy(perm),
        torch.from_numpy(stats), tuple(torch.from_numpy(p) for p in params),
    )


def _as_jax(inputs):
    packed, perm, stats, params = inputs
    return (jnp.asarray(packed), jnp.asarray(perm), jnp.asarray(stats),
            tuple(jnp.asarray(p) for p in params))


def _assert_update_close(got, ref, grad_rtol, grad_atol):
    (g_t, s_t), (g_j, s_j) = got, ref
    # Sums of 64 per-sample terms in fp32, in another order.
    for a, b in zip(s_t, s_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5,
                                   atol=1e-5)
    assert len(g_t) == len(g_j) == 11
    for i, (a, b) in enumerate(zip(g_t, g_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=grad_rtol,
                                   atol=grad_atol, err_msg=f"grad {i}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_update_matches_pallas_kernel(monkeypatch, name):
    """The CPU path of ``minibatch_update`` (the plain version) against the
    Pallas kernel in interpret mode.  The two do the same operations with
    the same casts, so only summation order and libm differ: gradients at
    rtol 1e-3 / atol 1e-5 (a tanh that differs by an ulp can move one
    activation across a bf16 rounding step, 2^-9 relative, in one of 64
    samples)."""
    monkeypatch.setenv("VMT_PALLAS_INTERPRET", "1")
    spec, jspec, inputs = _case(name)
    ref = pup.minibatch_update(jspec, *_as_jax(inputs))
    _assert_update_close(_plain(spec, inputs), ref, 1e-3, 1e-5)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_update_matches_jax_grad_reference(name):
    """Against ``reference_minibatch`` (``jax.grad`` of the jnp forward),
    at the JAX tests' tolerance: ``jax.grad`` keeps the cotangents in fp32
    where the hand-derived backward rounds them to bf16."""
    spec, jspec, inputs = _case(name)
    ref = jax.jit(pup.reference_minibatch, static_argnums=0)(
        jspec, *_as_jax(inputs))
    _assert_update_close(_plain(spec, inputs), ref, 2e-2, 2e-3)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_backward_matches_autograd(name):
    """The hand-derived backward against torch autograd of the plain
    forward (which passes gradients through the bf16 roundings unrounded):
    the same bf16-scaled tolerance."""
    spec, _, (packed, perm, stats, params) = _case(name)
    packed, perm, stats = map(torch.from_numpy, (packed, perm, stats))
    params = tuple(torch.from_numpy(p).requires_grad_() for p in params)
    x = puc.gather_minibatch(spec, packed, perm)
    fields = puc._fields(spec, x, stats)
    fwd = puc.forward_plain(spec, params, *fields)
    loss = (-fwd["pg_i"].sum() + spec.vf_coef * fwd["vf_i"].sum()
            - spec.ent_coef * fwd["ent_i"].sum()) / spec.norm
    auto = torch.autograd.grad(loss, params, allow_unused=True)
    hand, _ = puc.minibatch_update_plain(
        spec, packed, perm, stats, tuple(p.detach() for p in params))
    for i, (h, a) in enumerate(zip(hand, auto)):
        a = torch.zeros_like(h) if a is None else a
        torch.testing.assert_close(h, a, rtol=2e-2, atol=2e-3, msg=f"grad {i}")


def test_wrapper_raises_on_mixed_devices_and_counts_nothing_on_cpu():
    spec, _, inputs = _case("gaussian")
    before = puc.LAUNCHES
    _plain(spec, inputs)
    assert puc.LAUNCHES == before
    # Tiles shrink as the trunk widens; from about hidden 150 to 256 a
    # cluster of 4 blocks shares each tile and keeps the sums on chip; past
    # 256 the gradient sums and bf16 weights leave shared memory, past
    # about 1,040 the activation tiles and hidden-size vectors too.
    assert puc.layout(spec) == (64, False, False, False, 1)
    assert puc.layout(spec._replace(hidden=64)) == (64, False, False, False, 1)
    assert puc.layout(spec._replace(hidden=100)) == (64, False, False, False,
                                                     1)
    assert puc.layout(spec._replace(hidden=128)) == (32, False, False, False,
                                                     1)
    assert puc.layout(spec._replace(hidden=256)) == (64, False, False, False,
                                                     4)
    assert puc.layout(spec._replace(hidden=300)) == (32, True, True, False, 1)
    assert puc.layout(spec._replace(hidden=320)) == (32, True, True, False, 1)
    assert puc.layout(spec._replace(hidden=1040)) == (16, True, True, False,
                                                      1)
    # The cluster takes exactly the widths whose sums left shared memory
    # before: at obs_d 15 from hidden 162 (146-160: tiles of 16) to 256.
    transport = spec._replace(obs_d=15)
    assert puc.layout(transport._replace(hidden=160))[4] == 1
    assert puc.layout(transport._replace(hidden=162))[4] == 4
    assert puc.layout(transport._replace(hidden=256)) == (64, False, False,
                                                          False, 4)
    assert puc.layout(transport._replace(hidden=258))[4] == 1
    assert "PPO_CL=4" in puc.defines(transport._replace(hidden=256))
    assert "PPO_CL=1" in puc.defines(transport._replace(hidden=64))
    for hidden in (100, 256, 512, 1024, 1100, 1536, 2048, 4096):
        assert puc.update_supported(spec._replace(hidden=hidden))
    wide = spec._replace(obs_d=15, hidden=1536)
    for hidden in (1536, 2048, 4096):
        assert puc.layout(wide._replace(hidden=hidden)) == (64, True, True,
                                                             True, 1)
        assert "PPO_XG=1" in puc.defines(wide._replace(hidden=hidden))
    # Only packed rows too many for two raw tiles of 16 samples are refused.
    assert not puc.update_supported(spec._replace(obs_d=2000))
    with pytest.raises(ValueError, match="does not take"):
        puc.build(spec._replace(obs_d=2000))
    packed, perm, stats, params = inputs
    with pytest.raises(ValueError, match="CUDA tensors"):
        puc.launch(spec, torch.from_numpy(packed), torch.from_numpy(perm),
                   torch.from_numpy(stats),
                   tuple(torch.from_numpy(p) for p in params))


# --------------------------------------------------------------------- #
# The model
# --------------------------------------------------------------------- #
def _flax_model(obs_d, act_dim, hidden, dtype, seed=0):
    model = jax_ppo.ActorCritic(action_dim=act_dim, hidden=hidden,
                                dtype=jnp.dtype(dtype))
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, obs_d)))
    rng = np.random.RandomState(seed)
    # Non-zero biases and log_std, so that their places are checked too.
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.1 * rng.randn(*x.shape).astype(np.float32),
        params,
    )
    return model, params


def _numpy_tree(params):
    return jax.tree_util.tree_map(np.asarray, dict(params))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 3e-2)])
def test_actor_critic_matches_flax(dtype, tol):
    """Forward and Gaussian log-prob with flax's parameters loaded through
    ``ppo_params_from_numpy``.  float32: summation order only.  bfloat16:
    the two frameworks round the trunk's products and tanh to bf16 (2^-9
    relative) at their own places, on values of order 1."""
    rng = np.random.RandomState(1)
    model, params = _flax_model(7, 3, 16, dtype)
    obs = rng.randn(3, 5, 7).astype(np.float32)
    act = rng.randn(3, 5, 3).astype(np.float32)
    mask = (rng.rand(3, 1, 3) > 0.3).astype(np.float32)
    mean_j, ls_j, value_j = model.apply(params, jnp.asarray(obs))
    logp_j = jax_ppo._gaussian_logp(mean_j, ls_j, jnp.asarray(act),
                                    jnp.asarray(mask))

    net = torch_ppo.ActorCritic(7, 3, 16, dtype)
    ppo_params_from_numpy(net, _numpy_tree(params))
    with torch.no_grad():
        mean_t, ls_t, value_t = net(torch.from_numpy(obs))
        logp_t = torch_ppo.gaussian_logp(mean_t, ls_t, torch.from_numpy(act),
                                         torch.from_numpy(mask))
    for got, ref in ((mean_t, mean_j), (ls_t, ls_j), (value_t, value_j)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                                   rtol=tol, atol=tol)
    # The log-prob squares (action - mean) / std, with |action - mean| up
    # to about 4 here.
    np.testing.assert_allclose(logp_t.numpy(), np.asarray(logp_j),
                               rtol=tol, atol=10 * tol)
    back = ppo_params_to_numpy(net)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(_numpy_tree(params))):
        np.testing.assert_array_equal(a, b)


def _jax_gae(cfg, rew, done, value, last_value):
    """``compute_gae`` of the JAX example, replayed step by step."""
    gae = jnp.zeros_like(last_value)
    next_value = last_value
    adv = []
    for t in range(rew.shape[0] - 1, -1, -1):
        not_done = 1 - done[t]
        delta = rew[t] + cfg.gamma * next_value * not_done - value[t]
        gae = delta + cfg.gamma * cfg.gae_lambda * not_done * gae
        next_value = value[t]
        adv.append(gae)
    adv = jnp.stack(adv[::-1])
    return adv, adv + value


def test_compute_gae_matches_jax_replay():
    rng = np.random.RandomState(2)
    cfg = torch_ppo.PPOConfig()
    rew, value = rng.randn(2, 8, 3, 5).astype(np.float32)
    done = (rng.rand(8, 3, 5) > 0.8).astype(np.float32)
    last = rng.randn(3, 5).astype(np.float32)
    adv_j, ret_j = _jax_gae(cfg, *map(jnp.asarray, (rew, done, value, last)))
    adv_t, ret_t = torch_ppo.compute_gae(
        cfg, *map(torch.from_numpy, (rew, done, value, last)))
    np.testing.assert_allclose(adv_t.numpy(), np.asarray(adv_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(ret_t.numpy(), np.asarray(ret_j), rtol=1e-5,
                               atol=1e-5)


# --------------------------------------------------------------------- #
# The slice as a whole
# --------------------------------------------------------------------- #
ROLL_TOL = 1e-5


def test_iteration_matches_jax_pieces(monkeypatch):
    """One training iteration on dispersion (4 agents, 8 envs, 8 steps, no
    env finishes): the rollout from one injected state and injected noise,
    GAE and packing, then ``epochs x minibatches`` fused updates from the
    same packed rollout with the same block permutations.  The JAX side is
    assembled from the JAX package's env, flax model, Pallas kernel in
    interpret mode and optax chain.  The rollout half runs with a float32
    trunk on both sides, so that it can be held tightly; the update half
    with the bf16 trunk the kernel is made for."""
    monkeypatch.setenv("VMT_PALLAS_INTERPRET", "1")
    B, T = 8, 8
    cfg_kw = dict(rollout_steps=T, epochs=2, minibatches=2, hidden=16,
                  fused_block=16)
    cfg = torch_ppo.PPOConfig(**cfg_kw)
    rng = np.random.RandomState(3)

    env_j = vmt_jax.make_env("dispersion", num_envs=B, seed=0)
    env_t, _, trainer = torch_ppo.init_training(
        "dispersion", B, 0, cfg._replace(trunk_dtype="float32"), device="cpu")
    assert not trainer.fused
    env_j.reset(seed=0)
    state_from_numpy(env_t, jax_state_arrays(env_j.state))
    A = env_j.n_agents
    pad = jax_ppo.make_obs_padder(env_j)
    obs_j = pad(env_j.get_from_scenario(
        get_observations=True, get_rewards=False, get_infos=False,
        get_dones=False)[0])
    trainer.obs = trainer.pad_obs(env_t.get_from_scenario(
        get_observations=True, get_rewards=False, get_infos=False,
        get_dones=False)[0])
    np.testing.assert_allclose(trainer.obs.numpy(), np.asarray(obs_j),
                               atol=1e-6)

    obs_d, act_w = obs_j.shape[-1], 2
    model, params = _flax_model(obs_d, act_w, cfg.hidden, "float32", seed=4)
    ppo_params_from_numpy(trainer.model, _numpy_tree(params))
    noises = rng.randn(T, A, B, act_w).astype(np.float32)

    # The JAX rollout: policy_step of the JAX example without its reset.
    u_range = jnp.asarray(env_j.agents[0].action.u_range_tensor, jnp.float32)
    apply = jax.jit(model.apply)
    traj = {k: [] for k in ("obs", "action", "logp", "value", "rew", "done")}
    for t in range(T):
        mean, log_std, value = apply(params, obs_j)
        action = mean + jnp.exp(log_std) * noises[t]
        logp = jax_ppo._gaussian_logp(mean, log_std, action, 1.0)
        new_obs, rews, dones, _ = env_j.step(
            [jnp.clip(action[i], -u_range, u_range) for i in range(A)])
        assert not bool(dones.any())
        for k, v in (("obs", obs_j), ("action", action), ("logp", logp),
                     ("value", value), ("rew", jnp.stack(rews)),
                     ("done", jnp.broadcast_to(dones, (A, B)))):
            traj[k].append(v)
        obs_j = pad(new_obs)
    traj = {k: jnp.stack(v) for k, v in traj.items()}
    last_value = apply(params, obs_j)[2]
    adv, ret = _jax_gae(cfg, traj["rew"], traj["done"].astype(jnp.float32),
                        traj["value"], last_value)
    n = T * A * B
    packed_j = jnp.concatenate(
        [traj["obs"], traj["action"], traj["logp"][..., None], adv[..., None],
         ret[..., None], jnp.ones((T, A, B, act_w), jnp.float32)],
        axis=-1,
    ).reshape(n, -1).T

    packed_t, traj_t = trainer.collect(torch.from_numpy(noises), reset=False)
    # Everything in float32 on both sides: summation order and libm only,
    # carried through 8 env steps and the GAE scan.
    for k in ("obs", "action", "logp", "value", "rew"):
        np.testing.assert_allclose(traj_t[k].numpy(), np.asarray(traj[k]),
                                   rtol=ROLL_TOL, atol=ROLL_TOL, err_msg=k)
    assert not bool(traj_t["done"].any())
    assert packed_t.shape == packed_j.shape == (trainer.spec.d, n)
    np.testing.assert_allclose(packed_t.numpy(), np.asarray(packed_j),
                               rtol=ROLL_TOL, atol=ROLL_TOL)

    # The updates with the bf16 trunk, both sides from the JAX side's packed
    # rollout and the same parameters.
    _, _, trainer = torch_ppo.init_training("dispersion", B, 0, cfg,
                                            device="cpu")
    assert trainer.fused
    ppo_params_from_numpy(trainer.model, _numpy_tree(params))
    spec = trainer.spec
    jspec = pup.PPOUpdateSpec(*spec)
    nb_tot, nbm = n // spec.lb, spec.mb // spec.lb
    perms = [rng.permutation(nb_tot).astype(np.int32)
             for _ in range(cfg.epochs)]
    optimizer = optax.chain(optax.clip_by_global_norm(cfg.max_grad_norm),
                            optax.adam(cfg.lr))
    opt_state = optimizer.init(params)
    adv_row = packed_j[spec.obs_d + spec.act_w + 1].reshape(nb_tot, spec.lb)
    bs, bsq = adv_row.sum(axis=1), (adv_row * adv_row).sum(axis=1)

    @jax.jit
    def update(params, opt_state, pm):
        m = bs[pm].sum() / spec.mb
        var = jnp.maximum(bsq[pm].sum() / spec.mb - m * m, 0.0)
        p = params["params"]
        col = lambda v: v[:, None]
        g, (pg, vf, ent) = pup.minibatch_update(
            jspec, packed_j, pm,
            jnp.stack([m, 1.0 / (jnp.sqrt(var) + 1e-8)]),
            (p["Dense_0"]["kernel"], col(p["Dense_0"]["bias"]),
             p["Dense_1"]["kernel"], col(p["Dense_1"]["bias"]),
             p["Dense_2"]["kernel"], col(p["Dense_2"]["bias"]),
             col(p["log_std"]),
             p["Dense_3"]["kernel"], col(p["Dense_3"]["bias"]),
             p["Dense_4"]["kernel"], col(p["Dense_4"]["bias"])),
        )
        grads = {"params": {
            "Dense_0": {"kernel": g[0], "bias": g[1][:, 0]},
            "Dense_1": {"kernel": g[2], "bias": g[3][:, 0]},
            "Dense_2": {"kernel": g[4], "bias": g[5][:, 0]},
            "log_std": g[6][:, 0],
            "Dense_3": {"kernel": g[7], "bias": g[8][:, 0]},
            "Dense_4": {"kernel": g[9], "bias": g[10][:, 0]},
        }}
        loss = (-pg + cfg.vf_coef * vf - cfg.ent_coef * ent) / spec.mb
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    losses = []
    for perm in perms:
        for i in range(cfg.minibatches):
            params, opt_state, loss = update(
                params, opt_state, jnp.asarray(perm[i * nbm:(i + 1) * nbm]))
            losses.append(loss)

    loss_t = trainer.update(torch.from_numpy(np.asarray(packed_j).copy()),
                            [torch.from_numpy(p) for p in perms])
    np.testing.assert_allclose(float(loss_t), float(np.mean(losses)),
                               rtol=1e-4, atol=1e-5)
    # Four Adam steps of at most lr = 3e-4 each.  The first step is
    # lr * sign(g) on both sides; later ones divide running means of
    # gradients that agree to about 1e-3 relative, so the parameters agree
    # to a small share of one step: all 11 leaves within 0.01 lr (the
    # largest gap seen is 5e-4 lr, on the value branch's first kernel).
    got = ppo_params_to_numpy(trainer.model)["params"]
    ref = _numpy_tree(params)["params"]
    paths = [(layer, leaf) for layer in
             ("Dense_0", "Dense_1", "Dense_2", "Dense_3", "Dense_4")
             for leaf in ("kernel", "bias")] + [("log_std",)]
    for path in paths:
        a, b = got, ref
        for key in path:
            a, b = a[key], b[key]
        np.testing.assert_allclose(a, b, rtol=0, atol=0.01 * cfg.lr,
                                   err_msg="/".join(path))


# --------------------------------------------------------------------- #
# The trainer
# --------------------------------------------------------------------- #
SMALL = dict(rollout_steps=8, epochs=2, minibatches=2, hidden=16,
             fused_block=32)
TRAIN_CASES = {
    "dispersion": ("dispersion", dict(share_reward=True), SMALL),
    "dispersion_discrete": (
        "dispersion", dict(continuous_actions=False), SMALL),
    "speaker_listener": ("simple_speaker_listener", {}, SMALL),
    "speaker_listener_discrete": (
        "simple_speaker_listener", dict(continuous_actions=False), SMALL),
    "transport_multidiscrete": (
        "transport",
        dict(continuous_actions=False, multidiscrete_actions=True), SMALL),
    "transport_autograd_f32": (
        "transport", {}, dict(SMALL, trunk_dtype="float32")),
    "transport_autograd_bf16": (
        "transport", {}, dict(SMALL, fused_update=False)),
}


def _train(name, iters=2, seed=0):
    scenario, kwargs, cfg_kw = TRAIN_CASES[name]
    env, step, trainer = torch_ppo.init_training(
        scenario, 8, seed, torch_ppo.PPOConfig(**cfg_kw), device="cpu",
        **kwargs)
    before = [p.detach().clone() for p in trainer.model.ordered_parameters()]
    metrics = []
    for _ in range(iters):
        trainer, m = step(trainer)
        metrics.append(m)
    return env, trainer, before, metrics


@pytest.mark.parametrize("name", sorted(TRAIN_CASES))
def test_train_step_runs_and_updates(name):
    """Shared rewards, heterogeneous agents with communication actions,
    all three action heads, and both update paths: finite metrics,
    parameters that move, and the same parameters from the same seed."""
    env, trainer, before, metrics = _train(name)
    assert trainer.fused == ("autograd" not in name)
    for m in metrics:
        assert np.isfinite(float(m["loss"]))
        assert np.isfinite(float(m["mean_reward"]))
    after = [p.detach() for p in trainer.model.ordered_parameters()]
    assert sum(float((a - b).abs().sum()) for a, b in zip(after, before)) > 0
    assert all(bool(torch.isfinite(p).all()) for p in after)
    _, again, _, _ = _train(name)
    for a, b in zip(after, again.model.ordered_parameters()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name,kwargs", [
    ("dispersion", {}),
    ("simple_speaker_listener", {}),
    ("simple_speaker_listener", dict(continuous_actions=False)),
    ("dispersion", dict(continuous_actions=False, multidiscrete_actions=True)),
])
def test_trainer_spec_matches_the_jax_trainers(name, kwargs):
    """The update's shape (observation rows with the agent id, action
    width, head width) that the port derives from its env is the one the
    JAX example derives from the JAX env."""
    env_j = vmt_jax.make_env(name, num_envs=2, seed=0, **kwargs)
    obs_d = max(o.shape[-1] for o in env_j.reset(seed=0)) + env_j.n_agents
    if env_j.continuous_actions:
        act_w = max(env_j.get_agent_action_size(a) for a in env_j.agents)
        n_logits = 0
    else:
        spaces = [env_j.get_agent_action_space(a) for a in env_j.agents]
        nvecs = [[int(x) for x in s.nvec] if env_j.multidiscrete_actions
                 else [int(s.n)] for s in spaces]
        act_w = max(len(v) for v in nvecs)
        n_logits = max(max(v) for v in nvecs)
    _, _, trainer = torch_ppo.init_training(
        name, 2, 0, torch_ppo.PPOConfig(**SMALL), device="cpu", **kwargs)
    spec = trainer.spec
    assert (spec.obs_d, spec.act_w, spec.n_logits) == (obs_d, act_w, n_logits)


def test_trainer_refuses_a_hidden_size_the_kernel_does_not_take():
    """A hidden-256 trunk (gradient sums in device memory on the card) and
    a hidden-1,100 one (activation tiles in device memory too) train a step
    through the kernel's path (its plain version on the CPU), never routed
    to autograd unasked; a spec the kernel does not take makes the trainer
    raise when it is built, and the autograd update takes what it is asked
    for."""
    for hidden, placement in ((256, 1), (1100, 3)):
        wide = dict(SMALL, hidden=hidden)
        env, step, trainer = torch_ppo.init_training(
            "dispersion", 8, 0, torch_ppo.PPOConfig(**wide), device="cpu")
        assert trainer.fused and puc.layout(trainer.spec)[placement]
        before = [p.detach().clone()
                  for p in trainer.model.ordered_parameters()]
        trainer, metrics = step(trainer)
        assert np.isfinite(float(metrics["loss"]))
        after = trainer.model.ordered_parameters()
        assert all(bool(torch.isfinite(p).all()) for p in after)
        assert any(not torch.equal(p, b) for p, b in zip(after, before))
    with pytest.raises(ValueError, match="does not take"):
        puc.require_supported(trainer.spec._replace(obs_d=2000))
    _, _, trainer = torch_ppo.init_training(
        "dispersion", 8, 0,
        torch_ppo.PPOConfig(**wide, fused_update=False), device="cpu")
    assert not trainer.fused


def test_ppo_improves_on_shaped_reward():
    """navigation's dense shaping reward rises under training: the mean of
    the last 3 of 14 iterations beats the mean of the first 3, as the JAX
    example's test has it."""
    cfg = torch_ppo.PPOConfig(rollout_steps=32, epochs=2, minibatches=2,
                              hidden=32)
    env, step, trainer = torch_ppo.init_training(
        "navigation", 64, 0, cfg, device="cpu", n_agents=2)
    rewards = []
    for _ in range(14):
        trainer, metrics = step(trainer)
        rewards.append(float(metrics["mean_reward"]))
        assert np.isfinite(rewards[-1])
    assert np.mean(rewards[-3:]) > np.mean(rewards[:3]), rewards


# --------------------------------------------------------------------- #
# The kernel's source, compiled for the host
# --------------------------------------------------------------------- #
HOST_CASES = {
    "gaussian": (dict(obs_d=6, act_w=2, hidden=8, lb=16, mb=64), 8),
    "aw1_norm_n": (
        dict(obs_d=5, act_w=1, hidden=16, lb=32, mb=64, norm_n=256), 4),
    "flat_categorical": (
        dict(obs_d=6, act_w=1, hidden=8, lb=16, mb=64, n_logits=5), 8),
    "multidiscrete": (
        dict(obs_d=6, act_w=3, hidden=32, lb=16, mb=320, n_logits=4), 24),
    # 200 samples leave a ragged last tile.
    "hidden64_ragged_tile": (
        dict(obs_d=15, act_w=2, hidden=64, lb=40, mb=200), 7),
    # Hidden and obs_d that are not multiples of 16 are padded with zeros.
    "hidden96_tile64": (
        dict(obs_d=15, act_w=2, hidden=96, lb=40, mb=200), 7),
    "hidden100": (
        dict(obs_d=22, act_w=2, hidden=100, lb=40, mb=200), 7),
    # Wider trunks are compiled with smaller tiles: 32 samples at hidden
    # 128, 16 at 160; from about 162 to 256 a cluster of 4 blocks shares
    # each tile (emulated block by block, with its DSMEM exchanges).
    "hidden128_tile32": (
        dict(obs_d=15, act_w=2, hidden=128, lb=40, mb=200), 7),
    # (Its tile is 32 samples, as layout() gives this width.)
    "hidden128_tile16_multidiscrete": (
        dict(obs_d=15, act_w=2, hidden=128, lb=8, mb=72, n_logits=3), 12),
    "hidden160_tile16": (
        dict(obs_d=15, act_w=2, hidden=160, lb=40, mb=120), 4),
    "hidden256_cluster": (
        dict(obs_d=15, act_w=2, hidden=256, lb=40, mb=200), 7),
    # 200 samples leave a ragged last tile; 48 units a block.
    "hidden192_cluster_multidiscrete_ragged": (
        dict(obs_d=15, act_w=2, hidden=192, lb=8, mb=200, n_logits=3), 30),
    "hidden256_cluster_norm_n": (
        dict(obs_d=15, act_w=2, hidden=256, lb=40, mb=120, norm_n=480), 4),
    # Past about hidden 256 the weights are read from device memory.
    "hidden300_global_weights": (
        dict(obs_d=15, act_w=2, hidden=300, lb=40, mb=120), 4),
}
# Trunks compiled with the activation tiles and hidden-size vectors in the
# scratch past the partial buffer all the same (the layout past hidden
# 1,040), at the tile their own layout takes: the layout in every head
# mode, a ragged last tile and padding at the cost of small trunks.  On the
# host every layout runs the same sums in the same order, so these must
# also equal their own layout's result to the bit.
HOST_GLOBAL_TILES = {
    "gaussian_global_tiles": (
        dict(obs_d=6, act_w=2, hidden=8, lb=16, mb=64), 8),
    "multidiscrete_global_tiles": (
        dict(obs_d=6, act_w=3, hidden=32, lb=16, mb=320, n_logits=4), 24),
    "hidden100_ragged_global_tiles": (
        dict(obs_d=22, act_w=2, hidden=100, lb=40, mb=200), 7),
    "hidden300_global_tiles": (
        dict(obs_d=15, act_w=2, hidden=300, lb=40, mb=120), 4),
}


@pytest.mark.parametrize("name", sorted(HOST_CASES) + sorted(HOST_GLOBAL_TILES))
def test_kernel_source_on_the_host_matches_plain(name, tmp_path):
    """``csrc/ppo_update.cu`` compiled as host C++ (its phases run as loops
    over the thread index) against the plain version, on one block and on
    three: the tile loop, the shuffle in the tile load, the ragged last
    tile, every product's indexing and the two-pass sum are the card's
    code.  Gradients within 1e-3 of each gradient's largest entry (fp32
    sums in another order, bf16 rounding steps crossed by an ulp), sums at
    rtol 2e-5."""
    import ctypes
    import shutil
    import subprocess

    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    forced = name in HOST_GLOBAL_TILES
    fields, nb_tot = (HOST_GLOBAL_TILES if forced else HOST_CASES)[name]
    spec = puc.PPOUpdateSpec(**fields, **COEFS)
    tile, *natural = puc.layout(spec)
    packed, perm, stats, params = random_ppo_inputs(spec, nb_tot, seed=5)
    ref_g, ref_s = _plain(spec, (packed, perm, stats, params))
    dims = puc.ppo_dims(spec, packed.shape[1])
    pointers = puc._PPOParams(
        (ctypes.c_void_p * 11)(*[p.ctypes.data for p in params]))

    def host_update(placement, grid):
        defines = [d for d in puc.defines(spec) if d.split("=")[0] not in
                   ("PPO_GG", "PPO_WG", "PPO_XG")]
        defines += [f"PPO_{k}={int(v)}"
                    for k, v in zip(("GG", "WG", "XG"), placement)]
        scratch = puc.scratch_floats(spec, tile, placement[2])
        lib_path = str(tmp_path / f"libppo_{''.join(defines[-3:])}.so")
        if not os.path.exists(lib_path):
            subprocess.run(
                [cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-x", "c++",
                 *[f"-D{d}" for d in defines], "-o", lib_path, puc.SOURCE],
                check=True, timeout=60,
            )
        lib = ctypes.CDLL(lib_path)
        assert lib.vmt_ppo_p() == puc.flat_size(spec)
        assert lib.vmt_ppo_smem_bytes() == puc.smem_bytes(spec, tile,
                                                          *placement)
        assert lib.vmt_ppo_scratch_floats() == scratch
        lib.vmt_ppo_update.argtypes = [ctypes.c_void_p] * 7 + [
            ctypes.c_int, ctypes.c_void_p]
        partial = np.zeros(
            (puc.partial_floats(grid, puc.flat_size(spec), scratch),),
            np.float32)
        out = np.zeros((puc.flat_size(spec),), np.float32)
        err = lib.vmt_ppo_update(
            packed.ctypes.data, perm.ctypes.data, stats.ctypes.data,
            ctypes.addressof(pointers), partial.ctypes.data, out.ctypes.data,
            ctypes.addressof(dims), grid, None)
        assert err == 0
        return out

    for grid in (1, 3):
        out = host_update((True, True, True) if forced else natural, grid)
        if forced:
            np.testing.assert_array_equal(out, host_update(natural, grid))
        got_g, got_s = puc.split_flat(spec, torch.from_numpy(out))
        for i, (g, r) in enumerate(zip(got_g, ref_g)):
            assert g.shape == r.shape
            assert float((g - r).abs().max()) <= 1e-3 * float(
                r.abs().max()) + 1e-12, f"grid {grid} grad {i}"
        for g, r in zip(got_s, ref_s):
            np.testing.assert_allclose(float(g), float(r), rtol=2e-5,
                                       atol=1e-5)
