"""End-to-end PPO training on a vectorized scenario, on one CUDA card.

PyTorch counterpart of the JAX package's ``examples/jax_ppo.py``: a rollout
with masked auto-resets, GAE, and every PPO epoch and minibatch run on the
device with no host sync inside an iteration.  The minibatch update is the
hand-written kernel behind ``ops/ppo_update_cuda.minibatch_update`` (forward,
loss and backward of one minibatch in one launch over a feature-major packed
rollout, the epoch shuffle folded into its block indices); with
``fused_update=False``, an f32 trunk, or a minibatch the shuffle block does
not divide, the update goes through ``loss_fn`` and autograd instead (as in
the JAX example); the kernel takes any hidden size, and asked for it with
packed rows it does not take (more than about 1,200), ``init_training``
raises.

Agents share one actor-critic MLP; each agent's transition is a training
sample.  Heterogeneous scenarios are handled as in the JAX package:
observations zero-padded to the widest agent with a one-hot agent id, and a
per-agent action mask so padded action dims carry no log-prob or entropy.
All three action modes work: Gaussian for ``continuous_actions=True``, a
masked categorical head for flat ``continuous_actions=False``, a factored
categorical head for ``multidiscrete_actions=True``.

What differs from the JAX example: PyTorch runs eagerly, so the training
state lives in a :class:`Trainer` that ``train_step`` updates in place and
returns (where the JAX example threads a ``carry``); randomness comes from
one explicit ``torch.Generator`` (the env keeps its own); metrics stay
device tensors until the caller reads them.

Data-parallel training (the JAX example's ``_fused_epochs_sharded`` and
``init_training(mesh=)``): ``init_training(..., mesh=mesh)`` splits the env
batch over the mesh's ranks, one process a GPU: each rank builds an env of
its ``num_envs / ranks`` envs.  Each rank rolls out its own envs, seeds its
env, its trainer's generator (policy noise, epoch shuffle) and its reset
from ``(seed, rank)`` (``parallel.rank_seed``), and takes rank 0's
parameters once.  Each
minibatch of ``mb`` local samples then all-reduces the two advantage sums
before the kernel, which scales its terms by the global ``norm_n = mb *
ranks``, and all-reduces the flat gradients with ``(pg, vf, ent)`` after
it, so every rank takes the same clip and Adam step; ``update_autograd``
does the same through ``loss_fn``.  The epoch shuffle permutes within a
rank's samples, as the JAX example's.  ``mean_reward`` is averaged over the
ranks.  The collectives are ``all_reduce`` and ``broadcast`` only, which
gloo also carries for CUDA tensors (two ranks that share one card).

Run:  python -m vectorizedmultiagentsimulator_tpu_torch.examples.torch_ppo \\
          [scenario] [num_envs] [iterations]
      python -m torch.distributed.run --standalone --nproc_per_node=N \\
          -m vectorizedmultiagentsimulator_tpu_torch.examples.torch_ppo \\
          [scenario] [num_envs] [iterations]    # N GPUs, NCCL
"""
from __future__ import annotations

import math
import os
import sys
from typing import List, NamedTuple, Optional

import torch
from torch import nn

import vectorizedmultiagentsimulator_tpu_torch as vmt
from vectorizedmultiagentsimulator_tpu_torch.ops import ppo_update_cuda as puc
from vectorizedmultiagentsimulator_tpu_torch.parallel import (
    EnvMesh,
    init_distributed,
    rank_seed,
)
from vectorizedmultiagentsimulator_tpu_torch.utils import resolve_device

Tensor = torch.Tensor


class PPOConfig(NamedTuple):
    rollout_steps: int = 64
    epochs: int = 4
    minibatches: int = 4
    lr: float = 3e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    max_grad_norm: float = 0.5
    hidden: int = 64
    # Computation dtype of the trunk layers (parameters stay float32; the
    # mean, value and log-prob heads always compute in float32).  The fused
    # kernel rounds the trunk's operands to bfloat16 but accumulates, adds
    # the bias and takes tanh in float32, so at identical parameters its
    # log-prob differs from the rollout's by about bf16 eps: the ratio of
    # epoch 0 is 1 + O(1e-3), well inside clip_eps.
    trunk_dtype: str = "bfloat16"
    # The fused minibatch update (ops/ppo_update_cuda.py).  Falls back to
    # loss_fn and autograd with an f32 trunk or with shapes the block size
    # does not divide (Trainer.fused says which path a trainer runs); a
    # spec the kernel does not take raises when the trainer is built.
    fused_update: bool = True
    fused_block: int = 4096  # samples per shuffle block


def _truncated_normal(shape, std, generator, device):
    """Normal(0, std) truncated at two standard deviations of the
    untruncated law and rescaled to keep ``std`` (flax's ``lecun_normal``),
    by the inverse CDF from uniform draws."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = torch.rand(shape, generator=generator, device=device)
    x = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + u * (1.0 - 2.0 * lo)) - 1.0)
    return x.clamp(-2.0, 2.0) * (std / 0.87962566103423978)


class ActorCritic(nn.Module):
    """Shared-parameter actor-critic: obs -> (mean or logits, log_std,
    value).  Two tanh trunk layers and a float32 mean head, a ``log_std``
    parameter, and a separate tanh value branch.  In discrete mode the
    first head is read as categorical logits and ``log_std`` is unused.

    Weights are stored ``[in, out]`` (the JAX package's layout, and the one
    the update kernel reads), biases 1-D.  ``trunk_dtype`` is the
    computation dtype of the three hidden layers."""

    NAMES = ("w1", "b1", "w2", "b2", "wm", "bm", "log_std", "wv", "bv",
             "wv2", "bv2")

    def __init__(self, obs_dim: int, action_dim: int, hidden: int = 64,
                 trunk_dtype: str = "float32", generator=None, device=None):
        super().__init__()
        self.trunk_dtype = getattr(torch, trunk_dtype)

        def dense(fan_in, fan_out):
            w = _truncated_normal((fan_in, fan_out), math.sqrt(1.0 / fan_in),
                                  generator, device)
            return nn.Parameter(w), nn.Parameter(
                torch.zeros((fan_out,), device=device))

        self.w1, self.b1 = dense(obs_dim, hidden)
        self.w2, self.b2 = dense(hidden, hidden)
        self.wm, self.bm = dense(hidden, action_dim)
        self.log_std = nn.Parameter(torch.zeros((action_dim,), device=device))
        self.wv, self.bv = dense(obs_dim, hidden)
        self.wv2, self.bv2 = dense(hidden, 1)

    def forward(self, obs: Tensor):
        dt = self.trunk_dtype

        def layer(x, w, b):
            return torch.tanh(x @ w.to(dt) + b.to(dt))

        x = layer(layer(obs.to(dt), self.w1, self.b1), self.w2, self.b2)
        mean = x.to(torch.float32) @ self.wm + self.bm
        v = layer(obs.to(dt), self.wv, self.bv)
        value = (v.to(torch.float32) @ self.wv2 + self.bv2)[..., 0]
        return mean, self.log_std, value

    def ordered_parameters(self) -> List[nn.Parameter]:
        return [getattr(self, n) for n in self.NAMES]

    def kernel_params(self):
        """The parameters as the update kernel takes them: weights as they
        are, biases and ``log_std`` as columns (views)."""
        return tuple(
            p.detach() if p.ndim == 2 else p.detach().view(-1, 1)
            for p in self.ordered_parameters()
        )


def gaussian_logp(mean, log_std, action, mask):
    var = torch.exp(2 * log_std)
    return torch.sum(
        (
            -0.5 * ((action - mean) ** 2 / var)
            - log_std
            - 0.5 * math.log(2 * math.pi)
        )
        * mask,
        dim=-1,
    )


def make_obs_padder(env):
    """Stack per-agent observations into one ``[A, B, Dmax + A]`` tensor:
    each agent's obs zero-padded to the widest, with a one-hot agent id
    appended (so shared parameters can condition on the role)."""
    A = env.n_agents

    def pad(obs):
        dmax = max(o.shape[-1] for o in obs)
        rows = []
        for i, o in enumerate(obs):
            o = o.to(torch.float32)
            one_hot = o.new_zeros(o.shape[:-1] + (A,))
            one_hot[..., i] = 1.0
            fill = o.new_zeros(o.shape[:-1] + (dmax - o.shape[-1],))
            rows.append(torch.cat([o, fill, one_hot], dim=-1))
        return torch.stack(rows)

    return pad


def compute_gae(cfg: PPOConfig, rew, done, value, last_value):
    """Advantages and returns ``[T, A, B]`` from a rollout's rewards, dones
    (as float) and values, scanning back from ``last_value``."""
    T = rew.shape[0]
    adv = torch.empty_like(rew)
    gae = torch.zeros_like(last_value)
    next_value = last_value
    for t in range(T - 1, -1, -1):
        not_done = 1 - done[t]
        delta = rew[t] + cfg.gamma * next_value * not_done - value[t]
        gae = delta + cfg.gamma * cfg.gae_lambda * not_done * gae
        adv[t] = gae
        next_value = value[t]
    return adv, adv + value


def shard_packed(packed_fm: Tensor, num_envs: int, mesh: EnvMesh) -> Tensor:
    """Rank ``mesh.rank``'s samples of a packed rollout of ``num_envs``
    envs (``Trainer.pack``'s layout, env fastest): the columns of its envs,
    ``[D, n / mesh.size]``, in the order that rank's own trainer packs
    them."""
    d = packed_fm.shape[0]
    n = num_envs // mesh.size
    cols = packed_fm.reshape(d, -1, num_envs)
    return cols[:, :, mesh.rank * n:(mesh.rank + 1) * n].reshape(d, -1)


def clip_by_global_norm_(grads, max_norm: float):
    """Scale ``grads`` in place by ``max_norm / max(norm, max_norm)`` (the
    rule of optax's ``clip_by_global_norm``), on the device."""
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    scale = max_norm / torch.clamp_min(norm, max_norm)
    torch._foreach_mul_(list(grads), scale)


class Trainer:
    """The training state and the pieces of one iteration.  Built by
    :func:`init_training`.  With a ``mesh`` (an ``EnvMesh``), ``env`` is
    this rank's env of a split, ``seed`` this rank's, and the updates
    reduce over the mesh's ranks."""

    def __init__(self, env, cfg: PPOConfig, seed: int,
                 mesh: Optional[EnvMesh] = None):
        self.env = env
        self.cfg = cfg
        self.mesh = mesh
        dev = env.device
        A, B = env.n_agents, env.num_envs
        self.generator = torch.Generator(device=dev)
        self.generator.manual_seed(seed + 0x5eed)
        self.pad_obs = make_obs_padder(env)

        self.discrete = not env.continuous_actions
        self.u_ranges = [a.action.u_range_tensor.to(torch.float32)
                         for a in env.agents]
        if self.discrete:
            # Factored categorical head: K independent distributions of up
            # to n_cats choices (flat Discrete is K=1).  An additive -1e9
            # mask hides choices an agent lacks; a dim an agent lacks keeps
            # only choice 0, so it samples 0 and adds 0 to logp and entropy.
            if env.multidiscrete_actions:
                self.nvecs = [
                    [int(x) for x in env.get_agent_action_space(a).nvec]
                    for a in env.agents
                ]
            else:
                self.nvecs = [
                    [int(env.get_agent_action_space(a).n)] for a in env.agents
                ]
            self.K = max(len(v) for v in self.nvecs)
            self.n_cats = max(max(v) for v in self.nvecs)
            self.act_max = self.K * self.n_cats
            self.act_w = self.K
            mask3 = [
                [
                    [0.0] * (v[j] if j < len(v) else 1)
                    + [-1e9] * (self.n_cats - (v[j] if j < len(v) else 1))
                    for j in range(self.K)
                ]
                for v in self.nvecs
            ]
            self.act_mask3 = torch.tensor(mask3, device=dev)  # [A, K, n_cats]
            self.act_mask = self.act_mask3.reshape(A, self.act_max)
        else:
            # Full per-agent action width: physical dims + communication.
            self.act_dims = [env.get_agent_action_size(a) for a in env.agents]
            self.phys_dims = [a.action_size for a in env.agents]
            self.act_max = max(self.act_dims)
            self.act_w = self.act_max
            self.act_mask = torch.tensor(
                [[1.0] * d + [0.0] * (self.act_max - d) for d in self.act_dims],
                device=dev,
            )

        self.obs = self.pad_obs(env.reset(seed=seed))  # [A, B, Dmax + A]
        self.obs_d = self.obs.shape[-1]
        self.model = ActorCritic(
            self.obs_d, self.act_max, cfg.hidden, cfg.trunk_dtype,
            generator=self.generator, device=dev,
        )
        if mesh is not None:
            # Every rank starts from rank 0's parameters.
            params = self.model.ordered_parameters()
            with torch.no_grad():
                flat = mesh.broadcast(torch.cat([p.reshape(-1) for p in params]))
                for p, x in zip(params, self._split(flat)):
                    p.copy_(x)
        self.optimizer = torch.optim.Adam(
            self.model.ordered_parameters(), lr=cfg.lr, betas=(0.9, 0.999),
            eps=1e-8,
        )

        T = cfg.rollout_steps
        self.n = T * A * B
        assert self.n % cfg.minibatches == 0, (
            f"rollout_steps*n_agents*num_envs ({T}*{A}*{B}={self.n}) must be"
            f" divisible by minibatches ({cfg.minibatches}) or samples would"
            " be silently dropped"
        )
        self.mb = self.n // cfg.minibatches
        lb = cfg.fused_block
        while lb > 8 and self.mb % lb:
            lb //= 2
        self.spec = puc.PPOUpdateSpec(
            obs_d=self.obs_d, act_w=self.act_w, hidden=cfg.hidden, lb=lb,
            mb=self.mb, clip_eps=cfg.clip_eps, vf_coef=cfg.vf_coef,
            ent_coef=cfg.ent_coef,
            n_logits=self.n_cats if self.discrete else 0,
            # the global minibatch: the ranks' gradients add up to its mean
            norm_n=0 if mesh is None else self.mb * mesh.size,
        )
        # Which update this trainer runs, decided once.
        self.fused = (
            cfg.fused_update
            and cfg.trunk_dtype == "bfloat16"
            and self.mb % lb == 0
        )
        if self.fused:
            puc.require_supported(self.spec)

    # ------------------------------------------------------------------ #
    # Rollout
    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def policy_step(self, noise: Optional[Tensor] = None, reset: bool = True):
        """One env step under the current policy; returns the transition.
        ``noise`` replaces the generator's draw (standard normal ``[A, B,
        act_max]``, or uniform ``[A, B, K, n_cats]`` in discrete mode);
        ``reset=False`` leaves finished envs as they are."""
        env, A, B = self.env, self.env.n_agents, self.env.num_envs
        obs = self.obs
        mean, log_std, value = self.model(obs)
        if self.discrete:
            logits = mean.reshape(A, B, self.K, self.n_cats) + self.act_mask3[:, None]
            if noise is None:
                noise = torch.rand(logits.shape, generator=self.generator,
                                   device=obs.device)
            # Gumbel-max: a categorical draw that never reads the device.
            action = torch.argmax(logits - torch.log(-torch.log(noise)), dim=-1)
            logp = torch.gather(
                torch.log_softmax(logits, dim=-1), -1, action[..., None]
            )[..., 0].sum(-1)
            env_action = [action[i][:, : len(self.nvecs[i])] for i in range(A)]
        else:
            if noise is None:
                noise = torch.randn(mean.shape, generator=self.generator,
                                    device=obs.device)
            action = mean + torch.exp(log_std) * noise
            logp = gaussian_logp(mean, log_std, action, self.act_mask[:, None])
            env_action = [
                torch.cat(
                    [
                        torch.minimum(
                            torch.maximum(
                                action[i, :, : self.phys_dims[i]],
                                -self.u_ranges[i],
                            ),
                            self.u_ranges[i],
                        ),
                        # communication dims live in [0, 1]
                        action[i, :, self.phys_dims[i]: self.act_dims[i]]
                        .clamp(0.0, 1.0),
                    ],
                    dim=-1,
                )
                for i in range(A)
            ]
        new_obs, rews, dones, _ = env.step(env_action)
        new_obs = self.pad_obs(new_obs)
        if reset:
            # Masked auto-reset of finished envs, every step, with no host
            # read of dones.
            reset_obs = self.pad_obs(env.reset_at(dones))
            new_obs = torch.where(dones[None, :, None], reset_obs, new_obs)
        self.obs = new_obs
        return {
            "obs": obs,
            "action": action,
            "logp": logp,
            "value": value,
            "rew": torch.stack(rews),
            "done": dones[None].expand(A, B),
        }

    def rollout(self, noises=None, reset: bool = True):
        """``rollout_steps`` policy steps; the transitions stacked along a
        leading time axis."""
        steps = [
            self.policy_step(None if noises is None else noises[t], reset)
            for t in range(self.cfg.rollout_steps)
        ]
        return {k: torch.stack([s[k] for s in steps]) for k in steps[0]}

    # ------------------------------------------------------------------ #
    # Packing
    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def pack(self, traj, adv, ret) -> Tensor:
        """Every per-sample field in one feature-major ``[D, n]`` float32
        tensor (rows: obs | action | logp | adv | ret | mask).  Samples lie
        as (t, agent, env) with env fastest, so a block of ``lb`` samples
        spans consecutive, independent envs of one (t, agent)."""
        T, A, B = traj["logp"].shape
        n = self.n
        mask = self.act_mask[None, :, None, :].expand(T, A, B, self.act_max)
        parts = [
            traj["obs"],
            traj["action"].to(torch.float32).reshape(T, A, B, self.act_w),
            traj["logp"][..., None],
            adv[..., None],
            ret[..., None],
            mask,
        ]
        packed = torch.empty((self.spec.d, n), dtype=torch.float32,
                             device=adv.device)
        at = 0
        for part in parts:
            w = part.shape[-1]
            packed[at:at + w] = part.reshape(n, w).t()
            at += w
        return packed

    # ------------------------------------------------------------------ #
    # Updates
    # ------------------------------------------------------------------ #
    def _permutation(self, count: int) -> Tensor:
        # argsort of uniform keys: a permutation without a host sync.
        keys = torch.rand((count,), generator=self.generator,
                          device=self.env.device)
        return torch.argsort(keys)

    def _apply(self, grads):
        """Clip ``grads`` (ordered like the parameters) and take an Adam
        step."""
        clip_by_global_norm_(grads, self.cfg.max_grad_norm)
        for p, g in zip(self.model.ordered_parameters(), grads):
            p.grad = g.view_as(p)
        self.optimizer.step()

    def _split(self, flat: Tensor):
        """A flat tensor cut into pieces shaped like the parameters (and
        whatever lies past them as one last piece)."""
        params = self.model.ordered_parameters()
        sizes = [p.numel() for p in params]
        pieces = torch.split(flat, sizes + [flat.numel() - sum(sizes)])
        return [x.view(p.shape) for x, p in zip(pieces, params)] + [pieces[-1]]

    def reduce_update(self, grads, extra: Tensor):
        """``grads`` (ordered like the parameters, each in its own shape)
        and the 1-D ``extra`` summed over the mesh's ranks in one
        ``all_reduce``: ``(grads, extra)``, in the shapes given."""
        flat = torch.cat([g.reshape(-1) for g in grads] + [extra])
        *pieces, extra = self._split(self.mesh.all_reduce(flat))
        return [x.view_as(g) for x, g in zip(pieces, grads)], extra

    def _adv_stats(self, s: Tensor, sq: Tensor, norm: int) -> Tensor:
        """``(mean, 1 / (std + 1e-8))`` of a minibatch's advantages from
        their sum and sum of squares, both summed over the ranks first."""
        if self.mesh is not None:
            s, sq = self.mesh.all_reduce(torch.stack([s, sq]))
        mean = s / norm
        var = torch.clamp_min(sq / norm - mean * mean, 0.0)
        return torch.stack([mean, 1.0 / (torch.sqrt(var) + 1e-8)])

    @torch.no_grad()
    def update_fused(self, packed_fm: Tensor, perms=None) -> Tensor:
        """All epochs and minibatches through ``puc.minibatch_update``;
        ``perms`` (one block permutation per epoch) replaces the
        generator's.  Returns the mean loss."""
        cfg, spec = self.cfg, self.spec
        lb, mb, norm = spec.lb, spec.mb, spec.norm
        nb_tot, nbm = self.n // lb, mb // lb
        # Per-block advantage sums: a minibatch's mean and std come from
        # its blocks' sums, and go to the kernel as two device scalars.
        adv_row = packed_fm[spec.obs_d + spec.act_w + 1].reshape(nb_tot, lb)
        bs = adv_row.sum(dim=1)
        bsq = (adv_row * adv_row).sum(dim=1)
        losses = []
        for e in range(cfg.epochs):
            perm = self._permutation(nb_tot) if perms is None else perms[e]
            perm = perm.to(torch.int32)
            for i in range(cfg.minibatches):
                pm = perm[i * nbm:(i + 1) * nbm].contiguous()
                grads, (pg, vf, ent) = self.minibatch_grads(
                    packed_fm, pm, bs, bsq)
                losses.append(-pg / norm + cfg.vf_coef * vf / norm
                              - cfg.ent_coef * ent / norm)
                self._apply(grads)
        return torch.stack(losses).mean()

    @torch.no_grad()
    def minibatch_grads(self, packed_fm: Tensor, pm: Tensor, bs: Tensor,
                        bsq: Tensor):
        """One minibatch (the blocks ``pm``) through the kernel: the
        gradients and ``(pg, vf, ent)`` sums of ``puc.minibatch_update``,
        summed over the mesh's ranks.  ``bs`` / ``bsq``: each block's
        advantage sum and sum of squares."""
        spec = self.spec
        adv_stats = self._adv_stats(bs[pm].sum(), bsq[pm].sum(), spec.norm)
        grads, sums = puc.minibatch_update(
            spec, packed_fm, pm, adv_stats, self.model.kernel_params())
        if self.mesh is None:
            return grads, sums
        grads, sums = self.reduce_update(grads, torch.stack(sums))
        return grads, tuple(sums)

    def loss_fn(self, batch, adv_stats: Optional[Tensor] = None,
                norm: Optional[int] = None):
        """The PPO loss of a batch-major minibatch through the model, for
        autograd.  With ``adv_stats`` (``(mean, 1 / (std + 1e-8))`` of the
        global minibatch) and ``norm`` (its size), the advantages are
        normalized by those and the means are sums over ``norm``: one
        rank's share of the global loss."""
        cfg = self.cfg
        mean, log_std, value = self.model(batch["obs"])
        if self.discrete:
            lg = torch.log_softmax(
                mean.reshape(-1, self.K, self.n_cats)
                + batch["mask"].reshape(-1, self.K, self.n_cats),
                dim=-1,
            )
            logp = torch.gather(lg, -1, batch["action"][..., None])[..., 0].sum(-1)
            ent = -(torch.exp(lg) * lg).sum(-1).sum(-1)
        else:
            logp = gaussian_logp(mean, log_std, batch["action"], batch["mask"])
            ent = torch.sum(
                (log_std + 0.5 * math.log(2 * math.pi * math.e))
                * batch["mask"],
                -1,
            )
        ratio = torch.exp(logp - batch["logp"])
        adv = batch["adv"]
        if adv_stats is None:
            adv = (adv - adv.mean()) / (adv.std(unbiased=False) + 1e-8)

            def avg(x):
                return x.mean()
        else:
            adv = (adv - adv_stats[0]) * adv_stats[1]

            def avg(x):
                return x.sum() / norm
        pg = -avg(torch.minimum(
            ratio * adv,
            torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv,
        ))
        vf = 0.5 * avg((value - batch["ret"]) ** 2)
        return pg + cfg.vf_coef * vf - cfg.ent_coef * avg(ent)

    def autograd_grads(self, x: Tensor):
        """One minibatch's gradients (ordered like the parameters) and loss
        through ``loss_fn`` and autograd; ``x``: its samples, batch-major
        ``[mb, D]``.  Under a mesh the advantage sums, gradients and loss
        are summed over the ranks."""
        spec = self.spec
        od, o = spec.obs_d, spec.obs_d + spec.act_w
        action = x[:, od:o]
        batch = {
            "obs": x[:, :od],
            "action": action.long() if self.discrete else action,
            "logp": x[:, o],
            "adv": x[:, o + 1],
            "ret": x[:, o + 2],
            "mask": x[:, o + 3:],
        }
        if self.mesh is None:
            loss = self.loss_fn(batch)
        else:
            adv = batch["adv"]
            norm = x.shape[0] * self.mesh.size
            loss = self.loss_fn(batch, self._adv_stats(
                adv.sum(), (adv * adv).sum(), norm), norm)
        params = self.model.ordered_parameters()
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        loss = loss.detach()
        if self.mesh is not None:
            grads, loss = self.reduce_update(grads, loss.reshape(1))
            loss = loss[0]
        return grads, loss

    def update_autograd(self, packed_fm: Tensor, perms=None) -> Tensor:
        """All epochs and minibatches through ``loss_fn`` and autograd, the
        shuffle at blocks of ``G`` samples (``G`` the largest power of two
        up to 64 that divides the minibatch)."""
        cfg = self.cfg
        n, mb = self.n, self.mb
        G = 1
        while G < 64 and mb % (2 * G) == 0:
            G *= 2
        mbb = mb // G
        within = torch.arange(G, device=packed_fm.device)
        losses = []
        for e in range(cfg.epochs):
            perm = self._permutation(n // G) if perms is None else perms[e]
            for i in range(cfg.minibatches):
                blocks = perm[i * mbb:(i + 1) * mbb].long()
                cols = (blocks[:, None] * G + within).reshape(-1)
                grads, loss = self.autograd_grads(packed_fm[:, cols].t())
                losses.append(loss)
                with torch.no_grad():
                    self._apply(grads)
        return torch.stack(losses).mean()

    # ------------------------------------------------------------------ #
    # One iteration
    # ------------------------------------------------------------------ #
    def collect(self, noises=None, reset: bool = True):
        """Rollout, GAE and packing: ``(packed_fm [D, n], traj)``."""
        traj = self.rollout(noises, reset)
        with torch.no_grad():
            last_value = self.model(self.obs)[2]
            adv, ret = compute_gae(
                self.cfg, traj["rew"], traj["done"].to(torch.float32),
                traj["value"], last_value,
            )
        return self.pack(traj, adv, ret), traj

    def update(self, packed_fm: Tensor, perms=None) -> Tensor:
        if self.fused:
            return self.update_fused(packed_fm, perms)
        return self.update_autograd(packed_fm, perms)

    def train_step(self):
        """One training iteration; returns ``{"loss", "mean_reward"}`` as
        device tensors."""
        packed_fm, traj = self.collect()
        loss = self.update(packed_fm)
        mean_reward = traj["rew"].mean()
        if self.mesh is not None:
            mean_reward = self.mesh.all_reduce(
                mean_reward.reshape(1))[0] / self.mesh.size
        return {"loss": loss, "mean_reward": mean_reward}


def train_step(trainer: Trainer):
    """One training iteration of ``trainer``, which is updated in place;
    returns ``(trainer, metrics)`` as the JAX example returns ``(carry,
    metrics)``."""
    return trainer, trainer.train_step()


def init_training(scenario="dispersion", num_envs=512, seed=0,
                  cfg: PPOConfig = PPOConfig(), device=None,
                  mesh: Optional[EnvMesh] = None, **scenario_kwargs):
    """Build env, model and optimizer: ``(env, train_step, trainer)``.

    ``device=None`` is the CUDA card (and raises without one);
    ``device="cpu"`` trains on the CPU, where the minibatch update runs its
    plain PyTorch version.  ``mesh``: the ``num_envs`` envs are split over
    its ranks (on the mesh's device, if it names one), and ``env`` is this
    rank's ``num_envs / ranks``, built at that batch with the rank's seed
    (``rank_seed``): the trainer's first reset overwrites every row, so
    the global env is never built (``shard_environment`` splits an env
    whose rows matter)."""
    if mesh is not None:
        if num_envs % mesh.size:
            raise ValueError(
                f"num_envs ({num_envs}) must be divisible by the number of"
                f" mesh devices ({mesh.size})")
        if mesh.device is not None:
            device = mesh.device
        num_envs //= mesh.size
        seed = rank_seed(seed, mesh.rank)
    device = resolve_device(device)
    env = vmt.make_env(scenario, num_envs=num_envs, device=device, seed=seed,
                       **scenario_kwargs)
    return env, train_step, Trainer(env, cfg, seed, mesh)


def main():
    scenario = sys.argv[1] if len(sys.argv) > 1 else "dispersion"
    num_envs = int(sys.argv[2]) if len(sys.argv) > 2 else 512
    iters = int(sys.argv[3]) if len(sys.argv) > 3 else 50
    # Under torch.distributed.run: one rank a GPU over NCCL, the envs split.
    mesh = (init_distributed("nccl") if "WORLD_SIZE" in os.environ
            else None)
    env, step, trainer = init_training(scenario, num_envs, mesh=mesh)
    for it in range(iters):
        trainer, metrics = step(trainer)
        if mesh is None or mesh.rank == 0:
            print(
                f"iter {it:3d}  loss {float(metrics['loss']):+.4f}"
                f"  mean_reward {float(metrics['mean_reward']):+.5f}",
                flush=True,
            )
    if mesh is not None:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
