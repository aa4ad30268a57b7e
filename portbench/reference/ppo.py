"""Plain reference of one PPO training iteration on a simulated scenario,
as the port's trainer states it (``examples/torch_ppo.py``'s ``PPOConfig``
and the JAX example it follows): a rollout of ``rollout_steps`` steps of
every env under a shared actor-critic MLP (two tanh trunk layers and a
float32 mean head, a ``log_std`` vector, a tanh value branch), GAE, then
``epochs`` x ``minibatches`` clipped-PPO updates over shuffled blocks of
``fused_block`` samples, each gradient clipped to a global norm of
``max_grad_norm`` and applied by Adam.

Precision, as the configuration states it: the trunk computes in
bfloat16 in the rollout (``trunk_dtype``), and in the update on
bfloat16-rounded operands with float32 sums, bias and tanh (the fused
update's); the heads, the loss and Adam in float32.  ``trunk="fp8"``
rounds the trunk's operands to float8 (e4m3) instead: the control.

It imports nothing of the port: the env is the configuration's own plain
reference, the gradients are autograd's, Adam is written out.
"""
from __future__ import annotations

import math

import torch

LOG_2PI = math.log(2 * math.pi)
ENT_C = 0.5 * math.log(2 * math.pi * math.e)
NAMES = ("w1", "b1", "w2", "b2", "wm", "bm", "log_std", "wv", "bv", "wv2",
         "bv2")


def init_params(obs_d: int, act_w: int, hidden: int, generator, device):
    """The benchmark's initial weights: each dense weight ``[in, out]``
    normal with variance ``1 / in`` (lecun), biases and ``log_std`` 0.
    Drawn in one call on the device."""
    shapes = {"w1": (obs_d, hidden), "w2": (hidden, hidden),
              "wm": (hidden, act_w), "wv": (obs_d, hidden),
              "wv2": (hidden, 1)}
    total = sum(a * b for a, b in shapes.values())
    flat = torch.randn(total, generator=generator, device=device)
    params, at = {}, 0
    for name, (a, b) in shapes.items():
        params[name] = flat[at:at + a * b].view(a, b) / math.sqrt(a)
        at += a * b
    for name, n in (("b1", hidden), ("b2", hidden), ("bm", act_w),
                    ("log_std", act_w), ("bv", hidden), ("bv2", 1)):
        params[name] = torch.zeros(n, device=device)
    return {k: params[k] for k in NAMES}


def _round(x, trunk):
    if trunk == "fp8":
        return x.to(torch.float8_e4m3fn).to(torch.float32)
    return x.to(torch.bfloat16).to(torch.float32)


def forward_rollout(p, x, trunk="bf16"):
    """The rollout's forward: the trunk layers in bfloat16 (operands,
    product, bias and tanh), the heads in float32.  ``(mean, log_std,
    value)``."""
    if trunk == "fp8":
        def layer(h, w, b):
            return torch.tanh(_round(h, trunk) @ _round(w, trunk) + b)

        h = layer(layer(x, p["w1"], p["b1"]), p["w2"], p["b2"])
        v = layer(x, p["wv"], p["bv"])
    else:
        bf = torch.bfloat16

        def layer(h, w, b):
            return torch.tanh(h.to(bf) @ w.to(bf) + b.to(bf))

        h = layer(layer(x, p["w1"], p["b1"]), p["w2"], p["b2"]).float()
        v = layer(x, p["wv"], p["bv"]).float()
    mean = h @ p["wm"] + p["bm"]
    value = (v @ p["wv2"] + p["bv2"])[..., 0]
    return mean, p["log_std"], value


def forward_update(p, x, trunk="bf16"):
    """The update's forward: trunk products of rounded operands summed in
    float32, bias and tanh in float32; the heads in float32."""
    def layer(h, w, b):
        return torch.tanh(_round(h, trunk) @ _round(w, trunk) + b)

    h = layer(layer(x, p["w1"], p["b1"]), p["w2"], p["b2"])
    v = layer(x, p["wv"], p["bv"])
    mean = h @ p["wm"] + p["bm"]
    value = (v @ p["wv2"] + p["bv2"])[..., 0]
    return mean, p["log_std"], value


def gaussian_logp(mean, log_std, action):
    var = torch.exp(2 * log_std)
    return (-0.5 * (action - mean) ** 2 / var - log_std - 0.5 * LOG_2PI).sum(-1)


def gae(rew, done, value, last_value, gamma, lam):
    adv = torch.empty_like(rew)
    carry = torch.zeros_like(last_value)
    next_value = last_value
    for t in range(rew.shape[0] - 1, -1, -1):
        live = 1 - done[t]
        delta = rew[t] + gamma * next_value * live - value[t]
        carry = delta + gamma * lam * live * carry
        adv[t] = carry
        next_value = value[t]
    return adv, adv + value


class Adam:
    """Adam (Kingma and Ba) with bias correction, written out."""

    def __init__(self, params, lr, betas=(0.9, 0.999), eps=1e-8):
        self.lr, self.betas, self.eps, self.t = lr, betas, eps, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    def step(self, params, grads):
        self.t += 1
        b1, b2 = self.betas
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for k, g in grads.items():
            self.m[k] = b1 * self.m[k] + (1 - b1) * g
            self.v[k] = b2 * self.v[k] + (1 - b2) * g * g
            denom = (self.v[k] / c2).sqrt() + self.eps
            params[k] = params[k] - self.lr * (self.m[k] / c1) / denom


class Trainer:
    """The reference trainer: ``iteration`` runs one whole PPO iteration
    from the env state it holds.  ``env``: the configuration's reference
    module, ``tables`` its ``world.Tables``; ``ppo``: the traffic's
    ``PPOConfig`` values.  ``fault`` plants one of the faults the
    comparison must catch: ``"half_batch"`` (each minibatch's gradient
    from its first half only, the mean taken over it), ``"answer"`` (the
    loss an iteration reports 1 % off where it is produced)."""

    def __init__(self, env, tables, ppo: dict, params: dict, state: dict,
                 trunk="bf16", fault=None):
        self.env, self.T, self.ppo = env, tables, ppo
        self.params = {k: v.clone() for k, v in params.items()}
        self.adam = Adam(self.params, ppo["lr"])
        self.state = state
        self.trunk, self.fault = trunk, fault
        self.n_agents = len(tables.agent_index)
        self.u_range = torch.tensor(
            [a["u_range"] for a in tables.cfg["agents"]],
            device=state["pos"].device)[:, None, None]
        self.obs = self.pad(env.observe(tables, state))

    def pad(self, obs):
        """``[A, B, D]`` -> ``[A, B, D + A]``: a one-hot agent id appended
        (every agent of these configurations observes ``D`` numbers)."""
        A, B = obs.shape[:2]
        eye = torch.eye(A, device=obs.device)[:, None].expand(A, B, A)
        return torch.cat([obs.float(), eye], -1)

    @torch.no_grad()
    def rollout(self, noises):
        p, steps = self.params, []
        for t in range(self.ppo["rollout_steps"]):
            obs = self.obs
            mean, log_std, value = forward_rollout(p, obs, self.trunk)
            action = mean + torch.exp(log_std) * noises[t]
            logp = gaussian_logp(mean, log_std, action)
            u = torch.minimum(torch.maximum(action, -self.u_range),
                              self.u_range)
            self.state, new_obs, rew, done = self.env.step(self.T, self.state,
                                                           u)
            self.obs = self.pad(new_obs)
            steps.append((obs, action, logp, value, rew.float(),
                          done[None].expand_as(rew)))
        return [torch.stack(x) for x in zip(*steps)]

    def iteration(self, noises, perms):
        """One iteration; returns ``(loss, dones)``: the mean loss of its
        minibatch updates and the ``[T, A, B]`` dones of its rollout (a
        done env would be reset from the port's own generator, which the
        reference cannot follow)."""
        c = self.ppo
        obs, action, logp, value, rew, done = self.rollout(noises)
        with torch.no_grad():
            last_value = forward_rollout(self.params, self.obs, self.trunk)[2]
            adv, ret = gae(rew, done.float(), value, last_value, c["gamma"],
                           c["gae_lambda"])
        T, A, B = logp.shape
        n = T * A * B
        x_obs = obs.reshape(n, -1)
        x_act = action.reshape(n, -1)
        x_logp, x_adv, x_ret = (y.reshape(n) for y in (logp, adv, ret))
        lb = c["fused_block"]
        mb = n // c["minibatches"]
        nbm = mb // lb
        within = torch.arange(lb, device=obs.device)
        losses = []
        for e in range(c["epochs"]):
            for i in range(c["minibatches"]):
                blocks = perms[e][i * nbm:(i + 1) * nbm].long()
                if self.fault == "half_batch":
                    blocks = blocks[:nbm // 2]
                idx = (blocks[:, None] * lb + within).reshape(-1)
                loss, grads = self.minibatch(x_obs[idx], x_act[idx],
                                             x_logp[idx], x_adv[idx],
                                             x_ret[idx])
                losses.append(loss)
                norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
                scale = c["max_grad_norm"] / torch.clamp_min(
                    norm, c["max_grad_norm"])
                self.adam.step(self.params,
                               {k: g * scale for k, g in grads.items()})
        loss = torch.stack(losses).mean()
        return loss * 1.01 if self.fault == "answer" else loss, done

    def minibatch(self, obs, action, logp_old, adv, ret):
        """The PPO loss of one minibatch and its gradients (autograd)."""
        c = self.ppo
        p = {k: v.detach().requires_grad_(True)
             for k, v in self.params.items()}
        mean_a = adv.mean()
        var = torch.clamp_min((adv * adv).mean() - mean_a * mean_a, 0.0)
        adv = (adv - mean_a) / (torch.sqrt(var) + 1e-8)
        mean, log_std, value = forward_update(p, obs, self.trunk)
        ratio = torch.exp(gaussian_logp(mean, log_std, action) - logp_old)
        clipped = torch.clamp(ratio, 1 - c["clip_eps"], 1 + c["clip_eps"])
        pg = -torch.minimum(ratio * adv, clipped * adv).mean()
        vf = 0.5 * ((value - ret) ** 2).mean()
        ent = (log_std + ENT_C).sum()
        loss = pg + c["vf_coef"] * vf - c["ent_coef"] * ent
        grads = torch.autograd.grad(loss, list(p.values()))
        return loss.detach(), dict(zip(p, grads))
