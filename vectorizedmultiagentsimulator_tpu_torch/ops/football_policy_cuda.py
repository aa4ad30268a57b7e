"""Football's scripted-AI planner as a hand-written CUDA kernel
(``csrc/football_policy.cu``).

Replaces the JAX package's Pallas kernel
(``ops/football_policy_pallas.py::_make_kernel``).  For every env and AI
teammate the planner builds ``S + 1`` candidate targets (the current target,
then the samples: even samples centred on the ball, odd ones on the agent),
clamps them to the pitch, scores them with the 5-term value of
``AgentPolicy.get_pos_value`` and returns the first-max candidate.  The
normals of the samples (and the optional value noise) are drawn outside,
unscaled; the kernel and the plain version scale them by the same fp32
products (``PlannerParams.sigma``, ``spread`` and ``noise_scale``), so the
kernel is a pure function of its operands.  This module holds:

* ``PlannerParams`` and ``planner_params(policy)``: the static planner
  configuration, as in the JAX package, and the scales of the draws;
* ``candidate_values_plain`` and ``best_positions_plain``: the plain
  PyTorch version, the counterpart of the JAX package's
  ``best_positions_jnp`` (the same formulation: the stacked
  wall-displacement form, the first-max fold with strict ``>``);
* ``fused_best_positions``: the wrapper.  On CUDA tensors it launches the
  kernel or raises; on CPU tensors it runs ``best_positions_plain``.  It is
  a ``torch.autograd.Function`` whose backward re-runs
  ``best_positions_plain`` under autograd, as the JAX package's
  ``custom_vjp`` replays its jnp mirror;
* ``LAUNCHES``: the number of kernel launches, counted where the kernel is
  launched and nowhere else.

Shapes: ``agents_pos [B, T, 2]``, ``curr_target [B, T, 2]``, ``normals [B,
T, S, 2]`` (the samples are ``normals * sigma * spread``), ``ball_pos``,
``target_net_pos`` and ``own_net_pos [B, 2]``, ``value_noise [B, T, S + 1]``
(times ``noise_scale``) or None; the result is ``[B, T, 2]``, all float32.
On the card ``agents_pos``, ``normals`` and ``value_noise`` are contiguous;
``curr_target`` and the three positions may be views with any batch (and
teammate) stride and a unit last stride, such as the columns of the world's
``state.pos``.  The kernel is built at first use by :mod:`.cuda_build`.
"""
from __future__ import annotations

import ctypes
import os
from typing import NamedTuple, Optional

import torch

from vectorizedmultiagentsimulator_tpu_torch.ops import cuda_build

LAUNCHES = 0

SOURCE = os.path.join(cuda_build.CSRC, "football_policy.cu")

Tensor = torch.Tensor

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


class PlannerParams(NamedTuple):
    """Static planner configuration (the JAX package's, field for field)."""

    T: int  # teammates
    S: int  # nsamples
    clamp_y: float  # pitch_width/2 - agent_size
    clamp_x: float  # pitch_length/2 - agent_size
    goal_y: float  # goal_size/2 - agent_size
    goal_x: float  # goal_depth
    wall_w2: float  # pitch_width/2
    wall_l2: float  # pitch_length/2
    margin0: float  # replan_margin + 3*(1 - decision_strength)
    has_noise: bool  # decision_strength != 1 -> value-noise operand
    # The scales of the draws, each one fp32 product in this order:
    # samples = normals * sigma * spread, noise = value_noise * noise_scale.
    sigma: float = 1.0
    spread: float = 1.0  # 1 + 3*(1 - decision_strength)
    noise_scale: float = 1.0  # 1 - decision_strength


def planner_params(policy) -> PlannerParams:
    """The static planner config of a live ``AgentPolicy``."""
    world = policy.world
    ds = policy.decision_strength
    return PlannerParams(
        T=len(policy.teammates),
        S=int(policy.nsamples),
        clamp_y=float(world.pitch_width / 2 - world.agent_size),
        clamp_x=float(world.pitch_length / 2 - world.agent_size),
        goal_y=float(world.goal_size / 2 - world.agent_size),
        goal_x=float(world.goal_depth),
        wall_w2=float(world.pitch_width / 2),
        wall_l2=float(world.pitch_length / 2),
        margin0=float(policy.replan_margin + 3 * (1 - ds)),
        has_noise=bool(ds != 1),
        sigma=float(policy.sigma),
        spread=float(1 + 3 * (1 - ds)),
        noise_scale=float(1 - ds),
    )


class _Params(ctypes.Structure):
    """``Params`` of csrc/football_policy.cu, field for field.  The clamp
    bounds are rounded to fp32 here exactly as ``torch.clamp`` rounds the
    plain version's Python bounds."""

    _fields_ = [("T", _I), ("S", _I), ("has_noise", _I)] + [
        (n, _F) for n in ("clamp_y", "clamp_x", "goal_y", "goal_x_hi",
                          "wall_w2", "wall_l2", "margin0", "sigma", "spread",
                          "noise_scale")
    ]


_L = ctypes.c_longlong


class _Operands(ctypes.Structure):
    """``Operands`` of csrc/football_policy.cu, field for field: the
    operands' addresses and strides (in floats) of one call."""

    _fields_ = [("agents_pos", _P), ("curr_target", _P), ("ct_b", _L),
                ("ct_t", _L), ("normals", _P), ("ball", _P), ("ball_b", _L),
                ("target_net", _P), ("tnet_b", _L), ("own_net", _P),
                ("onet_b", _L), ("noise", _P), ("out", _P), ("B", _I)]


_structs = {}


def _struct(p: PlannerParams) -> _Params:
    """The kernel's ``Params`` for ``p``, filled once."""
    s = _structs.get(p)
    if s is None:
        s = _structs[p] = _Params(
            p.T, p.S, int(p.has_noise), p.clamp_y, p.clamp_x, p.goal_y,
            p.clamp_x + p.goal_x, p.wall_w2, p.wall_l2, p.margin0,
            p.sigma, p.spread, p.noise_scale,
        )
    return s


_NOT_SELF = {}


def _not_self(T: int, device) -> Tensor:
    """``[T, 1, T]``: 0 where the teammate is the agent itself, else 1;
    made once per device."""
    key = (T, str(device))
    m = _NOT_SELF.get(key)
    if m is None:
        m = _NOT_SELF[key] = (
            1.0 - torch.eye(T, dtype=torch.float32, device=device))[:, None]
    return m


def _norm2(x: Tensor, y: Tensor) -> Tensor:
    """|(x, y)| as two products, a sum and a square root, each its own
    rounding (the kernel's order)."""
    return torch.sqrt(x * x + y * y)


def candidate_values_plain(p: PlannerParams, agents_pos, curr_target, normals,
                           ball_pos, target_net_pos, own_net_pos,
                           value_noise=None):
    """The clamped candidates and their values: ``(px, py, values)``, each
    ``[B, T, S + 1]``; candidate 0 is ``curr_target``, candidate ``j + 1``
    is sample ``j`` (``normals[..., j, :] * sigma * spread``) around the
    ball (even ``j``) or the agent (odd ``j``).  ``values`` include the
    value noise (``value_noise * noise_scale``) and candidate 0's margin."""
    T, S = p.T, p.S
    ax, ay = agents_pos[..., 0], agents_pos[..., 1]  # [B, T]
    bx, by = ball_pos[:, None, 0:1], ball_pos[:, None, 1:2]  # [B, 1, 1]
    on_ball = torch.arange(S, device=ax.device) % 2 == 0  # [S]
    centre_x = torch.where(on_ball, bx, ax[..., None])  # [B, T, S]
    centre_y = torch.where(on_ball, by, ay[..., None])
    samples = normals * p.sigma * p.spread
    rx = torch.cat([curr_target[..., 0:1], samples[..., 0] + centre_x], -1)
    ry = torch.cat([curr_target[..., 1:2], samples[..., 1] + centre_y], -1)

    # clamp_pos (football.py AgentPolicy.clamp_pos)
    py = torch.clamp(ry, -p.clamp_y, p.clamp_y)
    inside_goal_y = torch.abs(py) < p.goal_y
    px = torch.where(
        inside_goal_y,
        torch.clamp(rx, -p.clamp_x - p.goal_x, p.clamp_x + p.goal_x),
        torch.clamp(rx, -p.clamp_x, p.clamp_x),
    )

    # get_pos_value: ball proximity and direction
    bvx, bvy = bx - px, by - py
    ball_norm = _norm2(bvx, bvy)
    valid = ball_norm > 0
    bden = torch.clamp_min(ball_norm, 1e-12)
    zero = torch.zeros_like(px)
    bhx = torch.where(valid, bvx / bden, zero)
    bhy = torch.where(valid, bvy / bden, zero)
    # |pos - ball| is |ball - pos|: negation is exact.
    d2 = ball_norm * ball_norm
    ball_dist_value = torch.exp(-2 * (d2 * d2))

    # shooting-side and defend dot products
    nvx = target_net_pos[:, None, 0:1] - px
    nvy = target_net_pos[:, None, 1:2] - py
    net_norm = torch.clamp_min(_norm2(nvx, nvy), 1e-12)
    side_dot = bhx * (nvx / net_norm) + bhy * (nvy / net_norm)
    side_value = torch.clamp_max(side_dot + 1.25, 1.0)
    ovx = (own_net_pos[:, None, 0:1] - px) / net_norm
    ovy = (own_net_pos[:, None, 1:2] - py) / net_norm
    defend_value = torch.clamp_min(bhx * -ovx + bhy * -ovy, 0.0)

    # teammate repulsion: 1 - |(exp(-5 d_j))_j| with the agent's own term
    # zeroed, its squares summed over the teammates in order
    if T > 1:
        dx = ax[:, None, None, :] - px[..., None]  # [B, T, S + 1, T]
        dy = ay[:, None, None, :] - py[..., None]
        e = torch.exp(-5 * _norm2(dx, dy)) * _not_self(T, px.device)
        sq = e * e
        acc = sq[..., 0]
        for j in range(1, T):
            acc = acc + sq[..., j]
        other_agent_value = -torch.sqrt(acc) + 1

    # get_wall_separations in its stacked form: the vertical displacement
    # (0, vmag * vsign), the horizontal one (hmag * hsign, 0)
    top, bottom = -py + p.wall_w2, py + p.wall_w2
    left, right = px + p.wall_l2, -px + p.wall_l2
    vmag = torch.minimum(top, bottom)
    vsign = torch.where(bottom < top, -1.0, 1.0)
    hmag = torch.minimum(left, right)
    hsign = torch.where(left < right, -1.0, 1.0)
    wall_v = _norm2(zero, vmag * vsign)
    wall_h = _norm2(hmag * hsign, zero)
    wall_value = -_norm2(torch.exp(-8 * wall_v), torch.exp(-8 * wall_h)) + 1

    value = wall_value
    if T > 1:
        value = value + other_agent_value
    value = (value + ball_dist_value + side_value + defend_value) / 5
    if p.has_noise:
        value = value + value_noise * p.noise_scale
    value = torch.cat([value[..., :1] + p.margin0, value[..., 1:]], -1)
    return px, py, value


def best_positions_plain(p: PlannerParams, agents_pos, curr_target, normals,
                         ball_pos, target_net_pos, own_net_pos,
                         value_noise=None) -> Tensor:
    """The plain PyTorch version of the kernel: the first-max candidate of
    ``candidate_values_plain`` (strict ``>``: ties keep the earliest),
    ``[B, T, 2]``."""
    px, py, values = candidate_values_plain(
        p, agents_pos, curr_target, normals, ball_pos, target_net_pos,
        own_net_pos, value_noise)
    best_x, best_y, best_val = px[..., 0], py[..., 0], values[..., 0]
    for k in range(1, p.S + 1):
        better = values[..., k] > best_val
        best_x = torch.where(better, px[..., k], best_x)
        best_y = torch.where(better, py[..., k], best_y)
        best_val = torch.maximum(best_val, values[..., k])
    return torch.stack([best_x, best_y], dim=-1)


def build() -> str:
    """Compile the kernel library if needed; returns its path."""
    return cuda_build.build(SOURCE)


_fn = None


def _library():
    """``vmt_football_best_positions``, built and bound at the first
    launch."""
    global _fn
    if _fn is None:
        _fn = cuda_build.entry_point(
            SOURCE, "vmt_football_best_positions", [_P, _P, _P])
    return _fn


def operands(p: PlannerParams, agents_pos, curr_target, normals, ball_pos,
             target_net_pos, own_net_pos, value_noise, out) -> _Operands:
    """The kernel's ``Operands`` for these tensors (on one device, checked
    here): their addresses and strides.  Raises on a shape, type or layout
    the kernel does not take."""
    if p.T < 1 or p.S < 0:
        raise ValueError(f"T={p.T}, S={p.S}: the kernel takes T >= 1, S >= 0")
    if (value_noise is None) == p.has_noise:
        raise ValueError("value_noise must be given iff p.has_noise")
    B = agents_pos.shape[0]
    T, S = p.T, p.S
    dev = agents_pos.device
    # (name, tensor, shape, whole tensor contiguous: else the last stride 1)
    checks = [("agents_pos", agents_pos, (B, T, 2), True),
              ("curr_target", curr_target, (B, T, 2), False),
              ("normals", normals, (B, T, S, 2), True),
              ("ball_pos", ball_pos, (B, 2), False),
              ("target_net_pos", target_net_pos, (B, 2), False),
              ("own_net_pos", own_net_pos, (B, 2), False),
              ("out", out, (B, T, 2), True)]
    if p.has_noise:
        checks.append(("value_noise", value_noise, (B, T, S + 1), True))
    for name, x, shape, whole in checks:
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, expected {dev}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} has dtype {x.dtype}, expected float32")
        if tuple(x.shape) != shape:
            raise ValueError(
                f"{name} has shape {tuple(x.shape)}, expected {shape}")
        if whole and not x.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
        if not whole and x.stride(-1) != 1:
            raise ValueError(
                f"{name} has strides {x.stride()}: the kernel takes a unit"
                " last stride")
    return _Operands(
        agents_pos.data_ptr(), curr_target.data_ptr(), curr_target.stride(0),
        curr_target.stride(1), normals.data_ptr(), ball_pos.data_ptr(),
        ball_pos.stride(0), target_net_pos.data_ptr(),
        target_net_pos.stride(0), own_net_pos.data_ptr(),
        own_net_pos.stride(0),
        value_noise.data_ptr() if p.has_noise else None, out.data_ptr(), B)


def launch(p: PlannerParams, agents_pos, curr_target, normals, ball_pos,
           target_net_pos, own_net_pos, value_noise=None) -> Tensor:
    """Launch the kernel on PyTorch's current stream; returns the best
    positions ``[B, T, 2]``, allocated here."""
    global LAUNCHES
    dev = agents_pos.device
    if dev.type != "cuda":
        raise ValueError(f"the kernel runs on CUDA tensors, got {dev}")
    out = torch.empty((agents_pos.shape[0], p.T, 2), dtype=torch.float32,
                      device=dev)
    ops = operands(p, agents_pos, curr_target, normals, ball_pos,
                   target_net_pos, own_net_pos, value_noise, out)
    err = _library()(ctypes.addressof(ops), ctypes.addressof(_struct(p)),
                     torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"planner kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


class _FusedBestPositions(torch.autograd.Function):
    @staticmethod
    def forward(ctx, p, agents_pos, curr_target, normals, ball_pos,
                target_net_pos, own_net_pos, value_noise):
        inputs = (agents_pos, curr_target, normals, ball_pos, target_net_pos,
                  own_net_pos) + ((value_noise,) if p.has_noise else ())
        ctx.save_for_backward(*inputs)
        ctx.p = p
        devices = {x.device.type for x in inputs}
        if devices == {"cuda"}:
            return launch(p, *inputs)
        if devices == {"cpu"}:
            return best_positions_plain(p, *inputs)
        raise ValueError(f"inputs on mixed devices: {devices}")

    @staticmethod
    def backward(ctx, grad):
        inputs = [
            x.detach().requires_grad_(need)
            for x, need in zip(ctx.saved_tensors, ctx.needs_input_grad[1:])
        ]
        wrt = [x for x in inputs if x.requires_grad]
        with torch.enable_grad():
            out = best_positions_plain(ctx.p, *inputs)
        got = iter(
            torch.autograd.grad(out, wrt, grad, allow_unused=True)
            if out.requires_grad else [None] * len(wrt)
        )
        grads = [next(got) if x.requires_grad else None for x in inputs]
        return (None, *grads) + (None,) * (7 - len(grads))


def fused_best_positions(p: PlannerParams, agents_pos: Tensor,
                         curr_target: Tensor, normals: Tensor,
                         ball_pos: Tensor, target_net_pos: Tensor,
                         own_net_pos: Tensor,
                         value_noise: Optional[Tensor] = None) -> Tensor:
    """The planner's best positions ``[B, T, 2]``: the kernel on CUDA
    tensors, ``best_positions_plain`` on CPU tensors; differentiable
    through ``best_positions_plain``.  ``value_noise`` is given iff
    ``p.has_noise``; both it and ``normals`` are unscaled draws (see
    ``PlannerParams``)."""
    if (value_noise is None) == p.has_noise:
        raise ValueError(
            "fused_best_positions: value_noise must be given iff p.has_noise"
            f" (has_noise={p.has_noise})")
    return _FusedBestPositions.apply(p, agents_pos, curr_target, normals,
                                     ball_pos, target_net_pos, own_net_pos,
                                     value_noise)
