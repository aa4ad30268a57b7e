"""One PPO minibatch update as a hand-written CUDA kernel
(``csrc/ppo_update.cu``).

Replaces the JAX package's Pallas kernel
(``ops/ppo_update_pallas.py::_kernel``).  This module holds:

* ``PPOUpdateSpec`` and ``pack_rows``: the static shape and coefficients of
  an update and the row layout of the packed rollout, as in the JAX package;
* ``minibatch_update_plain``: the plain PyTorch version, a mirror of the JAX
  package's ``_fwd_math`` and ``_bwd_math`` (the same bf16 casts in the
  trunk, the same ``<=`` and closed-interval tie rules, the same per-dim
  entropy term in the discrete backward).  bf16 operands are rounded and
  multiplied in float32, so the result does not depend on a bf16 matrix
  product;
* ``update_supported(spec)``: whether the kernel takes a spec: a trunk too
  wide for its gradient sums to share a block's shared memory (from about
  hidden 150 to 256) is split over a cluster of 4 blocks, which keep the
  sums on chip; one too wide for its bf16 weights (from about 260), then
  for its fp32 activation tiles (past about 1,040 at obs_d 15), keeps the
  sums, then the weights, then the tiles in device memory; only packed rows
  too many for two raw tiles of 16 samples (more than about 1,200) are
  refused;
* ``minibatch_update``: the wrapper.  On CUDA tensors it launches the kernel
  or raises; on CPU tensors it runs ``minibatch_update_plain``.  It returns
  gradients and nothing differentiates through it, so it is no
  ``autograd.Function``;
* ``LAUNCHES``: the number of minibatches sent to the kernel, counted where
  the kernel is launched and nowhere else, and ``LAUNCHES_BY_LAYOUT``, the
  same by ``layout(spec)``.

The kernel's head shape is static, so the source is compiled once per
``(obs_d, act_w, hidden, n_logits, layout(spec))`` at first use by
:mod:`.cuda_build`;
``n``, ``mb``, ``lb`` and the coefficients are runtime fields of a struct
filled once per spec.
"""
from __future__ import annotations

import ctypes
import math
import os
from typing import NamedTuple, Tuple

import torch

from vectorizedmultiagentsimulator_tpu_torch.ops import cuda_build

LAUNCHES = 0
LAUNCHES_BY_LAYOUT = {}

SOURCE = os.path.join(cuda_build.CSRC, "ppo_update.cu")

# csrc/ppo_update.cu: the tile sizes (samples) it can be compiled for,
# largest first; the shared memory a block may use on sm_90, and an SM's
# (a block reserves 1 KB more).
TILES = (64, 32, 16)
MAX_SMEM_BYTES = 232448
SM_SMEM_BYTES = 233472
MAX_BLOCKS_PER_SM = 2  # __launch_bounds__(256, 2)
CLUSTER = 4  # blocks of a cluster in the cluster layout (PPO_CL)

_LOG_2PI = float(math.log(2.0 * math.pi))
_ENT_C = float(0.5 * math.log(2.0 * math.pi) + 0.5)  # per-dim Gaussian ent.

Tensor = torch.Tensor


class PPOUpdateSpec(NamedTuple):
    """Static shape and coefficients of the update.

    ``n_logits == 0`` is the continuous (Gaussian) mode: ``act_w``-wide
    actions and a multiplicative per-dim action mask.  ``n_logits > 0`` is
    the factored-categorical mode: ``act_w`` independent categoricals of
    ``n_logits`` choices each (flat Discrete is ``act_w == 1``).  The action
    rows then hold the chosen indices as float32 and the mask rows the
    additive ``act_w * n_logits``-wide logits mask (0 on a real choice, -1e9
    on padding; a fully padded dim keeps choice 0 valid).
    """

    obs_d: int  # observation rows (with the one-hot agent id)
    act_w: int  # action width (padded to the widest agent)
    hidden: int
    lb: int  # samples per shuffle block
    mb: int  # samples per minibatch
    clip_eps: float
    vf_coef: float
    ent_coef: float
    n_logits: int = 0  # categorical head width; 0: continuous
    # Count the means are taken over; 0: mb.  A data-parallel caller sets
    # the global minibatch size so that the shards' gradients add up.
    norm_n: int = 0

    @property
    def norm(self) -> int:
        return self.norm_n if self.norm_n else self.mb

    @property
    def discrete(self) -> bool:
        return self.n_logits > 0

    @property
    def mask_w(self) -> int:
        return self.act_w * self.n_logits if self.discrete else self.act_w

    @property
    def d(self) -> int:  # packed rows
        return self.obs_d + self.act_w + 3 + self.mask_w


def pack_rows(spec: PPOUpdateSpec):
    """Row range of each field in the packed ``[D, n]`` array."""
    od, aw = spec.obs_d, spec.act_w
    return {
        "obs": (0, od),
        "action": (od, od + aw),
        "logp": (od + aw, od + aw + 1),
        "adv": (od + aw + 1, od + aw + 2),
        "ret": (od + aw + 2, od + aw + 3),
        "mask": (od + aw + 3, od + aw + 3 + spec.mask_w),
    }


def param_shapes(spec: PPOUpdateSpec):
    """Shapes of ``(W1, b1, W2, b2, Wm, bm, log_std, Wv, bv, Wv2, bv2)``:
    weights ``[in, out]``, biases and ``log_std`` as columns."""
    od, H, hw = spec.obs_d, spec.hidden, spec.mask_w
    return ((od, H), (H, 1), (H, H), (H, 1), (H, hw), (hw, 1), (hw, 1),
            (od, H), (H, 1), (H, 1), (1, 1))


def _bf16(x: Tensor) -> Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _fields(spec: PPOUpdateSpec, x: Tensor, adv_stats: Tensor):
    rows = pack_rows(spec)

    def row(name):
        a, b = rows[name]
        return x[a:b]

    adv_n = (row("adv") - adv_stats[0]) * adv_stats[1]
    return (row("obs"), row("action"), row("logp"), adv_n, row("ret"),
            row("mask"))


def forward_plain(spec, params, obs, act, logp_old, adv_n, ret, mask):
    """Forward pass and per-sample loss pieces, feature-major ``[rows,
    samples]``: trunk products on bf16-rounded operands with float32
    accumulation, everything else float32."""
    W1, b1, W2, b2, Wm, bm, ls, Wv, bv, Wv2, bv2 = params
    obs_b = _bf16(obs)
    h1 = torch.tanh(_bf16(W1).t() @ obs_b + b1)  # [H, n]
    h2 = torch.tanh(_bf16(W2).t() @ _bf16(h1) + b2)
    mean = Wm.t() @ h2 + bm  # [hw, n], the float32 head
    hv = torch.tanh(_bf16(Wv).t() @ obs_b + bv)
    value = Wv2.t() @ hv + bv2  # [1, n]

    out = dict(h1=h1, h2=h2, hv=hv, value=value)
    if spec.discrete:
        nl = spec.n_logits
        logp = torch.zeros_like(logp_old)
        ent_i = torch.zeros_like(logp_old)
        dims = []
        choices = torch.arange(nl, device=obs.device)[:, None]
        for k in range(spec.act_w):
            logits = mean[k * nl:(k + 1) * nl] + mask[k * nl:(k + 1) * nl]
            mx = logits.max(dim=0, keepdim=True).values
            ex = torch.exp(logits - mx)
            z = ex.sum(dim=0, keepdim=True)
            probs = ex / z
            logp_all = logits - (torch.log(z) + mx)
            onehot = (choices == act[k:k + 1].to(torch.int32)).to(torch.float32)
            logp = logp + (onehot * logp_all).sum(dim=0, keepdim=True)
            # probs is exactly 0 on padding, so 0 * finite adds nothing.
            ent_k = -(probs * logp_all).sum(dim=0, keepdim=True)
            ent_i = ent_i + ent_k
            dims.append((probs, logp_all, onehot, ent_k))
        out["dims"] = dims
    else:
        var = torch.exp(2.0 * ls)  # [aw, 1]
        diff = act - mean
        contrib = -0.5 * diff * diff / var - ls - 0.5 * _LOG_2PI
        logp = (mask * contrib).sum(dim=0, keepdim=True)
        ent_i = (mask * (ls + _ENT_C)).sum(dim=0, keepdim=True)
        out.update(var=var, diff=diff)
    ratio = torch.exp(logp - logp_old)
    rclip = torch.clamp(ratio, 1.0 - spec.clip_eps, 1.0 + spec.clip_eps)
    t1 = ratio * adv_n
    t2 = rclip * adv_n
    out.update(ratio=ratio, t1=t1, t2=t2, pg_i=torch.minimum(t1, t2),
               vf_i=0.5 * (value - ret) ** 2, ent_i=ent_i)
    return out


def backward_plain(spec, params, obs, adv_n, ret, mask, fwd):
    """Hand-derived gradient of ``-mean(pg_i) + vf_coef * mean(vf_i) -
    ent_coef * mean(ent_i)`` with respect to every parameter: ``min`` passes
    its gradient to ``t1`` on a tie, the clip on the closed interval."""
    W1, b1, W2, b2, Wm, bm, ls, Wv, bv, Wv2, bv2 = params
    h1, h2, hv, value = fwd["h1"], fwd["h2"], fwd["hv"], fwd["value"]
    ratio = fwd["ratio"]
    inv_mb = 1.0 / spec.norm

    sel = (fwd["t1"] <= fwd["t2"]).to(torch.float32)
    inside = (
        (ratio >= 1.0 - spec.clip_eps) & (ratio <= 1.0 + spec.clip_eps)
    ).to(torch.float32)
    dratio = -inv_mb * adv_n * (sel + (1.0 - sel) * inside)
    dlogp = dratio * ratio  # [1, n]

    if spec.discrete:
        # Per dim k: d logp / d logits_k = onehot_k - p_k, and the entropy
        # term gives +ent_coef / mb * p_k * (logp_all_k + H_k) with the
        # dim's own entropy H_k.
        dmean = torch.cat(
            [
                dlogp * (onehot - probs)
                + (spec.ent_coef * inv_mb) * probs * (logp_all + ent_k)
                for probs, logp_all, onehot, ent_k in fwd["dims"]
            ],
            dim=0,
        )
        dls = torch.zeros_like(ls)
    else:
        var, diff = fwd["var"], fwd["diff"]
        dmean = dlogp * mask * diff / var
        dls = (
            (dlogp * mask * (diff * diff / var - 1.0)).sum(dim=1, keepdim=True)
            - spec.ent_coef * inv_mb * mask.sum(dim=1, keepdim=True)
        )
    dvalue = spec.vf_coef * inv_mb * (value - ret)  # [1, n]

    dh2 = Wm @ dmean  # [H, n]
    dWm = h2 @ dmean.t()
    dbm = dmean.sum(dim=1, keepdim=True)
    dz2 = dh2 * (1.0 - h2 * h2)
    dW2 = _bf16(h1) @ _bf16(dz2).t()
    db2 = dz2.sum(dim=1, keepdim=True)
    dh1 = _bf16(W2) @ _bf16(dz2)
    dz1 = dh1 * (1.0 - h1 * h1)
    dW1 = _bf16(obs) @ _bf16(dz1).t()
    db1 = dz1.sum(dim=1, keepdim=True)
    dhv = Wv2 @ dvalue
    dzv = dhv * (1.0 - hv * hv)
    dWv = _bf16(obs) @ _bf16(dzv).t()
    dbv = dzv.sum(dim=1, keepdim=True)
    dWv2 = hv @ dvalue.t()
    dbv2 = dvalue.sum(dim=1, keepdim=True)
    return (dW1, db1, dW2, db2, dWm, dbm, dls, dWv, dbv, dWv2, dbv2)


def gather_minibatch(spec: PPOUpdateSpec, packed_fm: Tensor,
                     perm_mb: Tensor) -> Tensor:
    """The minibatch's columns ``[D, mb]``: blocks ``perm_mb`` of ``lb``
    samples each, in order."""
    blocks = packed_fm.reshape(spec.d, -1, spec.lb)
    return blocks[:, perm_mb.long()].reshape(spec.d, -1)


@torch.no_grad()
def minibatch_update_plain(spec: PPOUpdateSpec, packed_fm: Tensor,
                           perm_mb: Tensor, adv_stats: Tensor,
                           params: Tuple[Tensor, ...]):
    """The plain PyTorch version of the kernel: ``(grads, (pg_sum, vf_sum,
    ent_sum))`` for the minibatch made of blocks ``perm_mb``."""
    x = gather_minibatch(spec, packed_fm, perm_mb)
    obs, act, logp_old, adv_n, ret, mask = _fields(spec, x, adv_stats)
    fwd = forward_plain(spec, params, obs, act, logp_old, adv_n, ret, mask)
    grads = backward_plain(spec, params, obs, adv_n, ret, mask, fwd)
    return grads, (fwd["pg_i"].sum(), fwd["vf_i"].sum(), fwd["ent_i"].sum())


# --------------------------------------------------------------------- #
# The kernel
# --------------------------------------------------------------------- #
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


class _PPODims(ctypes.Structure):
    """``PPODims`` of csrc/ppo_update.cu, field for field."""

    _fields_ = [("n", _I), ("mb", _I), ("lb", _I), ("inv_norm", _F),
                ("clip_lo", _F), ("clip_hi", _F), ("vf_scale", _F),
                ("ent_scale", _F)]


class _PPOParams(ctypes.Structure):
    """``PPOParams`` of csrc/ppo_update.cu."""

    _fields_ = [("p", _P * 11)]


def _up4(x: int) -> int:
    return (x + 3) // 4 * 4


def flat_size(spec: PPOUpdateSpec) -> int:
    """Length of the kernel's flat output: the 11 gradients and 3 sums."""
    return sum(a * b for a, b in param_shapes(spec)) + 3


def _up16(x: int) -> int:
    return (x + 15) // 16 * 16


def smem_bytes(spec: PPOUpdateSpec, tile: int, global_sums: bool,
               global_weights: bool = False, global_tiles: bool = False,
               cluster: int = 1) -> int:
    """Shared memory of one block with ``tile`` samples a tile (the layout
    of csrc/ppo_update.cu): the trunk weights as bf16 rows of ``up16(hidden)
    + 8`` unless ``global_weights``, the heads' weights and biases (the
    hidden-size ones unless ``global_tiles``), the gradient sums unless
    ``global_sums``, two raw tiles of ``max(D, up16(obs_d))`` rows of
    ``tile + 8``, three activation tiles ``[tile][up16(hidden) + 8]``
    unless ``global_tiles``, and the head's rows at a stride of ``tile +
    4``.  With ``cluster`` blocks (``cluster_smem_bytes``) the block's
    slices instead."""
    if cluster > 1:
        return cluster_smem_bytes(spec, tile, cluster)
    od, aw, H, hw = spec.obs_d, spec.act_w, spec.hidden, spec.mask_w
    hp, odp = _up16(H), _up16(od)
    weights = 0 if global_weights else 2 * (2 * odp + hp) * (hp + 8)
    floats = _up4(H * hw) + 4 * hp + 2 * _up4(hw) + 4
    if not global_sums:
        floats += _up4(flat_size(spec))
    floats += 2 * max(spec.d, odp) * (tile + 8) + 3 * tile * (hp + 8)
    floats += (tile + 4) * (hw + 4 + (0 if spec.discrete else aw))
    if global_tiles:
        floats -= vector_floats(spec) + 3 * tile * (hp + 8)
    return weights + 4 * floats


def cluster_units(spec: PPOUpdateSpec, cluster: int = CLUSTER) -> int:
    """Hidden units a block of the cluster owns: ``up16(ceil(hidden /
    cluster))``."""
    return _up16(-(-spec.hidden // cluster))


def cluster_smem_bytes(spec: PPOUpdateSpec, tile: int,
                       cluster: int = CLUSTER) -> int:
    """Shared memory of one block of the cluster layout, block r owning
    ``hs = cluster_units(spec)`` hidden units of ``hc = cluster * hs``: as
    bf16 its columns of W1 and Wv (``[up16(obs_d)][hs + 8]``) and W2
    (``[hc][hs + 8]``), its rows of W2 (``[hs][hc + 8]``), the cluster's h1
    and dz2 (``[tile][hc + 8]`` each); as fp32 its slices of Wm, Wv2 and the
    three trunk biases, the head's bm, log_std and bv2, its gradient sums
    but dW2, two raw tiles, three activation slices ``[tile][hs + 8]``, the
    rank-ordered partial sums of mean and value ``[cluster][hw + 1][tile]``
    and the head's rows."""
    od, aw, hw = spec.obs_d, spec.act_w, spec.mask_w
    hs, odp = cluster_units(spec, cluster), _up16(od)
    hc = cluster * hs
    bf16 = (2 * odp + hc) * (hs + 8) + (hs + 2 * tile) * (hc + 8)
    sums = 2 * od * hs + 3 * hs + hs * hw + hs + 2 * hw + 1 + 3
    floats = _up4(hs * hw) + 4 * hs + 2 * _up4(hw) + 4 + _up4(sums)
    floats += 2 * max(spec.d, odp) * (tile + 8) + 3 * tile * (hs + 8)
    floats += cluster * (hw + 1) * tile
    floats += (tile + 4) * (hw + 4 + (0 if spec.discrete else aw))
    return 2 * bf16 + 4 * floats


def vector_floats(spec: PPOUpdateSpec) -> int:
    """Floats of the hidden-size vectors (Wm, Wv2 and the trunk's three
    biases) as csrc/ppo_update.cu lays them out."""
    return _up4(spec.hidden * spec.mask_w) + 4 * _up16(spec.hidden)


def scratch_floats(spec: PPOUpdateSpec, tile: int,
                   global_tiles: bool) -> int:
    """Floats of one block's slice of the device-memory scratch: the
    hidden-size vectors and three activation tiles with ``global_tiles``,
    else none."""
    if not global_tiles:
        return 0
    return vector_floats(spec) + 3 * tile * (_up16(spec.hidden) + 8)


def cluster_fits(spec: PPOUpdateSpec, tile: int) -> bool:
    """Whether the cluster layout takes ``spec`` at ``tile``: its block's
    shared memory fits, two warps of lanes span a block's units, and the
    running sums of its 8 sample groups (``hw + 4`` a unit) fit where the
    trunk's weights, h1 and dz2 were."""
    hs = cluster_units(spec)
    hc = CLUSTER * hs
    trunk_floats = (hc * (hs + 8) + (hs + 2 * tile) * (hc + 8)) // 2
    return (cluster_smem_bytes(spec, tile) <= MAX_SMEM_BYTES
            and 32 < hs <= 64
            and 8 * hs * (spec.mask_w + 4) <= trunk_floats)


# (global_sums, global_weights, global_tiles) in the order they are tried.
_PLACEMENTS = ((False, False, False), (True, False, False),
               (True, True, False), (True, True, True))


def layout(spec: PPOUpdateSpec):
    """``(tile, global_sums, global_weights, global_tiles, cluster)`` the
    kernel is compiled with for ``spec``: one block a tile (``cluster`` 1)
    with everything in shared memory and the largest tile of ``TILES`` that
    fits (64 samples up to hidden 112, 32 to 144, 16 to 160); else, while
    the bf16 trunk weights and one block's sums-free tiles of 16 samples
    would fit a block (to hidden 256), a cluster of ``CLUSTER`` blocks
    sharing each tile, each with its quarter of the hidden units, sums on
    chip, at the largest tile that fits (64 at hidden 256); else the
    gradient sums and the trunk weights in device memory, the weights read
    from there (to hidden 1,040 at obs_d 15, where three fp32 activation
    tiles of 16 samples still fit a block); else the activation tiles and
    hidden-size vectors too, in a scratch in device memory, any hidden
    size.  Only packed rows too many for two raw tiles of 16 samples are
    refused."""
    for placement in _PLACEMENTS:
        for tile in TILES:
            if smem_bytes(spec, tile, *placement) > MAX_SMEM_BYTES:
                continue
            if placement == (True, False, False):
                for ctile in TILES:
                    if cluster_fits(spec, ctile):
                        return (ctile, False, False, False, CLUSTER)
            return (tile,) + placement + (1,)
    raise ValueError(f"the PPO update kernel does not take {spec}: two raw"
                     f" tiles of {spec.d} packed rows and 16 samples exceed"
                     " a block's shared memory; use fused_update=False for"
                     " the autograd update")


def tile_size(spec: PPOUpdateSpec) -> int:
    """Samples per tile the kernel is compiled with for ``spec``."""
    return layout(spec)[0]


def blocks_per_sm(spec: PPOUpdateSpec) -> int:
    """Blocks of the kernel that share an SM's shared memory (one in the
    cluster layout)."""
    per_block = smem_bytes(spec, *layout(spec)) + 1024
    return max(1, min(MAX_BLOCKS_PER_SM, SM_SMEM_BYTES // per_block))


def update_supported(spec: PPOUpdateSpec) -> bool:
    """Whether the kernel takes this spec: any hidden size, with packed
    rows few enough for two raw tiles of 16 samples in a block's shared
    memory (up to about 1,200)."""
    try:
        layout(spec)
    except ValueError:
        return False
    return True


def require_supported(spec: PPOUpdateSpec) -> None:
    layout(spec)


def defines(spec: PPOUpdateSpec):
    tile, global_sums, global_weights, global_tiles, cluster = layout(spec)
    return (f"PPO_OD={spec.obs_d}", f"PPO_AW={spec.act_w}",
            f"PPO_H={spec.hidden}", f"PPO_NL={spec.n_logits}",
            f"PPO_T={tile}", f"PPO_GG={int(global_sums)}",
            f"PPO_WG={int(global_weights)}", f"PPO_XG={int(global_tiles)}",
            f"PPO_CL={cluster}")


def build(spec: PPOUpdateSpec) -> str:
    """Compile the kernel library for ``spec``'s shape if needed; returns
    its path; raises for a spec the kernel does not take.  Built with contracted multiply-adds: the kernel is held to a
    tolerance, not to the plain version's bits."""
    require_supported(spec)
    return cuda_build.build(SOURCE, defines(spec), fmad=True)


def ppo_dims(spec: PPOUpdateSpec, n: int) -> _PPODims:
    """The kernel's ``PPODims`` for ``spec`` and a packed rollout of ``n``
    columns."""
    inv = 1.0 / spec.norm
    return _PPODims(n, spec.mb, spec.lb, inv, 1.0 - spec.clip_eps,
                    1.0 + spec.clip_eps, spec.vf_coef * inv,
                    spec.ent_coef * inv)


class _Launcher(NamedTuple):
    fn: object
    dims: _PPODims
    flat: int
    scratch: int  # floats of a block's slice of the scratch
    layout: tuple
    max_rows: int  # rows of partial the card runs at once (blocks, clusters)


_launchers = {}


def _launcher(spec: PPOUpdateSpec, n: int, dev) -> _Launcher:
    """``vmt_ppo_update`` for ``spec``'s shape, built and bound at the first
    launch, with the ``PPODims`` of ``(spec, n)`` filled once and the most
    rows of the partial buffer that run at once on ``dev``: blocks, or
    clusters in the cluster layout."""
    key = (spec, n, dev)
    if key not in _launchers:
        lib = ctypes.CDLL(build(spec))
        tile, *placement = layout(spec)
        scratch = scratch_floats(spec, tile, placement[2])
        if (lib.vmt_ppo_p() != flat_size(spec)
                or lib.vmt_ppo_smem_bytes() != smem_bytes(spec, tile,
                                                          *placement)
                or lib.vmt_ppo_scratch_floats() != scratch):
            raise RuntimeError(
                "csrc/ppo_update.cu and ops/ppo_update_cuda.py disagree on"
                " the kernel's layout"
            )
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        if placement[3] > 1:
            with torch.cuda.device(dev):
                max_rows = lib.vmt_ppo_max_clusters()
            if max_rows <= 0:
                raise RuntimeError(
                    f"the PPO update kernel's {placement[3]}-block clusters do"
                    f" not fit {torch.cuda.get_device_name(dev)}")
        else:
            max_rows = blocks_per_sm(spec) * sms
        fn = lib.vmt_ppo_update
        fn.argtypes = [_P] * 7 + [_I, _P]
        fn.restype = _I
        _launchers[key] = _Launcher(fn, ppo_dims(spec, n), flat_size(spec),
                                    scratch, (tile, *placement), max_rows)
    return _launchers[key]


def partial_floats(grid: int, flat: int, scratch: int) -> int:
    """Floats of the buffer the kernel's blocks write: ``grid`` rows of
    ``flat`` gradient sums, then (from a multiple of 4) ``grid`` slices of
    ``scratch``."""
    return _up4(grid * flat) + grid * scratch


def split_flat(spec: PPOUpdateSpec, flat: Tensor):
    """The kernel's flat output as ``(grads, sums)``: views, no copies."""
    grads, at = [], 0
    for shape in param_shapes(spec):
        size = shape[0] * shape[1]
        grads.append(flat[at:at + size].view(shape))
        at += size
    return tuple(grads), (flat[at], flat[at + 1], flat[at + 2])


def launch(spec: PPOUpdateSpec, packed_fm: Tensor, perm_mb: Tensor,
           adv_stats: Tensor, params: Tuple[Tensor, ...]):
    """Launch the kernel on PyTorch's current stream; returns ``(grads,
    sums)`` as views of one flat tensor allocated here."""
    global LAUNCHES
    dev = packed_fm.device
    if dev.type != "cuda":
        raise ValueError(f"the kernel runs on CUDA tensors, got {dev}")
    n = packed_fm.shape[-1]
    nb = spec.mb // spec.lb
    if spec.mb % spec.lb or n % spec.lb:
        raise ValueError(f"lb={spec.lb} does not divide mb={spec.mb}, n={n}")
    checks = [("packed_fm", packed_fm, (spec.d, n), torch.float32),
              ("perm_mb", perm_mb, (nb,), torch.int32),
              ("adv_stats", adv_stats, (2,), torch.float32)]
    names = ("W1", "b1", "W2", "b2", "Wm", "bm", "log_std", "Wv", "bv",
             "Wv2", "bv2")
    if len(params) != 11:
        raise ValueError(f"expected 11 parameters, got {len(params)}")
    checks += [(nm, p, shape, torch.float32)
               for nm, p, shape in zip(names, params, param_shapes(spec))]
    for name, x, shape, dtype in checks:
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, expected {dev}")
        if x.dtype != dtype:
            raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(
                f"{name} has shape {tuple(x.shape)}, expected {shape}"
            )
        if not x.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    launcher = _launcher(spec, n, dev)
    grid = min(-(-spec.mb // launcher.layout[0]), launcher.max_rows)
    partial = torch.empty(
        (partial_floats(grid, launcher.flat, launcher.scratch),),
        dtype=torch.float32, device=dev)
    flat = torch.empty((launcher.flat,), dtype=torch.float32, device=dev)
    pointers = _PPOParams((_P * 11)(*(p.data_ptr() for p in params)))
    err = launcher.fn(
        packed_fm.data_ptr(), perm_mb.data_ptr(), adv_stats.data_ptr(),
        ctypes.addressof(pointers), partial.data_ptr(), flat.data_ptr(),
        ctypes.addressof(launcher.dims), grid,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"PPO update kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    LAUNCHES_BY_LAYOUT[launcher.layout] = (
        LAUNCHES_BY_LAYOUT.get(launcher.layout, 0) + 1)
    return split_flat(spec, flat)


def minibatch_update(spec: PPOUpdateSpec, packed_fm: Tensor, perm_mb: Tensor,
                     adv_stats: Tensor, params: Tuple[Tensor, ...]):
    """Gradients and loss sums of one PPO minibatch: ``(grads, (pg_sum,
    vf_sum, ent_sum))`` with ``grads`` shaped like ``params`` and per-sample
    terms scaled by ``1 / spec.norm``; the caller forms ``loss = -pg / norm
    + vf_coef * vf / norm - ent_coef * ent / norm``.

    ``packed_fm`` is the feature-major packed rollout ``[D, n]`` float32
    (rows as in :func:`pack_rows`), ``perm_mb`` the ``mb // lb`` int32 block
    indices of this minibatch, ``adv_stats`` its advantage ``(mean, 1 / (std
    + 1e-8))``.  The kernel on CUDA tensors, the plain version on CPU
    tensors."""
    devices = {x.device.type for x in (packed_fm, perm_mb, adv_stats, *params)}
    if devices == {"cuda"}:
        return launch(spec, packed_fm, perm_mb, adv_stats, params)
    if devices == {"cpu"}:
        return minibatch_update_plain(spec, packed_fm, perm_mb, adv_stats,
                                      params)
    raise ValueError(f"inputs on mixed devices: {devices}")
