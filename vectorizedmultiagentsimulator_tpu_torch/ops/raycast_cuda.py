"""The LIDAR ray cast as a hand-written CUDA kernel (``csrc/raycast.cu``).

Replaces the JAX package's Pallas kernel
(``ops/raycast_pallas.py::_kernel``).  This module holds:

* ``CastTable`` and ``cast_table``: the cast entities' indices and shape
  parameters, as device tensors for the plain version and as the kernel's
  ``CastTable`` struct for each tuple of origins (``kernel_table``), built
  once per table by ``World``;
* ``cast_rays_plain``: the plain PyTorch version, the counterpart of the
  JAX package's ``raycast_pallas._jnp_reference``;
* ``fused_cast_rays``: the wrapper.  On CUDA tensors it launches the kernel
  or raises; on CPU tensors it runs ``cast_rays_plain``.  Where a gradient
  is wanted it is a ``torch.autograd.Function`` whose backward re-runs
  ``cast_rays_plain`` under autograd, as the JAX package's ``custom_vjp``
  re-runs its jnp reference;
* ``LAUNCHES``: the number of kernel launches, counted where the kernel is
  launched and nowhere else.

Every function takes the world state as it is (``pos [B, N, 2]``, ``rot
[B, N, 1]``), ``origins``: one entity index, or a tuple of them (the
LIDARs that ``World`` casts together), each of which skips itself among
the table's entities, and ``angles``: ``[R]`` angles relative to each
origin's heading (a LIDAR's base angles), or, for one origin, ``[B, R]``
world-frame angles.  One origin gives ``[B, R]`` distances, a tuple ``[O,
B, R]``.  The kernel is built at first use by :mod:`.cuda_build`.
"""
from __future__ import annotations

import ctypes
import os
from typing import NamedTuple, Sequence, Tuple, Union

import numpy as np
import torch

from vectorizedmultiagentsimulator_tpu_torch.ops import cuda_build
from vectorizedmultiagentsimulator_tpu_torch.ops import raycast as rc

LAUNCHES = 0

SOURCE = os.path.join(cuda_build.CSRC, "raycast.cu")

Tensor = torch.Tensor
Origins = Union[int, Tuple[int, ...]]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# CastTable's capacities (csrc/raycast.cu): cast entities, origins a
# launch, and staged poses (cast entities and origins).
MAX_CAST, MAX_ORIGINS, MAX_NEED = 128, 64, 192


class _CastTable(ctypes.Structure):
    """``CastTable`` of csrc/raycast.cu, field for field."""

    _fields_ = [(n, _I) for n in ("n_sphere", "n_box", "n_line", "n_origin",
                                  "n_need")] + [
        ("need", _I * MAX_NEED), ("cast", _I * MAX_CAST),
        ("size0", _F * MAX_CAST), ("size1", _F * MAX_CAST),
        ("origin", _I * MAX_ORIGINS),
    ]


class CastTable(NamedTuple):
    """The entities a cast tests, by shape class: int64 entity indices and
    float32 shape parameters on the world's device (the plain version's
    operands); the same on the host (``entities``: sphere, box and line
    indices; ``sizes``: radius, length and width per class); and ``cache``,
    which holds the kernel's struct for each tuple of origins and the
    plain version's table without each origin."""

    sphere_idx: Tensor
    sphere_radius: Tensor
    box_idx: Tensor
    box_length: Tensor
    box_width: Tensor
    line_idx: Tensor
    line_length: Tensor
    entities: Tuple[tuple, tuple, tuple]
    sizes: Tuple[tuple, tuple, tuple, tuple]
    cache: dict

    @property
    def tensors(self):
        """The seven device tensors."""
        return self[:7]


def cast_table(world, spheres: Sequence[int], boxes: Sequence[int],
               lines: Sequence[int]) -> CastTable:
    """A ``CastTable`` for the given entity indices of ``world``, copied to
    its device once."""
    s, b, l = (np.asarray(x, dtype=np.int64).reshape(-1)
               for x in (spheres, boxes, lines))
    sizes = (world._radius[s], world._length[b], world._width[b],
             world._length[l])
    return _table(world.device, s, b, l, sizes)


def _table(device, s, b, l, sizes) -> CastTable:
    def on_dev(x, dtype):
        return torch.as_tensor(np.asarray(x, dtype=dtype), device=device)

    radius, b_len, b_wid, l_len = (np.asarray(x, dtype=np.float32)
                                   for x in sizes)
    return CastTable(
        on_dev(s, np.int64), on_dev(radius, np.float32), on_dev(b, np.int64),
        on_dev(b_len, np.float32), on_dev(b_wid, np.float32),
        on_dev(l, np.int64), on_dev(l_len, np.float32),
        tuple(tuple(int(i) for i in x) for x in (s, b, l)),
        tuple(tuple(float(v) for v in x)
              for x in (radius, b_len, b_wid, l_len)),
        {},
    )


def _without(table: CastTable, origin: int) -> CastTable:
    """``table`` with entity ``origin`` taken out (cached): the table the
    plain version casts an origin's rays against."""
    key = ("without", origin)
    sub = table.cache.get(key)
    if sub is None:
        (s, b, l), (radius, b_len, b_wid, l_len) = table.entities, table.sizes
        keep = [[i for i, e in enumerate(x) if e != origin] for x in (s, b, l)]
        if all(len(k) == len(x) for k, x in zip(keep, (s, b, l))):
            sub = table
        else:
            def pick(x, k):
                return np.asarray(x)[k] if len(k) else np.zeros(0)

            ks, kb, kl = keep
            sub = _table(table.sphere_idx.device, pick(s, ks), pick(b, kb),
                         pick(l, kl), (pick(radius, ks), pick(b_len, kb),
                                       pick(b_wid, kb), pick(l_len, kl)))
        table.cache[key] = sub
    return sub


def kernel_table(table: CastTable, origins: Tuple[int, ...]) -> _CastTable:
    """The kernel's ``CastTable`` struct for ``table`` and ``origins``
    (cached): the poses to stage (the cast entities, then the origins not
    among them), each cast entity's and each origin's slot among them, and
    the shape sizes."""
    key = ("kernel", origins)
    struct = table.cache.get(key)
    if struct is None:
        s, b, l = table.entities
        cast = s + b + l
        need = list(dict.fromkeys(cast + origins))
        if (len(cast) > MAX_CAST or len(origins) > MAX_ORIGINS
                or len(need) > MAX_NEED):
            raise ValueError(
                f"the ray-cast kernel takes at most {MAX_CAST} cast entities"
                f" and {MAX_ORIGINS} origins a launch, got {len(cast)} and"
                f" {len(origins)}")
        radius, b_len, b_wid, l_len = table.sizes
        slot = {e: i for i, e in enumerate(need)}
        struct = _CastTable(len(s), len(b), len(l), len(origins), len(need))
        struct.need[:len(need)] = need
        struct.cast[:len(cast)] = [slot[e] for e in cast]
        struct.size0[:len(cast)] = radius + b_len + l_len
        struct.size1[:len(cast)] = (0.0,) * len(s) + b_wid + (0.0,) * len(l)
        struct.origin[:len(origins)] = [slot[o] for o in origins]
        table.cache[key] = struct
    return struct


def _world_angles(rot: Tensor, angles: Tensor, origin: int) -> Tensor:
    """``[B, R]`` world-frame angles: ``[R]`` base angles plus the origin
    entity's heading (one fp32 add, as the kernel does), or ``angles``."""
    if angles.ndim == 1:
        return angles[None, :] + rot[:, origin]
    return angles


def _cast_one(pos, rot, angles, origin, table, max_range):
    """The plain cast from one origin over ``table`` (not containing it)."""
    ang = _world_angles(rot, angles, origin)
    o = pos[:, origin]
    dists = [torch.full_like(ang, max_range)]
    if len(table.sphere_idx):
        d = rc.cast_rays_to_sphere(
            pos[:, table.sphere_idx], table.sphere_radius, o, ang, max_range
        )
        dists.append(torch.amin(d, dim=1))
    if len(table.box_idx):
        d = rc.cast_rays_to_box(
            pos[:, table.box_idx], rot[:, table.box_idx, 0], table.box_length,
            table.box_width, o, ang, max_range,
        )
        dists.append(torch.amin(d, dim=1))
    if len(table.line_idx):
        d = rc.cast_rays_to_line(
            pos[:, table.line_idx], rot[:, table.line_idx, 0],
            table.line_length, o, ang, max_range,
        )
        dists.append(torch.amin(d, dim=1))
    return torch.amin(torch.stack(dists), dim=0)


def cast_rays_plain(pos: Tensor, rot: Tensor, angles: Tensor,
                    origins: Origins, table: CastTable,
                    max_range: float) -> Tensor:
    """The plain PyTorch version of the kernel: for each origin, the
    minimum hit distance over the table's spheres, boxes and lines other
    than the origin itself, capped at ``max_range``; ``[B, R]`` for one
    origin, ``[O, B, R]`` for a tuple."""
    if isinstance(origins, int):
        return _cast_one(pos, rot, angles, origins,
                         _without(table, origins), max_range)
    return torch.stack([_cast_one(pos, rot, angles, o, _without(table, o),
                                  max_range) for o in origins])


def build() -> str:
    """Compile the kernel library if needed; returns its path."""
    return cuda_build.build(SOURCE)


_fn = None


def _library():
    """``vmt_cast_rays``, built and bound at the first launch."""
    global _fn
    if _fn is None:
        _fn = cuda_build.entry_point(
            SOURCE, "vmt_cast_rays", [_P] * 5 + [_I] * 4 + [_F, _P]
        )
    return _fn


# The operand layouts checked so far: (origins, and each operand's shape,
# strides, dtype and device).  A layout is checked once.
_CHECKED = set()


def _check(pos: Tensor, rot: Tensor, angles: Tensor,
           origins: Tuple[int, ...]):
    key = (origins,) + tuple((x.shape, x.stride(), x.dtype, x.device)
                             for x in (pos, rot, angles))
    if key in _CHECKED:
        return
    dev = pos.device
    if dev.type != "cuda":
        raise ValueError(f"the kernel runs on CUDA tensors, got {dev}")
    B, N = pos.shape[0], pos.shape[1]
    for o in origins:
        if not 0 <= o < N:
            raise ValueError(f"origin entity {o} is not in [0, {N})")
    if angles.ndim not in (1, 2) or (angles.ndim == 2 and (
            angles.shape[0] != B or len(origins) != 1)):
        raise ValueError(
            f"angles has shape {tuple(angles.shape)}, expected [R], or"
            f" [{B}, R] for one origin"
        )
    for name, x, shape in (("pos", pos, (B, N, 2)), ("rot", rot, (B, N, 1)),
                           ("angles", angles, tuple(angles.shape))):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, expected {dev}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} has dtype {x.dtype}, expected float32")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    _CHECKED.add(key)


def launch(pos: Tensor, rot: Tensor, angles: Tensor, origins: Origins,
           table: CastTable, max_range: float) -> Tensor:
    """Launch the kernel on PyTorch's current stream; returns the distances
    (``[B, R]`` for one origin, ``[O, B, R]`` for a tuple), allocated
    here."""
    global LAUNCHES
    many = not isinstance(origins, int)
    origins = tuple(origins) if many else (origins,)
    _check(pos, rot, angles, origins)
    struct = kernel_table(table, origins)
    B, N, R = pos.shape[0], pos.shape[1], angles.shape[-1]
    out = torch.empty((len(origins), B, R), dtype=torch.float32,
                      device=pos.device)
    err = _library()(
        pos.data_ptr(), rot.data_ptr(), angles.data_ptr(), out.data_ptr(),
        ctypes.addressof(struct), B, N, R, R if angles.ndim == 2 else 0,
        max_range, torch.cuda.current_stream(pos.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"ray-cast kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out if many else out[0]


def _forward(pos, rot, angles, origins, table, max_range):
    devices = {x.device.type for x in (pos, rot, angles, table.sphere_idx)}
    if devices == {"cuda"}:
        return launch(pos, rot, angles, origins, table, max_range)
    if devices == {"cpu"}:
        return cast_rays_plain(pos, rot, angles, origins, table, max_range)
    raise ValueError(f"inputs on mixed devices: {devices}")


class _FusedCast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pos, rot, angles, origins, table, max_range):
        ctx.save_for_backward(pos, rot, angles)
        ctx.cast = (origins, table, max_range)
        return _forward(pos, rot, angles, origins, table, max_range)

    @staticmethod
    def backward(ctx, grad):
        inputs = [
            x.detach().requires_grad_(need)
            for x, need in zip(ctx.saved_tensors, ctx.needs_input_grad[:3])
        ]
        wrt = [x for x in inputs if x.requires_grad]
        with torch.enable_grad():
            out = cast_rays_plain(*inputs, *ctx.cast)
        got = iter(
            torch.autograd.grad(out, wrt, grad, allow_unused=True)
            if out.requires_grad else [None] * len(wrt)
        )
        return tuple(next(got) if x.requires_grad else None
                     for x in inputs) + (None, None, None)


def fused_cast_rays(pos: Tensor, rot: Tensor, angles: Tensor,
                    origins: Origins, table: CastTable,
                    max_range: float) -> Tensor:
    """The cast from one origin (``[B, R]``) or from each of a tuple of
    origins (``[O, B, R]``, one launch): the kernel on CUDA tensors,
    ``cast_rays_plain`` on CPU tensors; differentiable through
    ``cast_rays_plain``."""
    if torch.is_grad_enabled() and (pos.requires_grad or rot.requires_grad
                                    or angles.requires_grad):
        return _FusedCast.apply(pos, rot, angles, origins, table, max_range)
    return _forward(pos, rot, angles, origins, table, max_range)
