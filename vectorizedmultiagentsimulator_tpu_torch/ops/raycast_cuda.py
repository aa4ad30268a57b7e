"""The LIDAR ray cast as a hand-written CUDA kernel (``csrc/raycast.cu``).

Replaces the JAX package's Pallas kernel
(``ops/raycast_pallas.py::_kernel``).  This module holds:

* ``CastTable`` and ``cast_table``: the cast entities' indices and shape
  parameters as device tensors, built once per (entity, filter) by
  ``World.cast_rays``;
* ``cast_rays_plain``: the plain PyTorch version, the counterpart of the
  JAX package's ``raycast_pallas._jnp_reference``;
* ``fused_cast_rays``: the wrapper.  On CUDA tensors it launches the kernel
  or raises; on CPU tensors it runs ``cast_rays_plain``.  It is a
  ``torch.autograd.Function`` whose backward re-runs ``cast_rays_plain``
  under autograd, as the JAX package's ``custom_vjp`` re-runs its jnp
  reference;
* ``LAUNCHES``: the number of kernel launches, counted where the kernel is
  launched and nowhere else.

Every function takes the world state as it is (``pos [B, N, 2]``, ``rot
[B, N, 1]``), the index of the origin entity, and ``angles``: ``[R]`` angles
relative to the origin entity's heading (a LIDAR's base angles), or ``[B,
R]`` world-frame angles.  The kernel is built at first use by
:mod:`.cuda_build`.
"""
from __future__ import annotations

import ctypes
import os
from typing import NamedTuple, Sequence

import numpy as np
import torch

from vectorizedmultiagentsimulator_tpu_torch.ops import cuda_build
from vectorizedmultiagentsimulator_tpu_torch.ops import raycast as rc

LAUNCHES = 0

SOURCE = os.path.join(cuda_build.CSRC, "raycast.cu")

Tensor = torch.Tensor


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


class _CastTable(ctypes.Structure):
    """``CastTable`` of csrc/raycast.cu, field for field."""

    _fields_ = [(n, _P) for n in (
        "sphere_idx", "sphere_radius", "box_idx", "box_length", "box_width",
        "line_idx", "line_length",
    )] + [("n_sphere", _I), ("n_box", _I), ("n_line", _I)]


class CastTable(NamedTuple):
    """The entities a cast tests, by shape class: int64 entity indices and
    float32 shape parameters, on the world's device; and the kernel's
    ``CastTable`` struct pointing at them, filled once."""

    sphere_idx: Tensor
    sphere_radius: Tensor
    box_idx: Tensor
    box_length: Tensor
    box_width: Tensor
    line_idx: Tensor
    line_length: Tensor
    struct: _CastTable

    @property
    def tensors(self):
        """The seven device tensors, without the struct."""
        return self[:7]


def cast_table(world, spheres: Sequence[int], boxes: Sequence[int],
               lines: Sequence[int]) -> CastTable:
    """A ``CastTable`` for the given entity indices of ``world``, copied to
    its device once."""

    def on_dev(x, dtype):
        return torch.as_tensor(np.asarray(x, dtype=dtype), device=world.device)

    s, b, l = (np.asarray(x, dtype=np.int64) for x in (spheres, boxes, lines))
    tensors = (
        on_dev(s, np.int64), on_dev(world._radius[s], np.float32),
        on_dev(b, np.int64), on_dev(world._length[b], np.float32),
        on_dev(world._width[b], np.float32),
        on_dev(l, np.int64), on_dev(world._length[l], np.float32),
    )
    struct = _CastTable(*(x.data_ptr() for x in tensors), len(s), len(b),
                        len(l))
    return CastTable(*tensors, struct)


def _world_angles(rot: Tensor, angles: Tensor, origin: int) -> Tensor:
    """``[B, R]`` world-frame angles: ``[R]`` base angles plus the origin
    entity's heading (one fp32 add, as the kernel does), or ``angles``."""
    if angles.ndim == 1:
        return angles[None, :] + rot[:, origin]
    return angles


def cast_rays_plain(pos: Tensor, rot: Tensor, angles: Tensor, origin: int,
                    table: CastTable, max_range: float) -> Tensor:
    """The plain PyTorch version of the kernel: the minimum hit distance
    over the table's spheres, boxes and lines, capped at ``max_range``,
    ``[B, R]``."""
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


def build() -> str:
    """Compile the kernel library if needed; returns its path."""
    return cuda_build.build(SOURCE)


_fn = None


def _library():
    """``vmt_cast_rays``, built and bound at the first launch."""
    global _fn
    if _fn is None:
        _fn = cuda_build.entry_point(
            SOURCE, "vmt_cast_rays", [_P] * 5 + [_I] * 5 + [_F, _P]
        )
    return _fn

def launch(pos: Tensor, rot: Tensor, angles: Tensor, origin: int,
           table: CastTable, max_range: float) -> Tensor:
    """Launch the kernel on PyTorch's current stream; returns the distances
    ``[B, R]``, allocated here."""
    global LAUNCHES
    dev = pos.device
    if dev.type != "cuda":
        raise ValueError(f"the kernel runs on CUDA tensors, got {dev}")
    B, N = pos.shape[0], pos.shape[1]
    R = angles.shape[-1]
    if not 0 <= origin < N:
        raise ValueError(f"origin entity {origin} is not in [0, {N})")
    if angles.ndim not in (1, 2) or (angles.ndim == 2 and angles.shape[0] != B):
        raise ValueError(
            f"angles has shape {tuple(angles.shape)}, expected [R] or [{B}, R]"
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
    if table.sphere_idx.device != dev:
        raise ValueError(
            f"cast table is on {table.sphere_idx.device}, state on {dev}"
        )
    out = torch.empty((B, R), dtype=torch.float32, device=dev)
    err = _library()(
        pos.data_ptr(), rot.data_ptr(), angles.data_ptr(), out.data_ptr(),
        ctypes.addressof(table.struct), B, N, R, origin,
        R if angles.ndim == 2 else 0, max_range,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"ray-cast kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


class _FusedCast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pos, rot, angles, origin, table, max_range):
        ctx.save_for_backward(pos, rot, angles)
        ctx.cast = (origin, table, max_range)
        devices = {x.device.type for x in (pos, rot, angles, table.sphere_idx)}
        if devices == {"cuda"}:
            return launch(pos, rot, angles, origin, table, max_range)
        if devices == {"cpu"}:
            return cast_rays_plain(pos, rot, angles, origin, table, max_range)
        raise ValueError(f"inputs on mixed devices: {devices}")

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


def fused_cast_rays(pos: Tensor, rot: Tensor, angles: Tensor, origin: int,
                    table: CastTable, max_range: float) -> Tensor:
    """One LIDAR cast, ``[B, R]``: the kernel on CUDA tensors,
    ``cast_rays_plain`` on CPU tensors; differentiable through
    ``cast_rays_plain``."""
    return _FusedCast.apply(pos, rot, angles, origin, table, max_range)
