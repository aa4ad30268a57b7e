"""Vectorized LIDAR ray casts, plain PyTorch.

PyTorch counterpart of ``vectorizedmultiagentsimulator_tpu/ops/raycast.py``
(reference ``vmas/simulator/core.py:1281-1372`` boxes, ``:1414-1490``
spheres, ``:1544-1626`` lines).  Each function evaluates
``[B, n_entities, n_rays]`` densely; misses give ``max_range`` through
``where`` masks.  They are the plain version of the ray-cast kernel
(``ops/raycast_cuda.py``), its backward, and its reference.

Inputs:
  origin         [B, 2]            ray start (the sensing agent's position)
  angles         [B, R]            world-frame ray angles
  entity arrays  [B, E] / [B, E, 2] stacked per-shape state
Returns distances ``[B, E, R]``.
"""
from __future__ import annotations

import torch

from vectorizedmultiagentsimulator_tpu_torch.ops.geometry import (
    closest_point_line,
)
from vectorizedmultiagentsimulator_tpu_torch.utils import TorchUtils, X, Y

Tensor = torch.Tensor


def _direction(angle: Tensor) -> Tensor:
    return torch.stack([torch.cos(angle), torch.sin(angle)], dim=-1)


def cast_rays_to_box(
    box_pos: Tensor,     # [B, E, 2]
    box_rot: Tensor,     # [B, E]
    box_length: Tensor,  # [B, E] or [E]
    box_width: Tensor,   # [B, E] or [E]
    origin: Tensor,      # [B, 2]
    angles: Tensor,      # [B, R]
    max_range: float,
) -> Tensor:
    """Slab-method ray/oriented-box intersection (core.py:1281-1372)."""
    o = origin[:, None, None, :]
    bp = box_pos[:, :, None, :]
    br = box_rot[:, :, None]
    bl = box_length.to(box_pos.dtype).expand(box_rot.shape)[:, :, None]
    bw = box_width.to(box_pos.dtype).expand(box_rot.shape)[:, :, None]
    ang = angles[:, None, :]

    pos_origin = o - bp
    pos_aabb = TorchUtils.rotate_vector(pos_origin, -br)
    ray_dir_aabb = TorchUtils.rotate_vector(_direction(ang), -br)

    def slab(half, p, d):
        """Guarded slab interval: a ray parallel to the slab (d == 0, which
        every axis-aligned LIDAR ray is) would divide by zero.  That is
        right in forward IEEE-inf arithmetic, but the division's backward
        turns the masked-out cotangents into 0 * inf = NaN, so finite
        sentinels stand in for the infinities."""
        parallel = d == 0.0
        safe_d = torch.where(parallel, torch.ones_like(d), d)
        t1 = (-half - p) / safe_d
        t2 = (half - p) / safe_d
        lo = torch.minimum(t1, t2)
        hi = torch.maximum(t1, t2)
        inside = (p >= -half) & (p <= half)
        big = torch.full_like(lo, 1e9)
        lo = torch.where(parallel, torch.where(inside, -big, big), lo)
        hi = torch.where(parallel, torch.where(inside, big, -big), hi)
        return lo, hi

    tx_lo, tx_hi = slab(bl / 2, pos_aabb[..., X], ray_dir_aabb[..., X])
    ty_lo, ty_hi = slab(bw / 2, pos_aabb[..., Y], ray_dir_aabb[..., Y])
    tmin = torch.maximum(tx_lo, ty_lo)
    tmax = torch.minimum(tx_hi, ty_hi)

    intersect_aabb = tmin[..., None] * ray_dir_aabb + pos_aabb
    intersect_world = TorchUtils.rotate_vector(intersect_aabb, br) + bp

    collision = (tmax >= tmin) & (tmin > 0.0)
    dist = TorchUtils.safe_norm(o - intersect_world, dim=-1)
    return torch.where(collision, dist, torch.full_like(dist, max_range))


def cast_rays_to_sphere(
    sphere_pos: Tensor,     # [B, E, 2]
    sphere_radius: Tensor,  # [B, E] or [E]
    origin: Tensor,         # [B, 2]
    angles: Tensor,         # [B, R]
    max_range: float,
) -> Tensor:
    """Ray/circle intersection via closest-point decomposition
    (core.py:1414-1490)."""
    o = origin[:, None, None, :]
    sp = sphere_pos[:, :, None, :]
    sr = sphere_radius.to(sphere_pos.dtype).expand(sphere_pos.shape[:-1])
    sr = sr[:, :, None]
    B, E = sphere_pos.shape[:2]
    R = angles.shape[-1]
    ang = angles[:, None, :].expand(B, E, R)

    ray_dir_world = _direction(ang)
    line_pos = o + ray_dir_world * (max_range / 2)
    closest = closest_point_line(
        line_pos, ang, max_range, sp, limit_to_line_length=False
    )

    d = sp - closest
    d_norm = TorchUtils.safe_norm(d, dim=-1)
    ray_intersects = d_norm < sr
    a = sr**2 - d_norm**2
    m = torch.sqrt(torch.where(a > 0, a, torch.full_like(a, 1e-8)))

    u = sp - o
    u1 = closest - o
    sphere_in_front = torch.sum(u * ray_dir_world, dim=-1) > 0.0
    dist = TorchUtils.safe_norm(u1, dim=-1) - m
    return torch.where(
        ray_intersects & sphere_in_front, dist, torch.full_like(dist, max_range)
    )


def cast_rays_to_line(
    line_pos: Tensor,     # [B, E, 2]
    line_rot: Tensor,     # [B, E]
    line_length: Tensor,  # [B, E] or [E]
    origin: Tensor,       # [B, 2]
    angles: Tensor,       # [B, R]
    max_range: float,
) -> Tensor:
    """Ray/segment intersection (core.py:1544-1626)."""
    o = origin[:, None, None, :]
    lp = line_pos[:, :, None, :]
    lr = line_rot[:, :, None]
    ll = line_length.to(line_pos.dtype).expand(line_rot.shape)[:, :, None]
    ang = angles[:, None, :]

    B, E = line_pos.shape[:2]
    R = angles.shape[-1]
    r = (_direction(lr) * ll[..., None]).expand(B, E, R, 2)
    q = o
    s = _direction(ang).expand(B, E, R, 2)

    rxs = TorchUtils.cross(r, s)
    # Guarded division: rays parallel to the segment (rxs == 0) would give
    # inf/NaN, masked out of the result below, but the division's backward
    # would then form 0 * inf = NaN cotangents.
    parallel = rxs == 0.0
    safe_rxs = torch.where(parallel, torch.ones_like(rxs), rxs)
    t = TorchUtils.cross(q - lp, s / safe_rxs)
    u = TorchUtils.cross(q - lp, r / safe_rxs)
    d = TorchUtils.safe_norm(u * s, dim=-1)

    miss = (
        parallel[..., 0]
        | (t[..., 0] > 0.5)
        | (t[..., 0] < -0.5)
        | (u[..., 0] < 0.0)
    )
    return torch.where(miss, torch.full_like(d, max_range), d)
