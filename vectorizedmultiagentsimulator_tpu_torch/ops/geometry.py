"""Batched closest-point geometry.

PyTorch counterpart of ``vectorizedmultiagentsimulator_tpu/ops/geometry.py``
(reference ``vmas/simulator/physics.py``).  Every function broadcasts over
arbitrary leading batch dims, so one function serves ``[B,2]`` scenario
queries, ``[B,P,2]`` collision pair tables and ``[K,B,P,2]`` candidate
stacks.  Fixed sub-structure (the 4 sides of a box, the 4 endpoint
projections of a segment pair) is a stacked leading axis, reduced with a
first-minimum ``argmin`` as the reference's sequential ``d < best`` fold.

Sizes (``line_length``, ``box_width``...) may be python floats or tensors;
python floats become device scalars through ``torch.full``, never through a
host-to-device copy, so these functions never synchronise with the host.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from vectorizedmultiagentsimulator_tpu_torch.utils import TorchUtils, X, Y

Tensor = torch.Tensor


def _as(x, like: Tensor) -> Tensor:
    if isinstance(x, Tensor):
        return x.to(like.dtype)
    return torch.full((), float(x), dtype=like.dtype, device=like.device)


def _norm(v: Tensor) -> Tensor:
    return TorchUtils.safe_norm(v, dim=-1)


def safe_norm_xy(dx: Tensor, dy: Tensor) -> Tensor:
    """``safe_norm`` of a vector given as separate x/y components."""
    d2 = dx * dx + dy * dy
    is_zero = d2 == 0
    return torch.where(
        is_zero,
        torch.zeros_like(d2),
        torch.sqrt(torch.where(is_zero, torch.ones_like(d2), d2)),
    )


def _min_select(points_a: Tensor, points_b: Tensor) -> Tuple[Tensor, Tensor]:
    """Pick, along the leading candidate axis, the (a, b) point pair with
    the smallest distance; ``argmin`` keeps the first minimum."""
    d = _norm(points_a - points_b)  # [K, ...]
    idx = torch.argmin(d, dim=0)[None, ..., None]
    idx = idx.expand((1,) + points_a.shape[1:])
    pa = torch.gather(points_a, 0, idx)[0]
    pb = torch.gather(points_b, 0, idx)[0]
    return pa, pb


def _direction(rot: Tensor) -> Tensor:
    return torch.stack([torch.cos(rot), torch.sin(rot)], dim=-1)


def closest_point_line(
    line_pos: Tensor,
    line_rot: Tensor,
    line_length,
    test_point_pos: Tensor,
    limit_to_line_length: bool = True,
) -> Tensor:
    """Closest point on a segment (or infinite line) to a test point.
    ``line_rot`` / ``line_length`` have shape ``[...]`` (no trailing 1)."""
    line_length = _as(line_length, line_pos)
    direction = _direction(line_rot)
    delta_pos = line_pos - test_point_pos
    dot_p = torch.sum(delta_pos * direction, dim=-1)
    sign = torch.sign(dot_p)  # sign(0) == 0, as jnp.sign
    dist_from_center = torch.abs(dot_p)
    if limit_to_line_length:
        dist_from_center = torch.minimum(dist_from_center, line_length / 2)
    return line_pos - (sign * dist_from_center)[..., None] * direction


def line_extrema(
    line_pos: Tensor, line_rot: Tensor, line_length
) -> Tuple[Tensor, Tensor]:
    half = _as(line_length, line_pos) / 2
    xy = half[..., None] * _direction(line_rot)
    return line_pos + xy, line_pos - xy


def intersection_line_line(
    point_a1: Tensor, point_a2: Tensor, point_b1: Tensor, point_b2: Tensor
) -> Tuple[Tensor, Tensor]:
    """Segment-segment intersection; returns (point, distance), distance 0
    on intersection and +inf otherwise (the point is +inf too).  Parallel
    segments get a safe denominator and an out-of-range parameter, so the
    division's backward never forms 0 * inf."""
    r = point_a2 - point_a1
    s = point_b2 - point_b1
    p = point_a1
    q = point_b1
    cross_qp_r = TorchUtils.cross(q - p, r)
    cross_qp_s = TorchUtils.cross(q - p, s)
    cross_r_s = TorchUtils.cross(r, s)
    parallel = cross_r_s == 0
    safe_den = torch.where(parallel, torch.ones_like(cross_r_s), cross_r_s)
    minus_one = torch.full_like(cross_r_s, -1.0)
    u = torch.where(parallel, minus_one, cross_qp_r / safe_den)
    t = torch.where(parallel, minus_one, cross_qp_s / safe_den)
    in_range = (0 <= t) & (t <= 1) & (0 <= u) & (u <= 1)
    condition = (~parallel) & in_range  # [..., 1]
    inf = torch.full_like(p, math.inf)
    point = torch.where(condition, p + t * r, inf)
    distance = torch.where(
        condition[..., 0], torch.zeros_like(p[..., 0]), inf[..., 0]
    )
    return point, distance


def closest_points_line_line(
    line_pos: Tensor,
    line_rot: Tensor,
    line_length,
    line2_pos: Tensor,
    line2_rot: Tensor,
    line2_length,
) -> Tuple[Tensor, Tensor]:
    """Closest point pair between two segments."""
    shape = torch.broadcast_shapes(
        line_rot.shape, line2_rot.shape, line_pos.shape[:-1],
        line2_pos.shape[:-1],
    )
    line_pos = line_pos.expand(shape + (2,))
    line2_pos = line2_pos.expand(shape + (2,))
    line_rot = line_rot.expand(shape)
    line2_rot = line2_rot.expand(shape)
    line_length = _as(line_length, line_pos).expand(shape)
    line2_length = _as(line2_length, line_pos).expand(shape)
    point_a1, point_a2 = line_extrema(line_pos, line_rot, line_length)
    point_b1, point_b2 = line_extrema(line2_pos, line2_rot, line2_length)

    point_i, d_i = intersection_line_line(point_a1, point_a2, point_b1, point_b2)

    # Project each endpoint of one segment onto the other segment: the four
    # sub-problems stacked on a fresh leading axis.
    proj_pos = torch.stack([line2_pos, line2_pos, line_pos, line_pos])
    proj_rot = torch.stack([line2_rot, line2_rot, line_rot, line_rot])
    proj_len = torch.stack(
        [line2_length, line2_length, line_length, line_length]
    )
    proj_pts = torch.stack([point_a1, point_a2, point_b1, point_b2])
    a1_on_b, a2_on_b, b1_on_a, b2_on_a = closest_point_line(
        proj_pos, proj_rot, proj_len, proj_pts
    )
    candidates_1 = torch.stack([point_a1, point_a2, b1_on_a, b2_on_a])
    candidates_2 = torch.stack([a1_on_b, a2_on_b, point_b1, point_b2])
    closest_1, closest_2 = _min_select(candidates_1, candidates_2)

    crossing = (d_i == 0)[..., None]
    closest_1 = torch.where(crossing, point_i, closest_1)
    closest_2 = torch.where(crossing, point_i, closest_2)
    return closest_1, closest_2


def all_lines_box(
    box_pos: Tensor, box_rot: Tensor, box_width, box_length
) -> Tuple[Tensor, Tensor, Tensor]:
    """The 4 sides of a box as segments, stacked on a fresh leading axis:
    (pos [4,...,2], rot [4,...], length [4,...]).  Side order matches the
    reference: +length, -length, +width, -width."""
    shape = torch.broadcast_shapes(box_rot.shape, box_pos.shape[:-1])
    box_pos = box_pos.expand(shape + (2,))
    box_rot = box_rot.expand(shape)
    box_width = _as(box_width, box_pos).expand(shape)
    box_length = _as(box_length, box_pos).expand(shape)
    heading = _direction(box_rot)
    perp_rot = box_rot + math.pi / 2
    perp = _direction(perp_rot)

    half_l = (box_length / 2)[..., None]
    half_w = (box_width / 2)[..., None]
    p1 = box_pos + heading * half_l
    p2 = box_pos - heading * half_l
    p3 = box_pos + perp * half_w
    p4 = box_pos - perp * half_w

    pos = torch.stack([p1, p2, p3, p4])
    rot = torch.stack([perp_rot, perp_rot, box_rot, box_rot])
    length = torch.stack([box_width, box_width, box_length, box_length])
    return pos, rot, length


def closest_point_box_xy(
    box_pos: Tensor, box_rot: Tensor, box_width, box_length,
    test_point_pos: Tensor,
) -> Tuple[Tensor, Tensor]:
    """Closest point on a box's perimeter, as (x, y) components.

    Local-frame clamp form: rotate the test point into the box frame, clamp
    to the half-extents, and snap interior points to their nearest edge.
    Geometrically identical to the 4-side first-minimum fold
    (:func:`closest_point_box`), ties included (``margin_x <= margin_y``
    lets the length-direction edges win, as the fold's side order does).
    The scenario queries (``World.get_distance_from_point``,
    ``is_overlapping``) use this form and the physics the fold, as in the
    JAX package, so each matches its JAX counterpart to the ulp."""
    c = torch.cos(box_rot)
    s = torch.sin(box_rot)
    half_l = _as(box_length, box_pos) / 2
    half_w = _as(box_width, box_pos) / 2
    d = test_point_pos - box_pos
    dx, dy = d[..., X], d[..., Y]
    local_x = dx * c + dy * s  # along heading (length direction)
    local_y = -dx * s + dy * c  # along perp (width direction)
    clip_x = torch.minimum(torch.maximum(local_x, -half_l), half_l)
    clip_y = torch.minimum(torch.maximum(local_y, -half_w), half_w)
    inside = (torch.abs(local_x) < half_l) & (torch.abs(local_y) < half_w)
    margin_x = half_l - torch.abs(local_x)
    margin_y = half_w - torch.abs(local_y)
    edge_x = torch.where(local_x >= 0, half_l, -half_l)
    edge_y = torch.where(local_y >= 0, half_w, -half_w)
    qx = torch.where(inside & (margin_x <= margin_y), edge_x, clip_x)
    qy = torch.where(inside & (margin_x > margin_y), edge_y, clip_y)
    gx = qx * c - qy * s + box_pos[..., X]
    gy = qx * s + qy * c + box_pos[..., Y]
    return gx, gy


def closest_point_box(
    box_pos: Tensor, box_rot: Tensor, box_width, box_length,
    test_point_pos: Tensor,
) -> Tensor:
    """Closest point on a box's perimeter to a test point (4-side fold)."""
    lines_pos, lines_rot, lines_length = all_lines_box(
        box_pos, box_rot, box_width, box_length
    )
    pts = closest_point_line(
        lines_pos, lines_rot, lines_length, test_point_pos[None]
    )  # [4, ..., 2]
    d = _norm(test_point_pos[None] - pts)
    idx = torch.argmin(d, dim=0)[None, ..., None].expand((1,) + pts.shape[1:])
    return torch.gather(pts, 0, idx)[0]


def closest_line_box(
    box_pos: Tensor,
    box_rot: Tensor,
    box_width,
    box_length,
    line_pos: Tensor,
    line_rot: Tensor,
    line_length,
) -> Tuple[Tensor, Tensor]:
    """Closest (box point, line point) pair between a box and a segment."""
    line_length = _as(line_length, box_pos).expand(line_rot.shape)
    lines_pos, lines_rot, lines_length = all_lines_box(
        box_pos, box_rot, box_width, box_length
    )
    ps_box, ps_line = closest_points_line_line(
        lines_pos, lines_rot, lines_length,
        line_pos[None], line_rot[None], line_length[None],
    )
    return _min_select(ps_box, ps_line)


def closest_box_box(
    box_pos: Tensor,
    box_rot: Tensor,
    box_width,
    box_length,
    box2_pos: Tensor,
    box2_rot: Tensor,
    box2_width,
    box2_length,
) -> Tuple[Tensor, Tensor]:
    """Closest point pair between two boxes: each box's 4 sides against the
    other box (8 candidates, reference order), first minimum."""
    box_width = _as(box_width, box_pos).expand(box_rot.shape)
    box_length = _as(box_length, box_pos).expand(box_rot.shape)
    box2_width = _as(box2_width, box_pos).expand(box2_rot.shape)
    box2_length = _as(box2_length, box_pos).expand(box2_rot.shape)

    la_pos, la_rot, la_len = all_lines_box(
        box_pos, box_rot, box_width, box_length
    )
    lb_pos, lb_rot, lb_len = all_lines_box(
        box2_pos, box2_rot, box2_width, box2_length
    )

    def tile(x, like):
        return x.expand(like.shape)

    # Pass 1: sides of box1 vs box2; pass 2: sides of box2 vs box1.
    tgt_pos = torch.cat([tile(box2_pos, la_pos), tile(box_pos, lb_pos)])
    tgt_rot = torch.cat([tile(box2_rot, la_rot), tile(box_rot, lb_rot)])
    tgt_w = torch.cat([tile(box2_width, la_rot), tile(box_width, lb_rot)])
    tgt_l = torch.cat([tile(box2_length, la_rot), tile(box_length, lb_rot)])
    src_pos = torch.cat([la_pos, lb_pos])
    src_rot = torch.cat([la_rot, lb_rot])
    src_len = torch.cat([la_len, lb_len])

    pts_target, pts_line = closest_line_box(
        tgt_pos, tgt_rot, tgt_w, tgt_l, src_pos, src_rot, src_len
    )
    pts_on_box1 = torch.cat([pts_line[:4], pts_target[4:]])
    pts_on_box2 = torch.cat([pts_target[:4], pts_line[4:]])
    return _min_select(pts_on_box1, pts_on_box2)


def inner_point_box(
    outside_point: Tensor, surface_point: Tensor, box_pos: Tensor
) -> Tuple[Tensor, Tensor]:
    """Project the surface contact point toward the box centre along the
    outside-point->surface ray (physics.py:13-23); returns (inner point,
    distance surface->inner).  For a degenerate ray the reference sets the
    offset to the surface point itself, giving ``surface + surface``."""
    v = surface_point - outside_point
    u = box_pos - surface_point
    v_norm = _norm(v)[..., None]
    safe = torch.clamp_min(v_norm, 1e-12)
    x_magnitude = torch.sum(v * u, dim=-1, keepdim=True) / safe
    x = v / safe * x_magnitude
    degenerate = v_norm == 0
    x = torch.where(degenerate, surface_point.expand_as(x), x)
    x_magnitude = torch.where(
        degenerate, torch.zeros_like(x_magnitude), x_magnitude
    )
    return surface_point + x, torch.abs(x_magnitude[..., 0])
