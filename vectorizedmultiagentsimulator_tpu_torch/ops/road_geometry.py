"""road_traffic's path geometry in plain PyTorch.

The counterparts of the JAX package's geometry helpers in
``scenarios/road_traffic.py`` (reference ``vmas/scenarios/road_traffic.py``
:3281-3711), operation for operation, and the plain versions of the three
road-geometry kernels (``ops/road_geometry_cuda.py``):

* ``agent_geometry_plain`` and ``pair_collisions_plain``: the plain
  versions of the agent-geometry and the pair kernel, and
  ``geometry_plain``, the two together in the order of the JAX package's
  ``Scenario._bundle_jnp_pure``;
* ``neighbor_obs_plain``: the counterpart of the JAX package's
  ``road_geometry_pallas._neighbor_obs_jnp``, the plain version of the
  neighbour-observation kernel.

Where the JAX package selects path rows and points with one-hot matrix
products (a TPU workaround for gathers), this module indexes directly
(``table[path_id]``, ``torch.gather``), which selects the same values.
Every operation keeps the JAX package's order and association, so that the
kernels, which repeat it, give the same bits where the libraries' sqrt,
division and products round alike.
"""
from __future__ import annotations

import math

import torch

from vectorizedmultiagentsimulator_tpu_torch.utils import TorchUtils

Tensor = torch.Tensor


def get_rectangle_vertices(center: Tensor, yaw: Tensor, width: float,
                           length: float, is_close_shape: bool = True
                           ) -> Tensor:
    """center [..., 2], yaw [...] -> vertices [..., 5 or 4, 2]: each corner
    rotated, then translated."""
    w, l = width / 2, length / 2
    base = [(l, w), (l, -w), (-l, -w), (-l, w)]
    if is_close_shape:
        base.append((l, w))
    cos, sin = torch.cos(yaw), torch.sin(yaw)
    verts = [torch.stack([bx * cos - by * sin, bx * sin + by * cos], dim=-1)
             for bx, by in base]
    return torch.stack(verts, dim=-2) + center[..., None, :]


def get_perpendicular_distances(point: Tensor, polyline: Tensor,
                                n_points: Tensor):
    """point [..., 2], polyline [..., P, 2], n_points [...] -> (the least
    distance from the point to the polyline's first ``n_points - 1``
    segments [...], the index of the first segment within 1e-5 of it, plus
    one [...]).

    Segments at or after ``n_points - 1`` take the distance of segment
    ``n_points - 2``; the square root of an exactly-zero square is 0 with a
    zero gradient; the index is the first within 1e-5 of the least distance
    (agents spawn on polyline vertices, where two segments tie)."""
    X, Y = polyline[..., 0], polyline[..., 1]
    px, py = point[..., 0, None], point[..., 1, None]
    x0, y0 = X[..., :-1], Y[..., :-1]
    dx, dy = X[..., 1:] - x0, Y[..., 1:] - y0
    pvx, pvy = px - x0, py - y0
    line_lens_sq = dx * dx + dy * dy + 1e-8
    t = torch.clamp((pvx * dx + pvy * dy) / line_lens_sq, 0.0, 1.0)
    cx = x0 + dx * t - px
    cy = y0 + dy * t - py
    sq = cx * cx + cy * cy
    positive = sq > 0
    d = torch.where(positive,
                    torch.sqrt(torch.where(positive, sq, torch.ones_like(sq))),
                    torch.zeros_like(sq))
    n = n_points.expand(d.shape[:-1]).to(torch.long)
    seg_idx = torch.arange(d.shape[-1], device=d.device)
    d_end = torch.gather(d, -1, torch.clamp_min(n - 2, 0)[..., None])
    d = torch.where(seg_idx >= (n - 1)[..., None], d_end, d)
    dist = torch.amin(d, dim=-1)
    within = (d <= (dist + 1e-5)[..., None]).to(torch.uint8)
    return dist, torch.argmax(within, dim=-1) + 1


def get_short_term_reference_path(polyline: Tensor, index_closest_point: Tensor,
                                  n_points_to_return: int, is_loop: Tensor,
                                  n_points: Tensor, sample_interval: int = 2,
                                  n_points_shift: int = 1):
    """polyline [..., P, 2] -> (the ``n_points_to_return`` points [..., K,
    2], their indices [..., K]): every ``sample_interval``-th point from
    the closest one on, wrapping around a loop, clamped to the table."""
    future = (
        torch.arange(n_points_to_return, device=polyline.device)
        * sample_interval
        + index_closest_point[..., None]
        + n_points_shift
    )
    n = n_points[..., None].to(torch.long)
    future = torch.where(is_loop[..., None] & (future >= n - 1),
                         (future + 1) % n, future)
    future = torch.clamp(future, 0, polyline.shape[-2] - 1)
    index = future[..., None].expand(*future.shape, 2)
    return torch.gather(polyline, -2, index), future


def segments_intersect(L1: Tensor, L2: Tensor) -> Tensor:
    """Strict crossing test between two polylines (the reference's
    ``interX``): L1 [..., N1, 2], L2 [..., N2, 2] -> bool [...], whether any
    segment of L1 strictly crosses any segment of L2."""
    X1, Y1 = L1[..., 0], L1[..., 1]
    X2, Y2 = L2[..., 0], L2[..., 1]
    p1x, p1y = X1[..., :-1, None], Y1[..., :-1, None]
    p2x, p2y = X1[..., 1:, None], Y1[..., 1:, None]
    q1x, q1y = X2[..., None, :-1], Y2[..., None, :-1]
    q2x, q2y = X2[..., None, 1:], Y2[..., None, 1:]
    sx, sy = q2x - q1x, q2y - q1y
    rx, ry = p2x - p1x, p2y - p1y
    d1 = sx * (p1y - q1y) - sy * (p1x - q1x)
    d2 = sx * (p2y - q1y) - sy * (p2x - q1x)
    d3 = rx * (q1y - p1y) - ry * (q1x - p1x)
    d4 = rx * (q2y - p1y) - ry * (q2x - p1x)
    hit = (d1 * d2 < 0) & (d3 * d4 < 0)
    return torch.any(hit.flatten(-2), dim=-1)


def exponential_decreasing_fcn(x: Tensor, x0: float, x1: float) -> Tensor:
    x_clamped = torch.clamp(x, x0, x1)
    e_inv = 1 / math.e
    return (torch.exp(-(x_clamped - x0) / (x1 - x0)) - e_inv) / (1 - e_inv)


def angle_eliminate_two_pi(angle: Tensor) -> Tensor:
    two_pi = 2 * math.pi
    angle = torch.remainder(angle, two_pi)
    return torch.where(angle > math.pi, angle - two_pi, angle)


def to_local(vec: Tensor, rot: Tensor) -> Tensor:
    """Rotate displacements ``vec`` [..., 2] into the ego frame of heading
    ``rot`` [...]: by ``-rot``."""
    cos, sin = torch.cos(-rot), torch.sin(-rot)
    return torch.stack([vec[..., 0] * cos - vec[..., 1] * sin,
                        vec[..., 0] * sin + vec[..., 1] * cos], dim=-1)


def agent_geometry_plain(tables, with_collisions: bool, pos: Tensor,
                         rot: Tensor, path_id: Tensor):
    """The plain version of the agent-geometry kernel: for the poses ``pos
    [B, A, 2]``, ``rot [B, A]`` on the paths ``path_id [B, A]`` of
    ``tables`` (``road_geometry_cuda.PathTables``), ``(ref [B, A], left_all
    [B, A, 5], right_all [B, A, 5], boundaries [B, A], short_term [B, A, K,
    2])`` and with collisions also ``(lanelets, entry, exit)`` [B, A], the
    crossings of each agent's rectangle with its path's boundaries and
    entry and exit segments as 0/1, all float32."""
    long_term = tables.center[path_id]  # [B, A, P, 2]
    left_b = tables.left[path_id]
    right_b = tables.right[path_id]
    n_pts = tables.n_points[path_id]
    n_left = tables.n_left[path_id]
    n_right = tables.n_right[path_id]
    is_loop = tables.is_loop[path_id]

    dist_ref, idx_ref = get_perpendicular_distances(pos, long_term, n_pts)
    vertices = get_rectangle_vertices(pos, rot, tables.width, tables.length)
    # The centre and the 4 corners against each boundary in one pass.
    pts5 = torch.cat([pos[:, :, None, :], vertices[..., :4, :]], dim=2)
    dl, _ = get_perpendicular_distances(pts5, left_b[:, :, None],
                                        n_left[:, :, None])
    dr, _ = get_perpendicular_distances(pts5, right_b[:, :, None],
                                        n_right[:, :, None])
    left_all = torch.cat([(dl[..., 0] - tables.width / 2)[..., None],
                          dl[..., 1:]], dim=-1)
    right_all = torch.cat([(dr[..., 0] - tables.width / 2)[..., None],
                           dr[..., 1:]], dim=-1)
    boundaries = torch.amin(torch.cat([left_all, right_all], dim=-1), dim=-1)
    short_term, _ = get_short_term_reference_path(
        long_term, idx_ref, tables.K, is_loop, n_pts,
        sample_interval=tables.SI, n_points_shift=1)
    base = (dist_ref, left_all, right_all, boundaries, short_term)
    if not with_collisions:
        return base
    hit_l = segments_intersect(vertices, left_b)
    hit_r = segments_intersect(vertices, right_b)
    collide_lanelets = (hit_l | hit_r).to(torch.float32)
    if tables.entry_exit:
        # Entry and exit segments of paths that are not loops.
        collide_entry = (segments_intersect(vertices, tables.entry[path_id])
                         & ~is_loop).to(torch.float32)
        collide_exit = (segments_intersect(vertices, tables.exit[path_id])
                        & ~is_loop).to(torch.float32)
    else:
        collide_entry = torch.zeros_like(dist_ref)
        collide_exit = torch.zeros_like(dist_ref)
    return base + (collide_lanelets, collide_entry, collide_exit)


def pair_collisions_plain(tables, pos: Tensor, rot: Tensor):
    """The plain version of the pair kernel: every agent's closed rectangle
    ``vertices [B, A, 5, 2]`` and the strict agent-agent crossings
    ``agents [B, A, A]`` (0/1 float32, zero diagonal)."""
    A = pos.shape[1]
    vertices = get_rectangle_vertices(pos, rot, tables.width, tables.length)
    pair_hits = segments_intersect(vertices[:, :, None], vertices[:, None, :])
    eye = torch.eye(A, dtype=torch.bool, device=pos.device)[None]
    return vertices, (pair_hits & ~eye).to(torch.float32)


def geometry_plain(tables, with_collisions: bool, pos: Tensor, rot: Tensor,
                   path_id: Tensor):
    """Every per-step path quantity of road_traffic, the counterpart of the
    JAX package's ``Scenario._bundle_jnp_pure``: ``agent_geometry_plain``'s
    first five outputs, and with collisions then ``(vertices, lanelets,
    entry, exit, agents)`` (``pair_collisions_plain``'s and the crossing
    flags)."""
    out = agent_geometry_plain(tables, with_collisions, pos, rot, path_id)
    if not with_collisions:
        return out
    vertices, agents = pair_collisions_plain(tables, pos, rot)
    return out[:5] + (vertices,) + out[5:] + (agents,)


def select_nearest(dn: Tensor, k: int):
    """The ``k``-round first-min over the last axis of ``dn [B, A, A]``
    (``argmin``'s first-index rule, the chosen entry set to inf between
    rounds): ``(values [B, A, k], indices [B, A, k])``."""
    cur = dn
    vals, idxs = [], []
    for _ in range(k):
        vals.append(torch.amin(cur, dim=-1))
        i = torch.argmin(cur, dim=-1)
        idxs.append(i)
        cur = torch.scatter(cur, -1, i[..., None], math.inf)
    return torch.stack(vals, dim=-1), torch.stack(idxs, dim=-1)


def gather_rows(x: Tensor, idx: Tensor) -> Tensor:
    """``x [B, A, ...]`` at ``idx [B, A_i, k]`` -> ``[B, A_i, k, ...]``."""
    b = torch.arange(x.shape[0], device=x.device)[:, None, None]
    return x[b, idx]


def neighbor_obs_plain(A: int, k: int, half_l: float, half_w: float,
                       pos: Tensor, rot: Tensor, vel: Tensor, dn: Tensor):
    """The ``k`` nearest other agents of each agent by ``dn [B, A, A]``
    (normalised mutual distances, large diagonal), in its ego frame, raw:
    ``(nearing_dist [B, A, k], pos_ego [B, A, k, 2], rot_rel [B, A, k],
    vel_ego [B, A, k, 2], vert_ego [B, A, k, 4, 2])``, from ``pos [B, A,
    2]``, ``rot [B, A]``, ``vel [B, A, 2]``."""
    vel_abs = TorchUtils.safe_norm(vel, dim=-1)  # [B, A]
    vertices = get_rectangle_vertices(pos, rot, 2 * half_w,
                                      2 * half_l)[..., :4, :]
    nd, idx = select_nearest(dn, k)
    pos_j = gather_rows(pos, idx)  # [B, A, k, 2]
    rot_j = gather_rows(rot, idx)  # [B, A, k]
    va_j = gather_rows(vel_abs, idx)
    vert_j = gather_rows(vertices, idx)  # [B, A, k, 4, 2]
    pe = to_local(pos_j - pos[:, :, None, :], rot[:, :, None])
    rot_rel = rot_j - rot[:, :, None]
    ve = torch.stack([va_j * torch.cos(rot_rel), va_j * torch.sin(rot_rel)],
                     dim=-1)
    vt = to_local(vert_j - pos[:, :, None, None, :], rot[:, :, None, None])
    return nd, pe, rot_rel, ve, vt
