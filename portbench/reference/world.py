"""Plain PyTorch physics of a world that a configuration file describes.

The reference side of the benchmark's comparison for the simulator: one
VMAS step (``vmas/simulator/core.py``: ``World.step``, the agents' holonomic
action forces, drag, the soft collision and joint constraint forces, and
semi-implicit Euler over the substeps) for worlds of spheres, boxes and
lines, read from the configuration's ``world``, ``entities``, ``agents``,
``pairs`` and ``joints`` alone.  It imports nothing of the port.

Every tensor is batch-leading: ``pos [B, N, 2]``, ``rot [B, N, 1]``.
``dtype`` is the precision the step computes in: float32, as the
configurations state, and bfloat16 for the control.
"""
from __future__ import annotations

import math

import torch

# The smallest distance kept between a line and what touches it
# (vmas/simulator/utils.py: LINE_MIN_DIST).
LINE_MIN_DIST = 4 / 6e2


def moment_of_inertia(entity: dict) -> float:
    """VMAS's moment of a shape about its centre (vmas/simulator/core.py:
    Sphere, Box and Line)."""
    m = entity["mass"]
    if entity["shape"] == "sphere":
        return 0.5 * m * entity["radius"] ** 2
    if entity["shape"] == "box":
        return m * (entity["length"] ** 2 + entity["width"] ** 2) / 12
    return m * entity["length"] ** 2 / 12


class Tables:
    """A configuration's constants as device tensors of ``dtype``."""

    def __init__(self, cfg: dict, device, dtype=torch.float32):
        ents = cfg["entities"]
        self.cfg = cfg
        self.dtype = dtype
        self.n = len(ents)
        self.agent_index = [a["entity"] for a in cfg["agents"]]

        def col(values, dt=dtype):
            return torch.tensor(values, dtype=torch.float32,
                                device=device).to(dt)

        def flag(key):
            return torch.tensor([e[key] for e in ents], dtype=torch.bool,
                                device=device)

        w = cfg["world"]
        self.substeps = w["substeps"]
        self.sub_dt = w["dt"] / w["substeps"]
        self.semidim = (w.get("x_semidim"), w.get("y_semidim"))
        self.collision_force = w["collision_force"]
        self.joint_force = w["joint_force"]
        self.margin = w["contact_margin"]
        self.mass = col([e["mass"] for e in ents])[None, :, None]
        self.moment = col([moment_of_inertia(e) for e in ents])[None, :, None]
        self.drag = w["drag"]
        self.movable = flag("movable")[None, :, None]
        self.rotatable = flag("rotatable")[None, :, None]
        self.radius = col([e.get("radius", 0.0) for e in ents])
        self.length = col([e.get("length", 0.0) for e in ents])
        self.width = col([e.get("width", 0.0) for e in ents])
        self.u_multiplier = col([a["u_multiplier"] for a in cfg["agents"]])
        self.f_range = col([math.inf if a["f_range"] is None else a["f_range"]
                            for a in cfg["agents"]])
        self.pairs = {c: torch.tensor(p, dtype=torch.long, device=device)
                      for c, p in cfg["pairs"].items() if p}
        self.joints = cfg["joints"]
        if self.joints:
            self.joint_a = torch.tensor([j["a"] for j in self.joints],
                                        device=device)
            self.joint_b = torch.tensor([j["b"] for j in self.joints],
                                        device=device)
            self.joint_delta_a = col([j["delta_a"] for j in self.joints])
            self.joint_delta_b = col([j["delta_b"] for j in self.joints])
            self.joint_dist = col([j["dist"] for j in self.joints])
            if not all(j["rotate"] for j in self.joints):
                raise NotImplementedError(
                    "a joint with a fixed rotation: no configuration has one")


# ---------------------------------------------------------------- #
# Geometry (vmas/simulator/physics.py)
# ---------------------------------------------------------------- #
def norm(v):
    """The L2 norm over the last axis, 0 at the zero vector."""
    sq = (v * v).sum(-1)
    pos = sq > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, sq, torch.ones_like(sq))),
                       torch.zeros_like(sq))


def cross(a, b):
    return (a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0])[..., None]


def rotate(v, angle):
    """``v [..., 2]`` rotated by ``angle [...]``."""
    c, s = torch.cos(angle), torch.sin(angle)
    return torch.stack([v[..., 0] * c - v[..., 1] * s,
                        v[..., 0] * s + v[..., 1] * c], dim=-1)


def direction(rot):
    return torch.stack([torch.cos(rot), torch.sin(rot)], dim=-1)


def closest_point_line(line_pos, line_rot, length, point):
    """The point of a segment nearest ``point``."""
    d = direction(line_rot)
    dot = ((line_pos - point) * d).sum(-1)
    along = torch.minimum(torch.abs(dot), length / 2)
    return line_pos - (torch.sign(dot) * along)[..., None] * d


def box_sides(box_pos, box_rot, width, length):
    """A box's four sides as segments on a leading axis: (+length,
    -length, +width, -width), VMAS's order."""
    shape = torch.broadcast_shapes(box_rot.shape, box_pos.shape[:-1])
    box_pos = box_pos.expand(shape + (2,))
    box_rot = box_rot.expand(shape)
    width, length = width.expand(shape), length.expand(shape)
    heading, perp_rot = direction(box_rot), box_rot + math.pi / 2
    perp = direction(perp_rot)
    half_l, half_w = (length / 2)[..., None], (width / 2)[..., None]
    pos = torch.stack([box_pos + heading * half_l, box_pos - heading * half_l,
                       box_pos + perp * half_w, box_pos - perp * half_w])
    rot = torch.stack([perp_rot, perp_rot, box_rot, box_rot])
    lengths = torch.stack([width, width, length, length])
    return pos, rot, lengths


def first_nearest(points_a, points_b):
    """Of candidate pairs on a leading axis, the first nearest pair."""
    idx = torch.argmin(norm(points_a - points_b), dim=0)
    idx = idx[None, ..., None].expand((1,) + points_a.shape[1:])
    return (torch.gather(points_a, 0, idx)[0],
            torch.gather(points_b, 0, idx)[0])


def closest_point_box(box_pos, box_rot, width, length, point):
    sides = box_sides(box_pos, box_rot, width, length)
    pts = closest_point_line(*sides, point[None])
    return first_nearest(pts, point[None].expand_as(pts))[0]


def inner_point_box(outside, surface, box_pos):
    """The contact point moved into a solid box along the ray from the
    outside point (physics.py: _get_inner_point_box), and how far."""
    v = surface - outside
    u = box_pos - surface
    v_norm = norm(v)[..., None]
    safe = torch.clamp_min(v_norm, 1e-12)
    x_mag = (v * u).sum(-1, keepdim=True) / safe
    x = v / safe * x_mag
    degenerate = v_norm == 0
    x = torch.where(degenerate, surface.expand_as(x), x)
    x_mag = torch.where(degenerate, torch.zeros_like(x_mag), x_mag)
    return surface + x, torch.abs(x_mag[..., 0])


def closest_points_segments(pos_a, rot_a, len_a, pos_b, rot_b, len_b):
    """The nearest pair of points of two segments: their crossing point,
    else the first nearest of the four endpoint projections."""
    shape = torch.broadcast_shapes(rot_a.shape, rot_b.shape,
                                   pos_a.shape[:-1], pos_b.shape[:-1])
    pos_a, pos_b = pos_a.expand(shape + (2,)), pos_b.expand(shape + (2,))
    rot_a, rot_b = rot_a.expand(shape), rot_b.expand(shape)
    len_a, len_b = len_a.expand(shape), len_b.expand(shape)
    half_a = (len_a / 2)[..., None] * direction(rot_a)
    half_b = (len_b / 2)[..., None] * direction(rot_b)
    a1, a2 = pos_a + half_a, pos_a - half_a
    b1, b2 = pos_b + half_b, pos_b - half_b

    r, s = a2 - a1, b2 - b1
    r_s = cross(r, s)
    parallel = r_s == 0
    den = torch.where(parallel, torch.ones_like(r_s), r_s)
    t = torch.where(parallel, -torch.ones_like(r_s), cross(b1 - a1, s) / den)
    u = torch.where(parallel, -torch.ones_like(r_s), cross(b1 - a1, r) / den)
    crossing = (~parallel) & (t >= 0) & (t <= 1) & (u >= 0) & (u <= 1)
    point_i = a1 + t * r

    on_b = closest_point_line(torch.stack([pos_b, pos_b]),
                              torch.stack([rot_b, rot_b]),
                              torch.stack([len_b, len_b]),
                              torch.stack([a1, a2]))
    on_a = closest_point_line(torch.stack([pos_a, pos_a]),
                              torch.stack([rot_a, rot_a]),
                              torch.stack([len_a, len_a]),
                              torch.stack([b1, b2]))
    near_a, near_b = first_nearest(torch.cat([torch.stack([a1, a2]), on_a]),
                                   torch.cat([on_b, torch.stack([b1, b2])]))
    return (torch.where(crossing, point_i, near_a),
            torch.where(crossing, point_i, near_b))


def closest_line_box(box_pos, box_rot, width, length, line_pos, line_rot,
                     line_len):
    sides = box_sides(box_pos, box_rot, width, length)
    on_box, on_line = closest_points_segments(
        *sides, line_pos[None], line_rot[None], line_len[None])
    return first_nearest(on_box, on_line)


def box_sphere_overlap(box_pos, box_rot, width, length, sphere_pos, radius):
    """Whether a sphere touches a box (VMAS's ``World.is_overlapping``):
    its centre inside, or nearer the box's perimeter than its radius."""
    c, s = torch.cos(box_rot), torch.sin(box_rot)
    d = sphere_pos - box_pos
    lx = d[..., 0] * c + d[..., 1] * s
    ly = -d[..., 0] * s + d[..., 1] * c
    hl, hw = length / 2, width / 2
    qx = torch.clamp(lx, -hl, hl)
    qy = torch.clamp(ly, -hw, hw)
    inside = (torch.abs(lx) < hl) & (torch.abs(ly) < hw)
    mx, my = hl - torch.abs(lx), hw - torch.abs(ly)
    qx = torch.where(inside & (mx <= my), torch.where(lx >= 0, hl, -hl), qx)
    qy = torch.where(inside & (mx > my), torch.where(ly >= 0, hw, -hw), qy)
    near = torch.stack([qx * c - qy * s, qx * s + qy * c], -1) + box_pos
    return ((norm(sphere_pos - box_pos) < norm(box_pos - near))
            | (norm(sphere_pos - near) < radius + LINE_MIN_DIST))


# ---------------------------------------------------------------- #
# Forces
# ---------------------------------------------------------------- #
def soft_force(T, pos_a, pos_b, dist_min, multiplier, attractive=False):
    """VMAS's soft contact (core.py: _get_constraint_forces): a softplus of
    the penetration along the normal; a joint pulls (attractive) where
    the points lie farther apart than the rest distance."""
    sign = -1 if attractive else 1
    delta = pos_a - pos_b
    dist = norm(delta)
    x = (dist_min - dist) * sign / T.margin
    penetration = torch.logaddexp(x, torch.zeros_like(x)) * T.margin
    safe = torch.where(dist > 0, dist, torch.full_like(dist, 1e-8))
    force = sign * multiplier * delta / safe[..., None] * penetration[..., None]
    far = (dist < dist_min) if attractive else (dist > dist_min)
    zero = (dist < 1e-6) | far
    force = torch.where(zero[..., None], torch.zeros_like(force), force)
    return force, -force


def pair_forces(T, pos, rot):
    """Every joint and collision pair's forces and torques, summed per
    entity: ``([B, N, 2], [B, N, 1])``."""
    B = pos.shape[0]
    forces = torch.zeros_like(pos)
    torques = torch.zeros(B, T.n, 1, dtype=pos.dtype, device=pos.device)

    def add(idx, f, t=None):
        forces.index_add_(1, idx, f)
        if t is not None:
            torques.index_add_(1, idx, t)

    if T.joints:
        ia, ib = T.joint_a, T.joint_b
        pa, pb = pos[:, ia], pos[:, ib]
        ja = pa + rotate(T.joint_delta_a[None].expand(pa.shape), rot[:, ia, 0])
        jb = pb + rotate(T.joint_delta_b[None].expand(pb.shape), rot[:, ib, 0])
        dist = T.joint_dist[None]
        fa1, fb1 = soft_force(T, ja, jb, dist, T.joint_force, attractive=True)
        fa2, fb2 = soft_force(T, ja, jb, dist, T.joint_force)
        fa, fb = fa1 + fa2, fb1 + fb2
        add(ia, fa, cross(ja - pa, fa))
        add(ib, fb, cross(jb - pb, fb))
    cf = T.collision_force
    for cls, p in T.pairs.items():
        i, j = p[:, 0], p[:, 1]
        pi, pj = pos[:, i], pos[:, j]
        if cls == "ss":
            fi, fj = soft_force(T, pi, pj, (T.radius[i] + T.radius[j])[None], cf)
            add(i, fi)
            add(j, fj)
        elif cls == "ls":  # (line, sphere)
            near = closest_point_line(pi, rot[:, i, 0], T.length[i][None], pj)
            fs, fl = soft_force(T, pj, near,
                                (T.radius[j] + LINE_MIN_DIST)[None], cf)
            add(i, fl, cross(near - pi, fl))
            add(j, fs)
        elif cls == "bs":  # (box, sphere); every box here is solid
            near = closest_point_box(pi, rot[:, i, 0], T.width[i][None],
                                     T.length[i][None], pj)
            inner, d = inner_point_box(pj, near, pi)
            fs, fb = soft_force(T, pj, inner,
                                T.radius[j][None] + LINE_MIN_DIST + d, cf)
            add(i, fb, cross(near - pi, fb))
            add(j, fs)
        elif cls == "bl":  # (box, line)
            on_box, on_line = closest_line_box(
                pi, rot[:, i, 0], T.width[i][None], T.length[i][None],
                pj, rot[:, j, 0], T.length[j][None])
            inner, d = inner_point_box(on_line, on_box, pi)
            fb, fl = soft_force(T, inner, on_line, LINE_MIN_DIST + d, cf)
            add(i, fb, cross(on_box - pi, fb))
            add(j, fl, cross(on_line - pj, fl))
        else:
            raise NotImplementedError(
                f"pair class {cls!r}: no configuration has one")
    return forces, torques


def physics_step(T: Tables, state: dict, actions):
    """One step of the world in ``state`` (``pos``, ``vel``, ``rot``,
    ``ang_vel``) under ``actions [A, B, 2]`` in [-1, 1]: the holonomic
    force ``action * u_multiplier`` clamped to ``f_range``, then drag,
    pair forces and ``substeps`` semi-implicit Euler steps with positions
    clamped to the world's semidims.  Returns the new
    ``(pos, vel, rot, ang_vel)``."""
    pos, vel, rot, ang_vel = (state[k] for k in ("pos", "vel", "rot",
                                                 "ang_vel"))
    force_a = actions.to(T.dtype) * T.u_multiplier[:, None, None]
    force_a = torch.minimum(torch.maximum(force_a, -T.f_range[:, None, None]),
                            T.f_range[:, None, None])
    action_force = torch.zeros_like(pos)
    action_force[:, T.agent_index] = force_a.transpose(0, 1)
    for sub in range(T.substeps):
        f, t = pair_forces(T, pos, rot)
        f = f + action_force
        if sub == 0:
            vel = torch.where(T.movable, vel * (1 - T.drag), vel)
            ang_vel = torch.where(T.rotatable, ang_vel * (1 - T.drag), ang_vel)
        vel = torch.where(T.movable, vel + f / T.mass * T.sub_dt, vel)
        new_pos = pos + vel * T.sub_dt
        x, y = new_pos[..., 0], new_pos[..., 1]
        if T.semidim[0] is not None:
            x = torch.clamp(x, -T.semidim[0], T.semidim[0])
        if T.semidim[1] is not None:
            y = torch.clamp(y, -T.semidim[1], T.semidim[1])
        pos = torch.where(T.movable, torch.stack([x, y], -1), pos)
        ang_vel = torch.where(T.rotatable, ang_vel + t / T.moment * T.sub_dt,
                              ang_vel)
        rot = torch.where(T.rotatable, rot + ang_vel * T.sub_dt, rot)
    return pos, vel, rot, ang_vel
