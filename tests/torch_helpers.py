"""Helpers shared by the PyTorch port's tests and ``chip_smoke.py``.

Nothing here imports JAX, so ``chip_smoke.py`` can use it on a machine
that has PyTorch only.
"""
import math

import numpy as np
import torch

from vectorizedmultiagentsimulator_tpu_torch.core import (
    Agent,
    Box,
    Joint,
    Landmark,
    Line,
    Sphere,
    World,
)
from vectorizedmultiagentsimulator_tpu_torch.ops import physics_cuda, road_geometry
from vectorizedmultiagentsimulator_tpu_torch.utils import STATE_FIELDS


# A world the physics kernel refuses: 65 entities (no pairs) is over its
# 64-entity limit.
MANY_ENTITIES = dict(
    agents=[dict(name=f"a{i}", shape=("sphere", 0.01), collide=False)
            for i in range(65)],
)


# A joint world whose fixed rotations are static, so it steps through the
# kernel: a sphere pinned to a box's end by a dist-0 constraint that does
# not rotate and keeps the rotation gap 0.3 (explicit fixed_rotation_a and
# _b), and two heavy spheres pinned by a dist-0 constraint that does not
# rotate and has no fixed rotation (0 on the kernel).  physics_configs.py's
# joints_fixed_rotation infers its rotation per env and takes the plain
# path.
JOINTS_STATIC_ROTATION = dict(
    world=dict(substeps=5, dt=0.1),
    agents=[
        dict(name="a0", shape=("sphere", 0.05)),
        dict(name="a1", shape=("box", 0.3, 0.2, False), rotatable=True,
             mass=4.0),
        dict(name="a2", shape=("sphere", 0.1), mass=5.0),
        dict(name="a3", shape=("sphere", 0.1), mass=5.0),
    ],
    landmarks=[
        dict(name="l0", shape=("sphere", 0.1)),
    ],
    joints=[
        dict(a="a0", b="a1", anchor_a=(0, 0), anchor_b=(1, 0), dist=0.0,
             rotate_a=False, rotate_b=False, fixed_rotation_a=0.3,
             fixed_rotation_b=0.3),
        dict(a="a2", b="a3", dist=0.0, rotate_a=False, rotate_b=False),
    ],
    spread=0.5,
    # The fixed-rotation torque grows as exp|rotation gap|: rotations near
    # the constraint keep a step comparable pointwise.
    rot_spread=0.3,
)


def make_shape(spec):
    if spec[0] == "sphere":
        return Sphere(radius=spec[1])
    if spec[0] == "box":
        return Box(length=spec[1], width=spec[2], hollow=spec[3])
    if spec[0] == "line":
        return Line(length=spec[1])
    raise ValueError(spec)


def build_world(cfg, batch, *, device, seed=0):
    """A finalized port ``World`` from a ``tests/physics_configs.py`` spec
    (joints too); returns ``(world, {name: entity})``."""
    wkw = dict(cfg.get("world", {}))
    wkw.update(cfg.get("world_bounds", {}))
    world = World(batch, device, **wkw)
    entities = {}
    for kind, cls in (("agents", Agent), ("landmarks", Landmark)):
        for spec in cfg.get(kind, []):
            spec = dict(spec)
            name = spec.pop("name")
            e = cls(name=name, shape=make_shape(spec.pop("shape")), **spec)
            (world.add_agent if cls is Agent else world.add_landmark)(e)
            entities[name] = e
    for j in cfg.get("joints", []):
        world.add_joint(Joint(
            entities[j["a"]], entities[j["b"]],
            anchor_a=tuple(j.get("anchor_a", (0, 0))),
            anchor_b=tuple(j.get("anchor_b", (0, 0))),
            dist=j.get("dist", 0.0),
            rotate_a=j.get("rotate_a", True),
            rotate_b=j.get("rotate_b", True),
            collidable=j.get("collidable", False),
            width=j.get("width", 0.0),
            fixed_rotation_a=j.get("fixed_rotation_a"),
            fixed_rotation_b=j.get("fixed_rotation_b"),
        ))
    world.finalize(seed=seed)
    return world, entities


def random_step_inputs(world, spread, seed, rot_spread=math.pi):
    """Physics-step inputs ``(pos, vel, rot, ang_vel, force, torque,
    dyn_g)`` for ``world``, drawn from ``seed`` on the world's device:
    positions uniform in ``[-spread, spread]`` (so many pairs overlap),
    rotations in ``[-rot_spread, rot_spread]``, small random velocities
    and actions."""
    g = torch.Generator(device=world.device).manual_seed(seed)
    B, N, A = world.batch_dim, world._n_entities, len(world.agents)
    D = len(world._dyn_gravity_names)

    def u(*shape, lo=-1.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=g, device=world.device)

    return (
        u(B, N, 2, lo=-spread, hi=spread),
        u(B, N, 2, lo=-0.5, hi=0.5),
        u(B, N, 1, lo=-rot_spread, hi=rot_spread),
        u(B, N, 1, lo=-0.5, hi=0.5),
        u(B, A, 2),
        u(B, A, 1, lo=-0.2, hi=0.2),
        u(B, D, 2, lo=-0.1, hi=0.1),
    )


# The physics kernel against its plain version: every output within
# PHYS_ATOL + PHYS_RTOL |plain|.  A stiff joint world (joint_force 900 over
# 10-15 substeps amplifies a reassociation about 2x a substep) that exceeds
# it from inputs far from rest is held instead, env by env, to
# STIFF_FACTOR times that env's float32 sensitivity: the largest
# |plain32 - plain64| over its outputs, of the plain version from the
# inputs and from STIFF_NUDGES copies of them nudged by up to an ulp.  At
# most STIFF_ENV_SHARE of the envs may exceed that (an env at a force's
# cut-off, dist < 1e-6 or a contact's edge, takes the branch that the
# nudges do not; a wrong kernel fails in almost every env), and every
# output is held, over all envs, to STIFF_FACTOR x max |plain32 - plain64|
# + PHYS_ATOL.
PHYS_ATOL = PHYS_RTOL = 1e-4
STIFF_FACTOR = 4.0
STIFF_NUDGES = 8
STIFF_ENV_SHARE = 1e-3


def step_plain64(world, inputs):
    """The plain version (``physics_cuda.step_plain``) in float64 from the
    float32 ``inputs``: the world's float tables are widened for the
    call."""
    tables = world._t
    world._t = {k: v.double() if v.is_floating_point() else v
                for k, v in tables.items()}
    try:
        return physics_cuda.step_plain(world, *(x.double() for x in inputs))
    finally:
        world._t = tables


def nudged(inputs, seed):
    """``inputs`` with each element moved by -1, 0 or +1 ulp (drawn from
    ``seed``)."""
    g = torch.Generator(device=inputs[0].device).manual_seed(seed)
    return [x + x.abs() * torch.randint(-1, 2, x.shape, generator=g,
                                        device=x.device) * 2.0 ** -23
            for x in inputs]


def _env_max(tensors):
    """[B]: each env's largest element over ``tensors`` (each [B, ...])."""
    return torch.stack([t.reshape(t.shape[0], -1).amax(1)
                        for t in tensors]).amax(0)


def physics_diff(world, inputs, got, stiff=False):
    """``got`` (a kernel's ``(pos, vel, rot, ang_vel)``) against the plain
    version on ``inputs``: a dict of ``max_abs_err`` (max |got - plain32|),
    ``bad`` (outputs beyond PHYS_ATOL + PHYS_RTOL |plain32|) and ``ok``.
    With ``stiff``, a result with ``bad`` outputs also carries
    ``plain_f64_err`` (max |plain32 - plain64|), the ``bound`` STIFF_FACTOR
    x that + PHYS_ATOL, ``bad_envs`` (envs with an output beyond
    STIFF_FACTOR x the env's sensitivity + PHYS_ATOL + PHYS_RTOL |plain32|),
    ``allowed_envs`` (STIFF_ENV_SHARE of the envs) and ``env_ratio`` (the
    largest ratio of an env's excess over the strict tolerance to its
    sensitivity), and is ``ok`` when ``max_abs_err`` is within ``bound``
    and ``bad_envs`` within ``allowed_envs``."""
    with torch.no_grad():
        ref = physics_cuda.step_plain(world, *inputs)
        err, bad, finite = 0.0, 0, True
        excess = []
        for g, r in zip(got, ref):
            d = (g - r).abs()
            err = max(err, float(d.max()))
            finite = finite and bool(torch.isfinite(g).all())
            # NaN counts as out of tolerance.
            over = d - (PHYS_ATOL + PHYS_RTOL * r.abs())
            excess.append(torch.where(torch.isnan(over), math.inf, over))
            bad += int((~(d <= PHYS_ATOL + PHYS_RTOL * r.abs())).sum())
        out = {"max_abs_err": err, "bad": bad, "ok": bad == 0}
        if stiff and bad:
            ref64 = step_plain64(world, inputs)
            diff64 = [(r.double() - r64).abs() for r, r64 in zip(ref, ref64)]
            f64 = max(float(d.max()) for d in diff64)
            sens = _env_max(diff64)
            for k in range(STIFF_NUDGES):
                again = physics_cuda.step_plain(world, *nudged(inputs, k))
                sens = torch.maximum(sens, _env_max(
                    [(a.double() - r64).abs() for a, r64 in zip(again, ref64)]))
            env_excess = _env_max(excess).double()
            bad_envs = int((~(env_excess <= STIFF_FACTOR * sens)).sum())
            over = env_excess > 0
            ratio = (float((env_excess[over] / sens[over]).max())
                     if bool(over.any()) else 0.0)
            out.update(plain_f64_err=f64, bound=STIFF_FACTOR * f64 + PHYS_ATOL,
                       bad_envs=bad_envs,
                       allowed_envs=int(STIFF_ENV_SHARE * len(sens)),
                       env_ratio=ratio)
            out["ok"] = (finite and err <= out["bound"]
                         and bad_envs <= out["allowed_envs"])
    return out


# jittered_inputs' spread: each constraint stretched by about 1e-2, where
# a step stays well conditioned (smaller, some anchors near the joint
# force's dist < 1e-6 cut-off flip its direction; larger, contacts start).
JITTER = 3e-2


def jittered_inputs(inputs, seed, jitter=JITTER):
    """Physics-step ``inputs`` with every entity's position and rotation
    moved by up to ``jitter`` (uniform, drawn from ``seed``): from a reset
    state, where the joint observers pose every joint at rest (all joint
    forces 0), this stretches every constraint."""
    pos, vel, rot, *rest = inputs
    g = torch.Generator(device=pos.device).manual_seed(seed)

    def u(x):
        return x + jitter * (2 * torch.rand(x.shape, generator=g,
                                            device=x.device) - 1)

    return (u(pos), vel, u(rot), *rest)


def posed_step_inputs(world, entities, cfg, seed):
    """Physics-step inputs of a ``physics_configs``-style world as the
    golden generator (``tools/gen_golden.py``) poses it: each configured
    entity written through ``set_pos``/``set_rot`` in the config's order
    (so the joint observers pose the joint landmarks between their anchors)
    at a jittered grid of pitch ``spread``, rotations in ``[-rot_spread,
    rot_spread]``, velocities in [-0.3, 0.3], angular velocities in
    [-0.5, 0.5]; random actions.  Drawn from ``seed`` on the world's device;
    the world's state is left at the pose."""
    g = torch.Generator(device=world.device).manual_seed(seed)
    B, A, dev = world.batch_dim, len(world.agents), world.device
    spread = cfg["spread"]
    rot_spread = cfg.get("rot_spread", math.pi)

    def u(*shape, s=1.0):
        return (torch.rand(shape, generator=g, device=dev) * 2 - 1) * s

    names = [e["name"] for e in cfg.get("agents", [])] + [
        e["name"] for e in cfg.get("landmarks", [])]
    for i, n in enumerate(names):
        e = entities[n]
        cell = torch.tensor([(i % 3 - 1) * spread, (i // 3 - 1) * spread],
                            device=dev)
        e.set_pos(u(B, 2, s=spread) + cell)
        e.set_rot(u(B, 1, s=rot_spread))
        e.state.vel = u(B, 2, s=0.3)
        e.state.ang_vel = u(B, 1, s=0.5)
    s = world.state
    return (s.pos, s.vel, s.rot, s.ang_vel, u(B, A, 2), u(B, A, 1, s=0.2),
            s.pos.new_zeros((B, len(world._dyn_gravity_names), 2)))


def jax_state_arrays(jax_state):
    """A JAX ``WorldState`` as the numpy dict that
    ``utils.state_from_numpy`` loads (``key`` and ``phys_pack`` left out)."""
    out = {f: np.asarray(getattr(jax_state, f)) for f in STATE_FIELDS}
    out["extras"] = {k: np.asarray(v) for k, v in jax_state.extras.items()}
    return out


def random_ppo_inputs(spec, nb_tot, seed):
    """Inputs of one PPO minibatch update for ``spec`` (a ``PPOUpdateSpec``
    of either package), as numpy arrays drawn from ``seed``: ``(packed_fm
    [D, nb_tot * lb], perm_mb [mb // lb] int32, adv_stats [2], params)``.
    In discrete mode every dim has 1..n_logits valid choices (at least 2
    for a flat head) and the stored action is one of them; in continuous
    mode a fifth of the action mask is 0."""
    rng = np.random.RandomState(seed)
    od, aw, H = spec.obs_d, spec.act_w, spec.hidden
    hw = spec.mask_w
    n = nb_tot * spec.lb
    packed = rng.randn(spec.d, n).astype(np.float32)
    mask0 = od + aw + 3
    if spec.discrete:
        nl = spec.n_logits
        count = rng.randint(1 if aw > 1 else 2, nl + 1, (aw, n))
        packed[mask0:] = np.where(
            np.arange(nl)[None, :, None] < count[:, None, :], 0.0, -1e9
        ).reshape(aw * nl, n)
        packed[od:od + aw] = rng.randint(0, nl, (aw, n)) % count
    else:
        packed[mask0:] = rng.rand(aw, n) > 0.2
    packed[od + aw] *= 0.3  # old log-probs near the new ones
    perm = rng.permutation(nb_tot)[: spec.mb // spec.lb].astype(np.int32)
    adv = packed[od + aw + 1].reshape(nb_tot, spec.lb)[perm].ravel()
    stats = np.array([adv.mean(), 1.0 / (adv.std() + 1e-8)], np.float32)
    shapes = ((od, H), (H, 1), (H, H), (H, 1), (H, hw), (hw, 1), (hw, 1),
              (od, H), (H, 1), (H, 1), (1, 1))
    params = [(rng.randn(*s) * 0.3).astype(np.float32) for s in shapes]
    params[6] *= 0.1  # log_std
    return packed, perm, stats, params


def planner_fields(T, S=2, has_noise=False):
    """``PlannerParams`` fields (either package's) of football's default
    pitch, for ``T`` teammates and ``S`` samples; with noise, candidate 0's
    margin is that of ``ai_decision_strength = 0.9``."""
    return dict(T=T, S=S, clamp_y=0.725, clamp_x=1.475, goal_y=0.15,
                goal_x=0.1, wall_w2=0.75, wall_l2=1.5,
                margin0=0.3 if has_noise else 0.0, has_noise=has_noise)


def random_planner_inputs(B, T, S, has_noise, seed):
    """The planner's operands as float32 numpy arrays drawn from ``seed``:
    ``(agents_pos, curr_target, samples, ball_pos, target_net_pos,
    own_net_pos, value_noise or None)``, positions over the whole pitch
    and its goal mouths, so that clamps and walls act."""
    rng = np.random.RandomState(seed)

    def u(*shape, s=1.2):
        return rng.uniform(-s, s, shape).astype(np.float32)

    agents = np.stack([u(B, T, s=1.6), u(B, T, s=0.8)], -1)
    target = np.stack([u(B, T, s=1.6), u(B, T, s=0.8)], -1)
    samples = (rng.randn(B, T, S, 2) * 0.5).astype(np.float32)
    ball = u(B, 2)
    tnet = np.tile(np.float32([[1.55, 0.0]]), (B, 1))
    onet = np.tile(np.float32([[-1.55, 0.0]]), (B, 1))
    vn = (rng.randn(B, T, S + 1) * 0.1).astype(np.float32) if has_noise else None
    return agents, target, samples, ball, tnet, onet, vn


# A planner output that moves by more than this from the plain version's
# picked another candidate; such a row must be a near tie: its candidate's
# value within PLANNER_TIE of the best value.
PLANNER_SAME = 1e-5
PLANNER_TIE = 1e-6


def planner_selection_diff(fpc, p, inputs, got):
    """``got`` [B, T, 2] (a kernel's best positions) against the plain
    version of ``fpc`` (``ops/football_policy_cuda``) on ``inputs``:
    ``(max |got - plain| over rows that select the plain version's
    candidate, rows that select another, how many of those are not near
    ties, the largest value gap of those rows)``."""
    with torch.no_grad():
        px, py, values = fpc.candidate_values_plain(p, *inputs)
        ref = fpc.best_positions_plain(p, *inputs)
    diff = (got - ref).abs().amax(-1)  # [B, T]
    flipped = diff > PLANNER_SAME
    same_err = float(diff[~flipped].max()) if bool((~flipped).any()) else 0.0
    cand = torch.stack([px, py], -1)  # [B, T, S + 1, 2]
    pick = (got[..., None, :] - cand).abs().amax(-1).argmin(-1)
    gap = values.amax(-1) - torch.gather(values, -1, pick[..., None])[..., 0]
    gap = gap[flipped]
    worst_gap = float(gap.max()) if gap.numel() else 0.0
    return (same_err, int(flipped.sum()), int((gap > PLANNER_TIE).sum()),
            worst_gap)


def random_neighbor_inputs(B, A, seed):
    """The neighbour kernel's operands as float32 numpy arrays drawn from
    ``seed``: ``(pos [B, A, 2], rot [B, A], vel [B, A, 2], dn [B, A, A])``,
    ``dn`` the mutual distances with a diagonal above the largest."""
    rng = np.random.RandomState(seed)
    pos = rng.randn(B, A, 2).astype(np.float32)
    rot = rng.uniform(-3, 3, (B, A)).astype(np.float32)
    vel = rng.randn(B, A, 2).astype(np.float32)
    diff = pos[:, :, None] - pos[:, None]
    d = np.sqrt((diff * diff).sum(-1)).astype(np.float32)
    big = d.max(axis=(1, 2), keepdims=True) + 1
    dn = np.where(np.eye(A, dtype=bool)[None], big, d).astype(np.float32)
    return pos, rot, vel, dn


# Road geometry, kernel against plain: continuous outputs within
# ROAD_ATOL + ROAD_RTOL * |ref|.  A row whose closest centre-line index
# moved is allowed only at a near tie: the kernel's index must satisfy the
# first-within-1e-5 rule on the plain version's own distances up to
# ROAD_TIE.  A flipped crossing flag is allowed only at a near touch: a
# tested segment pair with an endpoint's cross product within ROAD_TOUCH of
# 0 (about 1e-5 from the other segment's line) where the crossing test's
# other condition holds or is on its edge too.
ROAD_ATOL = ROAD_RTOL = 1e-5
ROAD_TIE = 1e-6
ROAD_TOUCH = 1e-6


def _segment_distances(point, polyline):
    """The plain version's distance from ``point [..., 2]`` to every
    segment of ``polyline [..., P, 2]``: ``[..., P - 1]``."""
    X, Y = polyline[..., 0], polyline[..., 1]
    px, py = point[..., 0, None], point[..., 1, None]
    x0, y0 = X[..., :-1], Y[..., :-1]
    dx, dy = X[..., 1:] - x0, Y[..., 1:] - y0
    lsq = dx * dx + dy * dy + 1e-8
    t = torch.clamp(((px - x0) * dx + (py - y0) * dy) / lsq, 0.0, 1.0)
    cx = x0 + dx * t - px
    cy = y0 + dy * t - py
    return torch.sqrt(cx * cx + cy * cy)


def _cross_terms(L1, L2):
    """The four cross products of ``segments_intersect`` for every pair of
    segments of ``L1 [..., N1, 2]`` and ``L2 [..., N2, 2]``: ``[..., 4,
    N1 - 1, N2 - 1]``."""
    p1, p2 = L1[..., :-1, None, :], L1[..., 1:, None, :]
    q1, q2 = L2[..., None, :-1, :], L2[..., None, 1:, :]
    s, r = q2 - q1, p2 - p1

    def cross(a, b):
        return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]

    return torch.stack([cross(s, p1 - q1), cross(s, p2 - q1),
                        cross(r, q1 - p1), cross(r, q2 - p1)], dim=-3)


def _near_touch(L1, L2):
    """[M]: whether a segment pair of row m of ``L1 [M, N1, 2]`` and ``L2
    [M, N2, 2]`` sits on the edge of the strict crossing test: one
    segment's endpoint within ROAD_TOUCH (as a cross product) of the other
    segment's line while the other condition holds or is on its edge too."""
    d1, d2, d3, d4 = _cross_terms(L1, L2).unbind(-3)
    p_edge = torch.minimum(d1.abs(), d2.abs()) <= ROAD_TOUCH
    q_edge = torch.minimum(d3.abs(), d4.abs()) <= ROAD_TOUCH
    near = (p_edge & ((d3 * d4 < 0) | q_edge)) | (q_edge & (d1 * d2 < 0))
    return near.reshape(len(L1), -1).any(-1)


def geometry_diff(tables, pos, rot, path_id, got, ref):
    """``got`` (a kernel's ``geometry_plain`` outputs) against ``ref`` (the
    plain version's) for the poses ``pos [B, A, 2]``, ``rot [B, A]`` and
    ``path_id [B, A]`` on ``tables``: a dict of the largest |got - ref| over
    the continuous outputs and over the short-term points of rows whose
    index did not move, the rows whose closest index moved and the flags
    that flipped, and ``bad``: the elements out of tolerance, the moved rows
    that are not near ties and the flipped flags that are not near
    touches."""
    with torch.no_grad():
        cont = [0, 1, 2, 3] + ([5] if len(ref) > 5 else [])
        worst, bad = 0.0, 0
        for i in cont:
            d = (got[i] - ref[i]).abs()
            worst = max(worst, float(d.max()))
            bad += int((d > ROAD_ATOL + ROAD_RTOL * ref[i].abs()).sum())
        st_moved = (got[4] != ref[4]).flatten(2).any(-1)  # [B, A]
        if bool((~st_moved).any()):
            worst = max(worst, float((got[4] - ref[4])[~st_moved].abs().max()))
        moved = int(st_moved.sum())
        if moved:
            b, a = torch.nonzero(st_moved, as_tuple=True)
            pid = path_id[b, a].long()
            center = tables.center[pid]  # [M, P, 2]
            n = tables.n_points[pid].long()
            is_loop = tables.is_loop[pid]
            dseg = _segment_distances(pos[b, a], center)  # [M, P - 1]
            j = torch.arange(dseg.shape[-1], device=dseg.device)
            real = j[None] < torch.clamp_min(n - 1, 1)[:, None]
            dist = torch.where(real, dseg, torch.inf).amin(-1)
            thr = dist + 1e-5
            inside = (dseg <= thr[:, None] + ROAD_TIE) & real
            outside_before = torch.cumprod(
                torch.cat([torch.ones_like(dseg[:, :1], dtype=torch.bool),
                           (dseg >= thr[:, None] - ROAD_TIE)[:, :-1]],
                          dim=-1).to(torch.uint8), dim=-1).bool()
            # the short-term points each index would select
            M = len(pid)
            st_all, _ = road_geometry.get_short_term_reference_path(
                center[:, None].expand(-1, len(j), -1, -1),
                j[None].expand(M, -1) + 1, tables.K,
                is_loop[:, None].expand(-1, len(j)),
                n[:, None].expand(-1, len(j)), sample_interval=tables.SI)
            same = (st_all == got[4][b, a][:, None]).flatten(2).all(-1)
            ok = (same & inside & outside_before).any(-1)
            bad += int((~ok).sum())
        flipped = 0
        if len(ref) > 5:
            vertices = ref[5]
            for i, polys in ((6, (tables.left, tables.right)),
                             (7, (tables.entry,)), (8, (tables.exit,))):
                flip = got[i] != ref[i]
                if not bool(flip.any()):
                    continue
                flipped += int(flip.sum())
                b, a = torch.nonzero(flip, as_tuple=True)
                pid = path_id[b, a].long()
                near = torch.zeros(len(b), dtype=torch.bool,
                                   device=vertices.device)
                for table in polys:
                    near |= _near_touch(vertices[b, a], table[pid])
                bad += int((~near).sum())
            flip = got[9] != ref[9]
            if bool(flip.any()):
                flipped += int(flip.sum())
                b, i, jj = torch.nonzero(flip, as_tuple=True)
                near = _near_touch(vertices[b, i], vertices[b, jj])
                bad += int((~near).sum())
    return {"max_abs_err": worst, "moved": moved, "flipped": flipped,
            "bad": bad}


def neighbor_diff(got, ref):
    """``got`` (the neighbour kernel's outputs) against ``ref`` (the plain
    version's): whether nd is bit-equal, the largest |got - ref| and the
    elements out of ROAD_ATOL + ROAD_RTOL * |ref|."""
    worst, bad = 0.0, 0
    for g, r in zip(got, ref):
        d = (g - r).abs()
        worst = max(worst, float(d.max()))
        bad += int((d > ROAD_ATOL + ROAD_RTOL * r.abs()).sum())
    return {"nd_equal": bool(torch.equal(got[0], ref[0])),
            "max_abs_err": worst, "bad": bad}


def poses_at_path_ends(tables, path_id, seed):
    """Poses ``(pos [B, A, 2], rot [B, A])`` that put each agent across its
    path's entry segment (even agents) or exit segment (odd agents), within
    0.05 of the segment's midpoint at a random heading, so that the entry
    and exit crossing tests meet hits and misses."""
    g = torch.Generator(device=path_id.device).manual_seed(seed)
    B, A = path_id.shape
    ends = torch.stack([tables.entry, tables.exit], dim=1)[path_id.long()]
    which = (torch.arange(A, device=path_id.device) % 2)[None, :, None,
                                                           None, None]
    seg = torch.gather(ends, 2, which.expand(B, A, 1, 2, 2))[:, :, 0]
    mid = (seg[:, :, 0] + seg[:, :, 1]) / 2
    pos = mid + (torch.rand((B, A, 2), generator=g, device=path_id.device)
                 - 0.5) * 0.1
    rot = (torch.rand((B, A), generator=g, device=path_id.device) - 0.5) \
        * 2 * math.pi
    return pos.contiguous(), rot.contiguous()


def poses_near_path_ends(tables, path_id, seed):
    """Poses on the centre-line vertices 2 to 5 points before each agent's
    path's last point, heading along the path, so that the short-term path
    wraps around a loop (or runs into the padding of a path that is not
    one)."""
    g = torch.Generator(device=path_id.device).manual_seed(seed)
    pid = path_id.long()
    back = torch.randint(2, 6, path_id.shape, generator=g,
                         device=path_id.device)
    idx = tables.n_points[pid].long() - back
    pos = tables.center[pid, idx]
    seg = tables.center[pid, idx + 1] - pos
    return pos.contiguous(), torch.atan2(seg[..., 1], seg[..., 0]).contiguous()
