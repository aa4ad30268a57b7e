"""Helpers shared by the PyTorch port's tests and ``chip_smoke.py``.

Nothing here imports JAX, so ``chip_smoke.py`` can use it on a machine
that has PyTorch only.
"""
import contextlib
import math
import os
import re
import tempfile

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


def poses_at_cast_reach(world, origin, angles, max_range, seed, B,
                        inside=0.1):
    """Ray-cast poses ``(pos [B, N, 2], rot [B, N, 1])`` float32 numpy, on
    the edge of csrc/raycast.cu's reach test: entity ``origin`` uniform in
    [-1, 1]^2 with a random heading, and every other entity at max_range +
    its reach (a sphere's radius, half a box's diagonal, half a line's
    length) less up to ``inside`` from it, toward one of the rays of the
    base ``angles`` [R] give or take 0.3 rad, with a random heading; so
    rays meet entities near their far side, at distances just under
    max_range."""
    rng = np.random.RandomState(seed)
    N = len(world.entities)
    pos = np.zeros((B, N, 2), np.float32)
    rot = rng.uniform(-math.pi, math.pi, (B, N, 1)).astype(np.float32)
    pos[:, origin] = rng.uniform(-1.0, 1.0, (B, 2))
    for e in world.entities:
        if e.index == origin:
            continue
        shape = e.shape
        if isinstance(shape, Sphere):
            reach = shape.radius
        elif isinstance(shape, Box):
            reach = 0.5 * math.hypot(shape.length, shape.width)
        else:
            reach = 0.5 * shape.length
        d = max_range + reach - rng.uniform(0.0, inside, B)
        phi = (np.asarray(angles, np.float64)[rng.randint(len(angles), size=B)]
               + rot[:, origin, 0] + rng.uniform(-0.3, 0.3, B))
        pos[:, e.index, 0] = pos[:, origin, 0] + d * np.cos(phi)
        pos[:, e.index, 1] = pos[:, origin, 1] + d * np.sin(phi)
    return pos, rot


def jax_state_arrays(jax_state):
    """A JAX ``WorldState`` as the numpy dict that
    ``utils.state_from_numpy`` loads (``key`` and ``phys_pack`` left out)."""
    out = {f: np.asarray(getattr(jax_state, f)) for f in STATE_FIELDS}
    out["extras"] = {k: np.asarray(v) for k, v in jax_state.extras.items()}
    return out


# tests/test_scenario_parity.py's default tolerance for a golden replay:
# atol BASE growing GROWTH a step (at most 0.05), plus 2e-3 relative; a
# share of at most MAX_FRAC of the envs may leave the comparison.
GOLDEN_BASE, GOLDEN_GROWTH, GOLDEN_MAX_FRAC = 5e-4, 1.6, 0.25


def cpu_env(scenario, num_envs, seed=0, **kwargs):
    """The port's ``make_env(scenario)`` on the CPU."""
    from vectorizedmultiagentsimulator_tpu_torch import make_env

    return make_env(scenario, num_envs=num_envs, device="cpu", seed=seed,
                    **kwargs)


def replay_golden(make_env, path):
    """``tests/golden/scenario_<name>.npz`` (recorded from the reference
    simulator) replayed as ``tests/test_scenario_parity.py`` replays it:
    the recorded t=0 state injected, the recorded actions stepped, the
    states, and the observations and rewards where the file holds them
    (rewards from t = 1), held at its default tolerance with its
    divergence accounting; recorded per-entity masses (``entity_mass``)
    are injected as per-env mass.  ``make_env(scenario, num_envs,
    **kwargs)`` makes the port's env."""
    import ast

    data = np.load(path, allow_pickle=True)
    kwargs = ast.literal_eval(str(data["kwargs_json"]))
    name = (str(data["scenario_name"]) if "scenario_name" in data
            else os.path.basename(path)[len("scenario_"):-len(".npz")])
    B = data["pos"].shape[2]
    env = make_env(name, B, **kwargs)
    env.reset(seed=0)

    names = [str(n) for n in data["entity_names"]]
    mine = {e.name: e for e in env.world.entities}
    assert set(names) == set(mine), (sorted(names), sorted(mine))
    if "entity_mass" in data:
        # The reference's reset-sampled masses (het_mass), as per-env mass.
        for i, n in enumerate(names):
            mine[n].mass = torch.full((B, 1), float(data["entity_mass"][i]))
    for i, n in enumerate(names):
        e = mine[n]
        e.set_pos(torch.as_tensor(data["pos"][0, i]))
        e.set_rot(torch.as_tensor(data["rot"][0, i]))
        e.set_vel(torch.as_tensor(data["vel"][0, i]))
        e.set_ang_vel(torch.as_tensor(data["ang_vel"][0, i]))

    sizes = [int(s) for s in data["action_sizes"]]
    assert sizes == [env.get_agent_action_size(a) for a in env.agents]
    diverged = np.zeros((B,), dtype=bool)
    for t in range(data["actions"].shape[0]):
        flat = data["actions"][t]
        acts, ofs = [], 0
        for size in sizes:
            acts.append(torch.as_tensor(flat[:, ofs:ofs + size]))
            ofs += size
        obs, rews, _, _ = env.step(acts)
        atol = min(GOLDEN_BASE * GOLDEN_GROWTH**t, 0.05)

        def off(got, target):
            bad = np.abs(got - target) > atol + 2e-3 * np.abs(target)
            return bad.reshape(B, -1).any(axis=-1)

        if "obs" in data:
            for k, ref in enumerate(data["obs"][t + 1]):
                diverged |= off(obs[k].numpy(), ref)
        if "rew" in data and t >= 1:
            for k, ref in enumerate(data["rew"][t]):
                diverged |= off(rews[k].numpy().reshape(-1), ref)
        for i, n in enumerate(names):
            for field in ("pos", "vel", "rot", "ang_vel"):
                diverged |= off(getattr(mine[n].state, field).numpy(),
                                data[field][t + 1, i])
        assert diverged.mean() <= GOLDEN_MAX_FRAC + 1e-9, (
            f"{name}: {diverged.sum()}/{B} envs diverged by step {t}")
    return env


def held_in_parity(t, outputs, j_outputs, envs=None):
    """One step's observations, rewards and dones of the port's env
    (``outputs``) against the JAX env's (``j_outputs``) at atol 1e-5 growing x1.6 a step (observations
    only in ``envs``, a bool mask, where given)."""
    obs, rew, done = outputs[:3]
    j_obs, j_rew, j_done = j_outputs[:3]
    atol = 1e-5 * 1.6**t
    keep = slice(None) if envs is None else np.asarray(envs)
    for k in range(len(obs)):
        np.testing.assert_allclose(
            obs[k].numpy()[keep], np.asarray(j_obs[k])[keep], atol=atol,
            err_msg=f"obs {k} step {t}")
        np.testing.assert_allclose(
            rew[k].numpy(), np.asarray(j_rew[k]), atol=atol,
            err_msg=f"rew {k} step {t}")
    np.testing.assert_array_equal(done.numpy(), np.asarray(j_done))


def live_parity(jenv, env, n_steps, seed=0):
    """The JAX env's state carried into the port (its extras keys must be
    the port's), then both stepped with the same uniform numpy actions and
    held by ``held_in_parity`` each step."""
    from vectorizedmultiagentsimulator_tpu_torch.utils import (
        state_from_numpy,
        state_to_numpy,
    )

    arrays = jax_state_arrays(jenv.state)
    assert set(arrays["extras"]) == set(env.world.state.extras)
    state_from_numpy(env, arrays)
    back = state_to_numpy(env)
    for f in ("pos", "vel", "u", "steps"):
        np.testing.assert_array_equal(back[f], arrays[f])
    rng = np.random.RandomState(seed)
    B = env.num_envs
    sizes = [env.get_agent_action_size(a) for a in env.agents]
    for t in range(n_steps):
        acts = [rng.uniform(-1, 1, (B, s)).astype(np.float32) for s in sizes]
        held_in_parity(t,
                       env.step([torch.as_tensor(a) for a in acts]),
                       jenv.step(acts))


def same_seed_runs(make_env, scenario, B=8, n_steps=5):
    """Observations of ``n_steps`` random steps of the port's ``scenario``
    with seeds 3, 3 and 4: the first two equal to the bit, the third not."""
    def run(seed):
        env = make_env(scenario, B, seed=seed)
        out = [env.reset()]
        for _ in range(n_steps):
            out.append(env.step(env.get_random_actions())[0])
        return torch.stack([torch.cat(o, dim=-1) for o in out])

    a, b, c = run(3), run(3), run(4)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)


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


def tied_planner_inputs(inputs):
    """``random_planner_inputs``'s operands with exact ties among the
    candidates (numpy, copies).  In every third env the ball and all
    agents sit at one point on the pitch's axis (y = 0, the nets' line)
    and each sample mirrors the one before it in y: the two candidates lie
    apart but their values are equal to the bit (every term of the value is
    even in y there; the value noise is repeated likewise).  In every third
    env from the second the samples are 50x, clamped to the pitch's corners
    and edges, where candidates coincide."""
    agents, target, samples, ball, tnet, onet, vn = (
        None if x is None else x.copy() for x in inputs)
    rep = slice(0, None, 3)
    ball[rep, 1] = 0.0
    agents[rep] = ball[rep, None]
    for j in range(1, samples.shape[2]):
        samples[rep, :, j, 0] = samples[rep, :, j - 1, 0]
        samples[rep, :, j, 1] = -samples[rep, :, j - 1, 1]
        if vn is not None:
            vn[rep, :, j + 1] = vn[rep, :, j]
    samples[1::3] *= 50
    return agents, target, samples, ball, tnet, onet, vn


def strided_planner_views(inputs):
    """The planner's operands (tensors) with ``curr_target`` a view of a
    wider ``[B, T, 3]`` buffer and the ball and the nets columns of one
    stacked ``[B, 5, 2]`` state, as the scenario hands them over."""
    agents, target, samples, ball, tnet, onet, vn = inputs
    B, T = target.shape[:2]
    wide = target.new_zeros((B, T, 3))
    wide[..., :2] = target
    state = torch.stack([ball.new_zeros(B, 2), ball, tnet, onet,
                         ball.new_zeros(B, 2)], dim=1)
    return (agents, wide[..., :2], samples, state[:, 1], state[:, 2],
            state[:, 3], vn)


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


def _host_tables(tables):
    """``tables``' rows and point counts as numpy arrays: (centre, left,
    right) and (n_points, n_left, n_right)."""
    rows = [x.cpu().numpy() for x in (tables.center, tables.left,
                                      tables.right)]
    counts = [x.cpu().numpy() for x in (tables.n_points, tables.n_left,
                                        tables.n_right)]
    return rows, counts


def random_map_poses(tables, B, A, seed):
    """``(pos [B, A, 2], rot [B, A], path_id [B, A] int32)`` on ``tables``'
    device: positions uniform over the box of every real table point,
    headings uniform in [-pi, pi), path ids uniform over the paths, so
    most agents lie far from their path."""
    rows, counts = _host_tables(tables)
    real = np.concatenate([r[p, :n] for r, c in zip(rows, counts)
                           for p, n in enumerate(c)])
    lo, hi = real.min(axis=0), real.max(axis=0)
    rng = np.random.RandomState(seed)
    pos = rng.uniform(lo, hi, (B, A, 2)).astype(np.float32)
    rot = rng.uniform(-math.pi, math.pi, (B, A)).astype(np.float32)
    pid = rng.randint(0, len(counts[0]), (B, A)).astype(np.int32)
    dev = tables.center.device
    return tuple(torch.as_tensor(x, device=dev) for x in (pos, rot, pid))


# Distances from a chunk's box at which poses_at_chunk_margins puts a
# point: on the box, within the culling tolerance (1e-5 + 1e-4) and just
# beyond it.
CHUNK_OFFSETS = (0.0, 1e-6, 1e-5, 5e-5, 1e-4, 1.1e-4, 1.5e-4, 2e-4, 1e-3)


def poses_at_chunk_margins(tables, lanes, B, A, seed):
    """Poses a margin's width from a chunk's box: for each agent a random
    path, one of its rows (centre line, left or right boundary), a real
    chunk of ``lanes`` segments of it and a side of the chunk's box
    (``road_geometry_cuda.chunk_boxes``); the agent's centre (even agents)
    or one of its corners (odd agents) sits CHUNK_OFFSETS[k] outside that
    side at a random place along it, at a random heading.  Returns
    ``(pos, rot, path_id)`` as ``random_map_poses``."""
    from vectorizedmultiagentsimulator_tpu_torch.ops import (
        road_geometry_cuda,
    )

    rows, counts = _host_tables(tables)
    boxes = road_geometry_cuda.chunk_boxes(*rows, *counts, lanes)
    rng = np.random.RandomState(seed)
    half_l, half_w = tables.length / 2, tables.width / 2
    corners = np.float32([[half_l, half_w], [half_l, -half_w],
                          [-half_l, -half_w], [-half_l, half_w]])
    pos = np.zeros((B, A, 2), np.float32)
    rot = rng.uniform(-math.pi, math.pi, (B, A)).astype(np.float32)
    pid = rng.randint(0, len(counts[0]), (B, A)).astype(np.int32)
    for b in range(B):
        for a in range(A):
            p, r = pid[b, a], rng.randint(3)
            n_seg = max(int(counts[r][p]) - 1, 1)
            x0, y0, x1, y1 = boxes[p, r, rng.randint(-(-n_seg // lanes))]
            off = CHUNK_OFFSETS[rng.randint(len(CHUNK_OFFSETS))]
            u = rng.uniform()
            spot = [(x0 - off, y0 + u * (y1 - y0)),
                    (x1 + off, y0 + u * (y1 - y0)),
                    (x0 + u * (x1 - x0), y0 - off),
                    (x0 + u * (x1 - x0), y1 + off)][rng.randint(4)]
            spot = np.float32(spot)
            if a % 2:
                c, s = math.cos(rot[b, a]), math.sin(rot[b, a])
                bx, by = corners[rng.randint(4)]
                spot = spot - np.float32([bx * c - by * s, bx * s + by * c])
            pos[b, a] = spot
    dev = tables.center.device
    return tuple(torch.as_tensor(x, device=dev) for x in (pos, rot, pid))


def poses_near_self(tables, B, A, seed, min_gap=40):
    """Poses where a path passes near another part of itself: for each
    path, the two real points of one row (centre line, left or right
    boundary) at least ``min_gap`` points apart along it (around a loop)
    that lie nearest each other; each agent takes a random path and row and
    sits on the segment between those two points, at a fraction
    0.5 +- 0.05 of the way, with a random heading, so that its distances
    to two parts of the row far apart in index nearly tie.  Returns
    ``(pos, rot, path_id)`` as ``random_map_poses``."""
    rows, counts = _host_tables(tables)
    loops = tables.is_loop.cpu().numpy()
    near = {}
    for r in range(3):
        for p, n in enumerate(counts[r]):
            pts = rows[r][p, :n].astype(np.float64)
            d = np.linalg.norm(pts[:, None] - pts[None], axis=-1)
            gap = np.abs(np.arange(n)[:, None] - np.arange(n)[None])
            if loops[p]:
                gap = np.minimum(gap, n - gap)
            d[gap < min_gap] = np.inf
            i, j = np.unravel_index(np.argmin(d), d.shape)
            if np.isfinite(d[i, j]):
                near[(p, r)] = (pts[i], pts[j])
    keys = sorted(near)
    rng = np.random.RandomState(seed)
    pos = np.zeros((B, A, 2), np.float32)
    pid = np.zeros((B, A), np.int32)
    for b in range(B):
        for a in range(A):
            p, r = keys[rng.randint(len(keys))]
            u, v = near[(p, r)]
            pos[b, a] = u + (0.5 + rng.uniform(-0.05, 0.05)) * (v - u)
            pid[b, a] = p
    rot = rng.uniform(-math.pi, math.pi, (B, A)).astype(np.float32)
    dev = tables.center.device
    return tuple(torch.as_tensor(x, device=dev) for x in (pos, rot, pid))


# The device kernel each launch counter of ``ops.launch_counts`` counts:
# its name in a torch.profiler trace holds this.
KERNEL_NAMES = {
    "physics_step": "physics_step_kernel",
    "raycast": "cast_rays_kernel",
    "football_policy": "best_positions_kernel",
    "ppo_update": "ppo_update_kernel",
    "agent_geometry": "agent_geometry",
    "pair_collisions": "pair_collisions_kernel",
    "neighbor_obs": "neighbor_obs_kernel",
}


@contextlib.contextmanager
def kept_graphs():
    """CUDA graphs (``torch.cuda.CUDAGraph``) made inside keep their
    captured graph beside the instantiated one (``keep_graph=True``), so
    that ``graph_kernels`` can read them after their replays.  They are
    reset on leaving: use them only inside.  (A kept graph that the
    garbage collector destroys during a later capture invalidates that
    capture; the graphs' debug mode would keep every later graph too.)"""
    made, kept = torch.cuda.CUDAGraph, []

    class Kept(made):
        def __new__(cls, keep_graph=False):
            return super().__new__(cls, True)

        def __init__(self, keep_graph=False):
            super().__init__(True)
            kept.append(self)

    torch.cuda.CUDAGraph = Kept
    try:
        yield
    finally:
        torch.cuda.CUDAGraph = made
        torch.cuda.synchronize()
        for graph in kept:
            graph.reset()


def graph_kernels(graph) -> dict:
    """The kernel nodes of ``graph`` (made under ``kept_graphs``) counted by
    name, ``{counter: nodes}`` for each counter of KERNEL_NAMES with at
    least one, read from the graph's DOT dump (the CUDA driver API's
    ``cuGraphDebugDotPrint``, else ``CUDAGraph.debug_dump``).  A replay
    launches each node of its graph once: unlike a torch.profiler trace
    of a replay, which now and then drops a kernel's record, this is
    exact."""
    import ctypes

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "graph.dot")
        verbose = 1  # CU_GRAPH_DEBUG_DOT_FLAGS_VERBOSE
        rc = ctypes.CDLL("libcuda.so.1").cuGraphDebugDotPrint(
            ctypes.c_void_p(graph.raw_cuda_graph()), path.encode(),
            ctypes.c_uint(verbose))
        if rc or not os.path.exists(path):
            graph.debug_dump(path)
        if not os.path.exists(path):
            raise RuntimeError(
                f"no DOT dump of the graph (cuGraphDebugDotPrint returned"
                f" {rc}): was it made under kept_graphs()?")
        with open(path) as f:
            dot = f.read()
    # one chunk a node: from its definition to the next one
    nodes = re.split(r'^\s*"?graph_\d+_node_\d+"?\s*\[', dot,
                     flags=re.M)[1:]
    if not nodes:
        raise RuntimeError(f"no node in the graph's DOT dump: {dot[:400]!r}")
    counts = {k: sum(key in n for n in nodes)
              for k, key in KERNEL_NAMES.items()}
    return {k: n for k, n in counts.items() if n}


def traced_launches(fn, tries=3):
    """Run ``fn`` (on the card) under torch.profiler ``tries`` times and
    count the device kernels of each run by name: ``{counter: kernels}``
    for each counter of KERNEL_NAMES with at least one, each the most of
    its ``tries`` counts (the profiler now and then drops a kernel's
    event; it never adds one).  Unlike the wrappers' host counts, this
    sees what a CUDA graph's replay runs."""
    from torch.profiler import ProfilerActivity, profile

    counts = {}
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        for k, key in KERNEL_NAMES.items():
            counts[k] = max(counts.get(k, 0), sum(key in n for n in names))
    return {k: n for k, n in counts.items() if n}


# The scenarios of the env-batch split tests, with their kwargs: the JAX
# package's test sizes; road_traffic without its observation noise, a
# per-env draw from each rank's own stream (parallel/sharding.py), so
# that the outputs of a shard and of the global env can be equal to the
# bit.
SHARD_CASES = {
    "transport": {}, "navigation": {}, "discovery": {}, "sampling": {},
    "wind_flocking": {}, "road_traffic": dict(n_agents=4, is_add_noise=False),
    "football": {}, "joint_passage": {}, "give_way": {}, "drone": {},
}


def planner_draws(B, T, nsamples, seed=7):
    """Fixed standard normal planner samples ``[B, T, nsamples, 2]``."""
    return np.random.RandomState(seed).randn(B, T, nsamples, 2).astype(
        np.float32)


def feed_planner_draws(env, B, rows=slice(None)):
    """football: the red AI's planner of ``env`` takes rows ``rows`` of
    :func:`planner_draws` for a global batch of ``B`` every step, so that
    a shard and the global env draw the same samples for the same env."""
    policy = env.scenario.red_controller
    policy.planner_normals = lambda _, T: torch.as_tensor(
        planner_draws(B, T, policy.nsamples)[rows], device=env.device)


def _rows_of(outputs, rows):
    obs, rew, done = outputs[:3]
    return ([np.asarray(o)[rows] for o in obs],
            [np.asarray(r)[rows] for r in rew], np.asarray(done)[rows])


def shards_step_as_global(scenario, kwargs, B=8, n=2, steps=3, seed=0):
    """The port's ``scenario`` at ``B`` envs and its ``n`` in-process
    shards, stepped with the same uniform numpy actions: each shard's
    observations, rewards, dones, every state field and every extras buffer
    equal to the global env's rows to the bit, every step."""
    from vectorizedmultiagentsimulator_tpu_torch.parallel import (
        shard_environment,
    )

    env = cpu_env(scenario, B, **kwargs)
    shards = [shard_environment(env, rank=r, world_size=n) for r in range(n)]
    m = B // n
    if scenario == "football":
        feed_planner_draws(env, B)
        for r, shard in enumerate(shards):
            feed_planner_draws(shard, B, slice(r * m, (r + 1) * m))
    rng = np.random.RandomState(seed)
    sizes = [env.get_agent_action_size(a) for a in env.agents]
    for t in range(steps):
        acts = [torch.as_tensor(rng.uniform(-1, 1, (B, s)).astype(np.float32))
                for s in sizes]
        out = env.step(acts)
        g = env.world.state
        for r, shard in enumerate(shards):
            rows = slice(r * m, (r + 1) * m)
            got = _rows_of(shard.step([a[rows] for a in acts]), slice(None))
            want = _rows_of(out, rows)
            for a, b in zip(got[0] + got[1] + [got[2]],
                            want[0] + want[1] + [want[2]]):
                np.testing.assert_array_equal(a, b, err_msg=f"step {t}")
            s = shard.world.state
            for f in STATE_FIELDS:
                torch.testing.assert_close(getattr(s, f), getattr(g, f)[rows],
                                           rtol=0, atol=0, msg=f)
            assert set(s.extras) == set(g.extras)
            for k, v in s.extras.items():
                torch.testing.assert_close(v, g.extras[k][rows], rtol=0,
                                           atol=0, msg=k)


def held_as_joint_parity(t, outputs, j_outputs, diverged):
    """One step of a joint scenario held as ``tests/test_torch_joints.py``'s
    live parity holds it (``tests/test_scenario_parity.py``'s rule): obs
    and rewards within GOLDEN_BASE growing GOLDEN_GROWTH a step + 2e-3
    |ref|, at most GOLDEN_MAX_FRAC of the envs (``diverged``, updated in
    place) beyond, the dones of the others equal."""
    obs, rew, done = outputs[:3]
    j_obs, j_rew, j_done = j_outputs[:3]
    atol = GOLDEN_BASE * GOLDEN_GROWTH**t
    for got, ref in [(o.numpy(), np.asarray(j)) for o, j in zip(obs, j_obs)
                     ] + [(r.numpy()[:, None], np.asarray(j)[:, None])
                          for r, j in zip(rew, j_rew)]:
        assert np.isfinite(got).all()
        diverged |= (np.abs(got - ref) > atol + 2e-3 * np.abs(ref)).any(-1)
    assert diverged.mean() <= GOLDEN_MAX_FRAC + 1e-9, (t, diverged)
    np.testing.assert_array_equal(done.numpy()[~diverged],
                                  np.asarray(j_done)[~diverged])


def shards_match_jax(jenv, env, n=2, steps=3, seed=0, joint=False):
    """``jenv`` (the JAX package's env, its state already split by its
    ``shard_environment``) carried into the port's global ``env`` of the
    same batch, which is split into ``n`` in-process shards; both stepped
    with the same uniform numpy actions, each shard held to its rows of
    the JAX env's outputs by :func:`held_in_parity` (a ``joint`` scenario
    by :func:`held_as_joint_parity`)."""
    from vectorizedmultiagentsimulator_tpu_torch.parallel import (
        shard_environment,
    )
    from vectorizedmultiagentsimulator_tpu_torch.utils import (
        state_from_numpy,
    )

    arrays = jax_state_arrays(jenv.state)
    assert set(arrays["extras"]) == set(env.world.state.extras)
    state_from_numpy(env, arrays)
    B = env.num_envs
    m = B // n
    shards = [shard_environment(env, rank=r, world_size=n) for r in range(n)]
    if env.scenario.__class__.__module__.endswith("football"):
        for r, shard in enumerate(shards):
            feed_planner_draws(shard, B, slice(r * m, (r + 1) * m))
    rng = np.random.RandomState(seed)
    sizes = [env.get_agent_action_size(a) for a in env.agents]
    diverged = [np.zeros((m,), dtype=bool) for _ in shards]
    for t in range(steps):
        acts = [rng.uniform(-1, 1, (B, s)).astype(np.float32) for s in sizes]
        j_out = jenv.step(acts)
        for r, shard in enumerate(shards):
            rows = slice(r * m, (r + 1) * m)
            got = shard.step([torch.as_tensor(a[rows]) for a in acts])
            if joint:
                held_as_joint_parity(t, got, _rows_of(j_out, rows),
                                     diverged[r])
            else:
                held_in_parity(t, got, _rows_of(j_out, rows))


# --------------------------------------------------------------------- #
# The functional API (Environment.state, step_fn, reset_fn, reset_at_fn)
# --------------------------------------------------------------------- #
def tree_leaves(tree) -> list:
    """``(path, tensor)`` of every tensor in nested dicts, lists, tuples
    and WorldStates (a state's fields, then its extras)."""
    from vectorizedmultiagentsimulator_tpu_torch.core.state import WorldState

    if isinstance(tree, torch.Tensor):
        return [("", tree)]
    if isinstance(tree, WorldState):
        tree = dict({f: getattr(tree, f) for f in STATE_FIELDS},
                    extras=tree.extras)
    items = (tree.items() if isinstance(tree, dict) else enumerate(tree))
    return [(f"{k}/{p}", x) for k, v in items for p, x in tree_leaves(v)]


def differing_leaves(a, b) -> list:
    """The paths at which ``a`` and ``b`` (tensor trees, ``tree_leaves``)
    differ: in structure, shape, dtype or a bit (a NaN equals a NaN)."""
    la, lb = dict(tree_leaves(a)), dict(tree_leaves(b))
    bad = sorted(set(la) ^ set(lb))
    for k in la.keys() & lb.keys():
        x, y = la[k], lb[k]
        if x.shape != y.shape or x.dtype != y.dtype:
            bad.append(k)
        elif x.is_floating_point():
            if not bool(((x == y) | (x.isnan() & y.isnan())).all()):
                bad.append(k)
        elif not torch.equal(x, y):
            bad.append(k)
    return bad


def generator_at(state, device):
    """A new ``torch.Generator`` on ``device`` in ``state``."""
    g = torch.Generator(device=device)
    g.set_state(state)
    return g


def reset_mask(env, outs):
    """A step's dones (terminated or truncated with
    ``terminated_truncated``) and every third env."""
    dones = outs[2] | outs[3] if env.terminated_truncated else outs[2]
    every_third = torch.arange(env.num_envs, device=env.device) % 3 == 0
    return dones | every_third


def functional_checks(env, actions):
    """The functional API from ``env``'s current state over the action
    lists ``actions`` (one a step), raising AssertionError where:

    * ``step_fn`` (its own generator, from the world generator's state)
      or ``reset_at_fn`` (mask: the last step's dones and every third
      env) changes its input state (leaves and extras keys), or the state
      the world holds;
    * two ``step_fn`` branches with equal generator states differ;
    * ``env.state = s`` then ``env.step`` differs from the ``step_fn``
      chain (outputs, final state, generator state) or changes ``s``;
      ``env.reset_at`` differs from ``reset_at_fn``.

    Returns ``(s0, final state, outputs of each step)`` of the chain."""
    dev = env.device
    held = env.world.state
    held_copy = held.clone()
    s0 = env.state
    s0_copy = s0.clone()
    g0 = env.world.generator.get_state()
    runs = []
    for _ in range(2):
        g = generator_at(g0, dev)
        s, outs = s0, []
        for a in actions:
            s, o = env.step_fn(s, a, generator=g)
            outs.append(o)
        runs.append((s, outs, g.get_state()))
    bad = differing_leaves(s0, s0_copy)
    assert not bad, f"step_fn changed its input state: {bad}"
    bad = differing_leaves(runs[0][:2], runs[1][:2])
    assert not bad, f"two step_fn branches differ: {bad}"
    assert torch.equal(runs[0][2], runs[1][2])
    s_end, outs, g_end = runs[0]
    mask = reset_mask(env, outs[-1])
    s_end_copy = s_end.clone()
    r_state, r_outs = env.reset_at_fn(s_end, mask,
                                      generator=generator_at(g_end, dev))
    bad = differing_leaves(s_end, s_end_copy)
    assert not bad, f"reset_at_fn changed its input state: {bad}"
    assert env.world.state is held, "a functional call rebound the world"
    bad = differing_leaves(held, held_copy)
    assert not bad, f"a functional call changed the world's state: {bad}"

    env.state = s0
    env.world.generator.set_state(g0)
    eager = [env.step(a) for a in actions]
    bad = differing_leaves(eager, [list(o) for o in outs])
    assert not bad, f"env.step != step_fn: outputs {bad}"
    bad = differing_leaves(env.world.state, s_end)
    assert not bad, f"env.step != step_fn: state {bad}"
    assert torch.equal(env.world.generator.get_state(), g_end)
    bad = differing_leaves(s0, s0_copy)
    assert not bad, f"env.state = s, env.step changed s: {bad}"
    got = env.reset_at(mask, return_observations=True, return_info=True,
                       return_dones=True)
    bad = differing_leaves(got, list(r_outs))
    bad += differing_leaves(env.world.state, r_state)
    assert not bad, f"env.reset_at != reset_at_fn: {bad}"
    return s0, s_end, outs
