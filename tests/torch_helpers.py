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
    Landmark,
    Line,
    Sphere,
    World,
)
from vectorizedmultiagentsimulator_tpu_torch.utils import STATE_FIELDS


# A world the physics kernel refuses: 65 entities (no pairs) is over its
# 64-entity limit.
MANY_ENTITIES = dict(
    agents=[dict(name=f"a{i}", shape=("sphere", 0.01), collide=False)
            for i in range(65)],
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
    (no joints); returns ``(world, {name: entity})``."""
    if cfg.get("joints"):
        raise ValueError("joint configs need core/joints.py, not ported yet")
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
    world.finalize(seed=seed)
    return world, entities


def random_step_inputs(world, spread, seed):
    """Physics-step inputs ``(pos, vel, rot, ang_vel, force, torque,
    dyn_g)`` for ``world``, drawn from ``seed`` on the world's device:
    positions uniform in ``[-spread, spread]`` (so many pairs overlap),
    small random velocities and actions."""
    g = torch.Generator(device=world.device).manual_seed(seed)
    B, N, A = world.batch_dim, world._n_entities, len(world.agents)
    D = len(world._dyn_gravity_names)

    def u(*shape, lo=-1.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=g, device=world.device)

    return (
        u(B, N, 2, lo=-spread, hi=spread),
        u(B, N, 2, lo=-0.5, hi=0.5),
        u(B, N, 1, lo=-math.pi, hi=math.pi),
        u(B, N, 1, lo=-0.5, hi=0.5),
        u(B, A, 2),
        u(B, A, 1, lo=-0.2, hi=0.2),
        u(B, D, 2, lo=-0.1, hi=0.1),
    )


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
