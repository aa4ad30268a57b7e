"""Plain reference of VMAS's joint_passage scenario
(``vmas/scenarios/joint_passage.py``) at its defaults: two agents joined by
a rod with a mass on it carry it through the one opening of a wall of
passages, then pose it on a goal line.  The initial state the benchmark
draws, and each step's observations, rewards and dones.

A state is a dict of batch-leading tensors: ``pos``, ``vel``, ``rot``,
``ang_vel``, ``steps`` and ``extras``, whose keys are the names under
which the port's state API (``Environment.state``) keeps the scenario's
buffers.  Entities in the configuration's order: the rod, the mass, the
goal line, four walls, fourteen passages, the two agents.
"""
from __future__ import annotations

import math

import torch

from portbench.reference import world as W

ROD, GOAL = 0, 2  # the mass is entity 1, the walls 3-6
PASSAGES = range(7, 21)
OPEN = 14  # passage 7, the opening (its slot is the wall's middle)
PASSAGE_WIDTH = 0.2
MIDDLE_ANGLE = math.pi / 2
SHAPING_KEYS = ("scenario.pos_shaping_pre", "scenario.pos_shaping_post",
                "scenario.rot_shaping_pre", "scenario.rot_shaping_post")


def line_angle_dist(angle, goal):
    """The angle between two undirected lines, in [0, pi / 2]."""
    angle = angle % math.pi
    goal = goal % math.pi
    return torch.minimum(torch.abs(angle - goal), torch.minimum(
        torch.abs(angle - (goal - math.pi)),
        torch.abs((angle - math.pi) - goal))).squeeze(-1)


def shaping(pos, rot):
    """The four shaping terms: the rod's distance to the opening and to
    the goal, its angle to the vertical and to the goal line."""
    middle = torch.full_like(rot[:, ROD], MIDDLE_ANGLE)
    return (torch.linalg.norm(pos[:, ROD] - pos[:, OPEN], dim=1),
            torch.linalg.norm(pos[:, ROD] - pos[:, GOAL], dim=1),
            line_angle_dist(rot[:, ROD], middle),
            line_angle_dist(rot[:, ROD], rot[:, GOAL]))


def initial_state(cfg: dict, num_envs: int, generator, device) -> dict:
    """The scenario's reset, drawn from ``generator``: rod and goal angles
    uniform in [-pi/2, pi/2], the rod below the wall and the goal above
    it, uniform where they fit, the rod's ends swapped at random."""
    ents = cfg["entities"]
    B = num_envs
    r = ents[-1]["radius"]  # the agents'
    half = ents[ROD]["length"] / 2
    mass_position = cfg["kwargs"]["mass_position"]

    def draw(shape):
        return torch.rand(shape, generator=generator, device=device)

    start_angle = (draw((B, 1)) - 0.5) * math.pi
    goal_angle = (draw((B, 1)) - 0.5) * math.pi
    start = half * torch.cat([torch.cos(start_angle), torch.sin(start_angle)], 1)
    goal_d = half * torch.cat([torch.cos(goal_angle), torch.sin(goal_angle)], 1)
    sx, sy = start[:, :1].abs(), start[:, 1:].abs()
    gx, gy = goal_d[:, :1].abs(), goal_d[:, 1:].abs()
    u1, u2 = draw((B, 2)), draw((B, 2))
    lo, hi = -1 + r + sx, 1 - (r + sx)
    joint_x = (lo - hi) * u1[:, :1] + hi
    lo, hi = -1 + r + sy, -2 * r - PASSAGE_WIDTH / 2 - sy
    joint_pos = torch.cat([joint_x, (lo - hi) * u1[:, 1:] + hi], 1)
    lo, hi = -1 + r + gx, 1 - (r + gx)
    goal_x = (lo - hi) * u2[:, :1] + hi
    lo, hi = 2 * r + PASSAGE_WIDTH / 2 + gy, 1 - (r + gy)
    goal_pos = torch.cat([goal_x, (lo - hi) * u2[:, 1:] + hi], 1)
    sign = torch.where(draw((B, 1)) < 0.5, 1.0, -1.0)
    a0 = joint_pos - sign * start
    a1 = joint_pos + sign * start

    wall = 1 + r
    plen = ents[PASSAGES[0]]["length"]
    fixed = torch.tensor(
        [[wall, 0.0], [0.0, wall], [-wall, 0.0], [0.0, -wall]]
        + [[-1 - r + plen / 2 + plen * k, 0.0] for k in range(len(PASSAGES))],
        device=device)
    fixed_rot = torch.tensor([math.pi / 2, 0.0, math.pi / 2, 0.0]
                             + [0.0] * len(PASSAGES), device=device)
    rod_rot = torch.atan2(a1[:, 1] - a0[:, 1], a1[:, 0] - a0[:, 0])[:, None]
    pos = torch.cat([
        ((a0 + a1) / 2)[:, None],
        (joint_pos + mass_position * start * sign)[:, None],
        goal_pos[:, None],
        fixed[None].expand(B, -1, -1),
        a0[:, None], a1[:, None]], dim=1)
    rot = torch.cat([rod_rot[:, None], torch.zeros((B, 1, 1), device=device),
                     goal_angle[:, None], fixed_rot[None, :, None].expand(B, -1, 1),
                     torch.zeros((B, 2, 1), device=device)], dim=1)
    zeros = torch.zeros(B, device=device)
    extras = dict(zip(SHAPING_KEYS, shaping(pos, rot)))
    for k in ("passed", "pos_rew", "rot_rew", "collision_rew", "energy_rew",
              "energy_expenditure", "rew"):
        extras[f"scenario.{k}"] = zeros
    for k in ("scenario.all_passed", "passage 7.is_rendering"):
        extras[k] = torch.zeros(B, dtype=torch.bool, device=device)
    for a in ("agent_0", "agent_1"):
        extras[f"{a}.pid_accum_errs"] = torch.zeros((B, 2), device=device)
        extras[f"{a}.pid_prev_err"] = torch.zeros((B, 2), device=device)
    return {"pos": pos, "vel": torch.zeros_like(pos), "rot": rot,
            "ang_vel": torch.zeros_like(rot),
            "steps": torch.zeros(B, dtype=torch.int32, device=device),
            "extras": extras}


def observe(T, state):
    """Each agent's observation ``[A, B, 10]``: its position and velocity,
    its offsets from the goal and from the opening, the goal's direction."""
    pos, vel, rot = state["pos"], state["vel"], state["rot"]
    goal_dir = torch.cat([torch.cos(rot[:, GOAL]), torch.sin(rot[:, GOAL])], 1)
    return torch.stack([
        torch.cat([pos[:, i], vel[:, i], pos[:, i] - pos[:, GOAL],
                   pos[:, i] - pos[:, OPEN], goal_dir], dim=-1)
        for i in T.agent_index])


def step(T, state: dict, actions):
    """One env step: ``(new state, obs [A, B, 10], rews [A, B], dones
    [B])``.  The shared reward: the fall of the rod's distance to the
    opening until the rod's centre has passed the wall, then of its
    distance to the goal; the fall of its angle to the vertical until both
    agents have passed, then of its angle to the goal line.  Done where
    the rod lies on the goal within 0.01 and 0.01 rad."""
    pos, vel, rot, ang_vel = W.physics_step(T, state, actions)
    ex = state["extras"]
    pre_pos, post_pos, pre_rot, post_rot = shaping(pos, rot)
    joint_passed = pos[:, ROD, 1] > 0
    all_passed = torch.all(pos[:, T.agent_index, 1] > PASSAGE_WIDTH / 2, dim=1)
    pos_rew = torch.where(joint_passed, 0.0,
                          ex["scenario.pos_shaping_pre"] - pre_pos)
    pos_rew = pos_rew + torch.where(
        joint_passed, ex["scenario.pos_shaping_post"] - post_pos, 0.0)
    rot_rew = torch.where(all_passed, 0.0,
                          ex["scenario.rot_shaping_pre"] - pre_rot)
    rot_rew = rot_rew + torch.where(
        all_passed, ex["scenario.rot_shaping_post"] - post_rot, 0.0)
    rew = pos_rew + rot_rew
    extras = dict(ex, **dict(zip(SHAPING_KEYS,
                                 (pre_pos, post_pos, pre_rot, post_rot))))
    new = dict(state, pos=pos, vel=vel, rot=rot, ang_vel=ang_vel,
               steps=state["steps"] + 1, extras=extras)
    done = (post_pos <= 0.01) & (post_rot <= 0.01)
    obs = observe(T, new)
    return new, obs, rew[None].expand(obs.shape[0], -1), done
