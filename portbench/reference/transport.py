"""Plain reference of VMAS's transport scenario
(``vmas/scenarios/transport.py``) at one package: the initial state the
benchmark draws, and each step's observations, rewards and dones.

A state is a dict of batch-leading tensors: ``pos``, ``vel``, ``rot``,
``ang_vel``, ``steps`` and ``extras``, whose keys are the names under
which the port's state API (``Environment.state``) keeps the scenario's
buffers.  Entities in the configuration's order: goal, package, agents.
"""
from __future__ import annotations

import torch

from portbench.reference import world as W

GOAL, PACKAGE = 0, 1
SHAPING = "package 0.global_shaping"
ON_GOAL = "package 0.on_goal"
SHAPING_FACTOR = 100
WORLD_SEMIDIM = 1.0
# Candidates a spawn draws for each entity: the first that keeps its
# distances is taken, else the one that comes nearest to keeping them.
SPAWN_CANDIDATES = 64


def _spawn(generator, keep, n_new, min_dist, B, device):
    """Positions ``[B, n_new, 2]`` uniform in the world, each at least
    ``min_dist`` from the ones placed before it and from the positions
    of each ``(positions [B, M, 2], distance)`` of ``keep`` (VMAS's
    ``spawn_entities_randomly``, with a fixed number of candidates)."""
    placed = []
    for _ in range(n_new):
        cand = (torch.rand((B, SPAWN_CANDIDATES, 2), generator=generator,
                           device=device) * 2 - 1) * WORLD_SEMIDIM
        slack = torch.full((B, SPAWN_CANDIDATES), float("inf"),
                           device=device)
        rules = list(keep) + ([(torch.cat(placed, 1), min_dist)]
                              if placed else [])
        for others, dist in rules:
            if others.shape[1]:
                gap = W.norm(cand[:, :, None] - others[:, None])  # [B, K, M]
                slack = torch.minimum(slack, (gap - dist).amin(-1))
        ok = slack >= 0
        pick = torch.where(ok.any(1), ok.to(torch.int8).argmax(1),
                           slack.argmax(1))
        placed.append(cand[torch.arange(B, device=device), pick][:, None])
    return torch.cat(placed, dim=1)


def on_goal(T, pos, rot):
    return W.box_sphere_overlap(pos[:, PACKAGE], rot[:, PACKAGE, 0],
                                T.width[PACKAGE], T.length[PACKAGE],
                                pos[:, GOAL], T.radius[GOAL])


def initial_state(cfg: dict, num_envs: int, generator, device,
                  package_goal_dist: float = 0.0) -> dict:
    """The scenario's reset, drawn from ``generator``: agents apart by two
    radii, goal and package apart from each other and from the agents by
    the package's circumscribed radius, the goal's radius and 0.01 (goal
    and package at least ``package_goal_dist`` apart, where larger)."""
    T = W.Tables(cfg, device)
    B, ents = num_envs, cfg["entities"]
    n_agents = len(cfg["agents"])
    agent_radius = ents[T.agent_index[0]]["radius"]
    pkg = ents[PACKAGE]
    agents = _spawn(generator, [], n_agents, 2 * agent_radius, B, device)
    circ = ((pkg["length"] / 2) ** 2 + (pkg["width"] / 2) ** 2) ** 0.5
    apart = circ + ents[GOAL]["radius"] + 0.01
    goal = _spawn(generator, [(agents, apart)], 1, apart, B, device)
    pkg_pos = _spawn(generator, [(agents, apart),
                                 (goal, max(apart, package_goal_dist))],
                     1, apart, B, device)
    goal_pkg = torch.cat([goal, pkg_pos], 1)
    pos = torch.cat([goal_pkg, agents], dim=1)
    zeros = torch.zeros_like(pos)
    rot = torch.zeros((B, T.n, 1), device=device)
    dist = torch.linalg.norm(pos[:, PACKAGE] - pos[:, GOAL], dim=1)
    return {
        "pos": pos, "vel": zeros, "rot": rot, "ang_vel": torch.zeros_like(rot),
        "steps": torch.zeros(B, dtype=torch.int32, device=device),
        "extras": {
            ON_GOAL: on_goal(T, pos, rot),
            SHAPING: dist * SHAPING_FACTOR,
            "package 0.dist_to_goal": torch.zeros_like(dist),
            "scenario.rew": torch.zeros_like(dist),
        },
    }


def observe(T, state):
    """Each agent's observation ``[A, B, 11]``: its position and velocity,
    the package's offset from the goal and from the agent, the package's
    velocity and whether it is on the goal."""
    pos, vel = state["pos"], state["vel"]
    pkg = pos[:, PACKAGE]
    flag = state["extras"][ON_GOAL][:, None].to(pos.dtype)
    return torch.stack([
        torch.cat([pos[:, i], vel[:, i], pkg - pos[:, GOAL], pkg - pos[:, i],
                   vel[:, PACKAGE], flag], dim=-1)
        for i in T.agent_index])


def step(T, state: dict, actions):
    """One env step: ``(new state, obs [A, B, 11], rews [A, B], dones
    [B])``.  The reward, shared by the agents, is the fall of 100 times
    the package's distance to the goal, 0 once it is on the goal."""
    pos, vel, rot, ang_vel = W.physics_step(T, state, actions)
    dist = torch.linalg.norm(pos[:, PACKAGE] - pos[:, GOAL], dim=1)
    flag = on_goal(T, pos, rot)
    shaping = dist * SHAPING_FACTOR
    rew = torch.where(flag, torch.zeros_like(shaping),
                      state["extras"][SHAPING] - shaping)
    extras = dict(state["extras"], **{SHAPING: shaping, ON_GOAL: flag})
    new = dict(state, pos=pos, vel=vel, rot=rot, ang_vel=ang_vel,
               steps=state["steps"] + 1, extras=extras)
    obs = observe(T, new)
    return new, obs, rew[None].expand(obs.shape[0], -1), flag
