"""``tests/test_heuristics.py``'s eight cases on the port, on the CPU:
each scenario's ``HeuristicPolicy`` makes measurable task progress, run
as ``examples/run_heuristic.py`` runs it (the policy on each agent's
observations, then a step)."""
import importlib
import os
import sys

import numpy as np
import torch

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(__file__))
from torch_helpers import cpu_env  # noqa: E402

from vectorizedmultiagentsimulator_tpu_torch.examples.run_heuristic import (  # noqa: E402
    run_heuristic,
)


def _policy(scenario):
    mod = importlib.import_module(
        f"vectorizedmultiagentsimulator_tpu_torch.scenarios.{scenario}"
    )
    return mod.HeuristicPolicy(continuous_action=True)


def _step(env, policy, obs, u_range=1.0):
    actions = [policy.compute_action(o, u_range=u_range) for o in obs]
    return env.step(actions)


def _rollout(env, policy, n_steps, u_range=1.0):
    obs = env.reset()
    all_obs = [obs]
    for _ in range(n_steps):
        obs, rews, dones, infos = _step(env, policy, obs, u_range)
        all_obs.append(obs)
    return all_obs, rews


def test_balance_heuristic_progress(num_envs=8, n_steps=40):
    """Package approaches the goal under the heuristic (reference
    test_scenarios/test_balance.py:33-61)."""
    env = cpu_env("balance", num_envs, seed=4)
    all_obs, _ = _rollout(env, _policy("balance"), n_steps)
    # obs[:, 8:10] is package->goal displacement
    d0 = np.linalg.norm(all_obs[0][0][:, 8:10].numpy(), axis=-1)
    d1 = np.linalg.norm(all_obs[-1][0][:, 8:10].numpy(), axis=-1)
    assert d1.mean() < d0.mean()


def test_transport_heuristic_progress(num_envs=8, n_steps=60):
    env = cpu_env("transport", num_envs, seed=4)
    policy = _policy("transport")
    obs = env.reset()
    d0 = np.linalg.norm(obs[0][:, 4:6].numpy(), axis=-1)  # package->goal
    for _ in range(n_steps):
        obs, rews, dones, infos = _step(env, policy, obs)
    d1 = np.linalg.norm(obs[0][:, 4:6].numpy(), axis=-1)
    assert d1.mean() < d0.mean()


def test_wheel_heuristic_spins_line(num_envs=8, n_steps=60):
    env = cpu_env("wheel", num_envs, seed=4)
    policy = _policy("wheel")
    obs = env.reset()
    w0 = obs[0][:, 11].mean().item()  # |ang_vel|
    for _ in range(n_steps):
        obs, rews, dones, infos = _step(env, policy, obs)
    w1 = obs[0][:, 11].mean().item()
    assert w1 > w0


def test_flocking_heuristic_runs(num_envs=4, n_steps=10):
    env = cpu_env("flocking", num_envs, seed=4, n_agents=3, n_obstacles=2)
    all_obs, rews = _rollout(env, _policy("flocking"), n_steps)
    for r in rews:
        assert torch.isfinite(r).all()


def test_navigation_heuristic_progress(num_envs=8, n_steps=50):
    env = cpu_env("navigation", num_envs, seed=4, n_agents=2)
    policy = _policy("navigation")
    obs = env.reset()

    def mean_goal_dist(obs):
        return np.mean([np.linalg.norm(o[:, 4:6].numpy(), axis=-1).mean()
                        for o in obs])

    d0 = mean_goal_dist(obs)
    for _ in range(n_steps):
        obs, rews, dones, infos = _step(env, policy, obs)
    assert mean_goal_dist(obs) < d0


def test_football_ai_advances_ball(num_envs=4, n_steps=30):
    """The scripted red AI must approach / move the ball (football AI
    integration check)."""
    env = cpu_env("football", num_envs, seed=4, n_blue_agents=1,
                  n_red_agents=2, ai_red_agents=True, ai_blue_agents=False)
    env.reset()
    ball = env.scenario.ball
    red = env.scenario.red_agents

    def min_dist_to_ball():
        return min(
            torch.linalg.norm(a.state.pos - ball.state.pos, dim=-1)
            .mean().item()
            for a in red
        )

    d0 = min_dist_to_ball()
    zero = [torch.zeros((num_envs, a.action_size)) for a in env.agents]
    for _ in range(n_steps):
        env.step(zero)
    d1 = min_dist_to_ball()
    assert d1 < d0, f"red AI never approached the ball ({d0} -> {d1})"


def test_transport_agent_never_inside_package(num_envs=4):
    """The agent drives straight INTO the package at full force and must
    never end up inside it (reference
    test_scenarios/test_transport.py:32-53; 3 resets x 60 steps)."""
    env = cpu_env("transport", num_envs, seed=0, n_agents=1)
    radius = env.agents[0].shape.radius
    u_range = env.agents[0].u_range
    obs = env.reset()
    for _ in range(3):
        for _ in range(60):
            rel = obs[0][:, 6:8].numpy()  # package - agent
            dist = np.linalg.norm(rel, axis=-1)
            assert (dist > radius).all(), "agent center entered the package"
            act = np.clip(rel, -u_range, u_range)
            act = act / np.linalg.norm(act, axis=-1, keepdims=True) * u_range
            obs, rews, dones, infos = env.step(
                [torch.as_tensor(act, dtype=torch.float32)])
        obs = env.reset()


def test_discovery_respawns_covered_targets(num_envs=4):
    """Covering a target (agents_per_target agents within covering_range)
    respawns it elsewhere and pays the covering reward (reference
    discovery.py:182-206)."""
    env = cpu_env("discovery", num_envs, seed=0, n_agents=3, n_targets=2,
                  agents_per_target=2)
    env.reset()
    targets = [e for e in env.world.landmarks if e.name.startswith("target")]
    t0 = targets[0].state.pos.clone()
    t1 = targets[1].state.pos.clone()
    # Two agents inside covering_range (0.25) of target 0, far enough apart
    # (0.16 > 2 x agent radius) not to collide out of range.
    offset = torch.tensor([0.08, 0.0])
    env.world.agents[0].set_pos(t0 + offset, batch_index=None)
    env.world.agents[1].set_pos(t0 - offset, batch_index=None)
    env.world.agents[2].set_pos(torch.full((num_envs, 2), 0.9),
                                batch_index=None)
    acts = [torch.zeros((num_envs, 2)) for _ in env.agents]
    obs, rews, dones, infos = env.step(acts)
    moved = torch.linalg.norm(targets[0].state.pos - t0, dim=-1)
    assert (moved > 0.1).all(), "covered target must respawn elsewhere"
    assert (rews[0] > 0).all()
    # The uncovered target stays put.
    assert torch.equal(targets[1].state.pos, t1)


def test_run_heuristic_drives_each_heuristic():
    """``run_heuristic`` with each scenario's heuristic: a finite average
    reward."""
    for scenario, kwargs in (("balance", {}), ("transport", {}),
                             ("wheel", {}), ("navigation", dict(n_agents=2)),
                             ("discovery", dict(n_agents=3, n_targets=2)),
                             ("flocking", dict(n_agents=3, n_obstacles=2))):
        mod = importlib.import_module(
            f"vectorizedmultiagentsimulator_tpu_torch.scenarios.{scenario}")
        total = run_heuristic(scenario, mod.HeuristicPolicy, n_steps=5,
                              n_envs=4, env_kwargs=kwargs, device="cpu")
        assert np.isfinite(total), scenario
