"""The port's LIDAR scenarios discovery and sampling: replay of the
reference goldens, live parity with the JAX env from one injected state
(discovery through steps in which covered targets respawn), the port's
respawn on its own, same-seed determinism, the physics route against the
JAX package's, discovery's heuristic, and sampling's cells on their
edges."""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# The CPU tests run at small sizes, several test processes at once:
# PyTorch's intra-op threads would only contend with each other.
torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(__file__))
from torch_helpers import (
    cpu_env,
    held_in_parity,
    jax_state_arrays,
    live_parity,
    replay_golden,
    same_seed_runs,
)

import vectorizedmultiagentsimulator_tpu as vmt
from vectorizedmultiagentsimulator_tpu_torch.utils import state_from_numpy

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
SCENARIOS = ["discovery", "sampling"]
B = 8

_JAX_ENVS = {}


def jax_env(scenario):
    """One JAX env (B envs, seed 0) a scenario for this file: its first
    reset and step compile once."""
    if scenario not in _JAX_ENVS:
        _JAX_ENVS[scenario] = vmt.make_env(scenario, num_envs=B, seed=0)
    return _JAX_ENVS[scenario]



@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setenv("VMT_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("VMT_PALLAS_STEP", "1")
    from vectorizedmultiagentsimulator_tpu.ops import physics_pallas
    return physics_pallas


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_scenario_golden(scenario):
    """The reference's golden replayed at test_scenario_parity.py's
    tolerance; discovery's (targets_respawn=False) holds the observations
    and rewards too."""
    replay_golden(cpu_env, os.path.join(GOLDEN, f"scenario_{scenario}.npz"))


def test_sampling_live_parity_with_jax():
    live_parity(jax_env("sampling"), cpu_env("sampling", B, seed=1), 10)


def _pose_on_targets(jenv, envs):
    """In ``envs``, agents 0 and 1 just clear of target 0 on either side,
    both within covering range: the target is covered in the first
    step."""
    sc = jenv.scenario
    pos = np.array(jenv.state.pos)
    t0 = sc._targets[0].index
    a0, a1 = (a.index for a in jenv.world.agents[:2])
    pos[envs, a0] = pos[envs, t0] + [0.11, 0.0]
    pos[envs, a1] = pos[envs, t0] - [0.11, 0.0]
    jenv.state = jenv.state.replace(pos=pos)


def test_discovery_live_parity_through_respawns(n_steps=6):
    """targets_respawn=True from the JAX env's state with two agents posed
    on a target in half the envs: the covered targets agree every step,
    the rewards everywhere, the observations where no target respawned in
    the step (the two packages draw the new places from different
    streams); then the JAX env's target positions are copied into the
    port before the next step."""
    jenv = jax_env("discovery")
    env = cpu_env("discovery", B, seed=1)
    _pose_on_targets(jenv, np.arange(B // 2))
    arrays = jax_state_arrays(jenv.state)
    assert set(arrays["extras"]) == set(env.world.state.extras)
    state_from_numpy(env, arrays)
    targets = env.scenario._targets
    rng = np.random.RandomState(0)
    sizes = [env.get_agent_action_size(a) for a in env.agents]
    respawned = 0
    for t in range(n_steps):
        acts = [rng.uniform(-1, 1, (B, s)).astype(np.float32) for s in sizes]
        out = env.step([torch.as_tensor(a) for a in acts])
        j_out = jenv.step(acts)
        covered = np.asarray(jenv.state.extras["scenario.covered_targets"])
        np.testing.assert_array_equal(
            env.scenario.covered_targets.numpy(), covered)
        held_in_parity(t, out, j_out, envs=~covered.any(axis=1))
        respawned += int(covered.sum())
        j_pos = np.asarray(jenv.state.pos)
        for target in targets:
            target.set_pos(torch.tensor(j_pos[:, target.index]))
    assert respawned >= B // 2


def test_discovery_respawn_places_covered_targets(n=64):
    """The port's respawn alone: the covered targets move, inside the
    bounds, at least min_dist from every agent, from the targets kept and
    from one another; the others stay; nothing gives up."""
    env = cpu_env("discovery", n)
    sc = env.scenario
    a0, a1 = env.world.agents[:2]
    t0 = sc._targets[0]
    half = torch.arange(n) < n // 2
    for agent, side in ((a0, 1.0), (a1, -1.0)):
        pos = t0.state.pos + torch.tensor([0.11 * side, 0.0])
        agent.set_pos(torch.where(half[:, None], pos, agent.state.pos))
    before = torch.stack([t.state.pos for t in sc._targets], dim=1)
    give_ups = int(env.world.spawn_give_ups)
    env.step(env.get_random_actions())
    covered = sc.covered_targets
    assert bool(covered[half, 0].all())
    after = torch.stack([t.state.pos for t in sc._targets], dim=1)
    agents = torch.stack([a.state.pos for a in env.world.agents], dim=1)
    assert torch.equal(after[~covered], before[~covered])
    assert bool((after[covered] != before[covered]).any(dim=-1).all())
    assert bool((after.abs() <= 1.0).all())
    d = sc._min_dist_between_entities
    to_agents = torch.linalg.norm(after[:, :, None] - agents[:, None], dim=-1)
    assert bool((to_agents[covered] >= d).all())
    between = torch.linalg.norm(after[:, :, None] - after[:, None], dim=-1)
    pairs = covered[:, :, None] & ~torch.eye(sc.n_targets, dtype=torch.bool)
    assert bool((between[pairs] >= d).all())
    assert int(env.world.spawn_give_ups) == give_ups


@pytest.mark.parametrize("kwargs", [{}, dict(targets_respawn=False)])
def test_discovery_steps_at_other_kwargs(kwargs):
    """targets_respawn=False moves a covered target out of the arena for
    good (done once all are), and use_agent_lidar adds a second LIDAR
    group: one cast a group."""
    env = cpu_env("discovery", 4, use_agent_lidar=True, **kwargs)
    sc = env.scenario
    t0 = sc._targets[0]
    for agent, side in zip(env.world.agents[:2], (1.0, -1.0)):
        agent.set_pos(t0.state.pos + torch.tensor([0.11 * side, 0.0]))
    obs = env.step(env.get_random_actions())[0]
    assert obs[0].shape == (4, 31)
    groups = {id(g) for g, _ in env.world._lidar_groups.values()}
    assert len(groups) == 2
    gone = (t0.state.pos < -5).all(dim=-1)
    assert bool(gone.all()) is (not sc.targets_respawn)
    assert bool(sc.all_time_covered_targets[:, 0].all()) is (
        not sc.targets_respawn)


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_same_seed_same_trajectory(scenario):
    same_seed_runs(cpu_env, scenario)


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_route_matches_jax(pallas_interpret, scenario):
    """The port steps through the physics kernel where the JAX package's
    step_supported takes its Pallas kernel."""
    env = cpu_env(scenario, 2)
    assert env.world._use_kernel
    assert pallas_interpret.step_supported(jax_env(scenario).world)


@pytest.mark.parametrize("width", [19, 31])
def test_discovery_heuristic_matches_jax(width):
    """On observations whose LIDAR columns hold exact ties (values from a
    set of three), so argmin must pick the first of equals as jnp.argmin
    does."""
    from vectorizedmultiagentsimulator_tpu.scenarios.discovery import (
        HeuristicPolicy as JaxPolicy,
    )
    from vectorizedmultiagentsimulator_tpu_torch.scenarios.discovery import (
        HeuristicPolicy,
    )

    rng = np.random.RandomState(3)
    obs = rng.uniform(-1, 1, (64, width)).astype(np.float32)
    obs[:, 4:] = rng.choice(np.float32([0.1, 0.2, 0.35]), (64, width - 4))
    obs[:8, 4:] = np.float32(0.35)  # nothing seen: all tied
    ref = np.asarray(JaxPolicy().compute_action(obs, u_range=1.0))
    got = HeuristicPolicy().compute_action(torch.as_tensor(obs), u_range=1.0)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


def _near_edges(ulps=16):
    """fp32 positions on the grid's cell edges and up to ``ulps`` ulps to
    either side, inside the arena."""
    xs = [np.float32(-1.0 + 0.05 * np.arange(1, 40))]
    for toward in (np.float32(2), np.float32(-2)):
        x = xs[0]
        for _ in range(ulps):
            x = np.nextafter(x, toward)
            xs.append(x)
    return np.concatenate(xs)


def test_sampling_cells_on_their_edges():
    """Positions on the grid's cell edges and a few ulps either side land
    in the cells of the JAX package's jitted step (its ``sample`` under
    jax.jit marks the same cell as the port's), among them positions
    whose cell true division would move, and both read the same value."""
    import jax

    jenv = jax_env("sampling")
    jsc = jenv.scenario
    env = cpu_env("sampling", B)
    state_from_numpy(env, jax_state_arrays(jenv.state))
    sc = env.scenario
    xs = _near_edges()
    x = torch.as_tensor(xs)
    by_division = (x / torch.tensor(0.05) + 20.0).to(torch.int32)
    moved = xs[(by_division != (x * 20.0 + 20.0).to(torch.int32)).numpy()]
    assert len(moved) >= 3

    def jax_sample(pos, sampled):
        jsc.sampled = sampled
        value = jsc.sample(pos, update_sampled_flag=True)
        return value, jsc.sampled

    jitted = jax.jit(jax_sample)
    rng = np.random.RandomState(5)
    empty = np.zeros((B, 40, 40), bool)
    try:
        for k in range(6):
            pos = rng.choice(xs, (B, 2)).astype(np.float32)
            pos[:2, k % 2] = moved[rng.randint(len(moved), size=2)]
            ref, ref_sampled = jitted(pos, empty)
            sc.sampled = torch.zeros((B, 40, 40), dtype=torch.bool)
            got = sc.sample(torch.as_tensor(pos), update_sampled_flag=True)
            np.testing.assert_array_equal(sc.sampled.numpy(),
                                          np.asarray(ref_sampled))
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       rtol=1e-5, atol=1e-7)
    finally:
        jsc.sampled = jnp.zeros((B, 40, 40), bool)  # no tracer left behind
