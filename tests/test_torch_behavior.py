"""Behaviour tests of the port, each the counterpart of one of the JAX
package's, at its sizes and with the port's own envs only:

* ``tests/test_behavior_invariants.py`` (6): scripted policies of dropout
  (the closest agent alone reaches the goal; the energy trade-off),
  dispersion (exact food accounting, both reward modes), give_way (the
  scripted crossing), passage (switch at the passage) and
  reverse_transport (push from inside);
* ``tests/test_seeding.py`` (5): same seed, same reset; another seed,
  another; outside random number generators (numpy's, Python's and
  torch's global one) leave the env's stream alone; a rollout repeats;
  ``reset_at`` touches its env only;
* ``tests/test_spawning.py`` (3): the rejection spawner's separations in
  its fresh and masked-respawn modes and its one-entity wrapper, on
  occupied positions drawn from a seeded ``torch.Generator`` (the JAX
  test draws them from ``jax.random``);
* ``tests/test_dynamic_mass.py`` (2): per-env mass scales the
  acceleration; het_mass draws new masses at every reset.

All loops are bounded; reaching the bound fails the test.
"""
import os
import random
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(__file__))
from torch_helpers import cpu_env  # noqa: E402

from vectorizedmultiagentsimulator_tpu_torch.scenarios.dropout import (  # noqa: E402
    DEFAULT_ENERGY_COEFF,
)
from vectorizedmultiagentsimulator_tpu_torch.utils import (  # noqa: E402
    ScenarioUtils,
)

N_ENVS = 4


def _np(x):
    return x.detach().cpu().numpy()


def _act(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def _clamp(x, u):
    return np.clip(np.asarray(x), -u, u)


# ---------------------------------------------------------------- dropout
def _dropout_env(n_agents, energy_coeff=DEFAULT_ENERGY_COEFF):
    return cpu_env("dropout", N_ENVS, n_agents=n_agents,
                   energy_coeff=energy_coeff)


@pytest.mark.parametrize("n_agents", [1, 4])
def test_dropout_closest_agent_alone_reaches_goal(n_agents):
    """One agent (the closest) acting alone finishes with positive total
    reward, and every agent gets the same reward (obs[-3:-1] is the vector
    to the goal)."""
    env = _dropout_env(n_agents)
    obs = [_np(o) for o in env.reset()]
    u = env.agents[0].u_range
    best = int(np.argmin([np.linalg.norm(o[0, -3:-1]) for o in obs]))
    total = np.zeros(N_ENVS)
    for _ in range(300):
        actions = [_act(_clamp(obs[i][:, -3:-1], u)) if i == best
                   else torch.zeros((N_ENVS, 2)) for i in range(n_agents)]
        obs, rews, dones, _ = env.step(actions)
        obs = [_np(o) for o in obs]
        rews = [_np(r) for r in rews]
        for r in rews[1:]:
            np.testing.assert_array_equal(rews[0], r)
        total += rews[0]
        dones = _np(dones)
        assert (total[dones] > 0).all()
        if dones.any():
            return
    pytest.fail("no env finished within 300 steps")


def test_dropout_energy_tradeoff(n_agents=5, n_steps=100):
    """All 5 agents moving at once: net reward negative under the default
    energy penalty, positive with the penalty off."""

    def all_agents_total(energy_coeff):
        env = _dropout_env(n_agents, energy_coeff=energy_coeff)
        obs = env.reset()
        u = env.agents[0].u_range
        total = np.zeros(N_ENVS)
        for _ in range(n_steps):
            actions = [_act(_clamp(_np(o)[:, -3:-1], u)) for o in obs]
            obs, rews, dones, _ = env.step(actions)
            total += _np(rews[0])
            for i in np.nonzero(_np(dones))[0]:
                obs = env.reset_at(int(i))
        return float(total.mean())

    assert all_agents_total(DEFAULT_ENERGY_COEFF) < 0
    assert all_agents_total(0.0) > 0


# ------------------------------------------------------------- dispersion
@pytest.mark.parametrize("share_reward", [False, True])
def test_dispersion_exact_food_accounting(share_reward, n_agents=4):
    """Agent i greedily eats food i; at done the eaten-reward totals are
    exact: their sum over agents is n_agents (individual rewards), or every
    agent's is (shared).  Food i's relative position is obs[:, 4+3i :
    4+3i+2]."""
    env = cpu_env("dispersion", N_ENVS, n_agents=n_agents,
                  share_reward=share_reward, penalise_by_time=False)
    obs = env.reset()
    u = env.agents[0].u_range
    total = np.zeros((N_ENVS, n_agents))
    all_done = np.zeros(N_ENVS, bool)
    for _ in range(400):
        actions = [_act(_clamp(_np(obs[i])[:, 4 + 3 * i:6 + 3 * i], u))
                   for i in range(n_agents)]
        obs, rews, dones, _ = env.step(actions)
        total += np.stack([_np(r) for r in rews], axis=1)
        dones = _np(dones)
        if dones.any():
            if share_reward:
                np.testing.assert_array_equal(total[dones], float(n_agents))
            else:
                np.testing.assert_array_equal(
                    total[dones].sum(-1).astype(np.int64), n_agents)
            total[dones] = 0
            all_done |= dones
            for i in np.nonzero(dones)[0]:
                obs = env.reset_at(int(i))
        if all_done.all():
            return
    pytest.fail("not all envs finished within 400 steps")


# --------------------------------------------------------------- give_way
def test_give_way_scripted_crossing(threshold=17.0):
    """Agent 1 hugs the wall while agent 2 drives straight through: more
    than 17 of total shaping reward in every env."""
    env = cpu_env("give_way", N_ENVS, mirror_passage=False)
    obs = env.reset()
    u = env.agents[0].u_range
    total = np.zeros(N_ENVS)
    for _ in range(600):
        duck = (_np(obs[1])[:, 0] < 0).all()
        a1 = np.tile(np.asarray([u / 2, -u if duck else u], np.float32),
                     (N_ENVS, 1))
        a2 = np.tile(np.asarray([-u / 3, 0.0], np.float32), (N_ENVS, 1))
        obs, rews, dones, _ = env.step([_act(a1), _act(a2)])
        total += sum(_np(r) for r in rews)
        for i in np.nonzero(_np(dones))[0]:
            obs = env.reset_at(int(i))
        if (total > threshold).all():
            return
    pytest.fail(f"total reward {total} never exceeded {threshold}")


# ---------------------------------------------------------------- passage
def test_passage_switch_at_passage(n_agents=5):
    """Each agent heads for the passage's gap, then for its goal once
    through: every env terminates (obs[:, 4:6] is the goal vector,
    obs[:, 6:8] the gap vector)."""
    env = cpu_env("passage", N_ENVS, n_passages=1, shared_reward=True)
    obs = env.reset()
    u = env.agents[0].u_range
    switched = np.zeros((n_agents, N_ENVS), bool)
    all_done = np.zeros(N_ENVS, bool)
    for _ in range(500):
        actions = []
        for i in range(n_agents):
            o = _np(obs[i])
            to_goal, to_gap = o[:, 4:6], o[:, 6:8]
            switched[i] |= np.linalg.norm(to_gap, axis=1) <= 0.025
            actions.append(_act(np.where(switched[i][:, None],
                                         _clamp(2 * to_goal, u),
                                         _clamp(2 * to_gap, u))))
        obs, rews, dones, _ = env.step(actions)
        dones = _np(dones)
        if dones.any():
            all_done |= dones
            switched[:, dones] = False
            for i in np.nonzero(dones)[0]:
                obs = env.reset_at(int(i))
        if all_done.all():
            return
    pytest.fail("not all envs completed the passage within 500 steps")


# ------------------------------------------------------ reverse_transport
def test_reverse_transport_push_from_inside(n_agents=5):
    """Agents inside the hollow box push along goal - package (action =
    -obs[:, -2:]) until the package reaches the goal in every env."""
    env = cpu_env("reverse_transport", N_ENVS, n_agents=n_agents)
    obs = env.reset()
    u = env.agents[0].u_range
    all_done = np.zeros(N_ENVS, bool)
    for _ in range(2000):
        actions = [_act(_clamp(-_np(o)[:, -2:], u)) for o in obs]
        obs, rews, dones, _ = env.step(actions)
        dones = _np(dones)
        if dones.any():
            all_done |= dones
            for i in np.nonzero(dones)[0]:
                obs = env.reset_at(int(i))
        if all_done.all():
            return
    pytest.fail("package never reached the goal in some env")


# ---------------------------------------------------------------- seeding
def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def test_same_seed_same_reset(scenario="dispersion", num_envs=6):
    e1 = cpu_env(scenario, num_envs, seed=5)
    e2 = cpu_env(scenario, num_envs, seed=5)
    assert _same(e1.reset(seed=5), e2.reset(seed=5))


def test_different_seed_different_reset(scenario="dispersion", num_envs=6):
    env = cpu_env(scenario, num_envs, seed=5)
    o1 = env.reset(seed=5)
    o2 = env.reset(seed=6)
    assert not _same(o1, o2)


def test_external_rng_does_not_perturb(scenario="dispersion", num_envs=6):
    """numpy's, Python's and torch's global generators drawn from between
    env calls leave the env's stream (its world's ``torch.Generator``) as
    it was: the counterpart of the reference's local_seed isolation."""
    e1 = cpu_env(scenario, num_envs, seed=5)
    o1 = e1.reset(seed=7)
    a1 = e1.get_random_actions()
    s1 = e1.step(a1)

    e2 = cpu_env(scenario, num_envs, seed=5)
    o2 = e2.reset(seed=7)
    np.random.seed(123)
    np.random.rand(100)
    random.seed(55)
    random.random()
    torch.manual_seed(9)
    torch.rand(100)
    a2 = e2.get_random_actions()
    s2 = e2.step(a2)

    assert _same(o1, o2)
    assert _same(a1, a2)
    assert _same(s1[0], s2[0])


def test_rollout_deterministic(scenario="simple_tag", num_envs=4, n_steps=4):
    outs = []
    for _ in range(2):
        env = cpu_env(scenario, num_envs, seed=3)
        env.reset(seed=3)
        outs.append([env.step(env.get_random_actions())[0][0]
                     for _ in range(n_steps)])
    assert _same(outs[0], outs[1])


def test_reset_at_only_affects_index(scenario="dispersion", num_envs=6):
    env = cpu_env(scenario, num_envs, seed=1)
    env.reset(seed=1)
    for _ in range(3):
        env.step(env.get_random_actions())
    pos_before = _np(env.world.state.pos)
    env.reset_at(2)
    pos_after = _np(env.world.state.pos)
    mask = np.ones(num_envs, dtype=bool)
    mask[2] = False
    np.testing.assert_array_equal(pos_before[mask], pos_after[mask])
    assert not np.allclose(pos_before[2], pos_after[2])
    assert int(env.steps[2]) == 0
    assert (_np(env.steps)[mask] == 3).all()


# --------------------------------------------------------------- spawning
MIN_DIST = 0.2
BOUNDS = (-1.0, 1.0)


@pytest.fixture(scope="module")
def world():
    return cpu_env("dispersion", 64).world


def _uniform(shape, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(shape, generator=g) * 2.0 - 1.0


def _pairwise_ok(new, occ, i, min_dist):
    d_occ = np.linalg.norm(occ - new[i], axis=-1).min() if len(occ) else np.inf
    d_oth = min(np.linalg.norm(new[j] - new[i])
                for j in range(len(new)) if j != i)
    return min(d_occ, d_oth) >= min_dist - 1e-6


def test_fresh_spawn_separation(world):
    B, O, M = 64, 5, 6
    occupied = _uniform((B, O, 2), 0)
    pos = ScenarioUtils.find_random_positions_for_entities(
        occupied, M, world, MIN_DIST, BOUNDS, BOUNDS)
    pos, occ = _np(pos), _np(occupied)
    assert pos.shape == (B, M, 2)
    assert (np.abs(pos) <= 1.0).all()
    for b in range(B):
        for i in range(M):
            assert _pairwise_ok(pos[b], occ[b], i, MIN_DIST), (b, i)


def test_masked_respawn_keeps_unreplaced_rows(world):
    B, O, M = 64, 4, 5
    occupied = _uniform((B, O, 2), 1)
    current = _uniform((B, M, 2), 2)
    mask = torch.rand((B, M), generator=torch.Generator().manual_seed(3)) < 0.5
    new = ScenarioUtils.find_random_positions_for_entities(
        occupied, M, world, MIN_DIST, BOUNDS, BOUNDS,
        current_positions=current, replace_mask=mask)
    new, cur, m, occ = _np(new), _np(current), _np(mask), _np(occupied)
    np.testing.assert_array_equal(new[~m], cur[~m])
    for b in range(B):
        for i in range(M):
            if m[b, i]:
                assert _pairwise_ok(new[b], occ[b], i, MIN_DIST), (b, i)


def test_single_entity_wrapper(world):
    B, O = 64, 6
    occupied = _uniform((B, O, 2), 4)
    pos = ScenarioUtils.find_random_pos_for_entity(
        occupied, None, world, MIN_DIST, BOUNDS, BOUNDS)
    pos, occ = _np(pos), _np(occupied)
    assert pos.shape == (B, 1, 2)
    d = np.linalg.norm(occ - pos, axis=-1)
    assert (d.min(axis=1) >= MIN_DIST - 1e-6).all()


# ----------------------------------------------------------- dynamic mass
def test_dyn_mass_scales_acceleration():
    """The same force on masses 1, 2, 4 and 8: accelerations 1 : 1/2 :
    1/4 : 1/8."""
    env = cpu_env("het_mass", 4)
    agent = env.world.agents[0]
    agent.mass = torch.tensor([1.0, 2.0, 4.0, 8.0]).reshape(4, 1)
    env.world.agents[1].mass = torch.ones((4, 1))
    for a in env.world.agents:
        a.set_pos(torch.zeros((4, 2)), batch_index=None)
        a.set_vel(torch.zeros((4, 2)), batch_index=None)
    env.step([torch.tensor([[1.0, 0.0]]).repeat(4, 1) for _ in env.agents])
    vx = _np(agent.state.vel)[:, 0]
    np.testing.assert_allclose(vx[0] / vx[1], 2.0, rtol=1e-5)
    np.testing.assert_allclose(vx[0] / vx[2], 4.0, rtol=1e-5)
    np.testing.assert_allclose(vx[0] / vx[3], 8.0, rtol=1e-5)


def test_het_mass_resamples_on_reset():
    env = cpu_env("het_mass", 4)
    m0 = _np(env.world.agents[0].mass).copy()
    assert m0.shape == (4, 1)
    assert len(np.unique(m0.round(6))) > 1, "per-env masses should differ"
    env.reset_at(1)
    m1 = _np(env.world.agents[0].mass).copy()
    assert m1[1, 0] != m0[1, 0], "reset_at(1) must draw env 1's mass anew"
    np.testing.assert_array_equal(np.delete(m1, 1, axis=0),
                                  np.delete(m0, 1, axis=0))
    env.reset()
    m2 = _np(env.world.agents[0].mass)
    assert (m2 != m1).all(), "a full reset must draw every env's mass anew"
