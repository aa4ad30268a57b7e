"""The port's seven MPE scenarios beside simple_spread and
simple_speaker_listener: replay of the reference goldens, live parity
with the JAX env from one injected state (the per-env keys, secrets and
goal indices drawn at reset carried across with it), same-seed
determinism, and the physics route against the JAX package's."""
import os
import sys

import pytest
import torch

# The CPU tests run at small sizes, several test processes at once:
# PyTorch's intra-op threads would only contend with each other.
torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(__file__))
from torch_helpers import (
    cpu_env,
    live_parity,
    replay_golden,
    same_seed_runs,
)

import vectorizedmultiagentsimulator_tpu as vmt

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
SCENARIOS = ["simple", "simple_adversary", "simple_crypto", "simple_push",
             "simple_reference", "simple_tag", "simple_world_comm"]
B = 8

_JAX_ENVS = {}


def jax_env(scenario):
    """One JAX env (B envs, seed 0) a scenario for this file."""
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
    replay_golden(cpu_env, os.path.join(GOLDEN, f"scenario_{scenario}.npz"))


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_live_parity_with_jax(scenario):
    live_parity(jax_env(scenario), cpu_env(scenario, B, seed=1), 8)


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_same_seed_same_trajectory(scenario):
    same_seed_runs(cpu_env, scenario)


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_route_matches_jax(pallas_interpret, scenario):
    """The port steps through the physics kernel where the JAX package's
    step_supported takes its Pallas kernel (all seven)."""
    assert cpu_env(scenario, 2).world._use_kernel
    assert pallas_interpret.step_supported(jax_env(scenario).world)


def test_simple_tag_respawn_at_catch():
    """respawn_at_catch: the first agent's reward places a good agent that
    an adversary touches anew, at rest; the others keep their state."""
    env = cpu_env("simple_tag", 4, respawn_at_catch=True)
    sc = env.scenario
    good = sc.good_agents()[0]
    adv = sc.adversaries()[0]
    caught = torch.tensor([True, False, True, False])
    good.set_pos(torch.where(caught[:, None], adv.state.pos + 0.01,
                             good.state.pos + 5.0))
    good.set_vel(torch.ones(4, 2))
    sc.reward(env.world.agents[0])
    assert torch.equal(good.state.vel[caught], torch.zeros(2, 2))
    assert torch.equal(good.state.vel[~caught], torch.ones(2, 2))
    assert bool((good.state.pos[~caught].abs() > 2).all())
    assert bool((good.state.pos[caught].abs() <= 1).all())


@pytest.mark.parametrize("scenario,keys", [
    ("simple_crypto", ("key", "secret")),
    ("simple_reference", ("goal_index_0", "goal_index_1")),
    ("simple_adversary", ("goal_index",)),
])
def test_draws_at_reset_kept_and_redrawn(scenario, keys):
    """The per-env draws a reset makes: a masked reset keeps them where it
    does not reset (simple_crypto redraws the key and secret where it
    does; the goal indices are drawn at a full reset only)."""
    env = cpu_env(scenario, 64)
    sc = env.scenario
    before = {k: getattr(sc, k).clone() for k in keys}
    mask = torch.arange(64) < 32
    env.reset_at(mask)
    for k in keys:
        after = getattr(sc, k)
        assert torch.equal(after[~mask], before[k][~mask])
        redrawn = not torch.equal(after[mask], before[k][mask])
        assert redrawn is (scenario == "simple_crypto"), k
