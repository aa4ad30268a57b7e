"""The port's debug scenarios diff_drive, drone, het_mass and pollock:
replay of the reference goldens, live parity with the JAX env from one
injected state, same-seed determinism and the physics route against the
JAX package's (het_mass's per-env mass and pollock's size refuse the
kernel in both); the five dynamics models Forward, Rotation, Static,
DiffDrive and Drone one by one against the JAX package's; the LIDAR's
ray-by-ray measure; and the scenario registry against the JAX
package's."""
import importlib
import os
import sys
from types import SimpleNamespace

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
    live_parity,
    replay_golden,
    same_seed_runs,
)

import vectorizedmultiagentsimulator_tpu as vmt
from vectorizedmultiagentsimulator_tpu import dynamics as jax_dynamics
from vectorizedmultiagentsimulator_tpu_torch import dynamics

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
SCENARIOS = ["diff_drive", "drone", "het_mass", "pollock"]
B = 8
# The JAX package's step_supported: het_mass's per-env mass and pollock's
# weighted pair cost x substeps (45 entities, 5 substeps) refuse the kernel.
KERNEL_ROUTE = {"diff_drive": True, "drone": True, "het_mass": False,
                "pollock": False}

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


@pytest.mark.parametrize("scenario", ["diff_drive", "drone", "het_mass"])
def test_live_parity_with_jax(scenario):
    live_parity(jax_env(scenario), cpu_env(scenario, B, seed=1), 8)


def test_live_parity_with_jax_pollock():
    """pollock at the golden's size (3 agents, 2 lines, 2 boxes: the JAX
    step's compile at the full 45 entities takes minutes on the CPU), whose
    observations are zeros: every entity's state held each step too."""
    from torch_helpers import held_in_parity, jax_state_arrays
    from vectorizedmultiagentsimulator_tpu_torch.utils import (
        state_from_numpy,
    )

    kwargs = dict(n_agents=3, n_lines=2, n_boxes=2)
    jenv = vmt.make_env("pollock", num_envs=B, seed=0, **kwargs)
    env = cpu_env("pollock", B, seed=1, **kwargs)
    state_from_numpy(env, jax_state_arrays(jenv.state))
    rng = np.random.RandomState(0)
    for t in range(8):
        acts = [rng.uniform(-1, 1, (B, 2)).astype(np.float32)
                for _ in env.agents]
        held_in_parity(t, env.step([torch.as_tensor(a) for a in acts]),
                       jenv.step(acts))
        for f in ("pos", "vel", "rot", "ang_vel"):
            np.testing.assert_allclose(
                getattr(env.world.state, f).numpy(),
                np.asarray(getattr(jenv.state, f)), atol=1e-5 * 1.6**t,
                err_msg=f"{f} step {t}")


def _cpu_env_with_lidars(scenario, num_envs, seed=0):
    return cpu_env(scenario, num_envs, seed=seed, lidar=True)


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_same_seed_same_trajectory(scenario):
    """pollock observes its LIDARs here (its default observation is
    zeros, the same under any seed)."""
    same_seed_runs(_cpu_env_with_lidars if scenario == "pollock"
                   else cpu_env, scenario)


def _jax_world(scenario):
    """The JAX world the route is decided on: pollock's finalized without
    its first reset (which compiles for a minute at 45 entities), the
    others' after it (het_mass's per-env mass is made there)."""
    if scenario != "pollock":
        return jax_env(scenario).world
    import jax

    scenarios = importlib.import_module(
        "vectorizedmultiagentsimulator_tpu.scenarios")
    world = scenarios.load(scenario).Scenario().env_make_world(B)
    world.finalize(key=jax.random.PRNGKey(0))
    return world


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_route_matches_jax(pallas_interpret, scenario):
    """The port takes the physics kernel exactly where the JAX package's
    step_supported takes its Pallas kernel: diff_drive and drone do,
    het_mass (per-env mass) and pollock (over the size guard) do not."""
    assert cpu_env(scenario, 2).world._use_kernel == KERNEL_ROUTE[scenario]
    assert (pallas_interpret.step_supported(_jax_world(scenario))
            == KERNEL_ROUTE[scenario])


def test_pollock_lidar_ray_by_ray_equals_grouped():
    """``Lidar.measure(vectorized=False)`` (one ray cast a ray) equals the
    grouped measure to the bit on pollock with LIDARs, after steps that
    bring entities into range, and the scenario's observation is it."""
    env = cpu_env("pollock", B, seed=3, lidar=True, vectorized_lidar=False)
    for _ in range(3):
        obs = env.step(env.get_random_actions())[0]
    lidars = [a.sensors[0] for a in env.world.agents]
    grouped = [x.measure() for x in lidars]
    single = [x.measure(vectorized=False) for x in lidars]
    hits = 0
    for g, s, o in zip(grouped, single, obs):
        assert g.shape == (B, 16)
        assert torch.equal(g, s) and torch.equal(o, s)
        hits += int((g < 0.5).sum())
    assert hits > 0


def test_registry_matches_the_jax_package():
    ours = importlib.import_module(
        "vectorizedmultiagentsimulator_tpu_torch.scenarios")
    theirs = importlib.import_module(
        "vectorizedmultiagentsimulator_tpu.scenarios")
    assert sorted(ours._REGISTRY) == sorted(theirs._REGISTRY)
    assert len(ours._REGISTRY) == 41


# --------------------------------------------------------------------- #
# The dynamics models, one by one, from the same seeded numpy inputs
# --------------------------------------------------------------------- #
class _World:
    """What a dynamics model reads of its world: dt, the batch and the
    extras (Drone's state)."""

    def __init__(self, batch_dim, device=None):
        self.dt, self.batch_dim, self.device = 0.1, batch_dim, device
        self.is_finalized = True
        self.extras = {}

    def has_extra(self, key):
        return key in self.extras

    def get_extra(self, key):
        return self.extras[key]

    def set_extra(self, key, value):
        self.extras[key] = value


def _agent(xp, arrays, mass):
    state = SimpleNamespace(**{k: xp(v) for k, v in arrays.items()
                               if k != "u"}, force=None, torque=None)
    return SimpleNamespace(name="agent_0", state=state, mass=mass,
                           moment_of_inertia=0.3 * mass,
                           action=SimpleNamespace(u=xp(arrays["u"])))


MODELS = {
    "Forward": (lambda m, w: m.Forward(), 1),
    "Rotation": (lambda m, w: m.Rotation(), 1),
    "Static": (lambda m, w: m.Static(), 0),
    "DiffDrive euler": (lambda m, w: m.DiffDrive(w, integration="euler"), 2),
    "DiffDrive rk4": (lambda m, w: m.DiffDrive(w, integration="rk4"), 2),
    "Drone euler": (lambda m, w: m.Drone(w, integration="euler"), 4),
    "Drone rk4": (lambda m, w: m.Drone(w, integration="rk4"), 4),
}


@pytest.mark.parametrize("model", sorted(MODELS))
def test_dynamics_model_matches_jax(model):
    """Force, torque (and Drone's internal state, over three steps from a
    random one) of each model against the JAX package's model from the
    same random states and actions."""
    make, width = MODELS[model]
    rng = np.random.RandomState(7)
    n = 64
    arrays = {
        "pos": rng.uniform(-2, 2, (n, 2)), "rot": rng.uniform(-3, 3, (n, 1)),
        "vel": rng.uniform(-1, 1, (n, 2)),
        "ang_vel": rng.uniform(-1, 1, (n, 1)),
        "u": rng.uniform(-1, 1, (n, max(width, 1))),
    }
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    drone_state = rng.uniform(-0.3, 0.3, (n, 12)).astype(np.float32)
    agents, models = [], []
    for pkg, xp in ((dynamics, torch.as_tensor), (jax_dynamics, jnp.asarray)):
        w = _World(n)
        a = _agent(xp, arrays, mass=1.3)
        m = make(pkg, w)
        m.agent = a
        if model.startswith("Drone"):
            m.drone_state = xp(drone_state.copy())
        agents.append(a)
        models.append(m)
    steps = 3 if model.startswith("Drone") else 1
    for _ in range(steps):
        for m in models:
            m.check_and_process_action()
        for f in ("force", "torque"):
            got, ref = (getattr(a.state, f) for a in agents)
            if ref is None:
                assert got is None
                continue
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       rtol=2e-6, atol=2e-6, err_msg=f)
        if model.startswith("Drone"):
            got, ref = (m.drone_state for m in models)
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       rtol=2e-6, atol=2e-6)
            assert torch.equal(models[0].needs_reset(),
                               torch.as_tensor(np.array(
                                   models[1].needs_reset())))
