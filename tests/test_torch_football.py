"""The port's football scenario and its planner kernel's plain version:
held against the JAX package's planner (its jnp mirror and its Pallas
kernel in interpret mode), the kernel's source compiled as host C++, the
two football goldens, and the JAX env live at 5v5 with the red AI and with
shooting; same-seed determinism and autograd through the planner."""
import ast
import ctypes
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# The CPU tests run at small sizes, several test processes at once:
# PyTorch's intra-op threads would only contend with each other.
torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(__file__))
from torch_helpers import (
    jax_state_arrays,
    planner_fields,
    random_planner_inputs,
    strided_planner_views,
    tied_planner_inputs,
)

import vectorizedmultiagentsimulator_tpu as vmt
import vectorizedmultiagentsimulator_tpu_torch as vmt_torch
from vectorizedmultiagentsimulator_tpu.ops import football_policy_pallas as fpp
from vectorizedmultiagentsimulator_tpu_torch.ops import football_policy_cuda as fpc
from vectorizedmultiagentsimulator_tpu_torch.utils import (
    state_from_numpy,
    state_to_numpy,
)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
PLANNER_CASES = [(T, noise) for T in (1, 3, 5) for noise in (False, True)]
FIVE_A_SIDE = dict(n_blue_agents=5, n_red_agents=5)


def _torch(inputs):
    return [None if x is None else torch.as_tensor(x) for x in inputs]


# --------------------------------------------------------------------- #
# (a) The planner: plain version against the JAX package's
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("T,has_noise", PLANNER_CASES)
def test_planner_plain_matches_jax(T, has_noise, monkeypatch):
    """``best_positions_plain`` against ``best_positions_jnp`` (every row
    within 1e-6) and against the Pallas kernel in interpret mode (the rule
    of test_football_policy_pallas.py: at least 99 % of rows exactly equal,
    every row a clamped candidate).  The port takes the unscaled draws and
    scales them itself; the JAX side takes them scaled by the same fp32
    products, made here in numpy."""
    fields = planner_fields(T, has_noise=has_noise)
    scales = dict(sigma=0.55, spread=1.3, noise_scale=0.1)
    inputs = random_planner_inputs(67, T, 2, has_noise, seed=T)
    got = fpc.best_positions_plain(fpc.PlannerParams(**fields, **scales),
                                   *_torch(inputs)).numpy()
    f32 = np.float32
    scaled = list(inputs)
    scaled[2] = inputs[2] * f32(scales["sigma"]) * f32(scales["spread"])
    if has_noise:
        scaled[6] = inputs[6] * f32(scales["noise_scale"])
    jp = fpp.PlannerParams(**fields)
    j_in = [None if x is None else jnp.asarray(x) for x in scaled]
    mirror = np.asarray(fpp.best_positions_jnp(jp, *j_in))
    np.testing.assert_allclose(got, mirror, rtol=0, atol=1e-6)

    monkeypatch.setenv("VMT_PALLAS_INTERPRET", "1")
    kernel = np.asarray(fpp.fused_best_positions(jp, *j_in))
    exact = np.all(got == kernel, axis=-1)
    assert exact.mean() >= 0.99, f"selection agreement {exact.mean():.4f}"
    assert np.isfinite(got).all()
    assert np.abs(got[..., 1]).max() <= jp.clamp_y + 1e-6
    assert np.abs(got[..., 0]).max() <= jp.clamp_x + jp.goal_x + 1e-6


@pytest.fixture(scope="module")
def host_planner(tmp_path_factory):
    """``csrc/football_policy.cu`` compiled as host C++, its entry point
    bound; None without a host compiler."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        return None
    lib_path = str(tmp_path_factory.mktemp("planner") / "libplanner.so")
    subprocess.run(
        [cxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
         "-x", "c++", "-o", lib_path, fpc.SOURCE],
        check=True, timeout=60,
    )
    fn = ctypes.CDLL(lib_path).vmt_football_best_positions
    fn.argtypes = [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    return fn


def _host_run(host_planner, p, inputs):
    """The host build's best positions for ``inputs`` (CPU tensors, any of
    the views the card takes)."""
    out = torch.empty((inputs[0].shape[0], p.T, 2))
    ops = fpc.operands(p, *inputs, out)
    assert host_planner(ctypes.addressof(ops),
                        ctypes.addressof(fpc._struct(p)), None) == 0
    return out


# T 1-5, S 0-7; and S = 40, a long candidate loop.
HOST_CASES = [(T, S, noise) for T in range(1, 6) for S in range(8)
              for noise in (False, True)] + [(2, 40, False), (2, 40, True)]


@pytest.mark.parametrize("T,S,has_noise", HOST_CASES)
def test_kernel_source_on_the_host_matches_plain(host_planner, T, S,
                                                 has_noise):
    """The kernel's per-row body (the source compiled as host C++) against
    the plain version, bit for bit: random rows, rows with candidates that
    tie exactly (mirrored samples, candidates clamped to one corner), the
    draws scaled in the kernel, and curr_target, the ball and the nets as
    strided views of a stacked state."""
    if host_planner is None:
        pytest.skip("needs a host C++ compiler")
    p = fpc.PlannerParams(**planner_fields(T, S, has_noise=has_noise),
                          sigma=0.55, spread=1.3, noise_scale=0.1)
    inputs = _torch(tied_planner_inputs(
        random_planner_inputs(203, T, S, has_noise, seed=10 * T + S)))
    views = strided_planner_views(inputs)
    for x in views[1:2] + views[3:6]:
        assert not x.is_contiguous()
    ref = fpc.best_positions_plain(p, *inputs)
    got = _host_run(host_planner, p, views)
    assert torch.equal(got, ref), (got - ref).abs().max()
    assert torch.equal(fpc.best_positions_plain(p, *views), ref)


def test_planner_wrapper_on_the_cpu():
    """On CPU tensors the wrapper is the plain version and launches
    nothing; value_noise must come with has_noise and only then."""
    p = fpc.PlannerParams(**planner_fields(3))
    inputs = _torch(random_planner_inputs(8, 3, 2, False, seed=1))
    before = fpc.LAUNCHES
    got = fpc.fused_best_positions(p, *inputs)
    assert torch.equal(got, fpc.best_positions_plain(p, *inputs))
    assert fpc.LAUNCHES == before
    with pytest.raises(ValueError, match="value_noise"):
        fpc.fused_best_positions(p, *inputs[:6], torch.zeros(8, 3, 3))
    p_noise = fpc.PlannerParams(**planner_fields(3, has_noise=True))
    with pytest.raises(ValueError, match="value_noise"):
        fpc.fused_best_positions(p_noise, *inputs[:6])


def test_planner_autograd_is_the_plain_versions():
    """(f) Gradients through ``fused_best_positions`` on the CPU equal
    those through ``best_positions_plain``."""
    p = fpc.PlannerParams(**planner_fields(3, has_noise=True))
    inputs = _torch(random_planner_inputs(16, 3, 2, True, seed=2))

    def grads(fn):
        leaves = [x.clone().requires_grad_(True) for x in inputs]
        out = fn(p, *leaves)
        (out**2).sum().backward()
        return [x.grad for x in leaves]

    got, ref = grads(fpc.fused_best_positions), grads(fpc.best_positions_plain)
    for g, r in zip(got, ref):
        assert (g is None) == (r is None)
        if g is not None:
            assert torch.isfinite(g).all()
            torch.testing.assert_close(g, r, rtol=0, atol=0)
    assert got[0].abs().sum() > 0


# --------------------------------------------------------------------- #
# (b) The reference goldens
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("golden", ["football_1v1ai", "football_diff"])
def test_football_golden(golden):
    """``golden/scenario_<golden>.npz`` replayed as
    test_torch_transport.py's goldens are, with the observations and (from
    t = 1) the rewards in the divergence accounting, as
    test_scenario_parity.py does."""
    data = np.load(os.path.join(GOLDEN, f"scenario_{golden}.npz"),
                   allow_pickle=True)
    kwargs = ast.literal_eval(str(data["kwargs_json"]))
    B = data["pos"].shape[2]
    env = vmt_torch.make_env(str(data["scenario_name"]), num_envs=B,
                             device="cpu", seed=0, **kwargs)
    env.reset(seed=0)
    names = [str(n) for n in data["entity_names"]]
    mine = {e.name: e for e in env.world.entities}
    assert set(names) == set(mine)
    for i, n in enumerate(names):
        e = mine[n]
        e.set_pos(torch.as_tensor(data["pos"][0, i]))
        e.set_rot(torch.as_tensor(data["rot"][0, i]))
        e.set_vel(torch.as_tensor(data["vel"][0, i]))
        e.set_ang_vel(torch.as_tensor(data["ang_vel"][0, i]))

    sizes = [int(s) for s in data["action_sizes"]]
    assert sizes == [env.get_agent_action_size(a) for a in env.agents]
    diverged = np.zeros((B,), dtype=bool)

    def account(got, target, atol):
        bad = np.abs(got - target) > atol + 2e-3 * np.abs(target)
        return bad.any(axis=-1) if bad.ndim > 1 else bad

    for t in range(data["actions"].shape[0]):
        flat = data["actions"][t]
        acts, ofs = [], 0
        for size in sizes:
            acts.append(torch.as_tensor(flat[:, ofs:ofs + size]))
            ofs += size
        obs, rews, _, _ = env.step(acts)
        atol = min(5e-4 * 1.6**t, 0.05)
        for k in range(len(sizes)):
            diverged |= account(obs[k].numpy(), data["obs"][t + 1][k], atol)
            if t >= 1:
                diverged |= account(rews[k].numpy(), data["rew"][t][k], atol)
        for i, n in enumerate(names):
            for field in ("pos", "vel", "rot", "ang_vel"):
                got = getattr(mine[n].state, field).numpy()
                diverged |= account(got, data[field][t + 1, i], atol)
        assert diverged.mean() <= 0.25 + 1e-9, (
            f"{golden}: {diverged.sum()}/{B} envs diverged by step {t}"
        )


# --------------------------------------------------------------------- #
# (c), (d) Live parity with the JAX env
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def jax_five_a_side():
    """The JAX football env at 5v5 with the red AI, B = 4 (built once: its
    build and first step take seconds)."""
    return vmt.make_env("football", num_envs=4, seed=0, **FIVE_A_SIDE)


def _live_parity(jenv, env, n_steps, seed):
    arrays = jax_state_arrays(jenv.state)
    assert set(arrays["extras"]) == set(env.world.state.extras)
    for k, v in env.world.state.extras.items():
        assert v.numpy().dtype == arrays["extras"][k].dtype, k
    state_from_numpy(env, arrays)
    back = state_to_numpy(env)
    for f in ("pos", "vel", "u", "steps"):
        np.testing.assert_array_equal(back[f], arrays[f])

    B = env.num_envs
    rng = np.random.RandomState(seed)
    sizes = [env.get_agent_action_size(a) for a in env.agents]
    for t in range(n_steps):
        acts = [rng.uniform(-1, 1, (B, s)).astype(np.float32) for s in sizes]
        j_obs, j_rew, j_done, _ = jenv.step(acts)
        obs, rew, done, _ = env.step([torch.as_tensor(a) for a in acts])
        atol = 1e-5 * 1.6**t
        for k in range(len(sizes)):
            np.testing.assert_allclose(obs[k].numpy(), np.asarray(j_obs[k]),
                                       atol=atol, err_msg=f"obs {k} step {t}")
            np.testing.assert_allclose(rew[k].numpy(), np.asarray(j_rew[k]),
                                       atol=atol, err_msg=f"rew {k} step {t}")
        np.testing.assert_array_equal(done.numpy(), np.asarray(j_done))


def test_live_parity_five_a_side_ai(jax_five_a_side, monkeypatch):
    """(c) 5v5 with the red AI: the JAX reset state carried in, the same
    numpy actions, and one fixed array of planner samples on both sides
    (the JAX env is jitted, so its patched draw is fixed at trace time and
    serves every step); obs and rewards within 1e-5 growing x1.6 a step,
    dones exact."""
    jenv = jax_five_a_side
    z = np.random.RandomState(7).randn(4, 5, 2, 2).astype(np.float32)
    normal = jax.random.normal

    def fixed_normal(key, shape=(), dtype=jnp.float32):
        if tuple(shape) == z.shape:
            return jnp.asarray(z, dtype)
        return normal(key, shape, dtype)

    monkeypatch.setattr(jax.random, "normal", fixed_normal)
    env = vmt_torch.make_env("football", num_envs=4, device="cpu", seed=1,
                             **FIVE_A_SIDE)
    assert len(env.agents) == 5
    policy = env.scenario.red_controller
    monkeypatch.setattr(policy, "planner_normals",
                        lambda B, T: torch.as_tensor(z))
    _live_parity(jenv, env, n_steps=5, seed=0)
    # the AI moved: its targets are no longer the reset's zeros
    assert env.world.get_extra("ai_Red.agent_red_0.target_pos").abs().sum() > 0


def test_live_parity_shooting():
    """(d) ``enable_shooting=True, ai_red_agents=False``: every agent a
    policy agent with HolonomicWithRotation and 4 actions, the red actions
    flipped, kicks into the ball.  Each team's first agent starts facing the
    ball at 0.05 from it, so its kicks reach the ball from the first step."""
    kw = dict(n_blue_agents=2, n_red_agents=2, enable_shooting=True,
              ai_red_agents=False)
    jenv = vmt.make_env("football", num_envs=4, seed=0, **kw)
    env = vmt_torch.make_env("football", num_envs=4, device="cpu", seed=1,
                             **kw)
    assert all(type(a.dynamics).__name__ == "HolonomicWithRotation"
               for a in env.agents)
    names = [e.name for e in env.world.entities]
    s = jenv.state
    pos, rot = np.array(s.pos), np.array(s.rot)
    ball = names.index("Ball")
    pos[:, names.index("agent_blue_0")] = pos[:, ball] + [-0.05, 0.0]
    rot[:, names.index("agent_blue_0")] = 0.0
    pos[:, names.index("agent_red_0")] = pos[:, ball] + [0.05, 0.01]
    rot[:, names.index("agent_red_0")] = np.pi
    jenv.state = s.replace(pos=pos, rot=rot)
    _live_parity(jenv, env, n_steps=3, seed=3)
    assert env.world.get_extra("agent_blue_0.shoot_force").abs().sum() > 0


# --------------------------------------------------------------------- #
# (e) Determinism
# --------------------------------------------------------------------- #
def test_same_seed_same_trajectory(B=8, n_steps=5):
    def run(seed):
        env = vmt_torch.make_env("football", num_envs=B, device="cpu",
                                 seed=seed, **FIVE_A_SIDE)
        out = [env.reset()]
        for _ in range(n_steps):
            out.append(env.step(env.get_random_actions())[0])
        return torch.stack([torch.cat(o, dim=-1) for o in out])

    a, b, c = run(3), run(3), run(4)
    assert a.shape == (n_steps + 1, B, 5 * 88)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
