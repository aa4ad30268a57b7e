"""The port's wrappers: ``tests/test_wrappers.py``'s matrix on the port
(the same 9 scenarios crossed with continuous/discrete actions, tuple/dict
spaces and the numpy toggle; the gymnasium, gym and rllib cases, gym and
rllib through their plain fallbacks where those packages are absent), and
the wrappers' outputs held to the JAX package's wrappers from one injected
state with the same numpy actions (on balance and simple_world_comm here,
transport and navigation in ``test_torch_wrappers_parity.py``)."""
import os
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(__file__))
from torch_helpers import jax_state_arrays  # noqa: E402

import vectorizedmultiagentsimulator_tpu as vmt_jax  # noqa: E402
import vectorizedmultiagentsimulator_tpu_torch as vmt  # noqa: E402
from vectorizedmultiagentsimulator_tpu_torch.environment import (  # noqa: E402
    Wrapper,
)
from vectorizedmultiagentsimulator_tpu_torch.utils import (  # noqa: E402
    state_from_numpy,
)

# Reference TEST_SCENARIOS (test_wrappers/test_gym_wrapper.py:15-25).
TEST_SCENARIOS = [
    "balance",
    "discovery",
    "give_way",
    "joint_passage",
    "navigation",
    "passage",
    "transport",
    "waterfall",
    "simple_world_comm",
]

# Small-world overrides, as tests/test_wrappers.py has them.
_KWARGS = {
    "discovery": dict(n_agents=3, n_targets=3),
    "navigation": dict(n_agents=3),
}


def make(scenario, num_envs, **kwargs):
    return vmt.make_env(scenario, num_envs=num_envs, device="cpu", seed=0,
                        **_KWARGS.get(scenario, {}), **kwargs)


def _is_np(x):
    return isinstance(x, np.ndarray)


def _check_obs(obss, obs_shapes, dict_space, return_numpy):
    """Reference _check_obs_type (test_gym_wrapper.py:28-59): container
    type, per-agent shapes, numpy arrays or tensors on the env's device."""
    if dict_space:
        assert isinstance(obss, dict), f"expected dict, got {type(obss)}"
        items = [(obss[k], obs_shapes[k]) for k in obs_shapes]
    else:
        assert isinstance(obss, (list, tuple)), (
            f"expected list, got {type(obss)}"
        )
        items = list(zip(obss, obs_shapes))
    for obs, shape in items:
        assert tuple(obs.shape) == tuple(shape), (
            f"expected shape {shape}, got {obs.shape}"
        )
        assert _is_np(obs) == return_numpy, (
            f"return_numpy={return_numpy} but obs type is {type(obs)}"
        )
        if not return_numpy:
            assert isinstance(obs, torch.Tensor) and obs.device.type == "cpu"


def _rews_values(rews, dict_space):
    if dict_space:
        assert isinstance(rews, dict)
        return list(rews.values())
    assert isinstance(rews, (list, tuple))
    return list(rews)


def _random_actions(base, rng, dict_space, single=False):
    """Uniform numpy actions of every agent of the unwrapped env ``base``
    (ints for discrete actions): ``[num_envs, size]`` each, or ``[size]``
    with ``single``."""
    acts = {}
    for agent in base.agents:
        space = base.get_agent_action_space(agent)
        shape = (base.num_envs, base.get_agent_action_size(agent))
        if base.continuous_actions:
            a = rng.uniform(space.low, space.high, shape).astype(np.float32)
        else:
            a = rng.randint(0, space.n, shape).astype(np.int64)
        acts[agent.name] = a[0] if single else a
    return acts if dict_space else list(acts.values())


@pytest.mark.parametrize("scenario", TEST_SCENARIOS)
@pytest.mark.parametrize("continuous", [True, False])
@pytest.mark.parametrize("dict_space", [True, False])
def test_gymnasium_vec_matrix(scenario, continuous, dict_space, num_envs=3):
    gym = pytest.importorskip("gymnasium")
    return_numpy = continuous == dict_space
    max_steps = 5
    env = make(
        scenario,
        num_envs,
        continuous_actions=continuous,
        dict_spaces=dict_space,
        terminated_truncated=True,
        max_steps=max_steps,
        wrapper="gymnasium_vec",
        wrapper_kwargs={"return_numpy": return_numpy},
    )
    n_agents = env.unwrapped.n_agents
    assert len(env.observation_space) == n_agents
    assert len(env.action_space) == n_agents
    if dict_space:
        assert isinstance(env.observation_space, gym.spaces.Dict)
        assert isinstance(env.action_space, gym.spaces.Dict)
        obs_shapes = {
            k: s.shape for k, s in env.observation_space.spaces.items()
        }
    else:
        assert isinstance(env.observation_space, gym.spaces.Tuple)
        assert isinstance(env.action_space, gym.spaces.Tuple)
        obs_shapes = [s.shape for s in env.observation_space.spaces]

    obss, info = env.reset()
    _check_obs(obss, obs_shapes, dict_space, return_numpy)
    assert isinstance(info, dict)

    rng = np.random.RandomState(0)
    for _ in range(max_steps):
        actions = _random_actions(env.unwrapped, rng, dict_space)
        obss, rews, terminated, truncated, info = env.step(actions)
        _check_obs(obss, obs_shapes, dict_space, return_numpy)
        rew_values = _rews_values(rews, dict_space)
        assert len(rew_values) == n_agents
        for r in rew_values:
            assert _is_np(r) == return_numpy
            assert r.shape == (num_envs,)
        assert _is_np(terminated) == return_numpy
        assert _is_np(truncated) == return_numpy
        assert tuple(terminated.shape) == (num_envs,)
        assert tuple(truncated.shape) == (num_envs,)
        assert isinstance(info, dict)
    assert all(np.asarray(truncated)), "expected truncation at max_steps"


@pytest.mark.parametrize("scenario", TEST_SCENARIOS)
@pytest.mark.parametrize("continuous", [True, False])
def test_gymnasium_wrapper(scenario, continuous):
    gym = pytest.importorskip("gymnasium")
    dict_space = not continuous  # cover both container kinds
    env = make(
        scenario,
        1,
        continuous_actions=continuous,
        dict_spaces=dict_space,
        terminated_truncated=True,
        max_steps=5,
        wrapper="gymnasium",
    )
    space_cls = gym.spaces.Dict if dict_space else gym.spaces.Tuple
    assert isinstance(env.observation_space, space_cls)
    assert isinstance(env.action_space, space_cls)
    obs, info = env.reset(seed=0)
    n_agents = env.unwrapped.n_agents
    assert len(obs) == n_agents
    rng = np.random.RandomState(0)
    for _ in range(6):
        # Reference tests pass LIST actions even in dict-space mode
        # (test_gymnasium_wrapper.py:72-75).
        acts = _random_actions(env.unwrapped, rng, False, single=True)
        obs, rews, terminated, truncated, info = env.step(acts)
        rew_values = _rews_values(rews, dict_space)
        first = obs[0] if not dict_space else next(iter(obs.values()))
        assert isinstance(first, np.ndarray)
        assert isinstance(rew_values[0], float)
        assert isinstance(terminated, bool)
        assert isinstance(truncated, bool)
        if terminated or truncated:
            break
    assert truncated or terminated


@pytest.mark.parametrize("scenario", TEST_SCENARIOS)
def test_gym_wrapper(scenario):
    env = make(scenario, 1, max_steps=5, wrapper="gym")
    obs = env.reset()
    assert len(obs) == env.unwrapped.n_agents
    rng = np.random.RandomState(0)
    for _ in range(6):
        acts = _random_actions(env.unwrapped, rng, False, single=True)
        obs, rews, done, info = env.step(acts)
        assert isinstance(done, bool)
        if done:
            break
    assert done


def test_rllib_wrapper(scenario="simple_spread", num_envs=3):
    env = make(scenario, num_envs, wrapper="rllib")
    obs = env.vector_reset()
    assert len(obs) == num_envs
    n_agents = env.env.n_agents
    acts = [
        [np.zeros(env.env.get_agent_action_size(a)) for a in env.env.agents]
        for _ in range(num_envs)
    ]
    obs, rews, dones, infos = env.vector_step(acts)
    assert len(obs) == num_envs and len(rews) == num_envs
    assert all(isinstance(r, float) for r in rews)
    assert all("rewards" in i and len(i["rewards"]) == n_agents for i in infos)
    single = env.reset_at(1)
    assert len(single) == n_agents


def test_wrapper_enum_and_default_device():
    """``wrapper`` takes the enum or its name; without ``device`` the
    wrapped env is made on the card (an error naming ``device="cpu"``
    where there is none)."""
    env = vmt.make_env("simple_spread", 1, device="cpu", wrapper=Wrapper.GYM)
    assert type(env).__name__ == "GymWrapper"
    if not torch.cuda.is_available():
        with pytest.raises(Exception, match='device="cpu"'):
            vmt.make_env("simple_spread", 1, wrapper="gym")


# --------------------------------------------------------------------- #
# Parity with the JAX package's wrappers
# --------------------------------------------------------------------- #
def _held(got, want, t, where):
    """Outputs of one step held at ``held_in_parity``'s tolerance (atol
    1e-5 growing x1.6 a step), with their containers, types and shapes."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), where
        for k in want:
            _held(got[k], want[k], t, f"{where}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _held(g, w, t, f"{where}[{i}]")
    elif isinstance(want, (bool, np.bool_)) or (
            isinstance(want, np.ndarray) and want.dtype == bool):
        assert type(got) is type(want), (where, type(got), type(want))
        np.testing.assert_array_equal(got, want, err_msg=where)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), (where, type(got))
        assert got.shape == want.shape, (where, got.shape, want.shape)
        np.testing.assert_allclose(got, want, atol=1e-5 * 1.6**t,
                                   err_msg=where)
    else:
        assert type(got) is type(want), (where, type(got), type(want))
        np.testing.assert_allclose(got, want, atol=1e-5 * 1.6**t,
                                   err_msg=where)


def check_parity(kind, scenario, continuous=True, dict_space=False,
                 num_envs=3, n_steps=3):
    """The JAX wrapper (its env eager) and the port's, the JAX state
    carried into the port's after both reset, stepped with the same numpy
    actions; every step's outputs held by ``_held``."""
    vectorized = kind in ("gymnasium_vec", "rllib")
    num_envs = num_envs if vectorized else 1
    kwargs = dict(continuous_actions=continuous, dict_spaces=dict_space,
                  max_steps=n_steps, wrapper=kind,
                  terminated_truncated=kind.startswith("gymnasium"),
                  **_KWARGS.get(scenario, {}))
    jenv = vmt_jax.make_env(scenario, num_envs=num_envs, seed=0,
                            jit_compile=False, **kwargs)
    env = vmt.make_env(scenario, num_envs=num_envs, device="cpu", seed=0,
                       **kwargs)
    if kind == "rllib":
        jenv.vector_reset()
        env.vector_reset()
        base, jbase = env.env, jenv.env
    else:
        jenv.reset()
        env.reset()
        base, jbase = env.unwrapped, jenv.unwrapped
    state_from_numpy(base, jax_state_arrays(jbase.state))
    rng = np.random.RandomState(1)
    for t in range(n_steps):
        if kind == "rllib":
            per_agent = _random_actions(base, rng, False)
            acts = [[a[j] for a in per_agent] for j in range(num_envs)]
            got, want = env.vector_step(acts), jenv.vector_step(acts)
        else:
            acts = _random_actions(base, rng, dict_space,
                                   single=not vectorized)
            got, want = env.step(acts), jenv.step(acts)
        _held(list(got), list(want), t, f"{kind} {scenario} step {t}")


PARITY = [
    ("gymnasium_vec", "balance", True, True),
    ("gymnasium_vec", "balance", False, False),
    ("gymnasium_vec", "simple_world_comm", True, False),
    ("gymnasium_vec", "simple_world_comm", False, True),
    ("gymnasium", "simple_world_comm", True, False),
    ("gymnasium", "simple_world_comm", False, True),
    ("gym", "balance", True, False),
    ("gym", "simple_world_comm", True, False),
    ("rllib", "balance", True, False),
    ("rllib", "simple_world_comm", False, True),
]


@pytest.mark.parametrize("kind,scenario,continuous,dict_space", PARITY)
def test_wrapper_outputs_equal_the_jax_wrappers(kind, scenario, continuous,
                                                dict_space):
    if kind.startswith("gymnasium"):
        pytest.importorskip("gymnasium")
    check_parity(kind, scenario, continuous, dict_space)
