"""road_traffic on map '2' (the state-history ring and the initial-state
buffer) against the JAX package on the CPU, from one injected state.
The two packages draw different random numbers, so the settings take the
draws out: no observation noise, every collision recorded
(``probability_record=1.0``) and no replay at a step in the live parity (a step draws no replay); in the replay
test a buffer holding one row (``isb_len=1``), which every reset replays
(``probability_use_recording=1.0``).  One JAX env (a two-row buffer,
whose pointer wraps) serves both tests."""
import os
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
from torch_helpers import cpu_env, held_in_parity, jax_state_arrays

import vectorizedmultiagentsimulator_tpu as vmt
from vectorizedmultiagentsimulator_tpu_torch.utils import state_from_numpy

B = 8
BUFFERS = ("state_hist", "hist_ptr", "hist_len", "isb_buf", "isb_ptr",
           "isb_len")
# 8 vehicles: the JAX reset unrolls a placement loop an agent, whose
# compile sets most of this file's time.
MAP2 = dict(map_type="2", is_add_noise=False, n_agents=8)
# Every collision recorded at a step, every reset replaying a recorded row.
DRAWN_OUT = dict(MAP2, initial_state_buffer_size=2, probability_record=1.0,
                 probability_use_recording=1.0)


@pytest.fixture(scope="module")
def jax_map2():
    """The JAX env of both parity tests, and a copy of its first state
    (a JAX step donates the state it is given)."""
    jenv = vmt.make_env("road_traffic", num_envs=B, seed=0, **DRAWN_OUT)
    first = jax.tree_util.tree_map(np.array, jenv.state)
    return jenv, first


def restart(jenv, first):
    jenv.state = jax.tree_util.tree_map(jnp.asarray, first)


def extras(state, name):
    return np.asarray(state.extras[f"scenario.{name}"])


def held_buffers(t, env, jenv):
    """The map '2' buffers of both envs: the integer ones equal, the
    recorded states within the live parity's tolerance."""
    for name in BUFFERS:
        got = env.world.state.extras[f"scenario.{name}"].numpy()
        ref = extras(jenv.state, name)
        if got.dtype.kind == "f":
            np.testing.assert_allclose(got, ref, atol=1e-5 * 1.6**t,
                                       err_msg=f"{name} step {t}")
        else:
            np.testing.assert_array_equal(got, ref, err_msg=f"{name} step {t}")


def test_live_parity_buffers_with_jax(jax_map2):
    jenv, first = jax_map2
    restart(jenv, first)
    env = cpu_env("road_traffic", B, seed=1, **DRAWN_OUT)
    state_from_numpy(env, jax_state_arrays(jenv.state))
    held_buffers(0, env, jenv)
    rng = np.random.RandomState(0)
    for t in range(12):
        acts = [rng.uniform(-1, 1, (B, 2)).astype(np.float32)
                for _ in env.agents]
        held_in_parity(t, env.step([torch.as_tensor(a) for a in acts]),
                       jenv.step(acts))
        held_buffers(t, env, jenv)
    # Collisions were recorded, some env's pointer wrapped, and the ring
    # is full.
    assert int(env.scenario.isb_len.sum()) > 0
    assert int(env.scenario.hist_len.min()) == 10


def test_reset_replays_a_recorded_state_as_jax(jax_map2):
    """A buffer holding one row, replayed by every reset: each reset env
    takes the row's poses, velocities, path and point ids to the bit in
    both packages, the other envs keep theirs; the history ring restarts
    from the replayed state and the derived observations agree."""
    jenv, first = jax_map2
    restart(jenv, first)
    rng = np.random.RandomState(1)
    for _ in range(3):
        jenv.step([rng.uniform(-1, 1, (B, 2)).astype(np.float32)
                   for _ in range(jenv.n_agents)])
    # The state after 3 steps as the buffer's one row.
    row = np.asarray(jenv.scenario._current_snapshot())
    ext = dict(jenv.state.extras)
    ext["scenario.isb_buf"] = np.repeat(row[:, None], 2, axis=1)
    ext["scenario.isb_len"] = np.ones((B,), np.int32)
    ext["scenario.isb_ptr"] = np.zeros((B,), np.int32)
    for _ in range(2):
        jenv.step([rng.uniform(-1, 1, (B, 2)).astype(np.float32)
                   for _ in range(jenv.n_agents)])
    jenv.state = jenv.state.replace(extras={
        **jenv.state.extras,
        **{k: ext[k] for k in ("scenario.isb_buf", "scenario.isb_len",
                               "scenario.isb_ptr")}})
    env = cpu_env("road_traffic", B, seed=1, **DRAWN_OUT)
    state_from_numpy(env, jax_state_arrays(jenv.state))
    before = env.world.state.pos.clone()

    mask = np.array([True, False, True, True, False, False, True, False])
    obs = env.reset_at(torch.as_tensor(mask))
    j_obs = jenv.reset_at(mask)
    s, js, sc = env.world.state, jenv.state, env.scenario
    for f, cols in (("pos", slice(0, 2)), ("rot", slice(2, 3)),
                    ("vel", slice(3, 5))):
        got = getattr(s, f).numpy()
        np.testing.assert_array_equal(got[mask], row[mask][..., cols])
        np.testing.assert_array_equal(got, np.asarray(getattr(js, f)))
    np.testing.assert_array_equal(s.pos[~torch.as_tensor(mask)].numpy(),
                                  before[~torch.as_tensor(mask)].numpy())
    for name, col in (("path_id", 6), ("point_id", 7)):
        got = getattr(sc, name).numpy()
        np.testing.assert_array_equal(got[mask], row[mask][..., col])
        np.testing.assert_array_equal(got, extras(js, name))
    held_buffers(0, env, jenv)
    for k in range(len(obs)):
        np.testing.assert_allclose(obs[k].numpy(), np.asarray(j_obs[k]),
                                   atol=1e-5)


def test_done_query_in_reset_records_nothing():
    """The reset's done query leaves the buffers alone: recording is a
    step's (the JAX ``_done`` keeps it out of ``in_reset``), and a step
    writes the buffers in place, in the storage they had."""
    env = cpu_env("road_traffic", B, seed=2, map_type="2")
    rng = np.random.RandomState(2)
    ptrs = {k: env.world.state.extras[f"scenario.{k}"].data_ptr()
            for k in ("state_hist", "isb_buf")}
    for _ in range(12):
        env.step([torch.as_tensor(rng.uniform(-1, 1, (B, 2)).astype(
            np.float32)) for _ in env.agents])
    assert {k: env.world.state.extras[f"scenario.{k}"].data_ptr()
            for k in ptrs} == ptrs
    sc = env.scenario
    assert int(sc.isb_len.sum()) > 0
    isb = {k: getattr(sc, k).clone() for k in ("isb_buf", "isb_ptr",
                                               "isb_len")}
    hist = {k: getattr(sc, k).clone() for k in ("state_hist", "hist_ptr",
                                                "hist_len")}
    sc.done_query(in_reset=True)
    for k, v in {**isb, **hist}.items():
        assert torch.equal(getattr(sc, k), v), k
    env.reset_at(torch.tensor([True, False] * (B // 2)))
    for k, v in isb.items():
        assert torch.equal(getattr(sc, k), v), k
