"""The port's renderer: ``tests/test_render.py``'s cases on the port, and
its frames held to the JAX package's pixel for pixel from one injected
state, for every scenario with an ``extra_render`` and three without (here
and in ``test_torch_render_main.py`` and ``test_torch_render_debug.py``).
The JAX envs are built eagerly and take no step.  Also: the LIDAR rays a
frame draws with ``render_sensors`` (the JAX package's ray geoms, and the
last step's rays after ``parallel/rollout.py``), and that a frame draws no
random numbers and leaves the state as it was."""
import math
import os
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(__file__))
from torch_helpers import cpu_env, jax_state_arrays  # noqa: E402

import vectorizedmultiagentsimulator_tpu as vmt_jax  # noqa: E402
from vectorizedmultiagentsimulator_tpu_torch.render import (  # noqa: E402
    TextLine,
    Viewer,
)
from vectorizedmultiagentsimulator_tpu_torch.utils import (  # noqa: E402
    state_from_numpy,
    state_to_numpy,
)

B = 2
# The scenarios with an extra_render, and three without, in three files of
# about a minute each on one core (most of it the JAX envs' eager resets):
# kwargs that make each draw what it can (comm lines in range, shooting
# overlays) at a small size.  road_traffic's frame is 90 x 80: every
# lanelet segment is a full-canvas mask, which costs seconds at its
# 900 x 800 default.
FRAMES = {
    "transport": {},
    "simple_spread": {},
    "balance": {},
    "simple_tag": {},
    "football": dict(n_blue_agents=2, n_red_agents=2, enable_shooting=True),
    "sampling": {},
}
FRAMES_MAIN = {
    "road_traffic": dict(n_agents=4, viewer_size=(90, 80)),
    "navigation": dict(comms_range=0.6),
    "discovery": dict(n_agents=3, n_targets=3),
    "multi_give_way": dict(comms_range=0.6),
    "passage": {},
    "ball_passage": {},
    "joint_passage": {},
}
FRAMES_DEBUG = {
    "joint_passage_size": {},
    "ball_trajectory": {},
    "wind_flocking": {},
    "asym_joint": {},
    "drone": {},
    "diff_drive": {},
    "kinematic_bicycle": {},
    "line_trajectory": {},
    "circle_trajectory": {},
}


def _pair(name, **kwargs):
    """The JAX env (eager, no step) and the port's env on the CPU, the
    JAX state injected into the port's."""
    jenv = vmt_jax.make_env(name, num_envs=B, seed=0, jit_compile=False,
                            **kwargs)
    env = cpu_env(name, B, **kwargs)
    state_from_numpy(env, jax_state_arrays(jenv.state))
    return jenv, env


def check_frame(name, kwargs, env_index=1):
    """The port's frame of env ``env_index`` equals the JAX package's to
    the pixel."""
    jenv, env = _pair(name, **kwargs)
    if name == "road_traffic":
        # The JAX package colours its vehicles from numpy's global
        # generator; a colour is drawing configuration, not state.
        for jagent, agent in zip(jenv.world.agents, env.world.agents):
            agent.color = jagent.color
    want = jenv.render(mode="rgb_array", env_index=env_index)
    got = env.render(mode="rgb_array", env_index=env_index)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert got.std() > 0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_frame_equals_the_jax_frame(name):
    check_frame(name, FRAMES[name])


def test_textline_rasterizes():
    v = Viewer(200, 100)
    v.geoms.append(TextLine(text="Agent 0 sends [0.12,-0.5]", x=5, y=10))
    frame = v.render(return_rgb_array=True)
    dark = (frame < 128).all(axis=-1).sum()
    assert dark > 50


def test_textline_set_text_and_clip():
    v = Viewer(60, 30)
    t = TextLine(x=-20, y=-3)
    t.set_text("CLIPPED TEXT WIDER THAN CANVAS", font_size=20)
    v.geoms.append(t)
    frame = v.render(return_rgb_array=True)  # must not raise
    assert frame.shape == (30, 60, 3)


def test_comm_messages_rendered():
    env = cpu_env("simple_reference", 2)
    env.step(env.get_random_actions())
    frame = env.render(mode="rgb_array", env_index=0)
    assert len(env.text_lines) == sum(not a.silent for a in env.world.agents)
    assert all("sends" in t.text for t in env.text_lines)
    dark = (frame < 100).all(axis=-1).sum()
    assert dark > 100  # overlay text present in the frame


def test_make_ellipse_sector():
    from vectorizedmultiagentsimulator_tpu_torch import render as rendering

    g = rendering.make_circle(radius=0.1, angle=math.pi / 2, filled=True)
    # Partial angle -> polygon wedge closed through the centre.
    assert type(g).__name__ == "Polygon"
    assert g.points[-1] == (0.0, 0.0)
    full = rendering.make_circle(radius=0.1)
    assert type(full).__name__ == "Circle"


def test_x_to_rgb_colormap():
    from vectorizedmultiagentsimulator_tpu.utils import (
        x_to_rgb_colormap as jax_colormap,
    )
    from vectorizedmultiagentsimulator_tpu_torch.utils import (
        x_to_rgb_colormap,
    )

    x = np.linspace(0.0, 1.0, 9)
    out = x_to_rgb_colormap(x, alpha=0.5)
    assert out.shape == (9, 4)
    assert np.allclose(out[:, 3], 0.5)
    assert (out[:, :3] >= 0).all() and (out[:, :3] <= 1).all()
    np.testing.assert_array_equal(out, jax_colormap(x, alpha=0.5))


def test_render_agent_indices_and_shooting_overlay():
    from vectorizedmultiagentsimulator_tpu_torch.utils import ScenarioUtils

    env = cpu_env("football", 2, n_blue_agents=2, n_red_agents=2,
                  enable_shooting=True)
    env.step(env.get_random_actions())
    frame = env.render(mode="rgb_array", env_index=0)
    assert frame.std() > 0
    # Index labels: one per blue agent (reds and ball excluded).
    scenario = env.scenario
    geoms = ScenarioUtils.render_agent_indices(
        scenario, 0, start_from=1,
        exclude=scenario.red_agents + [scenario.ball],
    )
    assert len(geoms) == 2
    assert [g.text for g in geoms] == ["1", "2"]


def test_env_plot_function_api():
    """Public plot_function parity (reference environment.py:990-1014):
    builds a heatmap geom over explicit or viewer-derived bounds, and the
    render arguments draw it into the frame."""
    env = cpu_env("sampling", 2)

    def f(pts):  # [P, 2] -> [P]
        return np.exp(-(pts**2).sum(-1))

    geom = env.plot_function(
        f, precision=0.1, plot_range=((-1, 1), (-1, 1)),
        cmap_range=None, cmap_alpha=0.7, cmap_name="viridis",
    )
    assert geom is not None
    # With plot_range=None the viewer bounds are required: first render
    # to create them, then plot.
    plain = env.render(mode="rgb_array", env_index=0)
    geom2 = env.plot_function(
        f, precision=0.1, plot_range=None,
        cmap_range=None, cmap_alpha=1.0, cmap_name="viridis",
    )
    assert geom2 is not None
    plotted = env.render(mode="rgb_array", env_index=0,
                         plot_position_function=f,
                         plot_position_function_precision=0.1)
    assert (plotted != plain).any()


def _lidars(env):
    return [x for a in env.world.agents for x in a.sensors]


def test_lidar_ray_geoms_equal_the_jax_ones():
    """``Lidar.render``'s rays from the distances measured at the injected
    state are the JAX package's ``lidar_geoms`` from its last measurement
    there; a frame with ``render_sensors`` draws them, the default frame
    (the JAX package's) does not."""
    from vectorizedmultiagentsimulator_tpu.render import (
        lidar_geoms as jax_lidar_geoms,
    )

    jenv, env = _pair("navigation", n_agents=2)
    # The JAX LIDARs keep the measurement of their last observation: take
    # one at the injected state.
    jenv.get_from_scenario(get_observations=True, get_rewards=False,
                           get_infos=False, get_dones=False)
    env_index = 1
    for jlidar, lidar in zip(_lidars(jenv), _lidars(env)):
        meas = lidar.measure()[env_index].numpy()
        got = lidar.render(env_index, meas)
        want = jax_lidar_geoms(jlidar, env_index)
        assert len(got) == len(want) == 2 * len(lidar.angles_key)
        for g, w in zip(got, want):
            assert type(g).__name__ == type(w).__name__
            assert g.color == w.color and g.alpha == w.alpha
            for attr in ("start", "end", "center"):
                if hasattr(w, attr):
                    np.testing.assert_allclose(
                        np.asarray(getattr(g, attr), np.float64),
                        np.asarray(getattr(w, attr), np.float64),
                        rtol=0, atol=1e-6)
    plain = env.render(mode="rgb_array", env_index=env_index)
    rays = env.render(mode="rgb_array", env_index=env_index,
                      render_sensors=True)
    assert (rays != plain).any(axis=-1).sum() > 100


def test_frame_after_a_rollout_draws_the_last_steps_rays():
    """After ``parallel/rollout.py`` (its eager loop on the CPU; the graph
    on the card, which drops the LIDAR casts) a frame draws the rays of the
    last step: those of a fresh env loaded with the final state, not
    nothing and not a cast cached at the state the frame before saw."""
    from vectorizedmultiagentsimulator_tpu_torch.parallel import rollout

    env = cpu_env("navigation", B, n_agents=2)
    env.render(mode="rgb_array", env_index=0, render_sensors=True)
    rollout(env, n_steps=3)
    got = env.render(mode="rgb_array", env_index=0, render_sensors=True)
    fresh = cpu_env("navigation", B, n_agents=2, seed=5)
    state_from_numpy(fresh, state_to_numpy(env))
    want = fresh.render(mode="rgb_array", env_index=0, render_sensors=True)
    np.testing.assert_array_equal(got, want)
    plain = env.render(mode="rgb_array", env_index=0)
    assert (got != plain).any(axis=-1).sum() > 100


def test_a_frame_draws_no_random_numbers_and_writes_no_state():
    env = cpu_env("discovery", B, n_agents=3, n_targets=3)
    env.step(env.get_random_actions())
    before = state_to_numpy(env)
    rng = env.world.generator.get_state()
    env.render(mode="rgb_array", env_index=1, render_sensors=True)
    env.render(mode="rgb_array", env_index=0, agent_index_focus=1)
    assert torch.equal(env.world.generator.get_state(), rng)
    after = state_to_numpy(env)
    for f in before:
        if f == "extras":
            assert before[f].keys() == after[f].keys()
            for k in before[f]:
                np.testing.assert_array_equal(after[f][k], before[f][k])
        else:
            np.testing.assert_array_equal(after[f], before[f])
