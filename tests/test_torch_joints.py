"""The port's joints: the constraint solve of ``World._step_core`` against
the JAX package's, the physics kernel's route for joint worlds against the
JAX kernel's, the kernel source compiled as host C++ against the plain
version, the six joint scenarios against their reference goldens and live
against the JAX envs, the velocity controller, and gradients."""
import ast
import ctypes
import functools
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
from physics_configs import CONFIGS
from torch_helpers import (
    JOINTS_STATIC_ROTATION,
    build_world,
    jax_state_arrays,
    jittered_inputs,
    physics_diff,
    posed_step_inputs,
    random_step_inputs,
)

import vectorizedmultiagentsimulator_tpu as vmt
import vectorizedmultiagentsimulator_tpu_torch as vmt_torch
from vectorizedmultiagentsimulator_tpu import core as jcore
from vectorizedmultiagentsimulator_tpu_torch.ops import physics_cuda
from vectorizedmultiagentsimulator_tpu_torch.utils import state_from_numpy

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")

# test_scenario_parity.py's tolerances: _STIFF for the stiff joint worlds,
# _DEFAULT for the rest.
_STIFF = {
    "asym_joint": dict(base=3e-3, growth=2.2, max_steps=4, max_frac=0.5),
    "ball_trajectory": dict(base=3e-3, growth=2.2, max_steps=2, max_frac=0.5),
    "buzz_wire": dict(base=3e-3, growth=2.2, max_steps=4, max_frac=0.5),
}
_DEFAULT = dict(base=5e-4, growth=1.6, max_steps=10**9, max_frac=0.25)
JOINT_SCENARIOS = ["asym_joint", "ball_trajectory", "buzz_wire",
                   "joint_passage", "joint_passage_size", "waterfall"]


@pytest.mark.parametrize("scenario", JOINT_SCENARIOS)
def test_scenario_golden(scenario):
    """``golden/scenario_<name>.npz`` replayed as ``test_scenario_parity``
    does: the recorded t=0 state injected agents first (so that the joint
    observers pose the joint landmarks before they get their recorded
    pose), the recorded actions stepped, states compared with its
    divergence accounting and tolerances."""
    data = np.load(os.path.join(GOLDEN, f"scenario_{scenario}.npz"),
                   allow_pickle=True)
    kwargs = ast.literal_eval(str(data["kwargs_json"]))
    B = data["pos"].shape[2]
    env = vmt_torch.make_env(scenario, num_envs=B, device="cpu", seed=0,
                             **kwargs)
    env.reset(seed=0)

    names = [str(n) for n in data["entity_names"]]
    mine = {e.name: e for e in env.world.entities}
    assert set(names) == set(mine)
    agent_names = {a.name for a in env.world.agents}
    ordered = [n for n in names if n in agent_names] + [
        n for n in names if n not in agent_names]
    for n in ordered:
        e, i = mine[n], names.index(n)
        e.set_pos(torch.as_tensor(data["pos"][0, i]))
        e.set_rot(torch.as_tensor(data["rot"][0, i]))
        e.set_vel(torch.as_tensor(data["vel"][0, i]))
        e.set_ang_vel(torch.as_tensor(data["ang_vel"][0, i]))
    for i, n in enumerate(names):
        np.testing.assert_allclose(mine[n].state.pos.numpy(),
                                   data["pos"][0, i], atol=1e-6,
                                   err_msg=f"{n} t=0 pos")

    sizes = [int(s) for s in data["action_sizes"]]
    assert sizes == [env.get_agent_action_size(a) for a in env.agents]
    tol = _STIFF.get(scenario, _DEFAULT)
    diverged = np.zeros((B,), dtype=bool)
    for t in range(data["actions"].shape[0]):
        flat = data["actions"][t]
        acts, ofs = [], 0
        for size in sizes:
            acts.append(torch.as_tensor(flat[:, ofs:ofs + size]))
            ofs += size
        env.step(acts)
        if t >= tol["max_steps"]:
            continue
        atol = min(tol["base"] * tol["growth"]**t, 0.05)
        for i, n in enumerate(names):
            for field in ("pos", "vel", "rot", "ang_vel"):
                got = getattr(mine[n].state, field).numpy()
                target = data[field][t + 1, i]
                bad = np.abs(got - target) > atol + 2e-3 * np.abs(target)
                diverged |= bad.any(axis=-1)
        assert diverged.mean() <= tol["max_frac"] + 1e-9, (
            f"{scenario}: {diverged.sum()}/{B} envs diverged by step {t}")


# --------------------------------------------------------------------- #
# The constraint solve against the JAX package's
# --------------------------------------------------------------------- #
JOINT_WORLDS = {
    "joints": CONFIGS["joints"],
    "joints_fixed_rotation": CONFIGS["joints_fixed_rotation"],
    "joints_static_rotation": JOINTS_STATIC_ROTATION,
}


def _jax_world(cfg, batch):
    """The JAX package's world for a ``physics_configs``-style spec, with
    the fixed rotations that ``tests/helpers.build_world`` does not pass."""
    world = jcore.World(batch, **cfg.get("world", {}))
    ents = {}
    for kind, cls in (("agents", jcore.Agent), ("landmarks", jcore.Landmark)):
        for spec in cfg.get(kind, []):
            spec = dict(spec)
            name, shape = spec.pop("name"), spec.pop("shape")
            shape = {"sphere": lambda r: jcore.Sphere(radius=r),
                     "box": lambda l, w, h: jcore.Box(length=l, width=w,
                                                      hollow=h),
                     "line": lambda l: jcore.Line(length=l)}[shape[0]](
                         *shape[1:])
            ents[name] = cls(name=name, shape=shape, **spec)
            (world.add_agent if cls is jcore.Agent else world.add_landmark)(
                ents[name])
    for j in cfg.get("joints", []):
        j = dict(j)
        a, b = ents[j.pop("a")], ents[j.pop("b")]
        world.add_joint(jcore.Joint(a, b, **j))
    world.finalize()
    return world


# Rotations of the random inputs: near the fixed rotation where a world has
# one (its torque grows as exp|gap|, JOINTS_STATIC_ROTATION's rot_spread).
ROT_SPREAD = {"joints": np.pi, "joints_fixed_rotation": 0.3,
              "joints_static_rotation": 0.3}


def _per_env_rotations(batch, n, seed):
    return np.random.RandomState(seed).uniform(
        -0.3, 0.3, (n, batch, 1)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(JOINT_WORLDS))
def test_step_core_matches_jax(name, B=8):
    """``World._step_core`` with joints against the JAX package's, from
    random inputs with overlapping pairs and stretched constraints; a
    per-env fixed rotation (``joints_fixed_rotation``) is written into both
    worlds' extras."""
    cfg = JOINT_WORLDS[name]
    world, _ = build_world(cfg, B, device="cpu")
    jw = _jax_world(cfg, B)
    keyed = [c for c in world._ordered_constraints if c.inferred_rotation]
    jkeyed = [c for c in jw._ordered_constraints
              if c._extras_key is not None and not c.rotate
              and c._extras_key in [k._extras_key for k in keyed]]
    assert len(keyed) == len(jkeyed) == (name == "joints_fixed_rotation")
    for c, jc, fr in zip(keyed, jkeyed, _per_env_rotations(B, len(keyed), 3)):
        c.fixed_rotation = torch.as_tensor(fr)
        jc.fixed_rotation = jnp.asarray(fr)
    inputs = [x.numpy() for x in random_step_inputs(
        world, cfg["spread"], 5, rot_spread=ROT_SPREAD[name])]
    ref = jax.jit(lambda *a: jw._step_core(*a, jw.state.extras))(
        *(jnp.asarray(x) for x in inputs[:6]))
    got = world._step_core(*(torch.as_tensor(x) for x in inputs[:6]),
                           world.state.extras)
    for r, o, field in zip(ref, got, ("pos", "vel", "rot", "ang_vel")):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5, err_msg=field)


# --------------------------------------------------------------------- #
# The kernel's route
# --------------------------------------------------------------------- #
@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setenv("VMT_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("VMT_PALLAS_STEP", "1")
    from vectorizedmultiagentsimulator_tpu.ops import physics_pallas
    return physics_pallas


# A dist > 0 joint whose box end keeps an explicit fixed rotation: static,
# on the kernel (the route only: its landmark's pose sets the rotation gap,
# so from posed inputs the exp torque makes it too stiff to compare).
EXPLICIT_ROTATION = dict(
    world=dict(substeps=5),
    agents=[dict(name="a0", shape=("sphere", 0.05)),
            dict(name="a1", shape=("box", 0.2, 0.1, False), rotatable=True)],
    joints=[dict(a="a0", b="a1", anchor_b=(1, 0), dist=0.15, rotate_b=False,
                 fixed_rotation_b=0.3)],
)


@pytest.mark.parametrize("name,on_kernel", [
    ("joints", True), ("joints_fixed_rotation", False),
    ("joints_static_rotation", True), ("explicit_rotation", True)])
def test_route_of_joint_worlds_matches_jax(pallas_interpret, name, on_kernel):
    """The JAX kernel decides after the fixed rotation is written; the port
    decides at finalize and gives the same route."""
    cfg = dict(JOINT_WORLDS, explicit_rotation=EXPLICIT_ROTATION)[name]
    world, ents = build_world(cfg, 2, device="cpu")
    jw = _jax_world(cfg, 2)
    for e in jw.agents:  # the joint observers write the rotations
        e.set_pos(jnp.zeros((2, 2)), batch_index=None)
    assert world._use_kernel is on_kernel
    assert physics_cuda.step_supported(world) is on_kernel
    assert pallas_interpret.step_supported(jw) is on_kernel


@pytest.mark.parametrize("name", ["joints", "joints_fixed_rotation",
                                  "joints_static_rotation"])
def test_per_env_fixed_rotation_only_where_inferred(name, B=4):
    """Only a constraint whose rotation its Joint infers keeps a per-env
    fixed rotation (in extras, on the plain path); every other one is
    static after finalize, so a write that the kernel's tables would not
    see raises instead of reaching the plain path alone."""
    world, _ = build_world(JOINT_WORLDS[name], B, device="cpu")
    rot = torch.full((B, 1), 0.2)
    for c in world._ordered_constraints:
        assert (c._extras_key is not None) is c.inferred_rotation
        if c.inferred_rotation:
            c.fixed_rotation = rot
            assert torch.equal(world.get_extra(c._extras_key), rot)
            assert not world._use_kernel
        else:
            with pytest.raises(ValueError, match="fixed once the world"):
                c.fixed_rotation = rot
    assert physics_cuda.step_supported(world) is world._use_kernel


@pytest.mark.parametrize("scenario,on_kernel", [
    ("asym_joint", True), ("ball_trajectory", True), ("buzz_wire", True),
    ("joint_passage", True), ("joint_passage_size", True),
    ("waterfall", False)])
def test_route_of_joint_scenarios_matches_jax(pallas_interpret, scenario,
                                              on_kernel):
    """Each joint scenario at its defaults: the port's route (pinned after
    the first reset) against the JAX kernel's after its first reset."""
    env = vmt_torch.make_env(scenario, num_envs=2, device="cpu", seed=0)
    assert env.world._use_kernel is on_kernel
    jw = vmt.make_env(scenario, num_envs=2, seed=0, jit_compile=False).world
    assert pallas_interpret.step_supported(jw) is on_kernel


# --------------------------------------------------------------------- #
# The kernel's source on the host
# --------------------------------------------------------------------- #
def _build_host_physics(directory, replace=None):
    """``csrc/physics_step.cu`` compiled as host C++ (its per-thread body
    in a loop over the envs), with ``replace`` = (old, new) applied to a
    copy of the source; None without a host compiler."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        return None
    with open(physics_cuda.SOURCE) as f:
        source = f.read()
    if replace is not None:
        assert source.count(replace[0]) == 1, replace[0]
        source = source.replace(*replace)
    src_path = str(directory / "physics_step.cpp")
    with open(src_path, "w") as f:
        f.write(source)
    lib_path = str(directory / "libphysics.so")
    subprocess.run(
        [cxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
         "-o", lib_path, src_path],
        check=True, timeout=60,
    )
    lib = ctypes.CDLL(lib_path)
    fn = lib.vmt_physics_step
    fn.argtypes = [ctypes.c_void_p] * 14
    fn.restype = ctypes.c_int
    fn.smem_bytes = lib.vmt_physics_smem_bytes
    fn.smem_bytes.argtypes = [ctypes.c_void_p]
    return fn


@pytest.fixture(scope="module")
def host_physics(tmp_path_factory):
    return _build_host_physics(tmp_path_factory.mktemp("physics"))


def _host_step(fn, world, inputs, lanes=None):
    """One step of the host build; ``lanes`` forces a lane group (None:
    the one chosen at finalize).  Two launches must give the same bits."""
    kt = physics_cuda.kernel_tables(world)
    if lanes is not None:
        kt.structs[1].lanes = lanes
    dims = kt.structs[1]
    assert fn.smem_bytes(kt.addresses[1]) == physics_cuda.smem_bytes(
        dims.N, dims.pair_start[-1], dims.J, dims.lanes)
    inputs = [x.contiguous() for x in inputs]
    outs = []
    for _ in range(2):
        out = [torch.empty_like(x) for x in inputs[:4]]
        err = fn(*(x.data_ptr() for x in inputs),
                 *(o.data_ptr() for o in out), *kt.addresses, None)
        assert err == 0
        outs.append(out)
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    return outs[0]


# Lane groups beside the one chosen at finalize: the first design's one
# thread an env, and wider ones up to the widest the kernel takes.
FORCED_LANES = (1, 4, 8)


KERNEL_WORLDS = {c: CONFIGS[c] for c in CONFIGS
                 if c != "joints_fixed_rotation"}
KERNEL_WORLDS["joints_static_rotation"] = JOINTS_STATIC_ROTATION


def _check_kernel_world(host_physics, name, lanes=None, B=64):
    """The world ``name`` of ``KERNEL_WORLDS`` through the host build with
    ``lanes`` (None: the group chosen at finalize)."""
    if host_physics is None:
        pytest.skip("needs a host C++ compiler")
    cfg = KERNEL_WORLDS[name]
    world, ents = build_world(cfg, B, device="cpu")
    assert world._use_kernel
    if cfg.get("joints"):
        inputs = posed_step_inputs(world, ents, cfg, 21)
    else:
        inputs = random_step_inputs(world, cfg["spread"], 21)
    got = _host_step(host_physics, world, inputs, lanes)
    report = physics_diff(world, inputs, got)
    assert report["ok"], report


@pytest.mark.parametrize("name", sorted(KERNEL_WORLDS))
def test_kernel_source_on_the_host_matches_plain(host_physics, name):
    """The six pair classes' configs from random inputs, and the joint
    worlds that take the kernel posed as the goldens are (the joint
    observers place the joint landmarks): within PHYS_ATOL + PHYS_RTOL
    |plain| (the lanes' sums add in another order than the plain
    version's matmul, as one thread's do); 64 envs fill two blocks of
    32."""
    _check_kernel_world(host_physics, name)


@pytest.mark.parametrize("lanes", FORCED_LANES)
@pytest.mark.parametrize("name", sorted(KERNEL_WORLDS))
def test_kernel_source_on_the_host_matches_plain_at_lane_groups(
        host_physics, name, lanes):
    """The same at the other lane groups the kernel takes."""
    _check_kernel_world(host_physics, name, lanes)


SCENARIOS_ON_THE_KERNEL = ["asym_joint", "ball_trajectory", "buzz_wire",
                           "joint_passage", "joint_passage_size"]
# The scenarios without joints that step through the kernel too, held at
# the strict rule from every input.
JOINTLESS_SCENARIOS = [
    "discovery", "sampling", "simple", "simple_adversary", "simple_crypto",
    "simple_push", "simple_reference", "simple_tag", "simple_world_comm",
    "wheel", "passage", "ball_passage", "reverse_transport", "dropout"]


def _check_scenario(host_physics, scenario, lanes=None, B=16):
    """``scenario``'s world through the host build with ``lanes``."""
    if host_physics is None:
        pytest.skip("needs a host C++ compiler")
    env = vmt_torch.make_env(scenario, num_envs=B, device="cpu", seed=0)
    w = env.world
    joints = scenario in SCENARIOS_ON_THE_KERNEL
    assert w._use_kernel and bool(len(w._ordered_constraints)) is joints

    def state_inputs():
        s = w.state
        return (s.pos, s.vel, s.rot, s.ang_vel, s.force, s.torque,
                physics_cuda.stacked_dyn_gravity(w, s.extras))

    for stage, inputs in (("reset", state_inputs()),
                          ("jittered", jittered_inputs(state_inputs(), 23)),
                          ("random", random_step_inputs(w, 0.5, 22))):
        report = physics_diff(
            w, inputs, _host_step(host_physics, w, inputs, lanes),
            stiff=joints and stage == "random")
        assert report["ok"], (stage, report)
    for _ in range(3):
        env.step(env.get_random_actions())
    inputs = state_inputs()
    report = physics_diff(w, inputs, _host_step(host_physics, w, inputs,
                                                lanes), stiff=joints)
    assert report["ok"], report


@pytest.mark.parametrize("scenario",
                         SCENARIOS_ON_THE_KERNEL + JOINTLESS_SCENARIOS)
def test_kernel_source_on_the_host_matches_plain_scenarios(host_physics,
                                                           scenario):
    """The joint scenarios' worlds from their reset state and from it
    jittered, every constraint stretched (strict), after 3 steps and from
    random inputs (the stiff rule where the strict one is exceeded), with
    the lane group chosen at finalize; the scenarios without joints from
    the same inputs, all held at the strict rule."""
    _check_scenario(host_physics, scenario)


@pytest.mark.parametrize("scenario", SCENARIOS_ON_THE_KERNEL)
def test_kernel_source_on_the_host_matches_plain_scenarios_one_lane(
        host_physics, scenario):
    """The same with one thread an env."""
    _check_scenario(host_physics, scenario, lanes=1)


# Faults planted in a copy of the kernel's joint branch, and the world
# whose comparison must catch each: a lever-arm torque's sign on a
# scenario from its jittered reset (strict) and from random inputs (the
# stiff rule), the fixed-rotation torque's sign on the static-rotation
# world posed (strict).
PLANTED_FAULTS = {
    "lever_arm_torque": ("float ta = rax * fy - ray * fx;",
                         "float ta = -(rax * fy - ray * fx);"),
    "fixed_rotation_torque": ("ta = ta + -tq;", "ta = ta + tq;"),
}


@pytest.mark.parametrize("fault", sorted(PLANTED_FAULTS))
def test_kernel_comparisons_catch_a_planted_fault(tmp_path, fault, B=64):
    """The comparisons that hold the kernel to its plain version fail on a
    kernel whose joint branch is wrong."""
    fn = _build_host_physics(tmp_path, PLANTED_FAULTS[fault])
    if fn is None:
        pytest.skip("needs a host C++ compiler")
    if fault == "fixed_rotation_torque":
        world, ents = build_world(JOINTS_STATIC_ROTATION, B, device="cpu")
        inputs = posed_step_inputs(world, ents, JOINTS_STATIC_ROTATION, 21)
        assert not physics_diff(world, inputs,
                                _host_step(fn, world, inputs))["ok"]
        return
    env = vmt_torch.make_env("joint_passage", num_envs=B, device="cpu",
                             seed=0)
    w, s = env.world, env.world.state
    reset = (s.pos, s.vel, s.rot, s.ang_vel, s.force, s.torque,
             physics_cuda.stacked_dyn_gravity(w, s.extras))
    inputs = jittered_inputs(reset, 23)
    assert not physics_diff(w, inputs, _host_step(fn, w, inputs))["ok"]
    inputs = random_step_inputs(w, 0.5, 22)
    report = physics_diff(w, inputs, _host_step(fn, w, inputs), stiff=True)
    # Beyond the float64 rule in most envs, not at a few cut-offs.
    assert not report["ok"] and report["bad_envs"] > B // 2, report


# --------------------------------------------------------------------- #
# Live parity, determinism, controller, gradients
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("scenario,n_steps", [("buzz_wire", 4),
                                              ("joint_passage", 4)])
def test_live_parity_with_jax(scenario, n_steps, B=8):
    """The JAX env's reset state carried into the port
    (``state_from_numpy``, joint landmarks and PID extras included); both
    stepped with the same numpy actions for the stiff step count; obs and
    rewards held as ``test_scenario_parity`` holds them (its tolerance of
    the scenario, 2e-3 |ref| and its share of diverged envs: buzz_wire's 15
    substeps at joint_force 900 grow an ulp to about 1e-3 in one step), and
    the dones of the envs that did not diverge equal."""
    jenv = vmt.make_env(scenario, num_envs=B, seed=0)
    env = vmt_torch.make_env(scenario, num_envs=B, device="cpu", seed=1)
    arrays = jax_state_arrays(jenv.state)
    assert set(arrays["extras"]) == set(env.world.state.extras)
    state_from_numpy(env, arrays)
    rng = np.random.RandomState(0)
    sizes = [env.get_agent_action_size(a) for a in env.agents]
    tol = _STIFF.get(scenario, _DEFAULT)
    diverged = np.zeros((B,), dtype=bool)
    for t in range(n_steps):
        acts = [rng.uniform(-1, 1, (B, s)).astype(np.float32) for s in sizes]
        j_obs, j_rew, j_done, _ = jenv.step(acts)
        obs, rew, done, _ = env.step([torch.as_tensor(a) for a in acts])
        atol = tol["base"] * tol["growth"]**t
        for k in range(len(sizes)):
            for got, ref in ((obs[k].numpy(), np.asarray(j_obs[k])),
                             (rew[k].numpy()[:, None],
                              np.asarray(j_rew[k])[:, None])):
                assert np.isfinite(got).all()
                bad = np.abs(got - ref) > atol + 2e-3 * np.abs(ref)
                diverged |= bad.any(axis=-1)
        assert diverged.mean() <= tol["max_frac"] + 1e-9, (t, diverged)
        np.testing.assert_array_equal(done.numpy()[~diverged],
                                      np.asarray(j_done)[~diverged])


@pytest.mark.parametrize("scenario", JOINT_SCENARIOS)
def test_same_seed_same_trajectory(scenario, B=4, n_steps=3):
    def run(seed):
        env = vmt_torch.make_env(scenario, num_envs=B, device="cpu",
                                 seed=seed)
        out = [env.reset()]
        for _ in range(n_steps):
            out.append(env.step(env.get_random_actions())[0])
        return torch.stack([torch.cat(o, dim=-1) for o in out])

    a, b, c = run(3), run(3), run(4)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)


def test_velocity_controller_matches_jax(B=6):
    """joint_passage_size's PID (gains 2, 10, 1e-5, force range 10) with
    its integrator clamp and a masked reset, against the JAX package's
    controller on the same velocities and targets for 4 steps."""
    from vectorizedmultiagentsimulator_tpu.controllers import (
        VelocityController as JaxController,
    )
    from vectorizedmultiagentsimulator_tpu_torch.controllers import (
        VelocityController,
    )

    def make(core, ctrl, **kw):
        world = core.World(B, **kw)
        agent = core.Agent(name="a", shape=core.Sphere(0.05), f_range=10,
                           mass=2.0)
        agent.controller = ctrl(agent, world, [2.0, 10, 0.00001], "standard")
        world.add_agent(agent)
        world.finalize()
        agent.controller.reset(None)
        return world, agent

    jw, ja = make(jcore, JaxController)
    tw, ta = make(vmt_torch.core, VelocityController, device="cpu")
    assert set(jw.state.extras) == set(tw.state.extras) == {
        "a.pid_accum_errs", "a.pid_prev_err"}
    rng = np.random.RandomState(4)
    for t in range(4):
        u = rng.uniform(-30, 30, (B, 2)).astype(np.float32)
        vel = rng.uniform(-1, 1, (B, 2)).astype(np.float32)
        ja.action.u, ja.state.vel = jnp.asarray(u), jnp.asarray(vel)
        ta.action.u, ta.state.vel = torch.as_tensor(u), torch.as_tensor(vel)
        if t == 2:
            mask = np.arange(B) % 2 == 0
            ja.controller.reset(jnp.asarray(mask))
            ta.controller.reset(torch.as_tensor(mask))
        ja.controller.process_force()
        ta.controller.process_force()
        np.testing.assert_allclose(ta.action.u.numpy(),
                                   np.asarray(ja.action.u), rtol=1e-6,
                                   atol=1e-5, err_msg=f"u step {t}")
        for key in jw.state.extras:
            np.testing.assert_allclose(tw.get_extra(key).numpy(),
                                       np.asarray(jw.get_extra(key)),
                                       rtol=1e-6, atol=1e-6, err_msg=key)


def test_fused_step_gradients_on_a_joint_world(B=8):
    """The autograd.Function's backward (the plain version re-run) gives
    the plain version's own gradients through the joint forces and the
    fixed-rotation torque."""
    world, _ = build_world(JOINTS_STATIC_ROTATION, B, device="cpu")
    assert world._use_kernel
    base = random_step_inputs(world, 0.5, 9, rot_spread=0.3)
    weights = [torch.randn(x.shape, generator=torch.Generator().manual_seed(i))
               for i, x in enumerate(base[:4])]

    def grads(step):
        inputs = [x.clone().requires_grad_(True) for x in base]
        out = step(world, *inputs)
        loss = sum((o * w).sum() for o, w in zip(out, weights))
        return torch.autograd.grad(loss, inputs[:6])

    got = grads(physics_cuda.fused_step)
    ref = grads(physics_cuda.step_plain)
    for name, g, r in zip(("pos", "vel", "rot", "ang_vel", "force", "torque"),
                          got, ref):
        assert torch.isfinite(g).all(), name
        torch.testing.assert_close(g, r, rtol=1e-6, atol=1e-6, msg=name)
    assert got[2].abs().sum() > 0  # rotations reach the outputs


def test_joint_passage_collision_reward_matches_jax(B=8):
    """joint_passage with a collision penalty (the 52 distance queries its
    default of 0 skips): agents and the mass pressed against the collide
    passages and walls, the reward of one step against the JAX package's,
    run eagerly."""
    kw = dict(collision_reward=-1.0)
    jenv = vmt.make_env("joint_passage", num_envs=B, seed=0,
                        jit_compile=False, **kw)
    env = vmt_torch.make_env("joint_passage", num_envs=B, device="cpu",
                             seed=0, **kw)
    names = [e.name for e in jenv.world.entities]
    pos = np.array(jenv.state.pos)
    rng = np.random.RandomState(5)
    targets = [n for n in names if n.startswith(("passage", "wall"))]
    for n in ("agent_0", "agent_1", "mass"):
        pick = rng.randint(len(targets), size=B)
        pos[:, names.index(n)] = pos[np.arange(B), [names.index(targets[k])
                                                     for k in pick]]
        pos[:, names.index(n)] += rng.uniform(-0.12, 0.12, (B, 2))
    jenv.state = jenv.state.replace(pos=jnp.asarray(pos))
    state_from_numpy(env, jax_state_arrays(jenv.state))
    ref = np.asarray(jenv.scenario.reward(jenv.world.agents[0]))
    got = env.scenario.reward(env.world.agents[0]).numpy()
    j_coll = np.asarray(jenv.scenario.collision_rew)
    assert (j_coll < 0).any()
    np.testing.assert_allclose(env.scenario.collision_rew.numpy(), j_coll)
    np.testing.assert_allclose(got, ref, atol=1e-5)
