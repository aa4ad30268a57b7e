"""The port's road_traffic scenario, its KinematicBicycle dynamics and the
plain versions of its three road-geometry kernels: held against the JAX
package (its map tables, its dynamics, its jnp geometry bundle and
neighbour mirror, and its env live), the kernels' source compiled as host
C++, the VMAS goldens, and the JAX package's map '3' and testing-mode
behaviours; same-seed determinism and autograd through the wrappers."""
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
    geometry_diff,
    jax_state_arrays,
    neighbor_diff,
    poses_at_chunk_margins,
    poses_at_path_ends,
    poses_near_path_ends,
    poses_near_self,
    random_map_poses,
    random_neighbor_inputs,
)

import vectorizedmultiagentsimulator_tpu as vmt
import vectorizedmultiagentsimulator_tpu_torch as vmt_torch
from vectorizedmultiagentsimulator_tpu.dynamics import (
    KinematicBicycle as JaxBicycle,
)
from vectorizedmultiagentsimulator_tpu.ops import road_geometry_pallas as rgp
from vectorizedmultiagentsimulator_tpu.scenarios import road_traffic as jrt
from vectorizedmultiagentsimulator_tpu.scenarios import (
    road_traffic_map as jrtm,
)
from vectorizedmultiagentsimulator_tpu_torch.dynamics import KinematicBicycle
from vectorizedmultiagentsimulator_tpu_torch.ops import road_geometry as rg
from vectorizedmultiagentsimulator_tpu_torch.ops import road_geometry_cuda as rgc
from vectorizedmultiagentsimulator_tpu_torch.scenarios import (
    road_traffic_map as rtm,
)
from vectorizedmultiagentsimulator_tpu_torch.utils import (
    state_from_numpy,
    state_to_numpy,
)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
MAPS = [("1", {"n_agents": 20}), ("3", {"n_agents": 4})]
GEOMETRY_NAMES = ("ref", "left_all", "right_all", "boundaries", "short_term",
                  "vertices", "lanelets", "entry", "exit", "agents")


def _env(B=4, **kw):
    kw.setdefault("n_agents", 4)
    return vmt_torch.make_env("road_traffic", num_envs=B, device="cpu",
                              seed=0, **kw)


def _jax_scenario(B, **kw):
    """The JAX package's road_traffic scenario with its parameters and
    tables only (no world): enough for its jnp geometry bundle."""
    s = jrt.Scenario()
    s.init_params(B, **kw)
    return s


def _jax_bundle(js, pos, rot, path_id, with_collisions):
    """``js._bundle_jnp_pure`` jitted (one compile per case, faster than
    its eager ops) on the port's tensors."""
    fn = jax.jit(lambda p, r, i: js._bundle_jnp_pure(p, r, i,
                                                     with_collisions))
    return fn(*(jnp.asarray(x.numpy()) for x in (pos, rot, path_id)))


def _poses(env, jitter):
    """The env's reset poses, exact or jittered by up to 0.1 in position
    and 0.5 in heading (test_road_geometry_pallas.py's jitter), or
    ``jitter="ends"``: across the agents' entry and exit segments, or
    ``"last"``: on vertices just before their path's last point."""
    if jitter == "ends":
        return poses_at_path_ends(env.scenario._tables, env.scenario.path_id,
                                  seed=2)
    if jitter == "last":
        return poses_near_path_ends(env.scenario._tables,
                                    env.scenario.path_id, seed=2)
    s = env.world.state
    pos, rot = s.pos.clone(), s.rot[..., 0].clone()
    if jitter:
        rng = np.random.RandomState(1)
        pos = pos + torch.as_tensor(
            rng.uniform(-0.1, 0.1, pos.shape).astype(np.float32))
        rot = rot + torch.as_tensor(
            rng.uniform(-0.5, 0.5, rot.shape).astype(np.float32))
    return pos.contiguous(), rot.contiguous()


# --------------------------------------------------------------------- #
# The map
# --------------------------------------------------------------------- #
def test_map_tables_equal_jax():
    """The port's copy of the map module and of the CPM-Lab XML give the
    JAX package's padded path tables to the bit, and the port reads its
    own copy."""
    assert "vectorizedmultiagentsimulator_tpu_torch" in rtm.DEFAULT_MAP_PATH
    ours, theirs = rtm.get_map_data(), jrtm.get_map_data()
    assert ours["mean_lane_width"] == theirs["mean_lane_width"]
    for p_ours, p_theirs in zip(rtm.get_reference_paths(ours),
                                jrtm.get_reference_paths(theirs)):
        a = rtm.PaddedPaths(p_ours, 6, 185)
        b = jrtm.PaddedPaths(p_theirs, 6, 185)
        for f in ("center", "vec_norm", "left", "right", "n_points",
                  "n_left", "n_right", "is_loop", "entry", "exit"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)


# --------------------------------------------------------------------- #
# KinematicBicycle
# --------------------------------------------------------------------- #
class _World:
    dt = 0.05


@pytest.mark.parametrize("integration", ["euler", "rk4"])
def test_kinematic_bicycle_matches_jax(integration):
    """Euler and the hoisted RK4 against the JAX package's on random
    states and commands (the same operations: within an ulp-level
    tolerance for the libraries' tan/atan2/cos/sin)."""
    rng = np.random.RandomState(0)
    state = rng.uniform(-3, 3, (64, 3)).astype(np.float32)
    steer = rng.uniform(-0.6, 0.6, 64).astype(np.float32)
    v = rng.uniform(-1, 1, 64).astype(np.float32)
    args = dict(width=0.08, l_f=0.08, l_r=0.08, max_steering_angle=0.61,
                integration=integration)
    ours = KinematicBicycle(_World(), **args)
    theirs = JaxBicycle(_World(), **args)
    fn = "euler" if integration == "euler" else "runge_kutta"
    got = getattr(ours, fn)(*(torch.as_tensor(x) for x in (state, steer, v)))
    ref = getattr(theirs, fn)(*(jnp.asarray(x) for x in (state, steer, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-7)


def _replay_golden(name, env, data, check_obs_rew):
    """Replay ``data``'s actions from its t=0 state as
    test_scenario_parity.py does: states (and, with ``check_obs_rew``,
    observations and from t=1 rewards) within 5e-4 growing x1.6 a step
    plus 2e-3 relative, at most a quarter of the envs diverging."""
    B = data["pos"].shape[2]
    names = [str(n) for n in data["entity_names"]]
    mine = {e.name: e for e in env.world.entities}
    assert set(names) == set(mine)
    for i, n in enumerate(names):
        e = mine[n]
        for f in ("pos", "rot", "vel", "ang_vel"):
            getattr(e, f"set_{f}")(torch.as_tensor(data[f][0, i]))
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
        if check_obs_rew:
            for k in range(len(sizes)):
                diverged |= account(obs[k].numpy(), data["obs"][t + 1][k],
                                    atol)
                if t >= 1:
                    diverged |= account(rews[k].numpy(), data["rew"][t][k],
                                        atol)
        for i, n in enumerate(names):
            for f in ("pos", "vel", "rot", "ang_vel"):
                got = getattr(mine[n].state, f).numpy()
                diverged |= account(got, data[f][t + 1, i], atol)
        assert diverged.mean() <= 0.25 + 1e-9, (
            f"{name}: {diverged.sum()}/{B} envs diverged by step {t}")


def test_kinematic_bicycle_golden():
    """``golden/scenario_kinematic_bicycle.npz`` (Euler, one bicycle and
    one rotating holonomic box colliding, 10 substeps)."""
    data = np.load(os.path.join(GOLDEN, "scenario_kinematic_bicycle.npz"),
                   allow_pickle=True)
    kwargs = ast.literal_eval(str(data["kwargs_json"]))
    env = vmt_torch.make_env("kinematic_bicycle",
                             num_envs=data["pos"].shape[2], device="cpu",
                             seed=0, **kwargs)
    _replay_golden("kinematic_bicycle", env, data, check_obs_rew=False)


# --------------------------------------------------------------------- #
# The plain geometry against the JAX package's jnp bundle
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def geometry_cases():
    """(map, port env, JAX scenario) per map, B = 6."""
    return {m: (_env(6, map_type=m, **kw), _jax_scenario(6, map_type=m, **kw))
            for m, kw in MAPS}


@pytest.mark.parametrize("map_type,jitter", [("1", True), ("3", True),
                                             ("3", "ends")])
@pytest.mark.parametrize("with_collisions", [False, True])
def test_geometry_plain_matches_jax_jittered(geometry_cases, map_type,
                                             jitter, with_collisions):
    """``geometry_plain`` against ``Scenario._bundle_jnp_pure`` from the
    same jittered poses (or poses across the entry and exit segments) and
    path ids: atol 2e-5, rtol 1e-5 (the rule of
    test_road_geometry_pallas.py)."""
    env, js = geometry_cases[map_type]
    pos, rot = _poses(env, jitter)
    sc = env.scenario
    got = rg.geometry_plain(sc._tables, with_collisions, pos, rot, sc.path_id)
    ref = _jax_bundle(js, pos, rot, sc.path_id, with_collisions)
    assert len(got) == len(ref) == (10 if with_collisions else 5)
    for name, g, r in zip(GEOMETRY_NAMES, got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-5,
                                   rtol=1e-5, err_msg=name)
    if with_collisions:
        # the jitter makes some crossings, so the flags are exercised
        assert float(got[6].sum() + got[9].sum()) > 0


@pytest.mark.parametrize("map_type", ["1", "3"])
def test_geometry_plain_exact_on_reset_poses(geometry_cases, map_type):
    """At reset the agents sit exactly on path vertices (two segments tie):
    ``short_term`` and ``ref`` bit-equal to the JAX bundle's."""
    env, js = geometry_cases[map_type]
    pos, rot = _poses(env, jitter=False)
    sc = env.scenario
    got = rg.geometry_plain(sc._tables, False, pos, rot, sc.path_id)
    ref = _jax_bundle(js, pos, rot, sc.path_id, False)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(ref[4]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    assert float(got[0].abs().max()) == 0.0
    for name, g, r in zip(GEOMETRY_NAMES[1:4], got[1:4], ref[1:4]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6,
                                   err_msg=name)


def test_neighbor_obs_plain_matches_jax():
    """``neighbor_obs_plain`` against ``_neighbor_obs_jnp`` (B = 64, A = 6,
    k = 2, random): the selection (nd) bit-equal, the rest within 1e-6."""
    A, k, half_l, half_w = 6, 2, 0.08, 0.05
    inputs = random_neighbor_inputs(64, A, seed=0)
    got = rg.neighbor_obs_plain(A, k, half_l, half_w,
                                *(torch.as_tensor(x) for x in inputs))
    ref = jax.jit(lambda *x: rgp._neighbor_obs_jnp(A, k, half_l, half_w, *x))(
        *(jnp.asarray(x) for x in inputs))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    for name, g, r in zip(("nd", "pos_ego", "rot_rel", "vel_ego", "vert_ego"),
                          got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6,
                                   err_msg=name)


# --------------------------------------------------------------------- #
# The kernels' source on the host
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    """``csrc/road_geometry.cu`` compiled as host C++; None without a host
    compiler."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        return None
    lib_path = str(tmp_path_factory.mktemp("road") / "libroad.so")
    subprocess.run(
        [cxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
         "-x", "c++", "-o", lib_path, rgc.SOURCE],
        check=True, timeout=60,
    )
    lib = ctypes.CDLL(lib_path)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name, argtypes in (
        ("vmt_road_agent_geometry", [P] * 12 + [I, I, P]),
        ("vmt_road_pair_collisions", [P] * 5 + [I, P]),
        ("vmt_road_neighbor_obs", [P] * 9 + [I, I, I, F, F, P]),
    ):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, I
    return lib


def _host_geometry(lib, tables, with_collisions, pos, rot, path_id):
    B, A, K = pos.shape[0], tables.A, tables.K
    outs = [torch.empty(s) for s in ((B, A), (B, A, 5), (B, A, 5), (B, A),
                                     (B, A, K, 2))]
    flags = [torch.empty((B, A)) for _ in range(3)]
    err = lib.vmt_road_agent_geometry(
        pos.data_ptr(), rot.data_ptr(), path_id.data_ptr(),
        *(o.data_ptr() for o in outs), *(f.data_ptr() for f in flags),
        ctypes.addressof(tables.struct), B, int(with_collisions), None)
    assert err == 0
    if not with_collisions:
        return tuple(outs)
    vertices, agents = torch.empty((B, A, 5, 2)), torch.empty((B, A, A))
    err = lib.vmt_road_pair_collisions(
        pos.data_ptr(), rot.data_ptr(), vertices.data_ptr(),
        agents.data_ptr(), ctypes.addressof(tables.struct), B, None)
    assert err == 0
    return tuple(outs) + (vertices, *flags, agents)


@pytest.mark.parametrize("map_type,jitter,with_collisions", [
    ("1", False, False), ("1", True, True), ("1", "last", True),
    ("3", False, False), ("3", True, True), ("3", "ends", True),
    ("3", "last", False)])
def test_geometry_kernels_on_the_host_match_plain(
        host_kernels, geometry_cases, map_type, jitter, with_collisions):
    """The agent-geometry and pair kernels' per-thread bodies (the source
    compiled as host C++) against ``geometry_plain`` by
    ``torch_helpers.geometry_diff``: continuous outputs within 1e-5 +
    1e-5|ref|, and a moved closest index or flipped flag only at a near
    tie or near touch (none at the exact reset poses)."""
    if host_kernels is None:
        pytest.skip("needs a host C++ compiler")
    env, _ = geometry_cases[map_type]
    sc = env.scenario
    pos, rot = _poses(env, jitter)
    got = _host_geometry(host_kernels, sc._tables, with_collisions, pos, rot,
                         sc.path_id)
    ref = rg.geometry_plain(sc._tables, with_collisions, pos, rot, sc.path_id)
    report = geometry_diff(sc._tables, pos, rot, sc.path_id, got, ref)
    assert report["bad"] == 0, report
    if jitter == "ends":
        # both entry and exit crossings are met
        assert float(ref[7].sum()) > 0 and float(ref[8].sum()) > 0
    if jitter == "last":
        # on vertices, as at reset: the same closest index
        np.testing.assert_array_equal(got[4].numpy(), ref[4].numpy())
    if jitter in (False, "last"):
        assert report["moved"] == 0 and report["flipped"] == 0, report
        np.testing.assert_array_equal(got[4].numpy(), ref[4].numpy())
        np.testing.assert_array_equal(got[0].numpy(), ref[0].numpy())


def _variants_equal(lib, tables, got, pos, rot, path_id, lane_groups,
                    culls=(True, False)):
    """The host kernels at each lane group of ``lane_groups``, culling and
    not, bit-identical to ``got``."""
    for lanes in lane_groups:
        for cull in culls:
            with rgc.agent_variant(tables, lanes=lanes, cull=cull):
                other = _host_geometry(lib, tables, True, pos, rot, path_id)
            for name, g, o in zip(GEOMETRY_NAMES, got, other):
                assert torch.equal(g, o), (name, lanes, cull)


@pytest.mark.parametrize("B", [64, 256])
def test_geometry_kernels_on_the_host_random_map_poses(host_kernels,
                                                       geometry_cases, B):
    """Poses uniform over the map, random headings and path ids (most
    agents far from their path, so culling skips most chunks): the host
    kernels against ``geometry_plain`` by ``geometry_diff``, and every lane
    group, culling and not, bit-identical to the default launch."""
    if host_kernels is None:
        pytest.skip("needs a host C++ compiler")
    tables = geometry_cases["1"][0].scenario._tables
    pos, rot, pid = random_map_poses(tables, B, tables.A, seed=B)
    got = _host_geometry(host_kernels, tables, True, pos, rot, pid)
    ref = rg.geometry_plain(tables, True, pos, rot, pid)
    report = geometry_diff(tables, pos, rot, pid, got, ref)
    assert report["bad"] == 0, report
    _variants_equal(host_kernels, tables, got, pos, rot, pid,
                    rgc.LANE_GROUPS, culls=(True,) if B > 64 else
                    (True, False))


@pytest.mark.parametrize("poses", ["chunk margins", "near itself"])
def test_geometry_kernels_on_the_host_exact_where_culling_is_tight(
        host_kernels, geometry_cases, poses):
    """Poses whose centre or a corner lies on a chunk's box or within a
    few margins of it, at each lane group's chunks, and poses where a path
    passes near another part of itself (distances to two far parts of a
    row nearly tie): the closest index and every flag equal the plain
    version's, and culling changes no bit."""
    if host_kernels is None:
        pytest.skip("needs a host C++ compiler")
    tables = geometry_cases["1"][0].scenario._tables
    for lanes in rgc.LANE_GROUPS:
        if poses == "chunk margins":
            pos, rot, pid = poses_at_chunk_margins(tables, lanes, 16,
                                                   tables.A, seed=lanes)
        else:
            pos, rot, pid = poses_near_self(tables, 16, tables.A, seed=lanes)
        with rgc.agent_variant(tables, lanes=lanes):
            got = _host_geometry(host_kernels, tables, True, pos, rot, pid)
        ref = rg.geometry_plain(tables, True, pos, rot, pid)
        report = geometry_diff(tables, pos, rot, pid, got, ref)
        assert report["bad"] == 0, (lanes, report)
        assert report["moved"] == report["flipped"] == 0, (lanes, report)
        np.testing.assert_array_equal(got[4].numpy(), ref[4].numpy())
        _variants_equal(host_kernels, tables, got, pos, rot, pid, (lanes,),
                        culls=(False,))


@pytest.mark.parametrize("poses", ["random", "touching"])
def test_pair_matrix_is_symmetric_to_the_bit(host_kernels, geometry_cases,
                                             poses):
    """``agents[b, i, j] == agents[b, j, i]`` exactly, on the plain version
    and on the host pair kernel, which computes each unordered pair once:
    at random poses (agents crowded into a 1 m square, so that many cross)
    and at touching dyadic poses."""
    if host_kernels is None:
        pytest.skip("needs a host C++ compiler")
    tables = geometry_cases["1"][0].scenario._tables
    B, A = 64, tables.A
    if poses == "random":
        rng = np.random.RandomState(5)
        pos = torch.as_tensor(rng.uniform(1.0, 2.0, (B, A, 2))
                              .astype(np.float32))
        rot = torch.as_tensor(rng.uniform(-3, 3, (B, A)).astype(np.float32))
    else:
        offsets = torch.tensor([[0.0, 0.0], [0.125, 0.0], [0.0, 0.0625],
                                [0.125, 0.0625], [0.16, 0.0]])
        pos = (torch.tensor([2.0, 2.0]) + offsets[torch.arange(A) % 5]
               + (torch.arange(A) // 5)[:, None] * 0.5)
        pos = pos.expand(B, A, 2).contiguous()
        rot = torch.zeros((B, A))
    pid = torch.zeros((B, A), dtype=torch.int32)
    got = _host_geometry(host_kernels, tables, True, pos, rot, pid)
    ref = rg.geometry_plain(tables, True, pos, rot, pid)
    assert float(ref[9].sum()) > 0
    for m in (ref[9], got[9]):
        assert torch.equal(m, m.transpose(1, 2))
    report = geometry_diff(tables, pos, rot, pid, got, ref)
    assert report["bad"] == 0, report


def test_chunk_boxes_hold_their_segments(geometry_cases):
    """``road_geometry_cuda.chunk_boxes`` at every lane group: each box is
    the least and largest x and y of its chunk's points, so it holds each
    of its real segments; ``agent_variant`` puts the chosen layout back."""
    tables = geometry_cases["1"][0].scenario._tables
    rows = [x.numpy() for x in (tables.center, tables.left, tables.right)]
    counts = [x.numpy() for x in (tables.n_points, tables.n_left,
                                  tables.n_right)]
    before = [getattr(tables.struct, f) for f, _ in rgc._RoadParams._fields_]
    for lanes in rgc.LANE_GROUPS:
        boxes = rgc.chunk_boxes(*rows, *counts, lanes)
        assert boxes.shape == (40, 3, -(-184 // lanes), 4)
        for r in range(3):
            for p in range(40):
                n_seg = max(int(counts[r][p]) - 1, 1)
                pts = rows[r][p, :n_seg + 1]
                c = np.arange(n_seg + 1) // lanes
                for k in range(-(-n_seg // lanes)):
                    # the chunk's segments are k*lanes ... and their ends
                    mine = pts[k * lanes:min((k + 1) * lanes, n_seg) + 1]
                    np.testing.assert_array_equal(
                        boxes[p, r, k], np.concatenate(
                            [mine.min(axis=0), mine.max(axis=0)]))
                    inside = pts[c == k]
                    assert (inside >= boxes[p, r, k, :2]).all()
                    assert (inside <= boxes[p, r, k, 2:]).all()
        with rgc.agent_variant(tables, lanes=lanes, cull=False, staged=True):
            assert (tables.struct.lanes, tables.struct.cull,
                    tables.struct.staged) == (lanes, 0, 1)
    assert [getattr(tables.struct, f)
            for f, _ in rgc._RoadParams._fields_] == before
    with pytest.raises(ValueError, match="lanes"):
        with rgc.agent_variant(tables, lanes=6):
            pass


def test_geometry_diff_tells_faults_from_ties(geometry_cases):
    """The kernel-vs-plain rule itself: a moved short-term path, flipped
    flags and agent pairs far from any touch are faults; a flipped pair
    whose corner lies on the other's edge is a near touch."""
    env, _ = geometry_cases["3"]
    sc = env.scenario
    pos, rot = _poses(env, jitter=False)
    ref = rg.geometry_plain(sc._tables, True, pos, rot, sc.path_id)
    got = [r.clone() for r in ref]
    got[4][2, 2] += 0.01
    got[6][0, 0] = 1 - got[6][0, 0]
    got[7][1, 1] = 1 - got[7][1, 1]
    got[9][0, 0, 1] = 1 - got[9][0, 0, 1]
    report = geometry_diff(sc._tables, pos, rot, sc.path_id, got, ref)
    assert (report["moved"], report["flipped"], report["bad"]) == (1, 3, 4)
    pos[0, 1] = pos[0, 0] + torch.tensor([0.16, 0.0])  # corner on an edge
    rot[0, :2] = 0.0
    ref = rg.geometry_plain(sc._tables, True, pos, rot, sc.path_id)
    got = [r.clone() for r in ref]
    got[9][0, 0, 1] = 1 - got[9][0, 0, 1]
    report = geometry_diff(sc._tables, pos, rot, sc.path_id, got, ref)
    assert (report["flipped"], report["bad"]) == (1, 0)


def test_geometry_kernels_on_the_host_exact_at_touching_pairs(
        host_kernels, geometry_cases):
    """Unrotated agents in dyadic positions whose rectangles share an edge
    line or touch at a corner (cos and sin exact in every library): the
    strict crossing test must give the plain version's flags exactly."""
    if host_kernels is None:
        pytest.skip("needs a host C++ compiler")
    env, _ = geometry_cases["3"]
    sc = env.scenario
    B, A = sc.path_id.shape
    base = torch.tensor([2.0, 2.0])
    offsets = torch.tensor([[0.0, 0.0], [0.125, 0.0], [0.0, 0.0625],
                            [0.125, 0.0625]])  # half-extents 0.08 x 0.04
    pos = (base + offsets[torch.arange(A) % 4]).expand(B, A, 2).contiguous()
    pos = pos + torch.arange(B)[:, None, None] * 0.25
    rot = torch.zeros((B, A))
    got = _host_geometry(host_kernels, sc._tables, True, pos, rot,
                         sc.path_id)
    ref = rg.geometry_plain(sc._tables, True, pos, rot, sc.path_id)
    assert float(ref[9].sum()) > 0  # some pairs cross strictly
    for i in (6, 7, 8, 9):
        np.testing.assert_array_equal(got[i].numpy(), ref[i].numpy())


@pytest.mark.parametrize("A,k", [(6, 1), (6, 2), (20, 1), (20, 2), (33, 1),
                                 (33, 2), (64, 1), (64, 2)])
def test_neighbor_kernel_on_the_host_matches_plain(host_kernels, A, k):
    """The neighbour kernel's warp-per-env body (load, rectangles, each
    lane's selection, the staged stores; agents i and i + 32 in turn past
    32) against ``neighbor_obs_plain``: nd bit-equal, the rest within 1e-5
    + 1e-5|ref|; from random inputs, and from the same with every other
    env's dn rounded to a coarse grid, so that rounds meet ties, which the
    first index must win."""
    if host_kernels is None:
        pytest.skip("needs a host C++ compiler")
    half_l, half_w, B = 0.08, 0.04, 256
    pos, rot, vel, dn = random_neighbor_inputs(B, A, seed=3)
    tied = dn.copy()
    tied[::2] = np.round(tied[::2] * 2) / 2
    for d in (dn, tied):
        inputs = [torch.as_tensor(x) for x in (pos, rot, vel, d)]
        ref = rg.neighbor_obs_plain(A, k, half_l, half_w, *inputs)
        got = [torch.empty_like(r) for r in ref]
        err = host_kernels.vmt_road_neighbor_obs(
            *(x.data_ptr() for x in inputs), *(g.data_ptr() for g in got),
            B, A, k, half_l, half_w, None)
        assert err == 0
        report = neighbor_diff(got, ref)
        assert report["nd_equal"] and report["bad"] == 0, report
        assert torch.equal(got[2], ref[2])  # rot_rel: one subtraction


def test_kernel_struct_matches_ctypes_mirror(tmp_path):
    """``RoadParams`` of csrc/road_geometry.cu compiled as host C++: every
    field's offset and the size equal the ctypes mirror's."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    fields = [f for f, _ in rgc._RoadParams._fields_]
    probe = tmp_path / "probe.cpp"
    probe.write_text(
        f'#include "{rgc.SOURCE}"\n#include <cstddef>\n#include <cstdio>\n'
        "int main() {\n"
        + "".join(f'  std::printf("%zu\\n", offsetof(RoadParams, {f}));\n'
                  for f in fields)
        + '  std::printf("%zu\\n", sizeof(RoadParams));\n}\n')
    exe = tmp_path / "probe"
    subprocess.run([cxx, "-std=c++17", "-o", str(exe), str(probe)],
                   check=True, timeout=60)
    got = [int(x) for x in subprocess.run(
        [str(exe)], capture_output=True, text=True, check=True, timeout=60
    ).stdout.split()]
    want = [getattr(rgc._RoadParams, f).offset for f in fields]
    assert got == want + [ctypes.sizeof(rgc._RoadParams)]
    # the chunk boxes and the agent kernel's layout
    assert {"boxes", "lanes", "chunks", "cull", "staged"} <= set(fields)


def test_wrappers_on_the_cpu_are_the_plain_versions(geometry_cases):
    """On CPU tensors both wrappers return the plain versions' values and
    launch nothing."""
    env, _ = geometry_cases["1"]
    sc = env.scenario
    pos, rot = _poses(env, jitter=True)
    before = dict(rgc.LAUNCHES)
    for wc in (False, True):
        got = rgc.fused_geometry(sc._tables, wc, pos, rot, sc.path_id)
        ref = rg.geometry_plain(sc._tables, wc, pos, rot, sc.path_id)
        for g, r in zip(got, ref):
            assert torch.equal(g, r)
    inputs = [torch.as_tensor(x) for x in random_neighbor_inputs(8, 4, 1)]
    for g, r in zip(rgc.fused_neighbor_obs(4, 2, 0.08, 0.04, *inputs),
                    rg.neighbor_obs_plain(4, 2, 0.08, 0.04, *inputs)):
        assert torch.equal(g, r)
    assert rgc.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        rgc.launch_neighbor_obs(4, 2, 0.08, 0.04, *inputs)


def test_autograd_is_the_plain_versions(geometry_cases):
    """Gradients through both wrappers equal those through the plain
    versions (the backward re-runs them)."""
    env, _ = geometry_cases["1"]
    sc = env.scenario
    pos0, rot0 = _poses(env, jitter=True)

    def geom_grads(fn):
        pos = pos0.clone().requires_grad_(True)
        rot = rot0.clone().requires_grad_(True)
        out = fn(sc._tables, True, pos, rot, sc.path_id)
        sum((o**2).sum() for o in out).backward()
        return pos.grad, rot.grad

    for g, r in zip(geom_grads(rgc.fused_geometry),
                    geom_grads(rg.geometry_plain)):
        assert torch.isfinite(g).all() and g.abs().sum() > 0
        torch.testing.assert_close(g, r, rtol=0, atol=0)

    inputs = [torch.as_tensor(x) for x in random_neighbor_inputs(16, 6, 2)]

    def nobs_grads(fn):
        leaves = [x.clone().requires_grad_(True) for x in inputs]
        out = fn(6, 2, 0.08, 0.04, *leaves)
        sum((o**2).sum() for o in out).backward()
        return [x.grad for x in leaves]

    for g, r in zip(nobs_grads(rgc.fused_neighbor_obs),
                    nobs_grads(rg.neighbor_obs_plain)):
        torch.testing.assert_close(g, r, rtol=0, atol=0)


# --------------------------------------------------------------------- #
# The VMAS goldens
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("golden", ["road_traffic_map1", "road_traffic_map3"])
def test_road_traffic_golden(golden):
    """``golden/scenario_<golden>.npz``: the reference's path ids injected
    (``inject_reference_ids``), its t=0 poses set, its actions replayed;
    states, observations and (from t=1) rewards at
    test_scenario_parity.py's tolerance."""
    data = np.load(os.path.join(GOLDEN, f"scenario_{golden}.npz"),
                   allow_pickle=True)
    kwargs = ast.literal_eval(str(data["kwargs_json"]))
    env = vmt_torch.make_env("road_traffic", num_envs=data["pos"].shape[2],
                             device="cpu", seed=0, **kwargs)
    env.reset(seed=0)
    env.scenario.inject_reference_ids(data["rt_scenario_id"],
                                      data["rt_path_id"], data["rt_point_id"])
    _replay_golden(golden, env, data, check_obs_rew=True)


# --------------------------------------------------------------------- #
# Live parity with the JAX env
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def jax_env():
    """The JAX road_traffic env, map '1', 4 agents, B = 4, no observation
    noise (built once: it takes seconds)."""
    return vmt.make_env("road_traffic", num_envs=4, seed=0, n_agents=4,
                        is_add_noise=False)


def test_live_parity(jax_env):
    """The JAX env's state, scenario extras included, carried into the
    port; the same numpy actions for 5 steps: obs, rewards and the
    scenario's extras within 1e-5 growing x1.6 a step, dones exact."""
    env = _env(4, is_add_noise=False)
    arrays = jax_state_arrays(jax_env.state)
    assert set(arrays["extras"]) == set(env.world.state.extras)
    for key, v in env.world.state.extras.items():
        assert v.numpy().dtype == arrays["extras"][key].dtype, key
    state_from_numpy(env, arrays)
    rng = np.random.RandomState(0)
    for t in range(5):
        acts = [np.stack([rng.uniform(-1, 1, 4), rng.uniform(-0.6, 0.6, 4)],
                         -1).astype(np.float32) for _ in range(4)]
        j_obs, j_rew, j_done, _ = jax_env.step(acts)
        obs, rew, done, info = env.step([torch.as_tensor(a) for a in acts])
        atol = 1e-5 * 1.6**t
        for k in range(4):
            np.testing.assert_allclose(obs[k].numpy(), np.asarray(j_obs[k]),
                                       atol=atol, err_msg=f"obs {k} step {t}")
            np.testing.assert_allclose(rew[k].numpy(), np.asarray(j_rew[k]),
                                       atol=atol, err_msg=f"rew {k} step {t}")
        np.testing.assert_array_equal(done.numpy(), np.asarray(j_done))
        ours = state_to_numpy(env)["extras"]
        for key, ref in jax_state_arrays(jax_env.state)["extras"].items():
            if ref.dtype == np.float32:
                np.testing.assert_allclose(ours[key], ref, atol=atol,
                                           err_msg=f"{key} step {t}")
            else:
                np.testing.assert_array_equal(ours[key], ref,
                                              err_msg=f"{key} step {t}")
    assert set(info[0]) == {"pos", "rot", "vel", "act_vel", "act_steer",
                            "ref", "distance_ref", "distance_left_b",
                            "distance_right_b", "is_collision_with_agents",
                            "is_collision_with_lanelets"}


def test_same_seed_same_trajectory(B=4, n_steps=4):
    def run(seed):
        env = vmt_torch.make_env("road_traffic", num_envs=B, device="cpu",
                                 seed=seed, n_agents=4)
        out = [env.reset()]
        for _ in range(n_steps):
            out.append(env.step(env.get_random_actions())[0])
        return torch.stack([torch.cat(o, dim=-1) for o in out])

    a, b, c = run(3), run(3), run(4)
    assert a.shape == (n_steps + 1, B, 4 * 32)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)


# --------------------------------------------------------------------- #
# Map '3', testing mode, per-agent resets (tests/test_road_traffic.py)
# --------------------------------------------------------------------- #
def _step_zero(env):
    return env.step([torch.zeros((env.num_envs, 2)) for _ in env.agents])


def _force_overlap(env, env_i=0):
    """Agents 0 and 1 of one env crossing each other (a strict crossing
    at the next step; coincident rectangles would not register)."""
    B = env.num_envs
    target = torch.tensor([2.25, 2.0])
    for k, a in enumerate((env.agents[0], env.agents[1])):
        off = torch.tensor([0.01 * k, 0.005 * k])
        a.set_pos((target + off).expand(B, 2), batch_index=env_i)
        a.set_rot(torch.full((B, 1), 0.8 * k), batch_index=env_i)
        a.set_vel(torch.zeros((B, 2)), batch_index=env_i)


@pytest.mark.parametrize("map_type", ["1", "3"])
def test_forced_crossing_ends_the_episode(map_type):
    env = _env(2, map_type=map_type)
    _force_overlap(env, env_i=0)
    _, _, dones, infos = _step_zero(env)
    assert bool(dones[0]) and bool(infos[0]["is_collision_with_agents"][0])


def test_map_type_3_paths_within_group():
    env = _env(8, map_type="3")
    sc = env.scenario
    sid = sc.scenario_id.numpy()
    assert (sid == 1).all()  # default scenario_probabilities=[1, 0, 0]
    pid = sc.path_id.numpy()
    lo = sc.group_offsets[sid - 1]
    hi = lo + sc.group_sizes[sid - 1]
    assert (pid >= lo[:, None]).all() and (pid < hi[:, None]).all()
    env = _env(16, map_type="3", n_agents=3,
               scenario_probabilities=[0.0, 1.0, 0.0])
    sc = env.scenario
    assert (sc.scenario_id.numpy() == 2).all()
    lo, size = sc.group_offsets[1], sc.group_sizes[1]
    assert ((sc.path_id.numpy() >= lo) & (sc.path_id.numpy() < lo + size)).all()
    with pytest.raises(ValueError):
        _env(2, map_type="3", n_agents=11)
    # Map '2' draws from the whole map, as map '1' does: one group of every
    # path.
    env = _env(2, map_type="2")
    sc = env.scenario
    assert list(sc.group_sizes) == [sc.n_paths] == [_env(2).scenario.n_paths]
    assert (sc.path_id.numpy() < sc.n_paths).all()


def test_testing_mode_never_done_and_replaces_colliders():
    env = _env(2, is_testing_mode=True)
    sc = env.scenario
    before = env.world.state.pos.clone()
    _force_overlap(env, env_i=0)
    _, _, dones, _ = _step_zero(env)
    assert not bool(dones.any()), "testing mode never terminates"
    p = env.world.state.pos
    assert float(torch.linalg.norm(p[0, 0] - p[0, 1])) >= (
        sc.reset_agent_min_distance * 0.99)
    assert not bool(sc.collide_agents[0].any())
    # only the colliding agents of env 0 moved away from the step
    assert float((p[1] - before[1]).abs().max()) < 0.1


def test_per_agent_reset_api():
    env = _env(2)
    sc = env.scenario
    before = env.world.state.pos.clone()
    sc.reset_world_at(env_index=0, agent_index=2)
    after = env.world.state.pos
    moved = torch.linalg.norm(after - before, dim=-1) > 1e-9
    expected = torch.zeros_like(moved)
    expected[0, 2] = True
    assert torch.equal(moved, expected)
    d = torch.linalg.norm(after[0, 2] - after[0, [0, 1, 3]], dim=-1)
    assert bool((d >= sc.reset_agent_min_distance * 0.99).all())


def test_done_query_in_reset_replaces_no_agent():
    """``done_query(in_reset=True)`` reports the flags and re-places no
    agent, where ``done()`` re-places the testing mode's colliders; the
    Environment's reset asks with ``in_reset=True``."""
    env = _env(2, is_testing_mode=True)
    sc = env.scenario
    sc.collide_agents = torch.ones_like(sc.collide_agents)
    pos = env.world.state.pos.clone()
    assert not bool(sc.done_query(in_reset=True).any())
    assert torch.equal(env.world.state.pos, pos)
    sc.done()
    assert not torch.equal(env.world.state.pos, pos)

    calls = []
    done_query = type(sc).done_query
    sc.done_query = lambda *, in_reset=False: (
        calls.append(in_reset) or done_query(sc, in_reset=in_reset))
    env.reset()
    env.reset_at(1)
    _step_zero(env)
    assert calls == [True, True, False]
