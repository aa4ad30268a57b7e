"""The physics step as a hand-written CUDA kernel (``csrc/physics_step.cu``).

Replaces the JAX package's Pallas kernel
(``ops/physics_pallas.py::_make_kernel``).  This module holds:

* ``step_supported(world)``: whether a world's step runs the kernel,
  decided from its static tables (mirrors ``physics_pallas.step_supported``,
  joints included);
* ``step_plain``: the plain PyTorch version, ``World._step_core``;
* ``fused_step``: the wrapper.  On CUDA tensors it launches the kernel or
  raises; on CPU tensors it runs ``step_plain``.  It is a
  ``torch.autograd.Function`` whose backward re-runs ``step_plain`` under
  autograd, as the JAX package's ``custom_vjp`` re-runs its jnp core;
* ``LAUNCHES``: the number of kernel launches, counted where the kernel is
  launched and nowhere else;
* ``lane_group(world)``: the threads that step one env (a power of two up
  to 8), chosen at finalize from the world's weighted pair cost, and
  ``lanes(world, G)``, which forces another for a comparison.

The kernel is built at first use by :mod:`.cuda_build`.
"""
from __future__ import annotations

import contextlib
import ctypes
import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from vectorizedmultiagentsimulator_tpu_torch.ops import cuda_build

LAUNCHES = 0

MAX_ENTITIES = 64

SOURCE = os.path.join(cuda_build.CSRC, "physics_step.cu")

# The pair classes, in the order of their rows in the kernel's pair table
# (enum PairClass in csrc/physics_step.cu).
KERNEL_CLASSES = ("ss", "bs", "ls", "ll", "bl", "bb")
# The JAX kernel's per-pair unroll weights (physics_pallas.step_supported).
PAIR_WEIGHTS = {"ss": 1, "bs": 2, "ls": 1, "ll": 3, "bl": 8, "bb": 16}


def step_supported(world) -> bool:
    """Whether ``world`` steps through the kernel: at most 64 entities, no
    per-env mass, no per-env joint fixed rotation, and the JAX kernel's
    size guard (weighted pair count plus 2 a joint constraint, x substeps
    <= 2048).

    The JAX kernel refuses a per-env fixed rotation once the first reset
    has written it; here the decision is made at finalize, so a constraint
    whose ``Joint.notify`` will write one (``inferred_rotation``: a
    ``dist > 0`` joint end with ``rotate`` False and no fixed rotation
    given) is refused from the start.  A dist-0 constraint with ``rotate``
    False and no fixed rotation keeps 0 on the kernel, as in JAX; any
    other constraint's fixed rotation is static once the world is
    finalized (``JointConstraint.fixed_rotation`` raises)."""
    if world._n_entities > MAX_ENTITIES:
        return False
    if any(world.has_extra(f"{e.name}.dyn_mass") for e in world.entities):
        return False
    cons = world._ordered_constraints
    if any(c.inferred_rotation for c in cons):
        return False
    return pair_cost(world) * world._substeps <= 2048


# Weighted pair cost a lane takes before the group widens past 2, and the
# narrowest and widest groups (VMT_MAX_LANES: warps a block).  Measured on
# the H100 over 1, 2, 4 and 8 lanes on the nine stepping paths (PERF.md
# section 6): 2 lanes beat 1 everywhere (a block of one warp leaves the SM
# short of warps), and 8 beat 4 only on the two heaviest worlds.
COST_PER_LANE = 12
MIN_LANES = 2
MAX_LANES = 8  # VMT_MAX_LANES: warps a block
BLOCK_ENVS = 32  # VMT_WARP: envs a block, one a thread of each warp
MAX_SMEM_BYTES = 232448  # VMT_MAX_SMEM_BYTES


def pair_cost(world) -> int:
    """The JAX kernel's weighted size of one substep: ``PAIR_WEIGHTS`` per
    pair, plus 2 a joint constraint."""
    cost = sum(w * len(world._pairs[c]) for c, w in PAIR_WEIGHTS.items())
    return cost + 2 * len(world._ordered_constraints)


def smem_bytes(n_entities: int, n_pairs: int, n_joints: int,
               lanes: int) -> int:
    """A block's shared memory in csrc/physics_step.cu (``shared_bytes``):
    the tables, ``BLOCK_ENVS`` envs' state (13 fields: pose, velocities,
    the fixed forces, cos and sin of the rotation and of it + pi/2) at an
    odd stride, and each lane's force and torque sums for each env."""
    n, envs, ns = n_entities, BLOCK_ENVS, n_entities | 1
    ints = 4 * n + 2 * n_pairs + 3 * n_joints
    floats = 12 * n + 6 * n_joints + 13 * envs * ns + envs * lanes * 3 * ns
    return 4 * (ints + floats)


def lane_group(world) -> int:
    """Threads an env for ``world``: ``pair_cost // COST_PER_LANE`` rounded
    down to a power of two between ``MIN_LANES`` and ``MAX_LANES`` (2 for
    transport's 14 and buzz_wire's 23, 8 for joint_passage's 113 and
    football 5v5's 165), narrowed until a block's state fits its shared
    memory."""
    joints = len(world._ordered_constraints)
    pairs = sum(len(world._pairs[c]) for c in KERNEL_CLASSES)
    want = min(MAX_LANES, max(MIN_LANES, pair_cost(world) // COST_PER_LANE))
    lanes = 1 << (want.bit_length() - 1)
    while lanes > 1 and smem_bytes(world._n_entities, pairs, joints,
                                   lanes) > MAX_SMEM_BYTES:
        lanes //= 2
    return lanes


def stacked_dyn_gravity(world, extras) -> torch.Tensor:
    """The per-env dynamic gravity extras stacked as ``[B, D, 2]`` (D = 0
    when the world has none)."""
    names = world._dyn_gravity_names
    if not names:
        return world.state.pos.new_zeros((world.batch_dim, 0, 2))
    return torch.stack([extras[f"{n}.dyn_gravity"] for n in names], dim=1)


def step_plain(world, pos, vel, rot, ang_vel, force_a, torque_a, dyn_g):
    """The plain PyTorch version of the kernel: ``World._step_core``."""
    extras = {
        f"{n}.dyn_gravity": dyn_g[:, k]
        for k, n in enumerate(world._dyn_gravity_names)
    }
    return world._step_core(pos, vel, rot, ang_vel, force_a, torque_a, extras)


def build() -> str:
    """Compile the kernel library if needed; returns its path."""
    return cuda_build.build(SOURCE)


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# The [N] tables of csrc/physics_step.cu's Tables, in its field order; the
# packed pair table follows them.
_TABLE_FIELDS = (
    "movable", "rotatable", "mass", "moment", "drag", "max_speed", "v_range",
    "gravity", "dyn_row", "radius", "length", "width", "hollow", "lin_fric",
    "ang_fric",
)


class _Tables(ctypes.Structure):
    """``Tables`` of csrc/physics_step.cu, field for field."""

    _fields_ = [(n, _P) for n in _TABLE_FIELDS + ("pairs", "joint_idx",
                                                   "joint_geom")]


class _Dims(ctypes.Structure):
    """``Dims`` of csrc/physics_step.cu, field for field."""

    _fields_ = [
        ("B", _I), ("N", _I), ("A", _I), ("n_landmarks", _I), ("D", _I),
        ("substeps", _I), ("J", _I),
        ("pair_start", _I * (len(KERNEL_CLASSES) + 1)),
        ("sub_dt", _F), ("contact_margin", _F), ("collision_force", _F),
        ("joint_force", _F), ("torque_constraint_force", _F),
        ("has_x_semidim", _I), ("has_y_semidim", _I), ("x_semidim", _F),
        ("y_semidim", _F), ("lanes", _I),
    ]


class KernelTables(NamedTuple):
    """What a world's launches pass unchanged, built once at finalize: the
    device tensors of ``Tables`` (kept alive here), and the host addresses
    of the filled ``Tables`` and ``Dims`` structs."""

    tensors: Tuple[torch.Tensor, ...]
    structs: Tuple[_Tables, _Dims]
    addresses: Tuple[int, int]


_fn = None


def _library():
    """``vmt_physics_step``, built and bound at the first launch."""
    global _fn
    if _fn is None:
        _fn = cuda_build.entry_point(
            SOURCE, "vmt_physics_step", [_P] * 11 + [_P, _P, _P]
        )
    return _fn


def kernel_tables(world) -> KernelTables:
    """The kernel's static arguments for ``world``: its lane group, the
    world's float32 device tables, int32 copies of the flags, every class's
    pairs packed
    into one int32 ``[P, 2]`` table in ``KERNEL_CLASSES`` order, with the
    row where each class starts, and the joint constraints in the plain
    version's order as an int32 ``[J, 3]`` table (ia, ib, rotate) and a
    float32 ``[J, 6]`` one (anchor offsets of a and b, rest distance,
    static fixed rotation)."""
    t = world._t
    names = [e.name for e in world.entities]
    dyn_row = np.full((len(names),), -1, dtype=np.int32)
    for k, n in enumerate(world._dyn_gravity_names):
        dyn_row[names.index(n)] = k

    def i32(x):
        return torch.as_tensor(
            np.ascontiguousarray(x, dtype=np.int32), device=world.device
        )

    per_class = [
        np.asarray(world._pairs[c], dtype=np.int32).reshape(-1, 2)
        for c in KERNEL_CLASSES
    ]
    start = np.cumsum([0] + [len(p) for p in per_class])
    joint_idx = np.stack(
        [world._joint_ia, world._joint_ib, world._joint_rotate.astype(np.int32)],
        axis=1,
    )
    joint_geom = np.concatenate(
        [world._joint_delta_a, world._joint_delta_b,
         world._joint_dist[:, None], world._joint_fixed_rot[:, None]],
        axis=1,
    )
    tensors = (
        i32(world._movable), i32(world._rotatable), t["mass"], t["moment"],
        t["drag_coef"], t["max_speed"], t["v_range"], t["gravity_vec"],
        i32(dyn_row), t["radius"], t["length"], t["width"],
        i32(world._hollow), t["lin_friction"], t["ang_friction"],
        i32(np.concatenate(per_class)), i32(joint_idx),
        torch.as_tensor(joint_geom, device=world.device),
    )
    tables = _Tables(*(x.data_ptr() for x in tensors))
    dims = _Dims(
        world.batch_dim, world._n_entities, len(world.agents),
        world._n_landmarks, len(world._dyn_gravity_names), world._substeps,
        len(joint_idx), (_I * len(start))(*start.tolist()), world._sub_dt,
        world._contact_margin, world._collision_force, world._joint_force,
        world._torque_constraint_force,
        int(world._x_semidim is not None), int(world._y_semidim is not None),
        float(world._x_semidim or 0.0), float(world._y_semidim or 0.0),
        lane_group(world),
    )
    addresses = (ctypes.addressof(tables), ctypes.addressof(dims))
    return KernelTables(tensors, (tables, dims), addresses)


@contextlib.contextmanager
def lanes(world, group: int):
    """Step ``world``'s kernel with ``group`` threads an env inside the
    block (phase 2 and the tests hold every group to the plain version);
    the group chosen at finalize comes back on exit."""
    dims = world._kernel_tables.structs[1]
    chosen, dims.lanes = dims.lanes, group
    try:
        yield
    finally:
        dims.lanes = chosen


def _check(name, x: torch.Tensor, shape, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} has dtype {x.dtype}, expected float32")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def launch(world, pos, vel, rot, ang_vel, force_a, torque_a, dyn_g):
    """Launch the kernel on PyTorch's current stream; returns the new
    ``(pos, vel, rot, ang_vel)``, allocated here."""
    global LAUNCHES
    kt: Optional[KernelTables] = world._kernel_tables
    if kt is None or not world._use_kernel:
        raise RuntimeError("this world does not step through the kernel")
    dev = pos.device
    if dev.type != "cuda":
        raise ValueError(f"the kernel runs on CUDA tensors, got {dev}")
    if kt.tensors[0].device != dev:
        raise ValueError(
            f"world tables are on {kt.tensors[0].device}, state on {dev}"
        )
    B, N = world.batch_dim, world._n_entities
    A, D = len(world.agents), len(world._dyn_gravity_names)
    for name, x, shape in (
        ("pos", pos, (B, N, 2)),
        ("vel", vel, (B, N, 2)),
        ("rot", rot, (B, N, 1)),
        ("ang_vel", ang_vel, (B, N, 1)),
        ("force_a", force_a, (B, A, 2)),
        ("torque_a", torque_a, (B, A, 1)),
        ("dyn_g", dyn_g, (B, D, 2)),
    ):
        _check(name, x, shape, dev)
    out = [torch.empty_like(x) for x in (pos, vel, rot, ang_vel)]
    err = _library()(
        pos.data_ptr(), vel.data_ptr(), rot.data_ptr(), ang_vel.data_ptr(),
        force_a.data_ptr(), torque_a.data_ptr(), dyn_g.data_ptr(),
        *(x.data_ptr() for x in out), *kt.addresses,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"physics kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return tuple(out)

class _FusedStep(torch.autograd.Function):
    @staticmethod
    def forward(ctx, world, pos, vel, rot, ang_vel, force_a, torque_a, dyn_g):
        inputs = (pos, vel, rot, ang_vel, force_a, torque_a, dyn_g)
        ctx.world = world
        ctx.save_for_backward(*inputs)
        devices = {x.device.type for x in inputs}
        if devices == {"cuda"}:
            return launch(world, *inputs)
        if devices == {"cpu"}:
            return step_plain(world, *inputs)
        raise ValueError(f"inputs on mixed devices: {devices}")

    @staticmethod
    def backward(ctx, *grads):
        inputs = [
            x.detach().requires_grad_(need)
            for x, need in zip(ctx.saved_tensors, ctx.needs_input_grad[1:])
        ]
        with torch.enable_grad():
            outs = step_plain(ctx.world, *inputs)
        wrt = [x for x in inputs if x.requires_grad]
        pairs = [(o, g) for o, g in zip(outs, grads) if g is not None
                 and o.requires_grad]
        got = iter(
            torch.autograd.grad(
                [o for o, _ in pairs], wrt, [g for _, g in pairs],
                allow_unused=True,
            )
            if pairs and wrt
            else [None] * len(wrt)
        )
        return (None,) + tuple(
            next(got) if x.requires_grad else None for x in inputs
        )


def fused_step(world, pos, vel, rot, ang_vel, force_a, torque_a, dyn_g):
    """One full physics step (all substeps): the kernel on CUDA tensors,
    ``step_plain`` on CPU tensors; differentiable through ``step_plain``.
    Returns ``(pos, vel, rot, ang_vel)``."""
    return _FusedStep.apply(
        world, pos, vel, rot, ang_vel, force_a, torque_a, dyn_g
    )
