"""The physics step as a hand-written CUDA kernel (``csrc/physics_step.cu``).

Replaces the JAX package's Pallas kernel
(``ops/physics_pallas.py::_make_kernel``).  This module holds:

* ``step_supported(world)``: whether a world's step runs the kernel,
  decided from its static tables (mirrors ``physics_pallas.step_supported``
  and adds the pair classes and joints the kernel does not cover yet);
* ``step_plain``: the plain PyTorch version, ``World._step_core``;
* ``fused_step``: the wrapper.  On CUDA tensors it launches the kernel or
  raises; on CPU tensors it runs ``step_plain``.  It is a
  ``torch.autograd.Function`` whose backward re-runs ``step_plain`` under
  autograd, as the JAX package's ``custom_vjp`` re-runs its jnp core;
* ``LAUNCHES``: the number of kernel launches, counted where the kernel is
  launched and nowhere else.

The kernel is compiled with ``nvcc`` at first use, from the source in this
package, into ``_build/<source hash>/`` beside it, and loaded with ctypes.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from typing import Optional, Tuple

import numpy as np
import torch

LAUNCHES = 0

MAX_ENTITIES = 64

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "physics_step.cu")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

# -fmad=false: the kernel repeats the plain version's operations in its
# order, and without contracted multiply-adds its contact distances carry
# the plain version's bits (see the note at the top of the source).
# -Xptxas=-v writes each kernel's registers and spills to build.log.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

# Classes the kernel covers; worlds with any other pair class step through
# the plain version (ROADMAP Q2-1b ports them).
_KERNEL_CLASSES = ("ss", "bs")


def step_supported(world) -> bool:
    """Whether ``world`` steps through the kernel: at most 64 entities, no
    per-env mass, only sphere-sphere and box-sphere pairs (no joints are
    ported), and the JAX kernel's unroll-size guard."""
    if world._n_entities > MAX_ENTITIES:
        return False
    if any(world.has_extra(f"{e.name}.dyn_mass") for e in world.entities):
        return False
    if any(len(p) for c, p in world._pairs.items() if c not in _KERNEL_CLASSES):
        return False
    cost = len(world._pairs["ss"]) + 2 * len(world._pairs["bs"])
    return cost * world._substeps <= 2048


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


# ---------------------------------------------------------------------- #
# Build and bind
# ---------------------------------------------------------------------- #
def find_nvcc() -> str:
    """``nvcc`` on PATH, then ``$CUDA_HOME/bin``, then
    ``/usr/local/cuda/bin``."""
    found = shutil.which("nvcc")
    if found:
        return found
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the"
        " physics kernel cannot be built"
    )


def _source_hash() -> str:
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile the kernel library if this source has not been built yet;
    returns the path of the shared library."""
    out_dir = os.path.join(BUILD_DIR, _source_hash())
    lib_path = os.path.join(out_dir, "libvmt_physics.so")
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    with open(os.path.join(out_dir, "build.log"), "w") as f:
        f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    os.replace(tmp, lib_path)
    return lib_path


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = (
    [_P] * 11  # pos, vel, rot, ang_vel, force_a, torque_a, dyn_g, 4 outputs
    + [_P] * 17  # static tables and pair lists
    + [_I] * 8  # B, N, A, n_landmarks, D, n_ss, n_bs, substeps
    + [_F] * 3  # sub_dt, contact_margin, collision_force
    + [_I, _F, _I, _F]  # has_x_semidim, x_semidim, has_y_semidim, y_semidim
    + [_P]  # stream
)


@functools.lru_cache(maxsize=None)
def _library():
    lib = ctypes.CDLL(build())
    fn = lib.vmt_physics_step
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def kernel_tables(world) -> Tuple[torch.Tensor, ...]:
    """The 17 static tables the kernel reads, on the world's device, in the
    order of ``vmt_physics_step``'s table parameters: the world's float32
    device tables, plus int32 copies of the flags and pair lists.  Built
    once, at finalize."""
    t = world._t
    names = [e.name for e in world.entities]
    dyn_row = np.full((len(names),), -1, dtype=np.int32)
    for k, n in enumerate(world._dyn_gravity_names):
        dyn_row[names.index(n)] = k

    def i32(x):
        return torch.as_tensor(
            np.ascontiguousarray(x, dtype=np.int32), device=world.device
        )

    return (
        i32(world._movable), i32(world._rotatable), t["mass"], t["moment"],
        t["drag_coef"], t["max_speed"], t["v_range"], t["gravity_vec"],
        i32(dyn_row), t["radius"], t["length"], t["width"],
        i32(world._hollow), t["lin_friction"], t["ang_friction"],
        i32(world._pairs["ss"]), i32(world._pairs["bs"]),
    )


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
    tables: Optional[Tuple[torch.Tensor, ...]] = world._kernel_tables
    if tables is None or not world._use_kernel:
        raise RuntimeError("this world does not step through the kernel")
    B, N = pos.shape[0], world._n_entities
    A = len(world.agents)
    D = len(world._dyn_gravity_names)
    dev = pos.device
    if dev.type != "cuda":
        raise ValueError(f"the kernel runs on CUDA tensors, got {dev}")
    if tables[0].device != dev:
        raise ValueError(f"world tables are on {tables[0].device}, state on {dev}")
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
    fn = _library()
    err = fn(
        *(x.data_ptr() for x in (pos, vel, rot, ang_vel, force_a, torque_a,
                                 dyn_g)),
        *(x.data_ptr() for x in out),
        *(x.data_ptr() for x in tables),
        B, N, A, world._n_landmarks, D,
        len(world._pairs["ss"]), len(world._pairs["bs"]), world._substeps,
        world._sub_dt, world._contact_margin, world._collision_force,
        int(world._x_semidim is not None), float(world._x_semidim or 0.0),
        int(world._y_semidim is not None), float(world._y_semidim or 0.0),
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
