"""road_traffic's three road-geometry kernels as hand-written CUDA
(``csrc/road_geometry.cu``).

Replaces the JAX package's Pallas kernels in
``ops/road_geometry_pallas.py``: ``_make_agent_kernel`` and
``_make_pair_kernel`` (behind ``fused_geometry``) and
``_make_neighbor_obs_kernel`` (behind ``fused_neighbor_obs``).  This
module holds:

* ``PathTables`` and ``path_tables``: the scenario's padded reference
  paths and their chunk boxes (``chunk_boxes``) as device tensors, with the
  kernels' ``RoadParams`` struct pointing at them, made once per scenario
  at ``make_world``;
* ``agent_variant``: the agent-geometry kernel with another lane group
  (``lane_boxes``), without culling or with the tables in shared memory,
  for comparisons;
* ``fused_geometry``: every per-step path quantity of road_traffic.  On
  CUDA tensors it launches the agent-geometry kernel and, with collisions,
  the pair kernel, or raises; on CPU tensors it runs
  ``road_geometry.geometry_plain``;
* ``fused_neighbor_obs``: the k nearest agents in the ego frame; the
  neighbour kernel on CUDA tensors, ``road_geometry.neighbor_obs_plain`` on
  CPU tensors;
* ``LAUNCHES``: the launches of each kernel, counted where it is launched
  and nowhere else.

Both entry points are ``torch.autograd.Function`` s whose backward re-runs
the plain version under autograd, as the JAX package's ``custom_vjp`` s
replay their jnp mirrors (the path ids get no gradient).  The kernels are
built at first use by :mod:`.cuda_build`.
"""
from __future__ import annotations

import contextlib
import ctypes
import os
from typing import NamedTuple

import numpy as np
import torch

from vectorizedmultiagentsimulator_tpu_torch.ops import cuda_build
from vectorizedmultiagentsimulator_tpu_torch.ops import road_geometry as rg

KERNELS = ("agent_geometry", "pair_collisions", "neighbor_obs")
LAUNCHES = dict.fromkeys(KERNELS, 0)

SOURCE = os.path.join(cuda_build.CSRC, "road_geometry.cu")

# The agent-geometry kernel's layout (RoadParams.lanes, .staged), chosen by
# the device time at road_traffic@10k on the H100 over 4, 8, 16 and 32
# lanes an agent and both table placements (PERF.md section 6, row 5).
AGENT_LANES = 8
STAGED = False
LANE_GROUPS = (4, 8, 16, 32)

Tensor = torch.Tensor

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


class _RoadParams(ctypes.Structure):
    """``RoadParams`` of csrc/road_geometry.cu, field for field."""

    _fields_ = [(n, _P) for n in ("center", "left", "right", "meta", "ends",
                                  "boxes")]
    _fields_ += [(n, _I) for n in ("n_paths", "P", "A", "K", "SI",
                                   "entry_exit", "lanes", "chunks", "cull",
                                   "staged")]
    _fields_ += [("half_l", _F), ("half_w", _F)]


class PathTables(NamedTuple):
    """A scenario's reference paths on its device and its static geometry.

    ``center``, ``left``, ``right`` [n_paths, P, 2] float32; ``n_points``,
    ``n_left``, ``n_right`` [n_paths] int32; ``is_loop`` [n_paths] bool;
    ``entry``, ``exit`` [n_paths, 2, 2] float32 (the plain version's
    tables); ``meta`` [n_paths, 4] int32 and ``ends`` [n_paths, 2, 2, 2]
    float32 (the same, packed for the kernels); ``boxes`` [n_paths, 3,
    chunks, 4] float32, ``chunk_boxes`` at the agent kernel's lane group,
    and ``boxes_at``, those of each group made so far.  ``width``,
    ``length``: the agents' box; ``K`` short-term points every ``SI``-th
    point; ``entry_exit``: whether collisions test the entry and exit
    segments; ``A``: agents; ``struct``: the kernels' ``RoadParams``."""

    center: Tensor
    left: Tensor
    right: Tensor
    n_points: Tensor
    n_left: Tensor
    n_right: Tensor
    is_loop: Tensor
    entry: Tensor
    exit: Tensor
    meta: Tensor
    ends: Tensor
    boxes: Tensor
    boxes_at: dict
    width: float
    length: float
    K: int
    SI: int
    entry_exit: bool
    A: int
    struct: _RoadParams

    @property
    def kernel_tensors(self):
        """The device tensors the kernels read."""
        return (self.center, self.left, self.right, self.meta, self.ends,
                self.boxes)


def chunk_boxes(center, left, right, n_points, n_left, n_right,
                lanes: int) -> np.ndarray:
    """[n_paths, 3, chunks, 4] float32: for the centre line, the left and
    the right boundary of each path (numpy ``[n_paths, P, 2]`` float32
    tables with their point counts), the least and largest x and y (xmin,
    ymin, xmax, ymax) of the points of each chunk of ``lanes`` consecutive
    real segments.  A row of n points has max(n - 1, 1) segments, segment
    j joining points j and j + 1; ``chunks`` = ceil((P - 1) / lanes), and
    the boxes past a row's last chunk are zero (never read)."""
    n_paths, P = center.shape[:2]
    chunks = -(-(P - 1) // lanes)
    out = np.zeros((n_paths, 3, chunks, 4), np.float32)
    for r, (table, counts) in enumerate(((center, n_points), (left, n_left),
                                         (right, n_right))):
        for path in range(n_paths):
            n_seg = max(int(counts[path]) - 1, 1)
            for c in range(-(-n_seg // lanes)):
                pts = table[path, c * lanes:min((c + 1) * lanes, n_seg) + 1]
                out[path, r, c, :2] = pts.min(axis=0)
                out[path, r, c, 2:] = pts.max(axis=0)
    return out


def path_tables(paths, *, width: float, length: float, K: int, SI: int,
                entry_exit: bool, n_agents: int, device) -> PathTables:
    """``PathTables`` of ``paths`` (``road_traffic_map.PaddedPaths``),
    copied to ``device`` once."""

    def on_dev(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x, dtype=dtype),
                               device=device)

    meta = np.stack([paths.n_points, paths.n_left, paths.n_right,
                     paths.is_loop.astype(np.int32)], axis=1)
    ends = np.stack([paths.entry, paths.exit], axis=1)
    t = dict(
        center=on_dev(paths.center, np.float32),
        left=on_dev(paths.left, np.float32),
        right=on_dev(paths.right, np.float32),
        n_points=on_dev(paths.n_points, np.int32),
        n_left=on_dev(paths.n_left, np.int32),
        n_right=on_dev(paths.n_right, np.int32),
        is_loop=on_dev(paths.is_loop, np.bool_),
        entry=on_dev(paths.entry, np.float32),
        exit=on_dev(paths.exit, np.float32),
        meta=on_dev(meta, np.int32),
        ends=on_dev(ends, np.float32),
    )
    t["boxes"] = on_dev(chunk_boxes(
        paths.center.astype(np.float32), paths.left.astype(np.float32),
        paths.right.astype(np.float32), paths.n_points, paths.n_left,
        paths.n_right, AGENT_LANES), np.float32)
    n_paths, P = paths.center.shape[:2]
    struct = _RoadParams(
        *(t[k].data_ptr() for k in ("center", "left", "right", "meta",
                                    "ends", "boxes")),
        n_paths, P, n_agents, K, SI, int(entry_exit), AGENT_LANES,
        t["boxes"].shape[2], 1, int(STAGED), length / 2, width / 2,
    )
    return PathTables(**t, boxes_at={AGENT_LANES: t["boxes"]}, width=width,
                      length=length, K=K, SI=SI, entry_exit=bool(entry_exit),
                      A=n_agents, struct=struct)


def lane_boxes(tables: PathTables, lanes: int) -> Tensor:
    """``tables``' chunk boxes for a group of ``lanes`` (4, 8, 16 or 32), on
    their device, made at first use."""
    if lanes not in LANE_GROUPS:
        raise ValueError(f"lanes must be one of {LANE_GROUPS}")
    boxes = tables.boxes_at.get(lanes)
    if boxes is None:
        host = [x.cpu().numpy() for x in (
            tables.center, tables.left, tables.right, tables.n_points,
            tables.n_left, tables.n_right)]
        boxes = tables.boxes_at[lanes] = torch.as_tensor(
            chunk_boxes(*host, lanes), device=tables.center.device)
    return boxes


@contextlib.contextmanager
def agent_variant(tables: PathTables, lanes: int = None, cull: bool = None,
                  staged: bool = None):
    """Launch ``tables``' agent-geometry kernel with ``lanes`` threads an
    agent (4, 8, 16 or 32; ``lane_boxes``), without chunk culling (``cull=False``) or with the path tables
    staged in shared memory (``staged=True``): phase 2 and the tests hold
    every variant to the plain version.  The chosen layout comes back on
    exit."""
    s = tables.struct
    saved = (s.lanes, s.chunks, s.boxes, s.cull, s.staged)
    try:
        if lanes is not None:
            boxes = lane_boxes(tables, lanes)
            s.lanes, s.chunks, s.boxes = (lanes, boxes.shape[2],
                                          boxes.data_ptr())
        if cull is not None:
            s.cull = int(cull)
        if staged is not None:
            s.staged = int(staged)
        yield
    finally:
        s.lanes, s.chunks, s.boxes, s.cull, s.staged = saved


def build() -> str:
    """Compile the kernel library if needed; returns its path."""
    return cuda_build.build(SOURCE)


_fns = {}


def _library(symbol: str):
    """The entry point ``symbol`` of the library, built and bound at its
    first launch."""
    fn = _fns.get(symbol)
    if fn is None:
        argtypes = {
            "vmt_road_agent_geometry": [_P] * 12 + [_I, _I, _P],
            "vmt_road_pair_collisions": [_P] * 5 + [_I, _P],
            "vmt_road_neighbor_obs": [_P] * 9 + [_I, _I, _I, _F, _F, _P],
        }[symbol]
        fn = _fns[symbol] = cuda_build.entry_point(SOURCE, symbol, argtypes)
    return fn


def _check(dev, checks):
    for name, x, shape, dtype in checks:
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, expected {dev}")
        if x.dtype != dtype:
            raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(
                f"{name} has shape {tuple(x.shape)}, expected {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _geometry_inputs(tables, pos, rot, path_id=None):
    dev = pos.device
    if dev.type != "cuda":
        raise ValueError(f"the kernels run on CUDA tensors, got {dev}")
    B, A = pos.shape[0], tables.A
    checks = [("pos", pos, (B, A, 2), torch.float32),
              ("rot", rot, (B, A), torch.float32)]
    if path_id is not None:
        checks.append(("path_id", path_id, (B, A), torch.int32))
    _check(dev, checks)
    if tables.center.device != dev:
        raise ValueError(f"the path tables are on {tables.center.device},"
                         f" expected {dev}")
    return dev, B, A, dict(dtype=torch.float32, device=dev)


def launch_agent_geometry(tables: PathTables, with_collisions: bool,
                          pos: Tensor, rot: Tensor, path_id: Tensor):
    """Launch the agent-geometry kernel on PyTorch's current stream;
    returns ``agent_geometry_plain``'s outputs, allocated here."""
    dev, B, A, f32 = _geometry_inputs(tables, pos, rot, path_id)
    outs = (torch.empty((B, A), **f32), torch.empty((B, A, 5), **f32),
            torch.empty((B, A, 5), **f32), torch.empty((B, A), **f32),
            torch.empty((B, A, tables.K, 2), **f32))
    flags = tuple(torch.empty((B, A), **f32) for _ in range(3)) \
        if with_collisions else (None,) * 3
    err = _library("vmt_road_agent_geometry")(
        pos.data_ptr(), rot.data_ptr(), path_id.data_ptr(),
        *(o.data_ptr() for o in outs),
        *(None if f is None else f.data_ptr() for f in flags),
        ctypes.addressof(tables.struct), B, int(with_collisions),
        _stream(dev),
    )
    if err != 0:
        raise RuntimeError(
            f"agent-geometry kernel launch failed: CUDA error {err}")
    LAUNCHES["agent_geometry"] += 1
    return outs + flags if with_collisions else outs


def launch_pair_collisions(tables: PathTables, pos: Tensor, rot: Tensor):
    """Launch the pair kernel on PyTorch's current stream; returns
    ``pair_collisions_plain``'s outputs, allocated here."""
    dev, B, A, f32 = _geometry_inputs(tables, pos, rot)
    vertices = torch.empty((B, A, 5, 2), **f32)
    agents = torch.empty((B, A, A), **f32)
    err = _library("vmt_road_pair_collisions")(
        pos.data_ptr(), rot.data_ptr(), vertices.data_ptr(),
        agents.data_ptr(), ctypes.addressof(tables.struct), B, _stream(dev),
    )
    if err != 0:
        raise RuntimeError(
            f"pair-collision kernel launch failed: CUDA error {err}")
    LAUNCHES["pair_collisions"] += 1
    return vertices, agents


def launch_geometry(tables: PathTables, with_collisions: bool, pos: Tensor,
                    rot: Tensor, path_id: Tensor):
    """The agent-geometry kernel and, with collisions, the pair kernel;
    returns ``geometry_plain``'s outputs."""
    out = launch_agent_geometry(tables, with_collisions, pos, rot, path_id)
    if not with_collisions:
        return out
    vertices, agents = launch_pair_collisions(tables, pos, rot)
    return out[:5] + (vertices,) + out[5:] + (agents,)


# The neighbour kernel's operand layouts checked so far: (A, k, and each
# operand's shape, strides, dtype and device).  A layout is checked once.
_NEIGHBOR_CHECKED = set()


def launch_neighbor_obs(A: int, k: int, half_l: float, half_w: float,
                        pos: Tensor, rot: Tensor, vel: Tensor, dn: Tensor):
    """Launch the neighbour kernel on PyTorch's current stream; returns
    ``neighbor_obs_plain``'s outputs, contiguous views of one buffer
    allocated here."""
    dev = pos.device
    key = (A, k) + tuple((x.shape, x.stride(), x.dtype, x.device)
                         for x in (pos, rot, vel, dn))
    if key not in _NEIGHBOR_CHECKED:
        if dev.type != "cuda":
            raise ValueError(f"the kernel runs on CUDA tensors, got {dev}")
        if not 1 <= k < A <= 64:
            raise ValueError(f"the kernel takes 1 <= k < A <= 64, got k={k},"
                             f" A={A}")
        B = pos.shape[0]
        _check(dev, [("pos", pos, (B, A, 2), torch.float32),
                     ("rot", rot, (B, A), torch.float32),
                     ("vel", vel, (B, A, 2), torch.float32),
                     ("dn", dn, (B, A, A), torch.float32)])
        _NEIGHBOR_CHECKED.add(key)
    B = pos.shape[0]
    n = B * A * k
    nd, pe, rr, ve, vt = torch.empty(
        14 * n, dtype=torch.float32, device=dev).split(
            (n, 2 * n, n, 2 * n, 8 * n))
    outs = (nd.view(B, A, k), pe.view(B, A, k, 2), rr.view(B, A, k),
            ve.view(B, A, k, 2), vt.view(B, A, k, 4, 2))
    err = _library("vmt_road_neighbor_obs")(
        pos.data_ptr(), rot.data_ptr(), vel.data_ptr(), dn.data_ptr(),
        *(o.data_ptr() for o in outs), B, A, k, half_l, half_w, _stream(dev),
    )
    if err != 0:
        raise RuntimeError(
            f"neighbour-observation kernel launch failed: CUDA error {err}")
    LAUNCHES["neighbor_obs"] += 1
    return outs


def _on(inputs):
    """``"cuda"`` or ``"cpu"``: where all ``inputs`` lie."""
    devices = {x.device.type for x in inputs}
    if devices in ({"cuda"}, {"cpu"}):
        return devices.pop()
    raise ValueError(f"inputs on mixed devices: {devices}")


def _replay(ctx, plain, grads, n_lead):
    """Gradients of ``plain`` (run again under autograd on the saved
    inputs) for the inputs that need them; ``n_lead`` leading arguments of
    the forward get none."""
    needs = ctx.needs_input_grad[n_lead:]
    inputs = [x.detach().requires_grad_(need and x.is_floating_point())
              for x, need in zip(ctx.saved_tensors, needs)]
    wrt = [x for x in inputs if x.requires_grad]
    with torch.enable_grad():
        outs = [o for o in plain(*inputs)]
    pairs = [(o, g) for o, g in zip(outs, grads)
             if g is not None and o.requires_grad]
    got = iter(torch.autograd.grad([o for o, _ in pairs],
                                   wrt, [g for _, g in pairs],
                                   allow_unused=True)
               if pairs and wrt else [None] * len(wrt))
    return (None,) * n_lead + tuple(
        next(got) if x.requires_grad else None for x in inputs)


class _FusedGeometry(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tables, with_collisions, pos, rot, path_id):
        ctx.save_for_backward(pos, rot, path_id)
        ctx.tables, ctx.with_collisions = tables, with_collisions
        if _on((pos, rot, path_id)) == "cuda":
            outs = launch_geometry(tables, with_collisions, pos, rot, path_id)
        else:
            outs = rg.geometry_plain(tables, with_collisions, pos, rot,
                                     path_id)
        # The crossing flags and the index-selected short-term points have
        # no gradient in the plain version either.
        return outs

    @staticmethod
    def backward(ctx, *grads):
        def plain(pos, rot, path_id):
            return rg.geometry_plain(ctx.tables, ctx.with_collisions, pos,
                                     rot, path_id)

        return _replay(ctx, plain, grads, 2)


def _neighbor_obs(A, k, half_l, half_w, pos, rot, vel, dn):
    if _on((pos, rot, vel, dn)) == "cuda":
        return launch_neighbor_obs(A, k, half_l, half_w, pos, rot, vel, dn)
    return rg.neighbor_obs_plain(A, k, half_l, half_w, pos, rot, vel, dn)


class _FusedNeighborObs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, A, k, half_l, half_w, pos, rot, vel, dn):
        ctx.save_for_backward(pos, rot, vel, dn)
        ctx.static = (A, k, half_l, half_w)
        return _neighbor_obs(A, k, half_l, half_w, pos, rot, vel, dn)

    @staticmethod
    def backward(ctx, *grads):
        def plain(pos, rot, vel, dn):
            return rg.neighbor_obs_plain(*ctx.static, pos, rot, vel, dn)

        return _replay(ctx, plain, grads, 4)


def fused_geometry(tables: PathTables, with_collisions: bool, pos: Tensor,
                   rot: Tensor, path_id: Tensor):
    """``road_geometry.geometry_plain``'s outputs: the kernels on CUDA
    tensors, the plain version on CPU tensors; differentiable in ``pos``
    and ``rot`` through the plain version.  ``path_id`` is int32."""
    return _FusedGeometry.apply(tables, with_collisions, pos, rot, path_id)


def fused_neighbor_obs(A: int, k: int, half_l: float, half_w: float,
                       pos: Tensor, rot: Tensor, vel: Tensor, dn: Tensor):
    """``road_geometry.neighbor_obs_plain``'s outputs: the kernel on CUDA
    tensors, the plain version on CPU tensors; differentiable through the
    plain version."""
    if torch.is_grad_enabled() and (pos.requires_grad or rot.requires_grad
                                    or vel.requires_grad or dn.requires_grad):
        return _FusedNeighborObs.apply(A, k, half_l, half_w, pos, rot, vel,
                                       dn)
    return _neighbor_obs(A, k, half_l, half_w, pos, rot, vel, dn)
