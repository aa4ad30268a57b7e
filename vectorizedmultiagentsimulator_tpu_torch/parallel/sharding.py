"""The env batch split over ranks: one process a GPU.

PyTorch counterpart of the JAX package's ``parallel/sharding.py``, with
its names.  There, every leaf of the state has the env batch leading, so
sharding that axis over a ``jax.sharding.Mesh`` partitions the whole step
with no collective.  Here the same split is one process a card over
``torch.distributed``: rank ``r`` of ``n`` holds an env of ``B / n`` envs
on its own device, whose state is rows ``[r B / n, (r + 1) B / n)`` of
the global env's (every ``WorldState`` field and every ``extras``
buffer).  The envs are independent, so stepping needs no collective
either; the data-parallel trainer (``examples/torch_ppo.py``) adds the
reductions of its update.

* ``make_mesh(n_devices=None)``: the 1-D ``"envs"`` mesh of the ranks of
  the default process group (``parallel.init_distributed``), or of one
  rank where there is none; ``make_mesh(rank=, world_size=)`` names a
  rank of a split with no process group (shards in one process, as the
  CPU tests make them);
* ``shard_state(state, mesh, batch_dim)``: a rank's rows of a state;
* ``shard_environment(env, mesh=None)``: the rank's env.  A built env
  cannot change its batch (scenarios size index buffers and tables by it
  in ``make_world``, and ``World`` and ``Environment`` fix it), so the
  rank's env is built anew from the same scenario and arguments at the
  local batch, and the rank's rows of the global env's state are loaded
  into it.  The global env is left as it was; split before the first
  step, since a CUDA graph or a LIDAR cache made before belongs to the
  global env.  ``parallel.rollout`` then runs on each rank's env as it is.

Random streams: after the split each rank's world generator is seeded
from ``(seed, rank)`` (``rank_seed``): one generator on every rank would
draw the same resets for different envs.  Rank 0 keeps ``seed``, so a
world of one draws what the one-process env draws.  This differs from the
JAX package, whose replicated key draws one global array for all shards;
the random streams of the two packages cannot match anyway.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from vectorizedmultiagentsimulator_tpu_torch.core.state import WorldState
from vectorizedmultiagentsimulator_tpu_torch.utils import STATE_FIELDS

# An odd 64-bit constant (the golden ratio's): rank r's seed is seed + r
# times it, so no two ranks of a world share a seed.
_SEED_STRIDE = 0x9E3779B97F4A7C15


def rank_seed(seed: Optional[int], rank: int) -> int:
    """The seed of rank ``rank``'s random streams: ``seed`` (0 for
    ``None``) on rank 0, another for each other rank."""
    return (int(seed or 0) + rank * _SEED_STRIDE) % 2**63


@dataclasses.dataclass(frozen=True)
class EnvMesh:
    """The 1-D ``"envs"`` group of ranks that split the env batch.

    ``distributed``: whether the ranks are processes of the default process
    group; without it ``all_reduce`` and ``broadcast`` leave their tensor as
    it is (a world of one, or shards made in one process).  ``device``: the
    rank's device, ``None`` for the env's own."""

    rank: int
    size: int
    device: Optional[torch.device] = None
    distributed: bool = False

    def all_reduce(self, tensor: torch.Tensor) -> torch.Tensor:
        """Sum ``tensor`` over the ranks, in place."""
        if self.distributed:
            dist.all_reduce(tensor)
        return tensor

    def broadcast(self, tensor: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``tensor`` on every rank, in place."""
        if self.distributed:
            dist.broadcast(tensor, src)
        return tensor


def make_mesh(n_devices: Optional[int] = None, device=None,
              rank: Optional[int] = None,
              world_size: Optional[int] = None) -> EnvMesh:
    """The ``"envs"`` mesh of this process's rank.

    With ``rank`` and ``world_size`` given: that rank of a split with no
    process group.  Otherwise every rank of the default process group
    (``n_devices``, if given, must be its size), or, where none is
    initialized, a world of one (``n_devices`` None or 1)."""
    device = None if device is None else torch.device(device)
    if rank is not None or world_size is not None:
        if rank is None or world_size is None:
            raise ValueError("give both rank and world_size, or neither")
        if not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} is not in a world of {world_size}")
        return EnvMesh(rank, world_size, device, False)
    if dist.is_available() and dist.is_initialized():
        size = dist.get_world_size()
        if n_devices not in (None, size):
            raise ValueError(
                f"the process group has {size} ranks, not {n_devices}: a mesh"
                " spans every rank")
        return EnvMesh(dist.get_rank(), size, device, True)
    if n_devices not in (None, 1):
        raise RuntimeError(
            f"a mesh of {n_devices} ranks needs a process group: start one"
            " process a GPU and call parallel.init_distributed first")
    return EnvMesh(0, 1, device, False)


def shard_state(state: WorldState, mesh: EnvMesh, batch_dim: int,
                device=None) -> WorldState:
    """Rank ``mesh.rank``'s rows of ``state``, copied onto ``device`` (the
    mesh's, else the state's own): every tensor whose leading size is
    ``batch_dim`` is cut to the rank's ``batch_dim / mesh.size`` rows,
    anything else copied whole."""
    if batch_dim % mesh.size:
        raise ValueError(
            f"num_envs ({batch_dim}) must be divisible by the number of mesh"
            f" devices ({mesh.size})")
    n = batch_dim // mesh.size
    lo = mesh.rank * n
    device = device if device is not None else mesh.device

    def place(x: torch.Tensor) -> torch.Tensor:
        if x.ndim >= 1 and x.shape[0] == batch_dim:
            x = x[lo:lo + n]
        return x.detach().to(device=device or x.device, copy=True)

    out = WorldState(**{f: place(getattr(state, f)) for f in STATE_FIELDS})
    out.extras = {k: place(v) for k, v in state.extras.items()}
    return out


def shard_environment(env, mesh: Optional[EnvMesh] = None,
                      rank: Optional[int] = None,
                      world_size: Optional[int] = None):
    """This rank's env of the split of ``env`` (an ``Environment``) over
    ``mesh`` (by default ``make_mesh(rank=rank, world_size=world_size)``):
    the same scenario and arguments at ``num_envs / mesh.size`` envs on the
    mesh's device, holding the rank's rows of ``env``'s state, its world
    generator seeded from ``(seed, rank)``.  ``env`` is left as it was."""
    from vectorizedmultiagentsimulator_tpu_torch.environment import Environment

    if mesh is None:
        mesh = make_mesh(rank=rank, world_size=world_size)
    B = env.num_envs
    if B % mesh.size:
        raise ValueError(
            f"num_envs ({B}) must be divisible by the number of mesh"
            f" devices ({mesh.size})")
    kwargs = dict(env.build_kwargs)
    seed = rank_seed(kwargs.pop("seed"), mesh.rank)
    device = mesh.device if mesh.device is not None else env.device
    local = Environment(type(env.scenario)(), num_envs=B // mesh.size,
                        device=device, seed=seed, **kwargs)
    state = shard_state(env.state, mesh, B, device)
    like = local.world.state
    if set(state.extras) != set(like.extras):
        raise ValueError(
            "the rank's env has other extras than the global env:"
            f" {sorted(set(state.extras) ^ set(like.extras))[:5]}")
    for name, got, want in (
            [(f, getattr(state, f), getattr(like, f)) for f in STATE_FIELDS]
            + [(k, v, like.extras[k]) for k, v in state.extras.items()]):
        if got.shape != want.shape or got.dtype != want.dtype:
            raise ValueError(
                f"{name}: the rank's rows are {tuple(got.shape)} {got.dtype},"
                f" its env holds {tuple(want.shape)} {want.dtype}")
    local.state = state
    local.world.generator.manual_seed(seed)
    return local
