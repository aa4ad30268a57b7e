"""Constants, math helpers and scenario utilities.

PyTorch counterpart of ``vectorizedmultiagentsimulator_tpu/utils``: the
same constants, ``TorchUtils`` in place of ``JaxUtils``, and the
``ScenarioUtils`` rejection spawner.  Every helper broadcasts over
arbitrary leading batch dimensions, so one function serves ``[B,2]``,
``[B,P,2]`` and ``[4,B,P,2]`` call sites.
"""
from __future__ import annotations

from enum import Enum
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

X = 0
Y = 1
Z = 2
ALPHABET = "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
VIEWER_DEFAULT_ZOOM = 1.2
INITIAL_VIEWER_SIZE = (700, 700)
LINE_MIN_DIST = 4 / 6e2
COLLISION_FORCE = 100.0
JOINT_FORCE = 130.0
TORQUE_CONSTRAINT_FORCE = 1.0

DRAG = 0.25
LINEAR_FRICTION = 0.0
ANGULAR_FRICTION = 0.0

Tensor = torch.Tensor

AGENT_OBS_TYPE = Union[Tensor, Dict[str, Tensor]]
AGENT_INFO_TYPE = Dict[str, Tensor]
AGENT_REWARD_TYPE = Tensor

OBS_TYPE = Union[List[AGENT_OBS_TYPE], Dict[str, AGENT_OBS_TYPE]]
INFO_TYPE = Union[List[AGENT_INFO_TYPE], Dict[str, AGENT_INFO_TYPE]]
REWARD_TYPE = Union[List[AGENT_REWARD_TYPE], Dict[str, AGENT_REWARD_TYPE]]
DONE_TYPE = Tensor

# WorldState fields carried across by state_from_numpy / state_to_numpy.
STATE_FIELDS = (
    "pos", "vel", "rot", "ang_vel", "force", "torque", "c", "u",
    "action_c", "steps",
)


class Color(Enum):
    RED = (0.75, 0.25, 0.25)
    GREEN = (0.25, 0.75, 0.25)
    BLUE = (0.25, 0.25, 0.75)
    LIGHT_GREEN = (0.45, 0.95, 0.45)
    WHITE = (0.75, 0.75, 0.75)
    GRAY = (0.25, 0.25, 0.25)
    BLACK = (0.15, 0.15, 0.15)
    ORANGE = (1.00, 0.50, 0)
    PINK = (0.97, 0.51, 0.75)
    PURPLE = (0.60, 0.31, 0.64)
    YELLOW = (0.87, 0.87, 0)


class TorchUtils:
    """PyTorch counterpart of ``JaxUtils``."""

    @staticmethod
    def safe_norm(v: Tensor, dim=-1, keepdim: bool = False) -> Tensor:
        """L2 norm whose gradient at an exactly-zero vector is 0, not NaN.
        The square root sees 1.0 where the squared norm is 0, so the
        unselected branch of the ``where`` stays finite in backward too
        (0 * NaN would poison the gradient)."""
        sq = torch.sum(v * v, dim=dim, keepdim=keepdim)
        pos = sq > 0
        safe = torch.sqrt(torch.where(pos, sq, torch.ones_like(sq)))
        return torch.where(pos, safe, torch.zeros_like(sq))

    @staticmethod
    def clamp_with_norm(tensor: Tensor, max_norm: Tensor) -> Tensor:
        """Rescale rows whose norm exceeds ``max_norm``.  A safe divisor
        keeps the unselected branch finite, and an infinite ``max_norm``
        (no clamp) is replaced by 0 in the never-selected scaled branch so
        its backward never forms 0 * inf."""
        norm = TorchUtils.safe_norm(tensor, dim=-1, keepdim=True)
        finite_max = torch.where(
            torch.isfinite(max_norm), max_norm, torch.zeros_like(max_norm)
        )
        scaled = tensor / torch.clamp_min(norm, 1e-12) * finite_max
        return torch.where(norm > max_norm, scaled, tensor)

    @staticmethod
    def rotate_vector(vector: Tensor, angle: Tensor) -> Tensor:
        if angle.ndim == vector.ndim:
            angle = angle.squeeze(-1)
        cos = torch.cos(angle)
        sin = torch.sin(angle)
        return torch.stack(
            [
                vector[..., X] * cos - vector[..., Y] * sin,
                vector[..., X] * sin + vector[..., Y] * cos,
            ],
            dim=-1,
        )

    @staticmethod
    def cross(a: Tensor, b: Tensor) -> Tensor:
        return (a[..., X] * b[..., Y] - a[..., Y] * b[..., X])[..., None]

    @staticmethod
    def compute_torque(f: Tensor, r: Tensor) -> Tensor:
        return TorchUtils.cross(r, f)

    @staticmethod
    def where_from_index(env_index, new_value, old_value: Tensor) -> Tensor:
        """Masked overwrite of the envs named by ``env_index`` (None: all)."""
        mask = env_index_to_mask(
            env_index, old_value.shape[0], old_value.device
        )
        mask = mask.reshape(mask.shape + (1,) * (old_value.ndim - 1))
        return torch.where(mask, new_value, old_value)


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the CUDA card.
    Without one, ``None`` raises: the CPU is only used when asked for."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "No CUDA device is available, and the port runs on the card"
            ' unless asked otherwise: pass device="cpu" to run on the CPU.'
        )
    return torch.device("cuda")


def env_index_to_mask(env_index, batch_dim: int, device=None) -> Tensor:
    """Normalize an env index spec (None | int | int tensor | bool mask) to
    a boolean mask of shape ``[batch_dim]``."""
    if env_index is None:
        return torch.ones((batch_dim,), dtype=torch.bool, device=device)
    if isinstance(env_index, (int, np.integer)):
        mask = torch.zeros((batch_dim,), dtype=torch.bool, device=device)
        mask[int(env_index)] = True
        return mask
    env_index = torch.as_tensor(env_index, device=device)
    if env_index.dtype == torch.bool:
        return env_index
    mask = torch.zeros((batch_dim,), dtype=torch.bool, device=device)
    mask[env_index.long()] = True
    return mask


class ScenarioUtils:
    """Random-spawn helpers (reference utils.py:239-330)."""

    MAX_SPAWN_TRIES = 1000
    SPAWN_PROPOSALS_PER_ROUND = 16

    @staticmethod
    def spawn_entities_randomly(
        entities,
        world,
        env_index,
        min_dist_between_entities: float,
        x_bounds: Tuple[float, float],
        y_bounds: Tuple[float, float],
        occupied_positions: Optional[Tensor] = None,
    ):
        """Place ``entities`` at random positions at least
        ``min_dist_between_entities`` apart and from
        ``occupied_positions`` [B, O, 2]."""
        if occupied_positions is None:
            occupied_positions = torch.zeros(
                (world.batch_dim, 0, world.dim_p), device=world.device
            )
        entities = list(entities)
        new_pos = ScenarioUtils.find_random_positions_for_entities(
            occupied_positions,
            len(entities),
            world,
            min_dist_between_entities,
            x_bounds,
            y_bounds,
        )
        for i, entity in enumerate(entities):
            entity.set_pos(new_pos[:, i], batch_index=env_index)

    @staticmethod
    @torch.no_grad()
    def find_random_positions_for_entities(
        occupied_positions: Tensor,
        n_new: int,
        world,
        min_dist_between_entities: float,
        x_bounds: Tuple[float, float],
        y_bounds: Tuple[float, float],
    ) -> Tensor:
        """``[B, n_new, 2]`` positions, each ``>= min_dist`` from
        ``occupied_positions`` [B, O, 2] and from one another.

        Rejection sampling as in the JAX package: each round draws ``K``
        iid proposals per entity and keeps, per entity and env, the first
        proposal clear of the occupied set and of the entities placed
        before it.  The loop's exit test reads the device on the host,
        which is acceptable here because spawning runs at reset only.
        After ``MAX_SPAWN_TRIES`` draws the last proposal is accepted.
        """
        B = occupied_positions.shape[0]
        M = int(n_new)
        K = ScenarioUtils.SPAWN_PROPOSALS_PER_ROUND
        device = occupied_positions.device
        if not M:
            return torch.zeros((B, 0, 2), device=device)
        min_d = min_dist_between_entities
        lo = torch.tensor([x_bounds[0], y_bounds[0]], device=device)
        hi = torch.tensor([x_bounds[1], y_bounds[1]], device=device)
        eff = [torch.zeros((B, 2), device=device) for _ in range(M)]
        ok = [torch.zeros((B,), dtype=torch.bool, device=device) for _ in range(M)]
        tries = 0
        while True:
            u = torch.rand(
                (B, M, K, 2), generator=world.generator, device=device
            )
            cands = lo + u * (hi - lo)
            for i in range(M):
                cand = cands[:, i]  # [B, K, 2]
                if occupied_positions.shape[1]:
                    d_occ = torch.linalg.norm(
                        occupied_positions[:, None] - cand[:, :, None], dim=-1
                    )  # [B, K, O]
                    valid = torch.all(d_occ >= min_d, dim=-1)
                else:
                    valid = torch.ones((B, K), dtype=torch.bool, device=device)
                for j in range(M):
                    if j == i:
                        continue
                    d_j = torch.linalg.norm(eff[j][:, None] - cand, dim=-1)
                    valid = valid & ((d_j >= min_d) | ~ok[j][:, None])
                found = valid.any(dim=1)
                first = torch.argmax(valid.to(torch.float32), dim=1)
                chosen = torch.gather(
                    cand, 1, first[:, None, None].expand(B, 1, 2)
                )[:, 0]
                # Give-up value after MAX_SPAWN_TRIES: a distinct proposal
                # per entity, so entities never collapse onto one point.
                chosen = torch.where(
                    found[:, None], chosen, cand[:, (K - 1 - i) % K]
                )
                eff[i] = torch.where(ok[i][:, None], eff[i], chosen)
                ok[i] = ok[i] | found
            tries += K
            if (
                bool(torch.stack(ok, dim=1).all())
                or tries >= ScenarioUtils.MAX_SPAWN_TRIES
            ):
                break
        return torch.stack(eff, dim=1)

    @staticmethod
    def check_kwargs_consumed(kwargs: Dict, warn: bool = True):
        if len(kwargs) > 0:
            message = (
                f"Scenario kwargs: {kwargs} passed but not used by the scenario."
            )
            if warn:
                import warnings

                warnings.warn(message)
            else:
                raise ValueError(message)


def state_to_numpy(env) -> Dict:
    """The env's ``WorldState`` as numpy arrays: ``{field: array, ...,
    "extras": {key: array}}``, the layout of the JAX package's state."""
    s = env.world.state
    out = {f: getattr(s, f).detach().cpu().numpy() for f in STATE_FIELDS}
    out["extras"] = {
        k: v.detach().cpu().numpy() for k, v in s.extras.items()
    }
    return out


def state_from_numpy(env, arrays: Dict):
    """Load a JAX ``WorldState``'s fields, given as numpy arrays in the
    layout of :func:`state_to_numpy`, into the port env.  Fields missing
    from ``arrays`` keep their value; ``key`` and ``phys_pack`` are JAX
    machinery and are not read.  Shapes must match the env's, and every
    extras key must already exist in it (scenarios create their buffers
    at reset)."""
    s = env.world.state
    for f in STATE_FIELDS:
        if f in arrays:
            setattr(s, f, _loaded(f, arrays[f], getattr(s, f)))
    for k, v in arrays.get("extras", {}).items():
        if k not in s.extras:
            raise KeyError(f"extras key {k!r} is unknown to this env")
        s.extras[k] = _loaded(f"extras {k}", v, s.extras[k])


def _loaded(name, array, like: Tensor) -> Tensor:
    value = np.array(array)  # a copy: the env never shares the caller's memory
    if value.shape != tuple(like.shape):
        raise ValueError(
            f"{name}: shape {value.shape} does not match the env's"
            f" {tuple(like.shape)}"
        )
    return torch.as_tensor(value, dtype=like.dtype, device=like.device)
