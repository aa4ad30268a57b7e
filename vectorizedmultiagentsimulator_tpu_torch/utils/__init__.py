"""Constants, math helpers and scenario utilities.

PyTorch counterpart of ``vectorizedmultiagentsimulator_tpu/utils``: the
same constants, ``TorchUtils`` in place of ``JaxUtils``, and the
``ScenarioUtils`` rejection spawner.  Every helper broadcasts over
arbitrary leading batch dimensions, so one function serves ``[B,2]``,
``[B,P,2]`` and ``[4,B,P,2]`` call sites.
"""
from __future__ import annotations

import math
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


class Observable:
    """Tiny observer registry: joints subscribe to their entities' pose
    writes (reference utils.py:85-103)."""

    def __init__(self):
        self._observers = []

    def subscribe(self, observer):
        self._observers.append(observer)

    def notify_observers(self, *args, **kwargs):
        for obs in self._observers:
            obs.notify(self, *args, **kwargs)


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
    # A masked respawn's fixed rounds leave an entity unplaced with at most
    # this probability (see spawn_rounds).
    SPAWN_FAILURE_BOUND = 1e-9

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
            env_index=env_index,
        )
        for i, entity in enumerate(entities):
            entity.set_pos(new_pos[:, i], batch_index=env_index)

    @staticmethod
    def spawn_rounds(n_occupied, n_new, min_dist, x_bounds, y_bounds,
                     proposals_per_round) -> int:
        """The fixed number of proposal rounds of a masked respawn, from
        static facts only.  One proposal lands within ``min_dist`` of one
        of the at most ``n_occupied + n_new - 1`` blocking points with
        probability at most ``p = blockers * pi * min_dist^2 / area``, so
        ``d`` draws all fail with probability at most ``p^d``; the rounds
        cover the least ``d`` with ``p^d <= SPAWN_FAILURE_BOUND``, and never
        more than ``MAX_SPAWN_TRIES`` draws."""
        K = int(proposals_per_round)
        most = max(1, ScenarioUtils.MAX_SPAWN_TRIES // K)
        area = (x_bounds[1] - x_bounds[0]) * (y_bounds[1] - y_bounds[0])
        blockers = n_occupied + n_new - 1
        if min_dist <= 0 or blockers <= 0 or area <= 0:
            return 1
        p = blockers * math.pi * min_dist**2 / area
        if p >= 1.0:
            return most
        draws = math.ceil(
            math.log(ScenarioUtils.SPAWN_FAILURE_BOUND) / math.log(p)
        )
        return max(1, min(most, -(-draws // K)))

    @staticmethod
    @torch.no_grad()
    def find_random_positions_for_entities(
        occupied_positions: Tensor,
        n_new: int,
        world,
        min_dist_between_entities: float,
        x_bounds: Tuple[float, float],
        y_bounds: Tuple[float, float],
        current_positions: Optional[Tensor] = None,
        replace_mask: Optional[Tensor] = None,
        proposals_per_round: Optional[int] = None,
        env_index=None,
    ) -> Tensor:
        """``[B, n_new, 2]`` positions, each ``>= min_dist`` from
        ``occupied_positions`` [B, O, 2] and from one another.

        Rejection sampling as in the JAX package: each round draws ``K``
        iid proposals per entity and keeps, per entity and env, the first
        proposal clear of the occupied set, of the entities placed before
        it and, when ``current_positions`` [B, n_new, 2] is given, of the
        not yet replaced entities' current positions.  Rows where
        ``replace_mask`` [B, n_new] is False keep their current position and
        still block the others (per-step respawns).  With
        ``current_positions`` and a positive ``min_dist`` all entities scan
        one shared proposal stream, as in the JAX package: a proposal an
        earlier entity accepts is within ``min_dist`` of that entity and so
        invalid for every later one, which gives the joint law of separate
        streams from ``n_new`` times fewer draws.  ``proposals_per_round``
        (default ``SPAWN_PROPOSALS_PER_ROUND``) only chunks the stream.

        How many rounds run depends on ``env_index``:

        * ``None`` (a full reset): rounds repeat until every entity of
          every env is placed or ``MAX_SPAWN_TRIES`` draws were made, as in
          the JAX package.  The exit test reads the device on the host,
          once a round.
        * an index or a ``[B]`` bool mask (``reset_at``, the trainer's
          reset in every step): exactly :meth:`spawn_rounds` rounds,
          a number fixed on the host from the entity counts, ``min_dist``
          and the bounds, so nothing reads the device.  This differs from
          the JAX package, whose on-device ``while_loop`` always goes on to
          1000 draws before it gives up: here an entity gives up once the
          fixed rounds are over, which the choice of rounds makes rarer
          than ``SPAWN_FAILURE_BOUND`` per entity and env whenever the
          blocking discs cover less than the whole area.

        An entity that gives up takes the last round's proposal
        ``(K - 1 - i) % K`` (distinct per entity).  Give-ups, counted over
        the envs that ``env_index`` names, are added to the device tensor
        ``world.spawn_give_ups``.
        """
        B = occupied_positions.shape[0]
        M = int(n_new)
        O = occupied_positions.shape[1]
        K = int(
            proposals_per_round
            if proposals_per_round is not None
            else ScenarioUtils.SPAWN_PROPOSALS_PER_ROUND
        )
        assert K >= 1
        device = occupied_positions.device
        if not M:
            return torch.zeros((B, 0, 2), device=device)
        min_d = min_dist_between_entities
        has_current = current_positions is not None
        if has_current:
            eff = current_positions.to(torch.float32).clone()
            if replace_mask is not None:
                ok = ~replace_mask.to(torch.bool)
            else:
                ok = torch.zeros((B, M), dtype=torch.bool, device=device)
        else:
            eff = torch.zeros((B, M, 2), device=device)
            ok = torch.zeros((B, M), dtype=torch.bool, device=device)
        share = has_current and min_d > 0 and M > 1
        occupied_blocks = torch.ones((B, O), dtype=torch.bool, device=device)

        def one_round():
            u = torch.rand(
                (B, 1 if share else M, K, 2),
                generator=world.generator,
                device=device,
            )
            # Python scalars only: a tensor made from a list would be a
            # host-to-device copy, which a masked reset must not make.
            cands = torch.stack(
                [
                    x_bounds[0] + u[..., 0] * (x_bounds[1] - x_bounds[0]),
                    y_bounds[0] + u[..., 1] * (y_bounds[1] - y_bounds[0]),
                ],
                dim=-1,
            )
            for i in range(M):
                cand = cands[:, 0 if share else i]  # [B, K, 2]
                # Entities earlier in the fold hold this round's update,
                # later ones their position from before the round.
                points = torch.cat([occupied_positions, eff], dim=1)
                present = torch.ones_like(ok) if has_current else ok.clone()
                present[:, i] = False
                blocks = torch.cat([occupied_blocks, present], dim=1)
                dist = torch.linalg.norm(
                    points[:, None] - cand[:, :, None], dim=-1
                )  # [B, K, O + M]
                valid = torch.all(
                    (dist >= min_d) | ~blocks[:, None], dim=-1
                )  # [B, K]
                found = valid.any(dim=1)
                first = torch.argmax(valid.to(torch.float32), dim=1)
                chosen = torch.gather(
                    cand, 1, first[:, None, None].expand(B, 1, 2)
                )[:, 0]
                chosen = torch.where(
                    found[:, None], chosen, cand[:, (K - 1 - i) % K]
                )
                eff[:, i] = torch.where(ok[:, i, None], eff[:, i], chosen)
                ok[:, i] |= found

        if env_index is None:
            tries = 0
            while True:
                one_round()
                tries += K
                if bool(ok.all()) or tries >= ScenarioUtils.MAX_SPAWN_TRIES:
                    break
            gave_up = ~ok
        else:
            for _ in range(
                ScenarioUtils.spawn_rounds(O, M, min_d, x_bounds, y_bounds, K)
            ):
                one_round()
            mask = env_index_to_mask(env_index, B, device)
            gave_up = ~ok & mask[:, None]
        world.spawn_give_ups += gave_up.sum()
        return eff

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


# Where each parameter of ``examples/torch_ppo.ActorCritic`` (in the order of
# its ``NAMES``) lies in the parameter tree of the JAX package's flax
# ``ActorCritic``: dense kernels ``[in, out]``, biases and ``log_std`` 1-D.
PPO_PARAM_PATHS = (
    ("Dense_0", "kernel"), ("Dense_0", "bias"),
    ("Dense_1", "kernel"), ("Dense_1", "bias"),
    ("Dense_2", "kernel"), ("Dense_2", "bias"),
    ("log_std",),
    ("Dense_3", "kernel"), ("Dense_3", "bias"),
    ("Dense_4", "kernel"), ("Dense_4", "bias"),
)


@torch.no_grad()
def ppo_params_from_numpy(model, tree: Dict):
    """Load the flax parameter tree of the JAX package's ``ActorCritic``,
    given as numpy arrays (``{"params": {"Dense_0": {"kernel", "bias"}, ...,
    "log_std"}}``, with or without the outer ``"params"``), into the port's
    ``ActorCritic``.  Shapes must match."""
    tree = tree.get("params", tree)
    for param, path in zip(model.ordered_parameters(), PPO_PARAM_PATHS):
        leaf = tree
        for key in path:
            leaf = leaf[key]
        param.copy_(_loaded("/".join(path), leaf, param))


def ppo_params_to_numpy(model) -> Dict:
    """The port's ``ActorCritic`` parameters as the flax tree that
    :func:`ppo_params_from_numpy` reads."""
    tree: Dict = {}
    for param, path in zip(model.ordered_parameters(), PPO_PARAM_PATHS):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = param.detach().cpu().numpy().copy()
    return {"params": tree}
