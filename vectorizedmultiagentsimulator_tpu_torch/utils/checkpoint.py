"""Checkpoint / resume.

PyTorch counterpart of the JAX package's ``utils/checkpoint.py`` (its npz
pair; the orbax pair is not ported).  The port's simulation state is the
world's ``WorldState`` (every field, every ``extras`` buffer, the step
counters) and the world's ``torch.Generator``: randomness is not part of
the state (``core/state.py``).  A checkpoint holds both, so a fresh env of
the same scenario and kwargs continues from it to the bit.

The file is the JAX package's flat ``.npz``: ``__keys__`` names each leaf
``leaf_<i>`` by its path in the state (``.pos``, ``.extras['<key>']``,
``.steps``), and the port adds ``.generator``, the generator's
``get_state()``.  ``load`` also reads a file written by the JAX package's
``utils/checkpoint.save``: its world fields load as ``utils.
state_from_numpy`` loads them, and its PRNG key (``.key``) and packed
physics mirror (``.phys_pack``) are ignored, since the random streams of
the two packages cannot match.
"""
from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from vectorizedmultiagentsimulator_tpu_torch.core.state import WorldState
from vectorizedmultiagentsimulator_tpu_torch.utils import (
    STATE_FIELDS,
    _loaded,
    host_copy,
)

GENERATOR_KEY = ".generator"
# Leaves of a JAX package checkpoint that the port has no counterpart of.
_JAX_ONLY = re.compile(r"^\.(key|phys_pack)\b")
_EXTRAS = re.compile(r"^\.extras\['(.*)'\]$")


def _paths(state: WorldState) -> Dict[str, torch.Tensor]:
    out = {f".{f}": getattr(state, f) for f in STATE_FIELDS}
    out.update({f".extras['{k}']": v for k, v in state.extras.items()})
    return out


def save(path: str, state: WorldState,
         generator_state: Optional[torch.Tensor] = None) -> None:
    """Save ``state`` (and the world generator's ``get_state()``) to
    ``path`` (.npz), its tensors copied from the device in one copy."""
    paths = _paths(state)
    keys = list(paths)
    leaves = host_copy(list(paths.values()))
    if generator_state is not None:
        keys.append(GENERATOR_KEY)
        leaves.append(generator_state.cpu())
    arrays = {f"leaf_{i}": leaf.numpy() for i, leaf in enumerate(leaves)}
    np.savez_compressed(path, __keys__=np.asarray(keys, dtype=str), **arrays)


def _read(path: str) -> Dict[str, np.ndarray]:
    """A checkpoint file (the port's or the JAX package's) as ``{leaf path:
    array}``."""
    with np.load(path, allow_pickle=True) as data:
        keys = [str(k) for k in data["__keys__"]]
        return {k: data[f"leaf_{i}"] for i, k in enumerate(keys)}


def load(path: str, like_state: WorldState
         ) -> Tuple[WorldState, Optional[torch.Tensor]]:
    """``(state, generator_state)`` from a checkpoint; ``like_state`` (e.g.
    ``env.state``) gives the structure, devices and dtypes, and every
    field and extras key of the file must be its (shapes too).
    ``generator_state`` is ``None`` for a JAX package file."""
    saved = _read(path)
    generator_state = saved.pop(GENERATOR_KEY, None)
    saved = {k: v for k, v in saved.items() if not _JAX_ONLY.match(k)}
    like = _paths(like_state)
    if set(saved) != set(like):
        raise ValueError(
            "checkpoint structure mismatch: only in the file"
            f" {sorted(set(saved) - set(like))[:5]}, only in the env"
            f" {sorted(set(like) - set(saved))[:5]}")
    values = {k: _loaded(k, saved[k], like[k]) for k in like}
    state = WorldState(**{f: values[f".{f}"] for f in STATE_FIELDS})
    state.extras = {_EXTRAS.match(k).group(1): v for k, v in values.items()
                    if _EXTRAS.match(k)}
    if generator_state is not None:
        generator_state = torch.from_numpy(generator_state.copy())
    return state, generator_state


def save_env(path: str, env) -> None:
    """Checkpoint a live Environment: its state and world generator."""
    save(path, env.state, env.world.generator.get_state())


def restore_env(path: str, env):
    """Restore a live Environment from a checkpoint of an env with the same
    scenario and kwargs (or a JAX package checkpoint, which leaves the
    world generator as it is)."""
    state, generator_state = load(path, env.state)
    env.state = state
    if generator_state is not None:
        env.world.generator.set_state(generator_state)
    return env
