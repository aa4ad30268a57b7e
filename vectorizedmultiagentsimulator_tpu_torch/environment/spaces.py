"""Minimal gym-style spaces.

The runtime image has no ``gym``; ``gymnasium`` may or may not be present.
The Environment builds these self-contained spaces (API-compatible subset:
``Box``, ``Discrete``, ``MultiDiscrete``, ``Tuple``, ``Dict``), and the
gymnasium wrappers convert them (reference builds gym spaces directly,
``vmas/simulator/environment/environment.py:431-523``).
"""
from __future__ import annotations

from typing import Dict as TDict, List, Optional, Sequence, Tuple as TTuple

import numpy as np


class Space:
    def sample(self, rng: Optional[np.random.Generator] = None):
        raise NotImplementedError

    def contains(self, x) -> bool:
        raise NotImplementedError


class Box(Space):
    def __init__(self, low, high, shape=None, dtype=np.float32):
        low = np.asarray(low, dtype=dtype)
        high = np.asarray(high, dtype=dtype)
        if shape is not None:
            low = np.broadcast_to(low, shape).astype(dtype)
            high = np.broadcast_to(high, shape).astype(dtype)
        self.low = low
        self.high = high
        self.shape = tuple(low.shape)
        self.dtype = dtype

    def sample(self, rng=None):
        rng = rng or np.random.default_rng()
        low = np.where(np.isfinite(self.low), self.low, -1e6)
        high = np.where(np.isfinite(self.high), self.high, 1e6)
        return rng.uniform(low, high, size=self.shape).astype(self.dtype)

    def contains(self, x) -> bool:
        x = np.asarray(x)
        return x.shape == self.shape and bool(
            np.all(x >= self.low - 1e-6) and np.all(x <= self.high + 1e-6)
        )

    def __repr__(self):
        return f"Box({self.shape})"

    def __eq__(self, other):
        return (
            isinstance(other, Box)
            and np.allclose(self.low, other.low)
            and np.allclose(self.high, other.high)
        )


class Discrete(Space):
    def __init__(self, n: int):
        self.n = int(n)
        self.shape = ()
        self.dtype = np.int64

    def sample(self, rng=None):
        rng = rng or np.random.default_rng()
        return int(rng.integers(self.n))

    def contains(self, x) -> bool:
        return 0 <= int(x) < self.n

    def __repr__(self):
        return f"Discrete({self.n})"

    def __eq__(self, other):
        return isinstance(other, Discrete) and self.n == other.n


class MultiDiscrete(Space):
    def __init__(self, nvec: Sequence[int]):
        self.nvec = np.asarray(nvec, dtype=np.int64)
        self.shape = tuple(self.nvec.shape)
        self.dtype = np.int64

    def sample(self, rng=None):
        rng = rng or np.random.default_rng()
        return (rng.random(self.nvec.shape) * self.nvec).astype(np.int64)

    def contains(self, x) -> bool:
        x = np.asarray(x)
        return bool(np.all(x >= 0) and np.all(x < self.nvec))

    def __repr__(self):
        return f"MultiDiscrete({self.nvec.tolist()})"

    def __eq__(self, other):
        return isinstance(other, MultiDiscrete) and np.array_equal(
            self.nvec, other.nvec
        )


class Tuple(Space):
    def __init__(self, spaces: Sequence[Space]):
        self.spaces = tuple(spaces)

    def sample(self, rng=None):
        return tuple(s.sample(rng) for s in self.spaces)

    def contains(self, x) -> bool:
        return len(x) == len(self.spaces) and all(
            s.contains(v) for s, v in zip(self.spaces, x)
        )

    def __iter__(self):
        return iter(self.spaces)

    def __getitem__(self, i):
        return self.spaces[i]

    def __len__(self):
        return len(self.spaces)

    def __repr__(self):
        return f"Tuple({list(self.spaces)})"


class Dict(Space):
    def __init__(self, spaces: TDict[str, Space]):
        self.spaces = dict(spaces)

    def sample(self, rng=None):
        return {k: s.sample(rng) for k, s in self.spaces.items()}

    def contains(self, x) -> bool:
        return all(k in x and s.contains(x[k]) for k, s in self.spaces.items())

    def __getitem__(self, k):
        return self.spaces[k]

    def items(self):
        return self.spaces.items()

    def keys(self):
        return self.spaces.keys()

    def values(self):
        return self.spaces.values()

    def __iter__(self):
        return iter(self.spaces)

    def __repr__(self):
        return f"Dict({self.spaces})"


def to_gymnasium_space(space: Space):
    """Convert our space to a gymnasium space (requires gymnasium)."""
    import gymnasium

    if isinstance(space, Box):
        return gymnasium.spaces.Box(
            low=space.low, high=space.high, dtype=space.dtype
        )
    if isinstance(space, Discrete):
        return gymnasium.spaces.Discrete(space.n)
    if isinstance(space, MultiDiscrete):
        return gymnasium.spaces.MultiDiscrete(space.nvec)
    if isinstance(space, Tuple):
        return gymnasium.spaces.Tuple(
            [to_gymnasium_space(s) for s in space.spaces]
        )
    if isinstance(space, Dict):
        return gymnasium.spaces.Dict(
            {k: to_gymnasium_space(s) for k, s in space.spaces.items()}
        )
    raise NotImplementedError(f"Cannot convert {space}")
