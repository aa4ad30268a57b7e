"""Static geometry descriptors (reference ``vmas/simulator/core.py:85-203``).

Shapes are plain python config objects resolved at world-finalize time into
stacked numpy parameter arrays (radius/length/width/hollow per entity); no
tensors live here.
"""
from __future__ import annotations

import math
from abc import ABC, abstractmethod
from typing import Tuple

SPHERE = 0
BOX = 1
LINE = 2


class Shape(ABC):
    @abstractmethod
    def moment_of_inertia(self, mass: float) -> float:
        raise NotImplementedError

    @abstractmethod
    def get_delta_from_anchor(self, anchor: Tuple[float, float]) -> Tuple[float, float]:
        raise NotImplementedError

    @abstractmethod
    def circumscribed_radius(self) -> float:
        raise NotImplementedError


class Box(Shape):
    kind = BOX

    def __init__(self, length: float = 0.3, width: float = 0.1, hollow: bool = False):
        assert length > 0, f"Length must be > 0, got {length}"
        assert width > 0, f"Width must be > 0, got {width}"
        self._length = length
        self._width = width
        self.hollow = hollow

    @property
    def length(self):
        return self._length

    @property
    def width(self):
        return self._width

    def get_delta_from_anchor(self, anchor):
        return anchor[0] * self.length / 2, anchor[1] * self.width / 2

    def moment_of_inertia(self, mass: float) -> float:
        return (1 / 12) * mass * (self.length**2 + self.width**2)

    def circumscribed_radius(self) -> float:
        return math.sqrt((self.length / 2) ** 2 + (self.width / 2) ** 2)


class Sphere(Shape):
    kind = SPHERE

    def __init__(self, radius: float = 0.05):
        assert radius > 0, f"Radius must be > 0, got {radius}"
        self._radius = radius

    @property
    def radius(self):
        return self._radius

    def get_delta_from_anchor(self, anchor):
        dx = anchor[0] * self.radius
        dy = anchor[1] * self.radius
        norm = math.sqrt(dx * dx + dy * dy)
        if norm > self.radius:
            # Matches the reference's (unusual) renormalization: delta /=
            # (norm * radius) when outside the sphere (core.py:151-158).
            dx /= norm * self.radius
            dy /= norm * self.radius
        return dx, dy

    def moment_of_inertia(self, mass: float) -> float:
        return (1 / 2) * mass * self.radius**2

    def circumscribed_radius(self) -> float:
        return self.radius


class Line(Shape):
    kind = LINE

    def __init__(self, length: float = 0.5):
        assert length > 0, f"Length must be > 0, got {length}"
        self._length = length
        self._width = 2

    @property
    def length(self):
        return self._length

    @property
    def width(self):
        return self._width

    def moment_of_inertia(self, mass: float) -> float:
        return (1 / 12) * mass * (self.length**2)

    def circumscribed_radius(self) -> float:
        return self.length / 2

    def get_delta_from_anchor(self, anchor):
        return anchor[0] * self.length / 2, 0.0
