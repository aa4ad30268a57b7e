"""Sensors (reference ``vmas/simulator/sensors.py``).

PyTorch counterpart of ``vectorizedmultiagentsimulator_tpu/sensors.py``.
``Lidar.measure`` is ``World.measure_lidar``: the world casts every
LIDAR that shares this one's filter, base angles and max_range in one
launch of the ray-cast kernel, which turns the base angles into
world-frame angles itself, and each LIDAR reads its own slice.
``measure(vectorized=False)`` is the reference's ray-by-ray form: one
``World.cast_ray`` (one launch) a ray, on the same world-frame angles, so
both forms give the same bits.
``render`` draws the rays of distances it is given: ``Environment.render``
measures each rendering LIDAR from the current state (the world's cached
cast where it is current) and copies env ``env_index``'s row to the host
with the rest of the frame, so a frame after a CUDA-graph rollout, which
drops the casts, still draws the last step's rays.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Callable, Tuple, Union

import numpy as np
import torch

from vectorizedmultiagentsimulator_tpu_torch.utils import Color, same_device


class Sensor(ABC):
    def __init__(self, world):
        self._world = world
        self._agent = None

    @property
    def agent(self):
        return self._agent

    @agent.setter
    def agent(self, agent):
        self._agent = agent

    @abstractmethod
    def measure(self):
        raise NotImplementedError

    @abstractmethod
    def render(self, env_index: int = 0) -> list:
        raise NotImplementedError

    def to(self, device):
        """``self`` on its world's device; another device raises
        (``Environment.to``)."""
        same_device(self._world.device, device)
        return self


class Lidar(Sensor):
    def __init__(
        self,
        world,
        angle_start: float = 0.0,
        angle_end: float = 2 * np.pi,
        n_rays: int = 8,
        max_range: float = 1.0,
        entity_filter: Callable = lambda _: True,
        render_color: Union[Color, Tuple[float, float, float]] = Color.GRAY,
        alpha: float = 1.0,
        render: bool = True,
    ):
        super().__init__(world)
        # Drop the duplicated endpoint on full circles (sensors.py:61-68).
        if (angle_start - angle_end) % (np.pi * 2) < 1e-5:
            angles = np.linspace(angle_start, angle_end, n_rays + 1)[:n_rays]
        else:
            angles = np.linspace(angle_start, angle_end, n_rays)
        # [R] angles relative to the agent's heading, on the world's device,
        # and their float32 values on the host (World groups LIDARs by them).
        self._angles = torch.as_tensor(
            angles, dtype=torch.float32, device=world.device
        )
        self.angles_key = tuple(float(a) for a in np.float32(angles))
        self._max_range = max_range
        self._entity_filter = entity_filter
        self._render = render
        self._render_color = render_color
        self._alpha = alpha

    @property
    def entity_filter(self):
        return self._entity_filter

    @property
    def render_color(self):
        if isinstance(self._render_color, Color):
            return self._render_color.value
        return self._render_color

    @property
    def alpha(self):
        return self._alpha

    @property
    def rendering(self) -> bool:
        return self._render

    def set_render(self, render: bool):
        self._render = render

    @entity_filter.setter
    def entity_filter(self, entity_filter: Callable):
        self._entity_filter = entity_filter

    def measure(self, vectorized: bool = True) -> torch.Tensor:
        """Distances ``[B, n_rays]`` to the first entity the filter
        selects along each ray, capped at ``max_range``: with the LIDAR's
        group (``vectorized``), or one ``World.cast_ray`` a ray
        (sensors.py:91-110)."""
        if vectorized:
            return self._world.measure_lidar(self)
        angles = self._angles[None, :] + self.agent.state.rot  # [B, R]
        return torch.stack([
            self._world.cast_ray(self.agent, angles[:, i],
                                 max_range=self._max_range,
                                 entity_filter=self.entity_filter)
            for i in range(angles.shape[1])
        ], dim=1)

    def render(self, env_index: int = 0, measurement=None) -> list:
        """The rays of the distances ``measurement`` (numpy, ``[n_rays]``,
        env ``env_index``'s row); none where rendering is off or no
        distances are given."""
        if not self._render or measurement is None:
            return []
        from vectorizedmultiagentsimulator_tpu_torch.render import lidar_geoms

        return lidar_geoms(self, measurement, env_index)
