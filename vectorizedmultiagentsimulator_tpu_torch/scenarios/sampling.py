"""Sampling scenario (reference ``vmas/scenarios/sampling.py``).

Agents collect reward by visiting unvisited cells of a discretised
Gaussian-mixture density field; each cell pays its (normalised) pdf value
once.  The agents' LIDARs (12 rays over the agents) are one group, one
launch of the ray-cast kernel a step.

A position's cell is ``pos * (1 / grid_spacing) + n / 2`` truncated toward
zero.  The JAX package writes ``pos / grid_spacing``, which XLA computes as
the product with the fp32 reciprocal of the constant; the port multiplies
by that reciprocal too, so a position on a cell edge lands in the JAX
package's cell (true division would move some of them by one cell).
"""
from typing import Callable

import numpy as np
import torch

from vectorizedmultiagentsimulator_tpu_torch.core import (
    Agent,
    Entity,
    Sphere,
    World,
)
from vectorizedmultiagentsimulator_tpu_torch.scenario import BaseScenario
from vectorizedmultiagentsimulator_tpu_torch.sensors import Lidar
from vectorizedmultiagentsimulator_tpu_torch.utils import (
    Color,
    ScenarioUtils,
    TorchUtils,
    X,
    Y,
)


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        self.n_agents = kwargs.pop("n_agents", 3)
        self.shared_rew = kwargs.pop("shared_rew", True)
        self.comms_range = kwargs.pop("comms_range", 0.0)
        self.lidar_range = kwargs.pop("lidar_range", 0.2)
        self.agent_radius = kwargs.pop("agent_radius", 0.025)
        self.xdim = kwargs.pop("xdim", 1)
        self.ydim = kwargs.pop("ydim", 1)
        self.grid_spacing = kwargs.pop("grid_spacing", 0.05)
        self.n_gaussians = kwargs.pop("n_gaussians", 3)
        self.cov = kwargs.pop("cov", 0.05)
        self.collisions = kwargs.pop("collisions", True)
        self.spawn_same_pos = kwargs.pop("spawn_same_pos", False)
        self.norm = kwargs.pop("norm", True)
        ScenarioUtils.check_kwargs_consumed(kwargs)

        assert not (self.spawn_same_pos and self.collisions)
        assert (self.xdim / self.grid_spacing) % 1 == 0 and (
            self.ydim / self.grid_spacing
        ) % 1 == 0
        self.covs = (
            [self.cov] * self.n_gaussians
            if isinstance(self.cov, float)
            else self.cov
        )
        assert len(self.covs) == self.n_gaussians

        self.plot_grid = False
        self.visualize_semidims = False
        self.n_x_cells = int((2 * self.xdim) / self.grid_spacing)
        self.n_y_cells = int((2 * self.ydim) / self.grid_spacing)
        self.alpha_plot = 0.5

        self.agent_xspawn_range = 0 if self.spawn_same_pos else self.xdim
        self.agent_yspawn_range = 0 if self.spawn_same_pos else self.ydim
        self.x_semidim = self.xdim - self.agent_radius
        self.y_semidim = self.ydim - self.agent_radius

        world = World(
            batch_dim, device, x_semidim=self.x_semidim,
            y_semidim=self.y_semidim,
        )
        entity_filter_agents: Callable[[Entity], bool] = lambda e: isinstance(
            e, Agent
        )
        for i in range(self.n_agents):
            world.add_agent(
                Agent(
                    name=f"agent_{i}",
                    render_action=True,
                    collide=self.collisions,
                    shape=Sphere(radius=self.agent_radius),
                    sensors=(
                        [
                            Lidar(
                                world,
                                angle_start=0.05,
                                angle_end=2 * np.pi + 0.05,
                                n_rays=12,
                                max_range=self.lidar_range,
                                entity_filter=entity_filter_agents,
                            )
                        ]
                        if self.collisions
                        else None
                    ),
                )
            )

        # Constants on the device, made once: a step and a masked reset
        # copy nothing from the host.
        dev = world.device
        self._covs = torch.tensor(self.covs, dtype=torch.float32, device=dev)
        self._inv_spacing = float(
            np.float32(1) / np.float32(self.grid_spacing)
        )
        self._env_ids = torch.arange(batch_dim, device=dev)
        gs = self.grid_spacing
        self._deltas = torch.tensor(
            [[gs, 0], [-gs, 0], [0, gs], [0, -gs], [-gs, -gs], [gs, -gs],
             [-gs, gs], [gs, gs]],
            dtype=torch.float32, device=dev,
        )
        self._grid = torch.as_tensor(self._grid_pos(), device=dev)
        return world

    # ------------------------------------------------------------------ #
    # Gaussian-mixture field
    # ------------------------------------------------------------------ #
    def _mixture(self, dx, dy):
        """The unnormalised mixture pdf from a position's offsets ``dx``,
        ``dy`` [..., G] from each mean: diagonal covariances, summed over
        G."""
        exponent = -0.5 * (dx**2 + dy**2) / self._covs
        dens = torch.exp(exponent) / (2 * np.pi * self._covs)
        return torch.sum(dens, dim=-1)

    def _pdf(self, pos):
        """The unnormalised pdf at ``pos`` [B, 2] under each env's means
        ``self.locs`` [B, G, 2]."""
        return self._mixture(pos[:, None, X] - self.locs[..., X],
                             pos[:, None, Y] - self.locs[..., Y])

    def sample(self, pos, update_sampled_flag: bool = False, norm: bool = True):
        out_of_bounds = (
            (pos[:, X] < -self.xdim)
            | (pos[:, X] > self.xdim)
            | (pos[:, Y] < -self.ydim)
            | (pos[:, Y] > self.ydim)
        )
        pos = torch.stack(
            [
                torch.clamp(pos[:, X], -self.world.x_semidim,
                            self.world.x_semidim),
                torch.clamp(pos[:, Y], -self.world.y_semidim,
                            self.world.y_semidim),
            ],
            dim=-1,
        )
        index = pos * self._inv_spacing
        index = torch.stack([index[:, X] + self.n_x_cells / 2,
                             index[:, Y] + self.n_y_cells / 2], dim=-1)
        index = index.to(torch.int32).long()
        # The JAX package's gather clamps an index outside the grid, and
        # its scatter drops it.
        ix = index[:, X].clamp(0, self.n_x_cells - 1)
        iy = index[:, Y].clamp(0, self.n_y_cells - 1)
        inside = (ix == index[:, X]) & (iy == index[:, Y])

        v = self._pdf(pos)
        if norm:
            v = v / self.max_pdf

        sampled = self.sampled[self._env_ids, ix, iy]
        v = torch.where(sampled | out_of_bounds, 0.0, v)
        if update_sampled_flag:
            self.sampled = torch.index_put(
                self.sampled, (self._env_ids, ix, iy), sampled | inside
            )
        return v

    def _grid_pos(self):
        xpoints = np.arange(-self.xdim, self.xdim, self.grid_spacing)
        ypoints = np.arange(-self.ydim, self.ydim, self.grid_spacing)
        xg, yg = np.meshgrid(xpoints, ypoints)
        return np.stack([xg.ravel(), yg.ravel()], axis=-1).astype(
            np.float32
        )  # [P, 2]

    def normalize_pdf(self):
        """Each env's largest pdf value over the grid's points, [B].  The
        JAX package forms the ``[B, P, G, 2]`` differences (1.15 GB at 30k
        envs); the port forms x and y apart, ``[B, P, G]`` each, which
        gives the same values."""
        grid, locs = self._grid, self.locs
        pdf = self._mixture(grid[None, :, None, X] - locs[:, None, :, X],
                            grid[None, :, None, Y] - locs[:, None, :, Y])
        return torch.max(pdf, dim=-1).values

    def reset_world_at(self, env_index=None):
        B = self.world.batch_dim
        dev = self.world.device
        g = self.world.generator
        u = torch.rand((B, self.n_gaussians, 2), generator=g, device=dev)
        new_locs = torch.stack(
            [-self.xdim + u[..., X] * (2 * self.xdim),
             -self.ydim + u[..., Y] * (2 * self.ydim)],
            dim=-1,
        )
        if env_index is None:
            self.locs = new_locs
            self.sampled = torch.zeros(
                (B, self.n_x_cells, self.n_y_cells), dtype=torch.bool,
                device=dev,
            )
        else:
            self.locs = TorchUtils.where_from_index(
                env_index, new_locs, self.locs
            )
            self.sampled = TorchUtils.where_from_index(
                env_index, torch.zeros_like(self.sampled), self.sampled
            )
        max_pdf = self.normalize_pdf()
        if env_index is None:
            self.max_pdf = max_pdf
        else:
            self.max_pdf = TorchUtils.where_from_index(
                env_index, max_pdf, self.max_pdf
            )

        for agent in self.world.agents:
            pos = torch.cat(
                [
                    ScenarioUtils.uniform_in_bounds(
                        self.world, -self.agent_xspawn_range,
                        self.agent_xspawn_range, (1,))
                    if self.agent_xspawn_range
                    else torch.zeros((B, 1), device=dev),
                    ScenarioUtils.uniform_in_bounds(
                        self.world, -self.agent_yspawn_range,
                        self.agent_yspawn_range, (1,))
                    if self.agent_yspawn_range
                    else torch.zeros((B, 1), device=dev),
                ],
                dim=-1,
            )
            agent.set_pos(pos, batch_index=env_index)
            agent.sample = self.sample(agent.state.pos, norm=self.norm)
        if env_index is None:
            self.sampling_rew = torch.zeros((B,), device=dev)

    def reward(self, agent):
        is_first = self.world.agents.index(agent) == 0
        if is_first:
            for a in self.world.agents:
                a.sample = self.sample(
                    a.state.pos, update_sampled_flag=True, norm=self.norm
                )
            self.sampling_rew = torch.sum(
                torch.stack([a.sample for a in self.world.agents], dim=-1),
                dim=-1,
            )
        return self.sampling_rew if self.shared_rew else agent.sample

    def observation(self, agent):
        observations = [
            agent.state.pos,
            agent.state.vel,
            agent.sensors[0].measure(),
        ]
        for delta in self._deltas:
            pos = agent.state.pos + delta
            observations.append(
                self.sample(pos, update_sampled_flag=False)[:, None]
            )
        return torch.cat(observations, dim=-1)

    def info(self, agent):
        return {"agent_sample": agent.sample}

    def density_for_plot(self, env_index):
        """The mixture's normalised pdf under env ``env_index``'s means, as
        a function of ``[P, 2]`` numpy positions (the field plot's)."""
        def f(x):
            pos = torch.as_tensor(np.asarray(x), dtype=torch.float32)
            locs = self.locs[env_index]  # [G, 2]
            covs = torch.tensor(self.covs, dtype=torch.float32)
            diff = pos[:, None, :] - locs[None]
            exponent = -0.5 * torch.sum(diff**2, dim=-1) / covs[None]
            dens = torch.exp(exponent) / (2 * np.float32(np.pi) * covs[None])
            v = torch.sum(dens, dim=-1) / self.max_pdf[env_index]
            return v.numpy()

        return f

    def extra_render(self, env_index: int = 0):
        from vectorizedmultiagentsimulator_tpu_torch import render as rendering

        geoms = [
            rendering.render_function_util(
                f=self.density_for_plot(env_index=env_index),
                precision=self.grid_spacing,
                plot_range=((-self.xdim, self.xdim), (-self.ydim, self.ydim)),
                cmap_alpha=self.alpha_plot,
            )
        ]
        for i, agent1 in enumerate(self.world.agents):
            for j, agent2 in enumerate(self.world.agents):
                if j <= i:
                    continue
                agent_dist = torch.linalg.norm(
                    agent1.state.pos - agent2.state.pos, dim=-1
                )
                if float(agent_dist[env_index]) <= self.comms_range:
                    line = rendering.Line(
                        tuple(np.asarray(agent1.state.pos)[env_index]),
                        tuple(np.asarray(agent2.state.pos)[env_index]),
                        width=0.005,
                    )
                    line.set_color(*Color.BLACK.value)
                    geoms.append(line)
        for i in range(4):
            length = (
                2 * ((self.ydim if i % 2 == 0 else self.xdim) - self.agent_radius)
                + self.agent_radius * 2
            )
            geom = rendering.make_line(length)
            xform = rendering.Transform()
            geom.add_attr(xform)
            xform.set_translation(
                0.0
                if i % 2
                else (
                    self.x_semidim + self.agent_radius
                    if i == 0
                    else -self.x_semidim - self.agent_radius
                ),
                0.0
                if not i % 2
                else (
                    self.y_semidim + self.agent_radius
                    if i == 1
                    else -self.y_semidim - self.agent_radius
                ),
            )
            xform.set_rotation(np.pi / 2 if not i % 2 else 0.0)
            geom.set_color(*Color.BLACK.value)
            geoms.append(geom)
        return geoms
