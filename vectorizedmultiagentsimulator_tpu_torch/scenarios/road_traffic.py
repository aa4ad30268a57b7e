"""Road_traffic scenario (reference ``vmas/scenarios/road_traffic.py``).

CAV benchmark on the CPM-Lab HD map: up to 20 kinematic-bicycle vehicles
follow 40 long-term reference-path loops with ego-view partial
observations, progress and velocity rewards, and boundary and agent
collision penalties.  The PyTorch counterpart of the JAX package's
``scenarios/road_traffic.py`` for ``map_type`` '1' (the whole map), '2'
(the whole map, with recorded challenging initial states) and '3' (the
intersection and merge sub-maps), ``is_testing_mode`` and per-agent
resets.

Map '2' keeps, per env, a ring of the last ``n_steps_before_recording``
states (``state_hist``, pushed after the last agent's reward) and an
initial-state buffer of ``initial_state_buffer_size`` rows (``isb_buf``):
``done()`` records the state from ``n_steps_stored`` steps before an
agent-agent collision there, and a reset starts an env from one of its
recorded rows with probability ``probability_use_recording``.  Rows are
``[pos_x, pos_y, rot, vel_x, vel_y, scenario_id, path_id, point_id]`` per
agent (the reference's row format).  Both buffers are written in place
(indexed writes into the same storage, through ``World.own_extra``, which
copies a buffer of a borrowed state first: a functional call never writes
into its caller's), so a captured step neither reallocates nor re-reads
them on the host, and they hold detached values:
a replayed state starts an episode, with no gradient back into the episode
it was recorded in.

The per-step path geometry runs in three hand-written CUDA kernels
(``ops/road_geometry_cuda.py``): ``reward()`` calls ``fused_geometry``
with collisions (the agent-geometry and the pair kernel), ``observation()``
calls ``fused_neighbor_obs`` (the neighbour kernel), and resets call
``fused_geometry`` without collisions.  The scenario looks both entry
points up on the module at each call.  The reference paths are padded
once (``road_traffic_map.PaddedPaths``) and copied to the device at
``make_world``; the only per-agent path state is ``path_id`` (global into
the concatenated path table), ``point_id`` and the env's ``scenario_id``.

Placement differs from the JAX package in one respect.  The JAX package
re-proposes a too-close placement in a ``lax.while_loop`` of up to 100
tries, whose exit test is a device value; a Python loop on it would read
the device.  Here each agent draws a fixed number of proposals at once
(``placement_proposals``: the least number after which a placement stays
too close with probability at most 1e-9, by a bound from the map and
``reset_agent_min_distance``, and never more than the JAX package's 101)
and keeps the first that is clear, or the last, as the JAX package keeps
its last proposal when it gives up.  Give-ups are added to the device
tensor ``world.spawn_give_ups``.  No reset and no step reads the device.

``extra_render`` draws the lanelets' boundaries (segments built from
``map_data`` at the first frame and kept) and each agent's short-term
reference path.
"""
import math

import numpy as np
import torch

from vectorizedmultiagentsimulator_tpu_torch.core import Agent, Box, World
from vectorizedmultiagentsimulator_tpu_torch.dynamics import KinematicBicycle
from vectorizedmultiagentsimulator_tpu_torch.ops import road_geometry as rg
from vectorizedmultiagentsimulator_tpu_torch.ops import road_geometry_cuda
from vectorizedmultiagentsimulator_tpu_torch.scenario import BaseScenario
from vectorizedmultiagentsimulator_tpu_torch.scenarios import (
    road_traffic_map as rtm,
)
from vectorizedmultiagentsimulator_tpu_torch.utils import (
    Color,
    ScenarioUtils,
    TorchUtils,
    env_index_to_mask,
)

# The JAX package's placement loop: a first proposal and up to 100 more.
MAX_PLACEMENT_PROPOSALS = 101


def point_range(n_points: torch.Tensor, point_range_open: bool):
    """[lo, hi) of a placement's point index along paths of ``n_points``
    points (road_traffic.py:1126-1134): ``lo`` an int, ``hi`` a tensor."""
    if point_range_open:
        return 3, torch.clamp_min(n_points - 5, 4)
    return 6, torch.clamp_min(n_points // 2, 7)


def placement_proposals(paths, groups, point_range_open: bool,
                        min_dist: float, n_agents: int) -> int:
    """How many proposals each placement draws.  A proposal is a uniform
    path of the env's group and a uniform point in its range.  Every
    proposal within ``min_dist`` of a blocker x lies within ``2 min_dist``
    of the proposal nearest x, so one blocker rejects a proposal with
    probability at most ``w``, the largest weight of proposals within ``2
    min_dist`` of any one proposal, and ``n_agents - 1`` blockers with at
    most ``p = (n_agents - 1) w``.  The count is the least ``d`` with ``p^d
    <= ScenarioUtils.SPAWN_FAILURE_BOUND``, at most
    ``MAX_PLACEMENT_PROPOSALS``."""
    worst = 0.0
    lo, his = point_range(torch.as_tensor(paths.n_points), point_range_open)
    for lo_g, size in groups:
        pts, weights = [], []
        for pid in range(lo_g, lo_g + size):
            hi = int(his[pid])
            pts.append(paths.center[pid, lo:hi].astype(np.float64))
            weights.append(np.full(hi - lo, 1.0 / (size * (hi - lo))))
        pts, weights = np.concatenate(pts), np.concatenate(weights)
        r2 = (2 * min_dist) ** 2
        for chunk in range(0, len(pts), 512):
            c = pts[chunk:chunk + 512]
            d2 = ((c[:, None, :] - pts[None]) ** 2).sum(-1)
            worst = max(worst, float(((d2 < r2) * weights).sum(-1).max()))
    p = (n_agents - 1) * worst
    if n_agents <= 1 or p <= 0:
        return 1
    if p >= 1:
        return MAX_PLACEMENT_PROPOSALS
    d = math.ceil(math.log(ScenarioUtils.SPAWN_FAILURE_BOUND) / math.log(p))
    return max(1, min(MAX_PLACEMENT_PROPOSALS, d))


class Scenario(BaseScenario):
    def make_world(self, batch_dim: int, device=None, **kwargs):
        self.init_params(batch_dim, **kwargs)
        self.visualize_semidims = False
        world = World(
            batch_dim,
            device,
            x_semidim=self.world_x_dim,
            y_semidim=self.world_y_dim,
            dt=self.dt,
        )
        for i in range(self.n_agents):
            world.add_agent(
                Agent(
                    name=f"agent_{i}",
                    shape=Box(length=self.l_f + self.l_r,
                              width=self.agent_width),
                    color=tuple(np.random.RandomState(i).rand(3).tolist()),
                    collide=False,
                    u_range=[self.max_speed, self.max_steering_angle],
                    u_multiplier=[1, 1],
                    max_speed=self.max_speed,
                    dynamics=KinematicBicycle(
                        world,
                        width=self.agent_width,
                        l_f=self.l_f,
                        l_r=self.l_r,
                        max_steering_angle=self.max_steering_angle,
                        integration="rk4",
                    ),
                )
            )
        # Static tables on the device, made once: no step copies from the
        # host.
        dev = world.device
        self._tables = road_geometry_cuda.path_tables(
            self.paths,
            width=self.agent_width,
            length=self.l_f + self.l_r,
            K=self.n_points_short_term,
            SI=self.sample_interval_ref_path,
            entry_exit=self._entry_exit,
            n_agents=self.n_agents,
            device=dev,
        )
        self._vec_norm = torch.as_tensor(self.paths.vec_norm, device=dev)
        self._group_offsets = torch.as_tensor(self.group_offsets, device=dev)
        self._group_sizes = torch.as_tensor(self.group_sizes, device=dev)
        self._normalizer_pos_world = torch.as_tensor(
            self.normalizer_pos_world, device=dev)
        self._env_rows = torch.arange(batch_dim, device=dev)
        # The sub-maps an env can draw (map '3': those of nonzero
        # probability).
        groups = [
            g for j, g in enumerate(zip(self.group_offsets.tolist(),
                                        self.group_sizes.tolist()))
            if self.map_type != "3" or self.scenario_probabilities[j] > 0
        ]
        self._proposals = placement_proposals(
            self.paths,
            groups,
            self.point_range_open,
            self.reset_agent_min_distance,
            self.n_agents,
        )
        return world

    def init_params(self, batch_dim, **kwargs):
        self.world_x_dim = kwargs.pop("world_x_dim", 4.5)
        self.world_y_dim = kwargs.pop("world_y_dim", 4.0)
        self.agent_width = kwargs.pop("agent_width", 0.08)
        self.agent_length = kwargs.pop("agent_length", 0.16)
        self.l_f = kwargs.pop("l_f", self.agent_length / 2)
        self.l_r = kwargs.pop("l_r", self.agent_length - self.l_f)
        lane_width = kwargs.pop("lane_width", 0.15)

        r_p_normalizer = 100
        self.reward_progress = kwargs.pop("reward_progress", 10) / r_p_normalizer
        self.reward_vel = kwargs.pop("reward_vel", 5) / r_p_normalizer
        self.reward_reach_goal = (
            kwargs.pop("reward_reach_goal", 0) / r_p_normalizer
        )

        self.threshold_deviate_from_ref_path = kwargs.pop(
            "threshold_deviate_from_ref_path",
            (lane_width - self.agent_width) / 2,
        )
        self.threshold_reach_goal = kwargs.pop(
            "threshold_reach_goal", self.agent_width / 2
        )
        self.threshold_change_steering = kwargs.pop(
            "threshold_change_steering", 10
        )
        self.threshold_near_boundary_high = kwargs.pop(
            "threshold_near_boundary_high",
            (lane_width - self.agent_width) / 2 * 0.9,
        )
        self.threshold_near_boundary_low = kwargs.pop(
            "threshold_near_boundary_low", 0
        )
        self.threshold_near_other_agents_c2c_high = kwargs.pop(
            "threshold_near_other_agents_c2c_high",
            self.agent_length + self.agent_width,
        )
        self.threshold_near_other_agents_c2c_low = kwargs.pop(
            "threshold_near_other_agents_c2c_low",
            (self.agent_length + self.agent_width) / 2,
        )
        kwargs.pop("threshold_no_reward_if_too_close_to_boundaries", None)
        kwargs.pop("threshold_no_reward_if_too_close_to_other_agents", None)

        self.resolution_factor = kwargs.pop("resolution_factor", 200)
        self.sample_interval_ref_path = kwargs.pop(
            "sample_interval_ref_path", 2
        )
        kwargs.pop("max_ref_path_points", None)
        self.noise_level = kwargs.pop("noise_level", 0.2 * self.agent_width)
        n_stored_steps = kwargs.pop("n_stored_steps", 5)
        n_observed_steps = kwargs.pop("n_observed_steps", 1)
        assert 1 <= n_observed_steps <= n_stored_steps, (
            "n_observed_steps must be in [1, n_stored_steps]"
        )
        # The reference stores n_observed_steps (road_traffic.py:3119) but
        # its observations read only the latest stored step, so every
        # accepted value gives the same observations.
        self.n_observed_steps = n_observed_steps
        self.render_origin = kwargs.pop(
            "render_origin", [self.world_x_dim / 2, self.world_y_dim / 2]
        )
        self.viewer_size = kwargs.pop(
            "viewer_size",
            (
                int(self.world_x_dim * self.resolution_factor),
                int(self.world_y_dim * self.resolution_factor),
            ),
        )
        self.max_steering_angle = float(
            kwargs.pop("max_steering_angle", math.radians(35))
        )
        self.max_speed = kwargs.pop("max_speed", 1.0)
        self.viewer_zoom = kwargs.pop("viewer_zoom", 1.44)

        self.n_agents = kwargs.pop("n_agents", 20)
        self.is_partial_observation = kwargs.pop(
            "is_partial_observation", True
        )
        self.is_testing_mode = kwargs.pop("is_testing_mode", False)
        self.is_visualize_short_term_path = kwargs.pop(
            "is_visualize_short_term_path", True
        )
        self.map_type = kwargs.pop("map_type", "1")
        assert self.map_type in ("1", "2", "3"), (
            f"map_type must be one of '1'/'2'/'3', got {self.map_type!r}"
        )
        self.n_nearing_agents_observed = kwargs.pop(
            "n_nearing_agents_observed", 2
        )
        kwargs.pop("is_real_time_rendering", None)
        self.n_points_short_term = kwargs.pop("n_points_short_term", 3)
        self.dt = kwargs.pop("dt", 0.05)
        self.is_ego_view = kwargs.pop("is_ego_view", True)
        self.is_apply_mask = kwargs.pop("is_apply_mask", True)
        self.is_observe_vertices = kwargs.pop("is_observe_vertices", True)
        self.is_observe_distance_to_agents = kwargs.pop(
            "is_observe_distance_to_agents", True
        )
        self.is_observe_distance_to_boundaries = kwargs.pop(
            "is_observe_distance_to_boundaries", True
        )
        self.is_observe_distance_to_center_line = kwargs.pop(
            "is_observe_distance_to_center_line", True
        )
        self.scenario_probabilities = [
            float(p)
            for p in kwargs.pop("scenario_probabilities", [1.0, 0.0, 0.0])
        ]
        self.is_add_noise = kwargs.pop("is_add_noise", True)
        self.is_observe_ref_path_other_agents = kwargs.pop(
            "is_observe_ref_path_other_agents", False
        )
        kwargs.pop("is_visualize_extra_info", None)
        kwargs.pop("render_title", None)
        self.n_steps_stored = kwargs.pop("n_steps_stored", 10)
        self.n_steps_before_recording = kwargs.pop(
            "n_steps_before_recording", 10
        )
        self.n_points_nearing_boundary = kwargs.pop(
            "n_points_nearing_boundary", 5
        )
        kwargs.pop("parameters", None)
        kwargs.pop("is_prb", None)
        self.probability_record = float(
            kwargs.pop("probability_record", 1.0)
        )
        self.probability_use_recording = float(
            kwargs.pop("probability_use_recording", 0.2)
        )
        self.initial_state_buffer_size = int(
            kwargs.pop("initial_state_buffer_size", 8)
        )

        if self.map_type == "3":
            if (
                self.scenario_probabilities[1] != 0
                or self.scenario_probabilities[2] != 0
            ):
                if self.n_agents > 5:
                    raise ValueError(
                        "For map_type '3', if the second or third value of"
                        " scenario_probabilities is not zero, a maximum of 5"
                        " agents are allowed, as only a merge-in or a"
                        " merge-out will be used."
                    )
            else:
                if self.n_agents > 10:
                    raise ValueError(
                        "For map_type '3', if only the first value of"
                        " scenario_probabilities is not zero, a maximum of"
                        " 10 agents are allowed, as only an intersection"
                        " will be used."
                    )

        if self.n_nearing_agents_observed >= self.n_agents:
            raise ValueError(
                "n_nearing_agents_observed must be less than n_agents"
            )

        # Map and reference paths (numpy, once)
        map_file_path = kwargs.pop("map_file_path", None)
        ScenarioUtils.check_kwargs_consumed(kwargs)
        self.map_data = rtm.get_map_data(map_file_path)
        (
            paths_all,
            paths_intersection,
            paths_merge_in,
            paths_merge_out,
        ) = rtm.get_reference_paths(self.map_data)
        if self.map_type in ("1", "2"):
            # scenario_id 0 = the whole map (road_traffic.py:279-292)
            path_groups = [paths_all]
        else:
            # scenario_id 1/2/3 = intersection / merge-in / merge-out
            path_groups = [
                paths_intersection,
                paths_merge_in,
                paths_merge_out,
            ]
        paths_concat = [p for group in path_groups for p in group]
        n_extend = self.n_points_short_term * self.sample_interval_ref_path
        max_points = (
            max(p["center_line"].shape[0] for p in paths_concat)
            + n_extend
            + 2
        )
        self.paths = rtm.PaddedPaths(paths_concat, n_extend, max_points)
        self.n_paths = len(paths_concat)
        self.max_ref_points = max_points
        sizes = [len(g) for g in path_groups]
        self.group_offsets = np.cumsum([0] + sizes)[:-1].astype(np.int32)
        self.group_sizes = np.asarray(sizes, np.int32)
        # Initial point_id range (road_traffic.py:1126-1134): [6, n/2) when
        # only the whole map / intersection is in play, else [3, n-5); the
        # reference gates this on scenario_probabilities alone.
        self.point_range_open = (
            self.scenario_probabilities[1] != 0
            or self.scenario_probabilities[2] != 0
        )
        # Whether collisions test the entry and exit segments
        # (road_traffic.py:1631-1641; loops have none).
        self._entry_exit = (
            (self.map_type == "3" or self.is_testing_mode)
            and not all(self.paths.is_loop)
        )

        # Normalizers (road_traffic.py:723-745)
        self.normalizer_pos = self.agent_length * 10
        self.normalizer_pos_world = np.asarray(
            [self.world_x_dim, self.world_y_dim], np.float32
        )
        self.normalizer_v = self.max_speed
        self.normalizer_rot = 2 * np.pi
        self.normalizer_action_steering = self.max_steering_angle
        self.normalizer_action_vel = self.max_speed
        self.normalizer_distance_lanelet = lane_width * 3
        self.normalizer_distance_ref = lane_width * 3

        # Penalties (road_traffic.py:491-509)
        self.penalty_deviate_from_ref_path = -2 / 100
        self.penalty_weighting_deviate_from_ref_path = (
            self.map_data["mean_lane_width"] / 2
        )
        self.penalty_near_boundary = -20 / 100
        self.penalty_near_other_agents = -20 / 100
        self.penalty_collide_with_agents = -100 / 100
        self.penalty_collide_with_boundaries = -100 / 100
        self.penalty_change_steering = -2 / 100
        self.penalty_time = 5 / 100

        w = np.linspace(1, 0.2, self.n_points_short_term, dtype=np.float32)
        self.weighting_ref_directions = w / w.sum()
        # fp32 max_speed * dt, as the JAX package's [A] max-speed array
        # times dt rounds it.
        self._max_speed_dt = float(
            np.float32(self.max_speed) * np.float32(self.dt))

        self.distance_mask_agents = self.normalizer_pos
        self.reset_agent_min_distance = (
            math.sqrt((self.l_f + self.l_r) ** 2 + self.agent_width**2) * 1.2
        )

    # ------------------------------------------------------------------ #
    # Map '2': the state-history ring and the initial-state buffer (the
    # reference's StateBuffer / InitialStateBuffer, road_traffic.py:
    # 3003-3086, per env and batch-leading), written in place
    # ------------------------------------------------------------------ #
    def _current_snapshot(self):
        """``[B, A, 8]`` rows of ``[pos_x, pos_y, rot, vel_x, vel_y,
        scenario_id, path_id, point_id]`` (road_traffic.py:862-869),
        detached."""
        s = self.world.state
        sid = self.scenario_id[:, None, None].expand(-1, self.n_agents, 1)
        return torch.cat([
            s.pos, s.rot, s.vel, sid.to(torch.float32),
            self.path_id[..., None].to(torch.float32),
            self.point_id[..., None].to(torch.float32),
        ], dim=-1).detach()

    def _hist_push(self, snap):
        """Write ``snap`` at each env's ring pointer and advance it."""
        H = self.n_steps_before_recording
        hist = self.world.own_extra("scenario.state_hist")
        hist[self._env_rows, self.hist_ptr.long()] = snap
        self.hist_ptr = (self.hist_ptr + 1) % H
        self.hist_len = torch.clamp_max(self.hist_len + 1, H)

    def _hist_latest(self, n: int):
        """Per env the reference's ``CircularBuffer.get_latest(n)``
        (road_traffic.py:3028-3042): the state from ``n`` pushes ago, or
        the oldest entry where fewer than ``n`` pushes happened."""
        H = self.n_steps_before_recording
        idx = torch.where(n > self.hist_len, torch.zeros_like(self.hist_ptr),
                          (self.hist_ptr - n) % H)
        return self.state_hist[self._env_rows, idx.long()]

    def _hist_reset(self, env_mask):
        """The reference's ``state_buffer.reset()`` and ``add(current)``
        (road_traffic.py:1023-1035) in the envs of ``env_mask``: the ring
        zeroed with the current state in its first slot."""
        snap = self._current_snapshot()
        hist = self.world.own_extra("scenario.state_hist")
        hist.masked_fill_(env_mask[:, None, None, None], 0.0)
        hist[:, 0] = torch.where(env_mask[:, None, None], snap, hist[:, 0])
        one = torch.ones_like(self.hist_ptr)
        self.hist_ptr = torch.where(env_mask, one, self.hist_ptr)
        self.hist_len = torch.where(env_mask, one, self.hist_len)

    def _isb_append(self, mask, snap):
        """Append ``snap`` to the initial-state buffer of the envs of
        ``mask``: one row at each env's pointer, rewritten with its own
        value elsewhere."""
        S = self.initial_state_buffer_size
        rows, ptr = self._env_rows, self.isb_ptr.long()
        buf = self.world.own_extra("scenario.isb_buf")
        buf[rows, ptr] = torch.where(mask[:, None, None], snap, buf[rows, ptr])
        self.isb_ptr = torch.where(mask, (self.isb_ptr + 1) % S, self.isb_ptr)
        self.isb_len = torch.where(
            mask, torch.clamp_max(self.isb_len + 1, S), self.isb_len)

    def _recorded_starts(self):
        """A reset's replay draw (road_traffic.py:705-720): per env whether
        it starts from a recorded row (``probability_use_recording``, where
        the env has one) and that row, ``[B, A, 8]``, uniform over the
        env's rows."""
        B, dev = self.world.batch_dim, self.world.device
        g = self.world.generator
        use = ((torch.rand((B,), generator=g, device=dev)
                < self.probability_use_recording) & (self.isb_len >= 1))
        # jax.random.randint(k2, (B,), 0, max(isb_len, 1)) (:714-716):
        # torch.randint takes no per-env bound, so rec_idx =
        # min(floor(u * n), n - 1) with u uniform in [0, 1) and
        # n = max(isb_len, 1).
        n = torch.clamp_min(self.isb_len, 1)
        u = torch.rand((B,), generator=g, device=dev)
        rec_idx = torch.minimum((u * n.to(torch.float32)).long(),
                                (n - 1).long())
        return use, self.isb_buf[self._env_rows, rec_idx]

    # ------------------------------------------------------------------ #
    # Placement
    # ------------------------------------------------------------------ #
    def _group_bounds(self):
        """Per-env [lo, size) of the path-table slice the env draws its
        paths from (map_type '3' keeps each env to one sub-map)."""
        B = self.world.batch_dim
        dev = self.world.device
        if self.map_type == "3":
            return (self._group_offsets[self.scenario_id - 1],
                    self._group_sizes[self.scenario_id - 1])
        return (torch.zeros((B,), dtype=torch.int32, device=dev),
                torch.full((B,), self.n_paths, dtype=torch.int32, device=dev))

    def inject_reference_ids(self, scenario_id, path_id, point_id):
        """Test hook: overwrite the path-selection state with ids recorded
        from the reference implementation (parity replay).  The reference's
        path ids are local to the env's sub-map (road_traffic.py:455-463,
        1060-1093); these are global into the concatenated path table, so
        map '3' adds the sub-map's offset."""
        dev = self.world.device
        sid = torch.as_tensor(np.asarray(scenario_id)[:, 0], dtype=torch.int32,
                              device=dev)
        pid = torch.as_tensor(np.asarray(path_id), dtype=torch.int32,
                              device=dev)
        if self.map_type == "3":
            pid = pid + self._group_offsets[sid - 1][:, None]
        self.scenario_id = sid
        self.path_id = pid
        self.point_id = torch.as_tensor(np.asarray(point_id),
                                        dtype=torch.int32, device=dev)

    def _propose(self, n, group_lo, group_size):
        """``n`` proposals per env: ``(path_id, point_id) [n, B]`` int32
        and ``pos [n, B, 2]``, a uniform path of the env's group and a
        uniform point of its range."""
        g = self.world.generator
        dev = self.world.device
        B = self.world.batch_dim
        u_pid = torch.rand((n, B), generator=g, device=dev)
        pid = group_lo + torch.minimum(
            (u_pid * group_size.to(torch.float32)).to(torch.int32),
            group_size - 1,
        )
        lo, hi = point_range(self._tables.n_points[pid],
                             self.point_range_open)
        u = torch.rand((n, B), generator=g, device=dev)
        point = lo + (u * (hi - lo)).to(torch.int32)
        return pid, point, self._tables.center[pid, point]

    def _place(self, blockers, live, group_lo, group_size):
        """One agent's placement in every env: the first of
        ``self._proposals`` proposals at least ``reset_agent_min_distance``
        from every point of ``blockers [B, M, 2]``, or the last proposal
        where none is (counted in ``world.spawn_give_ups`` for the envs of
        ``live [B]``); returns ``(path_id, point_id) [B]`` int32, ``pos
        [B, 2]``, ``rot [B]`` and ``vel [B, 2]``."""
        B = self.world.batch_dim
        n = self._proposals
        pid, point, pos = self._propose(n, group_lo, group_size)
        diff = blockers[None] - pos[:, :, None, :]  # [n, B, M, 2]
        d2 = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
        clear = ~torch.any(d2 < self.reset_agent_min_distance**2, dim=-1)
        found = torch.any(clear, dim=0)  # [B]
        first = torch.argmax(clear.to(torch.uint8), dim=0)
        pick = torch.where(found, first, torch.full_like(first, n - 1))
        self.world.spawn_give_ups += (~found & live).sum()
        pid = torch.gather(pid, 0, pick[None])[0]
        point = torch.gather(point, 0, pick[None])[0]
        pos = torch.gather(pos, 0, pick[None, :, None].expand(1, B, 2))[0]
        yaw = self._vec_norm[pid, point]
        rot = torch.atan2(yaw[:, 1], yaw[:, 0])
        vel_abs = torch.rand((B,), generator=self.world.generator,
                             device=self.world.device) * self.max_speed
        vel = torch.stack([vel_abs * torch.cos(rot), vel_abs * torch.sin(rot)],
                          dim=-1)
        return pid, point, pos, rot, vel

    # ------------------------------------------------------------------ #
    def reset_world_at(self, env_index=None, agent_index=None):
        B, A = self.world.batch_dim, self.n_agents
        dev = self.world.device
        if agent_index is not None:
            # The reference's per-agent reset (road_traffic.py:917-922):
            # one agent re-placed, the others kept.
            mask = torch.zeros((B, A), dtype=torch.bool, device=dev)
            mask[:, agent_index] = env_index_to_mask(env_index, B, dev)
            self._reset_agents(mask)
            return

        env_mask = env_index_to_mask(env_index, B, dev)
        first = env_index is None and not self.world.has_extra(
            "scenario.path_id")
        if first:
            self.path_id = torch.zeros((B, A), dtype=torch.int32, device=dev)
            self.point_id = torch.zeros((B, A), dtype=torch.int32, device=dev)
            self.scenario_id = torch.zeros((B,), dtype=torch.int32,
                                           device=dev)
            if self.map_type == "3" or self.is_testing_mode:
                self.collide_entry = torch.zeros((B, A), dtype=torch.bool,
                                                 device=dev)
                self.collide_exit = torch.zeros((B, A), dtype=torch.bool,
                                                device=dev)
            if self.map_type == "2":
                H = self.n_steps_before_recording
                S = self.initial_state_buffer_size
                f32, i32 = torch.float32, torch.int32
                self.state_hist = torch.zeros((B, H, A, 8), dtype=f32,
                                              device=dev)
                self.hist_ptr = torch.zeros((B,), dtype=i32, device=dev)
                self.hist_len = torch.zeros((B,), dtype=i32, device=dev)
                self.isb_buf = torch.zeros((B, S, A, 8), dtype=f32,
                                           device=dev)
                self.isb_ptr = torch.zeros((B,), dtype=i32, device=dev)
                self.isb_len = torch.zeros((B,), dtype=i32, device=dev)

        if self.map_type == "3":
            # Per-env sub-map (road_traffic.py:1057-1093): a categorical
            # draw by thresholds on one uniform, Python floats only.
            probs = np.asarray(self.scenario_probabilities, np.float64)
            cum = np.cumsum(probs / probs.sum())[:-1]
            u = torch.rand((B,), generator=self.world.generator, device=dev)
            sid = torch.ones((B,), dtype=torch.int32, device=dev)
            for c in cum.tolist():
                sid = sid + (u >= c).to(torch.int32)
            self.scenario_id = TorchUtils.where_from_index(
                env_index, sid, self.scenario_id)
        group_lo, group_size = self._group_bounds()

        # Map '2': an env may start from a recorded state instead; its
        # placements are drawn all the same and then replaced.
        use_buffer = None
        live = env_mask
        if self.map_type == "2" and not first:
            use_buffer, record = self._recorded_starts()
            live = env_mask & ~use_buffer

        placed = torch.full((B, A, 2), 1e6, device=dev)
        new_path_id = self.path_id.clone()
        new_point_id = self.point_id.clone()
        for i, agent in enumerate(self.world.agents):
            pid, point, pos, rot, vel = self._place(placed, live,
                                                    group_lo, group_size)
            if use_buffer is not None:
                row = record[:, i]
                pid = torch.where(use_buffer, row[:, 6].to(torch.int32), pid)
                point = torch.where(use_buffer, row[:, 7].to(torch.int32),
                                    point)
                pos = torch.where(use_buffer[:, None], row[:, 0:2], pos)
                rot = torch.where(use_buffer, row[:, 2], rot)
                vel = torch.where(use_buffer[:, None], row[:, 3:5], vel)
            placed[:, i] = pos
            new_path_id[:, i] = pid
            new_point_id[:, i] = point
            agent.set_pos(pos, batch_index=env_index)
            agent.set_rot(rot[:, None], batch_index=env_index)
            agent.set_vel(vel, batch_index=env_index)
        self.path_id = TorchUtils.where_from_index(env_index, new_path_id,
                                                   self.path_id)
        self.point_id = TorchUtils.where_from_index(env_index, new_point_id,
                                                    self.point_id)
        if self.map_type == "2":
            self._hist_reset(env_mask)

        # Derived state
        s = self.world.state
        positions, rotations = s.pos, s.rot[..., 0]
        dist_ref, left_all, right_all, boundaries, short_term = (
            road_geometry_cuda.fused_geometry(
                self._tables, False, positions, rotations, self.path_id))

        def init_or_mask(name, value):
            if first:
                setattr(self, name, value)
            else:
                setattr(self, name, TorchUtils.where_from_index(
                    env_index, value, getattr(self, name)))

        init_or_mask("short_term", short_term)
        init_or_mask("prev_pos", positions)
        init_or_mask("distances_agents", self._mutual_distances(positions))
        init_or_mask("distances_ref", dist_ref)
        init_or_mask("distances_left_b", left_all)
        init_or_mask("distances_right_b", right_all)
        init_or_mask("distances_boundaries", boundaries)
        init_or_mask("collide_agents",
                     torch.zeros((B, A, A), dtype=torch.bool, device=dev))
        init_or_mask("collide_lanelets",
                     torch.zeros((B, A), dtype=torch.bool, device=dev))
        if self.map_type == "3" or self.is_testing_mode:
            init_or_mask("collide_entry",
                         torch.zeros((B, A), dtype=torch.bool, device=dev))
            init_or_mask("collide_exit",
                         torch.zeros((B, A), dtype=torch.bool, device=dev))
        init_or_mask("steering_hist",
                     torch.zeros((B, A, 2), dtype=torch.float32, device=dev))
        if env_index is None:
            self.rew_buf = torch.zeros((B,), dtype=torch.float32, device=dev)

    def _mutual_distances(self, positions):
        """Centre-to-centre distances with a large diagonal
        (road_traffic.py:3686-3711)."""
        d = TorchUtils.safe_norm(positions[:, :, None] - positions[:, None],
                                 dim=-1)
        big = torch.amax(d, dim=(-2, -1), keepdim=True) + 1
        eye = torch.eye(self.n_agents, dtype=torch.bool,
                        device=positions.device)[None]
        return torch.where(eye, big, d)

    # ------------------------------------------------------------------ #
    def reward(self, agent):
        i = agent.agent_index
        if i == 0:
            s = self.world.state
            positions, rotations, vels = s.pos, s.rot[..., 0], s.vel
            self.distances_agents = self._mutual_distances(positions)
            (
                dist_ref,
                left_all,
                right_all,
                boundaries,
                new_short,
                _vertices,
                coll_lane,
                coll_entry,
                coll_exit,
                coll_agents,
            ) = road_geometry_cuda.fused_geometry(
                self._tables, True, positions, rotations, self.path_id)
            self._new_short_term = new_short  # applied after rewarding
            self.distances_ref = dist_ref
            self.distances_left_b = left_all
            self.distances_right_b = right_all
            self.distances_boundaries = boundaries
            self.collide_agents = coll_agents > 0.5
            self.collide_lanelets = coll_lane > 0.5
            if self._entry_exit:
                self.collide_entry = coll_entry > 0.5
                self.collide_exit = coll_exit > 0.5

            # All agents' rewards at once ([B, A] elementwise).
            # Forward movement along the previous short-term path: the
            # weights sum to 1, so the weighted projections collapse to one
            # dot with the weighted point (road_traffic.py reward()).
            prev = self.prev_pos
            st = self.short_term
            st_w = st[:, :, 0] * float(self.weighting_ref_directions[0])
            for k in range(1, self.n_points_short_term):
                st_w = st_w + st[:, :, k] * float(
                    self.weighting_ref_directions[k])
            st_mean = torch.mean(st, dim=2)
            move = positions - prev
            move_projected_weighted = torch.sum(move * (st_w - prev), dim=-1)
            rew = (move_projected_weighted / self._max_speed_dt
                   * self.reward_progress)

            # High velocity
            v_proj = torch.sum(vels * (st_mean - prev), dim=-1)
            factor_moving_direction = torch.where(
                v_proj > 0, torch.ones_like(v_proj), 2 * torch.ones_like(v_proj))
            rew = rew + (factor_moving_direction * v_proj / self.max_speed
                         * self.reward_vel)

            # Close to lanelet boundaries
            rew = rew + (
                rg.exponential_decreasing_fcn(
                    self.distances_boundaries,
                    self.threshold_near_boundary_low,
                    self.threshold_near_boundary_high,
                )
                * self.penalty_near_boundary
            )
            # Close to other agents
            rew = rew + (
                torch.sum(
                    rg.exponential_decreasing_fcn(
                        self.distances_agents,
                        self.threshold_near_other_agents_c2c_low,
                        self.threshold_near_other_agents_c2c_high,
                    ),
                    dim=-1,
                )
                * self.penalty_near_other_agents
            )
            # Deviating from the reference path
            rew = rew + (
                self.distances_ref
                / self.penalty_weighting_deviate_from_ref_path
                * self.penalty_deviate_from_ref_path
            )
            # Changing steering too quickly (the two latest normalised
            # steering actions)
            steering_change = torch.clamp_min(
                torch.abs(self.steering_hist[:, :, 0]
                          - self.steering_hist[:, :, 1])
                * self.normalizer_action_steering
                - math.radians(self.threshold_change_steering),
                0.0,
            )
            steering_change_reward_factor = steering_change / (
                2 * self.max_steering_angle
                - 2 * math.radians(self.threshold_change_steering)
            )
            rew = rew + (
                steering_change_reward_factor * self.penalty_change_steering
            )
            # Collisions
            rew = rew + (torch.any(self.collide_agents, dim=-1)
                         * self.penalty_collide_with_agents)
            rew = rew + (self.collide_lanelets
                         * self.penalty_collide_with_boundaries)
            # Reaching the goal: the exit segment of a non-loop path
            # (road_traffic.py:1488-1493)
            if self.map_type == "3" or self.is_testing_mode:
                rew = rew + self.collide_exit * self.reward_reach_goal
            # Time
            rew = rew + (
                torch.where(v_proj > 0, torch.ones_like(v_proj),
                            -torch.ones_like(v_proj))
                * TorchUtils.safe_norm(vels, dim=-1)
                / self.max_speed
                * self.penalty_time
            )
            self._rewards_all = rew

        rew = self._rewards_all[:, i]
        if i == self.n_agents - 1:
            # Post-reward updates (road_traffic.py:1716-1734)
            self.prev_pos = self.world.state.pos
            self.short_term = self._new_short_term
            if self.map_type == "2":
                # The step's state into the history ring
                # (road_traffic.py:1718-1730).
                self._hist_push(self._current_snapshot())
        return rew

    _new_short_term = None
    _map_render = None  # the lanelets' segments, made at the first frame

    # ------------------------------------------------------------------ #
    def observation(self, agent):
        i = agent.agent_index
        B, A = self.world.batch_dim, self.n_agents

        if i == 0:
            s = self.world.state
            positions, rotations, vels = s.pos, s.rot[..., 0], s.vel
            vel_abs = TorchUtils.safe_norm(vels, dim=-1)  # [B, A]
            # Own components (the [i, i] diagonal of the pair matrices:
            # rot_rel is 0, so the ego velocity is (|v|, 0)).
            self._obs_self_pos = positions / self._normalizer_pos_world
            self._obs_self_rot = torch.zeros_like(rotations)
            self._obs_self_vel = (
                torch.stack([vel_abs, torch.zeros_like(vel_abs)], dim=-1)
                / self.normalizer_v
            )
            k = self.n_nearing_agents_observed
            dists_norm = (self.distances_agents
                          / self.normalizer_distance_lanelet)
            if self.is_partial_observation and self.is_ego_view:
                # The k nearest agents in the ego frame, raw, then
                # normalised here.
                nd, pe, re_, ve, vt = road_geometry_cuda.fused_neighbor_obs(
                    A, k, (self.l_f + self.l_r) / 2.0, self.agent_width / 2.0,
                    positions, rotations, vels, dists_norm)
                self._nearing_dist_sel = nd
                self._obs_pos_sel = pe / self.normalizer_pos
                self._obs_rot_sel = re_ / self.normalizer_rot
                self._obs_vel_sel = ve / self.normalizer_v
                self._obs_vertices_sel = vt / self.normalizer_pos
            elif self.is_partial_observation:
                # The k nearest agents in the world frame.
                vertices = rg.get_rectangle_vertices(
                    positions, rotations, self.agent_width,
                    self.l_f + self.l_r)
                nd, idx = rg.select_nearest(dists_norm, k)
                self._nearing_dist_sel = nd
                pos_j = rg.gather_rows(positions, idx)
                rot_j = rg.gather_rows(rotations, idx)
                vel_abs_j = rg.gather_rows(vel_abs, idx)
                vert_j = rg.gather_rows(vertices[:, :, :4, :], idx)
                self._obs_pos_sel = pos_j / self._normalizer_pos_world
                rot_rel = rot_j - rotations[:, :, None]
                self._obs_rot_sel = rot_rel / self.normalizer_rot
                self._obs_vel_sel = torch.stack(
                    [vel_abs_j * torch.cos(rot_rel),
                     vel_abs_j * torch.sin(rot_rel)], dim=-1
                ) / self.normalizer_v
                vert_rel = vert_j - positions[:, :, None, None, :]
                self._obs_vertices_sel = rg.to_local(
                    vert_rel, rotations[:, :, None, None]) / self.normalizer_pos
            else:
                # Full pair matrices [B, A_i, A_j, ...]
                vertices = rg.get_rectangle_vertices(
                    positions, rotations, self.agent_width,
                    self.l_f + self.l_r)
                rel = positions[:, None, :, :] - positions[:, :, None, :]
                self._obs_pos = (
                    rg.to_local(rel, rotations[:, :, None])
                    / self.normalizer_pos
                    if self.is_ego_view
                    else (positions[:, None] / self._normalizer_pos_world
                          ).expand(B, A, A, 2)
                )
                rot_rel = rotations[:, None, :] - rotations[:, :, None]
                self._obs_rot = rot_rel / self.normalizer_rot
                self._obs_vel = torch.stack(
                    [vel_abs[:, None] * torch.cos(rot_rel),
                     vel_abs[:, None] * torch.sin(rot_rel)], dim=-1
                ) / self.normalizer_v
                vert_rel = (vertices[:, None, :, :4, :]
                            - positions[:, :, None, None, :])
                self._obs_vertices = rg.to_local(
                    vert_rel, rotations[:, :, None, None]) / self.normalizer_pos
            # Own short-term reference path in the ego frame
            ref_rel = self.short_term - positions[:, :, None, :]
            self._obs_ref_self = rg.to_local(
                ref_rel, rotations[:, :, None]) / self.normalizer_pos
            self._obs_dist_agents = dists_norm
            # The latest normalised steering actions, for the next step's
            # steering-change penalty.
            steering_now = s.u[:, :A, 1] / self.normalizer_action_steering
            self.steering_hist = torch.stack(
                [steering_now, self.steering_hist[:, :, 0]], dim=-1)

        # Other agents
        k = self.n_nearing_agents_observed
        if self.is_partial_observation:
            nearing_dist = self._nearing_dist_sel[:, i]  # [B, k]
            if self.is_apply_mask:
                mask_far = (nearing_dist * self.normalizer_distance_lanelet
                            >= self.distance_mask_agents)
            else:
                mask_far = torch.zeros((B, k), dtype=torch.bool,
                                       device=nearing_dist.device)
            one, zero = 1.0, 0.0
            obs_pos_other = torch.where(mask_far[..., None], one,
                                        self._obs_pos_sel[:, i])
            obs_rot_other = torch.where(mask_far, zero, self._obs_rot_sel[:, i])
            obs_vel_other = torch.where(mask_far[..., None], zero,
                                        self._obs_vel_sel[:, i])
            obs_vert_other = torch.where(mask_far[..., None, None], one,
                                         self._obs_vertices_sel[:, i])
            obs_dist_other = torch.where(mask_far, one, nearing_dist)
        else:
            k = A
            obs_pos_other = self._obs_pos[:, i]
            obs_rot_other = self._obs_rot[:, i]
            obs_vel_other = self._obs_vel[:, i]
            obs_vert_other = self._obs_vertices[:, i]
            obs_dist_other = self._obs_dist_agents[:, i].clone()
            obs_dist_other[:, i] = 0.0

        others = [
            obs_vert_other.reshape(B, k, -1)
            if self.is_observe_vertices
            else torch.cat([obs_pos_other.reshape(B, k, -1),
                            obs_rot_other.reshape(B, k, -1)], dim=-1),
            obs_vel_other.reshape(B, k, -1),
        ]
        if self.is_observe_distance_to_agents:
            others.append(obs_dist_other.reshape(B, k, -1))
        obs_other_agents = torch.cat(others, dim=-1).reshape(B, -1)

        obs_self = []
        if not self.is_ego_view:
            obs_self.append(self._obs_self_pos[:, i].reshape(B, -1))
            obs_self.append(self._obs_self_rot[:, i].reshape(B, -1))
            obs_self.append(self._obs_self_vel[:, i].reshape(B, -1))
        else:
            # In the ego frame only the longitudinal velocity informs.
            obs_self.append(self._obs_self_vel[:, i, 0].reshape(B, -1))
        obs_self.append(self._obs_ref_self[:, i].reshape(B, -1))
        if self.is_observe_distance_to_center_line:
            obs_self.append((self.distances_ref[:, i]
                             / self.normalizer_distance_lanelet).reshape(B, -1))
        if self.is_observe_distance_to_boundaries:
            obs_self.append((torch.amin(self.distances_left_b[:, i], dim=-1)
                             / self.normalizer_distance_lanelet
                             ).reshape(B, -1))
            obs_self.append((torch.amin(self.distances_right_b[:, i], dim=-1)
                             / self.normalizer_distance_lanelet
                             ).reshape(B, -1))

        obs = torch.cat(obs_self + [obs_other_agents], dim=-1)
        if self.is_add_noise:
            obs = obs + self.noise_level * torch.rand(
                obs.shape, generator=self.world.generator,
                device=obs.device)
        return obs

    # ------------------------------------------------------------------ #
    def done(self):
        return self._done(in_reset=False)

    def done_query(self, *, in_reset: bool = False):
        return self._done(in_reset=in_reset)

    def _done(self, in_reset: bool):
        B = self.world.batch_dim
        is_collision_with_agents = torch.any(
            self.collide_agents.reshape(B, -1), dim=-1)
        is_collision_with_lanelets = torch.any(self.collide_lanelets, dim=-1)

        if in_reset:
            # A reset's query reports the flags only: the re-placements
            # below are per-step semantics (the reference runs them in
            # done() after world.step, road_traffic.py:2302-2345) and would
            # re-place agents from stale pre-reset flags.
            if self.is_testing_mode:
                return torch.zeros((B,), dtype=torch.bool,
                                   device=self.world.device)
            return is_collision_with_agents | is_collision_with_lanelets

        if self.map_type == "2":
            # Record the state from n_steps_stored steps before an
            # agent-agent collision (road_traffic.py:2302-2310), a per-env
            # draw where the reference draws once for all envs.
            do_record = (torch.rand((B,), generator=self.world.generator,
                                    device=self.world.device)
                         < self.probability_record) & is_collision_with_agents
            self._isb_append(do_record,
                             self._hist_latest(self.n_steps_stored))

        if self.is_testing_mode:
            # Collisions never terminate; only the colliding agents are
            # re-placed (road_traffic.py:2313-2330).
            agents_reset = (torch.any(self.collide_agents, dim=-1)
                            | self.collide_lanelets)
            if self._entry_exit:
                agents_reset = (agents_reset | self.collide_entry
                                | self.collide_exit)
            self._reset_agents(agents_reset)
            return torch.zeros((B,), dtype=torch.bool,
                               device=self.world.device)

        done = is_collision_with_agents | is_collision_with_lanelets
        if self.map_type == "3":
            # Agents leaving through their entry or exit segment are
            # re-placed unless the whole env terminates
            # (road_traffic.py:2332-2345); a masked update every step.
            agents_reset = ((self.collide_entry | self.collide_exit)
                            & ~done[:, None])
            self._reset_agents(agents_reset)
        return done

    def _reset_agents(self, mask):
        """Re-place agent a of env b where ``mask [B, A]`` is True (the
        reference's ``reset_world_at(env_index, agent_index)`` loop,
        road_traffic.py:917-1035, as one masked update): a new path and
        point of the env's sub-map, clear of all agents' current
        positions; the env's derived buffers are refreshed where any agent
        moved."""
        B, A = self.world.batch_dim, self.n_agents
        group_lo, group_size = self._group_bounds()
        positions = self.world.state.pos.clone()
        new_path_id = self.path_id.clone()
        new_point_id = self.point_id.clone()
        others = ~torch.eye(A, dtype=torch.bool, device=positions.device)
        for i, agent in enumerate(self.world.agents):
            m = mask[:, i]
            # Agent i does not block itself: its blocker entry lies far.
            blockers = torch.where(others[i][None, :, None], positions,
                                   torch.full_like(positions, 1e6))
            pid, point, pos, rot, vel = self._place(blockers, m, group_lo,
                                                    group_size)
            new_pos = torch.where(m[:, None], pos, agent.state.pos)
            agent.set_pos(new_pos)
            agent.set_rot(torch.where(m[:, None], rot[:, None],
                                      agent.state.rot))
            agent.set_vel(torch.where(m[:, None], vel, agent.state.vel))
            positions[:, i] = new_pos
            new_path_id[:, i] = torch.where(m, pid, new_path_id[:, i])
            new_point_id[:, i] = torch.where(m, point, new_point_id[:, i])
        self.path_id = new_path_id
        self.point_id = new_point_id

        # Refresh the derived buffers of envs with a re-placed agent (the
        # reference's reset_init_distances_and_short_term_ref_path and flag
        # refresh, road_traffic.py:1002-1020); the progress reward's
        # previous positions too, so a teleport never counts as progress.
        env_m = torch.any(mask, dim=-1)
        s = self.world.state
        positions, rotations = s.pos, s.rot[..., 0]
        dist_ref, left_all, right_all, boundaries, short_term = (
            road_geometry_cuda.fused_geometry(
                self._tables, False, positions, rotations, self.path_id))

        def mask_update(name, value):
            old = getattr(self, name)
            m = env_m.reshape((B,) + (1,) * (value.ndim - 1))
            setattr(self, name, torch.where(m, value, old))

        mask_update("short_term", short_term)
        mask_update("distances_agents", self._mutual_distances(positions))
        mask_update("distances_ref", dist_ref)
        mask_update("distances_left_b", left_all)
        mask_update("distances_right_b", right_all)
        mask_update("distances_boundaries", boundaries)
        mask_update("prev_pos", positions)
        self.collide_agents = self.collide_agents & ~env_m[:, None, None]
        self.collide_lanelets = self.collide_lanelets & ~env_m[:, None]
        if self.map_type == "3" or self.is_testing_mode:
            self.collide_entry = self.collide_entry & ~env_m[:, None]
            self.collide_exit = self.collide_exit & ~env_m[:, None]
        if self.map_type == "2":
            self._hist_reset(env_m)

    def info(self, agent):
        i = agent.agent_index
        pos_world = self._normalizer_pos_world
        return {
            "pos": agent.state.pos / pos_world,
            "rot": rg.angle_eliminate_two_pi(agent.state.rot)
            / self.normalizer_rot,
            "vel": agent.state.vel / self.normalizer_v,
            "act_vel": agent.action.u[:, 0] / self.normalizer_action_vel,
            "act_steer": agent.action.u[:, 1]
            / self.normalizer_action_steering,
            "ref": (self.short_term[:, i] / pos_world).reshape(
                self.world.batch_dim, -1),
            "distance_ref": self.distances_ref[:, i]
            / self.normalizer_distance_ref,
            "distance_left_b": torch.amin(self.distances_left_b[:, i], dim=-1)
            / self.normalizer_distance_lanelet,
            "distance_right_b": torch.amin(self.distances_right_b[:, i],
                                           dim=-1)
            / self.normalizer_distance_lanelet,
            "is_collision_with_agents": torch.any(self.collide_agents[:, i],
                                                  dim=-1),
            "is_collision_with_lanelets": torch.any(self.collide_lanelets,
                                                    dim=-1),
        }

    def _map_geoms(self):
        """The lanelets' boundaries as segments, built at the first frame
        from the map the scenario holds and kept."""
        from vectorizedmultiagentsimulator_tpu_torch import render as rendering

        if self._map_render is None:
            self._map_render = []
            for lanelet in self.map_data["lanelets"]:
                for bound in ("left_boundary", "right_boundary"):
                    pts = np.asarray(lanelet[bound])
                    for p0, p1 in zip(pts[:-1], pts[1:]):
                        seg = rendering.Line(tuple(p0), tuple(p1), width=0.005)
                        seg.set_color(*Color.BLACK.value)
                        self._map_render.append(seg)
        return self._map_render

    def extra_render(self, env_index: int = 0):
        from vectorizedmultiagentsimulator_tpu_torch import render as rendering

        geoms = list(self._map_geoms())
        if self.is_visualize_short_term_path:
            st = np.asarray(self.short_term)[env_index]
            for i_agent in range(self.n_agents):
                color = self.world.agents[i_agent].color
                pts = st[i_agent]
                for p0, p1 in zip(pts[:-1], pts[1:]):
                    seg = rendering.Line(tuple(p0), tuple(p1), width=0.004)
                    seg.set_color(*color[:3])
                    geoms.append(seg)
        return geoms
