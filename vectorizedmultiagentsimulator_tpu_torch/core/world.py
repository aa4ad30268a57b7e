"""The vectorized world: construction, state owner, and physics stepper.

PyTorch counterpart of ``vectorizedmultiagentsimulator_tpu/core/world.py``
(reference ``vmas/simulator/core.py:1090-2919``).  Collision pairs are
classified once at finalize into static index tables per shape-pair class;
per-pair forces are summed per entity through a 0/1 incidence matrix; the
integration is one vectorized update.  ``step`` runs the hand-written CUDA
kernel (``ops/physics_cuda.py``) for worlds it supports, and
``_step_core`` — the plain PyTorch version and the kernel's reference —
for the rest.  Joints (``core/joints.py``) become a static constraint
table whose forces come first in every substep, before the contact
classes.  ``cast_rays`` and ``measure_lidar`` (the LIDAR, every LIDAR
of a group in one launch) run the ray-cast kernel (``ops/raycast_cuda.py``)
on CUDA tensors and its plain version on CPU tensors.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from vectorizedmultiagentsimulator_tpu_torch.core import shapes as shp
from vectorizedmultiagentsimulator_tpu_torch.core.entities import (
    Agent,
    Entity,
    Landmark,
)
from vectorizedmultiagentsimulator_tpu_torch.core.joints import (
    Joint,
    JointConstraint,
)
from vectorizedmultiagentsimulator_tpu_torch.core.state import WorldState
from vectorizedmultiagentsimulator_tpu_torch.ops import geometry as geo
from vectorizedmultiagentsimulator_tpu_torch.ops import physics_cuda
from vectorizedmultiagentsimulator_tpu_torch.ops import raycast_cuda
from vectorizedmultiagentsimulator_tpu_torch.utils import (
    ANGULAR_FRICTION,
    COLLISION_FORCE,
    DRAG,
    JOINT_FORCE,
    LINEAR_FRICTION,
    LINE_MIN_DIST,
    TORQUE_CONSTRAINT_FORCE,
    TorchUtils,
    X,
    Y,
    env_index_to_mask,
    resolve_device,
)

Tensor = torch.Tensor

PAIR_CLASSES = ("ss", "ls", "ll", "bs", "bl", "bb")


def _version(x: Tensor):
    """``x``'s version counter, or None for an inference tensor (which
    keeps none)."""
    try:
        return x._version
    except RuntimeError:
        return None


class _CastGroup:
    """LIDARs cast in one launch: their agents (``origins``), shared base
    angles, ``max_range`` and cast table.  Holds the last cast ``[O, B,
    R]`` with what it read: the very ``pos`` and ``rot`` tensors, their
    versions, the result's own version and the grad mode.  The world
    replaces ``pos`` and ``rot`` on every write and ``bind`` swaps the
    state, so any pose change, an in-place one included, casts anew."""

    __slots__ = ("origins", "angles", "max_range", "table", "out", "read")

    def __init__(self, origins, angles, max_range, table):
        self.origins, self.angles = origins, angles
        self.max_range, self.table = max_range, table
        self.out, self.read = None, None

    def cast(self, state: WorldState) -> Tensor:
        pos, rot, out = state.pos, state.rot, self.out
        if out is not None:
            p, r, versions = self.read
            if (p is pos and r is rot and None not in versions
                    and versions == (_version(pos), _version(rot),
                                     _version(out), torch.is_grad_enabled())):
                return out
        out = raycast_cuda.fused_cast_rays(pos, rot, self.angles, self.origins,
                                           self.table, self.max_range)
        self.out = out
        self.read = (pos, rot, (_version(pos), _version(rot), _version(out),
                                torch.is_grad_enabled()))
        return out


class World:
    def __init__(
        self,
        batch_dim: int,
        device=None,
        dt: float = 0.1,
        substeps: int = 1,
        drag: float = DRAG,
        linear_friction: float = LINEAR_FRICTION,
        angular_friction: float = ANGULAR_FRICTION,
        x_semidim: Optional[float] = None,
        y_semidim: Optional[float] = None,
        dim_c: int = 0,
        collision_force: float = COLLISION_FORCE,
        joint_force: float = JOINT_FORCE,
        torque_constraint_force: float = TORQUE_CONSTRAINT_FORCE,
        contact_margin: float = 1e-3,
        gravity: Tuple[float, float] = (0.0, 0.0),
    ):
        assert batch_dim > 0, f"Batch dim must be greater than 0, got {batch_dim}"
        self._batch_dim = batch_dim
        self._device = resolve_device(device)
        self._agents: List[Agent] = []
        self._landmarks: List[Landmark] = []
        self._joints: Dict[frozenset, JointConstraint] = {}
        self._x_semidim = x_semidim
        self._y_semidim = y_semidim
        self._dim_p = 2
        self._dim_c = dim_c
        self._dt = dt
        self._substeps = substeps
        self._sub_dt = dt / substeps
        self._drag = drag
        self._gravity = np.asarray(gravity, dtype=np.float32)
        self._linear_friction = linear_friction
        self._angular_friction = angular_friction
        self._collision_force = collision_force
        self._joint_force = joint_force
        self._contact_margin = contact_margin
        self._torque_constraint_force = torque_constraint_force

        self._finalized = False
        self._state: Optional[WorldState] = None
        # extras key -> id of the tensor a borrowed state lends (own_extra)
        self._borrowed: Dict[str, int] = {}
        self.generator: Optional[torch.Generator] = None
        # Whether step() runs the CUDA kernel (physics_cuda.step_supported);
        # set at finalize and pinned again by the Environment after its
        # first reset, when per-env extras such as dyn_mass exist.
        self._use_kernel = False
        self._kernel_tables = None
        # Ray-cast tables per (origin entity index, entity filter), built
        # at the first cast (cast_rays); LIDAR groups per (LIDAR, agent,
        # filter), built at the first measure (measure_lidar).
        self._cast_tables: Dict[tuple, raycast_cuda.CastTable] = {}
        self._lidar_groups: Dict[tuple, Tuple[_CastGroup, int]] = {}

    # ------------------------------------------------------------------ #
    # Construction API
    # ------------------------------------------------------------------ #
    def add_agent(self, agent: Agent):
        """Only way to add agents to the world (core.py:1152)."""
        assert not self._finalized, "Cannot add entities after finalize"
        agent._world = self
        self._agents.append(agent)

    def add_landmark(self, landmark: Landmark):
        assert not self._finalized, "Cannot add entities after finalize"
        landmark._world = self
        self._landmarks.append(landmark)

    def add_joint(self, joint: Joint):
        assert self._substeps > 1, "For joints, world substeps needs to be more than 1"
        if joint.landmark is not None:
            self.add_landmark(joint.landmark)
        # A later constraint on the same pair replaces an earlier one.
        for constraint in joint.joint_constraints:
            self._joints[
                frozenset({constraint.entity_a.name, constraint.entity_b.name})
            ] = constraint

    # ------------------------------------------------------------------ #
    # Properties (API parity, core.py:1187-1232)
    # ------------------------------------------------------------------ #
    @property
    def batch_dim(self):
        return self._batch_dim

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def agents(self) -> List[Agent]:
        return self._agents

    @property
    def landmarks(self) -> List[Landmark]:
        return self._landmarks

    @property
    def entities(self) -> List[Entity]:
        return self._landmarks + self._agents

    @property
    def policy_agents(self) -> List[Agent]:
        return [a for a in self._agents if a.action_script is None]

    @property
    def scripted_agents(self) -> List[Agent]:
        return [a for a in self._agents if a.action_script is not None]

    @property
    def x_semidim(self):
        return self._x_semidim

    @property
    def y_semidim(self):
        return self._y_semidim

    @property
    def dt(self):
        return self._dt

    @property
    def dim_p(self):
        return self._dim_p

    @property
    def dim_c(self):
        return self._dim_c

    @property
    def substeps(self):
        return self._substeps

    @property
    def joints(self):
        return self._joints.values()

    @property
    def is_finalized(self):
        return self._finalized

    # ------------------------------------------------------------------ #
    # Finalize: static tables on the device + state
    # ------------------------------------------------------------------ #
    def finalize(self, seed: Optional[int] = None):
        assert not self._finalized, "World already finalized"
        ents = self.entities
        N = len(ents)
        A = len(self._agents)
        for i, e in enumerate(ents):
            e.index = i
        for j, a in enumerate(self._agents):
            a.agent_index = j
        self._n_entities = N
        self._n_landmarks = len(self._landmarks)

        names = [e.name for e in ents]
        assert len(set(names)) == len(names), f"Duplicate entity names: {names}"

        inf = np.inf
        f32 = np.float32

        def table(values, dtype=f32):
            return np.array(values, dtype=dtype)

        def or_default(v, d):
            return v if v is not None else d

        self._movable = table([e.movable for e in ents], bool)
        self._rotatable = table([e.rotatable for e in ents], bool)
        self._mass = table([e.mass for e in ents])
        self._moment = table([e.moment_of_inertia for e in ents])
        self._drag_coef = table([or_default(e.drag, self._drag) for e in ents])
        self._lin_friction = table(
            [or_default(e.linear_friction, self._linear_friction) for e in ents]
        )
        self._ang_friction = table(
            [or_default(e.angular_friction, self._angular_friction) for e in ents]
        )
        # Per-entity gravity: scalar/2-vector overrides are baked into the
        # static table; batched [B, 2] overrides live in
        # extras["<name>.dyn_gravity"] and are added in the step.
        grav_rows = []
        self._dyn_gravity_names: List[str] = []
        for e in ents:
            g = e._gravity
            if g is not None and np.ndim(g) == 2:
                self._dyn_gravity_names.append(e.name)
                grav_rows.append(self._gravity + 0.0)
            else:
                grav_rows.append(self._gravity + (g if g is not None else 0.0))
        self._gravity_vec = np.stack(grav_rows).astype(f32).reshape(N, 2)
        self._max_speed = table([or_default(e.max_speed, inf) for e in ents])
        self._v_range = table([or_default(e.v_range, inf) for e in ents])
        # Agent force/torque clamps [A]
        self._max_f = table([or_default(a.max_f, inf) for a in self._agents])
        self._f_range = table([or_default(a.f_range, inf) for a in self._agents])
        self._max_t = table([or_default(a.max_t, inf) for a in self._agents])
        self._t_range = table([or_default(a.t_range, inf) for a in self._agents])
        self._agent_movable = table([a.movable for a in self._agents], bool)
        self._agent_rotatable = table([a.rotatable for a in self._agents], bool)
        self._silent = table([a.silent for a in self._agents], bool)

        # Shape parameter tables
        self._radius = table(
            [e.shape.radius if isinstance(e.shape, shp.Sphere) else 0.0
             for e in ents]
        )
        self._length = table(
            [e.shape.length if isinstance(e.shape, (shp.Box, shp.Line)) else 0.0
             for e in ents]
        )
        self._width = table(
            [e.shape.width if isinstance(e.shape, shp.Box) else 0.0
             for e in ents]
        )
        self._hollow = table(
            [isinstance(e.shape, shp.Box) and e.shape.hollow for e in ents], bool
        )

        self._build_pair_tables()
        self._build_joint_tables()
        self._build_incidence()
        self._build_device_tables()

        self.generator = torch.Generator(device=self._device)
        self.generator.manual_seed(seed if seed is not None else 0)
        # Entities the rejection spawner placed at its give-up value, summed
        # over every reset so far; a device tensor, so counting never reads
        # the device.
        self.spawn_give_ups = torch.zeros(
            (), dtype=torch.long, device=self._device
        )
        # Per-agent u capacity: a scenario may write a u wider than
        # action_size as long as the dynamics model consumes it.
        self._u_widths = [a.action_size for a in self._agents]
        u_caps = [
            max(a.action_size, a.dynamics.needed_action_size)
            for a in self._agents
        ]
        self._state = WorldState.zeros(
            self._batch_dim, N, A, u_caps, self._dim_c, device=self._device
        )
        for a in self._agents:
            a.action._finalize(self._device)
        self._finalized = True
        for name in self._dyn_gravity_names:
            e = next(ent for ent in ents if ent.name == name)
            self.set_extra(
                f"{name}.dyn_gravity",
                torch.as_tensor(e._gravity, device=self._device)
                .expand(self._batch_dim, 2)
                .clone(),
            )
        self._use_kernel = physics_cuda.step_supported(self)
        self._kernel_tables = (
            physics_cuda.kernel_tables(self) if self._use_kernel else None
        )

    def _build_pair_tables(self):
        """Static narrowphase pair classification (core.py:2104-2174 done
        once instead of per substep)."""
        ents = self.entities
        pairs: Dict[str, list] = {c: [] for c in PAIR_CLASSES}
        joint_pairs = []
        for a, ea in enumerate(ents):
            for b in range(a + 1, len(ents)):
                eb = ents[b]
                constraint = self._joints.get(frozenset({ea.name, eb.name}))
                if constraint is not None:
                    joint_pairs.append(constraint)
                    # A dist-0 constraint replaces the pair's contact.
                    if constraint.dist == 0:
                        continue
                if not self._static_collides(ea, eb):
                    continue
                sa, sb = ea.shape, eb.shape
                if isinstance(sa, shp.Sphere) and isinstance(sb, shp.Sphere):
                    pairs["ss"].append((a, b))
                elif isinstance(sa, shp.Line) and isinstance(sb, shp.Sphere):
                    pairs["ls"].append((a, b))
                elif isinstance(sb, shp.Line) and isinstance(sa, shp.Sphere):
                    pairs["ls"].append((b, a))
                elif isinstance(sa, shp.Line) and isinstance(sb, shp.Line):
                    pairs["ll"].append((a, b))
                elif isinstance(sa, shp.Box) and isinstance(sb, shp.Sphere):
                    pairs["bs"].append((a, b))
                elif isinstance(sb, shp.Box) and isinstance(sa, shp.Sphere):
                    pairs["bs"].append((b, a))
                elif isinstance(sa, shp.Box) and isinstance(sb, shp.Line):
                    pairs["bl"].append((a, b))
                elif isinstance(sb, shp.Box) and isinstance(sa, shp.Line):
                    pairs["bl"].append((b, a))
                elif isinstance(sa, shp.Box) and isinstance(sb, shp.Box):
                    pairs["bb"].append((a, b))
                else:
                    raise AssertionError()
        self._pairs = {
            c: np.array(p, dtype=np.int32).reshape(-1, 2)
            for c, p in pairs.items()
        }
        self._ordered_constraints = joint_pairs

    def collides(self, a: Entity, b: Entity) -> bool:
        """Public static collidability query (reference core.py:2788-2803
        minus the per-step broadphase distance test, which is replaced by
        masked dense computation)."""
        return self._static_collides(a, b)

    def _static_collides(self, a: Entity, b: Entity) -> bool:
        if a is b:
            return False
        if (not a.collides(b)) or (not b.collides(a)):
            return False
        if not a.movable and not a.rotatable and not b.movable and not b.rotatable:
            return False
        return True

    def _build_joint_tables(self):
        """Per constraint, in pair order: entity indices, anchor offsets,
        rest distance, rotate flag and static fixed rotation (0 where it is
        None or inferred per env)."""
        cons = self._ordered_constraints
        J = len(cons)
        self._joint_ia = np.zeros((J,), dtype=np.int32)
        self._joint_ib = np.zeros((J,), dtype=np.int32)
        self._joint_delta_a = np.zeros((J, 2), dtype=np.float32)
        self._joint_delta_b = np.zeros((J, 2), dtype=np.float32)
        self._joint_dist = np.zeros((J,), dtype=np.float32)
        self._joint_rotate = np.zeros((J,), dtype=bool)
        self._joint_fixed_rot = np.zeros((J,), dtype=np.float32)
        index_map = {e.name: i for i, e in enumerate(self.entities)}
        for i, c in enumerate(cons):
            self._joint_ia[i] = index_map[c.entity_a.name]
            self._joint_ib[i] = index_map[c.entity_b.name]
            self._joint_delta_a[i] = c.entity_a.shape.get_delta_from_anchor(
                c.anchor_a
            )
            self._joint_delta_b[i] = c.entity_b.shape.get_delta_from_anchor(
                c.anchor_b
            )
            self._joint_dist[i] = c.dist
            self._joint_rotate[i] = c.rotate
            self._joint_fixed_rot[i] = float(c._fixed_rotation or 0.0)
            # Joint.notify writes this one's fixed rotation per env
            # (joints.py:139-144): route it through extras.
            if c.inferred_rotation:
                c._extras_key = f"joint_fixed_rotation.{i}"

    def _build_incidence(self):
        """[K, N] 0/1 matrices that sum the concatenated per-pair
        force/torque contributions into per-entity totals: the joint rows
        first, then each contact class."""
        order: List[int] = []
        if len(self._ordered_constraints):
            order += list(self._joint_ia) + list(self._joint_ib)
        for cls in PAIR_CLASSES:
            p = self._pairs[cls]
            if len(p):
                order += list(p[:, 0]) + list(p[:, 1])
        if not order:
            self._incidence_f = self._incidence_t = None
            return
        K, N = len(order), self._n_entities
        inc = np.zeros((K, N), dtype=np.float32)
        inc[np.arange(K), np.array(order)] = 1.0
        self._incidence_f = inc * self._movable[None, :].astype(np.float32)
        self._incidence_t = inc * self._rotatable[None, :].astype(np.float32)

    def _build_device_tables(self):
        """Every static table the step reads, once, as device tensors: the
        step itself never copies from the host."""
        dev = self._device

        def t(x, dtype=None):
            return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                                   device=dev)

        self._t = {
            name: t(getattr(self, "_" + name))
            for name in (
                "movable", "rotatable", "mass", "moment", "drag_coef",
                "lin_friction", "ang_friction", "gravity_vec", "max_speed",
                "v_range", "max_f", "f_range", "max_t", "t_range",
                "agent_movable", "agent_rotatable", "silent", "radius",
                "length", "width", "hollow", "joint_delta_a",
                "joint_delta_b", "joint_dist", "joint_rotate",
                "joint_fixed_rot",
            )
        }
        self._t["joint_ia"] = t(self._joint_ia, torch.long)
        self._t["joint_ib"] = t(self._joint_ib, torch.long)
        self._t_pairs = {
            c: t(p, torch.long) for c, p in self._pairs.items() if len(p)
        }
        if self._incidence_f is not None:
            self._t["incidence_f"] = t(self._incidence_f)
            self._t["incidence_t"] = t(self._incidence_t)

    # ------------------------------------------------------------------ #
    # State plumbing
    # ------------------------------------------------------------------ #
    @property
    def state(self) -> WorldState:
        return self._state

    def bind(self, state: WorldState, borrowed: bool = False):
        """Hold ``state``: the world writes its fields by replacing them on
        this very object.  ``borrowed``: its tensors stay the caller's, so an
        extras buffer written in place (``own_extra``) is copied first."""
        self._state = state
        self._borrowed = ({k: id(v) for k, v in state.extras.items()}
                          if borrowed else {})
        return self

    def snapshot(self) -> WorldState:
        """The state as it stands, as a new object (``WorldState.replace``)
        that later steps leave as it is: its extras become borrowed."""
        self._borrowed = {k: id(v) for k, v in self._state.extras.items()}
        return self._state.replace()

    def own_extra(self, key: str) -> Tensor:
        """The extras buffer ``key``, to be written in place: a copy, put in
        the state, where it is still the tensor of a borrowed state (the
        first write since a ``bind(..., borrowed=True)`` or ``snapshot``).
        (An id that a freed tensor left behind only costs a copy.)"""
        value = self._state.extras[key]
        if self._borrowed.get(key) == id(value):
            value = value.clone()
            self._state.extras[key] = value
            del self._borrowed[key]
        return value

    def functional(self, state: WorldState, fn: Callable,
                   generator: Optional[torch.Generator] = None):
        """``(new state, fn())`` with ``fn`` run on a ``replace()`` of
        ``state`` bound as borrowed and, where given, ``generator`` as the
        world's: the caller's state object, dict and tensors are left as
        they were.  Whatever the world held before (state, generator, the
        action widths) is restored afterwards, also when ``fn`` raises (the
        JAX package's ``Environment._functional``)."""
        held = (self._state, self._borrowed, self.generator,
                list(self._u_widths))
        self.bind(state.replace(), borrowed=True)
        if generator is not None:
            self.generator = generator
        try:
            out = fn()
            return self._state, out
        finally:
            (self._state, self._borrowed, self.generator,
             self._u_widths) = held

    def has_extra(self, key: str) -> bool:
        return key in self._state.extras

    def get_extra(self, key: str) -> Tensor:
        return self._state.extras[key]

    def set_extra(self, key: str, value: Tensor):
        self._state.extras[key] = value

    def _write_state(self, **updates):
        for k, v in updates.items():
            setattr(self._state, k, v)

    def _write_column(self, field: str, idx: int, value):
        """Set entity (or agent) ``idx`` of ``field`` in every env."""
        arr = getattr(self._state, field)
        value = torch.as_tensor(value, dtype=arr.dtype, device=arr.device)
        row = value.expand(arr[:, idx].shape)
        self._write_state(**{field: torch.select_scatter(arr, row, 1, idx)})

    def _set_action_u(self, agent_idx: int, value):
        u = self._state.u
        value = value.to(u.dtype)
        w = value.shape[1]
        if w > u.shape[2]:
            # Rare: a write wider than the preallocated capacity widens
            # the stacked storage.
            u = torch.cat([u, u.new_zeros(u.shape[:2] + (w - u.shape[2],))], 2)
        self._u_widths[agent_idx] = w
        row = torch.slice_scatter(u[:, agent_idx], value, 1, 0, w)
        self._state.u = torch.select_scatter(u, row, 1, agent_idx)

    def _masked_entity_write(self, field: str, idx: int, value, batch_index):
        """Reference ``set_pos``-style write (core.py:733-761): None index
        broadcasts/sets all envs, int or mask updates selected envs."""
        arr = getattr(self._state, field)
        row = arr[:, idx]  # [B, d]
        value = torch.as_tensor(value, dtype=arr.dtype, device=arr.device)
        if value.ndim == row.ndim and value.shape[0] == 1:
            value = value[0]
        value = value.expand(row.shape)
        if batch_index is None:
            new = value
        else:
            mask = env_index_to_mask(batch_index, self._batch_dim, arr.device)
            new = torch.where(mask[:, None], value, row)
        self._write_state(**{field: torch.select_scatter(arr, new, 1, idx)})

    def reset(self, env_index=None):
        """Zero all entity states (core.py:1179-1181) as one masked update."""
        mask = env_index_to_mask(env_index, self._batch_dim, self._device)
        m = mask[:, None, None]
        s = self._state
        self._write_state(
            **{
                f: torch.where(m, torch.zeros_like(v), v)
                for f in ("pos", "vel", "rot", "ang_vel", "force", "torque",
                          "c", "action_c", "u")
                for v in (getattr(s, f),)
            }
        )
        for agent in self._agents:
            agent.dynamics.reset(env_index)

    # ------------------------------------------------------------------ #
    # Physics step (core.py:1972-2015)
    # ------------------------------------------------------------------ #
    def step(self):
        s = self._state
        A = len(self._agents)
        t = self._t

        # Clamp agent action force/torque once (idempotent; the reference
        # re-clamps each substep, core.py:2018-2041) and write back.  The
        # clamps stay outside the kernel, as in the JAX package.
        force_a = s.force
        torque_a = s.torque
        if A:
            # All-inf clamps are static no-ops and are skipped.
            force_clamped = force_a
            if np.isfinite(self._max_f).any():
                force_clamped = TorchUtils.clamp_with_norm(
                    force_clamped, t["max_f"][None, :, None]
                )
            if np.isfinite(self._f_range).any():
                fr = t["f_range"][None, :, None]
                force_clamped = torch.minimum(torch.maximum(force_clamped, -fr), fr)
            if force_clamped is not force_a:
                am = t["agent_movable"][None, :, None]
                force_a = torch.where(am, force_clamped, force_a)

            torque_clamped = torque_a
            if np.isfinite(self._max_t).any():
                torque_clamped = TorchUtils.clamp_with_norm(
                    torque_clamped, t["max_t"][None, :, None]
                )
            if np.isfinite(self._t_range).any():
                tr = t["t_range"][None, :, None]
                torque_clamped = torch.minimum(
                    torch.maximum(torque_clamped, -tr), tr
                )
            if torque_clamped is not torque_a:
                ar = t["agent_rotatable"][None, :, None]
                torque_a = torch.where(ar, torque_clamped, torque_a)

        if self._use_kernel:
            pos, vel, rot, ang_vel = physics_cuda.fused_step(
                self, s.pos, s.vel, s.rot, s.ang_vel, force_a, torque_a,
                physics_cuda.stacked_dyn_gravity(self, s.extras),
            )
        else:
            pos, vel, rot, ang_vel = self._step_core(
                s.pos, s.vel, s.rot, s.ang_vel, force_a, torque_a, s.extras
            )

        updates = dict(pos=pos, vel=vel, rot=rot, ang_vel=ang_vel,
                       force=force_a, torque=torque_a)
        # Comm state update (core.py:2910-2913)
        if self._dim_c > 0 and A:
            silent = t["silent"][None, :, None]
            updates["c"] = torch.where(silent, s.c, s.action_c)
        self._write_state(**updates)

    def _step_core(self, pos, vel, rot, ang_vel, force_a, torque_a, extras):
        """Plain physics core: action/gravity/friction forces, pair
        narrowphase, and substepped semi-implicit Euler integration
        (core.py:1972-2010, 2860-2908).  It is the CUDA kernel's plain
        version and its backward."""
        B, N = pos.shape[0], pos.shape[1]
        nl = self._n_landmarks
        A = len(self._agents)
        t = self._t
        movable = t["movable"][None, :, None]
        rotatable = t["rotatable"][None, :, None]

        # Effective per-entity mass/moment [1|B, N, 1]: static tables, with
        # per-env overrides from extras["<name>.dyn_mass"] (shape moments
        # are linear in mass, so the override rescales the static moment).
        mass_e = t["mass"][None, :, None]
        moment_e = t["moment"][None, :, None]
        dyn_mass = [
            (i, extras[f"{e.name}.dyn_mass"])
            for i, e in enumerate(self.entities)
            if f"{e.name}.dyn_mass" in extras
        ]
        if dyn_mass:
            mass_e = mass_e.expand(B, N, 1)
            moment_e = moment_e.expand(B, N, 1)
            for i, m in dyn_mass:
                m = m.reshape(B, 1)
                mass_e = torch.select_scatter(mass_e, m, 1, i)
                moment_e = torch.select_scatter(
                    moment_e, m * float(self._moment[i] / self._mass[i]), 1, i
                )

        # Per-entity action force layout: landmarks get zeros.
        if A:
            action_force = torch.cat(
                [pos.new_zeros(B, nl, 2),
                 force_a * t["agent_movable"][None, :, None]], dim=1
            )
            action_torque = torch.cat(
                [pos.new_zeros(B, nl, 1),
                 torque_a * t["agent_rotatable"][None, :, None]], dim=1
            )
        else:
            action_force = pos.new_zeros(B, N, 2)
            action_torque = pos.new_zeros(B, N, 1)

        has_gravity = bool(np.any(self._gravity_vec != 0)) or bool(
            self._dyn_gravity_names
        )
        if has_gravity:
            gravity_force = t["gravity_vec"][None] * mass_e * movable
            for name in self._dyn_gravity_names:
                i = [e.name for e in self.entities].index(name)
                g = extras[f"{name}.dyn_gravity"] * mass_e[:, i] * float(
                    self._movable[i]
                )
                gravity_force = gravity_force.expand(B, N, 2)
                gravity_force = torch.select_scatter(
                    gravity_force, gravity_force[:, i] + g, 1, i
                )
        has_lin_friction = bool(np.any(self._lin_friction > 0))
        has_ang_friction = bool(np.any(self._ang_friction > 0))
        sub_dt = self._sub_dt
        for substep in range(self._substeps):
            forces = action_force + gravity_force if has_gravity else action_force
            torques = action_torque
            if has_lin_friction:
                forces = forces + self._friction_force(
                    vel, t["lin_friction"], mass_e
                )
            if has_ang_friction:
                torques = torques + self._friction_force(
                    ang_vel, t["ang_friction"], moment_e
                )

            pair_f, pair_t = self._environment_forces(pos, rot, extras)
            if pair_f is not None:
                forces = forces + pair_f
                torques = torques + pair_t

            # ---- integrate (core.py:2860-2908, semi-implicit Euler) ---- #
            if substep == 0:
                drag = t["drag_coef"][None, :, None]
                vel = torch.where(movable, vel * (1 - drag), vel)
                ang_vel = torch.where(rotatable, ang_vel * (1 - drag), ang_vel)
            new_vel = vel + forces / mass_e * sub_dt
            if np.isfinite(self._max_speed).any():
                new_vel = TorchUtils.clamp_with_norm(
                    new_vel, t["max_speed"][None, :, None]
                )
            if np.isfinite(self._v_range).any():
                vr = t["v_range"][None, :, None]
                new_vel = torch.minimum(torch.maximum(new_vel, -vr), vr)
            vel = torch.where(movable, new_vel, vel)
            new_pos = pos + vel * sub_dt
            if self._x_semidim is not None or self._y_semidim is not None:
                nx = new_pos[..., X]
                ny = new_pos[..., Y]
                if self._x_semidim is not None:
                    nx = torch.clamp(nx, -self._x_semidim, self._x_semidim)
                if self._y_semidim is not None:
                    ny = torch.clamp(ny, -self._y_semidim, self._y_semidim)
                new_pos = torch.stack([nx, ny], dim=-1)
            pos = torch.where(movable, new_pos, pos)

            new_ang_vel = ang_vel + torques / moment_e * sub_dt
            ang_vel = torch.where(rotatable, new_ang_vel, ang_vel)
            rot = torch.where(rotatable, rot + ang_vel * sub_dt, rot)

        return pos, vel, rot, ang_vel

    def _friction_force(self, vel: Tensor, coeff: Tensor, mass_like: Tensor):
        """Static/kinetic friction (core.py:2054-2073).  ``vel`` is
        [B,N,d]; ``coeff`` is [N]; ``mass_like`` is [1|B, N, 1]."""
        speed = TorchUtils.safe_norm(vel, dim=-1)  # [B, N]
        static = speed == 0
        friction_const = coeff[None, :, None] * mass_like
        direction = vel / torch.where(
            static, torch.full_like(speed, 1e-8), speed
        )[..., None]
        friction = -direction * torch.minimum(
            friction_const, torch.abs(vel) / self._sub_dt * mass_like
        )
        return torch.where(static[..., None], torch.zeros_like(friction), friction)

    # ------------------------------------------------------------------ #
    # Pairwise environment forces
    # ------------------------------------------------------------------ #
    def _environment_forces(self, pos: Tensor, rot: Tensor, extras):
        """All joint-constraint and collision pair forces, concatenated and
        summed per entity through the static incidence matrices."""
        if self._incidence_f is None:
            return None, None
        f_parts: List[Tensor] = []
        t_parts: List[Tensor] = []
        if len(self._ordered_constraints):
            fa, ta, fb, tb = self._joint_forces(pos, rot, extras)
            f_parts += [fa, fb]
            t_parts += [ta, tb]
        fns = {
            "ss": self._sphere_sphere,
            "ls": self._sphere_line,
            "ll": self._line_line,
            "bs": self._box_sphere,
            "bl": self._box_line,
            "bb": self._box_box,
        }
        for cls in PAIR_CLASSES:
            if cls not in self._t_pairs:
                continue
            p = self._t_pairs[cls]
            fa, ta, fb, tb = fns[cls](
                pos, rot, p[:, 0], p[:, 1], self._pairs[cls]
            )
            zeros_t = fa.new_zeros(fa.shape[:-1] + (1,))
            f_parts += [fa, fb]
            t_parts += [
                ta if ta is not None else zeros_t,
                tb if tb is not None else zeros_t,
            ]
        F = torch.cat(f_parts, dim=1)  # [B, K, 2]
        T = torch.cat(t_parts, dim=1)  # [B, K, 1]
        # Segment sum over the 0/1 incidence: an fp32 product (TF32 is
        # off for matmuls by default).
        forces = torch.einsum("bkc,kn->bnc", F, self._t["incidence_f"])
        torques = torch.einsum("bkc,kn->bnc", T, self._t["incidence_t"])
        return forces, torques

    def _constraint_forces(
        self,
        pos_a: Tensor,
        pos_b: Tensor,
        dist_min,
        force_multiplier: Optional[float] = None,
        attractive: bool = False,
    ) -> Tuple[Tensor, Tensor]:
        """Soft (differentiable) contact force (core.py:2805-2839):
        ``softplus(sign (dist_min - dist) / k) * k`` along the contact
        normal, times ``force_multiplier`` (the collision force unless
        given).  Repulsive (sign +1) it is zero outside contact, attractive
        (sign -1, joints) inside the rest distance; both are zero at
        coincident points."""
        if force_multiplier is None:
            force_multiplier = self._collision_force
        sign = -1 if attractive else 1
        delta_pos = pos_a - pos_b
        dist = TorchUtils.safe_norm(delta_pos, dim=-1)
        k = self._contact_margin
        x = (dist_min - dist) * sign / k
        penetration = torch.logaddexp(x, x.new_zeros(())) * k
        force = (
            sign
            * force_multiplier
            * delta_pos
            / torch.where(dist > 0, dist, torch.full_like(dist, 1e-8))[..., None]
            * penetration[..., None]
        )
        far = (dist < dist_min) if attractive else (dist > dist_min)
        zero = (dist < 1e-6) | far
        force = torch.where(zero[..., None], torch.zeros_like(force), force)
        return force, -force

    def _constraint_torques(
        self, rot_a: Tensor, rot_b: Tensor, force_multiplier: float
    ) -> Tuple[Tensor, Tensor]:
        """Soft fixed-rotation constraint torque (core.py:2841-2858)."""
        delta_rot = rot_a - rot_b
        abs_delta_rot = TorchUtils.safe_norm(delta_rot, dim=-1, keepdim=True)
        penetration = torch.exp(abs_delta_rot) - 1
        torque = force_multiplier * torch.sign(delta_rot) * penetration
        torque = torch.where(
            abs_delta_rot < 1e-9, torch.zeros_like(torque), torque
        )
        return -torque, torque

    def _joint_forces(self, pos, rot, extras):
        """Vectorized joint constraint solve (core.py:2201-2292): the
        attractive and the repulsive soft force between the two anchor
        points, their lever-arm torques, and the fixed-rotation torque of
        constraints that do not rotate."""
        t = self._t
        ia, ib = t["joint_ia"], t["joint_ib"]
        rot_a, rot_b = rot[:, ia], rot[:, ib]  # [B, J, 1]
        pos_a, pos_b = pos[:, ia], pos[:, ib]
        delta_a = TorchUtils.rotate_vector(
            t["joint_delta_a"][None].expand(pos_a.shape), rot_a
        )
        delta_b = TorchUtils.rotate_vector(
            t["joint_delta_b"][None].expand(pos_b.shape), rot_b
        )
        pos_joint_a = pos_a + delta_a
        pos_joint_b = pos_b + delta_b
        dist = t["joint_dist"][None]  # [1, J]

        fa_attr, fb_attr = self._constraint_forces(
            pos_joint_a, pos_joint_b, dist, self._joint_force, attractive=True
        )
        fa_rep, fb_rep = self._constraint_forces(
            pos_joint_a, pos_joint_b, dist, self._joint_force
        )
        force_a = fa_attr + fa_rep
        force_b = fb_attr + fb_rep

        torque_a_rot = TorchUtils.compute_torque(force_a, pos_joint_a - pos_a)
        torque_b_rot = TorchUtils.compute_torque(force_b, pos_joint_b - pos_b)

        # Fixed rotation [B|1, J, 1]: the static table, with the per-env
        # values that Joint.notify wrote into extras.
        B = pos.shape[0]
        joint_rot = t["joint_fixed_rot"][None, :, None]
        for i, c in enumerate(self._ordered_constraints):
            if c._extras_key in extras:
                joint_rot = torch.select_scatter(
                    joint_rot.expand(B, -1, 1),
                    extras[c._extras_key].reshape(B, 1), 1, i,
                )
        t_fixed_a, t_fixed_b = self._constraint_torques(
            rot_a, rot_b + joint_rot, self._torque_constraint_force
        )
        rotate = t["joint_rotate"][None, :, None]
        torque_a = torch.where(rotate, torque_a_rot, torque_a_rot + t_fixed_a)
        torque_b = torch.where(rotate, torque_b_rot, torque_b_rot + t_fixed_b)
        return force_a, torque_a, force_b, torque_b

    def _sphere_sphere(self, pos, rot, ia, ib, pn):
        """core.py:2294-2339"""
        radius = self._t["radius"]
        dist_min = (radius[ia] + radius[ib])[None]
        fa, fb = self._constraint_forces(pos[:, ia], pos[:, ib], dist_min)
        return fa, None, fb, None

    def _sphere_line(self, pos, rot, il, isph, pn):
        """core.py:2341-2392 (pair order: line, sphere)."""
        pos_l = pos[:, il]
        pos_s = pos[:, isph]
        closest = geo.closest_point_line(
            pos_l, rot[:, il, 0], self._t["length"][il][None], pos_s
        )
        force_sphere, force_line = self._constraint_forces(
            pos_s, closest, self._t["radius"][isph][None] + LINE_MIN_DIST
        )
        torque_line = TorchUtils.compute_torque(force_line, closest - pos_l)
        return force_line, torque_line, force_sphere, None

    def _line_line(self, pos, rot, ia, ib, pn):
        """core.py:2394-2457"""
        pa, pb = pos[:, ia], pos[:, ib]
        length = self._t["length"]
        point_a, point_b = geo.closest_points_line_line(
            pa, rot[:, ia, 0], length[ia][None],
            pb, rot[:, ib, 0], length[ib][None],
        )
        fa, fb = self._constraint_forces(point_a, point_b, LINE_MIN_DIST)
        ta = TorchUtils.compute_torque(fa, point_a - pa)
        tb = TorchUtils.compute_torque(fb, point_b - pb)
        return fa, ta, fb, tb

    def _inner_points(self, ibox, ibox_np, outside, surface, box_pos):
        """Anti-tunnelling inner point for solid boxes; hollow boxes keep
        the surface point (no extra distance)."""
        if self._hollow[ibox_np].all():
            return surface, torch.zeros_like(surface[..., 0])
        inner_h, d_h = geo.inner_point_box(outside, surface, box_pos)
        nh = ~self._t["hollow"][ibox][None, :, None]
        inner = torch.where(nh, inner_h, surface)
        d = torch.where(nh[..., 0], d_h, torch.zeros_like(d_h))
        return inner, d

    def _box_sphere(self, pos, rot, ibox, isph, pn):
        """core.py:2459-2552 (pair order: box, sphere)."""
        pos_box, pos_s = pos[:, ibox], pos[:, isph]
        closest = geo.closest_point_box(
            pos_box, rot[:, ibox, 0], self._t["width"][ibox][None],
            self._t["length"][ibox][None], pos_s,
        )
        inner_point, d = self._inner_points(ibox, pn[:, 0], pos_s, closest, pos_box)
        force_sphere, force_box = self._constraint_forces(
            pos_s, inner_point,
            self._t["radius"][isph][None] + LINE_MIN_DIST + d,
        )
        torque_box = TorchUtils.compute_torque(force_box, closest - pos_box)
        return force_box, torque_box, force_sphere, None

    def _box_line(self, pos, rot, ibox, iline, pn):
        """core.py:2554-2653 (pair order: box, line)."""
        pos_box, pos_line = pos[:, ibox], pos[:, iline]
        point_box, point_line = geo.closest_line_box(
            pos_box, rot[:, ibox, 0], self._t["width"][ibox][None],
            self._t["length"][ibox][None],
            pos_line, rot[:, iline, 0], self._t["length"][iline][None],
        )
        inner_point, d = self._inner_points(
            ibox, pn[:, 0], point_line, point_box, pos_box
        )
        force_box, force_line = self._constraint_forces(
            inner_point, point_line, LINE_MIN_DIST + d
        )
        torque_box = TorchUtils.compute_torque(force_box, point_box - pos_box)
        torque_line = TorchUtils.compute_torque(force_line, point_line - pos_line)
        return force_box, torque_box, force_line, torque_line

    def _box_box(self, pos, rot, ia, ib, pn):
        """core.py:2655-2786"""
        pa, pb = pos[:, ia], pos[:, ib]
        length, width = self._t["length"], self._t["width"]
        point_a, point_b = geo.closest_box_box(
            pa, rot[:, ia, 0], width[ia][None], length[ia][None],
            pb, rot[:, ib, 0], width[ib][None], length[ib][None],
        )
        inner_a, d_a = self._inner_points(ia, pn[:, 0], point_b, point_a, pa)
        inner_b, d_b = self._inner_points(ib, pn[:, 1], point_a, point_b, pb)
        fa, fb = self._constraint_forces(
            inner_a, inner_b, d_a + d_b + LINE_MIN_DIST
        )
        ta = TorchUtils.compute_torque(fa, point_a - pa)
        tb = TorchUtils.compute_torque(fb, point_b - pb)
        return fa, ta, fb, tb

    # ------------------------------------------------------------------ #
    # Ray casting (core.py:1628-1786)
    # ------------------------------------------------------------------ #
    def _cast_entities(self, entity_filter, origins) -> raycast_cuda.CastTable:
        """The entities that ``entity_filter`` selects, by shape class, as a
        cast table: what a ray from each of ``origins`` (entities) meets,
        each origin leaving itself out."""
        classes = {shp.Sphere: [], shp.Box: [], shp.Line: []}
        for e in self.entities:
            if not entity_filter(e):
                continue
            for origin in origins:
                assert e is origin or (e.collides(origin) and origin.collides(
                    e)), "Rays are only casted among collidables"
            if type(e.shape) not in classes:
                raise RuntimeError(
                    f"Shape {e.shape} currently not handled by cast_ray"
                )
            classes[type(e.shape)].append(e.index)
        return raycast_cuda.cast_table(
            self, classes[shp.Sphere], classes[shp.Box], classes[shp.Line]
        )

    def cast_rays(
        self,
        entity: Entity,
        angles: Tensor,
        max_range: float,
        entity_filter: Callable[[Entity], bool] = lambda _: False,
    ) -> Tensor:
        """Distances ``[B, R]`` from ``entity`` along each ray to the first
        entity that ``entity_filter`` selects, capped at ``max_range``.
        ``angles`` is ``[B, R]`` in the world frame, or ``[R]`` relative to
        ``entity``'s heading (a LIDAR's base angles).  One call is one
        launch of the ray-cast kernel on CUDA tensors (one origin)."""
        key = (entity.index, entity_filter)
        table = self._cast_tables.get(key)
        if table is None:
            table = self._cast_tables[key] = self._cast_entities(
                entity_filter, (entity,))
        s = self._state
        return raycast_cuda.fused_cast_rays(
            s.pos, s.rot, angles, entity.index, table, max_range
        )

    def measure_lidar(self, lidar) -> Tensor:
        """``lidar``'s distances ``[B, R]`` (``Lidar.measure``).  The LIDARs
        of the world's agents that share a filter, base angles and
        ``max_range`` form a group, cast in one launch from all their agents
        at the group's first measure; the other members read their slice
        until the state's ``pos`` or ``rot`` is written or grad mode
        changes (``_CastGroup``)."""
        found = self._lidar_groups.get((lidar, lidar.agent,
                                        lidar.entity_filter))
        if found is None:
            self._group_lidars(lidar)
            found = self._lidar_groups[(lidar, lidar.agent,
                                        lidar.entity_filter)]
        group, slot = found
        return group.cast(self._state)[slot]

    def drop_cast_caches(self):
        """Forget every LIDAR group's last cast, so that the next measure
        casts.  A CUDA graph's capture starts so (a captured step must cast
        each group), and a replay ends so: it rewrites the state's tensors
        without moving their versions."""
        for group, _ in self._lidar_groups.values():
            group.out = group.read = None

    def _group_lidars(self, lidar):
        """Group every LIDAR of the world's agents, and ``lidar``, by (filter,
        base angles, max_range), at most MAX_ORIGINS agents a group.  A
        group's table is every entity its filter selects and each agent
        skips itself, so a member's rays meet exactly its own table: the
        union of the members' tables without its own agent."""
        lidars = [x for a in self._agents for x in a.sensors
                  if hasattr(x, "angles_key")]
        if not any(x is lidar for x in lidars):
            lidars.append(lidar)
        by_key: Dict[tuple, list] = {}
        for x in lidars:
            by_key.setdefault(
                (x.entity_filter, x.angles_key, float(x._max_range)), []
            ).append(x)
        self._lidar_groups = {}
        for (entity_filter, _, max_range), members in by_key.items():
            agents = list({id(x.agent): x.agent for x in members}.values())
            table = self._cast_entities(entity_filter, agents)
            for start in range(0, len(agents), raycast_cuda.MAX_ORIGINS):
                chunk = agents[start:start + raycast_cuda.MAX_ORIGINS]
                slot = {id(a): i for i, a in enumerate(chunk)}
                group = _CastGroup(tuple(a.index for a in chunk),
                                   members[0]._angles, max_range, table)
                for x in members:
                    if id(x.agent) in slot:
                        self._lidar_groups[(x, x.agent, x.entity_filter)] = (
                            group, slot[id(x.agent)])

    def cast_ray(
        self,
        entity: Entity,
        angles: Tensor,
        max_range: float,
        entity_filter: Callable[[Entity], bool] = lambda _: False,
    ) -> Tensor:
        """angles [B] -> distances [B] (the single-angle API,
        core.py:1628-1660, on the vectorized cast); ``angles`` may be a
        strided view, such as one column of a LIDAR's ``[B, R]``."""
        return self.cast_rays(entity, angles[:, None].contiguous(), max_range,
                              entity_filter)[:, 0]

    # ------------------------------------------------------------------ #
    # Distance / overlap queries (core.py:1788-1969)
    # ------------------------------------------------------------------ #
    def get_distance_from_point(
        self, entity: Entity, test_point_pos: Tensor, env_index=None
    ):
        shape = entity.shape
        pos = entity.state.pos
        if isinstance(shape, shp.Sphere):
            return_value = torch.linalg.norm(pos - test_point_pos, dim=-1) - shape.radius
        elif isinstance(shape, shp.Box):
            gx, gy = geo.closest_point_box_xy(
                pos, entity.state.rot[..., 0], shape.width, shape.length,
                test_point_pos,
            )
            return_value = (
                geo.safe_norm_xy(
                    test_point_pos[..., X] - gx, test_point_pos[..., Y] - gy
                )
                - LINE_MIN_DIST
            )
        elif isinstance(shape, shp.Line):
            closest = geo.closest_point_line(
                pos, entity.state.rot[..., 0], shape.length, test_point_pos
            )
            return_value = (
                torch.linalg.norm(test_point_pos - closest, dim=-1) - LINE_MIN_DIST
            )
        else:
            raise RuntimeError("Distance not computable for given entity")
        if env_index is not None:
            return_value = return_value[env_index]
        return return_value

    def get_distance(self, entity_a: Entity, entity_b: Entity, env_index=None):
        sa, sb = entity_a.shape, entity_b.shape
        if isinstance(sa, shp.Sphere) and isinstance(sb, shp.Sphere):
            dist = self.get_distance_from_point(entity_a, entity_b.state.pos)
            return_value = dist - sb.radius
        elif {type(sa), type(sb)} == {shp.Box, shp.Sphere}:
            box, sphere = (
                (entity_a, entity_b)
                if isinstance(sb, shp.Sphere)
                else (entity_b, entity_a)
            )
            dist = self.get_distance_from_point(box, sphere.state.pos)
            return_value = dist - sphere.shape.radius
            is_overlapping = self.is_overlapping(entity_a, entity_b)
            return_value = torch.where(
                is_overlapping, torch.full_like(return_value, -1.0), return_value
            )
        elif {type(sa), type(sb)} == {shp.Line, shp.Sphere}:
            line, sphere = (
                (entity_a, entity_b)
                if isinstance(sb, shp.Sphere)
                else (entity_b, entity_a)
            )
            dist = self.get_distance_from_point(line, sphere.state.pos)
            return_value = dist - sphere.shape.radius
        elif isinstance(sa, shp.Line) and isinstance(sb, shp.Line):
            point_a, point_b = geo.closest_points_line_line(
                entity_a.state.pos, entity_a.state.rot[..., 0], sa.length,
                entity_b.state.pos, entity_b.state.rot[..., 0], sb.length,
            )
            return_value = (
                torch.linalg.norm(point_a - point_b, dim=-1) - LINE_MIN_DIST
            )
        elif {type(sa), type(sb)} == {shp.Box, shp.Line}:
            box, line = (
                (entity_a, entity_b) if isinstance(sb, shp.Line) else (entity_b, entity_a)
            )
            point_box, point_line = geo.closest_line_box(
                box.state.pos, box.state.rot[..., 0], box.shape.width,
                box.shape.length, line.state.pos, line.state.rot[..., 0],
                line.shape.length,
            )
            return_value = (
                torch.linalg.norm(point_box - point_line, dim=-1) - LINE_MIN_DIST
            )
        elif isinstance(sa, shp.Box) and isinstance(sb, shp.Box):
            point_a, point_b = geo.closest_box_box(
                entity_a.state.pos, entity_a.state.rot[..., 0], sa.width,
                sa.length, entity_b.state.pos, entity_b.state.rot[..., 0],
                sb.width, sb.length,
            )
            return_value = (
                torch.linalg.norm(point_a - point_b, dim=-1) - LINE_MIN_DIST
            )
        else:
            raise RuntimeError("Distance not computable for given entities")
        if env_index is not None:
            return_value = return_value[env_index]
        return return_value

    def is_overlapping(self, entity_a: Entity, entity_b: Entity, env_index=None):
        sa, sb = entity_a.shape, entity_b.shape
        if {type(sa), type(sb)} == {shp.Box, shp.Sphere}:
            box, sphere = (
                (entity_a, entity_b)
                if isinstance(sb, shp.Sphere)
                else (entity_b, entity_a)
            )
            sp = sphere.state.pos
            bp = box.state.pos
            gx, gy = geo.closest_point_box_xy(
                bp, box.state.rot[..., 0], box.shape.width, box.shape.length, sp
            )
            dist_sphere_closest = geo.safe_norm_xy(sp[..., X] - gx, sp[..., Y] - gy)
            dist_sphere_box = geo.safe_norm_xy(
                sp[..., X] - bp[..., X], sp[..., Y] - bp[..., Y]
            )
            dist_closest_box = geo.safe_norm_xy(bp[..., X] - gx, bp[..., Y] - gy)
            dist_min = sphere.shape.radius + LINE_MIN_DIST
            return_value = (dist_sphere_box < dist_closest_box) | (
                dist_sphere_closest < dist_min
            )
        else:
            return_value = self.get_distance(entity_a, entity_b) < 0
        if env_index is not None:
            return_value = return_value[env_index]
        return return_value
