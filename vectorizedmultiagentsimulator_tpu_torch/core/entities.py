"""Entity / Agent / Landmark construction and view objects.

Same object API as the JAX package (reference
``vmas/simulator/core.py:538-1086``).  Entities hold no tensors: all state
lives in the world's :class:`WorldState`.  Reading ``agent.state.pos``
slices it; writing ``agent.set_pos(...)`` replaces the field with an
updated tensor.

Scenario buffers (the reference lets scenarios attach arbitrary tensors to
entities, e.g. ``package.on_goal``) go through an attribute trap that
stores batch-leading tensors in ``state.extras`` under
``"{entity.name}.{attr}"`` — the JAX package's keys, so states carry
across.
"""
from __future__ import annotations

import typing
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch

from vectorizedmultiagentsimulator_tpu_torch.core.shapes import Shape, Sphere
from vectorizedmultiagentsimulator_tpu_torch.utils import Color, Observable

if typing.TYPE_CHECKING:
    from vectorizedmultiagentsimulator_tpu_torch.core.world import World

Tensor = torch.Tensor


def _is_batched_array(value, batch_dim) -> bool:
    return (
        isinstance(value, Tensor)
        and value.ndim >= 1
        and value.shape[0] == batch_dim
    )


class EntityStateView:
    """View over the entity slice of the world state (reference
    ``EntityState``): ``pos/vel [B,2]``, ``rot/ang_vel [B,1]``."""

    __slots__ = ("_entity",)

    def __init__(self, entity: "Entity"):
        self._entity = entity

    @property
    def _world(self) -> "World":
        return self._entity._world

    @property
    def pos(self) -> Tensor:
        return self._world.state.pos[:, self._entity.index]

    @pos.setter
    def pos(self, value: Tensor):
        self._world._write_column("pos", self._entity.index, value)

    @property
    def vel(self) -> Tensor:
        return self._world.state.vel[:, self._entity.index]

    @vel.setter
    def vel(self, value: Tensor):
        self._world._write_column("vel", self._entity.index, value)

    @property
    def rot(self) -> Tensor:
        return self._world.state.rot[:, self._entity.index]

    @rot.setter
    def rot(self, value: Tensor):
        self._world._write_column("rot", self._entity.index, value)

    @property
    def ang_vel(self) -> Tensor:
        return self._world.state.ang_vel[:, self._entity.index]

    @ang_vel.setter
    def ang_vel(self, value: Tensor):
        self._world._write_column("ang_vel", self._entity.index, value)


class AgentStateView(EntityStateView):
    """Adds comm utterance and action force/torque (core.py:319-410)."""

    @property
    def c(self) -> Optional[Tensor]:
        if self._world.dim_c == 0 or self._entity.silent:
            return None
        return self._world.state.c[:, self._entity.agent_index]

    @c.setter
    def c(self, value: Tensor):
        self._world._write_column("c", self._entity.agent_index, value)

    @property
    def force(self) -> Tensor:
        return self._world.state.force[:, self._entity.agent_index]

    @force.setter
    def force(self, value: Tensor):
        self._world._write_column("force", self._entity.agent_index, value)

    @property
    def torque(self) -> Tensor:
        return self._world.state.torque[:, self._entity.agent_index]

    @torque.setter
    def torque(self, value: Tensor):
        self._world._write_column("torque", self._entity.agent_index, value)


class Action:
    """Per-agent action container/view (reference core.py:414-534).

    The ``*_tensor`` properties are device tensors built once at world
    finalize, so the step never copies from the host."""

    def __init__(
        self,
        u_range: Union[float, Sequence[float]],
        u_multiplier: Union[float, Sequence[float]],
        u_noise: Union[float, Sequence[float]],
        action_size: int,
    ):
        self._u_range = u_range
        self._u_multiplier = u_multiplier
        self._u_noise = u_noise
        self.action_size = action_size
        self._agent: Optional["Agent"] = None
        self._tensors = None
        for attr in (u_multiplier, u_range, u_noise):
            if isinstance(attr, (list, tuple)):
                assert len(attr) == action_size, (
                    "Action attributes u_... must be either a float or a list of"
                    " floats (one per action) all with same length"
                )

    @property
    def _world(self) -> "World":
        return self._agent._world

    def _finalize(self, device):
        self._tensors = {
            name: torch.as_tensor(self._to_array(v), device=device)
            for name, v in (
                ("u_range", self._u_range),
                ("u_multiplier", self._u_multiplier),
                ("u_noise", self._u_noise),
            )
        }

    @property
    def u(self) -> Tensor:
        idx = self._agent.agent_index
        return self._world.state.u[:, idx, : self._world._u_widths[idx]]

    @u.setter
    def u(self, value: Tensor):
        self._world._set_action_u(self._agent.agent_index, value)

    @property
    def c(self) -> Optional[Tensor]:
        if self._world.dim_c == 0 or self._agent.silent:
            return None
        return self._world.state.action_c[:, self._agent.agent_index]

    @c.setter
    def c(self, value: Tensor):
        self._world._write_column("action_c", self._agent.agent_index, value)

    @property
    def u_range(self):
        return self._u_range

    @property
    def u_multiplier(self):
        return self._u_multiplier

    @property
    def u_noise(self):
        return self._u_noise

    def _to_array(self, value) -> np.ndarray:
        if isinstance(value, (list, tuple)):
            return np.asarray(value, dtype=np.float32)
        return np.full((self.action_size,), value, dtype=np.float32)

    @property
    def u_range_tensor(self) -> Tensor:
        return self._tensors["u_range"]

    @property
    def u_multiplier_tensor(self) -> Tensor:
        return self._tensors["u_multiplier"]

    @property
    def u_noise_tensor(self) -> Tensor:
        return self._tensors["u_noise"]


class Entity(Observable):
    """World object view (reference core.py:538-786).  Joints subscribe to
    an entity's pose writes (``set_pos`` and the other setters)."""

    def __init__(
        self,
        name: str,
        movable: bool = False,
        rotatable: bool = False,
        collide: bool = True,
        density: float = 25.0,  # kept for API parity; unused like the reference
        mass: float = 1.0,
        shape: Shape = None,
        v_range: Optional[float] = None,
        max_speed: Optional[float] = None,
        color=Color.GRAY,
        is_joint: bool = False,
        drag: Optional[float] = None,
        linear_friction: Optional[float] = None,
        angular_friction: Optional[float] = None,
        gravity=None,
        collision_filter: Callable[["Entity"], bool] = lambda _: True,
    ):
        Observable.__init__(self)
        if shape is None:
            shape = Sphere()
        self._name = name
        self._movable = movable
        self._rotatable = rotatable
        self._collide = collide
        self._density = density
        self._mass = mass
        self._shape = shape
        self._v_range = v_range
        self._max_speed = max_speed
        self._color = color
        self._is_joint = is_joint
        self._drag = drag
        self._linear_friction = linear_friction
        self._angular_friction = angular_friction
        self._gravity = (
            np.asarray(gravity, dtype=np.float32) if gravity is not None else None
        )
        self._collision_filter = collision_filter
        self._goal: Optional["Entity"] = None
        self._world: Optional["World"] = None
        self.index: Optional[int] = None  # entity index into stacked arrays
        self._state_view = EntityStateView(self)

    # ------------------------------------------------------------------ #
    # Dynamic scenario buffers -> state.extras
    # ------------------------------------------------------------------ #
    def _extras_key(self, name: str) -> str:
        return f"{self._name}.{name}"

    def __setattr__(self, name: str, value):
        if (
            not name.startswith("_")
            and name != "index"
            and not isinstance(getattr(type(self), name, None), property)
            and self.__dict__.get("_world") is not None
            and self._world.is_finalized
            and _is_batched_array(value, self._world.batch_dim)
        ):
            self._world.set_extra(self._extras_key(name), value)
        else:
            object.__setattr__(self, name, value)

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        world = self.__dict__.get("_world")
        if world is not None and world.is_finalized:
            key = f"{self.__dict__['_name']}.{name}"
            if world.has_extra(key):
                return world.get_extra(key)
        raise AttributeError(
            f"'{type(self).__name__}' object has no attribute '{name}'"
        )

    # ------------------------------------------------------------------ #
    @property
    def name(self) -> str:
        return self._name

    @property
    def batch_dim(self) -> int:
        return self._world.batch_dim

    @property
    def state(self) -> EntityStateView:
        return self._state_view

    @property
    def movable(self):
        return self._movable

    @property
    def rotatable(self):
        return self._rotatable

    @property
    def collide(self):
        return self._collide

    @property
    def shape(self) -> Shape:
        return self._shape

    @property
    def is_joint(self):
        return self._is_joint

    @property
    def mass(self):
        world = self.__dict__.get("_world")
        if world is not None and world.is_finalized:
            key = self._extras_key("dyn_mass")
            if world.has_extra(key):
                return world.get_extra(key)
        return self._mass

    @mass.setter
    def mass(self, mass):
        world = self.__dict__.get("_world")
        if (
            world is not None
            and world.is_finalized
            and _is_batched_array(mass, world.batch_dim)
        ):
            # Runtime per-env mass override, stored as [B,1] in extras.
            # Physics uses it for gravity/friction forces, acceleration and
            # (shape-linearly) the moment of inertia; worlds that carry one
            # step through the plain path (physics_cuda.step_supported).
            world.set_extra(
                self._extras_key("dyn_mass"),
                mass.to(torch.float32).reshape(world.batch_dim, 1),
            )
            return
        self._mass = mass

    @property
    def moment_of_inertia(self):
        return self.shape.moment_of_inertia(self.mass)

    @property
    def max_speed(self):
        return self._max_speed

    @property
    def v_range(self):
        return self._v_range

    @property
    def color(self):
        if isinstance(self._color, Color):
            return self._color.value
        return self._color

    @color.setter
    def color(self, color):
        self._color = color

    @property
    def goal(self):
        return self._goal

    @goal.setter
    def goal(self, goal: "Entity"):
        self._goal = goal

    @property
    def drag(self):
        return self._drag

    @property
    def linear_friction(self):
        return self._linear_friction

    @linear_friction.setter
    def linear_friction(self, value):
        self._linear_friction = value

    @property
    def angular_friction(self):
        return self._angular_friction

    @property
    def gravity(self):
        world = self.__dict__.get("_world")
        if world is not None and world.is_finalized:
            key = self._extras_key("dyn_gravity")
            if world.has_extra(key):
                return world.get_extra(key)
        return self._gravity

    @gravity.setter
    def gravity(self, value):
        world = self.__dict__.get("_world")
        if (
            world is not None
            and world.is_finalized
            and _is_batched_array(value, world.batch_dim)
        ):
            # Runtime per-env gravity override (wind fields), [B, 2].
            world.set_extra(self._extras_key("dyn_gravity"), value)
            return
        self._gravity = (
            np.asarray(value, dtype=np.float32) if value is not None else None
        )

    @property
    def collision_filter(self):
        return self._collision_filter

    @collision_filter.setter
    def collision_filter(self, collision_filter: Callable[["Entity"], bool]):
        self._collision_filter = collision_filter

    def collides(self, entity: "Entity") -> bool:
        if not self._collide:
            return False
        return self._collision_filter(entity)

    # ------------------------------------------------------------------ #
    # State writes (reference core.py:733-761)
    # ------------------------------------------------------------------ #
    def set_pos(self, pos, batch_index=None):
        self._world._masked_entity_write("pos", self.index, pos, batch_index)
        self.notify_observers()

    def set_vel(self, vel, batch_index=None):
        self._world._masked_entity_write("vel", self.index, vel, batch_index)
        self.notify_observers()

    def set_rot(self, rot, batch_index=None):
        self._world._masked_entity_write("rot", self.index, rot, batch_index)
        self.notify_observers()

    def set_ang_vel(self, ang_vel, batch_index=None):
        self._world._masked_entity_write("ang_vel", self.index, ang_vel, batch_index)
        self.notify_observers()


class Landmark(Entity):
    """Reference core.py:789-826."""

    def __init__(
        self,
        name: str,
        shape: Shape = None,
        movable: bool = False,
        rotatable: bool = False,
        collide: bool = True,
        density: float = 25.0,
        mass: float = 1.0,
        v_range: Optional[float] = None,
        max_speed: Optional[float] = None,
        color=Color.GRAY,
        is_joint: bool = False,
        drag: Optional[float] = None,
        linear_friction: Optional[float] = None,
        angular_friction: Optional[float] = None,
        gravity: Optional[float] = None,
        collision_filter: Callable[[Entity], bool] = lambda _: True,
    ):
        super().__init__(
            name,
            movable,
            rotatable,
            collide,
            density,
            mass,
            shape,
            v_range,
            max_speed,
            color,
            is_joint,
            drag,
            linear_friction,
            angular_friction,
            gravity,
            collision_filter,
        )


class Agent(Entity):
    """Reference core.py:830-1086."""

    def __init__(
        self,
        name: str,
        shape: Shape = None,
        movable: bool = True,
        rotatable: bool = True,
        collide: bool = True,
        density: float = 25.0,
        mass: float = 1.0,
        f_range: Optional[float] = None,
        max_f: Optional[float] = None,
        t_range: Optional[float] = None,
        max_t: Optional[float] = None,
        v_range: Optional[float] = None,
        max_speed: Optional[float] = None,
        color=Color.BLUE,
        alpha: float = 0.5,
        obs_range: Optional[float] = None,
        obs_noise: Optional[float] = None,
        u_noise: Union[float, Sequence[float]] = 0.0,
        u_range: Union[float, Sequence[float]] = 1.0,
        u_multiplier: Union[float, Sequence[float]] = 1.0,
        action_script: Optional[Callable] = None,
        sensors: Optional[List] = None,
        c_noise: float = 0.0,
        silent: bool = True,
        adversary: bool = False,
        drag: Optional[float] = None,
        linear_friction: Optional[float] = None,
        angular_friction: Optional[float] = None,
        gravity: Optional[float] = None,
        collision_filter: Callable[[Entity], bool] = lambda _: True,
        render_action: bool = False,
        dynamics=None,
        action_size: Optional[int] = None,
        discrete_action_nvec: Optional[List[int]] = None,
    ):
        super().__init__(
            name,
            movable,
            rotatable,
            collide,
            density,
            mass,
            shape,
            v_range,
            max_speed,
            color,
            is_joint=False,
            drag=drag,
            linear_friction=linear_friction,
            angular_friction=angular_friction,
            gravity=gravity,
            collision_filter=collision_filter,
        )
        if obs_range == 0.0:
            assert sensors is None, f"Blind agent cannot have sensors, got {sensors}"
        if action_size is not None and discrete_action_nvec is not None:
            if action_size != len(discrete_action_nvec):
                raise ValueError(
                    f"action_size {action_size} is inconsistent with"
                    f" discrete_action_nvec {discrete_action_nvec}"
                )
        if discrete_action_nvec is not None:
            if not all(n > 1 for n in discrete_action_nvec):
                raise ValueError(
                    "All values in discrete_action_nvec must be greater than 1,"
                    f" got {discrete_action_nvec}"
                )

        self._obs_range = obs_range
        self._obs_noise = obs_noise
        self._f_range = f_range
        self._max_f = max_f
        self._t_range = t_range
        self._max_t = max_t
        self._action_script = action_script
        self._sensors = []
        if sensors is not None:
            for sensor in sensors:
                self.add_sensor(sensor)
        self._c_noise = c_noise
        self._silent = silent
        self._render_action = render_action
        self._adversary = adversary
        self._alpha = alpha

        if dynamics is None:
            from vectorizedmultiagentsimulator_tpu_torch.dynamics import Holonomic

            dynamics = Holonomic()
        self._dynamics = dynamics
        if action_size is not None:
            self.action_size = action_size
        elif discrete_action_nvec is not None:
            self.action_size = len(discrete_action_nvec)
        else:
            self.action_size = self._dynamics.needed_action_size
        if discrete_action_nvec is None:
            self.discrete_action_nvec = [3] * self.action_size
        else:
            self.discrete_action_nvec = list(discrete_action_nvec)
        self._dynamics.agent = self
        self._action = Action(
            u_range=u_range,
            u_multiplier=u_multiplier,
            u_noise=u_noise,
            action_size=self.action_size,
        )
        self._action._agent = self
        self._state_view = AgentStateView(self)
        self.agent_index: Optional[int] = None  # index among world agents

    def add_sensor(self, sensor):
        sensor.agent = self
        self._sensors.append(sensor)

    @property
    def dynamics(self):
        return self._dynamics

    @property
    def action_script(self):
        return self._action_script

    def action_callback(self, world: "World"):
        self._action_script(self, world)
        assert (
            self._action.u is not None
        ), f"Action script of {self.name} should set u action"
        assert self._action.u.shape[1] == self.action_size, (
            f"Scripted action of agent {self.name} has wrong shape"
        )

    @property
    def u_range(self):
        return self._action.u_range

    @property
    def obs_noise(self):
        return self._obs_noise if self._obs_noise is not None else 0

    @property
    def action(self) -> Action:
        return self._action

    @property
    def u_multiplier(self):
        return self._action.u_multiplier

    @property
    def max_f(self):
        return self._max_f

    @property
    def f_range(self):
        return self._f_range

    @property
    def max_t(self):
        return self._max_t

    @property
    def t_range(self):
        return self._t_range

    @property
    def silent(self):
        return self._silent

    @property
    def sensors(self) -> List:
        return self._sensors

    @property
    def u_noise(self):
        return self._action.u_noise

    @property
    def c_noise(self):
        return self._c_noise

    @property
    def adversary(self):
        return self._adversary
