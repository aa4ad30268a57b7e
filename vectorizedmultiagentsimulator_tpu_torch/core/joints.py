"""Joints (reference ``vmas/simulator/joints.py``).

PyTorch counterpart of ``vectorizedmultiagentsimulator_tpu/core/joints.py``.
A ``Joint`` with ``dist == 0`` is a single :class:`JointConstraint`; with
``dist > 0`` it makes its own landmark (a Line, or a Box when it has a
width) and two zero-distance constraints at the landmark's ends, and it
observes its entities' pose writes to keep the landmark posed between the
two anchors (joints.py:86-144).

The constraint solver lives in the world's physics step (``world.py``);
at finalize the constraints become static tables.  A constraint's
``fixed_rotation`` may be inferred per env when the landmark is posed
(joints.py:139-144); it then lives in ``state.extras`` under
``joint_fixed_rotation.{i}``, and the world steps through the plain
version (``ops/physics_cuda.step_supported``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

import vectorizedmultiagentsimulator_tpu_torch.core.entities as entities_mod
import vectorizedmultiagentsimulator_tpu_torch.core.shapes as shapes_mod
from vectorizedmultiagentsimulator_tpu_torch.utils import (
    Color,
    TorchUtils,
    X,
    Y,
)


class Joint:
    def __init__(
        self,
        entity_a,
        entity_b,
        anchor_a: Tuple[float, float] = (0.0, 0.0),
        anchor_b: Tuple[float, float] = (0.0, 0.0),
        rotate_a: bool = True,
        rotate_b: bool = True,
        dist: float = 0.0,
        collidable: bool = False,
        width: float = 0.0,
        mass: float = 1.0,
        fixed_rotation_a: Optional[float] = None,
        fixed_rotation_b: Optional[float] = None,
    ):
        assert entity_a is not entity_b, "Cannot join same entity"
        for anchor in (anchor_a, anchor_b):
            assert (
                max(anchor) <= 1 and min(anchor) >= -1
            ), f"Joint anchor points should be between -1 and 1, got {anchor}"
        assert dist >= 0, f"Joint dist must be >= 0, got {dist}"
        if dist == 0:
            assert not collidable, "Cannot have collidable joint with dist 0"
            assert width == 0, "Cannot have width for joint with dist 0"
            assert fixed_rotation_a == fixed_rotation_b, (
                "If dist is 0, fixed_rotation_a and fixed_rotation_b should be"
                " the same"
            )
        if fixed_rotation_a is not None:
            assert not rotate_a, (
                "If you provide a fixed rotation for a, rotate_a should be False"
            )
        if fixed_rotation_b is not None:
            assert not rotate_b, (
                "If you provide a fixed rotation for b, rotate_b should be False"
            )
        if width > 0:
            assert collidable

        self.entity_a = entity_a
        self.entity_b = entity_b
        self.rotate_a = rotate_a
        self.rotate_b = rotate_b
        self.fixed_rotation_a = fixed_rotation_a
        self.fixed_rotation_b = fixed_rotation_b
        self.landmark = None
        self.joint_constraints = []

        if dist == 0:
            self.joint_constraints.append(
                JointConstraint(
                    entity_a,
                    entity_b,
                    anchor_a=anchor_a,
                    anchor_b=anchor_b,
                    dist=dist,
                    rotate=rotate_a and rotate_b,
                    fixed_rotation=fixed_rotation_a,  # or b, same
                ),
            )
        else:
            entity_a.subscribe(self)
            entity_b.subscribe(self)
            self.landmark = entities_mod.Landmark(
                name=f"joint {entity_a.name} {entity_b.name}",
                collide=collidable,
                movable=True,
                rotatable=True,
                mass=mass,
                shape=(
                    shapes_mod.Box(length=dist, width=width)
                    if width != 0
                    else shapes_mod.Line(length=dist)
                ),
                color=Color.BLACK,
                is_joint=True,
            )
            self.joint_constraints += [
                JointConstraint(
                    self.landmark,
                    entity_a,
                    anchor_a=(-1, 0),
                    anchor_b=anchor_a,
                    dist=0.0,
                    rotate=rotate_a,
                    fixed_rotation=fixed_rotation_a,
                ),
                JointConstraint(
                    self.landmark,
                    entity_b,
                    anchor_a=(1, 0),
                    anchor_b=anchor_b,
                    dist=0.0,
                    rotate=rotate_b,
                    fixed_rotation=fixed_rotation_b,
                ),
            ]
            # Constraints whose fixed rotation notify() infers per env: the
            # world keeps them on the plain path.
            for c, rotate, fixed in (
                (self.joint_constraints[0], rotate_a, fixed_rotation_a),
                (self.joint_constraints[1], rotate_b, fixed_rotation_b),
            ):
                c.inferred_rotation = not rotate and fixed is None

    def notify(self, observable, *args, **kwargs):
        """Re-pose the joint landmark between the two anchor points when an
        endpoint entity is moved (joints.py:121-144).  Device tensors only:
        nothing is read on the host."""
        pos_a = self.joint_constraints[0].pos_point(self.entity_a)
        pos_b = self.joint_constraints[1].pos_point(self.entity_b)

        self.landmark.set_pos((pos_a + pos_b) / 2, batch_index=None)
        angle = torch.atan2(
            pos_b[:, Y] - pos_a[:, Y],
            pos_b[:, X] - pos_a[:, X],
        )[..., None]
        self.landmark.set_rot(angle, batch_index=None)

        if not self.rotate_a and self.fixed_rotation_a is None:
            self.joint_constraints[0].fixed_rotation = (
                angle - self.entity_a.state.rot
            )
        if not self.rotate_b and self.fixed_rotation_b is None:
            self.joint_constraints[1].fixed_rotation = (
                angle - self.entity_b.state.rot
            )


class JointConstraint:
    """Anchors two entities at a distance (reference joints.py:148-242).

    ``fixed_rotation`` is a Python float (static) or, for a constraint
    whose ``Joint`` infers it (``inferred_rotation``), a ``[B, 1]`` tensor
    kept in ``state.extras`` under the key the world assigns at finalize
    (``_extras_key``).
    """

    def __init__(
        self,
        entity_a,
        entity_b,
        anchor_a: Tuple[float, float] = (0.0, 0.0),
        anchor_b: Tuple[float, float] = (0.0, 0.0),
        dist: float = 0.0,
        rotate: bool = True,
        fixed_rotation: Optional[float] = None,
    ):
        assert entity_a is not entity_b, "Cannot join same entity"
        for anchor in (anchor_a, anchor_b):
            assert (
                max(anchor) <= 1 and min(anchor) >= -1
            ), f"Joint anchor points should be between -1 and 1, got {anchor}"
        assert dist >= 0, f"Joint dist must be >= 0, got {dist}"
        if fixed_rotation is not None:
            assert not rotate, "If fixed rotation is provided, rotate should be False"
        if rotate:
            assert fixed_rotation is None, (
                "If you provide a fixed rotation, rotate should be False"
            )
            fixed_rotation = 0.0

        self.entity_a = entity_a
        self.entity_b = entity_b
        self.anchor_a = anchor_a
        self.anchor_b = anchor_b
        self.dist = dist
        self.rotate = rotate
        # Set by Joint for a constraint whose fixed rotation its notify()
        # writes per env.
        self.inferred_rotation = False
        # Set by the World at finalize where inferred_rotation is; the
        # per-env fixed rotation is stored in state.extras under this key.
        self._extras_key: Optional[str] = None
        self._fixed_rotation = fixed_rotation
        self._deltas = {}

    @property
    def fixed_rotation(self):
        if self._extras_key is not None:
            world = self.entity_a._world
            if world is not None and world.has_extra(self._extras_key):
                return world.get_extra(self._extras_key)
        return self._fixed_rotation

    @fixed_rotation.setter
    def fixed_rotation(self, value):
        world = self.entity_a._world
        if world is None or not world.is_finalized:
            self._fixed_rotation = value
        elif self._extras_key is not None and isinstance(value, torch.Tensor):
            world.set_extra(self._extras_key, value)
        else:
            # The world's tables (and the kernel's route) took the static
            # value at finalize.
            raise ValueError(
                "a joint constraint's fixed rotation is fixed once the world"
                " is finalized; only a Joint end whose rotation it infers"
                " (rotate False, no fixed rotation given) takes a per-env"
                " tensor"
            )

    def get_delta_anchor(self, entity):
        if entity is self.entity_a:
            anchor = self.anchor_a
        elif entity is self.entity_b:
            anchor = self.anchor_b
        else:
            raise AssertionError()
        pos = entity.state.pos
        # Made once per entity, so a reset copies nothing from the host.
        delta = self._deltas.get(entity.name)
        if delta is None:
            delta = torch.tensor(
                entity.shape.get_delta_from_anchor(anchor), dtype=torch.float32,
                device=pos.device,
            )
            self._deltas[entity.name] = delta
        return TorchUtils.rotate_vector(delta.expand(pos.shape), entity.state.rot)

    def pos_point(self, entity):
        return entity.state.pos + self.get_delta_anchor(entity)

    def render(self, env_index: int = 0) -> list:
        from vectorizedmultiagentsimulator_tpu_torch.render import joint_geoms

        return joint_geoms(self, env_index)
