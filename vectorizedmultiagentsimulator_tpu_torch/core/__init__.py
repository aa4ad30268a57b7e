from vectorizedmultiagentsimulator_tpu_torch.core.shapes import Box, Line, Shape, Sphere
from vectorizedmultiagentsimulator_tpu_torch.core.state import WorldState
from vectorizedmultiagentsimulator_tpu_torch.core.entities import (
    Action,
    Agent,
    Entity,
    Landmark,
)
from vectorizedmultiagentsimulator_tpu_torch.core.joints import Joint, JointConstraint
from vectorizedmultiagentsimulator_tpu_torch.core.world import World

__all__ = [
    "Shape",
    "Box",
    "Sphere",
    "Line",
    "WorldState",
    "Entity",
    "Agent",
    "Landmark",
    "Action",
    "Joint",
    "JointConstraint",
    "World",
]
