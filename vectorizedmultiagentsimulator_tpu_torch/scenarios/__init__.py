"""Scenario registry and loader.

Scenarios are importable modules registered in :data:`_REGISTRY`;
``load(name)`` returns the module (exposing ``.Scenario``).  The registry
holds the JAX package's 41 scenario names: 21 main scenarios, 11 debug
ones and 9 from MPE.
"""
from __future__ import annotations

import importlib

_PACKAGE = "vectorizedmultiagentsimulator_tpu_torch.scenarios"
_REGISTRY = {
    "asym_joint": f"{_PACKAGE}.debug.asym_joint",
    "balance": f"{_PACKAGE}.balance",
    "ball_passage": f"{_PACKAGE}.ball_passage",
    "ball_trajectory": f"{_PACKAGE}.ball_trajectory",
    "buzz_wire": f"{_PACKAGE}.buzz_wire",
    "circle_trajectory": f"{_PACKAGE}.debug.circle_trajectory",
    "diff_drive": f"{_PACKAGE}.debug.diff_drive",
    "discovery": f"{_PACKAGE}.discovery",
    "dispersion": f"{_PACKAGE}.dispersion",
    "drone": f"{_PACKAGE}.debug.drone",
    "dropout": f"{_PACKAGE}.dropout",
    "flocking": f"{_PACKAGE}.flocking",
    "football": f"{_PACKAGE}.football",
    "give_way": f"{_PACKAGE}.give_way",
    "goal": f"{_PACKAGE}.debug.goal",
    "het_mass": f"{_PACKAGE}.debug.het_mass",
    "joint_passage": f"{_PACKAGE}.joint_passage",
    "joint_passage_size": f"{_PACKAGE}.joint_passage_size",
    "kinematic_bicycle": f"{_PACKAGE}.debug.kinematic_bicycle",
    "line_trajectory": f"{_PACKAGE}.debug.line_trajectory",
    "multi_give_way": f"{_PACKAGE}.multi_give_way",
    "navigation": f"{_PACKAGE}.navigation",
    "passage": f"{_PACKAGE}.passage",
    "pollock": f"{_PACKAGE}.debug.pollock",
    "reverse_transport": f"{_PACKAGE}.reverse_transport",
    "road_traffic": f"{_PACKAGE}.road_traffic",
    "sampling": f"{_PACKAGE}.sampling",
    "simple": f"{_PACKAGE}.mpe.simple",
    "simple_adversary": f"{_PACKAGE}.mpe.simple_adversary",
    "simple_crypto": f"{_PACKAGE}.mpe.simple_crypto",
    "simple_push": f"{_PACKAGE}.mpe.simple_push",
    "simple_reference": f"{_PACKAGE}.mpe.simple_reference",
    "simple_speaker_listener": f"{_PACKAGE}.mpe.simple_speaker_listener",
    "simple_spread": f"{_PACKAGE}.mpe.simple_spread",
    "simple_tag": f"{_PACKAGE}.mpe.simple_tag",
    "simple_world_comm": f"{_PACKAGE}.mpe.simple_world_comm",
    "transport": f"{_PACKAGE}.transport",
    "vel_control": f"{_PACKAGE}.debug.vel_control",
    "waterfall": f"{_PACKAGE}.debug.waterfall",
    "wheel": f"{_PACKAGE}.wheel",
    "wind_flocking": f"{_PACKAGE}.wind_flocking",
}


def names():
    return sorted(_REGISTRY)


def load(name: str):
    """Load a scenario module by name (``.py`` suffix tolerated, like the
    reference loader)."""
    if name.endswith(".py"):
        name = name[: -len(".py")]
    name = name.split("/")[-1]
    if name not in _REGISTRY:
        raise AssertionError(f"{name} scenario not found.")
    return importlib.import_module(_REGISTRY[name])
