"""Scenario registry and loader.

Scenarios are importable modules registered in :data:`_REGISTRY`;
``load(name)`` returns the module (exposing ``.Scenario``).  The registry
holds the scenarios ported so far; the rest of the JAX package's library
is ROADMAP Queue 1 item 7.
"""
from __future__ import annotations

import importlib

_REGISTRY = {
    "balance": "vectorizedmultiagentsimulator_tpu_torch.scenarios.balance",
    "dispersion": "vectorizedmultiagentsimulator_tpu_torch.scenarios.dispersion",
    "flocking": "vectorizedmultiagentsimulator_tpu_torch.scenarios.flocking",
    "football": "vectorizedmultiagentsimulator_tpu_torch.scenarios.football",
    "kinematic_bicycle": (
        "vectorizedmultiagentsimulator_tpu_torch.scenarios.debug"
        ".kinematic_bicycle"
    ),
    "navigation": "vectorizedmultiagentsimulator_tpu_torch.scenarios.navigation",
    "road_traffic": (
        "vectorizedmultiagentsimulator_tpu_torch.scenarios.road_traffic"
    ),
    "transport": "vectorizedmultiagentsimulator_tpu_torch.scenarios.transport",
    "simple_speaker_listener": (
        "vectorizedmultiagentsimulator_tpu_torch.scenarios.mpe"
        ".simple_speaker_listener"
    ),
    "simple_spread": (
        "vectorizedmultiagentsimulator_tpu_torch.scenarios.mpe.simple_spread"
    ),
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
