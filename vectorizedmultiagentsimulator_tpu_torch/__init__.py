"""vectorizedmultiagentsimulator_tpu_torch — the PyTorch/CUDA port of
``vectorizedmultiagentsimulator_tpu``.

Same entry point, public names and module layout as the JAX package:
``make_env(name, num_envs, device=..., seed=...)`` builds a batch of
worlds on a PyTorch device; the physics step runs as a hand-written CUDA
kernel on the GPU (``ops/physics_cuda.py``) and as plain PyTorch on the
CPU.  This package never imports JAX.
"""
from vectorizedmultiagentsimulator_tpu_torch.environment import Wrapper
from vectorizedmultiagentsimulator_tpu_torch.make_env import make_env
from vectorizedmultiagentsimulator_tpu_torch.scenarios import _REGISTRY

__version__ = "0.1.0"

__all__ = [
    "make_env",
    "render_interactively",
    "scenarios",
    "debug_scenarios",
    "mpe_scenarios",
    "Wrapper",
]


def _names_in(kind):
    return sorted(name for name, module in _REGISTRY.items()
                  if module.split(".")[-2] == kind)


scenarios = _names_in("scenarios")
"""List of the main scenarios (excluding MPE and debug)."""

debug_scenarios = _names_in("debug")
"""List of the debug scenarios."""

mpe_scenarios = _names_in("mpe")
"""List of the MPE scenarios."""


def render_interactively(*args, **kwargs):
    from vectorizedmultiagentsimulator_tpu_torch.interactive import (
        render_interactively as _ri,
    )

    return _ri(*args, **kwargs)
