"""vectorizedmultiagentsimulator_tpu_torch — the PyTorch/CUDA port of
``vectorizedmultiagentsimulator_tpu``.

Same entry point and module layout as the JAX package:
``make_env(name, num_envs, device=..., seed=...)`` builds a batch of
worlds on a PyTorch device; the physics step runs as a hand-written CUDA
kernel on the GPU (``ops/physics_cuda.py``) and as plain PyTorch on the
CPU.  This package never imports JAX.
"""
from vectorizedmultiagentsimulator_tpu_torch.make_env import make_env
from vectorizedmultiagentsimulator_tpu_torch.scenarios import names as _names

__version__ = "0.1.0"

__all__ = ["make_env", "scenarios"]

scenarios = _names()
"""The scenarios ported so far."""
