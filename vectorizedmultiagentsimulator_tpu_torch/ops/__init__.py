"""The port's kernels (``*_cuda.py``, each beside its plain version) and
plain tensor math.  ``launch_counts`` / ``set_launch_counts`` read and
write every wrapper's ``LAUNCHES`` as one dict keyed by kernel."""
from typing import Dict

from vectorizedmultiagentsimulator_tpu_torch.ops import (  # noqa: F401
    cuda_build,
    football_policy_cuda,
    geometry,
    physics_cuda,
    ppo_update_cuda,
    raycast,
    raycast_cuda,
    road_geometry,
    road_geometry_cuda,
)

# Kernel name -> the module whose LAUNCHES (an int) counts it; the road
# kernels are counted in road_geometry_cuda.LAUNCHES, a dict by kernel.
_COUNTERS = {
    "physics_step": physics_cuda,
    "raycast": raycast_cuda,
    "football_policy": football_policy_cuda,
    "ppo_update": ppo_update_cuda,
}


def launch_counts() -> Dict[str, int]:
    """Every kernel's launch count: physics_step, raycast, football_policy,
    ppo_update and road_geometry_cuda.KERNELS."""
    counts = {k: m.LAUNCHES for k, m in _COUNTERS.items()}
    counts.update(road_geometry_cuda.LAUNCHES)
    return counts


def set_launch_counts(counts: Dict[str, int]):
    """Set the counts of the kernels named in ``counts``."""
    for k, n in counts.items():
        if k in _COUNTERS:
            _COUNTERS[k].LAUNCHES = n
        else:
            road_geometry_cuda.LAUNCHES[k] = n

