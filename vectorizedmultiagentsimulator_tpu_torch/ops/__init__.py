from vectorizedmultiagentsimulator_tpu_torch.ops import (  # noqa: F401
    cuda_build,
    geometry,
    physics_cuda,
    raycast,
    raycast_cuda,
    road_geometry,
    road_geometry_cuda,
)
