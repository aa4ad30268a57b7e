from vectorizedmultiagentsimulator_tpu_torch.ops import geometry, physics_cuda  # noqa: F401
