from vectorizedmultiagentsimulator_tpu_torch.models.heuristic_policy import (
    BaseHeuristicPolicy,
)

__all__ = ["BaseHeuristicPolicy"]
