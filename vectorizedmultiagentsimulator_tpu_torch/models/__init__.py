from vectorizedmultiagentsimulator_tpu_torch.models.heuristic_policy import (
    BaseHeuristicPolicy,
    RandomPolicy,
)

__all__ = ["BaseHeuristicPolicy", "RandomPolicy"]
