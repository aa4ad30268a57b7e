"""Environment front end.  The gym/gymnasium/rllib wrappers are not
ported yet (ROADMAP Queue 1, wrappers and edges)."""
from vectorizedmultiagentsimulator_tpu_torch.environment.environment import Environment

__all__ = ["Environment"]
