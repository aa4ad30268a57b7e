"""Environment front end.  The gym/gymnasium/rllib wrappers are not
ported yet (ROADMAP Queue 1 item 10)."""
from vectorizedmultiagentsimulator_tpu_torch.environment.environment import Environment

__all__ = ["Environment"]
