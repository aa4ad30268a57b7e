from vectorizedmultiagentsimulator_tpu_torch.parallel.rollout import rollout

__all__ = ["rollout"]
