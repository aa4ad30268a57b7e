"""Environment front end and wrapper dispatch (reference
``vmas/simulator/environment/__init__.py:10-34``), as in the JAX
package."""
from enum import Enum

from vectorizedmultiagentsimulator_tpu_torch.environment.environment import Environment


class Wrapper(Enum):
    RLLIB = 0
    GYM = 1
    GYMNASIUM = 2
    GYMNASIUM_VEC = 3

    def get_env(self, env: Environment, **kwargs):
        if self is self.RLLIB:
            from vectorizedmultiagentsimulator_tpu_torch.environment.wrappers.rllib import (
                VectorEnvWrapper,
            )

            return VectorEnvWrapper(env, **kwargs)
        elif self is self.GYM:
            from vectorizedmultiagentsimulator_tpu_torch.environment.wrappers.gym import (
                GymWrapper,
            )

            return GymWrapper(env, **kwargs)
        elif self is self.GYMNASIUM:
            from vectorizedmultiagentsimulator_tpu_torch.environment.wrappers.gymnasium import (
                GymnasiumWrapper,
            )

            return GymnasiumWrapper(env, **kwargs)
        elif self is self.GYMNASIUM_VEC:
            from vectorizedmultiagentsimulator_tpu_torch.environment.wrappers.gymnasium_vec import (
                GymnasiumVectorizedWrapper,
            )

            return GymnasiumVectorizedWrapper(env, **kwargs)


__all__ = ["Environment", "Wrapper"]
