"""PID velocity controller (reference
``vmas/simulator/controllers/velocity_controller.py``).

PyTorch counterpart of the JAX package's ``controllers/
velocity_controller.py``.  Turns velocity targets found in
``agent.action.u`` into forces.  Its integrator and derivative state
(``accum_errs``/``prev_err``) lives in ``state.extras`` under
``"<agent>.pid_accum_errs"`` and ``"<agent>.pid_prev_err"``, the JAX
package's keys, created by the first ``reset``.
"""
from __future__ import annotations

import math
import warnings
from typing import Optional

import torch

from vectorizedmultiagentsimulator_tpu_torch.utils import TorchUtils

Tensor = torch.Tensor


class VelocityController:
    def __init__(
        self,
        agent,
        world,
        ctrl_params=(1, 0, 0),
        pid_form: str = "standard",
    ):
        self.agent = agent
        self.world = world
        self.dt = world.dt
        self.ctrl_gain = ctrl_params[0]
        if pid_form == "standard":
            self.integralTs = ctrl_params[1]
            self.derivativeTs = ctrl_params[2]
        elif pid_form == "parallel":
            if ctrl_params[1] == 0:
                self.integralTs = 0.0
            else:
                self.integralTs = self.ctrl_gain / ctrl_params[1]
            self.derivativeTs = ctrl_params[2] / self.ctrl_gain
        else:
            raise Exception("PID form is either standard or parallel.")

        if self.integralTs == 0:
            self.use_integrator = False
        else:
            self.use_integrator = True
            fmax = min(
                self.agent.max_f,
                self.agent.f_range,
                key=lambda x: x if x is not None else math.inf,
            )
            if fmax is not None:
                self.integrator_windup_cutoff = (
                    0.5 * fmax * self.integralTs / (self.dt * self.ctrl_gain)
                )
            else:
                self.integrator_windup_cutoff = None
                warnings.warn(
                    "Force limits not specified. Integrator can wind up!"
                )

    # ------------------------------------------------------------------ #
    # Stateful buffers in extras
    # ------------------------------------------------------------------ #
    @property
    def _key_accum(self) -> str:
        return f"{self.agent.name}.pid_accum_errs"

    @property
    def _key_prev(self) -> str:
        return f"{self.agent.name}.pid_prev_err"

    def _get(self, key: str) -> Tensor:
        if not self.world.has_extra(key):
            self.world.set_extra(
                key,
                torch.zeros(
                    (self.world.batch_dim, self.world.dim_p),
                    device=self.world.device,
                ),
            )
        return self.world.get_extra(key)

    @property
    def accum_errs(self) -> Tensor:
        return self._get(self._key_accum)

    @accum_errs.setter
    def accum_errs(self, value: Tensor):
        self.world.set_extra(self._key_accum, value)

    @property
    def prev_err(self) -> Tensor:
        return self._get(self._key_prev)

    @prev_err.setter
    def prev_err(self, value: Tensor):
        self.world.set_extra(self._key_prev, value)

    def reset(self, index: Optional[int] = None):
        """Zero the PID state of the envs ``index`` names (None: all; an
        int, int tensor or ``[B]`` bool mask)."""
        self.accum_errs = TorchUtils.where_from_index(index, 0.0, self.accum_errs)
        self.prev_err = TorchUtils.where_from_index(index, 0.0, self.prev_err)

    def integralError(self, err: Tensor):
        if not self.use_integrator:
            return 0
        accum = self.accum_errs + self.dt * err
        if self.integrator_windup_cutoff is not None:
            accum = torch.clamp(
                accum,
                -self.integrator_windup_cutoff,
                self.integrator_windup_cutoff,
            )
        self.accum_errs = accum
        return (1.0 / self.integralTs) * accum

    def rateError(self, err: Tensor):
        e = self.derivativeTs * (err - self.prev_err) / self.dt
        self.prev_err = err
        return e

    def process_force(self):
        des_vel = self.agent.action.u
        cur_vel = self.agent.state.vel
        err = des_vel - cur_vel
        u = self.ctrl_gain * (err + self.integralError(err) + self.rateError(err))
        u = u * self.agent.mass
        self.agent.action.u = u
