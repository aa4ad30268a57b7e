"""``ppo.roofline_pct``: the PPO update's least time a minibatch
(``rooflines/ppo_update.py``) over the device time of its kernels a
launch in the traced stretch, in percent."""
from portbench.roofline import kernel_least_seconds

ROOFLINE = "ppo_update"


def read(run):
    if run.trace is None:
        return None
    roof = run.cell.module("rooflines", ROOFLINE)
    seconds, _ = run.trace.device_s(
        lambda n: any(k in n for k in roof.KERNELS))
    _, launches = run.trace.device_s(lambda n: roof.LAUNCH in n)
    if not launches or seconds <= 0:
        return None
    least, _ = kernel_least_seconds(run.cell, ROOFLINE)
    return 100.0 * least / (seconds / launches)
