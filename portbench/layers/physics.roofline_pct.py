"""``physics.roofline_pct``: the physics kernel's least time
(``rooflines/physics_step.py``) over its device time a launch in the
traced stretch, in percent.  Nothing where the trace holds no launch."""
from portbench.roofline import kernel_least_seconds

ROOFLINE = "physics_step"


def read(run):
    if run.trace is None:
        return None
    name = run.cell.module("rooflines", ROOFLINE).KERNEL
    seconds, launches = run.trace.device_s(lambda n: name in n)
    if not launches or seconds <= 0:
        return None
    least, _ = kernel_least_seconds(run.cell, ROOFLINE)
    return 100.0 * least / (seconds / launches)
