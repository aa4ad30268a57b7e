"""``step.other_device_ms``: device ms a step, in the traced stretch, of
every kernel that is none of the port's own (the ``__global__`` functions
of its ``csrc/*.cu``): the library kernels of scenario, dynamics,
environment and policy code."""
from portbench.trace import port_kernel_names


def read(run):
    if run.trace is None or not run.trace.steps:
        return None
    own = port_kernel_names()
    seconds, n = run.trace.device_s(
        lambda name: not any(k in name for k in own))
    if not n:
        return None
    return 1e3 * seconds / run.trace.steps
