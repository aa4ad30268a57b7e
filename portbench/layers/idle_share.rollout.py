"""``idle_share.rollout``: 1 - the device's busy time (the union of its operations
in the profiler's trace) over the traced stretch's wall time."""


def read(run):
    return run.trace.idle_share() if run.trace else None
