"""``entry.step_host_ms``: host ms from the call of ``Environment.step``
to its return (no synchronize), as the trainer's rollout calls it eagerly,
from a wrapper the benchmark puts on the env instance in the traced run's
iterations."""


def read(run):
    return run.trace.span_ms("env.step") if run.trace else None
