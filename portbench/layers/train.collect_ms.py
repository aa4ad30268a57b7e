"""``train.collect_ms``: ms an iteration of ``Trainer.collect`` (the
rollout with masked resets, GAE and packing), the benchmark's span from
the call to the synchronize after it, in the traced run's iterations."""


def read(run):
    return run.trace.span_ms("collect") if run.trace else None
