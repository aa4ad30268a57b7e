"""``train.update_ms``: ms an iteration of ``Trainer.update`` (every
epoch's minibatch updates), the benchmark's span from the call to the
synchronize after it, in the traced run's iterations."""


def read(run):
    return run.trace.span_ms("update") if run.trace else None
