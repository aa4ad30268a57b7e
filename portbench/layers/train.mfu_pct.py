"""``train.mfu_pct``: the policy's model FLOPs an iteration
(``rooflines/ppo_model.py``) over the traced iterations' mean time
(collect and update spans) times the card's bf16 peak, in percent."""
from portbench.roofline import kernel_least_seconds


def read(run):
    if run.trace is None or run.trace.span_ms("collect") is None:
        return None
    ms = run.trace.span_ms("collect") + run.trace.span_ms("update")
    least, _ = kernel_least_seconds(run.cell, "ppo_model")
    return 100.0 * least / (ms / 1e3)
