"""A kernel's least time on the H100: the larger of its bytes over the
memory rate and its operations over the rate of their type (``peaks.json``),
each byte read or written once, counted by ``rooflines/<kernel>.py`` from
the configuration and the traffic, never from the program's own tables."""
from __future__ import annotations

from typing import Tuple

from portbench.spec import BENCH_DIR, load_json

RATES = {"fp32": "fp32_flop_per_s", "bf16": "bf16_flop_per_s"}


def least_seconds(count: dict) -> Tuple[float, str]:
    """``count``: ``{"bytes": b, "ops": {"fp32": n, "bf16": m}}``; returns
    (seconds, "bytes" | "operations")."""
    peaks = load_json(BENCH_DIR, "peaks.json")
    t_bytes = count["bytes"] / peaks["hbm_bytes_per_s"]
    t_ops = sum(n / peaks[RATES[kind]] for kind, n in count["ops"].items())
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_least_seconds(cell, kernel: str) -> Tuple[float, str]:
    """The least time of one launch of ``rooflines/<kernel>.py``'s kernel
    in ``cell``."""
    return least_seconds(cell.module("rooflines", kernel).count(
        cell.config, cell.traffic))
