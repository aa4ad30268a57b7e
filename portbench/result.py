"""What one run of a cell hands back to ``run.py``: its end-to-end
numbers, what a traced run recorded for the layer readers, the numbers
its comparison with the reference gave beside their limits, and the
device's peak memory."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from portbench.spec import Cell
from portbench.trace import Trace


@dataclass
class Check:
    """One number of the comparison with the reference and its limit: the
    run is correct where the number is finite and at most the limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


@dataclass
class RunResult:
    cell: Cell
    metrics: dict = field(default_factory=dict)
    checks: List[Check] = field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    # a traced run's: the trace, the kernel nodes of one captured graph
    # and the env steps that graph runs
    trace: Optional[Trace] = None
    graph_nodes: List[str] = field(default_factory=list)
    graph_steps: int = 0
    # numbers a run prints beside its checks, for the record
    extra: dict = field(default_factory=dict)
