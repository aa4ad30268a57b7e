"""What a traced run reads from the card: a ``torch.profiler`` trace of a
stretch of the run (device kernels by name, busy time, idle gaps and what
the host was doing in them), the kernel nodes of a captured CUDA graph,
and the names of the port's own kernels (the ``__global__`` functions of
its ``csrc/*.cu`` sources).  Copied from the port's ``chip_smoke.py``
(phases 5-6) and ``tests/torch_helpers.py`` (``kept_graphs``,
``graph_kernels``), not imported.
"""
from __future__ import annotations

import contextlib
import ctypes
import glob
import os
import re
import tempfile
import time
from bisect import bisect_right
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, List, Tuple

from portbench.spec import ROOT

PORT_CSRC = os.path.join(ROOT, "vectorizedmultiagentsimulator_tpu_torch",
                         "csrc")


def port_kernel_names() -> set:
    """The ``__global__`` functions of the port's CUDA sources."""
    names = set()
    for path in glob.glob(os.path.join(PORT_CSRC, "*.cu")):
        with open(path) as f:
            src = f.read()
        names.update(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?"
            r"(\w+)\s*\(", src))
    return names


@dataclass
class Trace:
    """Device activity of a traced stretch: ``kernels`` as (name, start
    us, end us), memory copies and sets apart in ``copies``; ``host`` the
    host's operations (name, start us, end us); ``wall_s`` the stretch's
    length on the host clock; ``spans`` the benchmark's own spans (name ->
    seconds each); ``steps`` the env steps it ran."""
    kernels: List[Tuple[str, float, float]] = field(default_factory=list)
    copies: List[Tuple[str, float, float]] = field(default_factory=list)
    host: List[Tuple[str, float, float]] = field(default_factory=list)
    wall_s: float = 0.0
    steps: int = 0
    spans: dict = field(default_factory=dict)

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device (the union of
        their intervals)."""
        total, end = 0.0, None
        for _, s, e in sorted(self.kernels + self.copies, key=lambda k: k[1]):
            if end is None or s > end:
                total += e - s
                end = e
            elif e > end:
                total += e - end
                end = e
        return total / 1e6

    def idle_share(self):
        """1 - busy time over the stretch's wall time; ``None`` where
        nothing ran on the device."""
        if self.wall_s <= 0 or not (self.kernels or self.copies):
            return None
        return 1.0 - self.busy_s() / self.wall_s

    def span_ms(self, name: str):
        """The mean of the benchmark's span ``name`` in ms, if it has one."""
        spans = self.spans.get(name)
        return 1e3 * sum(spans) / len(spans) if spans else None

    def device_s(self, match: Callable[[str], bool]) -> Tuple[float, int]:
        """Seconds and count of the kernels whose name ``match``es."""
        hit = [e - s for n, s, e in self.kernels if match(n)]
        return sum(hit) / 1e6, len(hit)

    def top_ops(self, k: int = 10):
        """The ``k`` device operations that took the most time:
        [[name, seconds], ...]."""
        by = defaultdict(float)
        for n, s, e in self.kernels + self.copies:
            by[n[:160]] += (e - s) / 1e6
        return [[n, t] for n, t in sorted(by.items(), key=lambda x: -x[1])[:k]]

    def idle_gaps(self, k: int = 10):
        """The device's idle gaps summed by what the host was doing when
        each began (its innermost operation then), the ``k`` longest:
        [[name, seconds], ...]."""
        ivals = sorted((s, e) for _, s, e in self.kernels + self.copies)
        gaps, end = [], None
        for s, e in ivals:
            if end is not None and s > end:
                gaps.append((end, s))
            end = e if end is None else max(end, e)
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        by = defaultdict(float)
        for g0, g1 in gaps:
            name = "(none)"
            i = bisect_right(starts, g0) - 1
            for h in host[max(i - 2000, -1) + 1:i + 1][::-1]:
                if h[2] > g0:  # the latest to start of those running
                    name = h[0]
                    break
            by[name[:160]] += (g1 - g0) / 1e6
        return [[n, t] for n, t in sorted(by.items(), key=lambda x: -x[1])[:k]]


def profile(step: Callable[[], object], n: int, warmup: int = 0,
            host_ops: bool = True) -> Trace:
    """Run ``step`` ``warmup + n`` times under torch.profiler and keep the
    last ``n`` (the profiler's own first costs fall in the warm-up, which
    ends in a synchronize); the stretch's wall time runs from there to a
    synchronize after the last step.  The host's operations are recorded too
    where ``host_ops`` (a cost of a few microseconds each on the host: an
    eager loop of many small ones slows down under it)."""
    import torch
    from torch.profiler import ProfilerActivity, schedule
    from torch.profiler import profile as torch_profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU]
                                      if host_ops else [])
    kept = []
    torch.cuda.synchronize()
    with torch_profile(activities=acts, schedule=schedule(
            wait=0, warmup=warmup, active=n, repeat=1),
            on_trace_ready=lambda p: kept.extend(p.events())) as prof:
        for _ in range(warmup):
            step()
            torch.cuda.synchronize()  # its device work ends before the mark
            prof.step()
        t0 = time.perf_counter()
        for i in range(n):
            step()
            if i == n - 1:  # the trace ends at this mark: let it hold all
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            prof.step()
    out = Trace(wall_s=wall)
    for e in kept:
        item = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.name.startswith("ProfilerStep"):
            continue  # the schedule's own marks, also on the device's line
        if e.device_type == torch.autograd.DeviceType.CUDA:
            copy = e.name.startswith(("Memcpy", "Memset"))
            (out.copies if copy else out.kernels).append(item)
        else:
            out.host.append(item)
    return out


@contextlib.contextmanager
def kept_graphs(made_here: list):
    """CUDA graphs made inside keep their captured graph beside the
    instantiated one (``keep_graph=True``), so that ``graph_kernel_nodes``
    can read them, and are appended to ``made_here``; graphs made after
    are as usual."""
    import torch

    made = torch.cuda.CUDAGraph

    class Kept(made):
        def __new__(cls, keep_graph=False):
            return super().__new__(cls, True)

        def __init__(self, keep_graph=False):
            super().__init__(True)
            made_here.append(self)

    torch.cuda.CUDAGraph = Kept
    try:
        yield
    finally:
        torch.cuda.CUDAGraph = made


def graph_kernel_nodes(graph) -> List[str]:
    """The kernel nodes of ``graph`` (a ``torch.cuda.CUDAGraph`` made under
    ``kept_graphs``), each as the text of its node in the graph's DOT dump
    (the driver's ``cuGraphDebugDotPrint``, else ``debug_dump``).  A
    replay launches each node once, so this counts what a replay runs
    exactly, where a profiler trace now and then drops a kernel."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "graph.dot")
        verbose = 1  # CU_GRAPH_DEBUG_DOT_FLAGS_VERBOSE
        rc = ctypes.CDLL("libcuda.so.1").cuGraphDebugDotPrint(
            ctypes.c_void_p(graph.raw_cuda_graph()), path.encode(),
            ctypes.c_uint(verbose))
        if rc or not os.path.exists(path):
            graph.debug_dump(path)
        with open(path) as f:
            dot = f.read()
    nodes = re.split(r'^\s*"?graph_\d+_node_\d+"?\s*\[', dot, flags=re.M)[1:]
    if not nodes:
        raise RuntimeError(f"no node in the graph's DOT dump: {dot[:400]!r}")
    return [n for n in nodes if "KERNEL" in n]
