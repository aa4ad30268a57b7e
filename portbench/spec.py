"""The benchmark's files, found by name.

``BENCHMARK.json`` at the checkout's root names the cells; each cell's
configuration is ``configs/<config>.json`` (its plain reference
``reference/<config>.py``), its traffic ``traffic/<traffic>.json`` (run by
the code of its ``kind``, ``kinds/<kind>.py``), its correctness limits
``limits/<workload>.json``; each per-layer metric is read by
``layers/<metric>.py`` and each kernel's roofline counted by
``rooflines/<kernel>.py``.  A new cell, configuration, mix or metric is
new files and new entries: nothing here lists them.
"""
from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field
from typing import Optional

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
_loaded = {}


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(kind: str, name: str, bench_dir: str = BENCH_DIR):
    """The module ``<kind>/<name>.py`` of the benchmark's folder, loaded
    by path once (a metric's name holds dots)."""
    path = os.path.join(bench_dir, kind, name + ".py")
    if path not in _loaded:
        if not os.path.exists(path):
            raise FileNotFoundError(f"no {kind} module {name!r} ({path})")
        spec = importlib.util.spec_from_file_location(
            f"portbench_{kind}_{name.replace('.', '_')}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _loaded[path] = module
    return _loaded[path]


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)
    bench_dir: str = BENCH_DIR

    def module(self, kind: str, name: str):
        return load_module(kind, name, self.bench_dir)

    @property
    def reference(self):
        """The configuration's plain reference module."""
        return self.module("reference", self.config["name"])


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, benchmark: Optional[dict] = None,
              bench_dir: str = BENCH_DIR) -> Cell:
    bench = benchmark if benchmark is not None else load_json(
        os.path.dirname(bench_dir), "BENCHMARK.json")
    entries = [w for w in bench["workloads"] if w["name"] == workload]
    if not entries:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = entries[0]
    return Cell(
        name=workload, chips=w["chips"],
        config=load_json(bench_dir, "configs", w["config"] + ".json"),
        traffic=load_json(bench_dir, "traffic", w["traffic"] + ".json"),
        limits=load_json(bench_dir, "limits", workload + ".json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)],
        bench_dir=bench_dir,
    )
