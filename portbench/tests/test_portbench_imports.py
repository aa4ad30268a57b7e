"""No module the benchmark runs loads JAX or the JAX package (top-level
names compared whole: the port's own name begins with the JAX
package's), and the plain references load nothing of the port."""
import ast
import glob
import json
import os
import subprocess
import sys

from portbench.run import FORBIDDEN
from portbench.spec import BENCH_DIR, ROOT

PORT = "vectorizedmultiagentsimulator_tpu_torch"

LOAD_ALL = """
import json, sys
from portbench import run, calibrate, common, policy, roofline, trace
from portbench.spec import load_cell
bench = json.load(open("BENCHMARK.json"))
for w in bench["workloads"]:
    cell = load_cell(w["name"])
    cell.module("kinds", cell.traffic["kind"])
    cell.reference
    for m in cell.per_layer:
        cell.module("layers", m["name"])
import glob, os
for f in glob.glob("portbench/rooflines/*.py"):
    cell.module("rooflines", os.path.basename(f)[:-3])
import vectorizedmultiagentsimulator_tpu_torch
import vectorizedmultiagentsimulator_tpu_torch.examples.torch_ppo
import vectorizedmultiagentsimulator_tpu_torch.parallel.rollout
print(json.dumps(sorted(m for m in sys.modules)))
"""


def loaded(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=300)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_benchmark_loads_no_jax():
    mods = loaded(LOAD_ALL)
    assert PORT in mods
    assert [m for m in mods if m.split(".")[0] in FORBIDDEN] == []


def test_references_load_nothing_of_the_port():
    code = ("import json, sys, glob, os, importlib\n"
            "for f in sorted(glob.glob('portbench/reference/*.py')):\n"
            "    importlib.import_module('portbench.reference.'"
            " + os.path.basename(f)[:-3])\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    mods = loaded(code)
    bad = {PORT, *FORBIDDEN}
    assert [m for m in mods if m.split(".")[0] in bad] == []


def test_reference_sources_import_nothing_of_the_port():
    for path in glob.glob(os.path.join(BENCH_DIR, "reference", "*.py")):
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in {PORT, *FORBIDDEN}, (
                    path, name)
