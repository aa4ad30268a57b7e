"""Rules for tier-1 (``pytest tests/ -m 'not slow'``): no test of the port
leaves it, and no test waits without a limit.  They read the test sources
with ``ast`` and time nothing:

* the ``slow`` marker is registered (``conftest.py``);
* ``slow`` marks only JAX-package-only cases: no module that imports the
  port, directly or through another module of ``tests/``, carries one;
* every wait on a child process has a limit of its own: each
  ``subprocess.run`` (``call``, ``check_call``, ``check_output``),
  ``.communicate`` and ``.wait`` call passes ``timeout=``, and each
  ``run_workers`` call a finite number of seconds.
"""
import ast
import math
import os

import pytest

TESTS = os.path.dirname(os.path.abspath(__file__))
PORT = "vectorizedmultiagentsimulator_tpu_torch"
SUBPROCESS_WAITS = {"run", "call", "check_call", "check_output"}


def _sources():
    return {f[:-3]: os.path.join(TESTS, f) for f in sorted(os.listdir(TESTS))
            if f.endswith(".py")}


def _trees():
    out = {}
    for name, path in _sources().items():
        with open(path) as f:
            out[name] = ast.parse(f.read(), path)
    return out


def _imported(tree):
    """Top-level names of every module the source imports."""
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


def port_modules(trees):
    """The modules of ``tests/`` that import the port, directly or through
    another module of ``tests/``."""
    imports = {name: _imported(tree) for name, tree in trees.items()}
    found = {name for name, names in imports.items() if PORT in names}
    grew = True
    while grew:
        more = {name for name, names in imports.items()
                if name not in found and names & found}
        found |= more
        grew = bool(more)
    return found


def _slow_marks(tree):
    return [node.lineno for node in ast.walk(tree)
            if isinstance(node, ast.Attribute) and node.attr == "slow"
            and isinstance(node.value, ast.Attribute)
            and node.value.attr == "mark"]


def _module_constants(tree):
    consts = {}
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Constant)):
            consts[node.targets[0].id] = node.value.value
    return consts


def _finite_seconds(node, consts):
    value = node.value if isinstance(node, ast.Constant) else (
        consts.get(node.id) if isinstance(node, ast.Name) else None)
    return (isinstance(value, (int, float)) and not isinstance(value, bool)
            and math.isfinite(value) and value > 0)


def unbounded_waits(tree):
    """``(line, call)`` of every wait on a child process without a limit."""
    consts = _module_constants(tree)
    found = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        keywords = {k.arg: k.value for k in node.keywords}
        if isinstance(func, ast.Attribute):
            is_subprocess = (isinstance(func.value, ast.Name)
                             and func.value.id == "subprocess"
                             and func.attr in SUBPROCESS_WAITS)
            if (is_subprocess or func.attr in ("communicate", "wait")) and \
                    "timeout" not in keywords:
                found.append((node.lineno, ast.unparse(func)))
        name = func.id if isinstance(func, ast.Name) else getattr(
            func, "attr", None)
        if name == "run_workers":
            limit = keywords.get("timeout_s", (
                node.args[1] if len(node.args) > 1 else None))
            if limit is None or not _finite_seconds(limit, consts):
                found.append((node.lineno, "run_workers"))
    return found


def test_slow_marker_is_registered(pytestconfig):
    assert any(line.split(":")[0].strip() == "slow"
               for line in pytestconfig.getini("markers"))


def test_port_modules_are_found():
    """The import walk sees a port module that reaches the port only through
    another test module, and leaves a JAX-only module out."""
    found = port_modules(_trees())
    assert {"torch_helpers", "torch_dp_worker",
            "test_torch_wrappers_parity"} <= found
    assert not {"test_pallas", "test_grad", "test_suite_policy"} & found


def test_port_modules_carry_no_slow_mark():
    trees = _trees()
    marked = {name: _slow_marks(trees[name])
              for name in sorted(port_modules(trees))}
    assert not {k: v for k, v in marked.items() if v}, (
        "a module that imports the port marks a test slow (file: lines)")


def test_every_wait_on_a_child_process_is_bounded():
    bad = {name: unbounded_waits(tree) for name, tree in _trees().items()}
    assert not {k: v for k, v in bad.items() if v}, (
        "waits without timeout= or a finite run_workers limit")


@pytest.mark.parametrize("source,bad", [
    ("subprocess.run(['c++'], check=True)\n", True),
    ("subprocess.run(['c++'], check=True, timeout=60)\n", False),
    ("p.communicate()\n", True),
    ("p.wait(timeout=5)\n", False),
    ("run_workers(cmds, float('inf'))\n", True),
    ("T = 60\nrun_workers(cmds, T)\n", False),
], ids=["run", "run-timeout", "communicate", "wait-timeout",
        "run_workers-inf", "run_workers-constant"])
def test_the_wait_rule_reads_calls(source, bad):
    assert bool(unbounded_waits(ast.parse(source))) is bad
