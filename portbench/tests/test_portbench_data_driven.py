"""A configuration, a traffic mix, a cell and a per-layer metric added as
new files and new entries are found by name, and run, with no existing
file of the benchmark edited."""
import hashlib
import json
import os
import shutil

from portbench import run as R
from portbench.spec import BENCH_DIR, load_cell, load_json
from portbench.tests.helpers import TINY, run_cpu

FOLDERS = ("configs", "traffic", "limits", "layers", "rooflines",
           "reference", "kinds")


def digests(root):
    out = {}
    for folder in FOLDERS:
        for name in sorted(os.listdir(os.path.join(root, folder))):
            path = os.path.join(root, folder, name)
            if os.path.isfile(path):
                with open(path, "rb") as f:
                    out[(folder, name)] = hashlib.sha256(f.read()).hexdigest()
    return out


def test_new_files_are_found_by_name(tmp_path):
    bench_dir = tmp_path / "portbench"
    for folder in FOLDERS:
        shutil.copytree(os.path.join(BENCH_DIR, folder), bench_dir / folder,
                        ignore=shutil.ignore_patterns("__pycache__"))
    before = digests(bench_dir)
    # a configuration: transport under another name, with its reference
    cfg = load_json(BENCH_DIR, "configs", "transport.json")
    cfg["name"] = "transport_copy"
    (bench_dir / "configs" / "transport_copy.json").write_text(
        json.dumps(cfg))
    (bench_dir / "reference" / "transport_copy.py").write_text(
        "from portbench.reference.transport import *  # noqa: F401,F403\n"
        "from portbench.reference.transport import initial_state, observe,"
        " step  # noqa: F401\n")
    # a traffic mix, a cell's limits, a per-layer metric
    traffic = dict(load_json(BENCH_DIR, "traffic", "rollout.json"),
                   **TINY["rollout"])
    traffic["steps_per_call"] = 4
    (bench_dir / "traffic" / "rollout_short.json").write_text(
        json.dumps(traffic))
    (bench_dir / "limits" / "transport_copy.rollout_short.json").write_text(
        json.dumps(load_json(BENCH_DIR, "limits", "transport.rollout.json")))
    (bench_dir / "layers" / "test.calls.py").write_text(
        "def read(run):\n    return float(run.attempted)\n")
    bench = load_json(os.path.dirname(BENCH_DIR), "BENCHMARK.json")
    bench["workloads"].append({
        "name": "transport_copy.rollout_short", "config": "transport_copy",
        "traffic": "rollout_short", "chips": 1, "why": "a test"})
    bench["per_layer"].append({
        "name": "test.calls", "unit": "calls", "better": "higher",
        "source": "host_clock", "layer": "Rollout", "moves":
        "env_steps_per_s", "workloads": ["transport_copy.rollout_short"]})
    for m in bench["end_to_end"]:
        if "transport.rollout" in m.get("workloads", []):
            m["workloads"].append("transport_copy.rollout_short")
    cell = load_cell("transport_copy.rollout_short", bench, str(bench_dir))
    assert cell.config["name"] == "transport_copy"
    assert cell.traffic["steps_per_call"] == 4
    res, line = run_cpu(cell)
    assert line["correct"], line["check"]
    traced = R.report(res, True, "cpu", 1)
    assert traced["metrics"]["test.calls"]["value"] == res.attempted
    after = digests(bench_dir)
    assert {k: v for k, v in after.items() if k in before} == before
