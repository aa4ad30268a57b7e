"""The harness end to end at a tiny size on the CPU, through the port's
plain path, against the reference; and the result line's shape."""
import json

import pytest

from portbench import run as R
from portbench.result import Check, RunResult
from portbench.spec import ROOT, load_json
from portbench.tests.helpers import run_cpu, tiny_cell
from portbench.trace import Trace

WORKLOADS = [w["name"] for w in load_json(ROOT, "BENCHMARK.json")["workloads"]]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_runs_correct_on_cpu(workload):
    cell = tiny_cell(workload)
    res, line = run_cpu(cell)
    assert line["correct"], line["check"]
    assert list(line)[-1] == "check"
    assert set(line["check"]) == set(cell.limits)
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert line["attempted"] >= 1 and line["failed"] == 0
    json.dumps(line)


def test_trace_line_reads_per_layer_metrics():
    cell = tiny_cell("transport.rollout")
    trace = Trace(kernels=[("physics_step_kernel", 0.0, 20.0),
                           ("elementwise_kernel", 25.0, 30.0)],
                  copies=[("Memcpy DtoD (Device -> Device)", 30.0, 31.0)],
                  host=[("cudaGraphLaunch", 0.0, 2.0),
                        ("aten::copy_", 20.0, 40.0)],
                  wall_s=50e-6, steps=1)
    res = RunResult(cell=cell, trace=trace, graph_nodes=["KERNEL"] * 6,
                    graph_steps=2, checks=[Check("step0_gap", 0.0, 1.0)])
    line = R.report(res, True, "test", 1)
    m = {k: v["value"] for k, v in line["metrics"].items()}
    assert m["step.kernels"] == 3
    assert m["step.other_device_ms"] == pytest.approx(0.005)
    assert m["idle_share.rollout"] == pytest.approx(1 - 26e-6 / 50e-6)
    # 30,000 envs (the tiny cell keeps the traffic's count for the
    # roofline only through num_envs: 48 here): bytes bound
    least = 4 * (48 * (2 * 6 * 6 + 4 * 3) + 8 * 6 + 2 * 10) / 3.35e12
    assert m["physics.roofline_pct"] == pytest.approx(100 * least / 20e-6)
    assert line["device"]["busy_s"] == pytest.approx(26e-6)
    assert line["device"]["window_s"] == 50e-6
    assert line["breakdown"]["idle_gaps"][0][0] == "aten::copy_"
    assert list(line)[-1] == "check" and line["correct"]


def test_no_checks_is_not_correct():
    cell = tiny_cell("transport.rollout")
    res = RunResult(cell=cell, metrics={m["name"]: 1.0
                                        for m in cell.end_to_end})
    assert not R.report(res, False, "test", 1)["correct"]


def test_forbidden_names_compare_whole_top_level(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "vectorizedmultiagentsimulator_tpu_torch"
                        ".fake", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", object())
    assert R.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "vectorizedmultiagentsimulator_tpu.fake",
                        object())
    assert R.forbidden_modules() == ["vectorizedmultiagentsimulator_tpu.fake"]


def test_train_trace_line_reads_spans_and_rooflines():
    cell = tiny_cell("transport.train")
    trace = Trace(kernels=[("ppo_update_kernel", 0.0, 40.0),
                           ("ppo_reduce_kernel", 40.0, 50.0),
                           ("ppo_update_kernel", 60.0, 100.0),
                           ("ppo_reduce_kernel", 100.0, 110.0)],
                  wall_s=200e-6, steps=64,
                  spans={"collect": [0.3, 0.5], "update": [0.6, 0.6],
                         "env.step": [0.002, 0.004]})
    res = RunResult(cell=cell, trace=trace,
                    checks=[Check("loss_gap", 0.0, 1.0)])
    m = {k: v["value"] for k, v in
         R.report(res, True, "test", 1)["metrics"].items()}
    assert m["train.collect_ms"] == pytest.approx(400)
    assert m["train.update_ms"] == pytest.approx(600)
    assert m["entry.step_host_ms"] == pytest.approx(3)
    assert m["idle_share.train"] == pytest.approx(1 - 100e-6 / 200e-6)
    # 512 envs: minibatches of 32,768 samples; a launch of 50 us
    od, H, aw, mb = 15, 256, 2, 64 * 4 * 512 // 4
    ops = (2 * (4 * od * H + 3 * H * H) * mb / 989e12
           + (2 * (3 * H * aw + 2 * H) + 15 * H + 30 * aw) * mb / 67e12)
    assert m["ppo.roofline_pct"] == pytest.approx(100 * ops / 50e-6)
    f = 2 * (od * H + H * H + H * aw + od * H + H)
    n = 64 * 4 * 512
    flops = f * (n + 4 * 512) + 3 * f * n * 4
    assert m["train.mfu_pct"] == pytest.approx(100 * flops / 989e12 / 1.0)
