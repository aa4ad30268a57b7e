"""One run of each cell as the driver starts it, on the card; skipped
where there is none."""
import json
import subprocess
import sys

import pytest

from portbench.spec import ROOT, load_json


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [
    w["name"] for w in load_json(ROOT, "BENCHMARK.json")["workloads"]])
def test_cell_on_card(card, workload):
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", workload,
         "--seed", str(2**31 + 11), "--seconds", "3", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200, check=True)
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["check"]
