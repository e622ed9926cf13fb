"""On the card: every cell runs through the command of BENCHMARK.json and
comes out correct, untraced and traced. Skips without a CUDA device."""

import json
import subprocess

import pytest

from posebench import harness

BENCH = harness.benchmark()


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_runs_correct(card, workload, trace):
    cmd = BENCH["command"] + ["--workload", workload, "--seed", str(2 ** 31 + 901),
                              "--seconds", "3", "--trace", str(trace)]
    out = subprocess.run(cmd, capture_output=True, text=True, cwd=str(harness.ROOT), timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] >= 1
    assert line["metrics"]


def test_refuses_without_card():
    """Without a CUDA device the command prints no result and fails."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is here")
    cmd = BENCH["command"] + ["--workload", BENCH["workloads"][0]["name"], "--seed", "1",
                              "--seconds", "1", "--trace", "0"]
    out = subprocess.run(cmd, capture_output=True, text=True, cwd=str(harness.ROOT), timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
