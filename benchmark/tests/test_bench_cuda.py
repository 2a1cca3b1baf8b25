"""A short run of each cell on the card: `python -m pytest benchmark/tests
-m cuda` on a machine with one. Skips on the CPU (decided in the test)."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["k08-revisit-10hz", "kaist-serve-b16"])
def test_short_run_on_the_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "2147483999", "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert res["metrics"]["setup_s"]["value"] > 0


def test_no_card_no_result():
    """Without a card the run refuses and prints no result."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "k08-revisit-10hz", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
