"""One short run of a cell on the card, as the benchmark's command runs it
(skips without a card)."""

import json
import subprocess
import sys

import harness_support as hs
import pytest
import torch


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_run_on_the_card(card, trace):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "dam1m-step",
         "--seed", str(hs.SEED), "--seconds", "1", "--trace", str(trace)],
        cwd=hs.CHECKOUT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["failed"] == 0
    assert r["device"]["platform"] == "gpu"
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
    if trace:
        assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
        assert "k1_roofline" in r["metrics"]
