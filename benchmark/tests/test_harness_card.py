"""One short run of the first cell on the card (skips without one):
`python3 -m pytest benchmark/tests -m cuda` on a machine with a card."""

import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark runs on the card only")


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct(card):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "chr21_r2c2.deep", "--seed", str(2**31 + 17),
                          "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=1200,
                         env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert result["device"]["platform"] == "gpu"
    assert set(result["metrics"]) == {"reads_per_s", "setup_s"}
