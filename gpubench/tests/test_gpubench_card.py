"""On the card: one short run of each cell through the run command."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures the card and refuses the CPU")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["e2_bf16_burst8", "e2_f32_burst8",
                                      "train_structure_f32_b4"])
def test_short_run_on_the_card(card, workload):
    out = subprocess.run([sys.executable, "-m", "gpubench.run", "--workload", workload,
                          "--seed", str(2 ** 31 + 29), "--seconds", "3", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is True and r["device"]["platform"] == "gpu"
