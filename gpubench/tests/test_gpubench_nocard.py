"""The run command without a card, and without the program beside it,
exits non-zero and prints no result."""
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
ENV_CPU = {"CUDA_VISIBLE_DEVICES": ""}


def _run(cwd, args):
    import os

    return subprocess.run([sys.executable, *args], cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=dict(os.environ, **ENV_CPU))


def test_run_without_a_card_prints_no_result():
    out = _run(ROOT, ["-m", "gpubench.run", "--workload", "e2_bf16_burst8",
                      "--seed", str(2 ** 31 + 17), "--seconds", "1", "--trace", "0"])
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "CUDA" in out.stderr


def test_the_benchmark_alone_cannot_run_a_cell(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path, ["-c", "import gpubench.kinds.tiled_burst"])
    assert out.returncode != 0 and "image_denoising_tpu_torch" in out.stderr
    out = _run(tmp_path, ["-m", "gpubench.run", "--workload", "e2_f32_burst8",
                          "--seed", "1", "--seconds", "1", "--trace", "1"])
    assert out.returncode != 0 and "{" not in out.stdout
