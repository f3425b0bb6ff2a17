"""Nothing of the benchmark imports JAX or the JAX package, the reference
imports nothing of the program either, and a run leaves neither loaded.
Top-level module names are compared whole: ``image_denoising_tpu_torch``
is not ``image_denoising_tpu``."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
JAX = {"jax", "jaxlib", "flax", "image_denoising_tpu"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


FILES = sorted(p.relative_to(HERE).as_posix() for p in HERE.rglob("*.py"))


@pytest.mark.parametrize("rel", FILES)
def test_no_jax_import(rel):
    found = set(_imports(HERE / rel))
    assert not found & JAX, found & JAX
    if rel.startswith("reference/"):
        assert "image_denoising_tpu_torch" not in found
        assert found <= {"__future__", "contextlib", "numpy", "torch"}, found


def test_a_run_leaves_no_jax_loaded():
    code = ("import time; from gpubench import harness; "
            "from gpubench.tests._tiny import tiny_cell; "
            "r = harness.run_cell(tiny_cell('e2_f32_burst8'), 9, 0.5, False, 'cpu', time.time()); "
            "assert r['correct']; print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from gpubench import harness

    monkeypatch.setitem(sys.modules, "image_denoising_tpu_torch_x", sys)
    assert "image_denoising_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib" in harness.forbidden_modules()
