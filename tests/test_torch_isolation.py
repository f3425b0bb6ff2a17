"""The PyTorch port stands alone: it imports no JAX, no flax, optax or
msgpack (the GPU machine has none of them) and nothing of the JAX package,
and its entry points run on CUDA unless told otherwise."""
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
# what neither the port nor the card's scripts may import
BANNED = ("jax", "jaxlib", "flax", "optax", "msgpack", "image_denoising_tpu")


def test_port_modules_import_no_jax():
    code = textwrap.dedent("""
        import importlib, json, pkgutil, sys
        import image_denoising_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
        for n in names:
            importlib.import_module(n)
        def banned(n):
            return any(n == b or n.startswith(b + ".") for b in %r)
        print(json.dumps({"modules": names,
                          "banned": sorted(n for n in sys.modules if banned(n))}))
    """ % (BANNED,))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "image_denoising_tpu_torch.ops.fused_block" in report["modules"]
    for mod in ("cli.evaluation_704", "cli.evaluation_704_iqsl_memory",
                "memory.bank", "memory.retrieval", "adapters.wrappers",
                "adapters.memory_adapters", "adapters.output_adapter",
                "eval.tiled", "cli.train", "ops.neighbor", "ops.rng",
                "ops.noise", "losses.n2n", "losses.pixel", "train.schedule",
                "train.state", "train.steps", "ckpt.io", "utils.profiling",
                "ckpt.msgpack", "ckpt.pth_import", "models.registry", "losses.iqsl",
                "train.finetune_steps", "cli.finetune", "cli.finetune_iqsl",
                "cli.finetune_memory", "data.pairs", "cli.denoise", "cli.evaluation",
                "cli.evaluation_704_iqsl", "cli.evaluation_adapter",
                "cli.evaluation_adapter_iqsl", "metrics.device", "cli.train_opt",
                "hpo.engine", "hpo.benchmark", "models.unet", "models.resnet",
                "models.init", "models.layers", "ops.space_to_depth",
                "parallel.mesh", "parallel.dryrun", "memory.sharded",
                "data.native_sampler", "data.prep", "cli.dataset_tool",
                "cli.dataset_tool_raw", "cli.launchers"):
        assert f"image_denoising_tpu_torch.{mod}" in report["modules"]
    assert report["banned"] == []


def test_port_reads_nothing_of_the_native_directory():
    """The port builds its own copies of the host C++ (csrc/ssim.cpp,
    csrc/patch_sampler.cpp): no file of it names the repository's
    ``native/`` directory or the library its make builds."""
    pkg = REPO / "image_denoising_tpu_torch"
    named = [str(p.relative_to(REPO)) for p in sorted(pkg.rglob("*"))
             if p.is_file() and p.suffix in (".py", ".cpp", ".cu", ".cuh")
             and any(w in p.read_text() for w in ("native/", "libpatch_sampler"))]
    assert named == []
    assert (pkg / "csrc" / "patch_sampler.cpp").is_file()


def _entry_points():
    from image_denoising_tpu_torch.cli import (denoise, evaluation, evaluation_704,
                                               evaluation_704_iqsl,
                                               evaluation_704_iqsl_memory,
                                               evaluation_adapter, evaluation_adapter_iqsl,
                                               finetune, finetune_iqsl, finetune_memory,
                                               train, train_opt)
    from image_denoising_tpu_torch.eval import tiled
    from image_denoising_tpu_torch.memory import build_memory_bank
    from image_denoising_tpu_torch.models import (RESNET, ImprovedUNet, UNet, make_forward,
                                                  make_fused_forward)
    from image_denoising_tpu_torch.ops.neighbor import generate_mask_pair
    from image_denoising_tpu_torch.parallel import make_mesh

    frame = np.zeros((32, 32), np.uint8)
    return {
        "make_fused_forward": lambda: make_fused_forward(ImprovedUNet(1, 1, 8)),
        "make_forward_unet": lambda: make_forward(UNet(1, 1, 8, blindspot=True)),
        "make_forward_resnet": lambda: make_forward(RESNET(1, 1, 8)),
        "runner": lambda: tiled.make_tiled_pyramid_runner(lambda t: t, 32, 32, 16, 8),
        "runner_frames": lambda: tiled.make_tiled_pyramid_runner_frames(
            lambda t: t, 2, 32, 32, 16, 8),
        "denoise_tiled_pyramid": lambda: tiled.denoise_tiled_pyramid(
            lambda t: t, frame, 16, 8),
        "evaluation_704": lambda: evaluation_704.main(
            ["--checkpoint", "missing.pth", "--data_dir", "missing"]),
        "hann_runner": lambda: tiled.make_tiled_hann_runner(lambda t: t, 32, 32, 16, 8),
        "hann_runner_frames": lambda: tiled.make_tiled_hann_runner_frames(
            lambda t: t, 2, 32, 32, 16, 8),
        "denoise_tiled_hann": lambda: tiled.denoise_tiled_hann(
            lambda t: t, frame, 16, 8),
        "build_memory_bank": lambda: build_memory_bank(
            ["missing.png"], ["missing.png"], 16, 8),
        "evaluation_704_iqsl_memory": lambda: evaluation_704_iqsl_memory.main(
            ["--data_dir", "missing", "--base_ckpt", "b.pth",
             "--adapter_ckpt", "a.pth"]),
        "train": lambda: train.main(["--loss", "n2n", "--data_dir", "missing"]),
        "train_structure": lambda: train.main(["--data_dir", "missing"]),
        "finetune": lambda: finetune.main(["--data_dir", "missing",
                                           "--pretrained_ckpt", "b.ckpt"]),
        "finetune_iqsl": lambda: finetune_iqsl.main(["--data_dir", "missing",
                                                     "--pretrained_ckpt", "b.ckpt"]),
        "finetune_memory": lambda: finetune_memory.main(["--data_dir", "missing",
                                                         "--pretrained_ckpt", "b.ckpt"]),
        # the draw of subsample_pair_fused's plain version
        "generate_mask_pair": lambda: generate_mask_pair(0, (1, 1, 4, 4)),
        "denoise_whole_frame": lambda: tiled.denoise_whole_frame(
            lambda t: t, np.zeros((32, 32, 1), np.float32)),
        "evaluation": lambda: evaluation.main(
            ["--checkpoint", "missing.pth", "--data_dir", "missing"]),
        "evaluation_704_iqsl": lambda: evaluation_704_iqsl.main(
            ["--checkpoint", "missing.pth", "--data_dir", "missing"]),
        "denoise": lambda: denoise.main(["--checkpoint", "missing.pth",
                                         "--input_dir", "missing"]),
        "evaluation_adapter": lambda: evaluation_adapter.main(
            ["--ckpt", "missing.pth", "--data_dir", "missing"]),
        "evaluation_adapter_iqsl": lambda: evaluation_adapter_iqsl.main(
            ["--base_ckpt", "b.pth", "--adapter_ckpt", "a.pth", "--data_dir", "missing"]),
        "train_opt": lambda: train_opt.main(["--data_dir", "missing"]),
        "make_mesh": lambda: make_mesh(),
        "train_parallel": lambda: train.main(["--parallel", "--data_dir", "missing"]),
        "evaluation_704_iqsl_memory_bank_sharded": lambda: evaluation_704_iqsl_memory.main(
            ["--data_dir", "missing", "--base_ckpt", "b.pth", "--adapter_ckpt", "a.pth",
             "--bank_sharded"]),
    }


@pytest.mark.parametrize("name", ["make_fused_forward", "runner", "runner_frames",
                                  "denoise_tiled_pyramid", "evaluation_704",
                                  "hann_runner", "hann_runner_frames",
                                  "denoise_tiled_hann", "build_memory_bank",
                                  "evaluation_704_iqsl_memory", "train",
                                  "train_structure", "finetune", "finetune_iqsl",
                                  "finetune_memory", "generate_mask_pair",
                                  "denoise_whole_frame", "evaluation",
                                  "evaluation_704_iqsl", "denoise", "evaluation_adapter",
                                  "evaluation_adapter_iqsl", "train_opt",
                                  "make_forward_unet", "make_forward_resnet",
                                  "make_mesh", "train_parallel",
                                  "evaluation_704_iqsl_memory_bank_sharded"])
def test_entry_points_default_to_cuda(name):
    call = _entry_points()[name]
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()


def test_subsample_pair_fused_runs_the_kernel_or_raises():
    """The N2N sub-sampler's wrapper takes its plain version only for a CPU
    tensor: any other tensor goes to the kernel, which takes CUDA tensors
    only, and nothing falls back."""
    from image_denoising_tpu_torch.ops import neighbor

    with pytest.raises(ValueError, match="CUDA or CPU"):
        neighbor.subsample_pair_fused(0, torch.zeros((1, 1, 4, 4), device="meta"))
    img = torch.zeros((1, 1, 4, 4))
    before = neighbor.subsample_pair_fused.launches
    assert torch.equal(neighbor.subsample_pair_fused(0, img)[2][0],
                       neighbor.subsample_pair(0, img)[2][0])
    assert neighbor.subsample_pair_fused.launches == before


def test_cuda_scripts_import_no_jax():
    """The card's scripts (``scripts/cuda/*.py``) stand with the port: no
    import statement in them names JAX or the JAX package, and loading them
    with every module they import (inside their functions too) pulls in
    neither."""
    import ast

    scripts = sorted((REPO / "scripts" / "cuda").glob("*.py"))
    assert {"convergence.py", "huge_frame.py", "mutants.py"} <= {p.name for p in scripts}
    imported = set()
    for path in scripts:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module] + [f"{node.module}.{a.name}" for a in node.names]
            else:
                continue
            for name in names:
                assert not any(name == b or name.startswith(b + ".") for b in BANNED), (
                    path.name, name)
            imported.update(names)
    port = sorted(n for n in imported if n.startswith("image_denoising_tpu_torch."))
    assert "image_denoising_tpu_torch.eval.tiled" in port
    code = textwrap.dedent("""
        import importlib, importlib.util, json, pathlib, sys
        for path in sorted(pathlib.Path("scripts/cuda").glob("*.py")):
            spec = importlib.util.spec_from_file_location(path.stem, path)
            spec.loader.exec_module(importlib.util.module_from_spec(spec))
        for name in %r:
            try:
                importlib.import_module(name)
            except ModuleNotFoundError:  # a name imported from a module
                importlib.import_module(name.rsplit(".", 1)[0])
        banned = %r
        print(json.dumps(sorted(n for n in sys.modules
                                if any(n == b or n.startswith(b + ".") for b in banned))))
    """ % (port, BANNED))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_mutant_run_imports_no_jax():
    """scripts/cuda/mutants.py runs chip_smoke.py's checks in its children:
    the script, chip_smoke.py and every module of the port the children's
    checks import pull in nothing of BANNED."""
    code = textwrap.dedent("""
        import importlib, json, sys
        sys.path.insert(0, ".")
        import chip_smoke
        chip_smoke._script("mutants")
        for name in ("image_denoising_tpu_torch.ops._build", "image_denoising_tpu_torch.models",
                     "image_denoising_tpu_torch.ops.fused_block",
                     "image_denoising_tpu_torch.memory.retrieval",
                     "image_denoising_tpu_torch.memory", "image_denoising_tpu_torch.ops.neighbor",
                     "image_denoising_tpu_torch.eval.tiled", "image_denoising_tpu_torch.train"):
            importlib.import_module(name)
        banned = %r
        print(json.dumps(sorted(n for n in sys.modules
                                if any(n == b or n.startswith(b + ".") for b in banned))))
    """ % (BANNED,))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
