"""The port's CLIs with ``--parallel`` and ``--bank_sharded`` on the CPU:
``make_mesh()`` sent to 4 CPU devices (``patch_cpu_mesh``), each run held
to the same run without the flags (PNG bytes and metrics, at pinned 1-tile
chunks for the tiled CLIs), and E2 to the JAX CLI's ``--parallel`` run on
its 8 virtual CPU devices. Mirrors tests/test_parallel_eval_cli.py and
tests/test_finetune_e2e.py:302."""
import glob
import os

import numpy as np
import pytest
import torch

from image_denoising_tpu.ckpt import save_checkpoint as jax_save_checkpoint
from image_denoising_tpu.ckpt.pth_export import export_pth
from image_denoising_tpu.cli import evaluation_704 as jax_eval704
from image_denoising_tpu_torch.cli import (denoise, evaluation_704,
                                           evaluation_704_iqsl_memory, finetune_memory,
                                           train)

from _torch_port_helpers import (one_torch_thread, patch_cpu_mesh,  # noqa: F401
                                 same_files, seeded_improved_unet_params)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """5 seeded 64² uint8 pairs, ImprovedUNet-8 as a JAX ``.ckpt`` and as
    a ``.pth``, and a memory adapter written by the port's finetuner."""
    from PIL import Image

    root = tmp_path_factory.mktemp("parcli")
    rng = np.random.default_rng(61)
    yy, xx = np.mgrid[0:64, 0:64]
    for sub in ("clean", "noise"):
        (root / sub).mkdir()
    for i in range(5):
        clean = (120 + 60 * np.sin(xx / 6.0 + i)
                 + 40 * ((yy // 16 + xx // 16) % 2)).clip(0, 255).astype(np.uint8)
        noisy = np.clip(clean + rng.normal(0, 15, clean.shape), 0, 255).astype(np.uint8)
        Image.fromarray(clean).save(root / "clean" / f"sem{i:02d}.png")
        Image.fromarray(noisy).save(root / "noise" / f"sem{i:02d}.png")
    _, params = seeded_improved_unet_params(8, seed=62)
    base_ckpt = jax_save_checkpoint(params, str(root / "base"), "model", 1)
    pth = export_pth(params, "UNetImproved", str(root / "base.pth"))
    finetune_memory.main(["--device", "cpu", "--n_feature", "8", "--patch_size", "32",
                          "--patches_per_image", "2", "--n_epoch", "1",
                          "--adapter_hidden", "8", "--memory_stride", "16",
                          "--data_dir", str(root), "--pretrained_ckpt", base_ckpt,
                          "--save_model_path", str(root / "ft"), "--log_name", "mem"])
    (adapter,) = glob.glob(str(root / "ft" / "mem" / "epoch_adapter_only_001.ckpt"))
    return dict(root=str(root), base=base_ckpt, pth=pth, adapter=adapter)


E2 = ["--n_feature", "8", "--log_name", "UNetImproved", "--tile", "32", "--overlap", "16",
      "--compute_iq_iou"]


def test_eval704_parallel_matches_single_and_jax(data, tmp_path, monkeypatch):
    """E2 --parallel over 4 devices, in bursts of 2 with device metrics and
    2 host workers: the PNGs and metrics of the same run without
    --parallel; and (one forward per share, --tile_batch 0) within E2's
    limits of the JAX CLI's --parallel run on its 8 devices."""
    patch_cpu_mesh(monkeypatch, 4)
    common = E2 + ["--data_dir", data["root"], "--checkpoint", data["pth"],
                   "--device", "cpu", "--tile_batch", "-1"]
    burst = ["--frame_burst", "2", "--device_metrics", "--host_workers", "2"]
    ref = evaluation_704.main(common + burst + ["--save_dir", str(tmp_path / "ref")])
    par = evaluation_704.main(common + burst + ["--parallel",
                                                "--save_dir", str(tmp_path / "par")])
    assert par == ref
    same_files(tmp_path / "par", tmp_path / "ref")
    jargs = E2 + ["--data_dir", data["root"], "--checkpoint", data["base"],
                  "--tile_batch", "0", "--parallel"]
    want = jax_eval704.main(jargs + ["--save_dir", str(tmp_path / "jax")])
    got = evaluation_704.main(jargs[:-1] + ["--checkpoint", data["pth"], "--device", "cpu",
                                            "--parallel", "--save_dir",
                                            str(tmp_path / "port")])
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    assert abs(got["psnr"] - want["psnr"]) <= 0.01
    assert abs(got["ssim"] - want["ssim"]) <= 1e-4
    assert abs(got["l1"] - want["l1"]) <= 1e-5


@pytest.mark.parametrize("flags", [
    ["--parallel", "--bank_sharded", "--no-hoist_retrieval"],
    ["--bank_sharded", "--bank_dtype", "int8", "--clean_bank_dtype", "uint8",
     "--frame_burst", "2"],
    ["--parallel", "--no-hoist_retrieval", "--retrieval_chunk", "3"],
], ids=["sharded_per_chunk", "sharded_int8_burst", "parallel_per_chunk"])
def test_e6_parallel_and_sharded_bank_match_single(data, tmp_path, monkeypatch, flags):
    """E6 over 4 devices: the sharded bank retrieving inside each chunk's
    forward (JAX's form) and in the hoisted pass, int8 and f32 banks, and
    --parallel with a bank copied to each device: the PNGs and metrics of
    the single-device run with the same bank and chunks."""
    patch_cpu_mesh(monkeypatch, 4)
    args = ["--data_dir", data["root"], "--base_ckpt", data["base"], "--adapter_ckpt",
            data["adapter"], "--n_feature", "8", "--adapter_hidden", "8", "--patch_size",
            "32", "--overlap", "16", "--memory_stride", "16", "--num_memory_images", "2",
            "--compute_iq_iou", "--device", "cpu", "--tile_batch", "-1"]
    plain = [f for f in flags if f not in ("--parallel", "--bank_sharded")]
    ref = evaluation_704_iqsl_memory.main(args + plain + ["--save_dir", str(tmp_path / "ref")])
    out = evaluation_704_iqsl_memory.main(args + flags + ["--save_dir", str(tmp_path / "out")])
    assert out == ref
    same_files(tmp_path / "out", tmp_path / "ref")


def test_finetune_memory_with_both_flags(data, tmp_path, monkeypatch, capsys):
    """finetune_memory --parallel --bank_sharded: JAX's message, the batch
    kept whole (no batch split), so the adapter is the --bank_sharded run's
    bit for bit."""
    patch_cpu_mesh(monkeypatch, 4)
    args = ["--device", "cpu", "--n_feature", "8", "--patch_size", "32",
            "--patches_per_image", "2", "--n_epoch", "1", "--adapter_hidden", "8",
            "--memory_stride", "16", "--data_dir", data["root"], "--pretrained_ckpt",
            data["base"], "--bank_sharded"]
    ref = finetune_memory.main(args + ["--save_model_path", str(tmp_path / "ref")])
    capsys.readouterr()
    out = finetune_memory.main(args + ["--parallel", "--save_model_path", str(tmp_path / "out")])
    said = capsys.readouterr().out
    assert "--parallel adds no batch DP here" in said and "data-parallel over 4" in said
    for a, b in zip(out.model.parameters(), ref.model.parameters()):
        assert torch.equal(a, b)


def test_train_structure_parallel_matches_single(data, tmp_path, monkeypatch, capsys):
    """The default structure-loss trainer with --parallel over 4 devices at
    batch 4 of 64², one step in each of 2 epochs: each step's logged
    losses within 1e-5 of the single-device run's
    (tests/test_train.py:194-200's bound)."""
    import re

    patch_cpu_mesh(monkeypatch, 4)
    line = re.compile(r"Loss1=(\d+\.\d+), Loss_Full=(\d+\.\d+)")
    args = ["--device", "cpu", "--arch", "UNetImproved", "--n_feature", "8",
            "--batchsize", "4", "--n_epoch", "2", "--data_dir", data["root"]]
    losses = []
    for extra in ([], ["--parallel"]):
        capsys.readouterr()
        train.main(args + extra + ["--save_model_path", str(tmp_path / str(len(extra)))])
        losses.append(np.array(line.findall(capsys.readouterr().out), np.float64))
    assert losses[0].shape == (2, 2)
    np.testing.assert_allclose(losses[1], losses[0], atol=1e-5)


def test_denoise_parallel_in_bursts(data, tmp_path, monkeypatch):
    """denoise --parallel over 4 devices in bursts of 2 with 2 host
    workers: the PNGs of the run without --parallel."""
    patch_cpu_mesh(monkeypatch, 4)
    args = ["--checkpoint", data["pth"], "--input_dir", os.path.join(data["root"], "noise"),
            "--n_feature", "8", "--device", "cpu", "--tile_batch", "-1",
            "--frame_burst", "2", "--host_workers", "2"]
    assert denoise.main(args + ["--save_dir", str(tmp_path / "ref")]) == 5
    assert denoise.main(args + ["--parallel", "--save_dir", str(tmp_path / "out")]) == 5
    same_files(tmp_path / "out", tmp_path / "ref")

