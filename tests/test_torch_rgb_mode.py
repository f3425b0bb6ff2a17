"""RGB mode in the port (BASELINE.json: in_nc = out_nc = 3 across train,
finetune and eval) against the JAX package: the counterpart of
tests/test_rgb_mode.py at n_feature 8 on 64² RGB frames.

The port's trainer and finetuner write the ``.ckpt`` files; both packages'
E1 and E4 CLIs read them. Limits (BASELINE.md): each denoised PNG within 1
uint8 level of JAX's, average PSNR within 0.05 dB and SSIM within 1e-3; the
port's device metrics within 1e-3 dB, 1e-4 and 1e-6 of its host metrics
(tests/test_rgb_mode.py:75-77)."""
import glob
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from image_denoising_tpu.cli import evaluation as jax_e1
from image_denoising_tpu.cli import evaluation_adapter as jax_e4
from image_denoising_tpu.losses import structure_loss as jax_structure_loss
from image_denoising_tpu_torch.ckpt import load_checkpoint
from image_denoising_tpu_torch.cli import evaluation, evaluation_adapter, finetune
from image_denoising_tpu_torch.cli import train as train_cli
from image_denoising_tpu_torch.losses import structure_loss
from image_denoising_tpu_torch.models import ImprovedUNet
from image_denoising_tpu_torch.ops import AugmentNoise
from image_denoising_tpu_torch.ops.neighbor import (generate_subimages, subsample_pair,
                                                    subsample_pair_fused)

from _torch_port_helpers import one_torch_thread  # noqa: F401

CPU = ["--device", "cpu"]
NET = ["--n_feature", "8", "--n_channel", "3"]
PSNR_TOL, SSIM_TOL, LEVELS = 0.05, 1e-3, 1
DM_PSNR_TOL, DM_SSIM_TOL, DM_L1_TOL = 1e-3, 1e-4, 1e-6


@pytest.fixture(scope="module")
def rgb(tmp_path_factory):
    """2 seeded 64² RGB pairs (tests/test_rgb_mode.py's frames), the port's
    trainer run on them (its epoch_model_001.ckpt) and the port's output
    adapter finetune over that file (its epoch_adapter_001.ckpt)."""
    from PIL import Image

    root = tmp_path_factory.mktemp("rgbdata")
    (root / "clean").mkdir()
    (root / "noise").mkdir()
    rng = np.random.default_rng(21)
    yy, xx = np.mgrid[0:64, 0:64]
    for i in range(2):
        clean = np.stack([(120 + 60 * np.sin(xx / 5.0 + k + i)
                           + 30 * ((yy // 16 + xx // 16) % 2)).clip(0, 255)
                          for k in range(3)], axis=-1).astype(np.uint8)
        noisy = np.clip(clean.astype(np.float32) + rng.normal(0, 12, clean.shape),
                        0, 255).astype(np.uint8)
        Image.fromarray(clean).save(root / "clean" / f"rgb_{i}.png")
        Image.fromarray(noisy).save(root / "noise" / f"rgb_{i}.png")
    save = root / "results"
    train_cli.main(["--data_dir", str(root), "--save_model_path", str(save),
                    "--log_name", "UNetImproved_rgb", "--n_epoch", "1",
                    "--batchsize", "2"] + NET + CPU)
    (ckpt,) = glob.glob(os.path.join(save, "**", "epoch_model_001.ckpt"), recursive=True)
    finetune.main(["--data_dir", str(root), "--pretrained_ckpt", ckpt,
                   "--arch", "UNetImproved", "--save_model_path", str(root / "ft"),
                   "--log_name", "rgb_ft", "--n_epoch", "1", "--batchsize", "2",
                   "--patch_size", "32", "--patches_per_image", "4"] + NET + CPU)
    return dict(root=str(root), ckpt=ckpt,
                adapter=str(root / "ft" / "rgb_ft" / "epoch_adapter_001.ckpt"))


def _pngs(d):
    from PIL import Image

    return {f: np.asarray(Image.open(os.path.join(d, f)))
            for f in sorted(os.listdir(d)) if f.endswith("_denoised.png")}


def _same_levels(ours, theirs):
    assert sorted(ours) == sorted(theirs) and ours
    for f in ours:
        assert ours[f].shape == theirs[f].shape == (64, 64, 3), f
        d = np.abs(ours[f].astype(np.int16) - theirs[f].astype(np.int16))
        assert d.max() <= LEVELS, (f, d.max())


def test_train_writes_an_rgb_checkpoint(rgb):
    model = ImprovedUNet(3, 3, 8)
    model.load_state_dict(load_checkpoint(rgb["ckpt"], arch="UNetImproved"), strict=True)
    assert model.downs[0][0].in_channels == 4 and model.final.out_channels == 3


def test_whole_frame_eval_matches_jax(rgb, tmp_path):
    args = ["--data_dir", rgb["root"], "--checkpoint", rgb["ckpt"],
            "--log_name", "UNetImproved_rgb"] + NET
    ours = evaluation.main(args + CPU + ["--save_dir", str(tmp_path / "torch")])
    theirs = jax_e1.main(args + ["--save_dir", str(tmp_path / "jax")])
    _same_levels(_pngs(tmp_path / "torch"), _pngs(tmp_path / "jax"))
    assert abs(ours["psnr"] - theirs["psnr"]) <= PSNR_TOL
    assert abs(ours["ssim"] - theirs["ssim"]) <= SSIM_TOL
    assert ours["psnr"] > 5.0


def test_device_metrics_match_host_metrics(rgb, tmp_path):
    args = ["--data_dir", rgb["root"], "--checkpoint", rgb["ckpt"],
            "--log_name", "UNetImproved_rgb"] + NET + CPU
    host = evaluation.main(args + ["--save_dir", str(tmp_path / "host")])
    dm = evaluation.main(args + ["--save_dir", str(tmp_path / "dm"), "--device_metrics",
                                 "--save_images", "none"])
    assert abs(dm["psnr"] - host["psnr"]) < DM_PSNR_TOL
    assert abs(dm["ssim"] - host["ssim"]) < DM_SSIM_TOL
    assert abs(dm["l1"] - host["l1"]) < DM_L1_TOL


def test_adapter_finetune_and_eval_match_jax(rgb, tmp_path):
    assert os.path.exists(rgb["adapter"])
    args = ["--data_dir", rgb["root"], "--ckpt", rgb["adapter"]] + NET
    ours = evaluation_adapter.main(args + CPU + ["--save_dir", str(tmp_path / "torch")])
    theirs = jax_e4.main(args + ["--save_dir", str(tmp_path / "jax")])
    _same_levels(_pngs(tmp_path / "torch"), _pngs(tmp_path / "jax"))
    assert abs(ours - theirs) <= PSNR_TOL


def test_rgb_n2n_subsampler_and_losses():
    """tests/test_rgb_mode.py::test_rgb_n2n_subsampler_and_losses on the
    port: the sub-sampler at C = 3 (one pair of maps for all channels, the
    wrapper equal to its plain version), gauss25 noise of the input's shape,
    and the structure loss at C = 3 equal to JAX's on the same arrays."""
    x = torch.from_numpy(np.random.default_rng(0).random((2, 3, 32, 32), dtype=np.float32))
    sub1, sub2, (sel1, sel2) = subsample_pair_fused(7, x)
    assert sub1.shape == sub2.shape == (2, 3, 16, 16) and sel1.shape == (2, 16, 16)
    want = subsample_pair(7, x)
    assert torch.equal(sub1, want[0]) and torch.equal(sub2, want[1])
    for ch in range(3):
        assert torch.equal(sub1[:, ch : ch + 1], generate_subimages(x[:, ch : ch + 1], sel1))
        assert torch.equal(sub2[:, ch : ch + 1], generate_subimages(x[:, ch : ch + 1], sel2))
    y = AugmentNoise("gauss25").add_train_noise(torch.Generator().manual_seed(1), x)
    assert y.shape == x.shape and not torch.equal(y, x)
    got = float(structure_loss(y, x, x))
    nhwc = [np.asarray(a.permute(0, 2, 3, 1)) for a in (y, x, x)]
    assert np.isfinite(got)
    np.testing.assert_allclose(got, float(jax_structure_loss(*map(jnp.asarray, nhwc))),
                               rtol=1e-6)
    assert jax.devices()[0].platform == "cpu"
