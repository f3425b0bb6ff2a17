"""The port's evaluation_704 CLI against the JAX one on a tiny PNG dataset and
a ``.pth`` written by the JAX package's ``export_pth``."""
import os

import numpy as np
import pytest

from image_denoising_tpu.ckpt.pth_export import export_pth
from image_denoising_tpu.cli import evaluation_704 as jax_eval704
from image_denoising_tpu_torch.cli import evaluation_704 as eval704

from _torch_port_helpers import one_torch_thread, seeded_improved_unet_params  # noqa: F401


@pytest.fixture(scope="module")
def dataset_and_ckpt(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("semdata")
    (root / "clean").mkdir()
    (root / "noise").mkdir()
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:64, 0:64]
    for i in range(3):
        clean = (120 + 60 * np.sin(xx / 6.0 + i)
                 + 40 * ((yy // 16 + xx // 16) % 2)).clip(0, 255).astype(np.uint8)
        noisy = np.clip(clean + rng.normal(0, 15, clean.shape), 0, 255).astype(np.uint8)
        Image.fromarray(clean).save(root / "clean" / f"sem0000_{i:02d}.png")
        Image.fromarray(noisy).save(root / "noise" / f"sem0000_{i:02d}.png")
    _, params = seeded_improved_unet_params(8, seed=3)
    ckpt = export_pth(params, "UNetImproved", str(root / "model.pth"))
    return str(root), ckpt


ARGS = ["--n_feature", "8", "--log_name", "UNetImproved", "--tile", "32",
        "--overlap", "16", "--compute_iq_iou"]


def test_eval704_matches_jax_cli(dataset_and_ckpt, tmp_path):
    data, ckpt = dataset_and_ckpt
    common = ARGS + ["--data_dir", data, "--checkpoint", ckpt]
    ref = jax_eval704.main(common + ["--save_dir", str(tmp_path / "jax")])
    out = eval704.main(common + ["--save_dir", str(tmp_path / "torch"),
                                 "--device", "cpu"])
    assert sorted(os.listdir(tmp_path / "torch")) == sorted(os.listdir(tmp_path / "jax"))
    assert abs(out["psnr"] - ref["psnr"]) <= 0.01
    assert abs(out["ssim"] - ref["ssim"]) <= 1e-4
    assert abs(out["l1"] - ref["l1"]) <= 1e-5
    # burst mode runs the same per-tile forwards: byte-identical outputs
    burst = eval704.main(common + ["--save_dir", str(tmp_path / "burst"),
                                   "--device", "cpu", "--frame_burst", "2"])
    assert burst == out
    assert (open(tmp_path / "burst" / "metrics.txt").read()
            == open(tmp_path / "torch" / "metrics.txt").read())


@pytest.mark.parametrize("flag", [["--parallel"], ["--device_metrics"],
                                  ["--host_workers", "2"], ["--blindspot"],
                                  ["--gpu_devices", "0,1"]])
def test_eval704_refuses_flags_of_later_slices(dataset_and_ckpt, tmp_path, flag):
    data, ckpt = dataset_and_ckpt
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        eval704.main(ARGS + ["--data_dir", data, "--checkpoint", ckpt,
                             "--save_dir", str(tmp_path), "--device", "cpu"] + flag)
