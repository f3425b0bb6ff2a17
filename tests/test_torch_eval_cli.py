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


def test_eval704_device_metrics_match_host(dataset_and_ckpt, tmp_path):
    """--device_metrics scores each burst on the device: PSNR within 1e-3 dB,
    SSIM within 1e-5 of the host float64 pass, IoU within 1e-6, L1 equal,
    the same PNGs; with --save_images none (1-frame bursts) the predictions
    stay on the device and no PNG is written."""
    data, ckpt = dataset_and_ckpt
    common = ARGS + ["--data_dir", data, "--checkpoint", ckpt, "--device", "cpu"]
    host = eval704.main(common + ["--save_dir", str(tmp_path / "host")])
    dm = eval704.main(common + ["--save_dir", str(tmp_path / "dm"), "--frame_burst", "2",
                                "--device_metrics"])
    none = eval704.main(common + ["--save_dir", str(tmp_path / "none"),
                                  "--device_metrics", "--save_images", "none"])
    for got in (dm, none):
        assert abs(got["psnr"] - host["psnr"]) <= 1e-3
        assert abs(got["ssim"] - host["ssim"]) <= 1e-5
        assert got["l1"] == host["l1"]
        for k in ("iou_dark", "iou_mid", "iou_bright"):
            assert abs(got[k] - host[k]) <= 1e-6, k
    for f in sorted(os.listdir(tmp_path / "host")):
        assert (open(tmp_path / "dm" / f, "rb").read()
                == open(tmp_path / "host" / f, "rb").read()), f
    assert os.listdir(tmp_path / "none") == ["metrics.txt"]


def test_eval704_host_workers_and_profile_dir(dataset_and_ckpt, tmp_path, capsys):
    """--host_workers 2 runs the host pass in a pool: the frame lines,
    metrics.txt and every PNG are identical to the inline pass. --profile_dir
    writes a trace of the denoise loop."""
    data, ckpt = dataset_and_ckpt
    common = ARGS + ["--data_dir", data, "--checkpoint", ckpt, "--device", "cpu",
                     "--frame_burst", "2"]

    def lines():
        return [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[")]

    inline = eval704.main(common + ["--save_dir", str(tmp_path / "inline")])
    inline_lines = lines()
    pooled = eval704.main(common + ["--save_dir", str(tmp_path / "pooled"),
                                    "--host_workers", "2",
                                    "--profile_dir", str(tmp_path / "trace")])
    assert lines() == inline_lines and pooled == inline
    files = sorted(os.listdir(tmp_path / "inline"))
    assert files == sorted(os.listdir(tmp_path / "pooled"))
    for f in files:
        assert (open(tmp_path / "inline" / f, "rb").read()
                == open(tmp_path / "pooled" / f, "rb").read()), f
    assert [f for f in os.listdir(tmp_path / "trace") if f.endswith(".pt.trace.json")]


@pytest.mark.parametrize("flag", [["--parallel"], ["--blindspot"],
                                  ["--gpu_devices", "0,1"]])
def test_eval704_refuses_flags_of_later_slices(dataset_and_ckpt, tmp_path, flag,
                                               monkeypatch, capsys):
    """Flags that waited for later slices now run. --parallel (multi-device)
    splits each tile stack over a mesh of 4 CPU devices: at the pinned
    1-tile chunks every PNG and metrics.txt equal the run without it,
    frame by frame and in bursts. A --gpu_devices list runs on its first
    device (here the CPU), with the same output. --blindspot, refused until
    the other networks were ported: with --arch UNet on a blind-spot
    UNet-8 ``.pth`` the port's E2 matches the JAX CLI within the limits of
    test_eval704_matches_jax_cli."""
    data, ckpt = dataset_and_ckpt
    if flag == ["--blindspot"]:
        from _torch_port_helpers import seeded_network_params

        _, params = seeded_network_params("UNet", 8, seed=45, blindspot=True)
        pth = export_pth(params, "UNet", str(tmp_path / "unet_blindspot.pth"))
        common = ARGS + ["--data_dir", data, "--checkpoint", pth, "--arch", "UNet"] + flag
        ref = jax_eval704.main(common + ["--save_dir", str(tmp_path / "jax")])
        out = eval704.main(common + ["--save_dir", str(tmp_path / "torch"),
                                     "--device", "cpu"])
        assert sorted(os.listdir(tmp_path / "torch")) == sorted(os.listdir(tmp_path / "jax"))
        assert abs(out["psnr"] - ref["psnr"]) <= 0.01
        assert abs(out["ssim"] - ref["ssim"]) <= 1e-4
        assert abs(out["l1"] - ref["l1"]) <= 1e-5
        return
    from _torch_port_helpers import patch_cpu_mesh, same_files

    patch_cpu_mesh(monkeypatch, 4)
    common = ARGS + ["--data_dir", data, "--checkpoint", ckpt, "--device", "cpu",
                     "--tile_batch", "-1"]
    for burst in ([], ["--frame_burst", "2"]):
        tag = "burst" if burst else "frames"
        ref = eval704.main(common + burst + ["--save_dir", str(tmp_path / f"ref_{tag}")])
        capsys.readouterr()
        out = eval704.main(common + burst + flag + ["--save_dir", str(tmp_path / tag)])
        assert ("tile-parallel over 4 devices" in capsys.readouterr().out) == (
            flag == ["--parallel"])
        assert out == ref
        same_files(tmp_path / tag, tmp_path / f"ref_{tag}")
