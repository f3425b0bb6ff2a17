"""The port's E6 CLI (cli/evaluation_704_iqsl_memory.py) against the JAX one
on a tiny PNG set: the JAX side loads ``.ckpt`` files from
``save_checkpoint``, the port ``.pth`` files from ``export_pth``, holding
the same seeded params."""
import os

import numpy as np
import pytest

import jax.numpy as jnp

from image_denoising_tpu.adapters import build_memory_adapter as jax_build
from image_denoising_tpu.ckpt import save_checkpoint
from image_denoising_tpu.ckpt.pth_export import export_pth
from image_denoising_tpu.cli import evaluation_704_iqsl_memory as jax_e6
from image_denoising_tpu_torch.cli import evaluation_704_iqsl_memory as e6

from _torch_port_helpers import (one_torch_thread, seeded_improved_unet_params,  # noqa: F401
                                 seeded_params)


@pytest.fixture(scope="module")
def dataset_and_ckpts(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("e6data")
    (root / "clean").mkdir()
    (root / "noise").mkdir()
    rng = np.random.default_rng(9)
    yy, xx = np.mgrid[0:64, 0:64]
    for i in range(3):
        clean = (120 + 60 * np.sin(xx / 6.0 + i)
                 + 40 * ((yy // 16 + xx // 16) % 2)).clip(0, 255).astype(np.uint8)
        noisy = np.clip(clean + rng.normal(0, 15, clean.shape), 0, 255).astype(np.uint8)
        Image.fromarray(clean).save(root / "clean" / f"sem{i:02d}.png")
        Image.fromarray(noisy).save(root / "noise" / f"sem{i:02d}.png")
    _, base = seeded_improved_unet_params(8, seed=6)
    x = jnp.zeros((2, 32, 32, 1), jnp.float32)
    adapter = seeded_params(jax_build("hyper_gated_fft", 1, 16), x, x, x, seed=7)
    ck = root / "ckpt"
    return str(root), {
        "jax": (save_checkpoint(base, str(ck), "model", 1),
                save_checkpoint(adapter, str(ck), "adapter_only", 1)),
        "torch": (export_pth(base, "UNetImproved", str(root / "base.pth")),
                  export_pth(adapter, "hyper_gated_fft", str(root / "adapter.pth"))),
    }


ARGS = ["--n_feature", "8", "--patch_size", "32", "--overlap", "16",
        "--memory_stride", "16", "--num_memory_images", "2", "--compute_iq_iou"]


def _args(data, ckpts, side, save_dir, *extra):
    base, adapter = ckpts[side]
    out = ARGS + ["--data_dir", data, "--base_ckpt", base, "--adapter_ckpt", adapter,
                  "--save_dir", str(save_dir), *extra]
    return out + (["--device", "cpu"] if side == "torch" else [])


def _pngs(d):
    from PIL import Image

    return {f: np.asarray(Image.open(os.path.join(d, f)))
            for f in sorted(os.listdir(d)) if f.endswith(".png")}


def test_e6_matches_jax_cli(dataset_and_ckpts, tmp_path):
    data, ckpts = dataset_and_ckpts
    ref = jax_e6.main(_args(data, ckpts, "jax", tmp_path / "jax"))
    out = e6.main(_args(data, ckpts, "torch", tmp_path / "torch"))
    assert sorted(os.listdir(tmp_path / "torch")) == sorted(os.listdir(tmp_path / "jax"))
    assert len(_pngs(tmp_path / "torch")) == 3
    assert abs(out["psnr"] - ref["psnr"]) <= 0.01
    for k in ("iou_dark", "iou_mid", "iou_bright"):
        assert abs(out[k] - ref[k]) <= 1e-3, k

    def same(save_dir, *extra):
        got = e6.main(_args(data, ckpts, "torch", tmp_path / save_dir, *extra))
        assert got == out, extra
        a, b = _pngs(tmp_path / save_dir), _pngs(tmp_path / "torch")
        assert a.keys() == b.keys()
        for f in a:
            np.testing.assert_array_equal(a[f], b[f], err_msg=f)

    # bursts of 2 over 3 frames (a padded tail burst) run the same tiles
    same("burst", "--frame_burst", "2", "--timing_json", str(tmp_path / "t.json"))
    # exact int8 distances retrieve the same patches as the float32 bank on
    # this uint8 data, the uint8 clean store decodes to the same floats, and
    # per-chunk retrieval gives the hoisted pass's patches
    same("int8", "--bank_dtype", "int8", "--clean_bank_dtype", "uint8")
    same("no_hoist", "--bank_dtype", "int8", "--no_hoist_retrieval")
    same("chunked", "--retrieval_chunk", "5", "--pallas_retrieval")


def test_e6_device_metrics_and_host_workers(dataset_and_ckpts, tmp_path, capsys):
    """--device_metrics scores PSNR and IoU of each burst on the device
    (PSNR within 1e-3 dB, IoU within 1e-6 of the host pass, the same PNGs;
    none with --save_images none); --host_workers 2 gives the inline pass's
    frame lines, metrics.txt and PNGs."""
    data, ckpts = dataset_and_ckpts

    def lines():
        return [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[")]

    host = e6.main(_args(data, ckpts, "torch", tmp_path / "host"))
    host_lines = lines()
    for name, extra in (("dm", ["--frame_burst", "2", "--device_metrics"]),
                        ("none", ["--device_metrics", "--save_images", "none"])):
        got = e6.main(_args(data, ckpts, "torch", tmp_path / name, *extra))
        assert abs(got["psnr"] - host["psnr"]) <= 1e-3, name
        for k in ("iou_dark", "iou_mid", "iou_bright"):
            assert abs(got[k] - host[k]) <= 1e-6, (name, k)
    a, b = _pngs(tmp_path / "dm"), _pngs(tmp_path / "host")
    assert a.keys() == b.keys() and not _pngs(tmp_path / "none")
    for f in a:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    lines()
    pooled = e6.main(_args(data, ckpts, "torch", tmp_path / "pooled", "--host_workers", "2"))
    assert lines() == host_lines and pooled == host
    assert ((tmp_path / "pooled" / "metrics.txt").read_text()
            == (tmp_path / "host" / "metrics.txt").read_text())
    a = _pngs(tmp_path / "pooled")
    for f in a:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)


@pytest.mark.parametrize("flag", [["--parallel"], ["--bank_sharded"],
                                  ["--gpu_devices", "0,1"]])
def test_e6_refuses_flags_of_later_slices(dataset_and_ckpts, tmp_path, flag, monkeypatch):
    """The multi-device flags, refused until multi-device was ported, now
    run over a mesh of 4 CPU devices: --parallel splits each tile stack,
    --bank_sharded splits both banks too (the hoisted retrieval through the
    sharded bank's key merge), a --gpu_devices list runs on its first
    device. At pinned 1-tile chunks the PNGs and metrics equal the run
    without the flag, frame by frame and in bursts."""
    from _torch_port_helpers import patch_cpu_mesh, same_files

    patch_cpu_mesh(monkeypatch, 4)
    data, ckpts = dataset_and_ckpts
    for burst in ([], ["--frame_burst", "2"]):
        tag = "burst" if burst else "frames"
        ref = e6.main(_args(data, ckpts, "torch", tmp_path / f"ref_{tag}",
                            "--tile_batch", "-1", *burst))
        out = e6.main(_args(data, ckpts, "torch", tmp_path / tag,
                            "--tile_batch", "-1", *burst, *flag))
        assert out == ref
        same_files(tmp_path / tag, tmp_path / f"ref_{tag}")
