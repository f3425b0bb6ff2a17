"""The port's serving CLIs against the JAX package's on a tiny PNG set and the
same seeded weights: E1 (cli/evaluation.py), E3 (cli/evaluation_704_iqsl.py),
the production ``denoise`` CLI, and the adapter evaluators E4
(cli/evaluation_adapter.py) and E5 (cli/evaluation_adapter_iqsl.py). The
limits are E2's (tests/test_torch_eval_cli.py): PSNR 0.01 dB, SSIM 1e-4,
L1 1e-5, the same file names."""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from image_denoising_tpu.adapters import OutputAdapter as JaxOutputAdapter
from image_denoising_tpu.ckpt.pth_export import export_pth, params_to_state_dict
from image_denoising_tpu.cli import denoise as jax_denoise
from image_denoising_tpu.cli import evaluation as jax_e1
from image_denoising_tpu.cli import evaluation_704_iqsl as jax_e3
from image_denoising_tpu.cli import evaluation_adapter as jax_e4
from image_denoising_tpu.cli import evaluation_adapter_iqsl as jax_e5
from image_denoising_tpu_torch.adapters import OutputAdapter
from image_denoising_tpu_torch.ckpt import load_checkpoint, save_checkpoint
from image_denoising_tpu_torch.cli import (denoise, evaluation, evaluation_704,
                                           evaluation_704_iqsl, evaluation_adapter,
                                           evaluation_adapter_iqsl)
from image_denoising_tpu_torch.models import ImprovedUNet

from _torch_port_helpers import (one_torch_thread, seeded_improved_unet_params,  # noqa: F401
                                 seeded_params)

CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """3 seeded 64² uint8 pairs; ImprovedUNet-8 as a JAX-exported .pth; an
    output adapter (hidden 8, every weight non-zero) as its own .pth, in a
    combined base + adapter .pth and in a port-written ``adapter`` .ckpt."""
    from PIL import Image

    root = tmp_path_factory.mktemp("serving")
    (root / "clean").mkdir()
    (root / "noise").mkdir()
    rng = np.random.default_rng(41)
    yy, xx = np.mgrid[0:64, 0:64]
    for i in range(3):
        clean = (120 + 60 * np.sin(xx / 6.0 + i)
                 + 40 * ((yy // 16 + xx // 16) % 2)).clip(0, 255).astype(np.uint8)
        noisy = np.clip(clean + rng.normal(0, 15, clean.shape), 0, 255).astype(np.uint8)
        Image.fromarray(clean).save(root / "clean" / f"sem{i:02d}.png")
        Image.fromarray(noisy).save(root / "noise" / f"sem{i:02d}.png")
    _, base = seeded_improved_unet_params(8, seed=42)
    x = jnp.zeros((1, 16, 16, 1), jnp.float32)
    adapter = seeded_params(JaxOutputAdapter(1, 8), x, x, seed=43)
    base_pth = export_pth(base, "UNetImproved", str(root / "base.pth"))
    adapter_pth = export_pth(adapter, "output_adapter", str(root / "adapter.pth"))
    combined = {f"base.{k}": torch.from_numpy(np.array(v)) for k, v in
                params_to_state_dict(base, "UNetImproved").items()}
    combined.update({f"adapter.{k}": torch.from_numpy(np.array(v)) for k, v in
                     params_to_state_dict(adapter, "output_adapter").items()})
    torch.save(combined, root / "combined.pth")
    unet = ImprovedUNet(1, 1, 8)
    unet.load_state_dict(load_checkpoint(base_pth), strict=True)
    head = OutputAdapter(1, 8)
    head.load_state_dict(load_checkpoint(adapter_pth), strict=True)
    adapter_ckpt = save_checkpoint({"base": unet, "adapter": head}, str(root / "ckpt"),
                                   "adapter", 1)
    return dict(root=str(root), base=base_pth, adapter=adapter_pth,
                combined=str(root / "combined.pth"), adapter_ckpt=adapter_ckpt)


def _pngs(d):
    from PIL import Image

    return {f: np.asarray(Image.open(os.path.join(d, f)))
            for f in sorted(os.listdir(d)) if f.endswith(".png")}


def _frame_lines(text):
    return [ln for ln in text.splitlines() if ln.startswith("[")]


def _close(out, ref, keys=("psnr", "ssim", "l1")):
    limits = {"psnr": 0.01, "ssim": 1e-4, "l1": 1e-5, "iou_dark": 1e-3,
              "iou_mid": 1e-3, "iou_bright": 1e-3}
    for k in keys:
        assert abs(out[k] - ref[k]) <= limits[k], (k, out[k], ref[k])


def test_e1_matches_jax_cli(data, tmp_path):
    args = ["--n_feature", "8", "--data_dir", data["root"], "--checkpoint", data["base"]]
    ref = jax_e1.main(args + ["--save_dir", str(tmp_path / "jax")])
    out = evaluation.main(args + CPU + ["--save_dir", str(tmp_path / "torch")])
    _close(out, ref)
    got, want = _pngs(tmp_path / "torch"), _pngs(tmp_path / "jax")
    assert got.keys() == want.keys() and len(got) == 9
    for f in got:  # RGB mode, as the reference saves
        assert got[f].shape == (64, 64, 3), f
        assert np.abs(got[f].astype(int) - want[f]).max() <= 1, f


def test_e1_device_metrics_and_host_workers(data, tmp_path, capsys):
    """--device_metrics scores on the device: PSNR within 1e-3 dB, SSIM
    within 1e-5 of the host float64 pass, L1 equal, the same PNGs;
    --save_images none writes none. --host_workers 2: the host pass's
    lines and metrics.txt identical to the inline pass."""
    args = ["--n_feature", "8", "--data_dir", data["root"], "--checkpoint", data["base"]] + CPU
    host = evaluation.main(args + ["--save_dir", str(tmp_path / "host")])
    lines = _frame_lines(capsys.readouterr().out)
    dm = evaluation.main(args + ["--save_dir", str(tmp_path / "dm"), "--device_metrics"])
    assert abs(dm["psnr"] - host["psnr"]) <= 1e-3
    assert abs(dm["ssim"] - host["ssim"]) <= 1e-5
    assert dm["l1"] == host["l1"]
    a, b = _pngs(tmp_path / "dm"), _pngs(tmp_path / "host")
    assert a.keys() == b.keys()
    for f in a:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    capsys.readouterr()
    none = evaluation.main(args + ["--save_dir", str(tmp_path / "none"), "--device_metrics",
                                   "--save_images", "none", "--host_workers", "2"])
    assert none == dm and not _pngs(tmp_path / "none")
    capsys.readouterr()
    pooled = evaluation.main(args + ["--save_dir", str(tmp_path / "pooled"),
                                     "--host_workers", "2"])
    assert _frame_lines(capsys.readouterr().out) == lines
    assert pooled == host
    assert ((tmp_path / "pooled" / "metrics.txt").read_text()
            == (tmp_path / "host" / "metrics.txt").read_text())


def test_e3_matches_jax_cli(data, tmp_path):
    args = ["--n_feature", "8", "--data_dir", data["root"], "--checkpoint", data["base"],
            "--tile", "32", "--overlap", "16", "--compute_iq_iou"]
    ref = jax_e3.main(args + ["--save_dir", str(tmp_path / "jax")])
    out = evaluation_704_iqsl.main(args + CPU + ["--save_dir", str(tmp_path / "torch")])
    assert sorted(os.listdir(tmp_path / "torch")) == sorted(os.listdir(tmp_path / "jax"))
    _close(out, ref, ("psnr", "ssim", "l1", "iou_dark", "iou_mid", "iou_bright"))


DENOISE = ["--n_feature", "8", "--tile", "32", "--overlap", "16"]


def test_denoise_matches_jax_cli(data, tmp_path):
    """At the production preset's bursts of 8 and 8-tile chunks (float32):
    the uint8 PNGs equal JAX's on at least 99.9 % of pixels, within 1 level."""
    args = DENOISE + ["--input_dir", os.path.join(data["root"], "noise"),
                      "--checkpoint", data["base"], "--dtype", "float32"]
    assert jax_denoise.main(args + ["--save_dir", str(tmp_path / "jax")]) == 3
    assert denoise.main(args + CPU + ["--save_dir", str(tmp_path / "torch")]) == 3
    got, want = _pngs(tmp_path / "torch"), _pngs(tmp_path / "jax")
    assert got.keys() == want.keys() and len(got) == 3
    for f in got:
        d = np.abs(got[f].astype(int) - want[f])
        assert d.max() <= 1 and (d > 0).mean() <= 1e-3, f


def test_denoise_equals_e2_and_keeps_colliding_names(data, tmp_path):
    """--dtype float32 --tile_batch -1 --rounding floor gives E2's denoised
    PNGs byte for byte, in bursts of 2 (a padded tail), frame by frame and
    with --host_workers 2; two inputs with one stem get two outputs."""
    from PIL import Image

    e2 = tmp_path / "e2"
    evaluation_704.main(DENOISE + CPU + ["--data_dir", data["root"], "--checkpoint",
                                         data["base"], "--save_dir", str(e2),
                                         "--save_images", "denoised"])
    want = {f.rsplit("_", 2)[0] + "_denoised.png": v for f, v in _pngs(e2).items()}
    assert len(want) == 3
    noise = os.path.join(data["root"], "noise")
    args = DENOISE + CPU + ["--input_dir", noise, "--checkpoint", data["base"],
                            "--dtype", "float32", "--tile_batch", "-1",
                            "--rounding", "floor"]
    for mode, extra in (("burst2", ["--frame_burst", "2"]),
                        ("single", ["--frame_burst", "0"]),
                        ("pooled", ["--frame_burst", "2", "--host_workers", "2"])):
        assert denoise.main(args + extra + ["--save_dir", str(tmp_path / mode)]) == 3
        got = _pngs(tmp_path / mode)
        assert got.keys() == want.keys(), mode
        for f in got:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f"{mode} {f}")

    coll = tmp_path / "coll_in"
    coll.mkdir()
    img = Image.open(os.path.join(noise, sorted(os.listdir(noise))[0]))
    img.save(coll / "frame01.png")
    img.save(coll / "frame01.tif")
    assert denoise.main(args + ["--input_dir", str(coll), "--frame_burst", "2",
                                "--save_dir", str(tmp_path / "coll_out")]) == 2
    outs = _pngs(tmp_path / "coll_out")
    assert sorted(outs) == ["frame01_png_denoised.png", "frame01_tif_denoised.png"]
    np.testing.assert_array_equal(*outs.values())


@pytest.mark.parametrize("ckpt", ["combined", "adapter_ckpt"])
def test_e4_matches_jax_cli(data, tmp_path, ckpt):
    """E4 over a combined reference .pth and over the port-written
    ``adapter`` .ckpt (JAX reads both): mode-L PNGs within 1 level, mean
    PSNR within 0.01 dB; --host_workers 2 gives the same."""
    args = ["--n_feature", "8", "--adapter_hidden", "8", "--data_dir", data["root"],
            "--ckpt", data[ckpt], "--an_unknown_flag", "1"]
    ref = jax_e4.main(args + ["--save_dir", str(tmp_path / "jax")])
    out = evaluation_adapter.main(args + CPU + ["--save_dir", str(tmp_path / "torch")])
    assert abs(out - ref) <= 0.01
    got, want = _pngs(tmp_path / "torch"), _pngs(tmp_path / "jax")
    assert got.keys() == want.keys() and len(got) == 3
    for f in got:
        assert got[f].shape == (64, 64)
        assert np.abs(got[f].astype(int) - want[f]).max() <= 1, f
    pooled = evaluation_adapter.main(args + CPU + ["--save_dir", str(tmp_path / "pooled"),
                                                   "--host_workers", "2"])
    assert pooled == out


def test_e5_matches_jax_cli(data, tmp_path):
    args = ["--n_feature", "8", "--adapter_hidden", "8", "--data_dir", data["root"],
            "--base_ckpt", data["base"], "--adapter_ckpt", data["adapter"],
            "--compute_iq_iou"]
    ref = jax_e5.main(args + ["--save_dir", str(tmp_path / "jax")])
    out = evaluation_adapter_iqsl.main(args + CPU + ["--save_dir", str(tmp_path / "torch")])
    _close(out, ref, ("psnr", "ssim", "iou_dark", "iou_mid", "iou_bright"))
    assert sorted(os.listdir(tmp_path / "torch")) == sorted(os.listdir(tmp_path / "jax"))
    assert all(v.ndim == 2 for v in _pngs(tmp_path / "torch").values())


def _other_network_cli_matches_jax(data, tmp_path, cli):
    """E1 and denoise with ``--arch UNet --blindspot`` on a blind-spot UNet-8
    ``.pth``, E4 with ``--arch UNet`` on a combined UNet-8 + adapter
    ``.pth``: the port's CLI against the JAX one, E2's limits, PNGs within
    1 level."""
    from _torch_port_helpers import seeded_network_params

    blindspot = cli != "evaluation_adapter"
    _, unet = seeded_network_params("UNet", 8, seed=44, blindspot=blindspot)
    root = data["root"]
    if cli == "evaluation_adapter":
        sd = {f"base.{k}": torch.from_numpy(np.array(v))
              for k, v in params_to_state_dict(unet, "UNet").items()}
        sd.update({f"adapter.{k}": v for k, v in torch.load(data["adapter"]).items()})
        torch.save(sd, tmp_path / "unet_combined.pth")
        args = ["--n_feature", "8", "--adapter_hidden", "8", "--data_dir", root,
                "--ckpt", str(tmp_path / "unet_combined.pth"), "--arch", "UNet"]
        ref = jax_e4.main(args + ["--save_dir", str(tmp_path / "jax")])
        out = evaluation_adapter.main(args + CPU + ["--save_dir", str(tmp_path / "torch")])
        assert abs(out - ref) <= 0.01
    else:
        pth = export_pth(unet, "UNet", str(tmp_path / "unet_blindspot.pth"))
        net = ["--arch", "UNet", "--blindspot", "--checkpoint", pth]
        if cli == "evaluation":
            args = net + ["--n_feature", "8", "--data_dir", root]
            ref = jax_e1.main(args + ["--save_dir", str(tmp_path / "jax")])
            out = evaluation.main(args + CPU + ["--save_dir", str(tmp_path / "torch")])
            _close(out, ref)
        else:
            args = net + DENOISE + ["--input_dir", os.path.join(root, "noise"),
                                    "--dtype", "float32"]
            assert jax_denoise.main(args + ["--save_dir", str(tmp_path / "jax")]) == 3
            assert denoise.main(args + CPU + ["--save_dir", str(tmp_path / "torch")]) == 3
    got, want = _pngs(tmp_path / "torch"), _pngs(tmp_path / "jax")
    assert got.keys() == want.keys() and len(got) == {"evaluation": 9}.get(cli, 3)
    for f in got:
        assert np.abs(got[f].astype(int) - want[f]).max() <= 1, f


@pytest.mark.parametrize("cli,flag", [
    ("evaluation", ["--blindspot"]),
    ("evaluation", ["--gpu_devices", "0,1"]),
    ("denoise", ["--parallel"]),
    ("denoise", ["--blindspot"]),
    ("evaluation_adapter", ["--parallel"]),
    ("evaluation_adapter_iqsl", ["--parallel"]),
    ("evaluation_adapter", ["--arch", "UNet"]),
])
def test_serving_clis_refuse_flags_of_later_slices(data, tmp_path, cli, flag,
                                                   monkeypatch):
    """Flags that waited for multi-device now run over a mesh of 4 CPU
    devices and give the output of the run without them, byte for byte:
    ``denoise --parallel`` splits each burst's tile stack (1-tile chunks),
    E4/E5 ``--parallel`` run the frames in groups of 4, one per device,
    and E1's ``--gpu_devices`` list runs on its first device. The other
    networks' flags, refused until those networks were ported, now run and
    match the JAX CLI (``_other_network_cli_matches_jax``): ``--blindspot``
    in E1 and denoise, ``--arch UNet`` in E4."""
    if flag in (["--blindspot"], ["--arch", "UNet"]):
        _other_network_cli_matches_jax(data, tmp_path, cli)
        return
    from _torch_port_helpers import patch_cpu_mesh, same_files

    patch_cpu_mesh(monkeypatch, 4)
    ckpt = {"evaluation": ["--checkpoint", data["base"], "--data_dir", data["root"]],
            "denoise": ["--checkpoint", data["base"], "--tile_batch", "-1",
                        "--input_dir", os.path.join(data["root"], "noise")],
            "evaluation_adapter": ["--ckpt", data["combined"], "--data_dir", data["root"]],
            "evaluation_adapter_iqsl": ["--base_ckpt", data["base"], "--adapter_ckpt",
                                        data["adapter"], "--data_dir", data["root"]]}[cli]
    main = {"evaluation": evaluation.main, "denoise": denoise.main,
            "evaluation_adapter": evaluation_adapter.main,
            "evaluation_adapter_iqsl": evaluation_adapter_iqsl.main}[cli]
    args = ckpt + CPU + ["--n_feature", "8"]
    if cli.startswith("evaluation_adapter"):
        args += ["--adapter_hidden", "8"]
    ref = main(args + ["--save_dir", str(tmp_path / "ref")])
    out = main(args + ["--save_dir", str(tmp_path / "out")] + flag)
    assert out == ref
    same_files(tmp_path / "out", tmp_path / "ref")
