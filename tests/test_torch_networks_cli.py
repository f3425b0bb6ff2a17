"""The port's CLIs with the UNet (blind spot off and on) and the RESNET on
the CPU, against the JAX package's CLIs on the same files: N2N training of
the UNet (128² frames: 64² sub-images), the blind-spot launcher preset
(``--log_name UNET_blindspot_gauss25``) trained and served by E2 through
the same log-name dispatch, ``denoise`` and E3 with ``--arch RESNET``, and
the three finetuners over a UNet or RESNET base with the evaluator that
serves each one's adapter (E4, E5, E6). n_feature 8; E2's limits: PSNR
0.01 dB, SSIM 1e-4, L1 1e-5."""
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_denoising_tpu.ckpt import load_checkpoint as jax_load_checkpoint
from image_denoising_tpu.ckpt import save_checkpoint as jax_save_checkpoint
from image_denoising_tpu.cli import denoise as jax_denoise
from image_denoising_tpu.cli import evaluation_704 as jax_e2
from image_denoising_tpu.cli import evaluation_704_iqsl as jax_e3
from image_denoising_tpu.cli import evaluation_704_iqsl_memory as jax_e6
from image_denoising_tpu.cli import evaluation_adapter as jax_e4
from image_denoising_tpu.cli import evaluation_adapter_iqsl as jax_e5
from image_denoising_tpu.models import UNet as JaxUNet
from image_denoising_tpu_torch.ckpt import load_checkpoint
from image_denoising_tpu_torch.cli import (denoise, evaluation_704, evaluation_704_iqsl,
                                           evaluation_704_iqsl_memory, evaluation_adapter,
                                           evaluation_adapter_iqsl, finetune, finetune_iqsl,
                                           finetune_memory, train)
from image_denoising_tpu_torch.models import UNet
from image_denoising_tpu_torch.ops.neighbor import subsample_pair_fused

from _torch_port_helpers import one_torch_thread, seeded_network_params  # noqa: F401

CPU = ["--device", "cpu"]
TILES = ["--tile", "32", "--overlap", "16"]


def _write_pairs(root, size, count, seed):
    from PIL import Image

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    for sub in ("clean", "noise"):
        (root / sub).mkdir(parents=True)
    for i in range(count):
        clean = (120 + 60 * np.sin(xx / 6.0 + i)
                 + 40 * ((yy // 16 + xx // 16) % 2)).clip(0, 255).astype(np.uint8)
        noisy = np.clip(clean + rng.normal(0, 15, clean.shape), 0, 255).astype(np.uint8)
        Image.fromarray(clean).save(root / "clean" / f"sem{i:02d}.png")
        Image.fromarray(noisy).save(root / "noise" / f"sem{i:02d}.png")
    return str(root)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """5 seeded 64² pairs and 4 of 128²; UNet-8 and RESNET-8 bases as
    JAX-written ``.ckpt`` files."""
    root = tmp_path_factory.mktemp("netcli")
    out = dict(root=_write_pairs(root / "d64", 64, 5, seed=61),
               root128=_write_pairs(root / "d128", 128, 4, seed=62))
    for i, arch in enumerate(("UNet", "RESNET")):
        _, params = seeded_network_params(arch, 8, seed=63 + i)
        out[arch] = jax_save_checkpoint(params, str(root / arch), "model", 1)
        out[f"{arch}_params"] = params
    return out


def _pngs(d):
    from PIL import Image

    return {f: np.asarray(Image.open(os.path.join(d, f)))
            for f in sorted(os.listdir(d)) if f.endswith(".png")}


def _close(out, ref, keys=("psnr", "ssim", "l1")):
    limits = {"psnr": 0.01, "ssim": 1e-4, "l1": 1e-5}
    for k in keys:
        assert abs(out[k] - ref[k]) <= limits[k], (k, out[k], ref[k])


def test_n2n_train_cli_trains_the_unet(data, tmp_path):
    """``--arch UNet --loss n2n`` on 128² frames, 2 steps at batch 2: the
    reference outputs, no kernel launched on the CPU, and the last
    checkpoint, read by the JAX package, gives JAX's UNet the port's
    forward (atol 1e-5)."""
    before = subsample_pair_fused.launches
    state = train.main(CPU + ["--arch", "UNet", "--loss", "n2n", "--n_feature", "8",
                              "--batchsize", "2", "--n_epoch", "1",
                              "--max_steps_per_epoch", "2", "--data_dir", data["root128"],
                              "--save_model_path", str(tmp_path)])
    assert int(state.step) == 2 and subsample_pair_fused.launches == before
    (run_dir,) = glob.glob(str(tmp_path / "*" / "*"))
    assert sorted(os.listdir(run_dir)) == ["epoch_model_000.ckpt", "epoch_model_001.ckpt",
                                           "validation"]
    params = jax_load_checkpoint(os.path.join(run_dir, "epoch_model_001.ckpt"))
    x = np.random.default_rng(64).random((1, 64, 64, 1), dtype=np.float32)
    want = np.asarray(JaxUNet(1, 1, 8).apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = state.model(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_blindspot_preset_trains_and_serves_through_the_log_name(data, tmp_path):
    """The launcher's preset (``--log_name UNET_blindspot_gauss25``, the
    structure loss) for 2 steps: its checkpoint is the blind-spot topology
    (``nin_a`` takes 384 channels), and E2 picks the same network from the
    same log name in both packages, within E2's limits."""
    log = "UNET_blindspot_gauss25"
    train.main(CPU + ["--log_name", log, "--n_feature", "8", "--batchsize", "2",
                      "--n_epoch", "1", "--max_steps_per_epoch", "2",
                      "--data_dir", data["root"], "--save_model_path", str(tmp_path / "run")])
    (ckpt,) = glob.glob(str(tmp_path / "run" / log / "*" / "epoch_model_001.ckpt"))
    sd = load_checkpoint(ckpt, arch="UNet")
    assert sd["nin_a.weight"].shape == (384, 384, 1, 1)
    UNet(1, 1, 8, blindspot=True).load_state_dict(sd, strict=True)
    args = TILES + ["--n_feature", "8", "--log_name", log, "--data_dir", data["root"],
                    "--checkpoint", ckpt]
    ref = jax_e2.main(args + ["--save_dir", str(tmp_path / "jax")])
    out = evaluation_704.main(args + CPU + ["--save_dir", str(tmp_path / "torch")])
    _close(out, ref)
    assert sorted(os.listdir(tmp_path / "torch")) == sorted(os.listdir(tmp_path / "jax"))


@pytest.mark.parametrize("cli", ["denoise", "evaluation_704_iqsl"])
def test_resnet_serving_clis_match_jax(data, tmp_path, cli):
    """``--arch RESNET`` over the JAX-written ``.ckpt``: ``denoise``
    (float32) and E3 give JAX's PNGs within 1 level (and E3 its metrics
    within E2's limits)."""
    args = TILES + ["--n_feature", "8", "--arch", "RESNET", "--checkpoint", data["RESNET"]]
    if cli == "denoise":
        args += ["--input_dir", os.path.join(data["root"], "noise"), "--dtype", "float32"]
        assert jax_denoise.main(args + ["--save_dir", str(tmp_path / "jax")]) == 5
        assert denoise.main(args + CPU + ["--save_dir", str(tmp_path / "torch")]) == 5
    else:
        args += ["--data_dir", data["root"]]
        ref = jax_e3.main(args + ["--save_dir", str(tmp_path / "jax")])
        out = evaluation_704_iqsl.main(args + CPU + ["--save_dir", str(tmp_path / "torch")])
        _close(out, ref)
    got, want = _pngs(tmp_path / "torch"), _pngs(tmp_path / "jax")
    assert got.keys() == want.keys() and got
    for f in got:
        assert np.abs(got[f].astype(int) - want[f]).max() <= 1, f


FT = ["--n_feature", "8", "--patch_size", "32", "--patches_per_image", "2", "--n_epoch",
      "1", "--adapter_hidden", "8"]


@pytest.mark.parametrize("cli,arch", [("finetune", "RESNET"), ("finetune_iqsl", "UNet"),
                                      ("finetune_memory", "UNet")])
def test_finetuners_over_other_bases_and_their_evaluators(data, tmp_path, cli, arch):
    """Each finetuner over a JAX-written UNet or RESNET base ``.ckpt``
    (``--arch``), then the evaluator that serves its adapter in both
    packages: E4 on ``finetune``'s ``epoch_adapter`` file (whose base tree
    is JAX's, bit for bit: no RESNET ``up5``), E5 on ``finetune_iqsl``'s
    and E6 on ``finetune_memory``'s ``epoch_adapter_only`` file; PSNR
    within 0.01 dB."""
    main = {"finetune": finetune.main, "finetune_iqsl": finetune_iqsl.main,
            "finetune_memory": finetune_memory.main}[cli]
    mem = ["--memory_stride", "16"] if cli == "finetune_memory" else []
    state = main(FT + CPU + mem + ["--arch", arch, "--data_dir", data["root"],
                                   "--pretrained_ckpt", data[arch], "--log_name", "ft",
                                   "--save_model_path", str(tmp_path)])
    assert int(state.step) == 3  # 4 + 4 + a tail of 2
    role = "adapter" if cli == "finetune" else "adapter_only"
    adapter = str(tmp_path / "ft" / f"epoch_{role}_001.ckpt")
    common = ["--n_feature", "8", "--adapter_hidden", "8", "--arch", arch,
              "--data_dir", data["root"]]
    if cli == "finetune":
        tree = jax_load_checkpoint(adapter)
        assert sorted(tree["base"]) == sorted(data[f"{arch}_params"])
        for k, v in data[f"{arch}_params"].items():
            for a, b in zip(jax.tree_util.tree_leaves(v),
                            jax.tree_util.tree_leaves(tree["base"][k])):
                np.testing.assert_array_equal(a, b)
        args, ours, theirs = common + ["--ckpt", adapter], evaluation_adapter, jax_e4
    else:
        args = common + ["--base_ckpt", data[arch], "--adapter_ckpt", adapter]
        ours, theirs = ((evaluation_adapter_iqsl, jax_e5) if cli == "finetune_iqsl" else
                        (evaluation_704_iqsl_memory, jax_e6))
        if cli == "finetune_memory":
            args += ["--patch_size", "32", "--overlap", "16", "--memory_stride", "16",
                     "--num_memory_images", "2"]
    ref = theirs.main(args + ["--save_dir", str(tmp_path / "jax")])
    out = ours.main(args + CPU + ["--save_dir", str(tmp_path / "torch")])
    if isinstance(ref, dict):
        ref, out = ref["psnr"], out["psnr"]
    assert abs(out - ref) <= 0.01
