"""The port's finetune CLIs (cli/finetune{,_iqsl,_memory}.py) and
``train --resume x.ckpt`` on the CPU, from a base ``.ckpt`` the JAX package
wrote: the files each role writes, JAX's ``load_checkpoint`` reading them,
JAX's ``wrapper.apply`` on what it reads equal to the port's forward, the
port's and JAX's E6 CLIs serving the ``adapter_only`` file the memory
finetuner wrote, the multi-device flags against the runs without them, and
each CLI's first batch against JAX's CLI's at its defaults."""
import glob
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.tree_util import tree_leaves as _leaves

from image_denoising_tpu.adapters import (DenoiserWithAdapter as JaxAdapterWrapper,
                                          DenoiserWithMemoryAdapter as JaxMemWrapper)
from image_denoising_tpu.ckpt import load_checkpoint as jax_load_checkpoint
from image_denoising_tpu.ckpt import save_checkpoint as jax_save_checkpoint
from image_denoising_tpu.cli import evaluation_704_iqsl_memory as jax_e6
from image_denoising_tpu.memory import build_memory_bank as jax_bank
from image_denoising_tpu_torch.adapters import DenoiserWithAdapter, DenoiserWithMemoryAdapter
from image_denoising_tpu_torch.ckpt import load_checkpoint
from image_denoising_tpu_torch.cli import (evaluation_704_iqsl_memory, finetune,
                                           finetune_iqsl, finetune_memory, train)
from image_denoising_tpu_torch.memory import build_memory_bank
from image_denoising_tpu_torch.models import ImprovedUNet, make_fused_forward

from _torch_port_helpers import one_torch_thread, seeded_improved_unet_params  # noqa: F401

PS = 32
ARGS = ["--device", "cpu", "--n_feature", "8", "--patch_size", str(PS),
        "--patches_per_image", "2", "--n_epoch", "1", "--adapter_hidden", "8"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """5 seeded 64² uint8 pairs (one epoch: 10 patches, batches of 4, 4 and
    a tail of 2), and the base as a JAX-written ``epoch_model`` file."""
    from PIL import Image

    root = tmp_path_factory.mktemp("ftcli")
    rng = np.random.default_rng(31)
    yy, xx = np.mgrid[0:64, 0:64]
    for sub in ("clean", "noise"):
        (root / sub).mkdir()
    for i in range(5):
        clean = (120 + 60 * np.sin(xx / 6.0 + i)
                 + 40 * ((yy // 16 + xx // 16) % 2)).clip(0, 255).astype(np.uint8)
        noisy = np.clip(clean + rng.normal(0, 15, clean.shape), 0, 255).astype(np.uint8)
        Image.fromarray(clean).save(root / "clean" / f"sem{i:02d}.png")
        Image.fromarray(noisy).save(root / "noise" / f"sem{i:02d}.png")
    unet, base_params = seeded_improved_unet_params(8, seed=32)
    base_ckpt = jax_save_checkpoint(base_params, str(root / "base"), "model", 1)
    x = np.random.default_rng(33).random((2, 64, 64, 1), dtype=np.float32)
    return dict(root=str(root), base_ckpt=base_ckpt, unet=unet, base_params=base_params,
                x=x)


def _port_base(path):
    base = ImprovedUNet(1, 1, 8)
    base.load_state_dict(load_checkpoint(path, arch="UNetImproved"), strict=True)
    return make_fused_forward(base, device="cpu")


def _nchw(x):
    return torch.from_numpy(x.transpose(0, 3, 1, 2).copy())


@pytest.mark.parametrize("cli", ["finetune", "finetune_iqsl"])
def test_output_adapter_clis_write_their_roles(data, tmp_path, cli):
    """``finetune`` writes ``epoch_adapter_001.ckpt`` ({base, adapter}),
    ``finetune_iqsl`` ``epoch_adapter_only_001.ckpt``; JAX reads either, and
    its wrapper on what it reads gives the port's forward (atol 1e-5)."""
    main = {"finetune": finetune.main, "finetune_iqsl": finetune_iqsl.main}[cli]
    state = main(ARGS + ["--data_dir", data["root"], "--pretrained_ckpt", data["base_ckpt"],
                         "--save_model_path", str(tmp_path)])
    assert int(state.step) == 3  # 4 + 4 + a tail of 2
    log = "UNetImproved_adapter_ft" if cli == "finetune" else "UNetImproved_adapter_iqsl_ft"
    role = "adapter" if cli == "finetune" else "adapter_only"
    run = tmp_path / log
    (val_dir,) = glob.glob(str(run / "val_*_ep001"))
    assert sorted(os.listdir(run)) == sorted([f"epoch_{role}_001.ckpt",
                                              os.path.basename(val_dir)])
    assert len(glob.glob(os.path.join(val_dir, "*_denoised_ep001.png"))) == 1
    tree = jax_load_checkpoint(str(run / f"epoch_{role}_001.ckpt"))
    if cli == "finetune":
        assert sorted(tree) == ["adapter", "base"]
        base_tree, adapter_tree = tree["base"], tree["adapter"]
        for a, b in zip(_leaves(base_tree), _leaves(data["base_params"])):
            np.testing.assert_array_equal(a, b)  # the loaded base, bit for bit
    else:
        base_tree, adapter_tree = data["base_params"], tree
    jwrap = JaxAdapterWrapper(base=data["unet"], in_channels=1, hidden_channels=8)
    want = np.asarray(jwrap.apply({"params": {"base": base_tree, "adapter": adapter_tree}},
                                  jnp.asarray(data["x"])))
    port = DenoiserWithAdapter(_port_base(data["base_ckpt"]), state.model)
    with torch.no_grad():
        got = port(_nchw(data["x"])).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_memory_cli_adapter_is_served_by_both_e6_clis(data, tmp_path):
    """``finetune_memory`` (int8/uint8 bank, stride 16) writes
    ``epoch_adapter_only_001.ckpt``; JAX's wrapper on it equals the port's
    forward, and the port's E6 CLI over the ``.ckpt`` base serves it with
    the PSNR and IQ-IoU of JAX's E6 CLI on the same files."""
    bank_flags = ["--memory_stride", "16", "--bank_dtype", "int8",
                  "--clean_bank_dtype", "uint8"]
    state = finetune_memory.main(ARGS + bank_flags + [
        "--data_dir", data["root"], "--pretrained_ckpt", data["base_ckpt"],
        "--save_model_path", str(tmp_path)])
    assert int(state.step) == 3
    run = tmp_path / "UNetImproved_memory_adapter_ft"
    adapter_ckpt = str(run / "epoch_adapter_only_001.ckpt")
    assert os.path.exists(adapter_ckpt)
    (val_dir,) = glob.glob(str(run / "val_*_ep001"))
    assert len(glob.glob(os.path.join(val_dir, "*_denoised_full_ep001.png"))) == 1

    paths = [sorted(glob.glob(os.path.join(data["root"], s, "*"))) for s in ("clean", "noise")]
    kw = dict(patch_size=PS, stride=16, bank_dtype="int8", clean_dtype="uint8")
    jb, pb = jax_bank(*paths, **kw), build_memory_bank(*paths, **kw, device="cpu")
    x = data["x"][:, :PS, :PS]
    jwrap = JaxMemWrapper(base=data["unet"], in_channels=1, hidden_channels=8,
                          variant="hyper_gated_fft")
    want = np.asarray(jwrap.apply(
        {"params": {"base": data["base_params"],
                    "adapter": jax_load_checkpoint(adapter_ckpt)}},
        jnp.asarray(x), jb.noise_flat, jb.clean, jb.sq_norms))
    port = DenoiserWithMemoryAdapter(_port_base(data["base_ckpt"]), state.model)
    with torch.no_grad():
        got = port(_nchw(x), pb.noise_flat, pb.clean, pb.sq_norms).numpy()
    np.testing.assert_allclose(got.transpose(0, 2, 3, 1), want, atol=1e-5, rtol=0)

    e6_args = ["--data_dir", data["root"], "--base_ckpt", data["base_ckpt"],
               "--adapter_ckpt", adapter_ckpt, "--n_feature", "8", "--adapter_hidden", "8",
               "--patch_size", str(PS), "--overlap", "16", "--memory_stride", "16",
               "--num_memory_images", "2", "--compute_iq_iou"]
    got = evaluation_704_iqsl_memory.main(e6_args + ["--device", "cpu",
                                                     "--save_dir", str(tmp_path / "port")])
    ref = jax_e6.main(e6_args + ["--save_dir", str(tmp_path / "jax")])
    assert abs(got["psnr"] - ref["psnr"]) <= 0.01
    for k in ("iou_dark", "iou_mid", "iou_bright"):
        assert abs(got[k] - ref[k]) <= 1e-3, k


def test_train_resumes_from_a_jax_ckpt(data, tmp_path):
    """``train --resume x.ckpt`` starts from the JAX file: its epoch-0
    checkpoint is that file, byte for byte."""
    train.main(["--device", "cpu", "--arch", "UNetImproved", "--n_feature", "8",
                "--batchsize", "2", "--n_epoch", "1", "--max_steps_per_epoch", "1",
                "--data_dir", data["root"], "--resume", data["base_ckpt"],
                "--save_model_path", str(tmp_path)])
    (run_dir,) = glob.glob(str(tmp_path / "*" / "*"))
    assert sorted(os.listdir(run_dir)) == ["epoch_model_000.ckpt", "epoch_model_001.ckpt",
                                           "validation"]
    with open(data["base_ckpt"], "rb") as f, \
            open(os.path.join(run_dir, "epoch_model_000.ckpt"), "rb") as g:
        assert f.read() == g.read()
    assert sorted(jax_load_checkpoint(os.path.join(run_dir, "epoch_model_001.ckpt"))) == \
        sorted(data["base_params"])


@pytest.mark.parametrize("cli,flag", [("finetune_memory", "--parallel"),
                                      ("finetune_memory", "--bank_sharded"),
                                      ("finetune", "--parallel"),
                                      ("finetune_iqsl", "--parallel")])
def test_finetune_clis_refuse_multi_device_flags(data, tmp_path, cli, flag, monkeypatch,
                                                 capsys):
    """The multi-device flags, refused until multi-device was ported, now
    run over a mesh of 4 CPU devices. --parallel splits each batch of 4
    (and the tail of 2) over the devices: the adapter after the epoch
    equals the single-device run's within 1e-5, the bound JAX's own
    data-parallel test holds a step to (tests/test_train.py:194-200).
    --bank_sharded keeps the batch whole and retrieves through the sharded
    bank's key merge: the same patches, so the adapter is bit-equal."""
    from _torch_port_helpers import patch_cpu_mesh

    patch_cpu_mesh(monkeypatch, 4)
    main = {"finetune": finetune.main, "finetune_iqsl": finetune_iqsl.main,
            "finetune_memory": finetune_memory.main}[cli]
    args = ARGS + ["--data_dir", data["root"], "--pretrained_ckpt", data["base_ckpt"]]
    if cli == "finetune_memory":
        args += ["--memory_stride", "16"]
    ref = main(args + ["--save_model_path", str(tmp_path / "ref")])
    capsys.readouterr()
    out = main(args + [flag, "--save_model_path", str(tmp_path / "out")])
    said = capsys.readouterr().out
    assert (("data-parallel over 4 devices" in said) == (flag == "--parallel")
            and ("sharded over 4 devices" in said) == (flag == "--bank_sharded"))
    assert int(out.step) == int(ref.step) == 3
    for a, b in zip(out.model.parameters(), ref.model.parameters()):
        if flag == "--bank_sharded":
            assert torch.equal(a, b)
        else:
            np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=1e-5)
            np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), atol=1e-5)


def test_e2_cli_takes_a_ckpt(data, tmp_path):
    """The port's E2 CLI over the JAX-written ``.ckpt`` gives the metrics
    it gives over a ``.pth`` of the same weights (JAX's ``export_pth``)."""
    from image_denoising_tpu.ckpt.pth_export import export_pth
    from image_denoising_tpu_torch.cli import evaluation_704

    pth = export_pth(data["base_params"], "UNetImproved", str(tmp_path / "m.pth"))
    args = ["--data_dir", data["root"], "--n_feature", "8", "--log_name", "UNetImproved",
            "--tile", "32", "--overlap", "16", "--device", "cpu", "--save_images", "none"]
    got = evaluation_704.main(args + ["--checkpoint", data["base_ckpt"],
                                      "--save_dir", str(tmp_path / "ckpt")])
    want = evaluation_704.main(args + ["--checkpoint", pth, "--save_dir", str(tmp_path / "pth")])
    assert got == want


class _FirstBatch(Exception):
    """Raised by the dataset spy once it holds the first batch."""


def _spy_first_batch(monkeypatch, cls, seen):
    """``cls.batches`` records the first batch of the CLI's stream (and
    whether the native sampler drew it), then stops the CLI before a step."""
    orig = cls.batches

    def batches(self, *args, **kwargs):
        native = getattr(self, "native", getattr(self, "_native", None))
        seen.append((native is not None, next(orig(self, *args, **kwargs))))
        raise _FirstBatch

    monkeypatch.setattr(cls, "batches", batches)


@pytest.mark.parametrize("cli", ["finetune", "finetune_iqsl", "finetune_memory"])
def test_first_batch_equals_jax_cli(data, tmp_path, monkeypatch, cli):
    """Each finetune CLI at its defaults receives JAX's CLI's first batch
    at one seed: both take the native sampler on these uint8 frames."""
    import importlib

    from image_denoising_tpu.data import DenoisePatchDataset as JaxPatchDataset
    from image_denoising_tpu_torch.data import DenoisePatchDataset

    jax_main = importlib.import_module(f"image_denoising_tpu.cli.{cli}").main
    port_main = {"finetune": finetune.main, "finetune_iqsl": finetune_iqsl.main,
                 "finetune_memory": finetune_memory.main}[cli]
    args = ARGS + ["--data_dir", data["root"], "--pretrained_ckpt", data["base_ckpt"],
                   "--seed", "7", "--save_model_path", str(tmp_path)]
    if cli == "finetune_memory":
        args += ["--memory_stride", "16"]
    # JAX's CLI compiles its wrapper's init before the loop; its values do
    # not reach the batches, so it runs on the init's shapes uncompiled
    jit = jax.jit

    def no_compile_init(fn, *a, **k):
        if getattr(fn, "__name__", "") != "init":
            return jit(fn, *a, **k)
        return lambda *args: jax.tree_util.tree_map(
            lambda s: jnp.zeros(s.shape, s.dtype), jax.eval_shape(fn, *args))

    monkeypatch.setattr(jax, "jit", no_compile_init)
    seen = []
    _spy_first_batch(monkeypatch, DenoisePatchDataset, seen)
    _spy_first_batch(monkeypatch, JaxPatchDataset, seen)
    for main in (port_main, jax_main):
        with pytest.raises(_FirstBatch):
            main(args)
    (port_native, (pc, pn)), (jax_native, (jc, jn)) = seen
    assert port_native and jax_native
    assert pc.shape == (4, PS, PS, 1) and pc.dtype == np.float32
    np.testing.assert_array_equal(pc, jc)
    np.testing.assert_array_equal(pn, jn)
