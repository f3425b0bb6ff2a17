"""The port's train CLI (``--loss n2n``) on the CPU: the reference outputs and
log lines, a ``.pth`` the JAX package reads, ``--resume``, and the flags
that wait for later slices."""
import glob
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from image_denoising_tpu.ckpt import load_checkpoint as jax_load_checkpoint
from image_denoising_tpu.models import ImprovedUNet as JaxImprovedUNet
from image_denoising_tpu_torch.cli import train
from image_denoising_tpu_torch.models import ImprovedUNet

from _torch_port_helpers import one_torch_thread  # noqa: F401

ARGS = ["--device", "cpu", "--loss", "n2n", "--arch", "UNetImproved",
        "--n_feature", "8", "--max_steps_per_epoch", "2", "--batchsize", "2"]


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("n2ndata")
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:32, 0:32]
    for sub in ("clean", "noise"):
        (root / sub).mkdir()
    for i in range(5):
        clean = (120 + 60 * np.sin(xx / 5.0 + i) + 30 * np.cos(yy / 7.0)).clip(0, 255)
        noisy = np.clip(clean + rng.normal(0, 20, clean.shape), 0, 255)
        Image.fromarray(clean.astype(np.uint8)).save(root / "clean" / f"sem{i:02d}.png")
        Image.fromarray(noisy.astype(np.uint8)).save(root / "noise" / f"sem{i:02d}.png")
    return str(root)


@pytest.fixture(scope="module")
def run(data_dir, tmp_path_factory):
    """One CLI run of 2 epochs of 2 steps: (run dir, stdout, returned state)."""
    import contextlib
    import io

    out = tmp_path_factory.mktemp("n2nrun")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        state = train.main(ARGS + ["--data_dir", data_dir, "--n_epoch", "2",
                                   "--save_model_path", str(out)])
    (run_dir,) = glob.glob(str(out / "unet_gauss25_b4e100r02" / "*"))
    return run_dir, buf.getvalue(), state


def test_train_cli_writes_the_reference_outputs(run):
    run_dir, _, state = run
    assert state.step == 4
    names = sorted(os.listdir(run_dir))
    assert names == ["epoch_model_000.pth", "epoch_model_001.pth",
                     "epoch_model_002.pth", "validation"]
    assert sorted(os.listdir(os.path.join(run_dir, "validation"))) == [
        "A_log.csv", "sem00_000-001_clean.png", "sem00_000-001_denoised.png",
        "sem00_000-001_noisy.png", "sem00_000-002_denoised.png"]
    with open(os.path.join(run_dir, "validation", "A_log.csv")) as f:
        rows = f.read().splitlines()
    assert len(rows) == 2
    for epoch, row in enumerate(rows, start=1):
        m = re.fullmatch(rf"epoch{epoch}, loss_([0-9.e-]+), train_time_([0-9.e-]+)", row)
        assert m and np.isfinite(float(m.group(1))), row


def test_train_cli_prints_the_reference_log_lines(run):
    _, stdout, _ = run
    assert "init finish" in stdout
    assert "Batchsize=2, number of epoch=2" in stdout
    # n_epoch 2: milestones int(p·0.02)−1 = [−1, −1, 0, 0]; 0 fires twice
    # from the start, as torch's MultiStepLR and the JAX CLI do: 3e-4 · 0.5²
    assert "LearningRate of Epoch 1 = 7.5e-05" in stdout
    assert "LearningRate of Epoch 2 = 7.5e-05" in stdout
    steps = re.findall(r"^(\d{4}) (\d{5}) Loss1=(\d+\.\d{6}), Loss_Full=(\d+\.\d{6}), "
                       r"Time=\d+\.\d{4}$", stdout, flags=re.M)
    assert [(e, i) for e, i, _, _ in steps] == [("0001", "00000"), ("0001", "00001"),
                                                ("0002", "00000"), ("0002", "00001")]
    for _, _, rec, full in steps:
        assert 0 < float(rec) <= float(full)  # Loss1 is the rec term of Loss_Full
    assert stdout.count("Training Time/Epoch:") == 2
    assert stdout.count("Evaluation Time/Epoch:") == 2


def test_checkpoint_loads_in_the_jax_package(run):
    """The port's epoch checkpoint through JAX's load_checkpoint gives the
    port's forward (float32 sums in another order: atol 1e-5)."""
    run_dir, _, state = run
    path = os.path.join(run_dir, "epoch_model_002.pth")
    params = jax_load_checkpoint(path, arch="UNetImproved")
    x = np.random.default_rng(0).random((1, 32, 32, 1), dtype=np.float32)
    want = np.asarray(JaxImprovedUNet(in_nc=1, out_nc=1, n_feature=8).apply(
        {"params": params}, jnp.asarray(x)))
    model = ImprovedUNet(1, 1, 8)
    model.load_state_dict(torch.load(path, weights_only=True), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
        trained = state.model(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got, trained.numpy())


def test_resume_starts_from_the_checkpoint(run, data_dir, tmp_path):
    run_dir, _, _ = run
    path = os.path.join(run_dir, "epoch_model_002.pth")
    train.main(ARGS + ["--data_dir", data_dir, "--n_epoch", "1",
                       "--max_steps_per_epoch", "1", "--resume", path,
                       "--save_model_path", str(tmp_path)])
    (first,) = glob.glob(str(tmp_path / "*" / "*" / "epoch_model_000.pth"))
    a, b = torch.load(path, weights_only=True), torch.load(first, weights_only=True)
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("flags", [
    [],                                    # the default --loss structure
    ["--loss", "structure"],
    ["--dtype", "bfloat16"],
    ["--remat"],
    ["--remat_depth", "2"],
    ["--parallel"],
    ["--blindspot"],
    ["--profile_dir", "trace"],
    ["--resume", "model.ckpt"],
    ["--gpu_devices", "0,1"],
])
def test_train_cli_refuses_flags_of_later_slices(data_dir, tmp_path, flags):
    args = ["--device", "cpu", "--data_dir", data_dir, "--save_model_path", str(tmp_path)]
    if flags[:1] != ["--loss"] and flags:
        args += ["--loss", "n2n"]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train.main(args + flags)
    assert os.listdir(tmp_path) == []


def test_train_cli_refuses_other_architectures(data_dir, tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train.main(["--device", "cpu", "--loss", "n2n", "--arch", "UNET",
                    "--data_dir", data_dir, "--save_model_path", str(tmp_path)])

