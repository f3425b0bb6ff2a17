"""The port's train CLI on the CPU: the reference outputs and log lines of
``--loss n2n``, a ``.ckpt`` the JAX package reads, ``--resume``, what the
structure-loss slice's flags do, the JAX CLI's losses from the same
weights and frames, and the flags that wait for later slices."""
import glob
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from image_denoising_tpu.ckpt import load_checkpoint as jax_load_checkpoint
from image_denoising_tpu.models import ImprovedUNet as JaxImprovedUNet
from image_denoising_tpu_torch.ckpt import load_checkpoint
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
    assert names == ["epoch_model_000.ckpt", "epoch_model_001.ckpt",
                     "epoch_model_002.ckpt", "validation"]
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
    path = os.path.join(run_dir, "epoch_model_002.ckpt")
    params = jax_load_checkpoint(path)
    x = np.random.default_rng(0).random((1, 32, 32, 1), dtype=np.float32)
    want = np.asarray(JaxImprovedUNet(in_nc=1, out_nc=1, n_feature=8).apply(
        {"params": params}, jnp.asarray(x)))
    model = ImprovedUNet(1, 1, 8)
    model.load_state_dict(load_checkpoint(path, arch="UNetImproved"), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
        trained = state.model(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got, trained.numpy())


def test_resume_starts_from_the_checkpoint(run, data_dir, tmp_path):
    run_dir, _, _ = run
    path = os.path.join(run_dir, "epoch_model_002.ckpt")
    train.main(ARGS + ["--data_dir", data_dir, "--n_epoch", "1",
                       "--max_steps_per_epoch", "1", "--resume", path,
                       "--save_model_path", str(tmp_path)])
    (first,) = glob.glob(str(tmp_path / "*" / "*" / "epoch_model_000.ckpt"))
    with open(path, "rb") as f, open(first, "rb") as g:
        assert f.read() == g.read()


STEP_LINE = re.compile(r"^(\d{4}) (\d{5}) Loss1=(\d+\.\d{6}), Loss_Full=(\d+\.\d{6}), "
                       r"Time=\d+\.\d{4}$", re.M)


def _first_step_losses(data_dir, run_dir, **flags):
    """(L1, structure loss) of the CLI's first step, recomputed: the epoch-0
    checkpoint in a model built with the run's flags, on the first batch of
    the seed-0 shuffle, as ``make_structure_train_step`` computes them."""
    from image_denoising_tpu_torch.data import DenoiseDataset
    from image_denoising_tpu_torch.losses import l1_loss, structure_loss

    model = ImprovedUNet(1, 1, 8, **flags)
    model.load_state_dict(load_checkpoint(os.path.join(run_dir, "epoch_model_000.ckpt"),
                                          arch="UNetImproved"), strict=True)
    clean, noisy = next(DenoiseDataset(data_dir).batches(2, np.random.default_rng(0),
                                                         shuffle=True, drop_last=True))
    c, n = (torch.from_numpy(a).permute(0, 3, 1, 2) / 255.0 for a in (clean, noisy))
    with torch.no_grad():
        both = model(torch.cat([n, c], 0))
    return float(l1_loss(both[:2], c)), float(structure_loss(both[:2], both[2:], c))


@pytest.mark.parametrize("flags", [
    [],                                    # the default --loss structure
    ["--loss", "structure"],
    ["--dtype", "bfloat16"],
    ["--remat"],
    ["--remat_depth", "2"],
    ["--profile_dir", "trace"],
])
def test_train_cli_accepts_the_structure_slice_flags(data_dir, tmp_path, capsys, flags):
    """One structure-loss step on the CPU with each flag of this slice: the
    logged Loss1/Loss_Full are the recomputed L1 and Structure loss of the
    model the flags build (rtol 1e-5: the same ops, one batch), the model
    computes in bfloat16 with float32 parameters, recomputes the blocks the
    remat flags name, or the trace file is written."""
    if "--profile_dir" in flags:
        flags = ["--profile_dir", str(tmp_path / "trace")]
    state = train.main(["--device", "cpu", "--arch", "UNetImproved", "--n_feature", "8",
                        "--batchsize", "2", "--n_epoch", "1", "--max_steps_per_epoch", "1",
                        "--data_dir", data_dir, "--save_model_path", str(tmp_path / "out")]
                       + flags)
    model = state.model
    want_flags = dict(dtype=torch.bfloat16 if "--dtype" in flags else None,
                      remat="--remat" in flags or "--remat_depth" in flags,
                      remat_depth=2 if "--remat_depth" in flags else None)
    assert (model.dtype, model.remat, model.remat_depth) == tuple(want_flags.values())
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with torch.no_grad():
        out = model(torch.rand(1, 1, 32, 32))
    assert out.dtype == (want_flags["dtype"] or torch.float32)
    assert int(state.step) == 1 and int(state.skipped) == 0
    (run_dir,) = glob.glob(str(tmp_path / "out" / "*" / "*"))
    assert sorted(os.listdir(run_dir)) == ["epoch_model_000.ckpt", "epoch_model_001.ckpt",
                                           "validation"]
    ((_, _, l1, full),) = STEP_LINE.findall(capsys.readouterr().out)
    want_l1, want_full = _first_step_losses(data_dir, run_dir, **want_flags)
    np.testing.assert_allclose([float(l1), float(full)], [want_l1, want_full], rtol=1e-5)
    if "--profile_dir" in flags:
        assert glob.glob(str(tmp_path / "trace" / "*.pt.trace.json"))


def _other_network_matches_jax_cli(data_dir, tmp_path, capsys, flags):
    """``--arch UNet --blindspot`` or ``--arch RESNET``: both CLIs with the
    structure loss, resumed from one JAX-exported ``.pth`` of that network,
    2 steps at batch 2 of 64² frames: the logged Loss1/Loss_Full within
    rtol 1e-4, as test_structure_cli_matches_the_jax_cli holds them, and the
    port's checkpoint of that topology."""
    from image_denoising_tpu.ckpt.pth_export import export_pth
    from image_denoising_tpu.cli import train as jax_train_cli
    from image_denoising_tpu_torch.models import build_model

    from _torch_port_helpers import seeded_network_params

    blindspot = flags == ["--blindspot"]
    arch = "UNet" if blindspot else "RESNET"
    _, params = seeded_network_params(arch, 8, seed=22, blindspot=blindspot)
    pth = export_pth(params, arch, str(tmp_path / "start.pth"))
    common = ["--arch", arch] + (["--blindspot"] if blindspot else []) + [
        "--n_feature", "8", "--batchsize", "2", "--n_epoch", "1",
        "--max_steps_per_epoch", "2", "--seed", "0", "--resume", pth,
        "--data_dir", data_dir]
    lines = {}
    for name, main, extra in (("port", train.main, ["--device", "cpu"]),
                              ("jax", jax_train_cli.main, [])):
        main(common + extra + ["--save_model_path", str(tmp_path / name)])
        lines[name] = STEP_LINE.findall(capsys.readouterr().out)
    assert len(lines["port"]) == len(lines["jax"]) == 2
    got = np.array([[float(a), float(b)] for _, _, a, b in lines["port"]])
    want = np.array([[float(a), float(b)] for _, _, a, b in lines["jax"]])
    np.testing.assert_allclose(got, want, rtol=1e-4)
    (ckpt,) = glob.glob(str(tmp_path / "port" / "*" / "*" / "epoch_model_001.ckpt"))
    model = build_model(arch, 1, 8, blindspot=blindspot)
    model.load_state_dict(load_checkpoint(ckpt, arch=arch), strict=True)
    assert model.nin_a.in_channels == (384 if blindspot else 96)


@pytest.mark.parametrize("flags", [
    ["--parallel"],
    ["--blindspot"],
    ["--arch", "RESNET"],  # a .ckpt --resume is taken now (test_resume_*)
    ["--gpu_devices", "0,1"],
])
def test_train_cli_refuses_flags_of_later_slices(data_dir, data_dir64, tmp_path, capsys,
                                                 flags, monkeypatch):
    """--parallel, refused until multi-device was ported, now makes each
    step data-parallel over a mesh of 4 CPU devices (batch 2: two chunks of
    one): the N2N run's two logged steps equal the single-device run's
    within 1e-5, the bound of JAX's own data-parallel test
    (tests/test_train.py:194-200), and so does every gradient of a step
    (the parameters' ``.grad`` after a one-step run). The parameters are
    not compared: Adam's update g/(|g| + 1e-8) turns the rounding of a
    gradient within 1e-8 of 0 into up to lr of difference. A
    --gpu_devices list runs on its first device (the CPU here): the same
    run. --blindspot (with --arch UNet) and --arch RESNET, refused until
    those networks were ported, now train and match the JAX CLI
    (``_other_network_matches_jax_cli``)."""
    if flags in (["--blindspot"], ["--arch", "RESNET"]):
        _other_network_matches_jax_cli(data_dir64, tmp_path, capsys, flags)
        return
    from _torch_port_helpers import patch_cpu_mesh

    patch_cpu_mesh(monkeypatch, 4)
    args = ["--device", "cpu", "--loss", "n2n", "--data_dir", data_dir, "--arch",
            "UNetImproved", "--n_feature", "8", "--batchsize", "2", "--n_epoch", "1"]
    runs = {}
    for name, extra in (("ref", []), ("out", flags)):
        for steps in ("1", "2"):
            capsys.readouterr()
            state = train.main(args + extra + ["--max_steps_per_epoch", steps,
                                               "--save_model_path",
                                               str(tmp_path / name / steps)])
            said = capsys.readouterr().out
            runs[name, steps] = (state, STEP_LINE.findall(said), said)
    assert ("data-parallel over 4 devices" in runs["out", "2"][2]) == (flags == ["--parallel"])
    lines, lines_ref = runs["out", "2"][1], runs["ref", "2"][1]
    assert len(lines) == len(lines_ref) == 2
    got = np.array([[float(a), float(b)] for _, _, a, b in lines])
    want = np.array([[float(a), float(b)] for _, _, a, b in lines_ref])
    np.testing.assert_allclose(got, want, atol=1e-5)
    for a, b in zip(runs["out", "1"][0].model.parameters(),
                    runs["ref", "1"][0].model.parameters()):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), atol=1e-5)


@pytest.fixture(scope="module")
def data_dir64(tmp_path_factory):
    """5 seeded 64² pairs: a 4×4 bottleneck, where the packages' gradients
    agree to float32 rounding (at 32² GroupNorm groups are too small)."""
    from PIL import Image

    root = tmp_path_factory.mktemp("structdata")
    rng = np.random.default_rng(4)
    yy, xx = np.mgrid[0:64, 0:64]
    for sub in ("clean", "noise"):
        (root / sub).mkdir()
    for i in range(5):
        clean = (120 + 60 * np.sin(xx / 7.0 + i) + 30 * np.cos(yy / 9.0)).clip(0, 255)
        noisy = np.clip(clean + rng.normal(0, 25, clean.shape), 0, 255)
        Image.fromarray(clean.astype(np.uint8)).save(root / "clean" / f"sem{i:02d}.png")
        Image.fromarray(noisy.astype(np.uint8)).save(root / "noise" / f"sem{i:02d}.png")
    return str(root)


def test_structure_cli_matches_the_jax_cli(data_dir64, tmp_path, capsys):
    """Both CLIs with their default structure loss, resumed from one
    JAX-param ``.pth``, on the same frames and seed: 2 steps at batch 2.
    The batch order is the same shuffle of the same seed; the logged
    Loss1/Loss_Full agree within rtol 1e-4 (float32 sums in another order,
    one Adam step apart at step 2; readings: equal in all 6 printed
    decimals)."""
    from image_denoising_tpu.ckpt.pth_export import export_pth
    from image_denoising_tpu.cli import train as jax_train_cli

    from _torch_port_helpers import seeded_improved_unet_params

    _, params = seeded_improved_unet_params(8, seed=21)
    pth = export_pth(params, "UNetImproved", str(tmp_path / "start.pth"))
    common = ["--arch", "UNetImproved", "--n_feature", "8", "--batchsize", "2",
              "--n_epoch", "1", "--max_steps_per_epoch", "2", "--seed", "0",
              "--resume", pth, "--data_dir", data_dir64]
    lines = {}
    for name, main, extra in (("port", train.main, ["--device", "cpu"]),
                              ("jax", jax_train_cli.main, [])):
        main(common + extra + ["--save_model_path", str(tmp_path / name)])
        lines[name] = STEP_LINE.findall(capsys.readouterr().out)
    assert [s[:2] for s in lines["port"]] == [s[:2] for s in lines["jax"]] == [
        ("0001", "00000"), ("0001", "00001")]
    got = np.array([[float(a), float(b)] for _, _, a, b in lines["port"]])
    want = np.array([[float(a), float(b)] for _, _, a, b in lines["jax"]])
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert np.all(got[:, 0] < got[:, 1])  # Loss1 is the L1 part of Loss_Full


def test_train_cli_refuses_other_architectures(data_dir, tmp_path):
    """``UNET`` is the log-name spelling of the UNet: as ``--arch`` it is
    unknown, and both CLIs raise ValueError before writing anything."""
    from image_denoising_tpu.cli import train as jax_train_cli

    args = ["--loss", "n2n", "--arch", "UNET", "--data_dir", data_dir]
    with pytest.raises(ValueError, match="Unknown arch"):
        train.main(args + ["--device", "cpu", "--save_model_path", str(tmp_path / "port")])
    with pytest.raises(ValueError, match="Unknown arch"):
        jax_train_cli.main(args + ["--save_model_path", str(tmp_path / "jax")])
    assert os.listdir(tmp_path) == []

