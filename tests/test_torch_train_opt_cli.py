"""The port's HPO trainer (cli/train_opt.py) on the CPU: the CLI end to end
(2 trials on 48² frames, then the final retrain), its init snapshots read
by the JAX package and their ``w0_sum`` against JAX's first flax leaf, a
trial's loss reproduced from its snapshot, the tuning loop against the JAX
package's from one shared snapshot, and the refused ``--parallel``."""
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from image_denoising_tpu import train as jax_train
from image_denoising_tpu.ckpt import load_checkpoint as jax_load_checkpoint
from image_denoising_tpu.ckpt.io import np_tree
from image_denoising_tpu.ckpt.pth_export import params_to_state_dict as jax_params_to_state_dict
from image_denoising_tpu.data import DenoiseDataset as JaxDenoiseDataset
from image_denoising_tpu.models import ImprovedUNet as JaxImprovedUNet
from image_denoising_tpu_torch.ckpt import save_checkpoint
from image_denoising_tpu_torch.cli import train_opt
from image_denoising_tpu_torch.data import DenoiseDataset
from image_denoising_tpu_torch.models import ImprovedUNet
from image_denoising_tpu_torch.train import hpo_milestones

from _torch_port_helpers import one_torch_thread  # noqa: F401


def _png_pairs(root, count, size, seed):
    from PIL import Image

    rng = np.random.default_rng(seed)
    for sub in ("clean", "noise"):
        (root / sub).mkdir(parents=True)
    for i in range(count):
        clean = rng.integers(60, 200, (size, size)).astype(np.uint8)
        noisy = np.clip(clean + rng.normal(0, 10, clean.shape), 0, 255).astype(np.uint8)
        Image.fromarray(clean).save(root / "clean" / f"im_{i}.png")
        Image.fromarray(noisy).save(root / "noise" / f"im_{i}.png")


@pytest.fixture(scope="module")
def hpo_run(tmp_path_factory):
    """2 trials of 1 tuning epoch and a 1-epoch retrain on 2 pairs of 48²."""
    tmp = tmp_path_factory.mktemp("hpo")
    _png_pairs(tmp / "data", 2, 48, 3)
    study = train_opt.main([
        "--data_dir", str(tmp / "data"), "--save_model_path", str(tmp / "results"),
        "--log_name", "hpo_test", "--n_trials", "2", "--tune_epochs", "1",
        "--n_epoch", "1", "--batchsize", "2", "--device", "cpu",
        "--storage", f"sqlite:///{tmp}/optuna_unet.db",
        "--trials_log", str(tmp / "trials.log")])
    (run_dir,) = glob.glob(str(tmp / "results" / "hpo_test" / "*"))
    return dict(study=study, tmp=tmp, run_dir=run_dir)


def test_cli_writes_the_study_and_its_files(hpo_run):
    study, run_dir = hpo_run["study"], hpo_run["run_dir"]
    assert len(study.trials) == 2 and all(np.isfinite(t.value) for t in study.trials)
    assert sorted(os.listdir(os.path.join(run_dir, "trial_init_snapshots"))) == [
        "epoch_trial0_init_000.ckpt", "epoch_trial1_init_000.ckpt"]
    assert os.path.isfile(os.path.join(run_dir, "epoch_final_001.ckpt"))
    for t in study.trials:
        assert t.user_attrs["init_seed"] == train_opt.SEED + t.number
        assert t.user_attrs["device"] == 0
        assert t.params["n_feature"] in range(16, 129, 16)
        assert 1e-6 <= t.params["lr"] <= 3e-4
        assert os.path.isfile(t.user_attrs["init_weight_path"])
    recs = [json.loads(line) for line in open(hpo_run["tmp"] / "trials.log")]
    assert [r["trial"] for r in recs] == [0, 1]
    for r, t in zip(recs, study.trials):
        assert set(r) == {"trial", "value", "params", "completed", "init_seed", "device"}
        assert r["value"] == t.value and r["params"] == t.params and r["device"] == 0
    with open(os.path.join(run_dir, "validation", "A_log.csv")) as f:
        rows = f.read().strip().splitlines()
    assert rows[0] == "epoch, loss, train_time"
    assert len(rows) == 2 and rows[1].startswith("1, ")
    assert all(np.isfinite(float(v)) for v in rows[1].split(", "))


def test_study_resumes_from_storage(hpo_run):
    """The study's SQLite file holds both trials, with their attributes."""
    from image_denoising_tpu_torch.hpo import create_study

    study = create_study("unet_opt", storage=f"sqlite:///{hpo_run['tmp']}/optuna_unet.db")
    assert [(t.number, t.params, t.value, t.user_attrs) for t in study.trials] == \
        [(t.number, t.params, t.value, t.user_attrs) for t in hpo_run["study"].trials]


@pytest.mark.parametrize("trial", [0, 1])
def test_snapshot_loads_in_jax(hpo_run, trial):
    """The JAX package reads the port's init snapshot; through JAX's own
    params map it equals the port's seeded init, and its first flax leaf
    sums to the trial's ``w0_sum``, exactly."""
    t = hpo_run["study"].trials[trial]
    params = jax_load_checkpoint(t.user_attrs["init_weight_path"])
    model = train_opt.seeded_model(1, t.params["n_feature"], t.user_attrs["init_seed"])
    want = model.state_dict()
    got = jax_params_to_state_dict(params, "UNetImproved")
    assert set(got) == set(want)
    for k, v in got.items():
        np.testing.assert_array_equal(np.asarray(v), want[k].numpy(), err_msg=k)
    w0 = jax.tree_util.tree_leaves(np_tree(params))[0]
    assert float(np.sum(w0)) == t.user_attrs["w0_sum"] == train_opt.w0_sum(model)
    # the leaf is the one the module docstring names
    np.testing.assert_array_equal(w0, params["bottle_rdb"]["conv0"]["conv"]["bias"])


def test_trial_loss_reproduces_from_its_snapshot(hpo_run):
    """Trial 0 trained again from its snapshot, with its seed, gives its
    objective bit for bit on the CPU."""
    from image_denoising_tpu_torch.cli.common import load_params

    t = hpo_run["study"].trials[0]
    model = load_params(t.user_attrs["init_weight_path"], ImprovedUNet(1, 1, t.params["n_feature"]))
    ds = DenoiseDataset(str(hpo_run["tmp"] / "data"), convert_l=True)
    loss = train_opt.train_epochs(model, ds, t.params["lr"], t.user_attrs["init_seed"], 1,
                                  hpo_milestones(1), 2)
    assert loss == t.value


def test_tuning_matches_jax_from_a_shared_snapshot(tmp_path):
    """2 tuning epochs (2 steps of batch 2 each, the lr halved in epoch 2)
    of ImprovedUNet-16 from one snapshot the port wrote: the port's
    ``train_epochs`` and the JAX CLI's loop (float32, guards, clip 1.0,
    coupled weight decay) give each epoch's loss within rtol 1e-4 (float32
    sums in another order, carried by Adam)."""
    nf, lr, seed, epochs = 16, 1e-4, 7, 2
    _png_pairs(tmp_path / "data", 4, 48, 5)
    model = train_opt.seeded_model(1, nf, seed)
    snap = save_checkpoint(model, str(tmp_path), "trial0_init", 0)
    ds = DenoiseDataset(str(tmp_path / "data"), convert_l=True)
    milestones = hpo_milestones(epochs)
    assert milestones == [1]

    got = []
    from image_denoising_tpu_torch.train import (create_train_state, make_l1_train_step,
                                                 multistep_lr, set_learning_rate)

    state = create_train_state(model, lr=lr, weight_decay=1e-5)
    step = make_l1_train_step(model, state, guards=True, grad_clip=1.0, inputs_01=False)
    rng = np.random.default_rng(seed)
    for epoch in range(1, epochs + 1):
        set_learning_rate(state, multistep_lr(lr, milestones, 0.5, epoch))
        kept_before = int(state.step)
        loss = train_opt.run_epoch(step, ds, 2, rng)
        got.append((loss, int(state.step) - kept_before))  # the kept steps' count
    # train_epochs is that loop, returning the last epoch's loss
    again = train_opt.train_epochs(train_opt.seeded_model(1, nf, seed), ds, lr, seed, epochs,
                                   milestones, 2)
    assert again == got[-1][0]

    jax_ds = JaxDenoiseDataset(str(tmp_path / "data"), convert_l=True)
    jstate = jax_train.create_train_state(jax_load_checkpoint(snap), lr=lr, weight_decay=1e-5)
    jstep = jax_train.make_l1_train_step(JaxImprovedUNet(1, 1, nf).apply, guards=True,
                                         grad_clip=1.0, inputs_01=False)
    rng = np.random.default_rng(seed)
    want = []
    for epoch in range(1, epochs + 1):
        jstate = jax_train.set_learning_rate(
            jstate, jax_train.multistep_lr(lr, milestones, 0.5, epoch))
        total, batches, kept = 0.0, 0, 0
        for clean, noisy in jax_ds.batches(2, rng, shuffle=True, drop_last=False):
            jstate, m = jstep(jstate, jnp.asarray(clean), jnp.asarray(noisy))
            if bool(m["ok"]):
                total += float(m["loss"])
                kept += 1
            batches += 1
        want.append((total / max(1, batches), kept))
    assert [k for _, k in got] == [k for _, k in want] == [2, 2]
    np.testing.assert_allclose([g for g, _ in got], [w for w, _ in want], rtol=1e-4)


def test_two_jobs_train_trials_in_threads(tmp_path):
    """--n_jobs 2: both trials run at once in their own threads; each
    snapshot is its trial's own seeded init, as in a sequential run."""
    _png_pairs(tmp_path / "data", 2, 48, 4)
    study = train_opt.main([
        "--data_dir", str(tmp_path / "data"), "--save_model_path", str(tmp_path / "results"),
        "--n_trials", "2", "--n_jobs", "2", "--tune_epochs", "1", "--n_epoch", "1",
        "--batchsize", "2", "--device", "cpu", "--storage", f"sqlite:///{tmp_path}/jobs.db",
        "--trials_log", str(tmp_path / "trials.log")])
    assert sorted(t.number for t in study.trials) == [0, 1]
    for t in study.trials:
        assert np.isfinite(t.value) and t.user_attrs["device"] == 0
        want = train_opt.seeded_model(1, t.params["n_feature"], train_opt.SEED + t.number)
        params = jax_load_checkpoint(t.user_attrs["init_weight_path"])
        for k, v in jax_params_to_state_dict(params, "UNetImproved").items():
            np.testing.assert_array_equal(np.asarray(v), want.state_dict()[k].numpy(), err_msg=k)
        assert t.user_attrs["w0_sum"] == train_opt.w0_sum(want)
    assert len(open(tmp_path / "trials.log").read().splitlines()) == 2


def test_parallel_is_refused(tmp_path):
    for flags in (["--parallel"], ["--gpu_devices", "0,1"]):
        with pytest.raises(NotImplementedError, match="not ported"):
            train_opt.main(["--data_dir", str(tmp_path), "--device", "cpu", *flags])
