"""HPO trainer CLI — counterpart of ``image_denoising_tpu/cli/train_opt.py``.

The reference's Optuna flow (``train_opt.py``) on the port's own TPE engine
(``hpo/engine.py``):

* deterministic seeding: ``SEED = 2025``, per-trial ``SEED + trial.number``;
* search space: n_feature ∈ [16, 128] step 16, lr ∈ log[1e-6, 3e-4];
* ImprovedUNet trained with the guarded L1 step (non-finite / loss > 5 /
  grad-norm skip, clip 1.0, Adam with weight decay 1e-5 as coupled L2) on
  grayscale pairs (``DenoiseDataset(convert_l=True)``, [0,255]);
* SQLite study storage (resumable, ``load_if_exists``) and the
  ``trials.log`` JSONL;
* per-trial init-weight snapshots, ``epoch_trial{n}_init_000.ckpt`` in the
  JAX package's ``.ckpt`` format (either package reads the other's), with
  the ``w0_sum`` checksum: the sum of the first leaf of the flax params
  tree in sorted-key order, the same tensor the JAX CLI sums;
* a final retrain from the best trial's snapshot (strict load), MultiStepLR
  at {0.5, 0.75}·n_epoch, ``epoch_final_XXX.ckpt`` every ``--n_snapshot``
  epochs, ``A_log.csv``, and a render every 10 epochs.

Trial placement: trial n runs on the (n mod k)-th of the cards a
``--gpu_devices`` list names (``0,1``: ``cuda:0``, ``cuda:1``, ``cuda:0``,
...), or of every visible card when it names one, inside
``torch.cuda.device(...)`` (with ``--n_jobs`` > 1 each trial's
thread has its own current device), and its ``device`` attribute records
where the model's parameters are. Initial weights come from
``torch.manual_seed(init_seed)`` and torch's default init, which is the
reference's scheme; the random stream differs from JAX's ``PRNGKey``, so
the two packages meet through a shared snapshot. The guard decides on the
device; each epoch's loss sum stays there and is fetched once an epoch,
where JAX reads every step's loss.

Same flags as the JAX CLI, plus ``--device {cuda,cpu}`` (``cuda`` by
default). ``--parallel`` is parsed and has no effect, as in the JAX CLI
(trials, not batches, spread over the cards); the final retrain runs on
the first card of the list.

Run: ``python -m image_denoising_tpu_torch.cli.train_opt --data_dir data``.
"""
from __future__ import annotations

import argparse
import contextlib
import datetime
import json
import os
import threading
import time

import numpy as np
import torch

SEED = 2025
# torch's default init draws from the global generator: one trial at a time
# seeds it and builds its model, so parallel trials get their own weights
_INIT_LOCK = threading.Lock()


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--noisetype", type=str, default="gauss25")
    parser.add_argument("--data_dir", type=str, default="data")
    parser.add_argument("--save_model_path", type=str, default="./results")
    parser.add_argument("--log_name", type=str, default="UNetImproved")
    parser.add_argument("--gpu_devices", default="0", type=str)
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                        help="'cuda': trial n on cuda:{n %% device count}; 'cpu': "
                             "every trial on the CPU")
    parser.add_argument("--parallel", action="store_true",
                        help="accepted for the JAX CLI's launch lines; no effect")
    parser.add_argument("--n_epoch", type=int, default=20)
    parser.add_argument("--n_snapshot", type=int, default=1)
    parser.add_argument("--batchsize", type=int, default=4)
    parser.add_argument("--n_trials", type=int, default=4)
    parser.add_argument("--tune_epochs", type=int, default=1)
    parser.add_argument("--n_jobs", type=int, default=1)
    parser.add_argument("--storage", type=str, default="sqlite:///optuna_unet.db")
    parser.add_argument("--trials_log", type=str, default="trials.log")
    parser.add_argument("--n_channel", type=int, default=1)
    return parser.parse_args(argv)


def seeded_model(n_channel: int, n_feature: int, seed: int):
    """ImprovedUNet with torch's default init from ``torch.manual_seed(seed)``,
    on the CPU."""
    from ..models import ImprovedUNet

    with _INIT_LOCK:
        torch.manual_seed(seed)
        return ImprovedUNet(in_nc=n_channel, out_nc=n_channel, n_feature=n_feature)


def w0_sum(model) -> float:
    """``np.sum`` of the first leaf of the model's flax params tree in
    sorted-key order: the tensor ``jax.tree_util.tree_leaves`` puts first,
    which the JAX CLI sums (for ImprovedUNet ``bottle_rdb/conv0/conv/bias``)."""
    from ..ckpt.io import to_params

    leaf = to_params(model)
    while isinstance(leaf, dict):
        leaf = leaf[min(leaf)]
    return float(np.sum(leaf))


def _device_index(model) -> int:
    """The index of the device the model's parameters are on (0 on the CPU)."""
    return next(model.parameters()).device.index or 0


def run_epoch(step, ds, batchsize: int, rng) -> float:
    """One shuffled epoch of the guarded L1 ``step``: the sum of the kept
    steps' losses over all batches. The sum (float64, as JAX's host sum of
    float32 losses) stays on the device until the epoch's one fetch."""
    total = None
    batches = 0
    for clean, noisy in ds.batches(batchsize, rng, shuffle=True, drop_last=False):
        m = step(clean, noisy)
        kept = torch.where(m["ok"], m["loss"].double(), 0.0)
        total = kept if total is None else total + kept
        batches += 1
    if total is None:
        return 0.0
    return total.item() / max(1, batches)


def train_epochs(model, ds, lr: float, seed: int, epochs: int, milestones,
                 batchsize: int) -> float:
    """Guarded L1 training of ``model`` (on its device) for ``epochs``, the
    batches shuffled by ``np.random.default_rng(seed)``; the last epoch's
    loss (the trial's objective)."""
    from ..train import (create_train_state, make_l1_train_step, multistep_lr,
                         set_learning_rate)

    state = create_train_state(model, lr=lr, weight_decay=1e-5)
    step = make_l1_train_step(model, state, guards=True, grad_clip=1.0, inputs_01=False)
    rng = np.random.default_rng(seed)
    last_loss = None
    for epoch in range(1, epochs + 1):
        set_learning_rate(state, multistep_lr(lr, milestones, 0.5, epoch))
        last_loss = run_epoch(step, ds, batchsize, rng)
    return last_loss


def trial_devices(args):
    """The devices trials take in turn (trial n on the (n mod k)-th): the
    cards a ``--gpu_devices`` list names, or every visible card when it
    names one (``cli_mesh``); ``[cpu]`` for ``--device cpu``. Raises where
    there is no card, before anything is loaded."""
    from .common import cli_mesh

    return list(cli_mesh(args).devices)


def main(argv=None):
    args = parse_args(argv)
    devices = trial_devices(args)
    systime = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M")

    from ..ckpt import save_checkpoint
    from ..data import DenoiseDataset
    from ..hpo import create_study
    from ..train import (create_train_state, hpo_milestones, make_l1_train_step,
                         multistep_lr, set_learning_rate)
    from .common import load_params, save_png

    ds = DenoiseDataset(args.data_dir, convert_l=True)
    print(f"Found {len(ds)} samples")

    snap_dir = os.path.join(args.save_model_path, args.log_name, systime,
                            "trial_init_snapshots")
    os.makedirs(snap_dir, exist_ok=True)

    def objective(trial):
        init_seed = SEED + trial.number
        trial.set_user_attr("init_seed", int(init_seed))
        # per-trial device round-robin, as the reference pins each trial to
        # a GPU (train_opt.py:209-219); the scope is the trial's thread's own
        dev = devices[trial.number % len(devices)]

        n_feature = trial.suggest_int("n_feature", 16, 128, step=16)
        lr = trial.suggest_loguniform("lr", 1e-6, 3e-4)
        tune_epochs = max(1, args.tune_epochs)

        scope = torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()
        with scope:
            model = seeded_model(args.n_channel, n_feature, init_seed).to(dev)
            # the device the parameters landed on, not the one asked for
            trial.set_user_attr("device", _device_index(model))
            # init snapshot for exact reproducibility of the final retrain
            path = save_checkpoint(model, snap_dir, f"trial{trial.number}_init", 0)
            trial.set_user_attr("init_weight_path", path)
            trial.set_user_attr("w0_sum", w0_sum(model))
            loss = train_epochs(model, ds, lr, init_seed, tune_epochs,
                                hpo_milestones(tune_epochs), args.batchsize)
        return float(loss)

    def json_logger(study, trial):
        rec = {
            "trial": trial.number,
            "value": trial.value,
            "params": trial.params,
            "completed": trial.datetime_complete.isoformat(),
            "init_seed": int(trial.user_attrs.get("init_seed", -1)),
            "device": int(trial.user_attrs.get("device", -1)),
        }
        with open(args.trials_log, "a") as f:
            f.write(json.dumps(rec) + "\n")

    study = create_study(study_name="unet_opt", storage=args.storage,
                         load_if_exists=True, direction="minimize")
    study.optimize(objective, n_trials=args.n_trials, n_jobs=args.n_jobs,
                   callbacks=[json_logger])

    best = study.best_trial.params
    print("Best hyperparams:", best)

    # ── final retrain with best-trial parity ────────────────────────────────
    best_seed = int(study.best_trial.user_attrs.get("init_seed", SEED))
    device = devices[0]

    save_dir = os.path.join(args.save_model_path, args.log_name, systime)
    validation_path = os.path.join(save_dir, "validation")
    os.makedirs(validation_path, exist_ok=True)
    log_path = os.path.join(validation_path, "A_log.csv")
    with open(log_path, "a") as f:
        f.write("epoch, loss, train_time\n")

    model = seeded_model(args.n_channel, best["n_feature"], best_seed)
    init_w_path = study.best_trial.user_attrs.get("init_weight_path")
    if init_w_path and os.path.isfile(init_w_path):
        load_params(init_w_path, model)
        print(f"[repro] loaded init snapshot; w0_sum={w0_sum(model):.6f} "
              f"vs trial {study.best_trial.user_attrs.get('w0_sum')}")
    else:
        print("[repro] init snapshot not found; using seeded init.")
    model = model.to(device)

    state = create_train_state(model, lr=best["lr"], weight_decay=1e-5)
    step = make_l1_train_step(model, state, guards=True, grad_clip=1.0, inputs_01=False)
    milestones = [int(0.5 * args.n_epoch), int(0.75 * args.n_epoch)]

    rng = np.random.default_rng(best_seed)
    for epoch in range(1, args.n_epoch + 1):
        start = time.time()
        set_learning_rate(state, multistep_lr(best["lr"], milestones, 0.5, epoch))
        loss = run_epoch(step, ds, args.batchsize, rng)
        train_time = time.time() - start
        print(f"Epoch {epoch}: loss={loss:.4f}, time={train_time:.1f}s")

        if epoch % args.n_snapshot == 0 or epoch == args.n_epoch:
            save_checkpoint(model, save_dir, "final", epoch)
        with open(log_path, "a") as f:
            f.write(f"{epoch}, {loss}, {train_time}\n")

        if epoch % 10 == 0:
            clean_img, noisy_img = ds.get(0)
            x = torch.from_numpy(np.ascontiguousarray(noisy_img / 255.0, np.float32))
            with torch.no_grad():
                pred = model(x.permute(2, 0, 1)[None].to(device))[0]
            pred = pred.permute(1, 2, 0).cpu().numpy()
            pred255 = np.clip(np.clip(pred, 0, 1).squeeze() * 255.0 + 0.5,
                              0, 255).astype(np.uint8)
            noise_name = os.path.splitext(os.path.basename(ds.noise_paths[0]))[0]
            clean_name = os.path.splitext(os.path.basename(ds.clean_paths[0]))[0]
            if epoch == 10:
                save_png(clean_img.squeeze(-1).astype(np.uint8),
                         os.path.join(validation_path,
                                      f"{clean_name}_000-{epoch:03d}_clean.png"))
                save_png(noisy_img.squeeze(-1).astype(np.uint8),
                         os.path.join(validation_path,
                                      f"{noise_name}_000-{epoch:03d}_noisy.png"))
            save_png(pred255,
                     os.path.join(validation_path,
                                  f"{noise_name}_000-{epoch:03d}_denoised.png"))

    return study


if __name__ == "__main__":
    main()
