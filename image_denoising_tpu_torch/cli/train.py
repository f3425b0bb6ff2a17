"""A-domain trainer CLI — counterpart of ``image_denoising_tpu/cli/train.py``.

The default, ``--loss structure``, is the reference trainer: full-frame
pairs, one concatenated forward of noisy and clean, the Structure loss
(α·L1 + 0.5·TV + 0.5·consistency, α = ``--Lambda1``); its log's ``Loss1``
is L1(network(noisy), clean). ``--loss n2n`` is the Neighbor2Neighbor
self-supervised path: synthetic noise (``--noisetype``), the random 2×2
mask-pair sub-sampler (on the card the hand-written kernel
``csrc/neighbor.cu``, one launch per step) and the Λ-regularized loss.
Both train with Adam(``--lr``), MultiStepLR γ at {20,40,60,80}%·epochs−1,
and write an epoch-0 and per-snapshot checkpoint (``epoch_model_XXX.ckpt``,
the JAX package's params msgpack), validation PNGs and ``A_log.csv``, as
the JAX CLI does. ``--resume`` takes a ``.ckpt`` or a reference-layout
``.pth``. The log lines are the reference's (``Loss1=/Loss_Full=/Time=``),
fetched one step late so the host prepares step i+1 while the card runs
step i.

Same flags as the JAX CLI, plus ``--device {cuda,cpu}``: ``cuda`` runs on
the card ``--gpu_devices`` names (``cuda:N``). ``--dtype bfloat16``
computes in bfloat16 with float32 parameters; ``--remat`` /
``--remat_depth`` recompute blocks in backward; ``--profile_dir`` writes a
``torch.profiler`` trace of the first ``--profile_steps`` steps.
``--arch UNet|RESNET|UNetImproved`` or the ``--log_name`` substring
dispatch picks the network (``UNET``, ``UNET…blindspot``, ``RESNET``,
``UNetImproved``), ``--blindspot`` the blind-spot UNet/RESNET with
``--arch``; the UNet needs H and W divisible by 32, and by 64 for ``--loss
n2n``. ``--parallel`` makes each step data-parallel over the cards (the
``--gpu_devices`` list where it names several, else every visible card;
``train/steps.py``): the batch split over them, the loss and gradient the
whole batch's; without it the trainer runs on the first card of the list.

Run: ``python -m image_denoising_tpu_torch.cli.train --arch UNetImproved
--data_dir data``.
"""
from __future__ import annotations

import argparse
import contextlib
import datetime
import os
import time

import numpy as np
import torch


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--noisetype", type=str, default="gauss25")
    parser.add_argument("--data_dir", type=str, default="data")
    parser.add_argument("--save_model_path", type=str, default="./results")
    parser.add_argument("--log_name", type=str, default="unet_gauss25_b4e100r02")
    parser.add_argument("--gpu_devices", default="0", type=str,
                        help="card index N (cuda:N), or a list '0,1' of the "
                             "cards --parallel uses (the first without it)")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="'cuda': the card --gpu_devices names; 'cpu': "
                             "the plain versions of the kernels")
    parser.add_argument("--parallel", action="store_true",
                        help="data-parallel over the cards")
    parser.add_argument("--n_feature", type=int, default=48)
    parser.add_argument("--n_channel", type=int, default=1)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--gamma", type=float, default=0.5)
    parser.add_argument("--n_epoch", type=int, default=100)
    parser.add_argument("--n_snapshot", type=int, default=1)
    parser.add_argument("--batchsize", type=int, default=4)
    parser.add_argument("--Lambda1", type=float, default=1.0)
    parser.add_argument("--Lambda2", type=float, default=1.0)
    parser.add_argument("--increase_ratio", type=float, default=2.0)
    parser.add_argument("--arch", type=str, default=None,
                        help="explicit arch; default = log_name substring dispatch")
    parser.add_argument("--loss", type=str, default="structure",
                        choices=["structure", "n2n"],
                        help="structure = reference train.py; n2n = "
                             "documented N2N recipe")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--max_steps_per_epoch", type=int, default=0,
                        help="debug/bench cap; 0 = full epoch")
    parser.add_argument("--resume", type=str, default=None,
                        help=".ckpt params or reference-layout .pth to resume "
                             "params from")
    parser.add_argument("--start_epoch", type=int, default=1,
                        help="first epoch number when resuming")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="write a torch.profiler trace of the first "
                             "training steps of the first epoch to this "
                             "directory")
    parser.add_argument("--profile_steps", type=int, default=5)
    parser.add_argument("--subsampler", type=str, default="xla",
                        choices=["xla", "pallas"],
                        help="N2N mask-pair source. Both run the same "
                             "counter-keyed Philox draw: the hand-written "
                             "kernel on the card, its plain version on the "
                             "CPU, bit-equal, so it is reproducible across "
                             "backends")
    from .common import add_blindspot_flag, add_dtype_flag

    add_blindspot_flag(parser)
    add_dtype_flag(parser)
    parser.add_argument("--remat", action=argparse.BooleanOptionalAction,
                        default=False,
                        help="recompute the RDB/Res/Up blocks during backward "
                             "(torch.utils.checkpoint): less device memory, "
                             "more time")
    parser.add_argument("--remat_depth", type=int, default=None,
                        help="recompute only the blocks of the N "
                             "highest-resolution levels. Implies --remat. "
                             "Default: all levels when --remat.")
    opt, _ = parser.parse_known_args(argv)
    if opt.remat_depth is not None:
        # a depth without --remat would be a silent no-op: asking for a
        # depth is asking for remat, as in the JAX CLI
        opt.remat = True
    return opt


def main(argv=None):
    opt = parse_args(argv)
    from .common import cli_device, cli_mesh

    mesh = cli_mesh(opt) if opt.parallel else None
    device = torch.device(cli_device(opt, mesh))
    systime = datetime.datetime.now().strftime("%Y-%m-%d-%H-%M")

    from ..ckpt import save_checkpoint
    from ..data import DenoiseDataset, validation_denoise
    from ..ops import AugmentNoise, OperationSeed
    from ..train import (create_train_state, make_n2n_train_step,
                         make_structure_train_step, multistep_lr,
                         reference_milestones, set_learning_rate)
    from ..utils.profiling import trace
    from .common import build_network, load_params, resolve_dtype, save_png

    dataset = DenoiseDataset(opt.data_dir)
    valid = validation_denoise(opt.data_dir)

    torch.manual_seed(opt.seed)
    network = build_network(opt.arch, opt.log_name, opt.n_channel, opt.n_feature,
                            dtype=resolve_dtype(opt.dtype), remat=opt.remat,
                            remat_depth=opt.remat_depth, blindspot=opt.blindspot)
    if opt.resume:
        load_params(opt.resume, network)
        print(f"Resumed params from {opt.resume}")
    network = network.to(device)
    if mesh is not None:
        print(f"data-parallel over {mesh.size} devices")

    state = create_train_state(network, lr=opt.lr)
    milestones = reference_milestones(opt.n_epoch)
    if opt.loss == "structure":
        step_fn = make_structure_train_step(network, state, alpha=opt.Lambda1,
                                            mesh=mesh)
    else:
        aug = AugmentNoise(opt.noisetype)
        step_fn = make_n2n_train_step(
            network, state, noise_fn=aug.add_train_noise,
            increase_ratio=opt.increase_ratio, n_epoch=opt.n_epoch,
            lambda1=opt.Lambda1, lambda2=opt.Lambda2, mesh=mesh,
        )
    opseeds = OperationSeed(opt.seed)

    save_model_path = os.path.join(opt.save_model_path, opt.log_name, systime)
    save_checkpoint(network, save_model_path, "model", 0)
    print("init finish")
    print(f"Batchsize={opt.batchsize}, number of epoch={opt.n_epoch}")

    rng = np.random.default_rng(opt.seed)
    profiler = contextlib.ExitStack()
    profiling = False

    def flush_metrics(p):
        # reference log format: Loss1 = plain L1(net(noisy), clean)
        # (train.py:369-373); the n2n path reports its rec term instead. The
        # epoch mean + A_log.csv record it (train.py:365-377,434). Under
        # lag-1, Time spans step i's prep start → its metric fetch, which
        # lands after step i+1 is queued: the pipelined per-step interval.
        ep, i, st0, m = p
        loss = float(m["loss"])
        l1_part = float(m["l1"] if "l1" in m else m["loss_rec"])
        losses.append(l1_part)
        print(
            f"{ep:04d} {i:05d} Loss1={l1_part:.6f}, "
            f"Loss_Full={loss:.6f}, Time={time.time() - st0:.4f}"
        )

    for epoch in range(opt.start_epoch, opt.n_epoch + 1):
        epoch_st = time.time()
        lr = multistep_lr(opt.lr, milestones, opt.gamma, epoch)
        set_learning_rate(state, lr)
        print(f"LearningRate of Epoch {epoch} = {lr}")

        losses = []
        pending = None
        for it, (clean, noisy) in enumerate(
            dataset.batches(opt.batchsize, rng, shuffle=True, drop_last=True)
        ):
            if opt.max_steps_per_epoch and it >= opt.max_steps_per_epoch:
                break
            if opt.profile_dir and epoch == opt.start_epoch and it == 0:
                profiler.enter_context(trace(opt.profile_dir))
                profiling = True
            if profiling and it == opt.profile_steps:
                profiler.close()
                profiling = False
                print(f"profiler trace written to {opt.profile_dir}")
            st = time.time()
            if opt.loss == "structure":
                metrics = step_fn(clean, noisy)
            else:
                metrics = step_fn(clean, noisy, opseeds.next(), epoch)
            # lag-1 logging: fetch the previous step's metrics only after
            # queueing this one
            if pending is not None:
                flush_metrics(pending)
            pending = (epoch, it, st, metrics)
        if pending is not None:
            flush_metrics(pending)

        if profiling:
            profiler.close()
            profiling = False
            print(f"profiler trace written to {opt.profile_dir}")

        train_time = time.time() - epoch_st
        mean_loss = float(np.mean(losses)) if losses else float("nan")
        print(f"Training Time/Epoch:{train_time} \n Mean loss:{mean_loss}")

        if epoch % opt.n_snapshot == 0 or epoch == opt.n_epoch:
            eval_st = time.time()
            save_checkpoint(network, save_model_path, "model", epoch)
            validation_path = os.path.join(save_model_path, "validation")
            os.makedirs(validation_path, exist_ok=True)

            for i in range(len(valid[0])):
                clean_np, noisy_np = valid[0][i], valid[1][i]
                clean_name = os.path.basename(valid[2][i]).split(".")[0]
                noise_name = os.path.basename(valid[3][i]).split(".")[0]
                x = np.asarray(noisy_np, np.float32)
                if x.ndim == 2:
                    x = x[..., None]
                with torch.no_grad():
                    pred = network(
                        torch.from_numpy(x).to(device).permute(2, 0, 1)[None] / 255.0)
                pred = pred[0].permute(1, 2, 0).float().cpu().numpy()
                pred = np.clip(pred, 0, 1).squeeze()
                pred255 = np.clip(pred * 255.0 + 0.5, 0, 255).astype(np.uint8)

                if i == 0 and epoch == opt.n_snapshot:
                    save_png(np.asarray(clean_np).astype(np.uint8),
                             os.path.join(validation_path,
                                          f"{clean_name}_{i:03d}-{epoch:03d}_clean.png"))
                    save_png(np.asarray(noisy_np).astype(np.uint8),
                             os.path.join(validation_path,
                                          f"{noise_name}_{i:03d}-{epoch:03d}_noisy.png"))
                if i == 0:
                    save_png(pred255,
                             os.path.join(validation_path,
                                          f"{noise_name}_{i:03d}-{epoch:03d}_denoised.png"))

            with open(os.path.join(validation_path, "A_log.csv"), "a") as f:
                f.write(f"epoch{epoch}, loss_{mean_loss}, train_time_{train_time}\n")
            print(f"Evaluation Time/Epoch:{time.time() - eval_st}")

    return state


if __name__ == "__main__":
    main()
