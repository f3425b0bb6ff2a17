"""Memory-adapter finetune CLI — counterpart of
``image_denoising_tpu/cli/finetune_memory.py`` (reference ``finetune_memory.py``).

A memory bank from the first ``--num_memory_images`` pairs (patch
``--patch_size``, stride ``--memory_stride``), a frozen base and a
``DenoiserWithMemoryAdapter`` (the v5 hyper-gated FFT adapter by default,
``--adapter_variant`` picks v1–v5), trained on random patch pairs with
L1 + λ_grad·gradient + λ_iqsl·IQSL; Adam covers the adapter only. Each
epoch (every ``--save_every``) writes ``epoch_adapter_only_XXX.ckpt`` and
validates on the first 10 pairs with the Hann² tiled engine (overlap =
patch_size // 2, retrieval hoisted out of the tile chunks).

On a CUDA device the base is ``make_forward`` (for an ImprovedUNet every
level block through the chain kernel; ``--arch UNet`` or ``RESNET`` runs
that module), built once since the base never changes, and
each training step retrieves its batch's bank patches with the top-1
kernel inside the forward; nothing falls back to the CPU.

Same flags as the JAX CLI, plus ``--device {cuda,cpu}``: ``cuda`` runs on
the first card ``--gpu_devices`` names (``cuda:N``). ``--parallel`` splits
each batch over the cards (the ``--gpu_devices`` list where it names
several, else every visible card), each with its own copy of the base and
the adapter, after one retrieval over the whole batch. ``--bank_sharded``
splits both banks over the cards (``memory/sharded.py``: one retrieval
launch per shard, the whole bank's patches); the batch then stays whole,
as in JAX, so with both flags ``--parallel`` adds no batch split.

Run: ``python -m image_denoising_tpu_torch.cli.finetune_memory --data_dir d
--pretrained_ckpt model.ckpt``.
"""
from __future__ import annotations

import argparse
import datetime
import os
import time

import numpy as np
import torch

from ..adapters.memory_adapters import MEMORY_ADAPTERS


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_dir", type=str, required=True)
    parser.add_argument("--pretrained_ckpt", type=str, required=True,
                        help="base checkpoint (.ckpt or reference-layout .pth)")
    parser.add_argument("--arch", type=str, default="UNetImproved",
                        choices=["UNet", "RESNET", "UNetImproved"])
    parser.add_argument("--save_model_path", type=str, default="./results_ft")
    parser.add_argument("--log_name", type=str, default="UNetImproved_memory_adapter_ft")
    parser.add_argument("--gpu_devices", default="0", type=str,
                        help="card index N (cuda:N), or a list '0,1' of the "
                             "cards --parallel uses (the first without it)")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                        help="'cuda': the card --gpu_devices names; 'cpu': "
                             "the plain versions of the kernels")
    parser.add_argument("--parallel", action="store_true",
                        help="data-parallel over the cards")
    parser.add_argument("--n_feature", type=int, default=48)
    parser.add_argument("--n_channel", type=int, default=1)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--n_epoch", type=int, default=20)
    parser.add_argument("--batchsize", type=int, default=4)
    parser.add_argument("--num_workers", type=int, default=4)
    parser.add_argument("--adapter_hidden", type=int, default=16)
    parser.add_argument("--lambda_grad", type=float, default=0.1)
    parser.add_argument("--save_every", type=int, default=1)
    parser.add_argument("--patch_size", type=int, default=128)
    parser.add_argument("--patches_per_image", type=int, default=16)
    parser.add_argument("--num_memory_images", type=int, default=5)
    parser.add_argument("--memory_stride", type=int, default=64)
    parser.add_argument("--lambda_iqsl", type=float, default=0.1)
    parser.add_argument("--iqsl_q1", type=float, default=0.2)
    parser.add_argument("--iqsl_q2", type=float, default=0.8)
    parser.add_argument("--iqsl_tau", type=float, default=0.1)
    parser.add_argument("--iqsl_margin", type=float, default=0.0)
    parser.add_argument("--iqsl_max_images", type=int, default=50)
    parser.add_argument("--iqsl_ce_factor", type=float, default=0.5)
    parser.add_argument("--adapter_variant", type=str, default="hyper_gated_fft",
                        choices=list(MEMORY_ADAPTERS),
                        help="v1–v5; the reference hard-codes v5")
    parser.add_argument("--pallas_retrieval", action="store_true",
                        help="pad the bank to a multiple of 512 rows, as the "
                             "TPU kernel's tile grid needs. On a CUDA device "
                             "retrieval always runs the top-1 kernel; this "
                             "flag changes only the padding")
    parser.add_argument("--bank_sharded", action="store_true",
                        help="shard BOTH banks over the cards: each scans its "
                             "1/k with the retrieval kernel; the batch stays "
                             "whole, so --parallel adds no batch split")
    parser.add_argument("--bank_dtype", type=str, default="float32",
                        choices=["float32", "bfloat16", "int8"],
                        help="noise-bank storage dtype. bf16 halves the "
                             "memory; int8 quarters it and computes exact "
                             "integer distances (uint8-sourced patches)")
    parser.add_argument("--clean_bank_dtype", type=str, default="float32",
                        choices=["float32", "uint8"],
                        help="clean-bank storage dtype. uint8 stores the "
                             "source bytes (lossless for uint8 frames) at 4x "
                             "less memory")
    parser.add_argument("--seed", type=int, default=0)
    from .common import add_dtype_flag

    add_dtype_flag(parser)
    args, _ = parser.parse_known_args(argv)
    return args


def main(argv=None):
    opt = parse_args(argv)
    from .common import cli_device, cli_mesh

    mesh = cli_mesh(opt) if opt.parallel or opt.bank_sharded else None
    device = torch.device(cli_device(opt, mesh))
    systime = datetime.datetime.now().strftime("%Y-%m-%d-%H-%M")

    from ..adapters import DenoiserWithMemoryAdapter, build_memory_adapter
    from ..ckpt import save_checkpoint
    from ..data import DenoisePatchDataset, list_pairs, validation_denoise
    from ..eval.tiled import make_tiled_hann_runner
    from ..memory import build_memory_bank, make_ring_retrieval, shard_bank
    from ..metrics import calculate_psnr
    from ..train import create_train_state, make_memory_finetune_step
    from .common import iqsl_config, load_frozen_base, run_epoch, save_png
    from .evaluation_704_iqsl_memory import make_memory_model_call

    train_dataset = DenoisePatchDataset(opt.data_dir, patch_size=opt.patch_size,
                                        patches_per_image=opt.patches_per_image)
    valid = validation_denoise(opt.data_dir, limit=10)
    iqsl_cfg = iqsl_config(opt)

    clean_all, noise_all = list_pairs(opt.data_dir)
    num_mem = min(opt.num_memory_images, len(clean_all))
    bank = build_memory_bank(
        clean_all[:num_mem], noise_all[:num_mem], patch_size=opt.patch_size,
        stride=opt.memory_stride, bank_dtype=opt.bank_dtype,
        clean_dtype=opt.clean_bank_dtype, pad_to=512 if opt.pallas_retrieval else 0,
        device=device)

    # batch DP only without a sharded bank: with one the batch stays whole,
    # and so does the base's forward of it
    dp_mesh = mesh if opt.parallel and not opt.bank_sharded else None
    _, base_fwd = load_frozen_base(opt, device, dp_mesh)
    if opt.parallel:
        print(f"data-parallel over {mesh.size} devices")
    retrieval_fn = None
    if opt.bank_sharded:
        # the training batches (and the validation's tile chunks) are small
        # and stay whole; only the BANKS shard, each card scanning its 1/k
        bank = shard_bank(bank, mesh)
        retrieval_fn = make_ring_retrieval(mesh, queries_sharded=False)
        print(f"memory bank sharded over {mesh.size} devices "
              f"(~{bank.noise_flat[0].nbytes / 1e6:.1f} MB noise bank per device)")
        if opt.parallel:
            print("[bank_sharded] training batch stays replicated (the ring "
                  "replicates queries; only banks shard) — --parallel adds "
                  "no batch DP here")
    torch.manual_seed(opt.seed)
    adapter = build_memory_adapter(opt.adapter_variant, opt.n_channel,
                                   opt.adapter_hidden).to(device)
    wrapper = DenoiserWithMemoryAdapter(base_fwd, adapter, retrieval_fn)
    state = create_train_state(adapter, lr=opt.lr)
    step = make_memory_finetune_step(
        wrapper, state, lambda_grad=opt.lambda_grad, lambda_iqsl=opt.lambda_iqsl,
        iqsl_cfg=iqsl_cfg, mesh=dp_mesh)

    print(
        f"==> Start finetuning with MEMORY adapter + patches + IQSL. "
        f"Num epochs={opt.n_epoch}, batchsize={opt.batchsize}, lr={opt.lr}, "
        f"lambda_grad={opt.lambda_grad}, lambda_iqsl={opt.lambda_iqsl}, "
        f"patch_size={opt.patch_size}, patches_per_image={opt.patches_per_image}, "
        f"num_memory_images={num_mem}, memory_stride={opt.memory_stride}, "
        f"adapter_variant={opt.adapter_variant}"
    )

    save_root = os.path.join(opt.save_model_path, opt.log_name)
    rng = np.random.default_rng(opt.seed)
    # validation: the hoisted retrieval (one bank pass per frame) and the
    # Hann runner, one per frame shape, reused across epochs
    model_call, pre_tile_fn = make_memory_model_call(wrapper, bank, opt.n_channel,
                                                     retrieval_chunk=128)
    runners = {}

    for epoch in range(1, opt.n_epoch + 1):
        epoch_st = time.time()
        losses_l1, losses_iqsl = run_epoch(
            step, train_dataset.batches(opt.batchsize, rng), epoch, opt.n_epoch,
            bank.noise_flat, bank.clean, bank.sq_norms)
        print(f"End of epoch {epoch}, mean L1={np.mean(losses_l1):.6f}, "
              f"mean IQSL={np.mean(losses_iqsl):.6f}, "
              f"time={time.time() - epoch_st:.2f}s")

        if epoch % opt.save_every == 0 or epoch == opt.n_epoch:
            save_checkpoint(adapter, save_root, "adapter_only", epoch)
            save_dir = os.path.join(save_root, f"val_{systime}_ep{epoch:03d}")
            os.makedirs(save_dir, exist_ok=True)
            for i, (clean_np, noisy_np) in enumerate(zip(valid[0], valid[1])):
                noisy_name = os.path.basename(valid[3][i]).split(".")[0]
                frame = np.asarray(noisy_np)
                frame = frame[..., 0] if frame.ndim == 3 else frame
                run = runners.get(frame.shape)
                if run is None:
                    run = runners[frame.shape] = make_tiled_hann_runner(
                        model_call, *frame.shape, ps=opt.patch_size,
                        overlap=opt.patch_size // 2, batch=-8,
                        out_dtype="uint8_round", pre_tile_fn=pre_tile_fn, device=device)
                pred255 = run(frame).cpu().numpy()
                psnr = calculate_psnr(pred255, np.asarray(clean_np), zero_mse_psnr=99.0)
                if i == min(6, len(valid[0]) - 1):
                    print(f"Val ep{epoch}: psnr={psnr:.2f} dB")
                    save_png(pred255, os.path.join(
                        save_dir, f"{noisy_name}_denoised_full_ep{epoch:03d}.png"), mode="L")

    print("Finetuning (memory adapter) complete.")
    return state


if __name__ == "__main__":
    main()
