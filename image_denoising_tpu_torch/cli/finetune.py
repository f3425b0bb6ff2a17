"""Adapter finetune CLI — counterpart of ``image_denoising_tpu/cli/finetune.py``
(reference ``finetune.py``).

B-domain transfer: a frozen A-domain base and a small trainable
``OutputAdapter`` on random ``--patch_size`` patch pairs from the first 5
images, loss L1 + λ_grad·gradient, Adam(``--lr``) over the adapter only.
Each epoch (every ``--save_every``) writes the full wrapper tree
``{"base": …, "adapter": …}`` as ``epoch_adapter_XXX.ckpt`` and validates
with a whole-frame forward and PSNR. ``cli/finetune_iqsl.py`` runs the
same loop with the IQSL term (``train_adapter(opt, iqsl=True)``).

On a CUDA device the base is ``make_forward``, built once: for an
ImprovedUNet the training batches and the whole validation frames run
every level block through the chain kernel; ``--arch UNet`` or ``RESNET``
runs that module. Same flags as the JAX CLI, plus ``--device
{cuda,cpu}``. ``--parallel`` splits each batch over the cards (the
``--gpu_devices`` list where it names several, else every visible card):
each runs its own copy of the base and the adapter on its share, and the
loss and its gradient are the whole batch's.

Run: ``python -m image_denoising_tpu_torch.cli.finetune --data_dir d
--pretrained_ckpt model.ckpt``.
"""
from __future__ import annotations

import argparse
import datetime
import os
import time

import numpy as np
import torch



def parse_args(argv=None, iqsl: bool = False):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_dir", type=str, required=True,
                        help="B-domain root with clean/ and noise/ subfolders.")
    parser.add_argument("--pretrained_ckpt", type=str, required=True,
                        help="A-domain base checkpoint (.ckpt or .pth)")
    parser.add_argument("--arch", type=str, default="UNetImproved",
                        choices=["UNet", "RESNET", "UNetImproved"])
    parser.add_argument("--save_model_path", type=str, default="./results_ft")
    parser.add_argument("--log_name", type=str,
                        default="UNetImproved_adapter_iqsl_ft" if iqsl
                        else "UNetImproved_adapter_ft")
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
    if iqsl:
        parser.add_argument("--lambda_iqsl", type=float, default=0.1)
        parser.add_argument("--iqsl_q1", type=float, default=0.2)
        parser.add_argument("--iqsl_q2", type=float, default=0.8)
        parser.add_argument("--iqsl_tau", type=float, default=0.1)
        parser.add_argument("--iqsl_margin", type=float, default=0.0)
        parser.add_argument("--iqsl_max_images", type=int, default=50)
        parser.add_argument("--iqsl_ce_factor", type=float, default=0.5)
    parser.add_argument("--seed", type=int, default=0)
    from .common import add_dtype_flag

    add_dtype_flag(parser)
    args, _ = parser.parse_known_args(argv)
    return args


def train_adapter(opt, iqsl: bool = False):
    """The finetune loop of ``finetune.py`` (``iqsl=False``: L1 + gradient,
    all pairs validated, ``epoch_adapter`` files) or ``finetune_iqsl.py``
    (``iqsl=True``: + IQSL, the first 10 pairs validated,
    ``epoch_adapter_only`` files). Returns the train state."""
    from .common import cli_device, cli_mesh

    mesh = cli_mesh(opt) if opt.parallel else None
    device = torch.device(cli_device(opt, mesh))
    systime = datetime.datetime.now().strftime("%Y-%m-%d-%H-%M")

    from ..adapters import DenoiserWithAdapter, OutputAdapter
    from ..ckpt import save_checkpoint
    from ..data import DenoisePatchDataset, validation_denoise
    from ..metrics import calculate_psnr
    from ..train import create_train_state, make_adapter_finetune_step
    from .common import iqsl_config, load_frozen_base, run_epoch, save_png

    train_dataset = DenoisePatchDataset(opt.data_dir, patch_size=opt.patch_size,
                                        patches_per_image=opt.patches_per_image)
    valid = validation_denoise(opt.data_dir, limit=10 if iqsl else None)
    iqsl_cfg = iqsl_config(opt) if iqsl else None

    base, base_fwd = load_frozen_base(opt, device, mesh)
    if mesh is not None:
        print(f"data-parallel over {mesh.size} devices")
    torch.manual_seed(opt.seed)
    adapter = OutputAdapter(opt.n_channel, opt.adapter_hidden).to(device)
    wrapper = DenoiserWithAdapter(base_fwd, adapter)
    state = create_train_state(adapter, lr=opt.lr)
    step = make_adapter_finetune_step(
        wrapper, state, lambda_grad=opt.lambda_grad,
        lambda_iqsl=opt.lambda_iqsl if iqsl else 0.0, iqsl_cfg=iqsl_cfg, mesh=mesh)

    if not iqsl:
        print(f"==> Start finetuning with adapter + patches. Num epochs={opt.n_epoch}, "
              f"batchsize={opt.batchsize}, lr={opt.lr}, lambda_grad={opt.lambda_grad}, "
              f"patch_size={opt.patch_size}, patches_per_image={opt.patches_per_image}")

    save_root = os.path.join(opt.save_model_path, opt.log_name)
    rng = np.random.default_rng(opt.seed)
    for epoch in range(1, opt.n_epoch + 1):
        epoch_st = time.time()
        losses_l1, losses_iqsl = run_epoch(
            step, train_dataset.batches(opt.batchsize, rng), epoch, opt.n_epoch,
            iqsl=iqsl)
        if iqsl:
            print(f"End of epoch {epoch}, mean L1={np.mean(losses_l1):.6f}, "
                  f"mean IQSL={np.mean(losses_iqsl):.6f}, "
                  f"time={time.time() - epoch_st:.2f}s")
        else:
            print(f"End of epoch {epoch}, mean L1 loss={float(np.mean(losses_l1)):.6f}, "
                  f"time={time.time() - epoch_st:.2f}s")

        if epoch % opt.save_every == 0 or epoch == opt.n_epoch:
            if iqsl:
                save_checkpoint(adapter, save_root, "adapter_only", epoch)
            else:
                save_checkpoint({"base": base, "adapter": adapter}, save_root,
                                "adapter", epoch)
            save_dir = os.path.join(save_root, f"val_{systime}_ep{epoch:03d}")
            os.makedirs(save_dir, exist_ok=True)
            for i, (clean_np, noisy_np) in enumerate(zip(valid[0], valid[1])):
                clean_name = os.path.basename(valid[2][i]).split(".")[0]
                noisy_name = os.path.basename(valid[3][i]).split(".")[0]
                x = torch.from_numpy(np.asarray(noisy_np, np.float32) / np.float32(255.0))
                x = x[..., None] if x.ndim == 2 else x
                with torch.inference_mode():
                    pred = wrapper(x.permute(2, 0, 1)[None].to(device))[0]
                    pred255 = torch.clamp(pred * 255.0 + 0.5, 0, 255).to(torch.uint8)
                pred255 = pred255.permute(1, 2, 0).cpu().numpy().squeeze()
                psnr = calculate_psnr(pred255, clean_np, zero_mse_psnr=99.0)
                if i == 0:
                    print(f"Val ep{epoch}: psnr={psnr:.2f} dB")
                    if not iqsl:
                        save_png(np.asarray(clean_np).astype(np.uint8),
                                 os.path.join(save_dir, f"{clean_name}_clean.png"), mode="L")
                        save_png(np.asarray(noisy_np).astype(np.uint8),
                                 os.path.join(save_dir, f"{noisy_name}_noisy.png"), mode="L")
                    save_png(pred255, os.path.join(
                        save_dir, f"{noisy_name}_denoised_ep{epoch:03d}.png"), mode="L")

    print("Finetuning (IQSL adapter) complete." if iqsl else "Finetuning complete.")
    return state


def main(argv=None):
    return train_adapter(parse_args(argv))


if __name__ == "__main__":
    main()
