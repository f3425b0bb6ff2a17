"""Whole-image evaluation CLI — counterpart of
``image_denoising_tpu/cli/evaluation.py`` (E1).

One whole-frame forward per noisy image (``make_forward``: for an
ImprovedUNet on a CUDA device every level block goes through the chain
kernel, at batch 1 and the frame's own size), L1 recorded against the *noisy input* (a documented
quirk of the reference, ``evaluation.py:23-117``), PNGs of the noisy, clean
and denoised frames in RGB mode, PSNR and SSIM against the clean frame,
averages to ``metrics.txt``. uint8 via clip(p·255 + 0.5).

``--device_metrics`` quantises and scores each frame on the device (L1,
PSNR, float32 SSIM): only scalars come back, and the prediction too when
PNGs are asked for. ``--host_workers N`` runs the per-frame host pass
(fetch, metrics, PNG encode) in a thread pool, finalized in frame order.
Same flags as the JAX CLI plus ``--device {cuda,cpu}``; ``--arch UNet|RESNET|UNetImproved``
or the ``--log_name`` dispatch picks the network, ``--blindspot`` the
blind-spot UNet/RESNET; a ``--gpu_devices`` list runs on its first card,
as the reference's ``CUDA_VISIBLE_DEVICES`` + ``.cuda()`` does.

Run: ``python -m image_denoising_tpu_torch.cli.evaluation --data_dir d
--checkpoint model.ckpt`` (``--device cpu`` off the card). H and W must be
divisible by 16 (ImprovedUNet's four levels).
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_dir", type=str, default="./dataset/m1")
    parser.add_argument("--checkpoint", type=str, required=True,
                        help=".ckpt params or reference-layout .pth state dict")
    parser.add_argument("--save_dir", type=str, default="./eval_results")
    parser.add_argument("--n_feature", type=int, default=48)
    parser.add_argument("--n_channel", type=int, default=1)
    parser.add_argument("--log_name", type=str, default="UNetImproved")
    parser.add_argument("--arch", type=str, default=None,
                        help="explicit architecture (overrides log_name dispatch)")
    parser.add_argument("--gpu_devices", default="0", type=str,
                        help="card index N (cuda:N); of a list '0,1' the "
                             "first")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="'cuda': the card --gpu_devices names; 'cpu': "
                             "the plain chain")
    parser.add_argument("--save_images", type=str, default="all",
                        choices=["all", "denoised", "none"],
                        help="which PNGs to write per frame ('all' mirrors "
                             "the reference)")
    parser.add_argument("--device_metrics", action="store_true",
                        help="quantise and score PSNR/SSIM on the device "
                             "(float32 SSIM, ~1e-6 from the host float64 "
                             "SSIM). With --save_images none the prediction "
                             "never leaves the device.")
    from .common import add_blindspot_flag, add_dtype_flag, add_host_workers_flag

    add_blindspot_flag(parser)
    add_dtype_flag(parser)
    add_host_workers_flag(parser)
    return parser.parse_args(argv)


def evaluate(opt):
    from ..data.pairs import validation_denoise
    from ..metrics import calculate_psnr, calculate_ssim, frame_psnr_ssim
    from ..models.fused_forward import make_forward
    from .common import (HostWorkPool, MetricsWriter, build_network, cli_device,
                         load_params, make_metrics_finalize, save_png)

    device = cli_device(opt)
    os.makedirs(opt.save_dir, exist_ok=True)
    clean_imgs, noisy_imgs, clean_paths, noisy_paths = validation_denoise(opt.data_dir)

    network = load_params(
        opt.checkpoint,
        build_network(opt.arch, opt.log_name, opt.n_channel, opt.n_feature,
                      blindspot=opt.blindspot))
    dtype = torch.bfloat16 if opt.dtype == "bfloat16" else torch.float32
    fwd = make_forward(network, device=device, dtype=dtype)
    print(f"Loaded checkpoint from {opt.checkpoint}")

    save_mode = opt.save_images

    @torch.inference_mode()
    def _forward(noisy_f, clean255):
        """Queue one frame's forward and L1 against the noisy input; with
        --device_metrics also the quantisation, PSNR and SSIM. Returns device
        tensors: the host pass fetches them."""
        x3 = torch.from_numpy(noisy_f).to(device) / 255.0
        x3 = x3[..., None] if x3.dim() == 2 else x3
        pred = fwd(x3.permute(2, 0, 1)[None])[0].permute(1, 2, 0).float()
        l1 = torch.mean(torch.abs(pred - x3))
        if not opt.device_metrics:
            return pred, l1
        pred255 = torch.clamp(torch.clamp(pred, 0.0, 1.0).squeeze() * 255.0 + 0.5,
                              0, 255).to(torch.uint8)
        clean = torch.from_numpy(clean255).to(device)
        psnr, ssim = frame_psnr_ssim(pred255[None], clean[None])
        return pred255, l1, psnr[0], ssim[0]

    writer = MetricsWriter()

    def _host_pass(i, clean_name, noisy_name, clean255, noisy255, dev):
        """Fetch one frame's results and score it: inline, or in the
        --host_workers pool (finalized in frame order)."""
        if opt.device_metrics:
            pred_dev, l1_dev, psnr_dev, ssim_dev = dev
            pred255 = pred_dev.cpu().numpy() if save_mode != "none" else None
            l1_val, psnr_val, ssim_val = float(l1_dev), float(psnr_dev), float(ssim_dev)
        else:
            pred, l1_dev = dev
            l1_val = float(l1_dev)
            pred_np = np.clip(pred.cpu().numpy(), 0, 1).squeeze()
            pred255 = np.clip(pred_np * 255.0 + 0.5, 0, 255).astype(np.uint8)
            psnr_val = calculate_psnr(pred255, clean255)
            ssim_val = calculate_ssim(pred255, clean255)

        if save_mode == "all":
            save_png(noisy255, os.path.join(opt.save_dir, f"{noisy_name}_{i:03d}_noisy.png"))
            save_png(clean255, os.path.join(opt.save_dir, f"{clean_name}_{i:03d}_clean.png"))
        if save_mode != "none":
            save_png(pred255, os.path.join(opt.save_dir, f"{noisy_name}_{i:03d}_denoised.png"))
        msg = (f"[{i + 1}/{len(clean_imgs)}] {noisy_name} -> "
               f"PSNR: {psnr_val:.2f}, SSIM: {ssim_val:.4f}, L1: {l1_val:.6f}")
        return msg, dict(psnr=psnr_val, ssim=ssim_val, l1=l1_val)

    with HostWorkPool(opt.host_workers, make_metrics_finalize(writer)) as pool:
        for i, (clean, noisy) in enumerate(zip(clean_imgs, noisy_imgs)):
            clean_name = os.path.basename(clean_paths[i]).split(".")[0]
            noisy_name = os.path.basename(noisy_paths[i]).split(".")[0]
            noisy_f = np.asarray(noisy, dtype=np.float32)
            clean255 = np.asarray(clean).astype(np.uint8)
            noisy255 = noisy_f.astype(np.uint8)
            pool.submit(_host_pass, i, clean_name, noisy_name, clean255, noisy255,
                        _forward(noisy_f, clean255))

    writer.write(opt.save_dir)
    avg = writer.averages()
    print(
        f"Average PSNR: {avg['psnr']:.2f}, Average SSIM: {avg['ssim']:.4f}, "
        f"Average L1 Loss: {avg['l1']:.6f}"
    )
    return avg


def main(argv=None):
    return evaluate(parse_args(argv))


if __name__ == "__main__":
    main()
