"""Adapter inference + IQ-IoU CLI — counterpart of
``image_denoising_tpu/cli/evaluation_adapter_iqsl.py`` (E5).

Unlike ``evaluation_adapter`` (E4) this loads the base checkpoint and the
adapter-only checkpoint apart (``--base_ckpt``, ``--adapter_ckpt``: the
``epoch_adapter_only_XXX.ckpt`` of ``cli/finetune_iqsl.py``, or ``.pth``
files), and adds PSNR, SSIM and, with ``--compute_iq_iou``, the 3-class
intensity-quantized IoU against ``clean/``, averaged into ``metrics.txt``.
Whole frames run through ``DenoiserWithAdapter(make_forward(base),
adapter)``. Unknown flags are ignored, as in the JAX CLI. Same flags plus
``--device {cuda,cpu}``; ``--parallel`` runs the frames in groups of the
mesh's size, one per card, as ``cli/evaluation_adapter.py`` does.

Run: ``python -m image_denoising_tpu_torch.cli.evaluation_adapter_iqsl
--data_dir d --base_ckpt model.ckpt --adapter_ckpt adapter_only.ckpt
--compute_iq_iou`` (``--device cpu`` off the card).
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_dir", type=str, required=True)
    parser.add_argument("--base_ckpt", type=str, required=True)
    parser.add_argument("--adapter_ckpt", type=str, required=True,
                        help="adapter-only ckpt (epoch_adapter_only_xxx)")
    parser.add_argument("--arch", type=str, default="UNetImproved",
                        choices=["UNet", "RESNET", "UNetImproved"])
    parser.add_argument("--save_dir", type=str, default="./results_infer_adapter_iqsl")
    parser.add_argument("--gpu_devices", default="0", type=str,
                        help="card index N (cuda:N), or a list '0,1' of the "
                             "cards --parallel uses (the first without it)")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="'cuda': the card --gpu_devices names; 'cpu': "
                             "the plain chain")
    parser.add_argument("--parallel", action="store_true",
                        help="one frame per card, in groups of the cards")
    parser.add_argument("--n_feature", type=int, default=48)
    parser.add_argument("--n_channel", type=int, default=1)
    parser.add_argument("--adapter_hidden", type=int, default=16)
    parser.add_argument("--compute_iq_iou", action="store_true")
    parser.add_argument("--iq_low_q", type=float, default=0.25)
    parser.add_argument("--iq_high_q", type=float, default=0.75)
    parser.add_argument("--save_images", type=str, default="denoised",
                        choices=["denoised", "none"],
                        help="'denoised' writes *_denoised.png per frame (the "
                             "reference behavior); 'none' computes metrics only")
    from .common import add_dtype_flag, add_host_workers_flag

    add_dtype_flag(parser)
    add_host_workers_flag(parser)
    args, _ = parser.parse_known_args(argv)
    return args


def main(argv=None):
    opt = parse_args(argv)

    from ..data.pairs import load_image_f32
    from ..metrics import calculate_psnr, calculate_ssim, compute_iq_iou
    from .common import (HostWorkPool, MetricsWriter, batched_frame_forward,
                         cli_device, cli_mesh, make_metrics_finalize, save_png)
    from .evaluation_adapter import build_adapter_denoiser, load_frames

    mesh = cli_mesh(opt) if opt.parallel else None
    device = cli_device(opt, mesh)
    os.makedirs(opt.save_dir, exist_ok=True)
    noise_paths = sorted(glob.glob(os.path.join(opt.data_dir, "noise", "*")))
    clean_paths = sorted(glob.glob(os.path.join(opt.data_dir, "clean", "*")))
    if not noise_paths:
        raise RuntimeError(f"No files under {opt.data_dir}/noise")
    has_clean = len(clean_paths) > 0

    wrapper = build_adapter_denoiser(opt, device, opt.base_ckpt, opt.adapter_ckpt,
                                     mesh=mesh)
    print(f"Loaded base from {opt.base_ckpt}; adapter from {opt.adapter_ckpt}")
    preds = batched_frame_forward(wrapper, load_frames(noise_paths),
                                  parallel=opt.parallel, device=device, mesh=mesh)

    writer = MetricsWriter()

    def _host_pass(idx, n_path):
        base_name = os.path.splitext(os.path.basename(n_path))[0]
        pred255 = np.clip(preds[idx] * 255.0 + 0.5, 0, 255).astype(np.uint8).squeeze()
        if opt.save_images != "none":
            save_png(pred255, os.path.join(opt.save_dir, f"{base_name}_denoised.png"),
                     mode="L" if pred255.ndim == 2 else "RGB")
        if not (has_clean and idx < len(clean_paths)):
            return None
        clean255 = load_image_f32(clean_paths[idx]).astype(np.uint8)
        psnr = calculate_psnr(pred255, clean255, zero_mse_psnr=99.0)
        ssim = calculate_ssim(pred255, clean255)
        ious = None
        msg = f"[{idx + 1}/{len(noise_paths)}] {base_name} -> PSNR: {psnr:.2f}, SSIM: {ssim:.4f}"
        if opt.compute_iq_iou:
            ious = compute_iq_iou(pred255, clean255, opt.iq_low_q, opt.iq_high_q)
            msg += f", IoU(d/m/b)=({ious[0]:.3f},{ious[1]:.3f},{ious[2]:.3f})"
        return msg, dict(psnr=psnr, ssim=ssim, ious=ious)

    with HostWorkPool(opt.host_workers,
                      make_metrics_finalize(writer, skip_none=True)) as pool:
        for idx, n_path in enumerate(noise_paths):
            pool.submit(_host_pass, idx, n_path)

    if has_clean:
        writer.write(opt.save_dir)
    return writer.averages()


if __name__ == "__main__":
    main()
