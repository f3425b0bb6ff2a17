"""Tiled "704" evaluation CLI — counterpart of ``image_denoising_tpu/cli/evaluation_704.py``.

352×352 tiles, 64-px overlap (stride 288), reflect-padded ragged edge tiles,
pyramid weight blending, uint8 via clip(p·255) with NO +0.5 (reference
quirk, ``evaluation_704.py:120``). The network runs through
``make_forward``: for an ImprovedUNet on a CUDA device every level block goes through the
hand-written chain kernel. Same flags and output files as the JAX CLI, plus
``--device {cuda,cpu}``: ``cuda`` runs on the first card ``--gpu_devices``
names (``cuda:N``). ``--parallel`` splits each tile stack over the cards
(``parallel.make_mesh``: the ``--gpu_devices`` list where it names several,
else every visible card), each running its share in ``--tile_batch``
chunks. ``--device_metrics`` scores each burst on the device
(``metrics/device.py``), ``--host_workers N`` runs the per-frame host pass
in a thread pool and ``--profile_dir`` traces the denoise loop, the
program's spans included (``utils/profiling.py``).
``--arch UNet|RESNET|UNetImproved|Restormer`` or the ``--log_name``
dispatch picks the network (Restormer's ``--checkpoint`` is its upstream
``torch.save`` file), ``--blindspot`` the blind-spot UNet/RESNET.

Run: ``python -m image_denoising_tpu_torch.cli.evaluation_704 --data_dir d
--checkpoint model.ckpt`` (the JAX package's ``.ckpt``, or a
reference-layout ``.pth`` such as its ``ckpt/pth_export.py::export_pth``
writes). ``cli/evaluation_704_iqsl.py`` is the same CLI.
"""
from __future__ import annotations

import argparse
import contextlib
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
    parser.add_argument("--arch", type=str, default=None)
    parser.add_argument("--gpu_devices", default="0", type=str,
                        help="card index N (cuda:N), or a list '0,1' of the "
                             "cards --parallel uses (the first without it)")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="'cuda': the card --gpu_devices names; 'cpu': "
                             "the plain chain")
    parser.add_argument("--parallel", action="store_true",
                        help="split each tile stack over the cards (the "
                             "reference's DataParallel analog)")
    parser.add_argument("--tile", type=int, default=352)
    parser.add_argument("--overlap", type=int, default=64)
    parser.add_argument("--tile_batch", type=int, default=-1,
                        help="forward chunk size; 0 = all tiles in one batch, "
                             "±k = chunks of k tiles")
    parser.add_argument("--frame_burst", type=int, default=0,
                        help="process N same-shape frames per runner call "
                             "(serving mode: 8 with --tile_batch -8). 0 = "
                             "frame by frame like the reference.")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="write a torch.profiler trace of the denoise "
                             "loop to this directory; it carries the "
                             "program's spans (tiled.*, and burst, "
                             "burst.load, burst.submit with --frame_burst)")
    parser.add_argument("--save_images", type=str, default="all",
                        choices=["all", "denoised", "none"],
                        help="which PNGs to write per frame: 'all' (noisy + "
                             "clean + denoised, as the reference), "
                             "'denoised', or 'none'")
    parser.add_argument("--device_metrics", action="store_true",
                        help="score PSNR/SSIM (and IQ-IoU with "
                             "--compute_iq_iou) on the device (float32 SSIM, "
                             "~1e-6 from the host float64 SSIM). With "
                             "--save_images none the predictions never leave "
                             "the device. Implies the burst pipeline.")
    parser.add_argument("--compute_iq_iou", action="store_true")
    parser.add_argument("--iq_low_q", type=float, default=0.25)
    parser.add_argument("--iq_high_q", type=float, default=0.75)
    from .common import add_blindspot_flag, add_dtype_flag, add_host_workers_flag

    add_blindspot_flag(parser)
    add_dtype_flag(parser)
    add_host_workers_flag(parser)
    return parser.parse_args(argv)


def evaluate(opt):
    from ..data.pairs import validation_denoise
    from ..eval.tiled import denoise_tiled_pyramid, make_tiled_pyramid_runner_frames
    from ..metrics import (calculate_psnr, calculate_ssim, compute_iq_iou,
                           make_device_metrics)
    from ..models.fused_forward import make_forward
    from ..utils.profiling import trace
    from .common import (HostWorkPool, MetricsWriter, build_network, cli_device,
                         cli_mesh, drain_burst, iter_bursts, load_params,
                         make_clean_post, make_metrics_finalize, save_png)

    mesh = cli_mesh(opt) if opt.parallel else None
    device = cli_device(opt, mesh)
    os.makedirs(opt.save_dir, exist_ok=True)
    clean_imgs, noisy_imgs, clean_paths, noisy_paths = validation_denoise(opt.data_dir)

    network = load_params(
        opt.checkpoint,
        build_network(opt.arch, opt.log_name, opt.n_channel, opt.n_feature,
                      blindspot=opt.blindspot))
    dtype = torch.bfloat16 if opt.dtype == "bfloat16" else torch.float32
    fwd = make_forward(network, device=device, dtype=dtype, mesh=mesh)
    print(f"Loaded checkpoint from {opt.checkpoint}")
    if mesh is not None:
        print(f"tile-parallel over {mesh.size} devices")

    # --frame_burst: N same-shape frames per runner call, up to three bursts
    # in flight; the loop below drains them on demand, so the host pass of
    # early frames overlaps the device work of later ones. --device_metrics
    # scores each burst where its predictions are, so it implies bursts
    pred_cache: dict = {}
    burst_stream = None
    save_mode = opt.save_images
    fetch_pred = not opt.device_metrics or save_mode != "none"
    if opt.frame_burst > 1 or opt.device_metrics:
        fb = max(opt.frame_burst, 1)
        by_shape: dict = {}
        for j, nz in enumerate(noisy_imgs):
            if np.ndim(nz) != 2:
                raise ValueError(f"tiled pyramid eval is single-channel: "
                                 f"frame {j} has shape {np.shape(nz)}")
            if opt.device_metrics and np.shape(clean_imgs[j]) != np.shape(nz):
                raise ValueError(
                    f"--device_metrics scores per shape bucket: clean/noisy "
                    f"shapes differ for frame {j} ({np.shape(clean_imgs[j])} "
                    f"vs {np.shape(nz)})")
            by_shape.setdefault(np.shape(nz), []).append(j)

        def make_runner(h, w):
            return make_tiled_pyramid_runner_frames(
                fwd, fb, h, w, opt.tile, opt.overlap,
                batch=opt.tile_batch, out_dtype="uint8_floor",
                device=device, mesh=mesh)

        post = None
        if opt.device_metrics:
            post = make_clean_post(
                lambda j: np.asarray(clean_imgs[j], np.uint8), fb,
                make_device_metrics(iq_iou=opt.compute_iq_iou,
                                    low_q=opt.iq_low_q, high_q=opt.iq_high_q),
                pick_pred=lambda out: out[0])
        burst_stream = iter_bursts(
            by_shape, lambda j: np.asarray(noisy_imgs[j], np.uint8), fb,
            make_runner, post=post)

    writer = MetricsWriter()

    def _host_pass(i, clean_name, noisy_name, clean_u8, noisy_u8, pred255,
                   l1_val, dev_m):
        """One frame's PNGs and metrics: inline, or in the --host_workers
        pool (finalized in frame order)."""
        if save_mode == "all":
            save_png(noisy_u8, os.path.join(opt.save_dir, f"{noisy_name}_{i:03d}_noisy.png"), mode=None)
            save_png(clean_u8, os.path.join(opt.save_dir, f"{clean_name}_{i:03d}_clean.png"), mode=None)
        if save_mode != "none":
            save_png(pred255, os.path.join(opt.save_dir, f"{noisy_name}_{i:03d}_denoised.png"), mode=None)

        ious = None
        if dev_m is not None:
            psnr_val, ssim_val = float(dev_m[0]), float(dev_m[1])
            if len(dev_m) > 2:
                ious = [float(v) for v in dev_m[2]]
        else:
            psnr_val = calculate_psnr(pred255, clean_u8)
            ssim_val = calculate_ssim(pred255, clean_u8)
        msg = (f"[{i + 1}/{len(clean_imgs)}] {noisy_name} -> "
               f"PSNR: {psnr_val:.2f}, SSIM: {ssim_val:.4f}, L1: {l1_val:.6f}")
        if opt.compute_iq_iou:
            if ious is None:
                ious = compute_iq_iou(pred255, clean_u8, opt.iq_low_q, opt.iq_high_q)
            msg += f", IoU(d/m/b)=({ious[0]:.3f},{ious[1]:.3f},{ious[2]:.3f})"
        return msg, dict(psnr=psnr_val, ssim=ssim_val, l1=l1_val, ious=ious)

    profiling = trace(opt.profile_dir) if opt.profile_dir else contextlib.nullcontext()
    with profiling, HostWorkPool(opt.host_workers, make_metrics_finalize(writer)) as pool:
        for i, (clean, noisy) in enumerate(zip(clean_imgs, noisy_imgs)):
            clean_name = os.path.basename(clean_paths[i]).split(".")[0]
            noisy_name = os.path.basename(noisy_paths[i]).split(".")[0]
            clean_u8 = np.asarray(clean).astype(np.uint8)
            noisy_u8 = np.asarray(noisy).astype(np.uint8)

            dev_m = None
            if burst_stream is not None:
                while i not in pred_cache:
                    drain_burst(next(burst_stream), pred_cache, fetch_pred,
                                pick=lambda out: (out[0], (out[1],)))
                pred255, l1_val, dev_m = pred_cache.pop(i)
                l1_val = float(l1_val)
            else:
                pred255, l1_val = denoise_tiled_pyramid(
                    fwd, noisy_u8, ps=opt.tile, overlap=opt.overlap,
                    batch=opt.tile_batch, out_dtype="uint8_floor",
                    device=device, mesh=mesh)

            pool.submit(_host_pass, i, clean_name, noisy_name, clean_u8,
                        noisy_u8, pred255, l1_val, dev_m)
    if opt.profile_dir:
        print(f"profiler trace written to {opt.profile_dir}")

    writer.write(opt.save_dir)
    avg = writer.averages()
    print(
        f"Average PSNR: {avg['psnr']:.2f}, Average SSIM: {avg['ssim']:.4f}, "
        f"Average L1 Loss: {avg['l1']:.6f}"
    )
    if opt.compute_iq_iou and "iou_dark" in avg:
        print(
            "Average IQ-3class IoU - "
            f"dark: {avg['iou_dark']:.4f}, mid: {avg['iou_mid']:.4f}, "
            f"bright: {avg['iou_bright']:.4f}"
        )
    return avg


def main(argv=None):
    return evaluate(parse_args(argv))


if __name__ == "__main__":
    main()
