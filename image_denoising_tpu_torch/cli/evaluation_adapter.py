"""Adapter inference CLI — counterpart of
``image_denoising_tpu/cli/evaluation_adapter.py`` (E4).

Loads a combined base + output-adapter checkpoint (``--ckpt``): a
reference-layout ``.pth`` with ``base.*`` and ``adapter.*`` keys, or the
``epoch_adapter_XXX.ckpt`` that ``cli/finetune.py`` writes (in either
package). Denoises every frame under ``data_dir/noise/`` whole-frame through
``DenoiserWithAdapter(make_forward(base), adapter)`` (on a CUDA device an
ImprovedUNet base's level blocks go through the chain kernel; ``--arch``
picks UNet or RESNET), saves
``*_denoised.png`` (clip(p·255 + 0.5), mode L for one channel) and prints
PSNR when ``clean/`` exists. Unknown flags are ignored, as in the JAX CLI.
Same flags plus ``--device {cuda,cpu}``. ``--parallel`` runs the frames
in groups of the mesh's size, one per card (the ``--gpu_devices`` list
where it names several, else every visible card), as the JAX CLI does.

Run: ``python -m image_denoising_tpu_torch.cli.evaluation_adapter --data_dir
d --ckpt epoch_adapter_001.ckpt`` (``--device cpu`` off the card).
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_dir", type=str, required=True)
    parser.add_argument("--ckpt", type=str, required=True,
                        help="combined base + adapter checkpoint "
                             "(epoch_adapter_xxx .ckpt, or a .pth)")
    parser.add_argument("--arch", type=str, default="UNetImproved",
                        choices=["UNet", "RESNET", "UNetImproved"])
    parser.add_argument("--save_dir", type=str, default="./results_infer_adapter")
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
    parser.add_argument("--save_images", type=str, default="denoised",
                        choices=["denoised", "none"],
                        help="'denoised' writes *_denoised.png per frame (the "
                             "reference behavior); 'none' computes metrics only")
    from .common import add_dtype_flag, add_host_workers_flag

    add_dtype_flag(parser)
    add_host_workers_flag(parser)
    args, _ = parser.parse_known_args(argv)
    return args


def build_adapter_denoiser(opt, device, base_ckpt: str, adapter_ckpt=None,
                           mesh=None):
    """``DenoiserWithAdapter(make_forward(base), adapter)`` on
    ``device``, the base in the ``--dtype`` compute dtype. Without
    ``adapter_ckpt``, ``base_ckpt`` is a combined file: its ``base`` and
    ``adapter`` parts. With a ``mesh``, a ``parallel.PerDevice`` of it:
    one copy of the base and the adapter per device."""
    from ..adapters import DenoiserWithAdapter, OutputAdapter
    from ..ckpt.io import load_checkpoint
    from ..models.fused_forward import make_forward
    from ..models.registry import build_model

    combined = adapter_ckpt is None
    base = build_model(opt.arch, opt.n_channel, opt.n_feature)
    base.load_state_dict(load_checkpoint(base_ckpt, arch=opt.arch,
                                         prefix="base" if combined else ""),
                         strict=True)
    adapter = OutputAdapter(opt.n_channel, opt.adapter_hidden)
    adapter.load_state_dict(load_checkpoint(base_ckpt if combined else adapter_ckpt,
                                            arch="output_adapter",
                                            prefix="adapter" if combined else ""),
                            strict=True)
    dtype = torch.bfloat16 if opt.dtype == "bfloat16" else torch.float32
    fwd = make_forward(base, device=device, dtype=dtype, mesh=mesh)
    wrapper = DenoiserWithAdapter(fwd, adapter).to(device).eval()
    if mesh is None:
        return wrapper
    from ..parallel import PerDevice

    return PerDevice(mesh, wrapper.replica)


def load_frames(paths):
    """[H, W, C] float32 frames in [0, 1] (a grayscale frame gets C = 1)."""
    from ..data.pairs import load_image_f32

    frames = []
    for p in paths:
        x = load_image_f32(p) / 255.0
        frames.append(x[..., None] if x.ndim == 2 else x)
    return frames


def main(argv=None):
    opt = parse_args(argv)

    from ..data.pairs import load_image_f32
    from ..metrics import calculate_psnr
    from .common import (HostWorkPool, batched_frame_forward, cli_device, cli_mesh,
                         save_png)

    mesh = cli_mesh(opt) if opt.parallel else None
    device = cli_device(opt, mesh)
    noise_dir = os.path.join(opt.data_dir, "noise")
    clean_dir = os.path.join(opt.data_dir, "clean")
    os.makedirs(opt.save_dir, exist_ok=True)

    noise_paths = sorted(glob.glob(os.path.join(noise_dir, "*")))
    if not noise_paths:
        raise RuntimeError(f"No files found in {noise_dir}")
    clean_paths = sorted(glob.glob(os.path.join(clean_dir, "*")))
    has_clean = len(clean_paths) > 0
    if has_clean and len(clean_paths) != len(noise_paths):
        print("[Warning] clean/ and noise/ have different counts; PSNR may be misaligned.")
    print(f"Found {len(noise_paths)} noisy images for inference.")

    wrapper = build_adapter_denoiser(opt, device, opt.ckpt, mesh=mesh)
    print(f"Loaded adapter+base weights from {opt.ckpt}")
    preds = batched_frame_forward(wrapper, load_frames(noise_paths),
                                  parallel=opt.parallel, device=device, mesh=mesh)

    psnrs = []

    def _finalize(res):
        msg, psnr = res
        if psnr is not None:
            psnrs.append(psnr)
        print(msg)

    def _host_pass(idx, n_path):
        base_name = os.path.splitext(os.path.basename(n_path))[0]
        pred255 = np.clip(preds[idx] * 255.0 + 0.5, 0, 255).astype(np.uint8)
        note = "metrics only"
        if opt.save_images != "none":
            vis = pred255.squeeze(-1) if pred255.shape[-1] == 1 else pred255
            save_path = os.path.join(opt.save_dir, f"{base_name}_denoised.png")
            save_png(vis, save_path, mode="L" if vis.ndim == 2 else "RGB")
            note = f"saved to {save_path}"
        psnr = None
        if has_clean and idx < len(clean_paths):
            psnr = calculate_psnr(pred255.squeeze(), load_image_f32(clean_paths[idx]),
                                  zero_mse_psnr=99.0)
            msg = (f"[{idx + 1:03d}/{len(noise_paths):03d}] {base_name} → "
                   f"PSNR={psnr:.2f} dB, {note}")
        else:
            msg = f"[{idx + 1:03d}/{len(noise_paths):03d}] {base_name} → {note}"
        return msg, psnr

    with HostWorkPool(opt.host_workers, _finalize) as pool:
        for idx, n_path in enumerate(noise_paths):
            pool.submit(_host_pass, idx, n_path)

    print("Inference with adapter model finished.")
    return float(np.mean(psnrs)) if psnrs else None


if __name__ == "__main__":
    main()
