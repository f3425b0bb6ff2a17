"""Pure-inference tiled denoising CLI, the production serving entry point —
counterpart of ``image_denoising_tpu/cli/denoise.py``.

Denoises a flat directory of new frames (no ``clean/`` ground truth) with
E2's geometry: 352-px tiles, 64-px overlap, pyramid blend, bursts of frames
through ``make_tiled_pyramid_runner_frames`` over ``make_forward`` (for
an ImprovedUNet on a CUDA device every level block goes through the chain
kernel), and
writes one denoised PNG per frame. Defaults are the production preset:
bfloat16 compute, bursts of 8 with up to three in flight, 8-tile chunks,
``--rounding floor`` (E2's clip(p·255)); ``--dtype float32 --tile_batch
-1`` gives E2's denoised PNGs byte for byte, ``--rounding round`` the +0.5
of ``evaluation.py``.

Shapes are bucketed from the PIL headers alone and frames decode per burst,
so host memory holds the bursts in flight, not the directory. Two inputs
with one stem (``a.png``, ``a.tif``) keep their extension in the output
name. Same flags as the JAX CLI plus ``--device {cuda,cpu}``;
``--arch UNet|RESNET|UNetImproved|Restormer`` or the ``--log_name``
dispatch picks the network (Restormer's ``--checkpoint`` is its upstream
``torch.save`` file), ``--blindspot`` the blind-spot UNet/RESNET;
``--parallel`` splits each burst's tile stack over every visible card.

Run: ``python -m image_denoising_tpu_torch.cli.denoise --input_dir frames
--checkpoint model.ckpt`` (``--device cpu`` off the card).
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--input_dir", type=str, required=True,
                        help="directory of noisy frames (every image in it "
                             "is denoised; grayscale, like the SEM data)")
    parser.add_argument("--save_dir", type=str, default="./denoised")
    parser.add_argument("--checkpoint", type=str, required=True,
                        help=".ckpt params or reference-layout .pth state dict")
    parser.add_argument("--n_feature", type=int, default=48)
    parser.add_argument("--n_channel", type=int, default=1)
    parser.add_argument("--log_name", type=str, default="UNetImproved")
    parser.add_argument("--arch", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="'cuda': the current card; 'cpu': the plain chain")
    parser.add_argument("--parallel", action="store_true",
                        help="shard the tile batch over all devices in the mesh")
    parser.add_argument("--tile", type=int, default=352)
    parser.add_argument("--overlap", type=int, default=64)
    parser.add_argument("--tile_batch", type=int, default=-8,
                        help="forward chunk size: -8 = chunks of 8 tiles; 0 = "
                             "all tiles in one batch; -1 = one tile at a time")
    parser.add_argument("--frame_burst", type=int, default=8,
                        help="frames per runner call (0/1 = one at a time)")
    parser.add_argument("--rounding", type=str, default="floor",
                        choices=["floor", "round"],
                        help="uint8 quantization: floor = evaluation_704's "
                             "clip(p*255); round = evaluation.py's +0.5")
    parser.add_argument("--suffix", type=str, default="_denoised")
    from .common import add_blindspot_flag, add_dtype_flag, add_host_workers_flag

    add_blindspot_flag(parser)
    add_dtype_flag(parser, default="bfloat16")
    add_host_workers_flag(parser)
    return parser.parse_args(argv)


def output_names(paths, save_dir: str, suffix: str):
    """{input path: output PNG path}. A stem shared by several inputs keeps
    the input's extension (``frame01.png`` → ``frame01_png<suffix>.png``),
    so no output overwrites another."""
    stems = [os.path.splitext(os.path.basename(p))[0] for p in paths]
    out = {}
    for p, stem in zip(paths, stems):
        if stems.count(stem) > 1:
            stem = os.path.basename(p).replace(".", "_")
        out[p] = os.path.join(save_dir, f"{stem}{suffix}.png")
    return out


def run(opt):
    from ..data.pairs import load_image_f32
    from ..models.fused_forward import make_forward
    from .common import (HostWorkPool, build_network, cli_device, cli_mesh,
                         load_params, save_png)

    mesh = cli_mesh(opt) if opt.parallel else None
    device = cli_device(opt, mesh)
    os.makedirs(opt.save_dir, exist_ok=True)
    paths = sorted(p for p in glob.glob(os.path.join(opt.input_dir, "*"))
                   if os.path.isfile(p))
    if not paths:
        raise SystemExit(f"no frames found in {opt.input_dir}")

    network = load_params(
        opt.checkpoint,
        build_network(opt.arch, opt.log_name, opt.n_channel, opt.n_feature,
                      blindspot=opt.blindspot))
    dtype = torch.bfloat16 if opt.dtype == "bfloat16" else torch.float32
    fwd = make_forward(network, device=device, dtype=dtype, mesh=mesh)
    print(f"Loaded checkpoint from {opt.checkpoint}; "
          f"denoising {len(paths)} frames from {opt.input_dir}")
    if mesh is not None:
        print(f"tile-parallel over {mesh.size} devices")

    out_dtype = "uint8_floor" if opt.rounding == "floor" else "uint8_round"
    out_path = output_names(paths, opt.save_dir, opt.suffix)

    def _load(j):
        arr = load_image_f32(paths[j])
        if arr.ndim != 2:
            raise ValueError(f"tiled pyramid denoising is single-channel: "
                             f"{paths[j]} has shape {arr.shape}")
        return arr.astype(np.uint8)

    n_done = 0

    def _finalize(name):
        nonlocal n_done
        n_done += 1
        print(f"[{n_done}/{len(paths)}] {name}")

    def _encode(frame, path):
        save_png(frame, out_path[path], mode=None)
        return os.path.basename(path)

    # --host_workers: PNG encode (PIL releases the GIL in zlib) runs in a
    # thread pool; progress lines still print in frame order
    with HostWorkPool(opt.host_workers, _finalize) as pool:
        _run_frames(opt, paths, pool, _encode, _load, fwd, out_dtype, device, mesh)

    print(f"Wrote {n_done} denoised frames to {opt.save_dir}")
    return n_done


def _run_frames(opt, paths, pool, encode, load, fwd, out_dtype, device, mesh):
    from ..eval.tiled import denoise_tiled_pyramid, make_tiled_pyramid_runner_frames

    if opt.frame_burst > 1:
        from PIL import Image

        from .common import iter_bursts

        fb = opt.frame_burst
        # shapes from the headers only (PIL reads sizes lazily); frames
        # decode per burst inside the stream
        by_shape: dict = {}
        for j, p in enumerate(paths):
            with Image.open(p) as im:
                w_px, h_px = im.size
            by_shape.setdefault((h_px, w_px), []).append(j)

        def make_runner(h, w):
            return make_tiled_pyramid_runner_frames(
                fwd, fb, h, w, opt.tile, opt.overlap, batch=opt.tile_batch,
                out_dtype=out_dtype, device=device, mesh=mesh)

        for chunk, (out_dev, _l1), _ in iter_bursts(by_shape, load, fb, make_runner):
            out = out_dev.cpu().numpy()
            for k, j in enumerate(chunk):
                pool.submit(encode, out[k], paths[j])
    else:
        for j, p in enumerate(paths):
            pred255, _l1 = denoise_tiled_pyramid(
                fwd, load(j), ps=opt.tile, overlap=opt.overlap,
                batch=opt.tile_batch, out_dtype=out_dtype, device=device,
                mesh=mesh)
            pool.submit(encode, pred255, p)


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
