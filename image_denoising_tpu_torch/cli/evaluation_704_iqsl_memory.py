"""Memory-adapter tiled eval CLI — counterpart of
``image_denoising_tpu/cli/evaluation_704_iqsl_memory.py`` (E6).

Rebuilds the memory bank from the first ``--num_memory_images`` test pairs
(banks are never checkpointed), loads the base and the adapter, and denoises
each frame on 128-px tiles with a 64-px overlap and Hann² blending; uint8
via clip(p·255 + 0.5); PSNR and, with ``--compute_iq_iou``, IQ-IoU. On a
CUDA device the base runs through ``make_forward`` (for an ImprovedUNet
every level block through the chain kernel; ``--arch UNet`` or ``RESNET``
serve their module) and retrieval through the top-1 kernel. By
default retrieval is hoisted: one pass over the whole tile stack before the
chunked forward, the retrieved patches riding along as a second channel.
``--parallel`` splits each tile stack over the cards (the ``--gpu_devices``
list where it names several, else every visible card); ``--bank_sharded``
splits both banks over them too (``memory/sharded.py``: one retrieval
launch per shard, the same patches as the whole bank gives), and implies
the tile split, as in JAX. The hoisted pass stays under ``--bank_sharded``
(JAX turns it off there): its indices are the same, and a burst then
launches k retrievals instead of k per chunk.

Same flags, defaults and output files (``*_denoised_mem.png``,
``metrics.txt``) as the JAX CLI, plus ``--device {cuda,cpu}``: ``cuda`` runs
on the first card ``--gpu_devices`` names (``cuda:N``). ``--device_metrics``
scores PSNR (and IQ-IoU) of each burst on the device, ``--host_workers N``
runs the per-frame host pass in a thread pool.

Run: ``python -m image_denoising_tpu_torch.cli.evaluation_704_iqsl_memory
--data_dir d --base_ckpt b.ckpt --adapter_ckpt a.ckpt``: ``.ckpt`` files as
either package writes them (the base an ``epoch_model`` file, the adapter
the ``epoch_adapter_only`` file of ``cli/finetune_memory.py``), or
reference-layout ``.pth`` files such as the JAX package's
``ckpt/pth_export.py::export_pth`` writes.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..adapters.memory_adapters import MEMORY_ADAPTERS


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_dir", type=str, required=True)
    parser.add_argument("--base_ckpt", type=str, required=True,
                        help=".ckpt or reference-layout .pth of the base network")
    parser.add_argument("--adapter_ckpt", type=str, required=True,
                        help=".ckpt (adapter_only) or reference-layout .pth "
                             "of the adapter")
    parser.add_argument("--arch", type=str, default="UNetImproved",
                        choices=["UNet", "RESNET", "UNetImproved"])
    parser.add_argument("--save_dir", type=str,
                        default="./results_704_eval_adapter_memory")
    parser.add_argument("--gpu_devices", default="0", type=str,
                        help="card index N (cuda:N), or a list '0,1' of the "
                             "cards --parallel / --bank_sharded use")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="'cuda': the card --gpu_devices names; 'cpu': "
                             "the plain versions of the kernels")
    parser.add_argument("--parallel", action="store_true",
                        help="split each tile stack over the cards")
    parser.add_argument("--n_feature", type=int, default=48)
    parser.add_argument("--n_channel", type=int, default=1)
    parser.add_argument("--adapter_hidden", type=int, default=16)
    parser.add_argument("--patch_size", type=int, default=128)
    parser.add_argument("--overlap", type=int, default=64)
    parser.add_argument("--num_memory_images", type=int, default=5)
    parser.add_argument("--memory_stride", type=int, default=4)
    parser.add_argument("--adapter_variant", type=str, default="hyper_gated_fft",
                        choices=list(MEMORY_ADAPTERS))
    parser.add_argument("--pallas_retrieval", action="store_true",
                        help="pad the bank to a multiple of 512 rows, as the "
                             "TPU kernel's tile grid needs. On a CUDA device "
                             "retrieval always runs the top-1 kernel; this "
                             "flag changes only the padding")
    parser.add_argument("--bank_sharded", action="store_true",
                        help="shard BOTH banks over the cards: each scans its "
                             "1/k with the retrieval kernel and the keys merge "
                             "to the whole bank's first minimum. Implies the "
                             "tile split of --parallel")
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
    parser.add_argument("--tile_batch", type=int, default=-8,
                        help="forward chunk size; 0 = all tiles in one batch, "
                             "±k = chunks of k tiles")
    parser.add_argument("--frame_burst", type=int, default=0,
                        help="denoise N same-shape frames per runner call, "
                             "up to three bursts in flight. 0 = frame by "
                             "frame like the reference")
    parser.add_argument("--save_images", type=str, default="denoised",
                        choices=["denoised", "none"],
                        help="'denoised' writes *_denoised_mem.png per frame "
                             "(the reference's only output image); 'none' "
                             "computes metrics only")
    parser.add_argument("--compute_iq_iou", action="store_true")
    parser.add_argument("--iq_low_q", type=float, default=0.25)
    parser.add_argument("--iq_high_q", type=float, default=0.75)
    parser.add_argument("--device_metrics", action="store_true",
                        help="score PSNR (and IQ-IoU with --compute_iq_iou) "
                             "on the device; with --save_images none the "
                             "predictions never leave the device. Implies "
                             "the burst pipeline")
    parser.add_argument("--hoist_retrieval", action=argparse.BooleanOptionalAction,
                        default=True,
                        help="retrieve all tiles' memory patches in one pass "
                             "before the chunked forward, instead of sweeping "
                             "the bank once per --tile_batch chunk")
    parser.add_argument("--retrieval_chunk", type=int, default=0,
                        help="query-chunk size of the hoisted retrieval pass; "
                             "0 (default) = one pass over the whole tile "
                             "stack. Outputs are identical either way")
    parser.add_argument("--timing_json", type=str, default=None,
                        help="write per-burst drain timestamps (seconds since "
                             "the CLI started, drained frame indices, frame "
                             "pixel count) to this path")
    parser.add_argument("--dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"],
                        help="compute dtype of the base forward; weights load "
                             "as float32 and the adapter computes in float32")
    from .common import add_host_workers_flag

    add_host_workers_flag(parser)
    args, _ = parser.parse_known_args(argv)
    return args


def make_memory_model_call(wrapper, bank, n_channel: int = 1,
                           hoist: bool = True, retrieval_chunk: int = 0):
    """(model_call, pre_tile_fn) for the Hann runners over NCHW tiles.

    Hoisted (default): ``pre_tile_fn`` retrieves every tile's clean patch in
    one pass (``retrieval_chunk`` > 0: in query chunks of that size) and
    appends it as extra channels; ``model_call`` splits the stack again.
    Otherwise ``pre_tile_fn`` is None and each forward chunk retrieves its
    own patches. Retrieval is the wrapper's (``retrieval_fn``: the sharded
    bank's over a ``ShardedBank``).
    """
    from ..adapters import batched_select_memory_patch

    if retrieval_chunk < 0:
        raise SystemExit(f"--retrieval_chunk must be >= 0 (0 = single pass), "
                         f"got {retrieval_chunk}")
    if not hoist:
        def model_call(tiles):
            return wrapper(tiles, bank.noise_flat, bank.clean, bank.sq_norms)

        return model_call, None
    c = n_channel
    chunk = retrieval_chunk if retrieval_chunk > 0 else 10 ** 9

    def pre_tile_fn(tiles):
        mem = batched_select_memory_patch(
            tiles.permute(0, 2, 3, 1), bank.noise_flat, bank.clean,
            bank.sq_norms, chunk=chunk, retrieval_fn=wrapper.retrieval_fn)
        return torch.cat([tiles, mem.permute(0, 3, 1, 2).to(tiles.dtype)], 1)

    def model_call(stack):
        return wrapper(stack[:, :c], mem_clean=stack[:, c:])

    return model_call, pre_tile_fn


def make_memory_mesh_call(wrapper, bank, mesh, n_channel: int = 1,
                          hoist: bool = True, retrieval_chunk: int = 0):
    """``make_memory_model_call`` over a mesh: ``pre_tile_fn`` on the first
    device, and a ``parallel.PerDevice`` model call whose copy on each
    device runs that device's base forward and adapter
    (``wrapper.replica``) on its share of the tiles. Without hoisting, an
    unsharded bank is copied to each card (a repeated device shares it)."""
    from dataclasses import replace

    from ..memory import ShardedBank
    from ..parallel import PerDevice, replicate

    banks = dict.fromkeys(mesh.devices, bank)
    if not (isinstance(bank, ShardedBank) or hoist):
        copies = replicate(mesh, (bank.noise_flat, bank.clean, bank.sq_norms))
        banks = {d: replace(bank, noise_flat=n, clean=c, sq_norms=q)
                 for d, (n, c, q) in zip(mesh.devices, copies)}
    _, pre_tile_fn = make_memory_model_call(wrapper, bank, n_channel, hoist,
                                            retrieval_chunk)
    model_call = PerDevice(mesh, lambda d: make_memory_model_call(
        wrapper.replica(d), banks[d], n_channel, hoist, retrieval_chunk)[0])
    return model_call, pre_tile_fn


def _squeeze2d(a, what):
    a = np.asarray(a)
    if a.ndim == 3 and a.shape[2] == 1:
        a = a[..., 0]
    if a.ndim != 2:
        raise ValueError(f"memory tiled eval is single-channel: {what} has "
                         f"shape {a.shape}")
    return a


def evaluate(opt):
    from ..adapters import DenoiserWithMemoryAdapter, build_memory_adapter
    from ..ckpt.io import load_checkpoint
    from ..data.pairs import list_pairs, validation_denoise
    from ..eval.tiled import denoise_tiled_hann, make_tiled_hann_runner_frames
    from ..memory import build_memory_bank
    from ..metrics import calculate_psnr, compute_iq_iou, make_device_metrics
    from ..models.fused_forward import make_forward
    from ..memory import make_ring_retrieval, shard_bank
    from .common import (HostWorkPool, MetricsWriter, build_network, cli_device,
                         cli_mesh, drain_burst, iter_bursts, load_params,
                         make_clean_post, make_metrics_finalize, save_png)

    mesh = cli_mesh(opt) if opt.parallel or opt.bank_sharded else None
    device = cli_device(opt, mesh)
    os.makedirs(opt.save_dir, exist_ok=True)
    clean_imgs, noisy_imgs, clean_paths, noisy_paths = validation_denoise(opt.data_dir)
    clean_all, noise_all = list_pairs(opt.data_dir)
    num_mem = min(opt.num_memory_images, len(clean_all))
    bank = build_memory_bank(
        clean_all[:num_mem], noise_all[:num_mem],
        patch_size=opt.patch_size, stride=opt.memory_stride,
        bank_dtype=opt.bank_dtype, clean_dtype=opt.clean_bank_dtype,
        pad_to=512 if opt.pallas_retrieval else 0, device=device)
    retrieval_fn = None
    if mesh is not None:
        print(f"tile-parallel over {mesh.size} devices")
    if opt.bank_sharded:
        bank = shard_bank(bank, mesh)
        retrieval_fn = make_ring_retrieval(mesh, queries_sharded=True)
        print(f"memory bank sharded over {mesh.size} devices "
              f"(~{bank.noise_flat[0].nbytes / 1e6:.1f} MB noise bank per device)")

    base = load_params(opt.base_ckpt, build_network(
        opt.arch, None, opt.n_channel, opt.n_feature))
    dtype = torch.bfloat16 if opt.dtype == "bfloat16" else torch.float32
    fwd = make_forward(base, device=device, dtype=dtype, mesh=mesh)
    adapter = build_memory_adapter(opt.adapter_variant, opt.n_channel,
                                   opt.adapter_hidden)
    adapter.load_state_dict(load_checkpoint(opt.adapter_ckpt, arch=opt.adapter_variant),
                            strict=True)
    wrapper = DenoiserWithMemoryAdapter(fwd, adapter, retrieval_fn).to(device).eval()
    print(f"Loaded base from {opt.base_ckpt}; adapter from {opt.adapter_ckpt}")
    if mesh is None:
        model_call, pre_tile_fn = make_memory_model_call(
            wrapper, bank, opt.n_channel, opt.hoist_retrieval, opt.retrieval_chunk)
    else:
        model_call, pre_tile_fn = make_memory_mesh_call(
            wrapper, bank, mesh, opt.n_channel, opt.hoist_retrieval,
            opt.retrieval_chunk)

    pred_cache: dict = {}
    burst_stream = None
    save_mode = opt.save_images
    fetch_pred = not opt.device_metrics or save_mode != "none"
    if opt.frame_burst > 1 or opt.device_metrics:
        fb = max(opt.frame_burst, 1)
        by_shape: dict = {}
        for j, nz in enumerate(noisy_imgs):
            shape = _squeeze2d(nz, f"frame {j}").shape
            if opt.device_metrics and _squeeze2d(clean_imgs[j], f"clean {j}").shape != shape:
                raise ValueError(
                    f"--device_metrics scores per shape bucket: clean/noisy "
                    f"shapes differ for frame {j}")
            by_shape.setdefault(shape, []).append(j)

        def make_runner(h, w):
            return make_tiled_hann_runner_frames(
                model_call, fb, h, w, ps=opt.patch_size,
                overlap=opt.overlap, batch=opt.tile_batch,
                out_dtype="uint8_round", pre_tile_fn=pre_tile_fn, device=device,
                mesh=mesh)

        post = None
        if opt.device_metrics:
            # E6 reports PSNR (and IoU) only: ssim=False skips the SSIM work
            post = make_clean_post(
                lambda j: _squeeze2d(clean_imgs[j], f"clean {j}").astype(np.uint8), fb,
                make_device_metrics(iq_iou=opt.compute_iq_iou, low_q=opt.iq_low_q,
                                    high_q=opt.iq_high_q, ssim=False))
        burst_stream = iter_bursts(
            by_shape, lambda j: _squeeze2d(noisy_imgs[j], f"frame {j}").astype(np.uint8),
            fb, make_runner, post=post)

    t_start = time.perf_counter()
    drain_log: list = []
    writer = MetricsWriter()

    def _host_pass(i, noisy_name, clean255, pred255, dev_m):
        """One frame's PNG and metrics: inline, or in the --host_workers
        pool (finalized in frame order)."""
        if save_mode != "none":
            save_png(pred255, os.path.join(opt.save_dir,
                                           f"{noisy_name}_denoised_mem.png"),
                     mode="L")
        ious = None
        if dev_m is not None:
            psnr = float(dev_m[0])  # the ssim=False scorer: (psnr,) or (psnr, ious)
            if not np.isfinite(psnr):
                psnr = 99.0  # the host path's mse == 0 guard
            if len(dev_m) > 1:
                ious = [float(v) for v in dev_m[1]]
        else:
            psnr = calculate_psnr(pred255, clean255, zero_mse_psnr=99.0)
        msg = f"[{i + 1}/{len(clean_imgs)}] {noisy_name} -> PSNR: {psnr:.2f}"
        if opt.compute_iq_iou:
            if ious is None:
                ious = compute_iq_iou(pred255, clean255, opt.iq_low_q, opt.iq_high_q)
            msg += f", IoU(d/m/b)=({ious[0]:.3f},{ious[1]:.3f},{ious[2]:.3f})"
        return msg, dict(psnr=psnr, ious=ious)

    with HostWorkPool(opt.host_workers, make_metrics_finalize(writer)) as pool:
        for i, (clean, noisy) in enumerate(zip(clean_imgs, noisy_imgs)):
            noisy_name = os.path.basename(noisy_paths[i]).split(".")[0]
            clean255 = np.asarray(clean).astype(np.uint8)
            dev_m = None
            if burst_stream is not None:
                while i not in pred_cache:
                    chunk = drain_burst(next(burst_stream), pred_cache, fetch_pred)
                    drain_log.append({"t": round(time.perf_counter() - t_start, 4),
                                      "frames": list(chunk)})
                pred255, dev_m = pred_cache.pop(i)
            else:
                pred255 = denoise_tiled_hann(
                    model_call, np.asarray(noisy), ps=opt.patch_size,
                    overlap=opt.overlap, batch=opt.tile_batch,
                    out_dtype="uint8_round", pre_tile_fn=pre_tile_fn,
                    device=device, mesh=mesh)[..., 0]
            pool.submit(_host_pass, i, noisy_name, clean255, pred255, dev_m)

    if opt.timing_json and drain_log:
        px = int(np.shape(noisy_imgs[0])[0]) * int(np.shape(noisy_imgs[0])[1])
        with open(opt.timing_json, "w") as f:
            json.dump({"px_per_frame": px, "drains": drain_log}, f)

    writer.write(opt.save_dir)
    avg = writer.averages()
    print(f"Average PSNR: {avg['psnr']:.2f}")
    if opt.compute_iq_iou and "iou_dark" in avg:
        print("Average IQ-3class IoU - "
              f"dark: {avg['iou_dark']:.4f}, mid: {avg['iou_mid']:.4f}, "
              f"bright: {avg['iou_bright']:.4f}")
    return avg


def main(argv=None):
    return evaluate(parse_args(argv))


if __name__ == "__main__":
    main()
