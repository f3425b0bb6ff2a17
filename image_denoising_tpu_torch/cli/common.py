"""Shared CLI plumbing for the E2 and E6 evaluators and the trainer
(counterpart of the parts of ``image_denoising_tpu/cli/common.py`` that
``evaluation_704``, ``evaluation_704_iqsl_memory`` and ``train`` use).

Model construction, ``.pth`` loading, PNG writing, the per-image metrics
file, the lazy burst stream of ``--frame_burst``, and the trainer's
``--dtype`` and ``--blindspot`` flags.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..ckpt.io import load_checkpoint
from ..models.improved_unet import ImprovedUNet

__all__ = [
    "add_blindspot_flag",
    "add_dtype_flag",
    "resolve_dtype",
    "build_network",
    "load_params",
    "save_png",
    "MetricsWriter",
    "iter_bursts",
    "drain_burst",
    "make_metrics_finalize",
]


def add_blindspot_flag(parser) -> None:
    """--blindspot: the 4-rotation blindspot UNet/RESNET with an explicit
    --arch (those networks are not ported yet, ROADMAP.md)."""
    parser.add_argument(
        "--blindspot", action="store_true",
        help="build the blindspot variant (4-rotation stack, shifted "
             "convs/pools) when --arch is given (not ported yet)",
    )


def add_dtype_flag(parser, default: str = "float32") -> None:
    """--dtype: compute dtype for the model (params always stay float32)."""
    parser.add_argument(
        "--dtype", type=str, default=default,
        choices=["float32", "bfloat16"],
        help="compute dtype; params stay float32",
    )


def resolve_dtype(name: Optional[str]):
    """'bfloat16' → torch.bfloat16; 'float32'/None → None (f32 compute)."""
    return torch.bfloat16 if name == "bfloat16" else None


def build_network(arch: Optional[str], log_name: Optional[str],
                  n_channel: int, n_feature: int, dtype: Optional[torch.dtype] = None,
                  remat: bool = False, remat_depth: Optional[int] = None) -> ImprovedUNet:
    """Explicit ``--arch`` wins; otherwise the reference ``--log_name``
    substring dispatch (``train.py:298-314``). Only UNetImproved is ported.
    ``dtype`` is the compute dtype (parameters stay float32); ``remat`` and
    ``remat_depth`` recompute blocks in backward (``ImprovedUNet``)."""
    if arch:
        name = arch
    elif log_name:
        name = next((a for a in ("UNET", "RESNET", "UNetImproved")
                     if a in log_name), None)
        if name is None:
            raise ValueError(
                f"log_name {log_name!r} matches no architecture "
                "(need one of UNET / RESNET / UNetImproved as a substring)")
    else:
        raise ValueError("need --arch or --log_name to select an architecture")
    if name != "UNetImproved":
        raise NotImplementedError(
            f"architecture {name!r} is not ported yet (only UNetImproved); "
            "see ROADMAP.md")
    return ImprovedUNet(in_nc=n_channel, out_nc=n_channel, n_feature=n_feature,
                        dtype=dtype, remat=remat, remat_depth=remat_depth)


def load_params(ckpt_path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load a reference-layout ``.pth`` into ``model`` with ``strict=True``."""
    model.load_state_dict(load_checkpoint(ckpt_path), strict=True)
    return model


def save_png(arr: np.ndarray, path: str, mode: Optional[str] = "RGB") -> None:
    """uint8 array → PNG with PIL convert semantics (compress_level=1 is
    lossless, like the default, and faster to encode)."""
    from PIL import Image

    img = Image.fromarray(arr)
    if mode:
        img = img.convert(mode)
    img.save(path, compress_level=1)


def iter_bursts(by_shape, get_frame, fb, make_runner, max_inflight=3):
    """Lazy burst stream for ``--frame_burst``.

    One runner per frame-shape bucket ({(h, w): [frame indices]}); frames
    are loaded per chunk via ``get_frame(j)`` (2-D uint8), the tail chunk is
    padded by repeating its last frame, and at most ``max_inflight`` bursts
    are queued on the device so host work on drained frames overlaps device
    work on later ones. Yields ``(chunk, runner_out)``.
    """
    for (h, w), idxs in sorted(by_shape.items()):
        runner = make_runner(h, w)
        inflight = []
        for s in range(0, len(idxs), fb):
            chunk = idxs[s : s + fb]
            batchf = np.stack([get_frame(j) for j in chunk])
            if len(chunk) < fb:
                batchf = np.concatenate(
                    [batchf, np.repeat(batchf[-1:], fb - len(chunk), 0)]
                )
            inflight.append((chunk, runner(torch.from_numpy(batchf))))
            if len(inflight) >= max_inflight:
                yield inflight.pop(0)
        while inflight:
            yield inflight.pop(0)


def drain_burst(item, cache):
    """Fetch one burst to the host: cache[j] = (pred, *per-frame scalars).

    The runner returns the [F, H, W] uint8 predictions alone (the Hann
    engine) or with [F] per-frame scalars (the pyramid engine's L1).
    Returns the drained chunk of frame indices.
    """
    chunk, out = item
    preds, *scalars = out if isinstance(out, tuple) else (out,)
    preds = preds.cpu().numpy()
    scalars = [s.cpu().numpy() for s in scalars]
    for k, j in enumerate(chunk):
        cache[j] = (preds[k], *(float(s[k]) for s in scalars))
    return chunk


def make_metrics_finalize(writer):
    """Per-frame finalize: record ``(msg, writer_kwargs)`` and print ``msg``."""

    def _finalize(res):
        msg, add_kw = res
        writer.add(**add_kw)
        print(msg)

    return _finalize


class MetricsWriter:
    """Accumulates per-image metrics and writes the reference metrics.txt."""

    def __init__(self):
        self.psnr, self.ssim, self.l1 = [], [], []
        self.iou_dark, self.iou_mid, self.iou_bright = [], [], []

    def add(self, psnr=None, ssim=None, l1=None, ious=None):
        if psnr is not None:
            self.psnr.append(psnr)
        if ssim is not None:
            self.ssim.append(ssim)
        if l1 is not None:
            self.l1.append(l1)
        if ious is not None:
            self.iou_dark.append(ious[0])
            self.iou_mid.append(ious[1])
            self.iou_bright.append(ious[2])

    def averages(self):
        out = {}
        if self.psnr:
            out["psnr"] = float(np.mean(self.psnr))
        if self.ssim:
            out["ssim"] = float(np.mean(self.ssim))
        if self.l1:
            out["l1"] = float(np.mean(self.l1))
        if self.iou_dark:
            out["iou_dark"] = float(np.nanmean(self.iou_dark))
            out["iou_mid"] = float(np.nanmean(self.iou_mid))
            out["iou_bright"] = float(np.nanmean(self.iou_bright))
        return out

    def write(self, save_dir: str) -> str:
        avg = self.averages()
        path = os.path.join(save_dir, "metrics.txt")
        with open(path, "w") as f:
            if "psnr" in avg:
                f.write(f"Average PSNR: {avg['psnr']:.2f}\n")
            if "ssim" in avg:
                f.write(f"Average SSIM: {avg['ssim']:.4f}\n")
            if "l1" in avg:
                f.write(f"Average L1 Loss: {avg['l1']:.6f}\n")
            if "iou_dark" in avg:
                f.write(
                    "Average 3-class IoU (dark/mid/bright): "
                    f"{avg['iou_dark']:.4f}, {avg['iou_mid']:.4f}, {avg['iou_bright']:.4f}\n"
                )
        print(f"Saved metrics to {path}")
        return path
