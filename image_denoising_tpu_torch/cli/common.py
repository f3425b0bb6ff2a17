"""Shared CLI plumbing for the E2 and E6 evaluators, the trainer and the
finetuners (counterpart of the parts of ``image_denoising_tpu/cli/common.py``
that ``evaluation_704``, ``evaluation_704_iqsl_memory``, ``train`` and
``finetune*`` use).

Model construction, ``.ckpt`` and ``.pth`` loading, PNG writing, the
per-image metrics file, the lazy burst stream of ``--frame_burst``, and the
trainer's ``--dtype`` and ``--blindspot`` flags.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..ckpt.io import load_checkpoint, module_arch
from ..models.improved_unet import ImprovedUNet
from ..models.registry import build_model, build_model_from_log_name

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
    "refuse_unported",
    "load_frozen_base",
    "iqsl_config",
    "run_epoch",
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
    substring dispatch (``models/registry.py``). Only UNetImproved is
    ported. ``dtype`` is the compute dtype (parameters stay float32);
    ``remat`` and ``remat_depth`` recompute blocks in backward."""
    if arch:
        return build_model(arch, n_channel, n_feature, dtype=dtype, remat=remat,
                           remat_depth=remat_depth)
    if log_name:
        return build_model_from_log_name(log_name, n_channel, n_feature, dtype=dtype,
                                         remat=remat, remat_depth=remat_depth)
    raise ValueError("need --arch or --log_name to select an architecture")


def load_params(ckpt_path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load a ``.ckpt`` params tree or a reference-layout ``.pth`` into
    ``model`` with ``strict=True``."""
    model.load_state_dict(load_checkpoint(ckpt_path, arch=module_arch(model)),
                          strict=True)
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


# the finetuners (cli/finetune.py, finetune_iqsl.py, finetune_memory.py)

def refuse_unported(opt, flags=("parallel",)):
    """NotImplementedError for the multi-device flags (ROADMAP.md queue 1
    item 8), before anything is loaded."""
    refused = [f"--{n}" for n in flags if getattr(opt, n)]
    if "," in opt.gpu_devices:
        refused.append("--gpu_devices with several cards")
    if refused:
        raise NotImplementedError(
            f"{', '.join(refused)} not ported to the PyTorch package yet "
            "(ROADMAP.md queue 1 item 8)")


def load_frozen_base(opt, device):
    """(base module, its frozen forward on ``device``): the ``--arch``
    network with ``--pretrained_ckpt``'s weights, run by
    ``make_fused_forward`` in the ``--dtype`` compute dtype."""
    from ..models.fused_forward import make_fused_forward

    base = load_params(opt.pretrained_ckpt,
                       build_model(opt.arch, opt.n_channel, opt.n_feature))
    print(f"Loaded base weights from {opt.pretrained_ckpt}")
    dtype = torch.bfloat16 if opt.dtype == "bfloat16" else torch.float32
    return base, make_fused_forward(base, device=device, dtype=dtype)


def iqsl_config(opt):
    """The IQSL settings, thresholds estimated from clean/ when λ_iqsl > 0."""
    from ..losses import estimate_intensity_thresholds

    if opt.lambda_iqsl > 0.0:
        t1, t2 = estimate_intensity_thresholds(
            opt.data_dir, q1=opt.iqsl_q1, q2=opt.iqsl_q2, max_images=opt.iqsl_max_images)
        print(f"[IQSL] Estimated thresholds from clean/: t1={t1:.6f}, t2={t2:.6f}")
    else:
        t1 = t2 = 0.0
        print("[IQSL] lambda_iqsl=0 → IQSL disabled.")
    return {"t1": t1, "t2": t2, "tau": opt.iqsl_tau, "margin": opt.iqsl_margin,
            "ce_factor": opt.iqsl_ce_factor}


def run_epoch(step, batches, epoch, n_epoch, *bank, iqsl: bool = True):
    """One epoch of ``step`` over ``batches`` with the CLIs' lag-1 metric
    fetch (step i's metrics are read after step i+1 is queued) and their
    log lines; returns the per-step L1 and IQSL values."""
    losses_l1, losses_iqsl = [], []
    pending = None

    def flush(p):
        i, m = p
        losses_l1.append(float(m["l1"]))
        losses_iqsl.append(float(m["iqsl"]))
        if i % 10 == 0:
            print(f"Epoch [{epoch}/{n_epoch}] Iter [{i}] L1={float(m['l1']):.6f} "
                  f"Grad={float(m['grad']):.6f} "
                  + (f"IQSL={float(m['iqsl']):.6f} " if iqsl else "")
                  + f"Total={float(m['loss']):.6f}")

    for i, (clean, noisy) in enumerate(batches, start=1):
        metrics = step(clean, noisy, *bank)
        if pending is not None:
            flush(pending)
        pending = (i, metrics)
    if pending is not None:
        flush(pending)
    return losses_l1, losses_iqsl
