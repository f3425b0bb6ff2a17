"""On-device eval metrics (PSNR, MATLAB-SSIM, IQ-IoU) for ``--device_metrics``.

Counterpart of ``image_denoising_tpu/metrics/device.py``. The CLIs score
each burst of predictions against its clean frames where the predictions
already are: with ``--save_images none`` only scalars cross to the host.
The JAX package's ``vmap`` over frames becomes functions over a batch
[F, H, W] (or [F, H, W, C]); they are plain tensor ops that never wait for
the device, so scoring a burst queues behind its forward.

Accuracy contract: PSNR in float32, identical frames → +inf (the host's
``calculate_psnr`` without a guard); SSIM is ``ssim_torch`` (float32,
about 1e-6 from the host float64 SSIM) per channel and averaged, like
``calculate_ssim``; IoU thresholds are the float32 linear-interpolation
quantiles of the clean frame, as ``jnp.quantile`` computes them.
"""
from __future__ import annotations

import numpy as np
import torch

from .ssim import ssim_torch

__all__ = ["frame_psnr_ssim", "frame_iq_iou", "make_device_metrics"]


def _psnr(p, c):
    """Per-frame PSNR of [F, ...] float32 frames in [0, 255], un-guarded
    (``utils_eval.py:49-53``): identical frames give +inf."""
    mse = torch.square(p - c).flatten(1).mean(dim=1)
    return 10.0 * torch.log10(255.0 * 255.0 / mse)


def _channels_to_batch(x):
    """[F, H, W] → itself; [F, H, W, C] → [F·C, H, W]."""
    return x if x.dim() == 3 else x.permute(0, 3, 1, 2).flatten(0, 1)


def frame_psnr_ssim(pred255, clean255):
    """(psnr [F], ssim [F]) of a batch of [F, H, W] or [F, H, W, C] frames in
    [0, 255]; a multi-channel frame's SSIM is the mean over its channels."""
    p = pred255.float()
    c = clean255.float()
    s = ssim_torch(_channels_to_batch(p), _channels_to_batch(c))
    if p.dim() == 4:
        s = s.view(p.shape[0], p.shape[3]).mean(dim=1)
    return _psnr(p, c), s


def _quantile_weights(n: int, q: float):
    """``jnp.quantile``'s linear interpolation in float32: the two sorted
    positions around q·(n−1) and their weights."""
    pos = np.float32(q) * np.float32(n - 1)
    low, high = int(np.floor(pos)), int(np.ceil(pos))
    hw = np.float32(pos - np.float32(low))
    return low, high, float(np.float32(1) - hw), float(hw)


def frame_iq_iou(pred255, clean255, low_q: float = 0.25, high_q: float = 0.75):
    """[F, 3] float32 IoU (dark, mid, bright) of a batch of frames.

    Mirrors ``metrics/iq_iou.py::compute_iq_iou``: the thresholds are the
    (low_q, high_q) quantiles of each clean gray frame, both frames fall
    into {dark, mid, bright}, the bright label wins on overlap, and a class
    empty in both gives NaN. The quantiles sort each frame: no size limit
    (``torch.quantile`` refuses more than 2²⁴ elements) and no sync.
    """
    gt = clean255.float()
    pr = pred255.float()
    if gt.dim() == 4:
        gt, pr = gt.mean(dim=-1), pr.mean(dim=-1)
    gt, pr = gt.flatten(1) / 255.0, pr.flatten(1) / 255.0
    srt = torch.sort(gt, dim=1).values

    def quantile(q):
        low, high, lw, hw = _quantile_weights(gt.shape[1], q)
        return srt[:, low : low + 1] * lw + srt[:, high : high + 1] * hw

    t1, t2 = quantile(low_q), quantile(high_q)

    def labels(g):
        return torch.where(g >= t2, 2, torch.where(g <= t1, 0, 1))

    gl, pl = labels(gt), labels(pr)
    ious = []
    for k in range(3):
        gk, pk = gl == k, pl == k
        inter = (gk & pk).sum(dim=1).float()
        union = (gk | pk).sum(dim=1).float()
        ious.append(torch.where(union == 0, torch.nan, inter / union.clamp(min=1.0)))
    return torch.stack(ious, dim=1)


def make_device_metrics(iq_iou: bool = False, low_q: float = 0.25,
                        high_q: float = 0.75, ssim: bool = True):
    """A burst scorer ``(pred_u8[F,H,W], clean_u8[F,H,W]) -> (psnr[F],
    ssim[F])``, plus ``ious[F,3]`` when ``iq_iou`` is set. ``ssim=False``
    drops the SSIM work and its output: the tuple is then ``(psnr,)`` or
    ``(psnr, ious)`` (E6 reports PSNR and IoU only)."""

    def score(pred255, clean255):
        if ssim:
            out = list(frame_psnr_ssim(pred255, clean255))
        else:
            out = [_psnr(pred255.float(), clean255.float())]
        if iq_iou:
            out.append(frame_iq_iou(pred255, clean255, low_q, high_q))
        return tuple(out)

    return score
