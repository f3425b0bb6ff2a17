"""Intensity-Quantized Structural Loss (counterpart of ``image_denoising_tpu/losses/iqsl.py``).

Reference semantics (``finetune_iqsl.py:262-383``): a 3-class (dark/mid/
bright) soft segmentation surrogate. Hard targets come from thresholding
the clean image at (t1, t2); soft predictions are a softmax over
−|pred−center|/τ with class centers (t1/2, (t1+t2)/2, (t2+1)/2). Loss =
multi-class Dice + ce_factor · soft cross-entropy, with an optional
don't-care margin around the thresholds. The thresholds are global
quantiles of the clean set, estimated once on the host. Tensors are NCHW
with C == 1, as in ``losses/pixel.py``.
"""
from __future__ import annotations

import glob
import os
from typing import Tuple

import numpy as np
import torch

__all__ = ["iqsl_loss", "estimate_intensity_thresholds"]


def estimate_intensity_thresholds(
    data_dir: str, q1: float = 0.2, q2: float = 0.8, max_images: int = 50
) -> Tuple[float, float]:
    """Quantiles of the pooled clean/ pixel distribution in [0,1] scale."""
    from PIL import Image

    clean_paths = sorted(glob.glob(os.path.join(data_dir, "clean", "*")))[:max_images]
    if not clean_paths:
        raise RuntimeError(f"No clean images found in {os.path.join(data_dir, 'clean')}")
    all_pixels = np.concatenate([
        (np.asarray(Image.open(p), dtype=np.float32) / 255.0).reshape(-1)
        for p in clean_paths])
    if not 0.0 < q1 < q2 < 1.0:
        raise ValueError("iqsl_q1, iqsl_q2 must satisfy 0 < q1 < q2 < 1.")
    return float(np.quantile(all_pixels, q1)), float(np.quantile(all_pixels, q2))


def iqsl_loss(pred, target, t1: float, t2: float, tau: float = 0.1,
              margin: float = 0.0, ce_factor: float = 0.5, eps: float = 1e-6):
    """pred/target: NCHW with C == 1 (grayscale), values in [0,1]."""
    if pred.shape != target.shape or pred.shape[1] != 1:
        raise ValueError(f"IQSL takes single-channel pred and target of one shape; "
                         f"got {tuple(pred.shape)} and {tuple(target.shape)}")
    y = target[:, 0]  # [B,H,W]
    y_hat = pred[:, 0]

    if margin > 0.0:
        valid = ((y <= (t1 - margin))
                 | ((y >= (t1 + margin)) & (y <= (t2 - margin)))
                 | (y >= (t2 + margin))).to(y.dtype)
    else:
        valid = torch.ones_like(y)

    dark = (y <= t1).to(y.dtype)
    mid = ((y > t1) & (y < t2)).to(y.dtype)
    bright = (y >= t2).to(y.dtype)
    target_oh = torch.stack([dark, mid, bright], dim=-1)  # [B,H,W,3]

    # the centers as host scalars, cast to the prediction's dtype in each op:
    # no copy to the device
    centers = (t1 / 2.0, (t1 + t2) / 2.0, (t2 + 1.0) / 2.0)
    dist = torch.stack([(y_hat - c).abs() for c in centers], dim=-1)
    tau = max(float(tau), 1e-6)
    prob = torch.softmax(-dist / tau, dim=-1)

    valid_b = valid[..., None]
    prob = prob * valid_b
    target_oh = target_oh * valid_b

    inter = (prob * target_oh).sum(dim=(0, 1, 2))
    pred_sum = prob.sum(dim=(0, 1, 2))
    tgt_sum = target_oh.sum(dim=(0, 1, 2))
    dice = (2.0 * inter + eps) / (pred_sum + tgt_sum + eps)
    loss_dice = 1.0 - dice.mean()

    ce = -(target_oh * torch.log(prob + eps)).sum()
    valid_count = valid_b.sum() * 3
    ce = ce / (valid_count + eps)
    return loss_dice + ce_factor * ce
