"""Intensity-quantized 3-class IoU (``evaluation_704_iqsl.py:38-83``).

Thresholds are the (low_q, high_q) quantiles of the ground-truth gray image;
both images are quantized into {dark, mid, bright} and per-class IoU is
returned (NaN when a class is empty in both).
"""
from __future__ import annotations

import numpy as np

__all__ = ["to_gray_float01", "quantize_3class", "compute_iq_iou"]


def to_gray_float01(img) -> np.ndarray:
    """2D or 3D [0,255] image → grayscale float in [0,1] (channel mean)."""
    arr = np.asarray(img, dtype=np.float32)
    if arr.ndim == 3:
        arr = arr.mean(axis=2)
    return arr / 255.0


def quantize_3class(gray: np.ndarray, t1: float, t2: float) -> np.ndarray:
    """[H,W] float in [0,1] → labels {0: dark, 1: mid, 2: bright}."""
    labels = np.zeros_like(gray, dtype=np.int32)
    labels[gray <= t1] = 0
    labels[(gray > t1) & (gray < t2)] = 1
    labels[gray >= t2] = 2
    return labels


def compute_iq_iou(pred255, clean255, low_q: float = 0.25, high_q: float = 0.75):
    """Per-class IoU [dark, mid, bright]; thresholds from GT quantiles."""
    gt_gray = to_gray_float01(clean255)
    t1, t2 = np.quantile(gt_gray, [low_q, high_q])
    gt_lbl = quantize_3class(gt_gray, t1, t2)
    pred_lbl = quantize_3class(to_gray_float01(pred255), t1, t2)
    ious = []
    for k in range(3):
        gt_k, pr_k = gt_lbl == k, pred_lbl == k
        union = np.logical_or(gt_k, pr_k).sum()
        inter = np.logical_and(gt_k, pr_k).sum()
        ious.append(np.nan if union == 0 else float(inter) / float(union))
    return ious
