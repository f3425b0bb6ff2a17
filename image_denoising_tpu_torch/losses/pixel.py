"""Pixel and frequency-domain losses (counterpart of ``image_denoising_tpu/losses/pixel.py``).

* ``structure_loss`` — α·L1(pred_noisy, clean) + β·TV(pred_clean)
  + γ·L1(pred_clean, clean), the A-domain trainer's criterion. TV is the
  reference's: mean |forward difference| of the *clean prediction*,
  averaged over the two axes.
* ``l1fft_loss`` — α·L1 + β·mean|FFT2(pred) − FFT2(target)|.
* ``gradient_loss`` — L1 of forward differences.

All functions take NCHW tensors; the spatial axes are (2, 3). Mixed dtypes
promote as ``jnp`` does: a bfloat16 prediction against a float32 target
gives a float32 L1, and TV of a bfloat16 prediction stays bfloat16.
"""
from __future__ import annotations

import torch

__all__ = ["l1_loss", "l2_loss", "structure_loss", "l1fft_loss", "gradient_loss"]


def l1_loss(pred, target):
    return (pred - target).abs().mean()


def l2_loss(pred, target):
    return (pred - target).square().mean()


def structure_loss(pred, pred2, target, alpha: float = 1.0, beta: float = 0.5,
                   gamma: float = 0.5):
    """pred = net(noisy), pred2 = net(clean), target = clean."""
    pixel = l1_loss(pred, target)
    tv1 = l1_loss(pred2[:, :, 1:, :], pred2[:, :, :-1, :])
    tv2 = l1_loss(pred2[:, :, :, 1:], pred2[:, :, :, :-1])
    tv = (tv1 + tv2) / 2.0
    cst = l1_loss(pred2, target)
    return alpha * pixel + beta * tv + gamma * cst


def l1fft_loss(pred, target, alpha: float = 1.0, beta: float = 1.0):
    pixel = l1_loss(pred, target)
    fp = torch.fft.fft2(pred, dim=(2, 3))
    ft = torch.fft.fft2(target, dim=(2, 3))
    freq = (fp - ft).abs().mean()
    return alpha * pixel + beta * freq


def gradient_loss(pred, target):
    pdx = pred[:, :, :, 1:] - pred[:, :, :, :-1]
    pdy = pred[:, :, 1:, :] - pred[:, :, :-1, :]
    tdx = target[:, :, :, 1:] - target[:, :, :, :-1]
    tdy = target[:, :, 1:, :] - target[:, :, :-1, :]
    return l1_loss(pdx, tdx) + l1_loss(pdy, tdy)
