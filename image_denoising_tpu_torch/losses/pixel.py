"""Pixel losses (the part of ``image_denoising_tpu/losses/pixel.py`` that the
N2N trainer uses; ``structure_loss``, ``l1fft_loss`` and ``gradient_loss``
come with the structure trainer, ROADMAP.md)."""
from __future__ import annotations

__all__ = ["l1_loss", "l2_loss"]


def l1_loss(pred, target):
    return (pred - target).abs().mean()


def l2_loss(pred, target):
    return (pred - target).square().mean()
