"""Shared NCHW layer primitives (counterpart of ``image_denoising_tpu/models/layers.py``).

Documented difference: the JAX package computes LeakyReLU as
``max(x, 0.2·x)``, whose gradient at x == 0 is 0.6; here it is torch's
``F.leaky_relu`` (the reference's op, gradient 0.2 there). The forward is
identical.
"""
from __future__ import annotations

import torch.nn.functional as F

__all__ = ["LEAKY_SLOPE", "leaky_relu", "gn_groups", "max_pool_2x2",
           "pixel_shuffle"]

LEAKY_SLOPE = 0.2


def leaky_relu(x):
    return F.leaky_relu(x, LEAKY_SLOPE)


def gn_groups(channels: int, groups: int = 32) -> int:
    """Group count with the reference's divisibility fallback (arch_unet.py:12-14)."""
    g = min(groups, channels)
    while channels % g != 0 and g > 1:
        g -= 1
    return g


def max_pool_2x2(x):
    """torch MaxPool2d(2): floor semantics (odd trailing row/col dropped)."""
    return F.max_pool2d(x, 2)


def pixel_shuffle(x, r: int = 2):
    """NCHW PixelShuffle; torch's channel order c_in = c_out·r² + i·r + j."""
    return F.pixel_shuffle(x, r)
