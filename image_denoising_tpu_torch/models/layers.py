"""Shared NCHW layer primitives (counterpart of ``image_denoising_tpu/models/layers.py``).

``Conv2d`` and ``Deconv2x2`` carry flax's compute-dtype semantics: the
parameters stay float32, and with a ``compute_dtype`` set the input, weight
and bias are cast to it for the conv (so gradients reach the float32
parameters through the cast). The blind-spot helpers are the reference's
shifted conv and pool (``arch_unet.py:65-97``) on NCHW.

Documented difference: the JAX package computes LeakyReLU as
``max(x, 0.2·x)``, whose gradient at x == 0 is 0.6; here it is torch's
``F.leaky_relu`` (the reference's op, gradient 0.2 there). The forward is
identical.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .init import init_conv_

__all__ = ["LEAKY_SLOPE", "Conv2d", "Deconv2x2", "blindspot_conv",
           "blindspot_output_shift", "blindspot_pool", "gn_groups", "leaky_relu",
           "max_pool_2x2", "pixel_shuffle", "rotate"]

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


class Conv2d(nn.Conv2d):
    """SAME conv (VALID for 1×1) with JAX ``Conv``'s init regimes
    (``init_conv_``: ``torch``, ``kaiming01`` or ``zeros``) that computes in
    ``compute_dtype`` when one is set (flax ``nn.Conv(dtype=...)``)."""

    compute_dtype: Optional[torch.dtype] = None

    def __init__(self, cin: int, cout: int, kernel: int = 3, bias: bool = True,
                 init: str = "torch"):
        super().__init__(cin, cout, kernel, padding=kernel // 2, bias=bias)
        init_conv_(self, init)

    def forward(self, x):
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class Deconv2x2(nn.ConvTranspose2d):
    """ConvTranspose2d(cin, cout, k=2, s=2), weight in torch's (in, out, 2, 2)
    layout: y[n, o, 2i+di, 2j+dj] = Σ_c x[n, c, i, j]·W[c, o, di, dj] + b[o],
    the JAX package's einsum. Kaiming-normal·0.1 with torch's deconv fan
    (out·4), zero bias."""

    compute_dtype: Optional[torch.dtype] = None

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 2, stride=2)
        init_conv_(self, "kaiming01")

    def forward(self, x):
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt), self.bias.to(dt),
                                  stride=2)


def rotate(x, angle: int):
    """``torch.rot90(x, k, dims=(3, 2))`` on NCHW, k = angle / 90: the
    reference's op, and JAX's ``jnp.rot90(axes=(2, 1))`` on NHWC."""
    if angle == 0:
        return x
    return torch.rot90(x, {90: 1, 180: 2, 270: 3}[angle], dims=(3, 2))


def _shift_down(x, rows: int = 1):
    """Rows moved down by ``rows``: zeros on top, the bottom rows dropped."""
    return F.pad(x[:, :, :-rows], (0, 0, rows, 0))


def blindspot_conv(x, conv_fn: Callable, kernel: int, blindspot: bool):
    """conv_func (arch_unet.py:65-78): pad the top by k//2 rows, SAME conv,
    crop as many rows off the bottom. 1×1 convs run as they are."""
    if not blindspot or kernel == 1:
        return conv_fn(x)
    ofs = kernel // 2
    return conv_fn(F.pad(x, (0, 0, ofs, 0)))[:, :, :-ofs]


def blindspot_pool(x, blindspot: bool):
    """pool_func (arch_unet.py:81-86): rows shifted down by 1, then the
    floor 2×2 max-pool."""
    return max_pool_2x2(_shift_down(x) if blindspot else x)


def blindspot_output_shift(x):
    """The row shift before the 4-way merge (arch_unet.py:246-247)."""
    return _shift_down(x)
