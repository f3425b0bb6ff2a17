"""Space-to-depth as a reshape and a permute, NCHW (counterpart of
``image_denoising_tpu/ops/space_to_depth.py``).

The reference implements it with ATen ``unfold`` (``train.py:134-138``).
Output channel index = c·4 + kh·2 + kw: per input channel the 2×2 cell is
flattened [TL, TR, BL, BR], as torch's unfold orders it.
"""
from __future__ import annotations

import torch

__all__ = ["space_to_depth", "depth_to_space"]


def space_to_depth(x: torch.Tensor, block_size: int = 2) -> torch.Tensor:
    """[N, C, H, W] → [N, C·b², H/b, W/b] with (c, kh, kw) channel order."""
    n, c, h, w = x.shape
    b = block_size
    x = x.reshape(n, c, h // b, b, w // b, b)
    return x.permute(0, 1, 3, 5, 2, 4).reshape(n, c * b * b, h // b, w // b)


def depth_to_space(x: torch.Tensor, block_size: int = 2) -> torch.Tensor:
    """Inverse of :func:`space_to_depth`."""
    n, cb, hb, wb = x.shape
    b = block_size
    c = cb // (b * b)
    x = x.reshape(n, c, b, b, hb, wb)
    return x.permute(0, 1, 4, 2, 5, 3).reshape(n, c, hb * b, wb * b)
