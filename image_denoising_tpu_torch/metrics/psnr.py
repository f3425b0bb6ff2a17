"""Peak signal-to-noise ratio in the 255 domain (``utils_eval.py:49-53``)."""
from __future__ import annotations

import numpy as np

__all__ = ["calculate_psnr"]


def calculate_psnr(target, ref) -> float:
    """10·log10(255² / MSE) with float32 accumulation; ``inf`` for identical
    images, as the reference's eval scripts give (the JAX package's
    ``zero_mse_psnr=None``)."""
    img1 = np.asarray(target, dtype=np.float32)
    img2 = np.asarray(ref, dtype=np.float32)
    mse = np.mean(np.square(img1 - img2))
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(255.0 * 255.0 / mse))
