"""Peak signal-to-noise ratio in the 255 domain (``utils_eval.py:49-53``)."""
from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["calculate_psnr"]


def calculate_psnr(target, ref, *, zero_mse_psnr: Optional[float] = None) -> float:
    """10·log10(255² / MSE) with float32 accumulation.

    Identical images give ``inf``, as the reference's eval scripts do, or
    ``zero_mse_psnr`` where the caller guards them: the adapter trainers and
    evaluators pass 99 (``finetune.py:165-173``), the JAX package's default.
    """
    img1 = np.asarray(target, dtype=np.float32)
    img2 = np.asarray(ref, dtype=np.float32)
    mse = np.mean(np.square(img1 - img2))
    if mse == 0:
        return float("inf") if zero_mse_psnr is None else float(zero_mse_psnr)
    return float(10.0 * np.log10(255.0 * 255.0 / mse))
