"""MATLAB-equivalent SSIM on the host (``utils_eval.py:19-47``).

11×11 Gaussian window σ=1.5 (cv2.getGaussianKernel outer product),
correlation with REFLECT_101 borders (``scipy.ndimage.correlate`` with
``mode='mirror'``), a [5:-5, 5:-5] valid crop, C1=(0.01·255)²,
C2=(0.03·255)², float64 accumulation.
"""
from __future__ import annotations

import numpy as np

__all__ = ["gaussian_window", "ssim", "calculate_ssim"]

_C1 = (0.01 * 255) ** 2
_C2 = (0.03 * 255) ** 2


def gaussian_window(ksize: int = 11, sigma: float = 1.5) -> np.ndarray:
    ax = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2.0
    k = np.exp(-(ax**2) / (2.0 * sigma**2))
    k /= k.sum()
    return np.outer(k, k)


def _filter_mirror(img: np.ndarray, window: np.ndarray) -> np.ndarray:
    from scipy.ndimage import correlate

    return correlate(img, window, mode="mirror")


def ssim(prediction, target) -> float:
    """Single-channel SSIM on [0,255]-domain 2-D arrays (float64)."""
    img1 = np.asarray(prediction, dtype=np.float64)
    img2 = np.asarray(target, dtype=np.float64)
    window = gaussian_window()
    mu1 = _filter_mirror(img1, window)[5:-5, 5:-5]
    mu2 = _filter_mirror(img2, window)[5:-5, 5:-5]
    mu1_sq, mu2_sq, mu1_mu2 = mu1**2, mu2**2, mu1 * mu2
    sigma1_sq = _filter_mirror(img1**2, window)[5:-5, 5:-5] - mu1_sq
    sigma2_sq = _filter_mirror(img2**2, window)[5:-5, 5:-5] - mu2_sq
    sigma12 = _filter_mirror(img1 * img2, window)[5:-5, 5:-5] - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + _C1) * (2 * sigma12 + _C2)) / (
        (mu1_sq + mu2_sq + _C1) * (sigma1_sq + sigma2_sq + _C2)
    )
    return float(ssim_map.mean())


def calculate_ssim(target, ref) -> float:
    """Dispatch on ndim/channels like the reference wrapper."""
    img1 = np.asarray(target, dtype=np.float64)
    img2 = np.asarray(ref, dtype=np.float64)
    if img1.shape != img2.shape:
        raise ValueError("Input images must have the same dimensions.")
    if img1.ndim == 2:
        return ssim(img1, img2)
    if img1.ndim == 3:
        if img1.shape[2] == 3:
            return float(np.mean([ssim(img1[:, :, i], img2[:, :, i]) for i in range(3)]))
        if img1.shape[2] == 1:
            return ssim(np.squeeze(img1), np.squeeze(img2))
    raise ValueError("Wrong input image dimensions.")
