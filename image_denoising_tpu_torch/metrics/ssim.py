"""MATLAB-equivalent SSIM (``utils_eval.py:19-47``).

11×11 Gaussian window σ=1.5 (cv2.getGaussianKernel outer product),
correlation with REFLECT_101 borders, a [5:-5, 5:-5] valid crop,
C1=(0.01·255)², C2=(0.03·255)².

* ``ssim`` / ``calculate_ssim``: on the host in float64, by default through
  the native separable filter (``csrc/ssim.cpp``, built with ``g++`` at
  first use, ctypes releasing the GIL so the CLIs' ``--host_workers``
  threads score frames at once); ``native=False`` runs
  ``scipy.ndimage.correlate`` with ``mode='mirror'`` (REFLECT_101).
* ``ssim_torch``: batched float32 on a tensor's device (the counterpart of
  the JAX package's ``ssim_jax``), for ``metrics/device.py``.
"""
from __future__ import annotations

import threading

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["gaussian_window", "ssim", "calculate_ssim", "ssim_torch"]

_C1 = (0.01 * 255) ** 2
_C2 = (0.03 * 255) ** 2

_NATIVE_LOCK = threading.Lock()


def gaussian_window(ksize: int = 11, sigma: float = 1.5) -> np.ndarray:
    return np.outer(_gaussian_1d(ksize, sigma), _gaussian_1d(ksize, sigma))


def _gaussian_1d(ksize: int = 11, sigma: float = 1.5) -> np.ndarray:
    ax = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2.0
    k = np.exp(-(ax**2) / (2.0 * sigma**2))
    return k / k.sum()


def _filter_mirror(img: np.ndarray, window: np.ndarray) -> np.ndarray:
    from scipy.ndimage import correlate

    return correlate(img, window, mode="mirror")


def _native_lib():
    """The native SSIM library, built once: the lock keeps several threads
    of a first ``--host_workers`` pass from compiling it side by side. A
    failed build raises with the compiler's output."""
    from ..ops import _build

    with _NATIVE_LOCK:
        return _build.load_ssim()


def ssim(prediction, target, native: bool = True) -> float:
    """Single-channel SSIM on [0,255]-domain 2-D arrays (float64)."""
    img1 = np.asarray(prediction, dtype=np.float64)
    img2 = np.asarray(target, dtype=np.float64)
    if native and img1.ndim == 2 and min(img1.shape) >= 11:
        import ctypes

        lib = _native_lib()
        a = np.ascontiguousarray(img1)
        b = np.ascontiguousarray(img2)
        if a.shape != b.shape:
            raise ValueError("Input images must have the same dimensions.")
        dp = ctypes.POINTER(ctypes.c_double)
        return float(lib.ssim_gray(a.ctypes.data_as(dp), b.ctypes.data_as(dp),
                                   a.shape[0], a.shape[1]))
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


def _filter_separable(x, taps):
    """[S, H, W] → the 11-tap Gaussian correlation along H then W, REFLECT_101
    borders (torch's ``reflect`` pad), same extent. Shifted multiply-adds in
    float32, so no global TF32 or cuDNN setting can change the result."""
    r = len(taps) // 2
    xp = F.pad(x[:, None], (r, r, r, r), mode="reflect")[:, 0]
    h, w = x.shape[1], x.shape[2]
    rows = taps[0] * xp[:, :h, :]
    for i, t in enumerate(taps[1:], 1):
        rows = rows + t * xp[:, i : i + h, :]
    out = taps[0] * rows[:, :, :w]
    for i, t in enumerate(taps[1:], 1):
        out = out + t * rows[:, :, i : i + w]
    return out


def ssim_torch(pred, target):
    """Batched SSIM on the inputs' device: [B, H, W] in [0, 255] → [B]
    float32, about 1e-6 from the float64 host version.

    The five streams x, y, x², y², xy are filtered as one stack. The filter
    is computed in plain float32 whatever ``torch.backends.cudnn.allow_tf32``
    says: a convolution in TF32 (10-bit mantissa) would lose the digits
    that the E[x²] − µ² cancellation needs (the JAX package forces HIGHEST
    precision on its filter for the same reason).
    """
    img1 = pred.float()
    img2 = target.float()
    b = img1.shape[0]
    stacked = torch.cat([img1, img2, img1 * img1, img2 * img2, img1 * img2])
    f = _filter_separable(stacked, [float(t) for t in _gaussian_1d()])[:, 5:-5, 5:-5]
    mu1, mu2, e11, e22, e12 = f.split(b)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = e11 - mu1_sq
    sigma2_sq = e22 - mu2_sq
    sigma12 = e12 - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + _C1) * (2 * sigma12 + _C2)) / (
        (mu1_sq + mu2_sq + _C1) * (sigma1_sq + sigma2_sq + _C2)
    )
    return ssim_map.mean(dim=(1, 2))
