"""Synthetic noise augmentation (counterpart of ``image_denoising_tpu/ops/noise.py``).

Reference semantics (``train.py:64-131``): style strings ``gauss<σ>``,
``gauss<σ1>_<σ2>``, ``poisson<λ>``, ``poisson<λ1>_<λ2>``; Gaussian σ is given
in /255 units, Poisson λ in absolute units; range styles draw one parameter
per sample, uniformly. The device path takes an explicit ``torch.Generator``
on the tensor's device (the JAX version takes a key): the two packages'
noise differs by design, its distribution does not.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = ["AugmentNoise"]


def _parse(style: str) -> Tuple[str, Tuple[float, ...]]:
    if style.startswith("gauss"):
        params = tuple(float(p) / 255.0 for p in style.replace("gauss", "", 1).split("_"))
        return ("gauss_fix" if len(params) == 1 else "gauss_range"), params
    if style.startswith("poisson"):
        params = tuple(float(p) for p in style.replace("poisson", "", 1).split("_"))
        return ("poisson_fix" if len(params) == 1 else "poisson_range"), params
    raise ValueError(f"unknown noise style {style!r}")


class AugmentNoise:
    """Adds synthetic train/valid noise to images in [0,1]."""

    def __init__(self, style: str):
        self.style, self.params = _parse(style)

    # --- device path (train) -------------------------------------------------
    def add_train_noise(self, gen: torch.Generator, x: torch.Tensor) -> torch.Tensor:
        """x: [B, ...] float on ``gen``'s device; range styles draw [B,1,1,1]."""
        bshape = (x.shape[0],) + (1,) * (x.dim() - 1)

        def uniform(lo, hi):
            u = torch.rand(bshape, generator=gen, device=x.device, dtype=x.dtype)
            return lo + (hi - lo) * u

        if self.style == "gauss_fix":
            std = self.params[0]
            return x + torch.randn(x.shape, generator=gen, device=x.device, dtype=x.dtype) * std
        if self.style == "gauss_range":
            std = uniform(*self.params)
            return x + torch.randn(x.shape, generator=gen, device=x.device, dtype=x.dtype) * std
        if self.style == "poisson_fix":
            lam = self.params[0]
            return torch.poisson(lam * x, generator=gen) / lam
        if self.style == "poisson_range":
            lam = uniform(*self.params)
            return torch.poisson(lam * x, generator=gen) / lam
        raise AssertionError(self.style)

    # --- host path (validation) ----------------------------------------------
    def add_valid_noise(self, x):
        shape = x.shape
        if self.style == "gauss_fix":
            std = self.params[0]
            return np.asarray(x + np.random.normal(size=shape) * std, dtype=np.float32)
        if self.style == "gauss_range":
            min_std, max_std = self.params
            std = np.random.uniform(low=min_std, high=max_std, size=(1, 1, 1))
            return np.asarray(x + np.random.normal(size=shape) * std, dtype=np.float32)
        if self.style == "poisson_fix":
            lam = self.params[0]
            return np.asarray(np.random.poisson(lam * x) / lam, dtype=np.float32)
        if self.style == "poisson_range":
            min_lam, max_lam = self.params
            lam = np.random.uniform(low=min_lam, high=max_lam, size=(1, 1, 1))
            return np.asarray(np.random.poisson(lam * x) / lam, dtype=np.float32)
        raise AssertionError(self.style)
