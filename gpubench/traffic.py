"""The inputs of every traffic mix, made from the seed on the host.

SEM-like frames: a smooth background and bright grains with soft edges
(each a random field on a coarse grid, upsampled bilinearly), plus
Gaussian noise, all in uint8. A traffic file's ``frames`` entry sets the
sizes; the same seed gives the same frames, and every seed the same sizes.
"""
from __future__ import annotations

import numpy as np


def _upsample(c: np.ndarray, h: int, w: int) -> np.ndarray:
    """Bilinear [n, a, b] → [n, h, w], corners on corners."""
    a, b = c.shape[1:]
    y = np.linspace(0, a - 1, h)
    x = np.linspace(0, b - 1, w)
    y0 = np.minimum(y.astype(np.int64), a - 2)
    x0 = np.minimum(x.astype(np.int64), b - 2)
    fy = (y - y0)[None, :, None].astype(np.float32)
    fx = (x - x0)[None, None, :].astype(np.float32)
    top, bot = c[:, y0], c[:, y0 + 1]
    top = top[:, :, x0] * (1 - fx) + top[:, :, x0 + 1] * fx
    bot = bot[:, :, x0] * (1 - fx) + bot[:, :, x0 + 1] * fx
    return top * (1 - fy) + bot * fy


def clean_frames(rng: np.random.Generator, n: int, h: int, w: int) -> np.ndarray:
    """float32 [n, h, w] in [0, 255]: background 60–180, grains +70."""
    back = _upsample(rng.random((n, h // 64 + 2, w // 64 + 2), dtype=np.float32), h, w)
    grain = _upsample(rng.random((n, h // 12 + 2, w // 12 + 2), dtype=np.float32), h, w)
    edge = np.clip((grain - 0.62) * 12.0, 0.0, 1.0)
    return 60.0 + 120.0 * back + 70.0 * edge


def noisy_frames(rng: np.random.Generator, clean: np.ndarray, sigma: float) -> np.ndarray:
    noise = rng.standard_normal(clean.shape, dtype=np.float32) * np.float32(sigma)
    return np.clip(clean + noise, 0, 255).astype(np.uint8)


def frame_pool(seed: int, spec) -> np.ndarray:
    """uint8 [pool, h, w] noisy frames (``spec``: pool, hw, sigma)."""
    rng = np.random.default_rng([seed % 2 ** 63, 1])
    hw = spec["hw"]
    return noisy_frames(rng, clean_frames(rng, spec["pool"], hw, hw), spec["sigma"])


def pair_pool(seed: int, spec):
    """(clean, noisy) uint8 NHWC [pool, hw, hw, 1] training pairs."""
    rng = np.random.default_rng([seed % 2 ** 63, 2])
    hw = spec["hw"]
    clean = clean_frames(rng, spec["pool"], hw, hw)
    noisy = noisy_frames(rng, clean, spec["sigma"])
    return clean.astype(np.uint8)[..., None], noisy[..., None]


def epoch_batches(seed: int, pool: int, batch: int):
    """Endless pool indices in batches: each epoch a fresh shuffle, the
    tail dropped (``data/pairs.py``'s ``batches``)."""
    rng = np.random.default_rng([seed % 2 ** 63, 3])
    while True:
        order = rng.permutation(pool)
        for s in range(0, pool - batch + 1, batch):
            yield order[s:s + batch]
