"""The finetuners' native patch sampler (counterpart of
``image_denoising_tpu/data/native_sampler.py``).

A ctypes binding of the port's own ``csrc/patch_sampler.cpp``, built by
``g++`` into ``build/host/`` at first use (``ops/_build.py::build_host``).
The frames are registered once as uint8; each batch's crops are drawn by a
counter-based SplitMix64 stream keyed by (seed, batch index, item) and
copied to float32 NHWC in [0,1] by the library's threads, so a batch does
not depend on the thread count or on the batches before it.

``sample_plain`` is the same function in numpy, the oracle the tests and
``chip_smoke.py`` hold the library to bit for bit. A failed build raises
with the compiler's output: nothing falls back to another stream.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import numpy as np

__all__ = ["NativePatchSampler", "load_library", "sample_plain"]

_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
_ITEM = np.uint64(0xD1B54A32D192ED03)
_SALT_TOP, _SALT_LEFT = np.uint64(0x11), np.uint64(0x22)
_INV255 = np.float32(1) / np.float32(255)  # the C++ kInv255, a float division


def load_library() -> ctypes.CDLL:
    """The sampler's library, built on first call; raises with ``g++``'s
    output when the build fails."""
    from ..ops import _build

    return _build.load_patch_sampler()


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class NativePatchSampler:
    """Deterministic threaded random-crop batches over resident uint8 pairs."""

    def __init__(self, images: List[Tuple[np.ndarray, np.ndarray]], n_threads: int = 4):
        """images: list of (clean_u8 [H,W,C], noise_u8 [H,W,C])."""
        self._handle = None
        if not images:
            raise ValueError("NativePatchSampler needs at least one image pair")
        self.channels = images[0][0].shape[-1]
        for clean, noise in images:
            # the library copies H·W·C bytes of each and sizes every output
            # item by the first image's C
            if (np.ndim(clean) != 3 or np.shape(clean) != np.shape(noise)
                    or np.shape(clean)[-1] != self.channels):
                raise ValueError("every (clean, noise) pair must be [H,W,C] of one shape, "
                                 f"C = {self.channels}: got {np.shape(clean)}, "
                                 f"{np.shape(noise)}")
        self._lib = load_library()
        self.n_threads = n_threads
        self.n_images = len(images)
        self._handle = self._lib.ps_create(len(images))
        for i, (clean, noise) in enumerate(images):
            clean = np.ascontiguousarray(clean, dtype=np.uint8)
            noise = np.ascontiguousarray(noise, dtype=np.uint8)
            h, w, c = clean.shape
            rc = self._lib.ps_add_image(self._handle, i, _u8p(clean), _u8p(noise), h, w, c)
            if rc != 0:
                raise RuntimeError(f"ps_add_image failed: {rc}")

    def sample(self, seed: int, batch_index: int, img_of_item: np.ndarray,
               patch: int) -> Tuple[np.ndarray, np.ndarray]:
        """→ (clean, noise) float32 [B, patch, patch, C] in [0,1]."""
        batch = len(img_of_item)
        img_of_item = np.ascontiguousarray(img_of_item, dtype=np.int32)
        out_c = np.empty((batch, patch, patch, self.channels), np.float32)
        out_n = np.empty((batch, patch, patch, self.channels), np.float32)
        rc = self._lib.ps_sample_batch(
            self._handle, ctypes.c_uint64(seed), ctypes.c_uint64(batch_index), batch, patch,
            img_of_item.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), _f32p(out_c),
            _f32p(out_n), self.n_threads)
        if rc != 0:
            raise RuntimeError(f"ps_sample_batch failed: {rc}")
        return out_c, out_n

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.ps_destroy(self._handle)
            self._handle = None


def _splitmix64(x):
    x = x + _GOLDEN
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def sample_plain(images: Sequence[Tuple[np.ndarray, np.ndarray]], seed: int,
                 batch_index: int, img_of_item, patch: int) -> Tuple[np.ndarray, np.ndarray]:
    """``NativePatchSampler(images).sample(seed, batch_index, img_of_item,
    patch)`` in numpy, bit for bit: the same SplitMix64 draws in wrapping
    uint64 arithmetic, ``top = r % (H - patch + 1)``, and each byte times
    float32(1/255) in float32. Raises as the library does for an empty
    batch, a bad image index or a patch larger than its image."""
    img_of_item = np.asarray(img_of_item, dtype=np.int32)
    batch = len(img_of_item)
    if batch <= 0 or patch <= 0:
        raise RuntimeError("ps_sample_batch failed: -1")
    for gi in img_of_item:
        if not 0 <= gi < len(images):
            raise RuntimeError("ps_sample_batch failed: -2")
        h, w = images[gi][0].shape[:2]
        if h < patch or w < patch:
            raise RuntimeError("ps_sample_batch failed: -3")
    items = np.arange(batch, dtype=np.uint64)
    with np.errstate(over="ignore"):
        key = np.uint64(batch_index) * _GOLDEN + items * _ITEM
        r_top = _splitmix64(np.uint64(seed) ^ _splitmix64(key + _SALT_TOP))
        r_left = _splitmix64(np.uint64(seed) ^ _splitmix64(key + _SALT_LEFT))
    channels = images[img_of_item[0]][0].shape[-1]
    out_c = np.empty((batch, patch, patch, channels), np.float32)
    out_n = np.empty_like(out_c)
    for b, gi in enumerate(img_of_item):
        clean, noise = images[gi]
        h, w = clean.shape[:2]
        top = int(r_top[b] % np.uint64(h - patch + 1))
        left = int(r_left[b] % np.uint64(w - patch + 1))
        for src, out in ((clean, out_c), (noise, out_n)):
            crop = np.asarray(src, np.uint8)[top:top + patch, left:left + patch]
            out[b] = crop.astype(np.float32) * _INV255
    return out_c, out_n
