"""Clean/noise image pairs (counterpart of ``image_denoising_tpu/data/pairs.py``).

Directory contract (reference ``train.py:208-228``): ``data_dir/clean/*`` and
``data_dir/noise/*``, sorted filenames pairing 1:1, decoded on the host into
float32 [0,255].
"""
from __future__ import annotations

import glob
import os
from typing import List, Tuple

import numpy as np

__all__ = ["list_pairs", "load_image_f32", "validation_denoise"]


def list_pairs(data_dir: str) -> Tuple[List[str], List[str]]:
    clean = sorted(glob.glob(os.path.join(data_dir, "clean", "*")))
    noise = sorted(glob.glob(os.path.join(data_dir, "noise", "*")))
    return clean, noise


def load_image_f32(path: str) -> np.ndarray:
    """Decode to float32 in [0,255]. (H,W) for grayscale, (H,W,C) otherwise.

    16-bit frames scale by their type max (uint16 → ·255/65535) and PIL
    mode "I" by the int32 max, as the reference's PILToTensor +
    ConvertImageDtype pipeline does (``train_opt.py:95-115``).
    """
    from PIL import Image

    arr = np.asarray(Image.open(path))
    if arr.dtype == np.uint16:
        arr = arr.astype(np.float32) * (255.0 / 65535.0)
    elif arr.dtype == np.int32:
        arr = arr.astype(np.float32) * (255.0 / 2147483647.0)
    else:
        arr = arr.astype(np.float32)
    return arr


def validation_denoise(data_dir: str):
    """All clean/noise frames as float32 + path lists (``utils_eval.py:6-17``)."""
    clean_paths, noise_paths = list_pairs(data_dir)
    images_clean = [load_image_f32(p) for p in clean_paths]
    images_noise = [load_image_f32(p) for p in noise_paths]
    return images_clean, images_noise, clean_paths, noise_paths
