"""Clean/noise image pairs (counterpart of ``image_denoising_tpu/data/pairs.py``).

Directory contract (reference ``train.py:208-228``): ``data_dir/clean/*`` and
``data_dir/noise/*``, sorted filenames pairing 1:1, decoded on the host into
float32 [0,255]. ``DenoiseDataset`` keeps them resident and yields
shuffled NHWC batches; /255 runs on the device inside the train step.
"""
from __future__ import annotations

import glob
import os
from typing import Iterator, List, Tuple

import numpy as np

__all__ = ["list_pairs", "load_image_f32", "validation_denoise", "DenoiseDataset"]


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


def _ensure_nhwc(img: np.ndarray) -> np.ndarray:
    return img[..., None] if img.ndim == 2 else img


class DenoiseDataset:
    """Full-image pair dataset with shuffled batching.

    Yields (clean, noisy) NHWC float32 in [0,255], decoded once and kept
    resident. The train CLI's copy of the JAX ``DenoiseDataset``; its
    ``convert_l`` (train_opt.py) comes with the HPO trainer.
    """

    def __init__(self, data_dir: str):
        self.clean_paths, self.noise_paths = list_pairs(data_dir)
        if not self.clean_paths:
            raise RuntimeError(f"no images under {data_dir}/clean")
        self._pairs = [
            (_ensure_nhwc(load_image_f32(c)), _ensure_nhwc(load_image_f32(n)))
            for c, n in zip(self.clean_paths, self.noise_paths)
        ]
        print(f"fetch {len(self.clean_paths)} samples for training")

    def __len__(self) -> int:
        return len(self.clean_paths)

    def get(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        return self._pairs[idx]

    def batches(
        self,
        batch_size: int,
        rng: np.random.Generator,
        shuffle: bool = True,
        drop_last: bool = True,
    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        order = np.arange(len(self))
        if shuffle:
            rng.shuffle(order)
        n_full = len(order) // batch_size
        end = n_full * batch_size if drop_last else len(order)
        for s in range(0, end, batch_size):
            idxs = order[s : s + batch_size]
            cleans = np.stack([self.get(i)[0] for i in idxs])
            noisys = np.stack([self.get(i)[1] for i in idxs])
            yield cleans, noisys
