"""Clean/noise image pairs (counterpart of ``image_denoising_tpu/data/pairs.py``).

Directory contract (reference ``train.py:208-228``): ``data_dir/clean/*`` and
``data_dir/noise/*``, sorted filenames pairing 1:1, decoded on the host into
float32 [0,255]. ``DenoiseDataset`` keeps them resident (unless
``cache=False``) and yields shuffled NHWC batches, grayscale under
``convert_l=True`` (the HPO trainer); /255 runs on the device inside the
train step.
``DenoisePatchDataset`` yields the finetuners' random patch pairs in
[0,1], as the JAX package's does, batch for batch from one seeded ``rng``:
by default through the native C++ sampler (``data/native_sampler.py``)
when every frame is uint8-exact, else (16-bit input, or
``use_native=False``) through the numpy stream.
"""
from __future__ import annotations

import glob
import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

__all__ = ["list_pairs", "load_image_f32", "validation_denoise", "DenoiseDataset",
           "DenoisePatchDataset"]


def list_pairs(data_dir: str, limit: Optional[int] = None) -> Tuple[List[str], List[str]]:
    clean = sorted(glob.glob(os.path.join(data_dir, "clean", "*")))
    noise = sorted(glob.glob(os.path.join(data_dir, "noise", "*")))
    if limit is not None:
        clean, noise = clean[:limit], noise[:limit]
    return clean, noise


def load_image_f32(path: str, convert_l: bool = False) -> np.ndarray:
    """Decode to float32 in [0,255]. (H,W) for grayscale, (H,W,C) otherwise.

    16-bit frames scale by their type max (uint16 → ·255/65535) and PIL
    mode "I" by the int32 max, as the reference's PILToTensor +
    ConvertImageDtype pipeline does (``train_opt.py:95-115``).
    ``convert_l`` (the HPO trainer's grayscale) converts the other modes
    with ``Image.convert("L")``; 16- and 32-bit and float frames are
    single-channel already and keep their depth, as in the JAX package.
    """
    from PIL import Image

    im = Image.open(path)
    if convert_l and im.mode not in ("I", "I;16", "F", "L"):
        im = im.convert("L")
    arr = np.asarray(im)
    if arr.dtype == np.uint16:
        arr = arr.astype(np.float32) * (255.0 / 65535.0)
    elif arr.dtype == np.int32:
        arr = arr.astype(np.float32) * (255.0 / 2147483647.0)
    else:
        arr = arr.astype(np.float32)
    return arr


def validation_denoise(data_dir: str, limit: Optional[int] = None):
    """All (or the first ``limit``) clean/noise frames as float32 + path
    lists (``utils_eval.py:6-17``; ``limit=10`` is the ``[:10]`` of
    ``finetune_iqsl.py:218-219``)."""
    clean_paths, noise_paths = list_pairs(data_dir, limit)
    images_clean = [load_image_f32(p) for p in clean_paths]
    images_noise = [load_image_f32(p) for p in noise_paths]
    return images_clean, images_noise, clean_paths, noise_paths


def _ensure_nhwc(img: np.ndarray) -> np.ndarray:
    return img[..., None] if img.ndim == 2 else img


class DenoiseDataset:
    """Full-image pair dataset with shuffled batching.

    Yields (clean, noisy) NHWC float32 in [0,255]. ``convert_l`` is the
    HPO trainer's grayscale (``load_image_f32``); ``cache`` keeps the
    decoded pairs resident, else each ``get`` decodes its pair again.
    """

    def __init__(self, data_dir: str, convert_l: bool = False, cache: bool = True):
        self.clean_paths, self.noise_paths = list_pairs(data_dir)
        if not self.clean_paths:
            raise RuntimeError(f"no images under {data_dir}/clean")
        self.convert_l = convert_l
        self._cache: Optional[List[Tuple[np.ndarray, np.ndarray]]] = None
        if cache:
            self._cache = [self._decode(i) for i in range(len(self.clean_paths))]
        print(f"fetch {len(self.clean_paths)} samples for training")

    def _decode(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        return (_ensure_nhwc(load_image_f32(self.clean_paths[idx], self.convert_l)),
                _ensure_nhwc(load_image_f32(self.noise_paths[idx], self.convert_l)))

    def __len__(self) -> int:
        return len(self.clean_paths)

    def get(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        if self._cache is not None:
            return self._cache[idx]
        return self._decode(idx)

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


class DenoisePatchDataset:
    """Random same-coordinate patch pairs from the first ``max_images`` pairs.

    Reference semantics (``finetune.py:94-150``): only the first 5 image
    pairs are used; one epoch = n_images · patches_per_image random crops,
    scaled to [0,1]. Decoded images stay resident. With ``use_native`` (the
    default) and every frame uint8-exact, ``native`` is the
    ``NativePatchSampler`` that crops each batch, keyed by a batch seed
    drawn once per epoch and the batch's index; otherwise ``native`` is
    None and the crops are numpy slices drawn from ``rng`` one by one. A
    failed build of the sampler raises: nothing falls back.
    """

    def __init__(self, data_dir: str, patch_size: int, patches_per_image: int,
                 max_images: int = 5, use_native: bool = True):
        clean_paths, noise_paths = list_pairs(data_dir, limit=max_images)
        if len(clean_paths) != len(noise_paths) or not clean_paths:
            raise ValueError("clean and noise must have the same number of images "
                             "and be non-empty.")
        self.patch_size = patch_size
        self.patches_per_image = patches_per_image
        self.images = [
            (_ensure_nhwc(load_image_f32(c)), _ensure_nhwc(load_image_f32(n)))
            for c, n in zip(clean_paths, noise_paths)
        ]
        for c, _ in self.images:
            h, w = c.shape[:2]
            if h < patch_size or w < patch_size:
                raise ValueError(f"Image size ({h},{w}) smaller than patch_size "
                                 f"{patch_size}.")
        self.native = None
        # the native sampler stores uint8 frames: only where every frame is
        # exactly uint8-representable (16-bit input keeps the numpy stream)
        u8_exact = all(
            float(a.min()) >= 0.0 and float(a.max()) <= 255.0
            and np.array_equal(a, np.round(a))
            for pair in self.images for a in pair
        )
        if use_native and u8_exact:
            from .native_sampler import NativePatchSampler

            self.native = NativePatchSampler(
                [(c.astype(np.uint8), n.astype(np.uint8)) for c, n in self.images])
        elif use_native:
            print("[DenoisePatchDataset] frames not uint8-exact "
                  "(high-bit-depth input): using the numpy sampler")
        print(f"B-domain: {len(self.images)} images, {patches_per_image} "
              f"patches/image/epoch → {len(self)} samples/epoch.")

    def __len__(self) -> int:
        return len(self.images) * self.patches_per_image

    def sample(self, index: int, rng: np.random.Generator):
        """One (clean, noisy) patch pair of the numpy stream, [H,W,C]
        float32 in [0,1]."""
        clean_img, noise_img = self.images[index // self.patches_per_image]
        h, w = clean_img.shape[:2]
        ps = self.patch_size
        top = int(rng.integers(0, h - ps + 1))
        left = int(rng.integers(0, w - ps + 1))
        clean = clean_img[top : top + ps, left : left + ps] / 255.0
        noise = noise_img[top : top + ps, left : left + ps] / 255.0
        return clean.astype(np.float32), noise.astype(np.float32)

    def batches(
        self,
        batch_size: int,
        rng: np.random.Generator,
        shuffle: bool = True,
        drop_last: bool = False,
    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """NHWC (clean, noisy) batches; the tail batch is kept unless
        ``drop_last``."""
        order = np.arange(len(self))
        if shuffle:
            rng.shuffle(order)
        end = (len(order) // batch_size) * batch_size if drop_last else len(order)
        batch_seed = int(rng.integers(0, 2**63 - 1))
        for bi, s in enumerate(range(0, end, batch_size)):
            idxs = order[s : s + batch_size]
            if self.native is not None:
                img_of_item = (idxs // self.patches_per_image).astype(np.int32)
                yield self.native.sample(batch_seed, bi, img_of_item, self.patch_size)
            else:
                pairs = [self.sample(int(i), rng) for i in idxs]
                yield np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])
