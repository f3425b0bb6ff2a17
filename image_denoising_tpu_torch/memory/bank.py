"""Retrieval memory bank (counterpart of ``image_denoising_tpu/memory/bank.py``).

Dense strided patch extraction (patch 128, stride 4–64) from the first
memory pairs, in torch ``unfold`` order (row-major over valid positions),
then device residency:

* the noise bank is flat ``[N, P·P·C]``: float32, bfloat16, or **int8**
  centered bytes (k − 128), whose distances are exact integers;
* squared norms are precomputed once: float32 in the [0, 1] domain, int32
  for int8 banks;
* the clean bank is ``[N, P, P, C]`` float32, or the source bytes (uint8,
  decoded with a 256-entry table after the gather, bit-equal to float32);
* ``pad_to`` pads N to a multiple with zero rows whose norms are +inf
  (INT32_MAX for int8 banks), so they are never selected.

The arrays are the JAX package's to the bit: the same numpy arithmetic
(``/255.0``, ``round(x·255) − 128``). For byte-exact frames with an int8
noise bank and a uint8 clean bank, the bytes are extracted directly
(``_byte_bank``): the same arrays without the float32 intermediates, which
take about 7 GB of host memory per bank at stride 4.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..utils.device import resolve_device

__all__ = ["extract_patches", "MemoryBank", "build_memory_bank",
           "build_memory_bank_from_frames"]

INT32_MAX = np.iinfo(np.int32).max


def extract_patches(img: np.ndarray, patch_size: int, stride: int) -> np.ndarray:
    """[H,W] or [H,W,C] image → [N, P, P, C] patches (row-major grid)."""
    if img.ndim == 2:
        img = img[..., None]
    p = patch_size
    windows = np.lib.stride_tricks.sliding_window_view(img, (p, p), axis=(0, 1))
    windows = windows[::stride, ::stride]  # [nh, nw, C, p, p]
    n = windows.shape[0] * windows.shape[1]
    return np.ascontiguousarray(
        windows.transpose(0, 1, 3, 4, 2).reshape(n, p, p, img.shape[2]))


@dataclass
class MemoryBank:
    """Device-resident (noise, clean) patch bank with precomputed norms."""

    noise_flat: torch.Tensor  # [N, D] float32 / bfloat16 / centered int8
    clean: torch.Tensor  # [N, P, P, C] float32 (or uint8, decoded after gather)
    sq_norms: torch.Tensor  # [N] float32 ([0,1] domain) or int32 (int8 banks)
    patch_size: int
    stride: int

    @property
    def size(self) -> int:
        return int(self.noise_flat.shape[0])


def _uint8_exact(arr: np.ndarray) -> bool:
    return (float(arr.min()) >= 0.0 and float(arr.max()) <= 255.0
            and np.array_equal(arr, np.round(arr)))


def _pad_rows(arr: np.ndarray, n_pad: int) -> np.ndarray:
    return np.concatenate([arr, np.zeros((n_pad,) + arr.shape[1:], arr.dtype)])


def _int8_norms(noise_int8: np.ndarray, rows: int = 4096) -> np.ndarray:
    """Σ k² per row of a centered-int8 bank, as int32 (exact), in row chunks
    so the int32 copy stays small."""
    out = np.empty(noise_int8.shape[0], np.int64)
    for s in range(0, noise_int8.shape[0], rows):
        x = noise_int8[s : s + rows].astype(np.int32)
        out[s : s + rows] = np.einsum("ij,ij->i", x, x, dtype=np.int64)
    if out.max(initial=0) >= INT32_MAX:
        raise ValueError("int8 bank norms overflow int32")
    return out.astype(np.int32)


def _byte_bank(clean_frames, noise_frames, patch_size, stride):
    """(noise int8 [N, D], clean uint8 [N, P, P, C]) straight from the bytes.

    Equal to the float route: for a byte k, ``round(f32(k/255)·255)`` is k.
    """
    p = patch_size
    per = [len(range(0, np.shape(f)[0] - p + 1, stride))
           * len(range(0, np.shape(f)[1] - p + 1, stride)) for f in noise_frames]
    c = 1 if np.ndim(noise_frames[0]) == 2 else np.shape(noise_frames[0])[2]
    n = sum(per)
    clean = np.empty((n, p, p, c), np.uint8)
    noise = np.empty((n, p * p * c), np.int8)
    s = 0
    for cf, nf, k in zip(clean_frames, noise_frames, per):
        clean[s : s + k] = extract_patches(np.asarray(cf).astype(np.uint8),
                                           patch_size, stride)
        # k − 128 for k in [0, 255] is k XOR 0x80 read as int8
        nb = extract_patches(np.asarray(nf).astype(np.uint8), patch_size, stride)
        noise[s : s + k] = (nb.reshape(k, -1) ^ np.uint8(0x80)).view(np.int8)
        s += k
    return noise, clean


def build_memory_bank_from_frames(
    clean_frames: Sequence[np.ndarray],
    noise_frames: Sequence[np.ndarray],
    patch_size: int,
    stride: int,
    bank_dtype: str = "float32",
    pad_to: int = 0,
    clean_dtype: str = "float32",
    *,
    device="cuda",
    names: Optional[Sequence[tuple]] = None,
) -> MemoryBank:
    """The bank from frames in memory: [H,W] or [H,W,C] arrays in [0, 255]
    (``load_image_f32``'s float32, or uint8). ``names`` [(clean, noise)]
    label the frames in error messages."""
    if bank_dtype not in ("float32", "bfloat16", "int8"):
        raise ValueError(f"unknown bank_dtype {bank_dtype!r}")
    if clean_dtype not in ("float32", "uint8"):
        raise ValueError(f"unknown clean_dtype {clean_dtype!r}")
    if len(clean_frames) != len(noise_frames) or not len(clean_frames):
        raise ValueError("need as many clean as noise frames, at least one")
    dev = resolve_device(device)
    names = names or [(f"clean frame {i}", f"noise frame {i}")
                      for i in range(len(clean_frames))]
    for (cname, nname), cf, nf in zip(names, clean_frames, noise_frames):
        if clean_dtype == "uint8" and not _uint8_exact(np.asarray(cf)):
            raise ValueError(
                f"--clean_bank_dtype uint8 requires uint8-exact clean frames, "
                f"but {cname} is not byte-exact (high-bit-depth input?). Use "
                f"--clean_bank_dtype float32 for this data.")
        if bank_dtype == "int8" and not _uint8_exact(np.asarray(nf)):
            raise ValueError(
                f"--bank_dtype int8 requires uint8-exact noise frames, but "
                f"{nname} is not byte-exact (high-bit-depth input?). Use "
                f"--bank_dtype float32 or bfloat16 for this data.")
        if np.shape(cf) != np.shape(nf):
            raise ValueError(f"{cname} and {nname} differ in shape")

    if bank_dtype == "int8" and clean_dtype == "uint8":
        noise_q, clean = _byte_bank(clean_frames, noise_frames, patch_size, stride)
        n = noise_q.shape[0]
    else:
        all_clean, all_noise = [], []
        for cf, nf in zip(clean_frames, noise_frames):
            clean_arr = np.asarray(cf, np.float32) / 255.0
            noise_arr = np.asarray(nf, np.float32) / 255.0
            all_clean.append(extract_patches(clean_arr.astype(np.float32),
                                             patch_size, stride))
            all_noise.append(extract_patches(noise_arr.astype(np.float32),
                                             patch_size, stride))
        clean = np.concatenate(all_clean, axis=0)
        noise_flat = np.concatenate(all_noise, axis=0)
        del all_clean, all_noise
        n = noise_flat.shape[0]
        noise_flat = noise_flat.reshape(n, -1)
        if clean_dtype == "uint8":
            clean = np.round(clean * 255.0).astype(np.uint8)
        if bank_dtype == "int8":
            noise_q = (np.round(noise_flat * 255.0).astype(np.int32)
                       - 128).astype(np.int8)

    if bank_dtype == "int8":
        sq_norms = _int8_norms(noise_q)
        n_pad = (-n) % pad_to if pad_to else 0
        if n_pad:
            noise_q = _pad_rows(noise_q, n_pad)
            sq_norms = np.concatenate(
                [sq_norms, np.full((n_pad,), INT32_MAX, np.int32)])
        noise_t = torch.from_numpy(noise_q)
        desc = "int8 (exact integer distances)"
    else:
        sq_norms = np.sum(noise_flat.astype(np.float32) ** 2, axis=1)
        n_pad = (-n) % pad_to if pad_to else 0
        if n_pad:
            noise_flat = _pad_rows(noise_flat, n_pad)
            sq_norms = np.concatenate(
                [sq_norms, np.full((n_pad,), np.inf, np.float32)])
        noise_t = torch.from_numpy(noise_flat)
        if bank_dtype == "bfloat16":
            noise_t = noise_t.to(torch.bfloat16)
        desc = bank_dtype
    print(f"[MemoryBank] #clean patches={n}, patch_size={patch_size}, "
          f"stride={stride}, dtype={desc}"
          + (f", padded to {noise_t.shape[0]}" if pad_to else ""))
    return MemoryBank(
        noise_flat=noise_t.to(dev),
        clean=torch.from_numpy(clean).to(dev),
        sq_norms=torch.from_numpy(np.ascontiguousarray(sq_norms)).to(dev),
        patch_size=patch_size,
        stride=stride,
    )


def build_memory_bank(
    clean_paths: List[str],
    noise_paths: List[str],
    patch_size: int,
    stride: int,
    bank_dtype: str = "float32",
    pad_to: int = 0,
    clean_dtype: str = "float32",
    *,
    device="cuda",
) -> MemoryBank:
    """The bank from image paths (values scaled to [0, 1]); see
    :func:`build_memory_bank_from_frames`."""
    from ..data.pairs import load_image_f32

    if len(clean_paths) != len(noise_paths) or not clean_paths:
        raise ValueError("need as many clean as noise paths, at least one")
    resolve_device(device)  # fail before decoding when there is no GPU
    return build_memory_bank_from_frames(
        [load_image_f32(p) for p in clean_paths],
        [load_image_f32(p) for p in noise_paths],
        patch_size, stride, bank_dtype, pad_to, clean_dtype, device=device,
        names=list(zip(clean_paths, noise_paths)))
