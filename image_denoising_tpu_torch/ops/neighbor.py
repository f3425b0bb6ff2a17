"""Neighbor2Neighbor random sub-sampler: a CUDA kernel and its plain version.

Counterpart of ``image_denoising_tpu/ops/neighbor.py`` (plain functions) and
``image_denoising_tpu/ops/neighbor_pallas.py`` (the TPU kernel). For every
image and every 2×2 cell one of the 8 ordered neighbor pairs is drawn
uniformly; sub-image 1 takes the cell's value at the pair's first position,
sub-image 2 at its second (positions 0=TL, 1=TR, 2=BL, 3=BR). One draw per
cell is shared by all channels. Images are NCHW here.

The draw is Philox4x32-10 (``ops/rng.py``) keyed by the 64-bit seed
(low word, high word), with counter (cell index h2·(W/2) + w2, image index,
0, 0); r = word 0 mod 8 is exactly uniform since 2³² is a multiple of 8. The
kernel (``csrc/neighbor.cu``) and ``generate_mask_pair`` use that same
layout, so they agree bit for bit. The stream differs from the TPU kernel's
on-core PRNG and from ``jax.random``; the distribution is the same.

``subsample_pair_fused`` on a CUDA tensor runs the kernel (one launch); on a
CPU tensor it runs ``subsample_pair``. There is no fallback on CUDA.
``subsample_pair_fused.launches`` counts the calls that ran the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils.device import resolve_device
from .rng import MASK32, MASK64, philox4x32_10

__all__ = [
    "generate_mask_pair",
    "generate_subimages",
    "subsample_pair",
    "subsample_pair_fused",
]

# The 8 ordered neighbor pairs (reference train.py:151-154; the TPU kernel's
# _POS1/_POS2 columns): row r holds the two cell positions of draw r.
_IDX_PAIR = torch.tensor(
    [[0, 1], [0, 2], [1, 3], [2, 3], [1, 0], [2, 0], [3, 1], [3, 2]],
    dtype=torch.int32,
)
# element sizes the kernel moves (it copies bits; the value type is irrelevant)
_ELEM_BYTES = {torch.float32: 4, torch.bfloat16: 2}


def _half_shape(shape):
    if len(shape) != 4:
        raise ValueError(f"expected an NCHW shape; got {tuple(shape)}")
    n, _, h, w = shape
    if h % 2 or w % 2 or h == 0 or w == 0:
        raise ValueError(f"the N2N sub-sampler needs even, non-zero H and W; "
                         f"got H={h}, W={w}")
    return n, h // 2, w // 2


def generate_mask_pair(seed: int, shape, device="cuda"):
    """The per-cell pair draw for an NCHW ``shape``: (sel1, sel2), each int32
    [N, H/2, W/2] holding the chosen cell positions (0..3)."""
    n, h2, w2 = _half_shape(shape)
    device = resolve_device(device)
    seed = int(seed) & MASK64
    cell = torch.arange(h2 * w2, dtype=torch.int64, device=device)[None, :]
    image = torch.arange(n, dtype=torch.int64, device=device)[:, None]
    r = philox4x32_10(cell, image, 0, 0, seed & MASK32, seed >> 32)[0] & 7
    pair = _IDX_PAIR.to(device)[r].reshape(n, h2, w2, 2)
    return pair[..., 0], pair[..., 1]


def generate_subimages(img, sel):
    """One pixel per 2×2 cell: img NCHW, sel [N, H/2, W/2] → [N, C, H/2, W/2]."""
    n, c, h, w = img.shape
    cells = (img.reshape(n, c, h // 2, 2, w // 2, 2)
             .permute(0, 1, 2, 4, 3, 5).reshape(n, c, h // 2, w // 2, 4))
    idx = sel.long()[:, None, :, :, None].expand(n, c, h // 2, w // 2, 1)
    return torch.gather(cells, 4, idx)[..., 0]


def subsample_pair(seed: int, img):
    """Plain PyTorch version of the kernel: (sub1, sub2, (sel1, sel2))."""
    sel1, sel2 = generate_mask_pair(seed, img.shape, img.device)
    return generate_subimages(img, sel1), generate_subimages(img, sel2), (sel1, sel2)


def _subsample_cuda(seed: int, img):
    from ._build import load_neighbor

    if img.dtype not in _ELEM_BYTES:
        raise TypeError(f"subsample_pair_fused takes float32 or bfloat16 on "
                        f"CUDA; got {img.dtype}")
    img = img.contiguous()
    if img.data_ptr() % (2 * img.element_size()):
        raise ValueError("subsample_pair_fused needs an image aligned to two "
                         "elements (it loads a cell row's pair at once)")
    n, h2, w2 = _half_shape(img.shape)
    c = img.shape[1]
    if n * h2 * w2 >= 2 ** 31:
        raise ValueError(f"too many cells for one launch: {tuple(img.shape)}")
    sub1 = torch.empty((n, c, h2, w2), dtype=img.dtype, device=img.device)
    sub2 = torch.empty_like(sub1)
    sel1 = torch.empty((n, h2, w2), dtype=torch.int32, device=img.device)
    sel2 = torch.empty_like(sel1)
    lib = load_neighbor()
    with torch.cuda.device(img.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(img.device).cuda_stream)
        err = lib.idt_subsample_pair(
            _ELEM_BYTES[img.dtype], img.data_ptr(), n, c, 2 * h2, 2 * w2,
            int(seed) & MASK64, sub1.data_ptr(), sub2.data_ptr(),
            sel1.data_ptr(), sel2.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"subsample_pair kernel launch failed: CUDA error "
                           f"{err} (shape {tuple(img.shape)}, {img.dtype})")
    subsample_pair_fused.launches += 1
    return sub1, sub2, (sel1, sel2)


def subsample_pair_fused(seed: int, img):
    """img NCHW with even H and W; seed a 64-bit int.

    Returns (sub1, sub2, (sel1, sel2)): sub-images [N, C, H/2, W/2] in img's
    dtype and int32 selector maps [N, H/2, W/2], the contract of the TPU
    kernel ``subsample_pair_pallas``. A CPU tensor takes ``subsample_pair``;
    a CUDA tensor runs the kernel or raises.
    """
    if img.device.type == "cpu":
        return subsample_pair(seed, img)
    if img.device.type != "cuda":
        raise ValueError(f"subsample_pair_fused runs on CUDA or CPU, not {img.device}")
    return _subsample_cuda(seed, img)


subsample_pair_fused.launches = 0
