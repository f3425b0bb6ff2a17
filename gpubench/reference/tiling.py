"""The reference's tiled pyramid denoise (``evaluation_704.py``), in numpy.

Tiles of ``ps`` on a grid anchored at multiples of ``ps − overlap``; a tile
that runs past the frame is cropped and reflect-padded (``np.pad``,
edge excluded) back to ``ps``. Each prediction is clipped to [0, 1] and
weighted by (1 − |2y − 1|)(1 − |2x − 1|) over its unpadded extent; the
weighted sum is divided by the summed weights (a zero sum counts as 1) in
float64, and quantised as ``uint8_floor``: clip(p·255) without +0.5.
"""
from __future__ import annotations

import numpy as np
import torch


def tile_grid(h: int, w: int, ps: int, overlap: int):
    step = ps - overlap
    return [(r0, c0, min(r0 + ps, h) - r0, min(c0 + ps, w) - c0)
            for r0 in range(0, h, step) for c0 in range(0, w, step)]


def pyramid_mask(ps: int) -> np.ndarray:
    yy, xx = np.meshgrid(np.linspace(0, 1, ps), np.linspace(0, 1, ps), indexing="ij")
    return (1 - np.abs(yy - 0.5) * 2) * (1 - np.abs(xx - 0.5) * 2)


def frame_tiles(frame: np.ndarray, grid, ps: int) -> np.ndarray:
    """uint8 [H, W] → float32 [T, ps, ps] in [0, 1]."""
    x = frame.astype(np.float32) / np.float32(255.0)
    return np.stack([np.pad(x[r0:r0 + th, c0:c0 + tw], ((0, ps - th), (0, ps - tw)),
                            mode="reflect") for r0, c0, th, tw in grid])


def blend_uint8(preds: np.ndarray, grid, h: int, w: int, ps: int) -> np.ndarray:
    """float [T, ps, ps] predictions → the uint8_floor frame [H, W]."""
    mask = pyramid_mask(ps)
    canvas = np.zeros((h, w))
    weight = np.zeros((h, w))
    for p, (r0, c0, th, tw) in zip(preds, grid):
        m = mask[:th, :tw]
        canvas[r0:r0 + th, c0:c0 + tw] += np.clip(p[:th, :tw].astype(np.float64), 0, 1) * m
        weight[r0:r0 + th, c0:c0 + tw] += m
    weight[weight == 0] = 1.0
    return np.clip(canvas / weight * 255.0, 0, 255).astype(np.uint8)


def denoise_frames(frames: np.ndarray, net, ps: int, overlap: int, chunk: int,
                   device) -> np.ndarray:
    """uint8 [N, H, W] → uint8 [N, H, W]; ``net`` maps NCHW [k, 1, ps, ps]
    float32 tiles to predictions, run ``chunk`` tiles at a time."""
    n, h, w = frames.shape
    grid = tile_grid(h, w, ps, overlap)
    out = np.empty_like(frames)
    with torch.inference_mode():
        for i in range(n):
            tiles = torch.from_numpy(frame_tiles(frames[i], grid, ps)).to(device)
            preds = torch.cat([net(tiles[s:s + chunk, None]).float()
                               for s in range(0, len(grid), chunk)])
            out[i] = blend_uint8(preds[:, 0].cpu().numpy(), grid, h, w, ps)
    return out
