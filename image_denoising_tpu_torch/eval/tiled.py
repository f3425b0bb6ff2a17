"""Full-frame inference: one whole-frame forward, or tiles with pyramid
or Hann² blending.

Counterpart of ``image_denoising_tpu/eval/tiled.py``. ``denoise_whole_frame``
is the whole-frame path of ``evaluation.py``; the tiled engines have two
regimes:

* pyramid (the ``evaluation_704.py`` engine): 352-px tiles, stride =
  ps − overlap, grid anchored at multiples of the stride (tiles may overrun
  the frame; they are cropped and reflect-padded), weight
  (1−|2y−1|)(1−|2x−1|) on the *unpadded* tile extent, predictions clipped
  to [0, 1], contribution==0 → 1 divide guard, uint8 via clip(p·255) with
  NO +0.5 (``uint8_floor``) or with it (``uint8_round``).
* hann (the ``evaluation_704_iqsl_memory.py`` engine): 128-px full-size
  tiles on an edge-aligned, deduplicated grid (last row and column snapped
  to the frame edge), Hann²(periodic=False) window clamped to ≥ 1e-3,
  divide by (Σw + 1e-8) with Σw summed in float64, NO clip of the
  predictions before the blend, uint8 via clip(p·255 + 0.5). A
  ``pre_tile_fn`` hook runs once on the whole NCHW tile stack before the
  chunked forward (the hoisted memory retrieval: it returns the stack with
  the retrieved patches as extra channels).

The tile grid is static per frame geometry and computed on the host; the
gather, the chunked forward, the blend and the quantisation run on the
device. Model calls take and return NCHW ``[k, C, ps, ps]`` tiles. Under a
profiler each phase is a ``tiled.*`` span (``utils/profiling.py``); all
but the forward and the retrieval are device-timed.

``mesh=`` (``parallel.make_mesh``) splits the tile stack over the mesh's
devices, the counterpart of JAX's ``_shard_tiles``: the stack is padded
with zero tiles to a device multiple, each device runs its share in the
runner's chunk size (a ``parallel.PerDevice`` model call, as
``make_forward(mesh=)`` gives, runs each share on its device's copy), and
the predictions are gathered on the first device, which also cuts the
tiles and blends and quantises the frames. JAX turns a negative ``batch`` into one forward under a mesh,
because its chunk loop is a sequential ``lax.map``; the port's chunk loop
launches asynchronously on each device, so it keeps the chunk size.

Where the JAX package has two blend forms (an unrolled pad-and-add for ≤256
tiles and a scatter loop above that), PyTorch needs one: an in-place add of
each weighted tile into the canvas, in tile order, which is both.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..parallel.mesh import forward_over_mesh
from ..utils.device import resolve_device
from ..utils.profiling import span

__all__ = [
    "pyramid_weight_mask",
    "hann_window_2d",
    "reference_tile_grid",
    "edge_aligned_grid",
    "make_tiled_pyramid_runner",
    "make_tiled_pyramid_runner_frames",
    "denoise_tiled_pyramid",
    "make_tiled_hann_runner",
    "make_tiled_hann_runner_frames",
    "denoise_tiled_hann",
    "denoise_whole_frame",
]


def denoise_whole_frame(model_call: Callable, noisy01: np.ndarray, device="cuda"):
    """One forward of a [H, W, C] float frame in [0, 1] (``evaluation.py``
    semantics), clipped to [0, 1]; returns numpy [H, W, C] float32.
    ``model_call`` takes and returns NCHW; ImprovedUNet needs H and W
    divisible by 2**depth."""
    dev = resolve_device(device)
    x = torch.from_numpy(np.asarray(noisy01, np.float32)).to(dev)
    with torch.inference_mode():
        pred = model_call(x.permute(2, 0, 1)[None])[0]
        return torch.clamp(pred.float(), 0.0, 1.0).permute(1, 2, 0).cpu().numpy()


def pyramid_weight_mask(ps: int) -> np.ndarray:
    """(1 − |2y−1|)(1 − |2x−1|) on a [0,1]-linspace grid (evaluation_704.py:62-68)."""
    yy, xx = np.meshgrid(
        np.linspace(0, 1, ps), np.linspace(0, 1, ps), indexing="ij"
    )
    return ((1 - np.abs(yy - 0.5) * 2) * (1 - np.abs(xx - 0.5) * 2)).astype(np.float32)


def hann_window_2d(ps: int, clamp_min: float = 1e-3) -> np.ndarray:
    """torch.hann_window(ps, periodic=False) outer product, clamped ≥ clamp_min."""
    n = np.arange(ps, dtype=np.float64)
    w1 = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / (ps - 1)))
    return np.maximum(np.outer(w1, w1), clamp_min).astype(np.float32)


def edge_aligned_grid(h: int, w: int, ps: int, overlap: int):
    """(r0, c0) full-size tiles with a snapped last row/col, deduplicated and
    sorted (evaluation_704_iqsl_memory.py:1041-1048)."""
    if h < ps or w < ps:
        raise ValueError(f"Image ({h},{w}) smaller than patch_size {ps}")
    if overlap >= ps:
        raise ValueError("overlap must be smaller than patch_size")
    step = ps - overlap
    ys = sorted(set(range(0, h - ps + 1, step)) | {h - ps})
    xs = sorted(set(range(0, w - ps + 1, step)) | {w - ps})
    return [(y, x) for y in ys for x in xs]


def reference_tile_grid(h: int, w: int, ps: int, stride: int):
    """(r0, c0, th, tw) tuples for the stride-anchored, crop-overrun grid."""
    grid = []
    for r0 in range(0, h, stride):
        for c0 in range(0, w, stride):
            th = min(r0 + ps, h) - r0
            tw = min(c0 + ps, w) - c0
            grid.append((r0, c0, th, tw))
    return grid


def _reflect_indices(start: int, valid: int, ps: int) -> np.ndarray:
    """Absolute image indices for a ps-long axis slice starting at ``start``
    with ``valid`` in-bounds pixels, reflect-extended (edge excluded) like
    np.pad(mode='reflect') on the cropped tile; past size−1 the mirror
    repeats cyclically instead of failing."""
    idx = np.arange(ps)
    out = np.empty(ps, dtype=np.int64)
    inb = idx < valid
    out[inb] = start + idx[inb]
    if valid < ps:
        # reflect cycle of length 2·(valid−1): [0..v-1, v-2..1] repeating
        cycle = max(2 * (valid - 1), 1)
        over = idx[~inb] % cycle
        refl = np.where(over < valid, over, cycle - over)
        out[~inb] = start + refl
    return out


def _chunked_forward(model_call, tiles, batch: int):
    """Run ``[T, C, ps, ps]`` tiles through model_call in chunks.

    batch == 0 (or ≥ T): one call. batch = k > 0: chunks of k, the last one
    zero-padded to k and cropped. batch = −k: the same chunks of k, the
    counterpart of the JAX package's ``lax.map`` over k-tile chunks.
    """
    t = tiles.shape[0]
    k = abs(batch)
    if k == 0 or k >= t:
        return model_call(tiles)
    outs = []
    for s in range(0, t, k):
        chunk = tiles[s : s + k]
        n = chunk.shape[0]
        if n < k:
            pad = tiles.new_zeros((k - n,) + tuple(tiles.shape[1:]))
            chunk = torch.cat([chunk, pad])
        outs.append(model_call(chunk)[:n])
    return torch.cat(outs)


def _forward(model_call, tiles, batch: int, mesh):
    """``_chunked_forward`` of the whole stack, or with a mesh of each
    device's share of it (zero tiles pad T to a device multiple and are
    cropped after), gathered on the mesh's first device."""
    if mesh is None:
        return _chunked_forward(model_call, tiles, batch)
    t, k = tiles.shape[0], mesh.size
    if t % k:
        tiles = torch.cat([tiles, tiles.new_zeros((k - t % k,) + tuple(tiles.shape[1:]))])
    on = getattr(model_call, "on", None)
    out = forward_over_mesh(
        mesh, lambda d, share: _chunked_forward(on(d) if on else model_call, share, batch),
        tiles)
    return out[:t]


def _runner_device(device, mesh):
    return resolve_device(mesh.primary if mesh is not None else device)


def _quantize(out01, out_dtype: str):
    """'uint8_floor' = clip(p·255) without +0.5 (evaluation_704.py:120);
    'uint8_round' = clip(p·255 + 0.5); 'float32' passes through."""
    if out_dtype == "float32":
        return out01
    if out_dtype not in ("uint8_floor", "uint8_round"):
        raise ValueError(f"unknown out_dtype {out_dtype!r}")
    bias = 0.5 if out_dtype == "uint8_round" else 0.0
    return torch.clamp(out01 * 255.0 + bias, 0, 255).to(torch.uint8)


class _PyramidGeometry:
    """Host-side tile grid, gather indices and blend weights for one frame size."""

    def __init__(self, h, w, ps, overlap, device):
        self.h, self.w, self.ps = h, w, ps
        self.grid = reference_tile_grid(h, w, ps, ps - overlap)
        rows = np.stack([_reflect_indices(r0, th, ps) for (r0, _, th, _) in self.grid])
        cols = np.stack([_reflect_indices(c0, tw, ps) for (_, c0, _, tw) in self.grid])
        self.row_idx = torch.as_tensor(rows, device=device)[:, :, None]
        self.col_idx = torch.as_tensor(cols, device=device)[:, None, :]
        mask = pyramid_weight_mask(ps)
        contrib = np.zeros((h, w), np.float64)
        for (r0, c0, th, tw) in self.grid:
            contrib[r0 : r0 + th, c0 : c0 + tw] += mask[:th, :tw]
        contrib[contrib == 0] = 1.0
        self.mask = torch.as_tensor(mask, device=device)
        self.inv_contrib = torch.as_tensor(1.0 / contrib, dtype=torch.float32,
                                           device=device)

    def gather(self, imgs):
        """[F, H, W] → [F, T, ps, ps] reflect-padded tiles."""
        return imgs[:, self.row_idx, self.col_idx]

    def blend(self, preds):
        """[F, T, ps, ps] → [F, H, W]: clip to [0,1], weight, add in tile order,
        scale by the reciprocal contribution."""
        canvas = preds.new_zeros((preds.shape[0], self.h, self.w),
                                 dtype=torch.float32)
        for i, (r0, c0, th, tw) in enumerate(self.grid):
            p = torch.clamp(preds[:, i, :th, :tw].float(), 0.0, 1.0)
            canvas[:, r0 : r0 + th, c0 : c0 + tw] += p * self.mask[:th, :tw]
        return canvas * self.inv_contrib


def _run_frames(geo, model_call, frames255, batch, out_dtype, device, mesh):
    with span("tiled.frames", device):
        imgs = torch.as_tensor(frames255).to(device).float() / 255.0  # [F,H,W]
    with span("tiled.gather", device):
        tiles = geo.gather(imgs)                                     # [F,T,ps,ps]
    f, t, ps = tiles.shape[0], tiles.shape[1], geo.ps
    with span("tiled.forward"):
        preds = _forward(model_call, tiles.reshape(f * t, 1, ps, ps), batch, mesh)
    with span("tiled.l1", device):
        preds = preds.reshape(f, t, ps, ps).float()
        l1 = torch.mean(torch.abs(preds - tiles), dim=(2, 3)).mean(dim=1)
    with span("tiled.blend", device):
        canvas = geo.blend(preds)
    with span("tiled.quantize", device):
        return _quantize(canvas, out_dtype), l1


def make_tiled_pyramid_runner(
    model_call: Callable, h: int, w: int, ps: int = 352, overlap: int = 64,
    batch: int = 0, *, out_dtype: str = "float32", device="cuda", mesh=None,
):
    """frame [H, W] in [0, 255] → (pred [H, W], mean tile L1), on ``device``
    (with a ``mesh``, on its first device, the tiles split over it).

    ``out_dtype`` in {'float32', 'uint8_floor', 'uint8_round'}.
    """
    dev = _runner_device(device, mesh)
    geo = _PyramidGeometry(h, w, ps, overlap, dev)

    @torch.inference_mode()
    def run(noisy255):
        out, l1 = _run_frames(geo, model_call, torch.as_tensor(noisy255)[None],
                              batch, out_dtype, dev, mesh)
        return out[0], l1[0]

    return run


def make_tiled_pyramid_runner_frames(
    model_call: Callable, n_frames: int, h: int, w: int, ps: int = 352,
    overlap: int = 64, batch: int = 0, *, out_dtype: str = "float32",
    device="cuda", mesh=None,
):
    """Frame-batched variant: [F, H, W] in [0, 255] → ([F, H, W] pred, [F] L1).

    All F·T tiles run through ``_chunked_forward`` as one stack (``batch=-k``
    for k-tile chunks: the serving shape is F=8, k=8; with a ``mesh``, each
    device's share of it) and the blends run over all frames at once.
    Frames may be a numpy array or a tensor on any device; results stay on
    ``device`` (the mesh's first device).
    """
    dev = _runner_device(device, mesh)
    geo = _PyramidGeometry(h, w, ps, overlap, dev)

    @torch.inference_mode()
    def run(frames255):
        frames = torch.as_tensor(frames255)
        if tuple(frames.shape) != (n_frames, h, w):
            raise ValueError(f"expected frames of shape {(n_frames, h, w)}, "
                             f"got {tuple(frames.shape)}")
        return _run_frames(geo, model_call, frames, batch, out_dtype, dev, mesh)

    return run


def denoise_tiled_pyramid(
    model_call: Callable,
    noisy255: np.ndarray,
    ps: int = 352,
    overlap: int = 64,
    batch: int = 0,
    out_dtype: str = "float32",
    device="cuda",
    mesh=None,
):
    """Tiled-352 pyramid-blend full-frame denoise (evaluation_704.py engine).

    noisy255: [H, W] uint8/float in [0, 255]. Returns (pred [H, W] as numpy —
    float32 in [0, 1] or uint8 per ``out_dtype`` — and the mean per-tile
    L1(pred, padded input) as a float).
    """
    noisy = np.asarray(noisy255)
    if noisy.ndim != 2:
        raise ValueError("tiled pyramid eval is single-channel")
    h, w = noisy.shape
    run = make_tiled_pyramid_runner(model_call, h, w, ps, overlap, batch,
                                    out_dtype=out_dtype, device=device, mesh=mesh)
    out, l1 = run(noisy)
    return out.cpu().numpy(), float(l1)


class _HannGeometry:
    """Host-side edge-aligned grid, gather indices, Hann² window and the
    reciprocal weight sum for one frame size."""

    def __init__(self, h, w, ps, overlap, device):
        self.h, self.w, self.ps = h, w, ps
        self.grid = edge_aligned_grid(h, w, ps, overlap)
        yy = np.arange(ps)
        rows = np.stack([r0 + yy for r0, _ in self.grid])
        cols = np.stack([c0 + yy for _, c0 in self.grid])
        self.row_idx = torch.as_tensor(rows, device=device)[:, :, None]
        self.col_idx = torch.as_tensor(cols, device=device)[:, None, :]
        window = hann_window_2d(ps)
        wsum = np.zeros((h, w), np.float64)
        for (r0, c0) in self.grid:
            wsum[r0 : r0 + ps, c0 : c0 + ps] += window
        self.window = torch.as_tensor(window, device=device)
        self.inv_wsum = torch.as_tensor(1.0 / (wsum + 1e-8), dtype=torch.float32,
                                        device=device)

    def gather(self, imgs):
        """[F, H, W] → [F, T, ps, ps] tiles."""
        return imgs[:, self.row_idx, self.col_idx]

    def blend(self, preds):
        """[F, T, ps, ps] → [F, H, W]: weight (no clip), add in tile order,
        scale by the reciprocal weight sum."""
        ps = self.ps
        canvas = preds.new_zeros((preds.shape[0], self.h, self.w),
                                 dtype=torch.float32)
        for i, (r0, c0) in enumerate(self.grid):
            canvas[:, r0 : r0 + ps, c0 : c0 + ps] += preds[:, i].float() * self.window
        return canvas * self.inv_wsum


def _run_hann_frames(geo, model_call, frames255, batch, out_dtype, device,
                     pre_tile_fn, mesh):
    with span("tiled.frames", device):
        imgs = torch.as_tensor(frames255).to(device).float() / 255.0  # [F,H,W]
    with span("tiled.gather", device):
        tiles = geo.gather(imgs)                                     # [F,T,ps,ps]
    f, t, ps = tiles.shape[0], tiles.shape[1], geo.ps
    tiles = tiles.reshape(f * t, 1, ps, ps)
    if pre_tile_fn is not None:
        with span("tiled.retrieve"):
            tiles = pre_tile_fn(tiles)
    with span("tiled.forward"):
        preds = _forward(model_call, tiles, batch, mesh)[:, 0]
    with span("tiled.blend", device):
        canvas = geo.blend(preds.reshape(f, t, ps, ps))
    with span("tiled.quantize", device):
        return _quantize(canvas, out_dtype)


def make_tiled_hann_runner(
    model_call: Callable, h: int, w: int, ps: int = 128, overlap: int = 64,
    batch: int = 0, *, out_dtype: str = "float32",
    pre_tile_fn: Optional[Callable] = None, device="cuda", mesh=None,
):
    """frame [H, W] in [0, 255] → pred [H, W], on ``device`` (with a
    ``mesh``, on its first device, the tiles split over it).

    ``pre_tile_fn(tiles) -> tiles'`` runs once on the whole NCHW
    ``[T, 1, ps, ps]`` stack before the chunked forward, on the first
    device; ``model_call`` then takes chunks of what it returns and gives
    NCHW predictions, of which channel 0 is blended.
    """
    dev = _runner_device(device, mesh)
    geo = _HannGeometry(h, w, ps, overlap, dev)

    @torch.inference_mode()
    def run(noisy255):
        return _run_hann_frames(geo, model_call, torch.as_tensor(noisy255)[None],
                                batch, out_dtype, dev, pre_tile_fn, mesh)[0]

    return run


def make_tiled_hann_runner_frames(
    model_call: Callable, n_frames: int, h: int, w: int, ps: int = 128,
    overlap: int = 64, batch: int = 0, *, out_dtype: str = "float32",
    pre_tile_fn: Optional[Callable] = None, device="cuda", mesh=None,
):
    """Frame-batched Hann variant: [F, H, W] in [0, 255] → [F, H, W] pred.

    All F·T tiles go through ``pre_tile_fn`` once and through
    ``_chunked_forward`` as one stack (``batch=-k`` for k-tile chunks: the
    serving shape is F=4, k=8; with a ``mesh``, each device's share of the
    stack); the blends run over all frames at once.
    """
    dev = _runner_device(device, mesh)
    geo = _HannGeometry(h, w, ps, overlap, dev)

    @torch.inference_mode()
    def run(frames255):
        frames = torch.as_tensor(frames255)
        if tuple(frames.shape) != (n_frames, h, w):
            raise ValueError(f"expected frames of shape {(n_frames, h, w)}, "
                             f"got {tuple(frames.shape)}")
        return _run_hann_frames(geo, model_call, frames, batch, out_dtype, dev,
                                pre_tile_fn, mesh)

    return run


def denoise_tiled_hann(
    model_call: Callable,
    noisy255: np.ndarray,
    ps: int = 128,
    overlap: int = 64,
    batch: int = 0,
    out_dtype: str = "float32",
    pre_tile_fn: Optional[Callable] = None,
    device="cuda",
    mesh=None,
):
    """Hann²-blended patchwise denoise (denoise_full_image_patchwise engine).

    noisy255: [H, W] (or [H, W, 1]) in [0, 255]. Returns the prediction as
    numpy [H, W, 1]: float32 in [0, 1], or uint8 per ``out_dtype``.
    """
    noisy = np.asarray(noisy255)
    if noisy.ndim == 3 and noisy.shape[2] == 1:
        noisy = noisy[..., 0]
    if noisy.ndim != 2:
        raise ValueError("tiled Hann eval is single-channel")
    h, w = noisy.shape
    run = make_tiled_hann_runner(model_call, h, w, ps, overlap, batch,
                                 out_dtype=out_dtype, pre_tile_fn=pre_tile_fn,
                                 device=device, mesh=mesh)
    return run(noisy).cpu().numpy()[..., None]
