#!/usr/bin/env python3
"""Frames past 256 tiles through both tiled engines of the port, on the card.

Counterpart of ``scripts/tpu_huge_frame.py``. Two legs on one seeded frame
(a smooth pattern with N(0, 15) on top):

* pyramid — a ``pyr_hw``² frame (4672²: 17 × 17 = 289 tiles of 352², overlap
  64) through ``eval/tiled.py::make_tiled_pyramid_runner``: ImprovedUNet-48
  through ``make_fused_forward`` in bfloat16, chunks of 8 tiles,
  ``uint8_floor``.
* hann — its top-left ``hann_hw``² crop (2816²: 43 × 43 = 1849 tiles of 128²,
  overlap 64) through ``make_tiled_hann_runner``, ``uint8_round``: the memory
  wrapper (the same base, ``hyper_gated_fft`` hidden 16, every weight drawn
  from the seed) over an int8/uint8 bank that ``memory/bank.py`` builds from
  4 seeded 704² pairs at stride 18 (4,356 rows, padded to 4,608). The hoisted
  retrieval runs once, at B = 1849.

Each leg: s/frame and MP/s (the median of 3 runs after a warm one), and the
frame against a float64 host oracle: the tile predictions of the runner's
own chunked forward, captured in its last run, blended in numpy float64 by
the math of ``_PyramidGeometry.blend`` / ``_HannGeometry.blend`` and
quantised as the runner does. Limit: at most 1 uint8 level, on at most
0.1 % of pixels. The tiles that run fed the network are held equal to crops
of the frame taken here, independently of the runner's gather (``np.pad``
reflects the pyramid's edge tiles). The hann leg also holds that run's
retrieval to the same crops: its int8 queries equal to them, its indices to
``top1_l2_retrieval_reference`` on them (int8 distances are exact: equal)
and the clean patches it appended to the bank's rows at those indices.

    python scripts/cuda/huge_frame.py [pyr_hw] [hann_hw] [--checkpoint m.ckpt]

prints one JSON line per leg (``--device cpu`` runs it off the card). The
base's weights come from ``--checkpoint`` (an ImprovedUNet ``.ckpt``), else
from ``torch.manual_seed(0)``. It imports the port and never JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PS, OVERLAP, HANN_PS, HANN_OVERLAP, CHUNK = 352, 64, 128, 64, 8
N_FEATURE, HIDDEN, DTYPE = 48, 16, "bfloat16"
BANK_PAIRS, BANK_FRAME, BANK_STRIDE, BANK_PAD = 4, 704, 18, 512
MAX_LEVELS, MAX_FRAC = 1, 1e-3
REPS = 3


def seeded_frame(hw: int) -> np.ndarray:
    """The JAX script's frame: 120 + 60·sin(x/19) + 30·cos(y/23) + N(0, 15)
    from seed 0, uint8 [hw, hw]."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:hw, 0:hw]
    return np.clip(120 + 60 * np.sin(xx / 19) + 30 * np.cos(yy / 23)
                   + rng.normal(0, 15, (hw, hw)), 0, 255).astype(np.uint8)


def bank_pairs(pairs: int, hw: int):
    """``pairs`` clean uint8 frames of the same pattern family at other
    phases, and noisy = clean + N(0, 15)."""
    rng = np.random.default_rng(1)
    yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float32)
    clean = [np.clip(120 + 60 * np.sin(xx / 19 + p) + 30 * np.cos(yy / 23 - p),
                     0, 255).astype(np.uint8) for p in range(pairs)]
    noise = [np.clip(c + rng.normal(0, 15, c.shape), 0, 255).astype(np.uint8)
             for c in clean]
    return clean, noise


def pyramid_oracle(preds, grid, ps: int, h: int, w: int,
                   out_dtype: str = "uint8_floor") -> np.ndarray:
    """``_PyramidGeometry.blend`` and ``uint8_floor`` in numpy float64 from
    the tile predictions ``preds`` [T, ps, ps]: each clipped to [0, 1],
    weighted by the pyramid mask on its unpadded extent, summed, divided by
    the summed weights (0 → 1), then clip(p·255) without +0.5
    (``out_dtype="float32"``: the blend before quantising, float64)."""
    from image_denoising_tpu_torch.eval.tiled import pyramid_weight_mask

    mask = pyramid_weight_mask(ps).astype(np.float64)
    canvas = np.zeros((h, w), np.float64)
    contrib = np.zeros((h, w), np.float64)
    for i, (r0, c0, th, tw) in enumerate(grid):
        p = np.clip(np.asarray(preds[i, :th, :tw], np.float64), 0.0, 1.0)
        canvas[r0:r0 + th, c0:c0 + tw] += p * mask[:th, :tw]
        contrib[r0:r0 + th, c0:c0 + tw] += mask[:th, :tw]
    contrib[contrib == 0] = 1.0
    if out_dtype == "float32":
        return canvas / contrib
    return np.clip(canvas / contrib * 255.0, 0, 255).astype(np.uint8)


def hann_oracle(preds, grid, ps: int, h: int, w: int) -> np.ndarray:
    """``_HannGeometry.blend`` and ``uint8_round`` in numpy float64: each
    full tile weighted by the clamped Hann² window (no clip), summed,
    divided by (Σw + 1e-8), then clip(p·255 + 0.5)."""
    from image_denoising_tpu_torch.eval.tiled import hann_window_2d

    window = hann_window_2d(ps).astype(np.float64)
    canvas = np.zeros((h, w), np.float64)
    wsum = np.zeros((h, w), np.float64)
    for i, (r0, c0) in enumerate(grid):
        canvas[r0:r0 + ps, c0:c0 + ps] += np.asarray(preds[i], np.float64) * window
        wsum[r0:r0 + ps, c0:c0 + ps] += window
    return np.clip(canvas / (wsum + 1e-8) * 255.0 + 0.5, 0, 255).astype(np.uint8)


def pyramid_crops(frame: np.ndarray, grid, ps: int) -> np.ndarray:
    """The pyramid runner's tiles, taken without its gather: each grid
    cell's crop of ``frame``, reflect-padded to ps² by ``np.pad`` (uint8
    [T, ps, ps])."""
    return np.stack([np.pad(frame[r0:r0 + th, c0:c0 + tw], ((0, ps - th), (0, ps - tw)),
                            mode="reflect") for (r0, c0, th, tw) in grid])


def hann_crops(frame: np.ndarray, grid, ps: int) -> np.ndarray:
    """The Hann runner's tiles, taken without its gather (uint8 [T, ps, ps])."""
    return np.stack([frame[r0:r0 + ps, c0:c0 + ps] for (r0, c0) in grid])


def same_pixels(tiles01: np.ndarray, crops: np.ndarray) -> bool:
    """Tiles in [0, 1] are the uint8 ``crops`` over 255 (to float rounding)."""
    return bool(np.array_equal(np.rint(tiles01.astype(np.float64) * 255.0), crops))


def level_check(out: np.ndarray, oracle: np.ndarray) -> dict:
    d = np.abs(out.astype(np.int16) - oracle.astype(np.int16))
    return dict(max_abs_diff_uint8=int(d.max()), mismatch_frac=float((d > 0).mean()),
                mismatch_gt1_frac=float((d > 1).mean()),
                within_limits=bool(d.max() <= MAX_LEVELS and (d > 0).mean() <= MAX_FRAC))


class Capture:
    """A model call that keeps, while ``on``, each chunk's input tiles and
    its outputs: what the runner's gather fed its chunked forward, and the
    predictions that came back."""

    def __init__(self, model_call):
        self.model_call, self.on, self.ins, self.outs = model_call, False, [], []

    def __call__(self, tiles):
        out = self.model_call(tiles)
        if self.on:
            self.ins.append(tiles.float().cpu())
            self.outs.append(out.float().cpu())
        return out

    def taken(self, tiles: int):
        """(input tiles, predictions) of the captured run, NCHW numpy, the
        last chunk's zero padding cropped."""
        return tuple(np.concatenate([x.numpy() for x in xs])[:tiles]
                     for xs in (self.ins, self.outs))


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timed_runs(run, frame, device, reps: int = REPS):
    """One warm run, then ``reps`` timed ones, each to its output on the
    host: (median seconds, every time)."""
    run(frame)
    _sync(device)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = run(frame)
        (out[0] if isinstance(out, tuple) else out).cpu()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), times


def pyramid_leg(model_call, frame: np.ndarray, *, ps: int = PS, overlap: int = OVERLAP,
                batch: int = -CHUNK, device="cuda", reps: int = REPS) -> dict:
    """The pyramid runner on ``frame`` [H, W] uint8: timed, then one more run
    with its predictions captured, against ``pyramid_oracle``."""
    from image_denoising_tpu_torch.eval import tiled

    h, w = frame.shape
    cap = Capture(model_call)
    run = tiled.make_tiled_pyramid_runner(cap, h, w, ps, overlap, batch,
                                          out_dtype="uint8_floor", device=device)
    grid = tiled.reference_tile_grid(h, w, ps, ps - overlap)
    med, times = timed_runs(run, frame, device, reps)
    cap.on = True
    out, l1 = run(frame)
    out = out.cpu().numpy()
    cap.on = False
    ins, preds = cap.taken(len(grid))
    preds = preds[:, 0]
    oracle = pyramid_oracle(preds, grid, ps, h, w)
    return dict(leg="pyramid", hw=h, tiles=len(grid), ps=ps, overlap=overlap,
                s_per_frame=med, times_s=times, mps=h * w / 1e6 / med, l1=float(l1),
                out_mean=float(out.mean()), pred_std=float(np.std(preds)),
                tiles_equal_to_crops=same_pixels(ins[:, 0], pyramid_crops(frame, grid, ps)),
                **level_check(out, oracle))


def hann_leg(model_call, frame: np.ndarray, *, pre_tile_fn=None, bank=None,
             ps: int = HANN_PS, overlap: int = HANN_OVERLAP, batch: int = -CHUNK,
             device="cuda", reps: int = REPS):
    """The Hann runner on ``frame``, with the hoisted retrieval
    ``pre_tile_fn`` over the int8 ``bank`` where given: timed, then one more
    run with its tiles and predictions captured, its tiles against
    ``hann_crops`` and its frame against ``hann_oracle``; with a bank, its
    retrieval's queries, indices and appended clean patches against the
    crops, ``top1_l2_retrieval_reference`` on them and the bank's rows.
    Returns (result, queries, indices); the last two are None without a
    bank."""
    import torch

    from image_denoising_tpu_torch.adapters import wrappers
    from image_denoising_tpu_torch.eval import tiled
    from image_denoising_tpu_torch.memory.retrieval import (top1_l2_retrieval,
                                                            top1_l2_retrieval_reference)

    h, w = frame.shape
    cap = Capture(model_call)
    run = tiled.make_tiled_hann_runner(cap, h, w, ps, overlap, batch,
                                       out_dtype="uint8_round", pre_tile_fn=pre_tile_fn,
                                       device=device)
    grid = tiled.edge_aligned_grid(h, w, ps, overlap)
    med, times = timed_runs(run, frame, device, reps)
    seen = []

    def recording(q, bank_flat, sq_norms):
        idx = top1_l2_retrieval(q, bank_flat, sq_norms)
        seen.append((q, idx))
        return idx

    cap.on = True
    wrappers.top1_l2_retrieval = recording
    try:
        out = run(frame).cpu().numpy()
    finally:
        wrappers.top1_l2_retrieval = top1_l2_retrieval
        cap.on = False
    ins, preds = cap.taken(len(grid))
    preds = preds[:, 0]
    crops = hann_crops(frame, grid, ps)
    res = dict(leg="hann_memory" if bank is not None else "hann", hw=h, tiles=len(grid),
               ps=ps, overlap=overlap, s_per_frame=med, times_s=times,
               mps=h * w / 1e6 / med, out_mean=float(out.mean()),
               pred_std=float(np.std(preds)),
               tiles_equal_to_crops=same_pixels(ins[:, 0], crops),
               **level_check(out, hann_oracle(preds, grid, ps, h, w)))
    if bank is None:
        return res, None, None
    (q, idx), = seen
    # the int8 queries of uint8 tiles are their pixels − 128
    own_q = torch.from_numpy((crops.reshape(len(grid), -1).astype(np.int16) - 128)
                             .astype(np.int8)).to(q.device)
    ref = top1_l2_retrieval_reference(own_q, bank.noise_flat, bank.sq_norms)
    res.update(retrieval_batch=int(q.shape[0]),
               bank_rows=int((bank.sq_norms != torch.iinfo(torch.int32).max).sum()),
               bank_rows_padded=int(bank.noise_flat.shape[0]),
               queries_equal_to_crops=bool(torch.equal(q, own_q)),
               retrieval_equal_to_plain=bool(torch.equal(idx, ref)),
               retrieval_mismatches=int((idx != ref).sum()),
               memory_equal_to_bank=same_pixels(
                   ins[:, 1:], bank.clean[ref.long()].permute(0, 3, 1, 2).cpu().numpy()))
    return res, q, idx


def build_base(checkpoint=None, n_feature: int = N_FEATURE):
    """ImprovedUNet-``n_feature`` (grayscale) with ``checkpoint``'s weights,
    else torch's default init from seed 0."""
    import torch

    from image_denoising_tpu_torch.ckpt import load_checkpoint
    from image_denoising_tpu_torch.models import ImprovedUNet

    torch.manual_seed(0)
    model = ImprovedUNet(1, 1, n_feature)
    if checkpoint:
        model.load_state_dict(load_checkpoint(checkpoint, arch="UNetImproved"),
                              strict=True)
    return model.eval()


def seeded_adapter():
    """``hyper_gated_fft`` (hidden ``HIDDEN``) with every weight drawn
    non-zero from seed 0 (its zero-initialised tails too, so the adapter
    moves the output)."""
    import torch

    from image_denoising_tpu_torch.adapters import build_memory_adapter

    torch.manual_seed(0)
    adapter = build_memory_adapter("hyper_gated_fft", 1, HIDDEN)
    with torch.no_grad():
        for p in adapter.parameters():
            fan_in = p[0].numel() if p.dim() > 1 else 16
            p.uniform_(-fan_in ** -0.5, fan_in ** -0.5)
    return adapter.eval()


def run(pyr_hw: int = 4672, hann_hw: int = 2816, *, checkpoint=None, device="cuda",
        emit=print) -> dict:
    """Both legs at this module's geometry (read at the call); ``emit`` gets
    one JSON line per leg. Returns {"pyramid": …, "hann": …, "retrieval":
    (queries, indices, bank)}."""
    import torch

    sys.path.insert(0, REPO)
    from image_denoising_tpu_torch.adapters import DenoiserWithMemoryAdapter
    from image_denoising_tpu_torch.cli.evaluation_704_iqsl_memory import (
        make_memory_model_call)
    from image_denoising_tpu_torch.memory import build_memory_bank_from_frames
    from image_denoising_tpu_torch.models import make_fused_forward

    big = seeded_frame(max(pyr_hw, hann_hw))
    fwd = make_fused_forward(build_base(checkpoint, N_FEATURE), device=device,
                             dtype=getattr(torch, DTYPE))
    pyr = pyramid_leg(fwd, np.ascontiguousarray(big[:pyr_hw, :pyr_hw]), ps=PS, overlap=OVERLAP,
                      batch=-CHUNK, device=device, reps=REPS)
    pyr["dtype"] = DTYPE
    emit(json.dumps(pyr))

    t0 = time.perf_counter()
    clean, noise = bank_pairs(BANK_PAIRS, BANK_FRAME)
    bank = build_memory_bank_from_frames(clean, noise, HANN_PS, BANK_STRIDE,
                                         bank_dtype="int8", pad_to=BANK_PAD,
                                         clean_dtype="uint8", device=device)
    _sync(device)
    bank_s = time.perf_counter() - t0
    adapter = seeded_adapter().to(device)
    model_call, pre = make_memory_model_call(DenoiserWithMemoryAdapter(fwd, adapter), bank)
    hann, q, idx = hann_leg(model_call, np.ascontiguousarray(big[:hann_hw, :hann_hw]),
                            pre_tile_fn=pre, bank=bank, ps=HANN_PS, overlap=HANN_OVERLAP,
                            batch=-CHUNK, device=device, reps=REPS)
    hann.update(dtype=DTYPE, bank_seconds=bank_s)
    emit(json.dumps(hann))
    return dict(pyramid=pyr, hann=hann, retrieval=(q, idx, bank))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("pyr_hw", nargs="?", type=int, default=4672)
    ap.add_argument("hann_hw", nargs="?", type=int, default=2816)
    ap.add_argument("--checkpoint", default=None,
                    help="ImprovedUNet-48 .ckpt of the base (default: seeded init)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("huge_frame: no CUDA device (pass --device cpu for the CPU)",
                  file=sys.stderr)
            return 1
    res = run(args.pyr_hw, args.hann_hw, checkpoint=args.checkpoint, device=args.device)
    ok = all(res[leg][k] for leg in ("pyramid", "hann")
             for k in ("within_limits", "tiles_equal_to_crops"))
    ok &= all(res["hann"][k] for k in ("queries_equal_to_crops", "retrieval_equal_to_plain",
                                       "memory_equal_to_bank"))
    print(json.dumps({"kind": "huge_frame_done", "pass": bool(ok)}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
