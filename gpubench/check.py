"""The numbers that decide ``correct``, worked out from the program's
outputs and the reference's. Which of them a cell compares, and at what
limit, is in ``limits/<workload>.json``.

Serving: each returned uint8 frame against the reference's frame of the
same input. ``off1_share``: share of pixels one level or more apart;
``mean_levels``: mean absolute difference in levels; ``max_levels``: the
widest. ``tile_off1_max`` and ``tile_mean_levels_max``: the same two over
each tile's footprint in each frame (the reference's tile grid), the worst
of any: a fault confined to one tile or one chunk shows there undiluted.

Training: the first steps' losses, the first gradient and the change of
the parameters, each norm taken leaf by leaf. ``loss<i>_gap``: the
relative gap of step i's loss; ``loss_gap``: the largest of them;
``grad_gap`` and ``step_gap``: the worst
leaf's gap between the program's norm and the reference's, over the
reference's norm of that leaf or of the median leaf, whichever is larger;
``grad_gap_med`` and ``step_gap_med``: the median leaf's gap.
Leaves whose reference gradient is under a thousandth of the median
leaf's move under Adam by rounding alone and are left out of
``step_gap``.
"""
from __future__ import annotations

import statistics

import numpy as np

ROUNDING_LEAF = 1e-3


def frame_readings(outputs, ref_frames, burst: int, pool: int, grid) -> dict:
    """``outputs``: [(burst index, uint8 [burst, H, W])]; ``ref_frames``:
    the reference's uint8 frame of each pool index; ``grid``: the tiles'
    footprints (r0, c0, height, width)."""
    n_px = n_off = total = 0
    worst = 0
    tile_off = tile_mean = 0.0
    for b, frames in outputs:
        for i, out in enumerate(frames):
            ref = ref_frames[(b * burst + i) % pool]
            d = np.abs(out.astype(np.int16) - ref.astype(np.int16))
            n_px += d.size
            n_off += int(np.count_nonzero(d))
            total += int(d.sum(dtype=np.int64))
            worst = max(worst, int(d.max()))
            for r0, c0, th, tw in grid:
                t = d[r0:r0 + th, c0:c0 + tw]
                tile_off = max(tile_off, int(np.count_nonzero(t)) / t.size)
                tile_mean = max(tile_mean, float(t.mean()))
    if not n_px:
        return {}
    return {"off1_share": n_off / n_px, "mean_levels": total / n_px,
            "max_levels": float(worst), "tile_off1_max": tile_off,
            "tile_mean_levels_max": tile_mean,
            "frames_compared": float(n_px // frames[0].size)}


def leaf_gaps(prog, ref, keep=None) -> list:
    """Each kept leaf's gap of norms over the larger of its reference norm
    and the median leaf's."""
    idx = [i for i in range(len(ref)) if keep is None or keep[i]]
    med = statistics.median(ref[i] for i in idx)
    return [abs(prog[i] - ref[i]) / max(ref[i], med, 1e-30) for i in idx]


def rounding_leaves(ref_grads) -> list:
    """Indices of the leaves left out of ``step_gap``."""
    med = statistics.median(ref_grads)
    return [i for i, g in enumerate(ref_grads) if g < ROUNDING_LEAF * med]


def train_readings(prog, ref) -> dict:
    """``prog`` and ``ref``: (losses, first-gradient norms, change norms),
    leaves in the same order."""
    (pl, pg, pc), (rl, rg, rc) = prog, ref
    out = set(rounding_leaves(rg))
    keep = [i not in out for i in range(len(rg))]
    gaps = [abs(a - b) / abs(b) for a, b in zip(pl, rl)]
    readings = {f"loss{i}_gap": g for i, g in enumerate(gaps, start=1)}
    grad, step = leaf_gaps(pg, rg), leaf_gaps(pc, rc, keep)
    readings.update(loss_gap=max(gaps), grad_gap=max(grad),
                    grad_gap_med=statistics.median(grad), step_gap=max(step),
                    step_gap_med=statistics.median(step), leaves_left_out=float(len(out)))
    return readings
