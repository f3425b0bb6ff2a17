"""Restormer's transformer blocks' share of their roofline: over a burst's
chunks and the eight stages, the sum of max(FLOPs at the dtype's peak,
least bytes at 3.35 TB/s) (``work_restormer.stage_work``), over the device
time of the stage spans (``restormer_blocks_ms.serve``)."""
from gpubench.metrics._restormer import STAGES, blocks_ms
from gpubench.reference.tiling import tile_grid
from gpubench.work import roofline_s
from gpubench.work_restormer import stage_work


def read(cell, summary):
    ms = blocks_ms()
    if not ms:
        return None
    cfg, tr = cell.cfg, cell.traffic
    hw, k = tr["frames"]["hw"], abs(tr["tile_batch"])
    tiles = tr["burst"] * len(tile_grid(hw, hw, tr["tile"], tr["overlap"]))
    chunks = [k] * (tiles // k) + ([tiles % k] if tiles % k else [])
    bound = sum(roofline_s(*stage_work(cfg, s, tr["tile"], b, cfg["dtype"]), cfg["dtype"])
                for b in chunks for s in STAGES)
    return 100.0 * bound / (ms / 1e3)
