"""The whole served burst's share of the card's peak: every convolution of
the network over the burst's tiles (``work.forward_flops``) per second of
the traced window, over the highest dense rate the serving path may take
in the configuration's dtype (bf16: 989 TFLOP/s; float32: 3xTF32,
495/3 TFLOP/s, since its plain convolutions run with TF32 off)."""
from gpubench.reference.tiling import tile_grid
from gpubench.work import PEAK_FLOPS, forward_flops

PEAK = {"float32": "tf32x3", "bfloat16": "bfloat16"}


def read(cell, summary):
    if not summary["busy_s"]:
        return None
    cfg, tr = cell.cfg, cell.traffic
    hw = tr["frames"]["hw"]
    tiles = tr["burst"] * len(tile_grid(hw, hw, tr["tile"], tr["overlap"]))
    flops = forward_flops(cfg, tiles, tr["tile"]) * summary["n_units"]
    return 100.0 * flops / summary["window_s"] / PEAK_FLOPS[PEAK[cfg["dtype"]]]
