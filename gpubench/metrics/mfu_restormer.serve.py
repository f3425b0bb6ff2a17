"""The whole served Restormer burst's share of the card's peak: the
network's FLOPs (``work_restormer.forward_flops``) over the tiles a burst
carries, as the program's ``restormer.tiles`` counter counts them, per
second of the traced window, over the dense rate of the configuration's
dtype (bf16: 989 TFLOP/s)."""
from gpubench.metrics._restormer import tiles_per_burst
from gpubench.work import PEAK_FLOPS
from gpubench.work_restormer import forward_flops


def read(cell, summary):
    tiles = tiles_per_burst()
    if not tiles or not summary["busy_s"]:
        return None
    flops = forward_flops(cell.cfg, tiles, cell.traffic["tile"]) * summary["n_units"]
    return 100.0 * flops / summary["window_s"] / PEAK_FLOPS[cell.cfg["dtype"]]
