"""The training step's share of the card's peak: the fused forward over
both halves of the batch (2·batch images) with the backward counted as
twice the forward (``work.forward_flops``), per second of the traced
window, over the highest dense rate the step may take: float32 convolutions
run under cuDNN's default TF32 (495 TFLOP/s), bf16 at 989."""
from gpubench.work import PEAK_FLOPS, forward_flops

PEAK = {"float32": "tf32", "bfloat16": "bfloat16"}


def read(cell, summary):
    if not summary["busy_s"]:
        return None
    tr = cell.traffic
    flops = 3 * forward_flops(cell.cfg, 2 * tr["batch"], tr["pairs"]["hw"]) * summary["n_units"]
    return 100.0 * flops / summary["window_s"] / PEAK_FLOPS[PEAK[cell.cfg["dtype"]]]
