"""The chain kernel's share of its roofline over the traced bursts: the
least time its calls could take (``work.chain_work`` at each chunk, at the
peak of the route the configuration's dtype takes: bf16 wgmma, or float32
as 3xTF32) over the device time of ``chain_conv_kernel`` and
``chain_finish_kernel``."""
import math

from gpubench.reference.tiling import tile_grid
from gpubench.work import ITEMSIZE, chain_levels, chain_work, roofline_s

KERNELS = ("chain_conv_kernel<", "chain_finish_kernel<")
ROUTE = {"float32": "tf32x3", "bfloat16": "bfloat16"}


def read(cell, summary):
    t = sum(s for name, s in summary["ops"].items() if any(k in name for k in KERNELS))
    if not t:
        return None
    cfg, tr = cell.cfg, cell.traffic
    hw, k = tr["frames"]["hw"], abs(tr["tile_batch"])
    tiles = tr["burst"] * len(tile_grid(hw, hw, tr["tile"], tr["overlap"]))
    chunks = [k] * (tiles // k) + ([tiles % k] if tiles % k else [])
    dtype = cfg["dtype"]
    bound = sum(roofline_s(*chain_work(h, cin, nf, lead, ITEMSIZE[dtype], b), ROUTE[dtype])
                for b in chunks for h, cin, nf, lead in chain_levels(cfg, tr["tile"]))
    return 100.0 * bound * summary["n_units"] / t
