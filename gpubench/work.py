"""Work from shapes and the card's published peaks: the yardstick of every
roofline and ``mfu`` share. Nothing here depends on what implements the
work.

Peaks are NVIDIA's dense rates for the H100 SXM at its 700 W limit.
``tf32x3`` is float32 on the tensor cores as three TF32 products (the
chain kernel's float32 route); ``float32`` is the CUDA cores' rate.
"""
from __future__ import annotations

from .reference.net import GROWTH, N_GROWTH, layer_specs

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "tf32x3": 495e12 / 3,
              "bfloat16": 989e12}
ITEMSIZE = {"float32": 4, "bfloat16": 2}


def chain_levels(cfg, tile: int):
    """The level blocks the chain computes: ``(h, cin, nf, lead)`` for each
    down level, the bottleneck and each up level (``lead`` is the level's
    first conv: the down lead conv or the up fuse conv)."""
    nc, nf, depth = cfg["n_channel"], cfg["n_feature"], cfg["depth"]
    widths = [nf * 2 ** i for i in range(depth)]
    levels, cin = [], nc + (1 if cfg["noise"] else 0)
    for i, w in enumerate(widths):
        levels.append((tile >> i, cin, w, True))
        cin = w
    levels.append((tile >> depth, cin, cin, False))
    for i, skip in enumerate(reversed(widths)):
        out = cin // 2
        levels.append((tile >> (depth - 1 - i), out + skip, out, True))
        cin = out
    return levels


def chain_work(h: int, cin: int, nf: int, lead: bool, itemsize: int, batch: int):
    """(FLOPs, bytes) one chain call needs at ``batch`` tiles of h²: 2 per
    multiply-add; x, weights and biases read once, the RDB output and the
    ResBlock's conv0 output written once."""
    px = batch * h * h
    macs_w = (9 * cin * nf if lead else 0) + sum(
        9 * (nf + i * GROWTH) * GROWTH for i in range(N_GROWTH))
    macs_w += (nf + N_GROWTH * GROWTH) * nf + 9 * nf * nf
    params = macs_w + (nf if lead else 0) + N_GROWTH * GROWTH + nf
    nbytes = (px * (cin if lead else nf) + params + 2 * px * nf) * itemsize
    return 2 * px * macs_w, nbytes


def roofline_s(flops: float, nbytes: float, peak: str) -> float:
    """The least time the card could take: operations at the route's peak
    or bytes at the memory rate, whichever is longer."""
    return max(flops / PEAK_FLOPS[peak], nbytes / HBM_BYTES_PER_S)


def _resolution(key: str, hw: int, depth: int) -> int:
    part = key.split(".")
    if part[0] == "downs":
        return hw >> int(part[1])
    if part[0] == "bottle":
        return hw >> depth
    if part[0] == "ups":
        level = depth - 1 - int(part[1])
        return hw >> (level + 1 if part[2] == "conv_ps" else level)
    return hw


def forward_flops(cfg, batch: int, hw: int) -> float:
    """FLOPs of one forward of ``batch`` images of hw²: every convolution,
    2 per multiply-add (GroupNorm, activations and pooling not counted)."""
    total = 0
    for spec in layer_specs(cfg):
        if len(spec) == 5:
            key, cout, cin, k, _ = spec
            r = _resolution(key, hw, cfg["depth"])
            total += r * r * cout * cin * k * k
    return 2.0 * batch * total
