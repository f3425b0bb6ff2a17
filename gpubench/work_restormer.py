"""Restormer's work from shapes: the yardstick of ``mfu_restormer.serve`` and
``restormer_roofline.serve``. Nothing here depends on what implements it.

FLOPs are 2 per multiply-add of every convolution (a conv's multiply-adds a
pixel are its weight's element count, depthwise ones included) and of the
two attention products of each block (q kᵀ and A v, C²/h each a pixel);
the LayerNorms, the row norms, the softmax, GELU, the gate and the adds are
not counted. A stage is one level's run of transformer blocks, the work the
program's ``restormer.<stage>`` span holds. Its least bytes: its input read
and its output written once, and its weights read once (LayerNorm weights
and temperatures in float32, which serving keeps them in; the rest in the
compute dtype).
"""
from __future__ import annotations

from .reference.restormer import param_specs, stages
from .work import ITEMSIZE

# the resolution level (0: the tile's own) each top-level module runs at;
# a down conv runs before its PixelUnshuffle, an up conv before its shuffle
LEVEL = {"patch_embed": 0, "encoder_level1": 0, "down1_2": 0, "encoder_level2": 1,
         "down2_3": 1, "encoder_level3": 2, "down3_4": 2, "latent": 3, "up4_3": 3,
         "reduce_chan_level3": 2, "decoder_level3": 2, "up3_2": 2,
         "reduce_chan_level2": 1, "decoder_level2": 1, "up2_1": 1,
         "decoder_level1": 0, "refinement": 0, "output": 0}


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def stage_work(cfg, name: str, tile: int, batch: int, dtype: str):
    """(FLOPs, least bytes) of stage ``name``'s blocks over ``batch`` tiles of
    ``tile``²."""
    (prefix, c, heads, n_blocks, level), = [
        s[1:] for s in stages(cfg) if s[0] == name]
    px = batch * (tile >> level) ** 2
    macs = n_blocks * 2 * c * c // heads
    weight_bytes = 0
    for key, shape in param_specs(cfg):
        if key.startswith(prefix + "."):
            conv = len(shape) == 4  # else a LayerNorm weight or a temperature
            macs += _numel(shape) if conv else 0
            weight_bytes += _numel(shape) * (ITEMSIZE[dtype] if conv else 4)
    return 2.0 * px * macs, 2 * px * c * ITEMSIZE[dtype] + weight_bytes


def forward_flops(cfg, batch: int, tile: int) -> float:
    """FLOPs of one forward of ``batch`` tiles of ``tile``²: every stage and
    every conv around them."""
    total = sum(stage_work(cfg, s[0], tile, batch, "float32")[0] for s in stages(cfg))
    for key, shape in param_specs(cfg):
        top = key.split(".")[0]
        if len(shape) == 4 and not any(key.startswith(s[1] + ".") for s in stages(cfg)):
            total += 2.0 * batch * (tile >> LEVEL[top]) ** 2 * _numel(shape)
    return total
