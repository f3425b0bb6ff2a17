from .tiled import (
    denoise_tiled_pyramid,
    make_tiled_pyramid_runner,
    make_tiled_pyramid_runner_frames,
    pyramid_weight_mask,
    reference_tile_grid,
)

__all__ = [
    "denoise_tiled_pyramid",
    "make_tiled_pyramid_runner",
    "make_tiled_pyramid_runner_frames",
    "pyramid_weight_mask",
    "reference_tile_grid",
]
