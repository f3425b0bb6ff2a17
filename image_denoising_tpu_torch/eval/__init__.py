from .tiled import (
    denoise_tiled_hann,
    denoise_tiled_pyramid,
    denoise_whole_frame,
    edge_aligned_grid,
    hann_window_2d,
    make_tiled_hann_runner,
    make_tiled_hann_runner_frames,
    make_tiled_pyramid_runner,
    make_tiled_pyramid_runner_frames,
    pyramid_weight_mask,
    reference_tile_grid,
)

__all__ = [
    "denoise_tiled_hann",
    "denoise_tiled_pyramid",
    "denoise_whole_frame",
    "edge_aligned_grid",
    "hann_window_2d",
    "make_tiled_hann_runner",
    "make_tiled_hann_runner_frames",
    "make_tiled_pyramid_runner",
    "make_tiled_pyramid_runner_frames",
    "pyramid_weight_mask",
    "reference_tile_grid",
]
