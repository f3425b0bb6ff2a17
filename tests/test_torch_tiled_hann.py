"""The port's Hann² tiled engine (eval/tiled.py, Hann half) against the JAX
``make_tiled_hann_runner{,_frames}`` and ``denoise_tiled_hann``."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from image_denoising_tpu.eval import tiled as jax_tiled
from image_denoising_tpu_torch.eval import tiled

from _torch_port_helpers import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("h,w,ps,overlap", [(704, 704, 128, 64), (100, 90, 32, 16),
                                            (64, 64, 64, 8), (70, 41, 16, 5)])
def test_window_and_grid_match_jax(h, w, ps, overlap):
    np.testing.assert_array_equal(tiled.hann_window_2d(ps), jax_tiled.hann_window_2d(ps))
    assert tiled.edge_aligned_grid(h, w, ps, overlap) == jax_tiled.edge_aligned_grid(
        h, w, ps, overlap)


# model: NCHW in, NCHW out (port); NHWC (JAX). 'affine' leaves [0, 1], so a
# clip before the blend would show, and its slope puts no uint8 pixel on a
# rounding edge; 'stack' reads a second channel that pre_tile_fn appended to
# the whole stack
MODELS = {
    "identity": (lambda t: t, lambda t: t, None, None),
    "affine": (lambda t: 1.37 * t - 0.13, lambda t: 1.37 * t - 0.13, None, None),
    "stack": (lambda t: 1.4 * t[:, :1] + 0.6 * t[:, 1:] - 0.3,
              lambda t: 1.4 * t[..., :1] + 0.6 * t[..., 1:] - 0.3,
              lambda t: torch.cat([t, (1.0 - t) ** 2], 1),
              lambda t: jnp.concatenate([t, (1.0 - t) ** 2], -1)),
}
# (frames, h, w, ps, overlap, batch): ragged snapped edges with a padded -k
# chunk, and a >256-tile grid (the JAX scatter blend)
GEOMETRIES = {"snapped": (2, 100, 90, 32, 16, -4),
              "scatter_over_256_tiles": (1, 72, 72, 8, 4, 0)}


def _frames(f, h, w, seed=3):
    return np.random.default_rng(seed).integers(0, 256, (f, h, w)).astype(np.uint8)


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
@pytest.mark.parametrize("model", list(MODELS))
def test_hann_runner_frames_matches_jax(geometry, model):
    f, h, w, ps, overlap, batch = GEOMETRIES[geometry]
    assert (len(tiled.edge_aligned_grid(h, w, ps, overlap)) > 256) == (
        geometry == "scatter_over_256_tiles")
    call, jcall, pre, jpre = MODELS[model]
    frames = _frames(f, h, w)
    want = np.asarray(jax_tiled.make_tiled_hann_runner_frames(
        jcall, f, h, w, ps, overlap, batch, pre_tile_fn=jpre)(jnp.asarray(frames)))
    got = tiled.make_tiled_hann_runner_frames(
        call, f, h, w, ps, overlap, batch, pre_tile_fn=pre, device="cpu")(frames)
    assert got.dtype == torch.float32 and tuple(got.shape) == (f, h, w)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    if model != "identity":
        assert want.min() < 0 or want.max() > 1  # predictions are not clipped
    # the single-frame runner computes frame 0 the same way
    one = tiled.make_tiled_hann_runner(call, h, w, ps, overlap, batch,
                                       pre_tile_fn=pre, device="cpu")(frames[0])
    np.testing.assert_allclose(one.numpy(), want[0], atol=1e-6, rtol=0)


@pytest.mark.parametrize("model", ["identity", "affine"])
def test_denoise_tiled_hann_uint8_round_matches_jax(model):
    """uint8 via clip(p·255 + 0.5); the identity returns the frame itself."""
    call, jcall, _, _ = MODELS[model]
    frame = _frames(1, 100, 90)[0]
    want = jax_tiled.denoise_tiled_hann(jcall, frame, ps=32, overlap=16, batch=-4,
                                        out_dtype="uint8_round")
    got = tiled.denoise_tiled_hann(call, frame, ps=32, overlap=16, batch=-4,
                                   out_dtype="uint8_round", device="cpu")
    assert got.dtype == np.uint8 and got.shape == want.shape == (100, 90, 1)
    np.testing.assert_array_equal(got, want)
    if model == "identity":
        np.testing.assert_array_equal(got[..., 0], frame)
    f32 = tiled.denoise_tiled_hann(call, frame[..., None], ps=32, overlap=16,
                                   device="cpu")
    assert f32.dtype == np.float32 and f32.shape == (100, 90, 1)
