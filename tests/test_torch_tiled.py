"""The port's tiled pyramid engine (image_denoising_tpu_torch/eval/tiled.py)
against the JAX ``make_tiled_pyramid_runner_frames`` on the same frames."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from image_denoising_tpu.eval import tiled as jax_tiled
from image_denoising_tpu_torch.ckpt import load_jax_params
from image_denoising_tpu_torch.eval import tiled
from image_denoising_tpu_torch.models import ImprovedUNet, make_fused_forward

from _torch_port_helpers import one_torch_thread, seeded_improved_unet_params  # noqa: F401


def _jax_run(model_call, frames, ps, overlap, batch, out_dtype):
    f, h, w = frames.shape
    run = jax_tiled.make_tiled_pyramid_runner_frames(
        model_call, f, h, w, ps, overlap, batch=batch, out_dtype=out_dtype)
    out, l1 = run(jnp.asarray(frames))
    return np.asarray(out), np.asarray(l1)


def _torch_run(model_call, frames, ps, overlap, batch, out_dtype):
    f, h, w = frames.shape
    run = tiled.make_tiled_pyramid_runner_frames(
        model_call, f, h, w, ps, overlap, batch=batch, out_dtype=out_dtype,
        device="cpu")
    out, l1 = run(frames)
    return out.numpy(), l1.numpy()


# (frames, h, w, ps, overlap, batch): exact fit, ragged with a -k scan whose
# last chunk is padded, and a >256-tile grid that takes the JAX scatter blend
GEOMETRIES = {
    "exact_fit": (2, 96, 96, 64, 32, -4),
    "ragged": (2, 80, 112, 64, 32, 5),
    "scatter_over_256_tiles": (1, 68, 68, 8, 4, 0),
}


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
@pytest.mark.parametrize("model", ["identity", "affine"])
def test_pyramid_blend_matches_jax(geometry, model):
    f, h, w, ps, overlap, batch = GEOMETRIES[geometry]
    assert (len(tiled.reference_tile_grid(h, w, ps, ps - overlap)) > 256) == (
        geometry == "scatter_over_256_tiles")
    frames = np.random.default_rng(3).integers(0, 256, (f, h, w)).astype(np.uint8)
    # "affine" leaves [0, 1], so the blend's clip and the L1 are exercised
    call = (lambda t: t) if model == "identity" else (lambda t: 1.3 * t - 0.1)
    ref, ref_l1 = _jax_run(call, frames, ps, overlap, batch, "float32")
    out, l1 = _torch_run(call, frames, ps, overlap, batch, "float32")
    assert out.shape == (f, h, w) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, atol=1e-6)
    np.testing.assert_allclose(l1, ref_l1, atol=1e-6)


def test_reflect_indices_cycle_past_tile_edge():
    """Edge tiles narrower than overlap+1 mirror cyclically (no crash)."""
    np.testing.assert_array_equal(
        tiled._reflect_indices(10, 3, 8),
        jax_tiled._reflect_indices(10, 3, 8))
    np.testing.assert_array_equal(tiled._reflect_indices(10, 1, 4), [10] * 4)


@pytest.mark.parametrize("batch", [0, 3, -2])
def test_chunked_forward_pads_and_crops(batch):
    tiles = torch.arange(7 * 4, dtype=torch.float32).reshape(7, 1, 2, 2)
    calls = []

    def model_call(t):
        calls.append(t.shape[0])
        return t * 2

    out = tiled._chunked_forward(model_call, tiles, batch)
    torch.testing.assert_close(out, tiles * 2)
    assert set(calls) == ({7} if batch == 0 else {abs(batch)})


def test_tiny_model_uint8_floor_matches_jax():
    """ImprovedUNet-8 through both engines with uint8_floor: at most one
    level apart (summation order can move a blended pixel across a rounding
    edge), on at most 0.1 % of pixels."""
    rng = np.random.default_rng(4)
    frames = rng.integers(0, 256, (2, 48, 40)).astype(np.uint8)
    jm, params = seeded_improved_unet_params(8, seed=1)
    jfwd = jax.jit(lambda t: jm.apply({"params": params}, t))
    ref, ref_l1 = _jax_run(jfwd, frames, 32, 16, -4, "uint8_floor")
    model = load_jax_params(ImprovedUNet(in_nc=1, out_nc=1, n_feature=8), params)
    out, l1 = _torch_run(make_fused_forward(model, device="cpu"), frames,
                         32, 16, -4, "uint8_floor")
    assert out.dtype == np.uint8 and out.shape == ref.shape
    diff = np.abs(out.astype(np.int16) - ref.astype(np.int16))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    np.testing.assert_allclose(l1, ref_l1, atol=1e-5)


def test_denoise_tiled_pyramid_single_frame():
    frame = np.random.default_rng(6).integers(0, 256, (40, 56)).astype(np.uint8)
    out, l1 = tiled.denoise_tiled_pyramid(lambda t: t, frame, ps=32, overlap=8,
                                          out_dtype="uint8_round", device="cpu")
    ref, _ = jax_tiled.denoise_tiled_pyramid(lambda t: t, frame, ps=32,
                                             overlap=8, out_dtype="uint8_round")
    np.testing.assert_array_equal(out, ref)
    assert l1 == 0.0
