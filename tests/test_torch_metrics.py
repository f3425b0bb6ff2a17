"""The port's host metrics and image loading against the JAX package's."""
import numpy as np
import pytest

from image_denoising_tpu.data.pairs import load_image_f32 as jax_load_image_f32
from image_denoising_tpu.metrics import (
    calculate_psnr as jax_psnr,
    calculate_ssim as jax_ssim,
    compute_iq_iou as jax_iq_iou,
)
from image_denoising_tpu_torch.data.pairs import load_image_f32, validation_denoise
from image_denoising_tpu_torch.metrics import calculate_psnr, calculate_ssim, compute_iq_iou


@pytest.fixture
def pair():
    rng = np.random.default_rng(9)
    clean = rng.integers(0, 256, (48, 40)).astype(np.uint8)
    pred = np.clip(clean + rng.normal(0, 12, clean.shape), 0, 255).astype(np.uint8)
    return pred, clean


@pytest.mark.parametrize("shape", [(48, 40), (48, 40, 3), (48, 40, 1)])
def test_psnr_ssim_iou_match_jax(pair, shape):
    pred, clean = pair
    if len(shape) == 3:
        pred = np.repeat(pred[..., None], shape[2], axis=2)
        clean = np.repeat(clean[..., None], shape[2], axis=2)
    assert calculate_psnr(pred, clean) == jax_psnr(pred, clean, zero_mse_psnr=None)
    # scipy mirror filter vs the JAX package's native (or scipy) SSIM
    assert abs(calculate_ssim(pred, clean) - jax_ssim(pred, clean)) < 1e-9
    np.testing.assert_array_equal(compute_iq_iou(pred, clean, 0.2, 0.8),
                                  jax_iq_iou(pred, clean, 0.2, 0.8))
    assert calculate_psnr(clean, clean) == float("inf")


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_load_image_and_pairs_match_jax(tmp_path, dtype):
    from PIL import Image

    rng = np.random.default_rng(10)
    for sub in ("clean", "noise"):
        (tmp_path / sub).mkdir()
        for i in range(2):
            a = rng.integers(0, np.iinfo(dtype).max, (16, 24)).astype(dtype)
            Image.fromarray(a).save(tmp_path / sub / f"f{i}.png")
    clean, noisy, cpaths, npaths = validation_denoise(str(tmp_path))
    assert [p.split("/")[-1] for p in cpaths] == ["f0.png", "f1.png"]
    for img, path in zip(clean + noisy, cpaths + npaths):
        np.testing.assert_array_equal(img, jax_load_image_f32(path))
        assert img.dtype == np.float32 and img.max() <= 255.0
    np.testing.assert_array_equal(load_image_f32(cpaths[0]), clean[0])
