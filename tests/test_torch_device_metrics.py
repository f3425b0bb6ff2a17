"""The port's on-device metrics (metrics/device.py, ssim_torch) against the
JAX package's make_device_metrics and ssim_jax and against the host
metrics, and the port's native SSIM (csrc/ssim.cpp) against its scipy path
and the JAX package's native SSIM."""
import threading

import numpy as np
import pytest
import torch

from image_denoising_tpu.metrics import make_device_metrics as jax_device_metrics
from image_denoising_tpu.metrics.ssim import ssim as jax_ssim
from image_denoising_tpu.metrics.ssim import ssim_jax
from image_denoising_tpu_torch.metrics import (calculate_psnr, calculate_ssim,
                                               compute_iq_iou, frame_iq_iou,
                                               frame_psnr_ssim, make_device_metrics,
                                               ssim, ssim_torch)

from _torch_port_helpers import one_torch_thread  # noqa: F401


def _frames(seed, n=3, shape=(72, 80)):
    """(pred, clean) uint8 batches: a smooth clean frame with texture and a
    noisy prediction around it."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    clean = np.stack([(120 + 60 * np.sin(xx / (5.0 + i)) * np.cos(yy / 7.0)
                       + rng.normal(0, 8, shape)).clip(0, 255) for i in range(n)])
    pred = np.clip(clean + rng.normal(0, 12, clean.shape), 0, 255)
    return pred.astype(np.uint8), clean.astype(np.uint8)


@pytest.mark.parametrize("use_ssim", [True, False], ids=["ssim", "no_ssim"])
@pytest.mark.parametrize("iq_iou", [False, True], ids=["psnr", "iq_iou"])
def test_make_device_metrics_matches_jax_and_host(use_ssim, iq_iou):
    pred, clean = _frames(0)
    got = make_device_metrics(iq_iou=iq_iou, low_q=0.2, high_q=0.8, ssim=use_ssim)(
        torch.from_numpy(pred), torch.from_numpy(clean))
    ref = jax_device_metrics(iq_iou=iq_iou, low_q=0.2, high_q=0.8, ssim=use_ssim)(pred, clean)
    assert len(got) == len(ref) == 1 + use_ssim + iq_iou
    got = [g.numpy() for g in got]
    ref = [np.asarray(r) for r in ref]
    for k in range(len(pred)):
        assert abs(got[0][k] - ref[0][k]) <= 1e-3
        assert abs(got[0][k] - calculate_psnr(pred[k], clean[k])) <= 1e-3
        if use_ssim:
            assert abs(got[1][k] - ref[1][k]) <= 1e-5
            assert abs(got[1][k] - calculate_ssim(pred[k], clean[k])) <= 1e-4
        if iq_iou:
            np.testing.assert_allclose(got[-1][k], ref[-1][k], atol=1e-7)
            np.testing.assert_allclose(got[-1][k],
                                       compute_iq_iou(pred[k], clean[k], 0.2, 0.8),
                                       atol=1e-7)


def test_identical_and_constant_frames():
    """Identical frames: PSNR +inf (the un-guarded host PSNR). Constant
    frames: both thresholds equal the constant, every pixel is 'bright' (the
    bright label wins), so dark and mid are NaN and bright is 1."""
    _, clean = _frames(1, n=2)
    c = torch.from_numpy(clean)
    psnr, ssim_v, _ = make_device_metrics(iq_iou=True)(c, c)
    assert torch.isinf(psnr).all() and calculate_psnr(clean[0], clean[0]) == float("inf")
    np.testing.assert_allclose(ssim_v.numpy(), 1.0, atol=1e-6)
    const = torch.full((2, 16, 16), 77, dtype=torch.uint8)
    ious = frame_iq_iou(const, const).numpy()
    host = compute_iq_iou(const[0].numpy(), const[0].numpy())
    assert np.isnan(ious[:, :2]).all() and np.isnan(host[:2]).all()
    assert (ious[:, 2] == 1.0).all() and host[2] == 1.0


def test_frame_psnr_ssim_on_three_channel_frames():
    """[F, H, W, 3]: PSNR over all channels, SSIM per channel and averaged,
    as calculate_ssim scores an RGB frame."""
    pred, clean = _frames(2, n=3)
    p3 = np.stack([pred, pred[::-1], np.roll(pred, 1, 0)], -1)[:2]  # [2, H, W, 3]
    c3 = np.stack([clean, clean[::-1], np.roll(clean, 1, 0)], -1)[:2]
    psnr, s = frame_psnr_ssim(torch.from_numpy(p3), torch.from_numpy(c3))
    for k in range(2):
        assert abs(float(psnr[k]) - calculate_psnr(p3[k], c3[k])) <= 1e-3
        assert abs(float(s[k]) - calculate_ssim(p3[k], c3[k])) <= 1e-4


def test_ssim_torch_ignores_the_tf32_flags():
    """ssim_torch computes its filter in plain float32: its result does not
    depend on torch.backends.cudnn.allow_tf32 (True by default), and stays
    within 1e-5 of ssim_jax (HIGHEST precision) and 1e-4 of the float64
    host SSIM."""
    pred, clean = _frames(3, n=4)
    p, c = torch.from_numpy(pred).float(), torch.from_numpy(clean).float()
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
        on = ssim_torch(p, c)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        off = ssim_torch(p, c)
    assert torch.equal(on, off)
    np.testing.assert_allclose(on.numpy(), np.asarray(ssim_jax(pred, clean)), atol=1e-5)
    host = [calculate_ssim(pred[k], clean[k]) for k in range(4)]
    np.testing.assert_allclose(on.numpy(), host, atol=1e-4)


def test_iq_iou_thresholds_past_torch_quantile_limit():
    """A 4096×4097 frame holds more than 2**24 pixels, which torch.quantile
    refuses; the sorted quantile still gives the host's IoU."""
    rng = np.random.default_rng(4)
    clean = rng.integers(0, 256, (1, 4096, 4097), dtype=np.uint8)
    pred = np.clip(clean.astype(np.int16) + rng.integers(-9, 10, clean.shape), 0, 255)
    pred = pred.astype(np.uint8)
    got = frame_iq_iou(torch.from_numpy(pred), torch.from_numpy(clean)).numpy()[0]
    np.testing.assert_allclose(got, compute_iq_iou(pred[0], clean[0]), atol=1e-7)


def test_native_ssim_matches_scipy_and_jax():
    pred, clean = _frames(5, n=2, shape=(96, 128))
    for k in range(2):
        native = ssim(pred[k], clean[k])
        assert abs(native - ssim(pred[k], clean[k], native=False)) < 1e-12
        assert abs(native - jax_ssim(pred[k], clean[k], native=True)) < 1e-12


def test_native_ssim_first_use_from_four_threads(tmp_path, monkeypatch):
    """Four threads that call the native SSIM at once, before the library
    exists, build it once and score like one thread does."""
    from image_denoising_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "HOST_BUILD_DIR", tmp_path / "host")
    _build.load_ssim.cache_clear()
    pred, clean = _frames(6, n=4, shape=(64, 80))
    out = [None] * 4
    barrier = threading.Barrier(4)

    def score(k):
        barrier.wait()
        out[k] = ssim(pred[k], clean[k])

    try:
        threads = [threading.Thread(target=score, args=(k,)) for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
        assert len(list((tmp_path / "host").glob("libssim_*.so"))) == 1
        assert out == [ssim(pred[k], clean[k]) for k in range(4)]
        for k in range(4):
            assert abs(out[k] - ssim(pred[k], clean[k], native=False)) < 1e-12
    finally:
        _build.load_ssim.cache_clear()
