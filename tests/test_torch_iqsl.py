"""The port's IQSL (losses/iqsl.py) against the JAX package's: the value and
its gradient with respect to the prediction, against ``jax.grad``, at two
margins and two temperatures; and the threshold estimate on a directory of
PNGs."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from image_denoising_tpu.losses import estimate_intensity_thresholds as jax_thresholds
from image_denoising_tpu.losses import iqsl_loss as jax_iqsl
from image_denoising_tpu_torch.losses import estimate_intensity_thresholds, iqsl_loss

from _torch_port_helpers import one_torch_thread  # noqa: F401

T1, T2 = 0.3, 0.7


@pytest.mark.parametrize("margin", [0.0, 0.05])
@pytest.mark.parametrize("tau", [0.1, 0.03])
def test_iqsl_value_and_grad_match_jax(margin, tau):
    """float32, 2 × 64² NHWC / NCHW: value within rtol 1e-5 and the
    gradient with respect to pred within 1e-5 of its largest entry (the
    same elementwise ops, sums in another order)."""
    rng = np.random.default_rng(int(100 * tau + 1000 * margin))
    target = rng.random((2, 64, 64, 1), dtype=np.float32)
    pred = np.clip(target + rng.normal(0, 0.1, target.shape), 0, 1).astype(np.float32)

    def jloss(p):
        return jax_iqsl(p, jnp.asarray(target), T1, T2, tau=tau, margin=margin,
                        ce_factor=0.5)

    want, want_g = jax.value_and_grad(jloss)(jnp.asarray(pred))
    p = torch.from_numpy(pred.transpose(0, 3, 1, 2).copy()).requires_grad_(True)
    got = iqsl_loss(p, torch.from_numpy(target.transpose(0, 3, 1, 2).copy()), T1, T2,
                    tau=tau, margin=margin, ce_factor=0.5)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    want_g = np.asarray(want_g).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(p.grad.numpy(), want_g, rtol=0,
                               atol=1e-5 * np.abs(want_g).max())


def test_thresholds_match_jax(tmp_path):
    from PIL import Image

    (tmp_path / "clean").mkdir()
    rng = np.random.default_rng(3)
    for i in range(4):
        Image.fromarray(rng.integers(0, 256, (40, 48)).astype(np.uint8)).save(
            tmp_path / "clean" / f"c{i}.png")
    for kw in ({}, {"q1": 0.1, "q2": 0.9, "max_images": 2}):
        got = estimate_intensity_thresholds(str(tmp_path), **kw)
        assert got == jax_thresholds(str(tmp_path), **kw)
    with pytest.raises(RuntimeError, match="No clean images"):
        estimate_intensity_thresholds(str(tmp_path / "missing"))
