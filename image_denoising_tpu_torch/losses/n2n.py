"""Neighbor2Neighbor regularized loss (counterpart of ``image_denoising_tpu/losses/n2n.py``).

Semantics (``training_script.md:126-156``):

    loss1 = mean((f(sub1) − sub2)²)
    loss2 = Λ · mean((diff − (f(noisy)|sub1 − f(noisy)|sub2))²)
    Λ     = epoch / n_epoch · increase_ratio
    total = Λ₁·loss1 + Λ₂·loss2

where f(noisy) is evaluated without gradient; its difference is detached
here as well, as the JAX version stops its gradient.
"""
from __future__ import annotations

__all__ = ["n2n_regularized_loss"]


def n2n_regularized_loss(noisy_sub1_pred, noisy_sub2, noisy_denoised_sub1,
                         noisy_denoised_sub2, lam, lambda1: float = 1.0,
                         lambda2: float = 1.0):
    """All args are half-resolution sub-images of one layout; lam is Λ."""
    diff = noisy_sub1_pred - noisy_sub2
    exp_diff = (noisy_denoised_sub1 - noisy_denoised_sub2).detach()
    loss1 = (diff ** 2).mean()
    loss2 = lam * ((diff - exp_diff) ** 2).mean()
    return lambda1 * loss1 + lambda2 * loss2, (loss1, loss2)
