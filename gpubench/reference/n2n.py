"""The reference's Neighbor2Neighbor training step (Huang et al., CVPR 2021,
as the reference's ``train.py`` runs it with ``--loss n2n``), in plain
PyTorch over ``net.py``'s network.

Each step draws Gaussian noise onto the clean batch, x = clean + σ/255 · n,
with n from PyTorch's own generator on the device seeded with the step's
noise seed (so the program's draw and this one are the same numbers), and
picks for every 2×2 cell of every image one of the 8 ordered neighbour
pairs (``PAIRS``, positions 0 TL, 1 TR, 2 BL, 3 BR) by ``philox.py``'s mask
draw: sub₁ and sub₂ take the cell's pixels at the pair's two positions.
Then, with f(x) taken without gradient,

    loss₁ = mean((f(sub₁) − sub₂)²)
    loss₂ = Λ · mean((f(sub₁) − sub₂ − (f(x)|₁ − f(x)|₂))²)
    Λ     = epoch / n_epoch · increase_ratio (in float32)
    loss  = λ₁ · loss₁ + λ₂ · loss₂

and Adam (β 0.9 / 0.999, ε 1e-8 outside the square root, bias corrected).
``steps`` follows the program's first steps from the same weights, batches
and seeds and returns what the comparison reads.
"""
from __future__ import annotations

import numpy as np
import torch

from .net import forward, make_weights
from .philox import block64, mask_draws, step_seeds
from .train import nchw01

PAIRS = np.array([[0, 1], [0, 2], [1, 3], [2, 3], [1, 0], [2, 0], [3, 1], [3, 2]])


def noisy(clean01, noise_seed: int, sigma: float):
    gen = torch.Generator(device=clean01.device)
    gen.manual_seed(noise_seed)
    n = torch.randn(clean01.shape, generator=gen, device=clean01.device,
                    dtype=clean01.dtype)
    return clean01 + n * (sigma / 255.0)


def pair_positions(mask_seed: int, shape, counter_offset: int = 0):
    """int64 [N, H/2, W/2] positions of sub-image 1 and of sub-image 2."""
    n, _, h, w = shape
    pair = PAIRS[mask_draws(mask_seed, n, (h // 2) * (w // 2), counter_offset)]
    return (torch.from_numpy(pair[..., 0]).reshape(n, h // 2, w // 2),
            torch.from_numpy(pair[..., 1]).reshape(n, h // 2, w // 2))


def sub_image(img, pos):
    """The pixel at ``pos`` of each 2×2 cell: NCHW → [N, C, H/2, W/2]."""
    pos = pos.to(img.device)[:, None]
    dy, dx = pos // 2, pos % 2
    out = torch.zeros_like(img[:, :, ::2, ::2])
    for y in (0, 1):
        for x in (0, 1):
            out = torch.where((dy == y) & (dx == x), img[:, :, y::2, x::2], out)
    return out


def steps(cfg, seed: int, batches, device, tr, conv=None, counter_offset: int = 0,
          noise_offset: int = 0, betas=(0.9, 0.999), eps: float = 1e-8):
    """Run ``len(batches)`` N2N steps from ``make_weights(cfg, seed)`` with the
    run's operation seeds from ``seed``; ``tr`` the traffic (``sigma``,
    ``epoch``, ``n_epoch``, ``increase_ratio``, ``lambda1``, ``lambda2``,
    ``lr``). ``conv``: ``net.forward``'s convolution (a control's
    precision); ``counter_offset`` moves the mask draw's counters and
    ``noise_offset`` the noise seed (controls).

    Returns (losses, first-gradient norm per leaf, norm of each leaf's
    change over all the steps), leaves in ``make_weights`` order.
    """
    params = make_weights(cfg, seed, device)
    start = {k: v.clone() for k, v in params.items()}
    for v in params.values():
        v.requires_grad_(True)
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    s = {k: torch.zeros_like(v) for k, v in params.items()}
    lam = float(np.float32(tr["epoch"]) / np.float32(tr["n_epoch"])
                * np.float32(tr["increase_ratio"]))
    losses, grad_norms = [], None
    for t, ((clean_u8, _), op_seed) in enumerate(
            zip(batches, step_seeds(seed, len(batches))), start=1):
        noise_seed, mask_seed = block64(op_seed, 0)
        x = noisy(nchw01(clean_u8, device), (noise_seed + noise_offset) % 2 ** 64,
                  tr["sigma"])
        pos1, pos2 = pair_positions(mask_seed, x.shape, counter_offset)
        sub1, sub2 = sub_image(x, pos1), sub_image(x, pos2)
        with torch.no_grad():
            den = forward(params, x, cfg, conv)
            exp_diff = sub_image(den, pos1) - sub_image(den, pos2)
        diff = forward(params, sub1, cfg, conv) - sub2
        loss = (tr["lambda1"] * (diff ** 2).mean()
                + tr["lambda2"] * lam * ((diff - exp_diff) ** 2).mean())
        grads = torch.autograd.grad(loss, list(params.values()))
        losses.append(float(loss.detach()))
        if grad_norms is None:
            grad_norms = [float(g.norm()) for g in grads]
        with torch.no_grad():
            for (k, p), g in zip(params.items(), grads):
                m[k].mul_(betas[0]).add_(g, alpha=1 - betas[0])
                s[k].mul_(betas[1]).addcmul_(g, g, value=1 - betas[1])
                m_hat = m[k] / (1 - betas[0] ** t)
                s_hat = s[k] / (1 - betas[1] ** t)
                p.sub_(tr["lr"] * m_hat / (s_hat.sqrt() + eps))
    with torch.no_grad():
        change = [float((params[k] - start[k]).norm()) for k in params]
    return losses, grad_norms, change
