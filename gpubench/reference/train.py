"""The reference's A-domain training step (``train.py:354-368``), in plain PyTorch.

loss = α·L1(f(noisy), clean) + β·TV(f(clean)) + γ·L1(f(clean), clean), TV
the mean absolute forward difference of f(clean) over each spatial axis,
averaged; Adam (β 0.9 / 0.999, ε 1e-8 outside the square root, bias
corrected) written out. ``steps`` follows the program's first steps from
the same weights and batches and returns what the comparison reads.
"""
from __future__ import annotations

import torch

from .net import forward, make_weights


def structure_loss(pred_n, pred_c, clean, alpha=1.0, beta=0.5, gamma=0.5):
    tv = ((pred_c[:, :, 1:] - pred_c[:, :, :-1]).abs().mean()
          + (pred_c[:, :, :, 1:] - pred_c[:, :, :, :-1]).abs().mean()) / 2.0
    return (alpha * (pred_n - clean).abs().mean() + beta * tv
            + gamma * (pred_c - clean).abs().mean())


def nchw01(batch_u8, device):
    """NHWC uint8 → NCHW float32 in [0, 1] on ``device``."""
    t = torch.as_tensor(batch_u8).to(device)
    return t.permute(0, 3, 1, 2).float() / 255.0


def steps(cfg, seed: int, batches, device, lr: float, alpha: float = 1.0,
          conv=None, betas=(0.9, 0.999), eps: float = 1e-8):
    """Run ``len(batches)`` steps from ``make_weights(cfg, seed)``.

    Returns (losses, first-gradient norm per leaf, norm of each leaf's
    change over all the steps), leaves in ``make_weights`` order.
    """
    params = make_weights(cfg, seed, device)
    start = {k: v.clone() for k, v in params.items()}
    for v in params.values():
        v.requires_grad_(True)
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    s = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, grad_norms = [], None
    for t, (clean_u8, noisy_u8) in enumerate(batches, start=1):
        clean, noisy = nchw01(clean_u8, device), nchw01(noisy_u8, device)
        b = clean.shape[0]
        both = forward(params, torch.cat([noisy, clean]), cfg, conv)
        loss = structure_loss(both[:b], both[b:], clean, alpha)
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
                p.sub_(lr * m_hat / (s_hat.sqrt() + eps))
    with torch.no_grad():
        change = [float((params[k] - start[k]).norm()) for k in params]
    return losses, grad_norms, change
