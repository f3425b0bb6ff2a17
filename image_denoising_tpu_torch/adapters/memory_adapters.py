"""The five memory-conditioned adapter variants as NCHW ``nn.Module``s.

Counterpart of ``image_denoising_tpu/adapters/memory_adapters.py``
(reference ``finetune_memory.py:530-1192``). Each takes (noisy, base_out,
mem_clean), NCHW in [0, 1]:

v1 MemoryResidualAdapter       3-conv CNN on the concat of all three,
                               zero-init last conv; out = base + δ.
v2 LowFrequencyBlendAdapter    fixed 9×9 σ=3 Gaussian depthwise low-pass;
                               1×1 gate net on the three low-pass maps (last
                               conv zero weights, bias −2); out =
                               HP_base + (1−g)·LP_base + g·LP_mem, clamped.
v3 GlobalMonotoneToneCurve     MLP(6 global mean/std features) → K−1
                               softplus slopes → cumsum → normalised
                               monotone curve applied to base_out.
v4 HyperGatedResidualAdapter   local 3-conv CNN on [noisy, base_out]
                               (zero-init last); hyper-MLP(6 features) →
                               per-channel γ = sigmoid, β = 0.1·tanh;
                               out = base + γ·r + β, clamped.
v5 HyperGatedResidualAdapterFFT  v4 plus row-wise rFFT power in 3 bands per
                               input (log1p, per-sample mean-normalised):
                               hyper input 6 + 3·3 = 15.

Submodule names follow the reference, so the state dicts of
``ckpt/pth_export.py::params_to_state_dict`` load with ``strict=True``:
``body.{0,2,4}``, ``gate_net.{0,2}``, ``mlp.{0,2}``, ``local_net.{0,2,4}``,
``hyper_mlp.{0,2}``. Fresh modules keep the JAX package's init: torch's
default for hidden layers, zeros (and the stated biases) for the tails, so
a new adapter is the identity on base_out (v2: up to its fixed blend).
Global standard deviations are Bessel-corrected (ddof=1), like torch's
``Tensor.std``.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "MemoryResidualAdapter",
    "LowFrequencyBlendAdapter",
    "GlobalMonotoneToneCurveAdapter",
    "HyperGatedResidualAdapter",
    "HyperGatedResidualAdapterFFT",
    "MEMORY_ADAPTERS",
    "build_memory_adapter",
    "row_fft_features",
]


def _global_mean_std(x):
    """[B, C, H, W] → (mean, std) each [B]; std is Bessel-corrected."""
    flat = x.reshape(x.shape[0], -1)
    mean = flat.mean(dim=1)
    var = ((flat - mean[:, None]) ** 2).sum(dim=1) / (flat.shape[1] - 1)
    return mean, var.sqrt()


def _stats(noisy, base_out, mem_clean):
    """[B, 6]: (mean, std) of noisy, base_out and mem_clean."""
    feats = []
    for t in (noisy, base_out, mem_clean):
        feats += list(_global_mean_std(t))
    return torch.stack(feats, dim=1)


def _zero_(layer: nn.Module, bias: float = 0.0) -> nn.Module:
    nn.init.zeros_(layer.weight)
    nn.init.constant_(layer.bias, bias)
    return layer


def _conv_body(cin: int, hidden: int, cout: int) -> nn.Sequential:
    """3×3 conv → ReLU → 3×3 conv → ReLU → zero-init 3×3 conv (keys 0, 2, 4)."""
    return nn.Sequential(
        nn.Conv2d(cin, hidden, 3, padding=1), nn.ReLU(),
        nn.Conv2d(hidden, hidden, 3, padding=1), nn.ReLU(),
        _zero_(nn.Conv2d(hidden, cout, 3, padding=1)))


class MemoryResidualAdapter(nn.Module):
    def __init__(self, in_channels: int = 1, hidden_channels: int = 16):
        super().__init__()
        self.body = _conv_body(3 * in_channels, hidden_channels, in_channels)

    def forward(self, noisy, base_out, mem_clean):
        return base_out + self.body(torch.cat([noisy, base_out, mem_clean], 1))


def _gaussian_kernel2d(k: int, sigma: float) -> np.ndarray:
    ax = np.arange(k, dtype=np.float32) - (k - 1) / 2.0
    xx, yy = np.meshgrid(ax, ax, indexing="ij")
    kernel = np.exp(-(xx**2 + yy**2) / (2.0 * sigma**2))
    return (kernel / kernel.sum()).astype(np.float32)


class LowFrequencyBlendAdapter(nn.Module):
    def __init__(self, in_channels: int = 1, hidden_channels: int = 16,
                 kernel_size: int = 9, sigma: float = 3.0,
                 clamp_output: bool = True):
        super().__init__()
        self.clamp_output = clamp_output
        self.register_buffer(
            "gaussian", torch.from_numpy(_gaussian_kernel2d(kernel_size, sigma)),
            persistent=False)
        self.gate_net = nn.Sequential(
            nn.Conv2d(3 * in_channels, hidden_channels, 1), nn.ReLU(),
            # zero weights, bias −2 → g ≈ 0.12 at init (finetune_memory.py:623-626)
            _zero_(nn.Conv2d(hidden_channels, in_channels, 1), -2.0))

    def _lowpass(self, x):
        k = self.gaussian.shape[0]
        c = x.shape[1]
        w = self.gaussian.to(x.dtype)[None, None].expand(c, 1, k, k)
        return F.conv2d(x, w, padding=k // 2, groups=c)

    def forward(self, noisy, base_out, mem_clean):
        lp_noisy = self._lowpass(noisy)
        lp_base = self._lowpass(base_out)
        lp_mem = self._lowpass(mem_clean)
        g = torch.sigmoid(self.gate_net(torch.cat([lp_noisy, lp_base, lp_mem], 1)))
        out = (base_out - lp_base) + (1.0 - g) * lp_base + g * lp_mem
        return out.clamp(0.0, 1.0) if self.clamp_output else out


class GlobalMonotoneToneCurveAdapter(nn.Module):
    def __init__(self, in_channels: int = 1, hidden_dim: int = 16,
                 num_ctrl_points: int = 8, clamp_output: bool = True):
        super().__init__()
        self.k = num_ctrl_points
        self.clamp_output = clamp_output
        self.mlp = nn.Sequential(
            _zero_(nn.Linear(6, hidden_dim)), nn.ReLU(),
            # softplus⁻¹(1): unit slopes, the identity curve at init
            _zero_(nn.Linear(hidden_dim, num_ctrl_points - 1),
                   math.log(math.exp(1.0) - 1.0)))

    def forward(self, noisy, base_out, mem_clean):
        k = self.k
        feats = _stats(noisy, base_out, mem_clean)
        slopes = F.softplus(self.mlp(feats)) + 1e-4
        y_rest = torch.cumsum(slopes * (1.0 / (k - 1)), dim=1)
        y = torch.cat([feats.new_zeros((feats.shape[0], 1)), y_rest], dim=1)
        y_vals = y / y[:, -1:].clamp(min=1e-6)  # [B, K]

        x = base_out.clamp(0.0, 1.0)
        pos = (x * (k - 1)).clamp(0.0, k - 1 - 1e-6)
        idx0 = torch.floor(pos).long()
        idx1 = torch.clamp(idx0 + 1, max=k - 1)
        t = pos - idx0.to(pos.dtype)
        b = base_out.shape[0]
        y0 = torch.gather(y_vals, 1, idx0.reshape(b, -1)).view_as(base_out)
        y1 = torch.gather(y_vals, 1, idx1.reshape(b, -1)).view_as(base_out)
        out = y0 + (y1 - y0) * t
        return out.clamp(0.0, 1.0) if self.clamp_output else out


def _hyper_mlp(in_features: int, hidden: int, channels: int) -> nn.Sequential:
    """Zero-initialised hyper-network → 2·channels raw (γ, β) (keys 0, 2)."""
    return nn.Sequential(_zero_(nn.Linear(in_features, hidden)), nn.ReLU(),
                         _zero_(nn.Linear(hidden, 2 * channels)))


def _gamma_beta(hyper, channels: int, beta_scale: float = 0.1):
    """[B, 2C] → per-channel γ = sigmoid, β = 0.1·tanh, each [B, C, 1, 1]."""
    gamma = torch.sigmoid(hyper[:, :channels])
    beta = beta_scale * torch.tanh(hyper[:, channels:])
    return gamma[:, :, None, None], beta[:, :, None, None]


class HyperGatedResidualAdapter(nn.Module):
    n_features = 6

    def __init__(self, in_channels: int = 1, hidden_channels: int = 16,
                 clamp_output: bool = True):
        super().__init__()
        self.in_channels = in_channels
        self.clamp_output = clamp_output
        self.local_net = _conv_body(2 * in_channels, hidden_channels, in_channels)
        self.hyper_mlp = _hyper_mlp(self.n_features, hidden_channels, in_channels)

    def _features(self, noisy, base_out, mem_clean):
        return _stats(noisy, base_out, mem_clean)

    def forward(self, noisy, base_out, mem_clean):
        r = self.local_net(torch.cat([noisy, base_out], 1))
        hyper = self.hyper_mlp(self._features(noisy, base_out, mem_clean))
        gamma, beta = _gamma_beta(hyper, self.in_channels)
        out = base_out + gamma * r + beta
        return out.clamp(0.0, 1.0) if self.clamp_output else out


def row_fft_features(x, num_bins: int = 3):
    """[B, C, H, W] → [B, num_bins]: row-wise rFFT power band means, log1p,
    per-sample mean-normalised (finetune_memory.py:1077-1116). Computed in
    float32, whatever x's dtype."""
    b, c, h, w = x.shape
    spec = torch.fft.rfft(x.float().reshape(b, c * h, w), dim=-1)
    power_mean = (spec.real ** 2 + spec.imag ** 2).mean(dim=1)  # [B, F]
    freq = power_mean.shape[-1]
    bin_size = freq // num_bins
    feats = torch.stack([
        power_mean[:, k * bin_size : (k + 1) * bin_size if k < num_bins - 1
                   else freq].mean(dim=-1)
        for k in range(num_bins)], dim=1)
    feats = torch.log1p(feats)
    return feats / (feats.mean(dim=1, keepdim=True) + 1e-6)


class HyperGatedResidualAdapterFFT(HyperGatedResidualAdapter):
    def __init__(self, in_channels: int = 1, hidden_channels: int = 16,
                 num_fft_bins: int = 3, clamp_output: bool = True):
        self.num_fft_bins = num_fft_bins
        self.n_features = 6 + 3 * num_fft_bins
        super().__init__(in_channels, hidden_channels, clamp_output)

    def _features(self, noisy, base_out, mem_clean):
        return torch.cat([_stats(noisy, base_out, mem_clean)] + [
            row_fft_features(t, self.num_fft_bins)
            for t in (noisy, base_out, mem_clean)], dim=1)


MEMORY_ADAPTERS = {
    "memory_residual": MemoryResidualAdapter,
    "lowfreq_blend": LowFrequencyBlendAdapter,
    "tone_curve": GlobalMonotoneToneCurveAdapter,
    "hyper_gated": HyperGatedResidualAdapter,
    "hyper_gated_fft": HyperGatedResidualAdapterFFT,
}


def build_memory_adapter(variant: str, in_channels: int = 1,
                         hidden_channels: int = 16) -> nn.Module:
    """v1..v5 by name; 'hyper_gated_fft' (v5) is the reference's active pick."""
    if variant not in MEMORY_ADAPTERS:
        raise ValueError(f"unknown adapter variant {variant!r} "
                         f"(choose from {sorted(MEMORY_ADAPTERS)})")
    if variant == "tone_curve":
        return GlobalMonotoneToneCurveAdapter(in_channels, hidden_dim=hidden_channels)
    return MEMORY_ADAPTERS[variant](in_channels, hidden_channels)
