"""Residual output adapter for the frozen-base path (counterpart of
``image_denoising_tpu/adapters/output_adapter.py``, reference
``adapter.py:5-26``): a 2-conv CNN over concat[noisy, base_out]
(2C → hidden → C, ReLU between, torch default init), NCHW; returns
``base_out + delta``. Keys ``net.{0,2}``, as ``pth_export`` writes them.
"""
from __future__ import annotations

import torch
from torch import nn

__all__ = ["OutputAdapter"]


class OutputAdapter(nn.Module):
    def __init__(self, in_channels: int = 1, hidden_channels: int = 16):
        super().__init__()
        self.net = nn.Sequential(
            nn.Conv2d(2 * in_channels, hidden_channels, 3, padding=1), nn.ReLU(),
            nn.Conv2d(hidden_channels, in_channels, 3, padding=1))

    def forward(self, noisy, base_out):
        return base_out + self.net(torch.cat([noisy, base_out], 1))
