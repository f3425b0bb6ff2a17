"""ImprovedUNet as NCHW ``nn.Module``s (counterpart of ``image_denoising_tpu/models/improved_unet.py``).

Depth-4 UNet with a sigmoid noise-estimator map, per-level
Conv→LReLU→RDB→ResBlock stacks with channel doubling 48→384, an
RDB+ResBlock bottleneck, PixelShuffle UpBlocks and a sigmoid output head
(reference ``arch_unet.py:422-531``). Every layer keeps torch's default
init, as the reference does. The module tree is named after the reference,
so a state dict from ``ckpt/pth_export.py::params_to_state_dict`` loads with
``strict=True``: ``noise_estimator.{0,2}``, ``downs.{i}.{0,2,3}``,
``bottle.{0,1}``, ``ups.{i}.{conv_ps,fuse,rdb,res}``, ``final``.
"""
from __future__ import annotations

import torch
from torch import nn

from .layers import LEAKY_SLOPE, gn_groups, leaky_relu, max_pool_2x2, pixel_shuffle

__all__ = ["GroupNorm", "ResBlock", "RDB", "UpBlock", "ImprovedUNet"]


def _conv3(cin: int, cout: int, bias: bool = True) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1, bias=bias)


class GroupNorm(nn.GroupNorm):
    """GroupNorm with the reference group-count fallback (eps 1e-5)."""

    def __init__(self, channels: int, groups: int = 32):
        super().__init__(gn_groups(channels, groups), channels, eps=1e-5)


class ResBlock(nn.Module):
    """conv0 → GN → LReLU → conv1 → GN, plus the input (keys block.{0,1,3,4})."""

    def __init__(self, channels: int):
        super().__init__()
        self.block = nn.Sequential(
            _conv3(channels, channels, bias=False),
            GroupNorm(channels),
            nn.LeakyReLU(LEAKY_SLOPE),
            _conv3(channels, channels, bias=False),
            GroupNorm(channels),
        )

    def forward(self, x):
        return x + self.block(x)


class RDB(nn.Module):
    """Residual dense block: ``layers`` growth convs with dense concat + 1×1 LFF."""

    def __init__(self, channels: int, growth: int = 32, layers: int = 4):
        super().__init__()
        self.convs = nn.ModuleList(
            _conv3(channels + i * growth, growth) for i in range(layers)
        )
        self.lff = nn.Conv2d(channels + layers * growth, channels, 1)

    def forward(self, x):
        feats = [x]
        for conv in self.convs:
            feats.append(leaky_relu(conv(torch.cat(feats, 1))))
        return x + self.lff(torch.cat(feats, 1))


class UpBlock(nn.Module):
    """conv→PixelShuffle(2) upsample, skip concat, fuse conv, RDB, ResBlock."""

    def __init__(self, in_ch: int, skip_ch: int, out_ch: int):
        super().__init__()
        self.conv_ps = _conv3(in_ch, out_ch * 4)
        self.fuse = _conv3(out_ch + skip_ch, out_ch)
        self.rdb = RDB(out_ch)
        self.res = ResBlock(out_ch)

    def forward(self, x, skip):
        x = pixel_shuffle(self.conv_ps(x), 2)
        x = leaky_relu(self.fuse(torch.cat([x, skip], 1)))
        return self.res(self.rdb(x))


class ImprovedUNet(nn.Module):
    """NCHW ``[B, in_nc, H, W]`` in [0, 1] → ``[B, out_nc, H, W]`` in (0, 1).

    Widths at n_feature=48: down levels 48, 96, 192, 384; bottleneck 384;
    up blocks 192, 96, 48, 24 with concat inputs 576, 288, 144, 72.
    """

    def __init__(self, in_nc: int = 3, out_nc: int = 3, n_feature: int = 48,
                 depth: int = 4, noise: bool = True):
        super().__init__()
        self.in_nc, self.out_nc = in_nc, out_nc
        self.n_feature, self.depth, self.noise = n_feature, depth, noise
        if noise:
            self.noise_estimator = nn.Sequential(
                _conv3(in_nc, n_feature), nn.LeakyReLU(LEAKY_SLOPE),
                _conv3(n_feature, 1), nn.Sigmoid(),
            )
        cin = in_nc + (1 if noise else 0)
        widths = [n_feature * 2 ** i for i in range(depth)]
        self.downs = nn.ModuleList()
        for nf in widths:
            self.downs.append(nn.Sequential(
                _conv3(cin, nf), nn.LeakyReLU(LEAKY_SLOPE), RDB(nf), ResBlock(nf),
            ))
            cin = nf
        self.bottle = nn.Sequential(RDB(cin), ResBlock(cin))
        self.ups = nn.ModuleList()
        for skip in reversed(widths):
            self.ups.append(UpBlock(cin, skip, cin // 2))
            cin //= 2
        self.final = _conv3(cin + in_nc, out_nc)

    def forward(self, x):
        div = 2 ** self.depth
        h, w = x.shape[2], x.shape[3]
        if h % div or w % div:
            raise ValueError(
                f"ImprovedUNet(depth={self.depth}) needs H and W divisible by "
                f"{div}; got ({h},{w}). The torch reference shares this "
                f"constraint (PixelShuffle doubling vs floored pooling)."
            )
        if self.noise:
            x = torch.cat([x, self.noise_estimator(x)], 1)
        orig = x[:, : self.in_nc]
        skips = []
        for down in self.downs:
            x = down(x)
            skips.append(x)
            x = max_pool_2x2(x)
        x = self.bottle(x)
        for up, skip in zip(self.ups, reversed(skips)):
            x = up(x, skip)
        return torch.sigmoid(self.final(torch.cat([x, orig], 1)))
