"""ImprovedUNet as NCHW ``nn.Module``s (counterpart of ``image_denoising_tpu/models/improved_unet.py``).

Depth-4 UNet with a sigmoid noise-estimator map, per-level
Conv→LReLU→RDB→ResBlock stacks with channel doubling 48→384, an
RDB+ResBlock bottleneck, PixelShuffle UpBlocks and a sigmoid output head
(reference ``arch_unet.py:422-531``). Every layer keeps torch's default
init, as the reference does. The module tree is named after the reference,
so a state dict from ``ckpt/pth_export.py::params_to_state_dict`` loads with
``strict=True``: ``noise_estimator.{0,2}``, ``downs.{i}.{0,2,3}``,
``bottle.{0,1}``, ``ups.{i}.{conv_ps,fuse,rdb,res}``, ``final``.

``dtype`` (compute dtype) and ``remat`` / ``remat_depth`` follow the flax
module's semantics and change no parameter or key: parameters stay
float32, each conv casts its input and weight to the compute dtype (so
gradients reach the float32 parameters through the cast), GroupNorm takes
its statistics in float32 and returns the compute dtype, and concatenating
the float32 input with bfloat16 maps promotes to float32, as
``jnp.concatenate`` does. ``torch.autocast`` is not used: its per-op lists
differ from flax's (GroupNorm's and sigmoid's output dtypes).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .layers import (LEAKY_SLOPE, Conv2d, gn_groups, leaky_relu, max_pool_2x2,
                     pixel_shuffle)

__all__ = ["Conv2d", "GroupNorm", "ResBlock", "RDB", "UpBlock", "ImprovedUNet"]


class GroupNorm(nn.GroupNorm):
    """GroupNorm with the reference group-count fallback (eps 1e-5); with a
    ``compute_dtype``, statistics and affine in float32, output in it."""

    compute_dtype: Optional[torch.dtype] = None

    def __init__(self, channels: int, groups: int = 32):
        super().__init__(gn_groups(channels, groups), channels, eps=1e-5)

    def forward(self, x):
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        return F.group_norm(x.float(), self.num_groups, self.weight, self.bias,
                            self.eps).to(dt)


class ResBlock(nn.Module):
    """conv0 → GN → LReLU → conv1 → GN, plus the input (keys block.{0,1,3,4})."""

    def __init__(self, channels: int):
        super().__init__()
        self.block = nn.Sequential(
            Conv2d(channels, channels, bias=False),
            GroupNorm(channels),
            nn.LeakyReLU(LEAKY_SLOPE),
            Conv2d(channels, channels, bias=False),
            GroupNorm(channels),
        )

    def forward(self, x):
        return x + self.block(x)


class RDB(nn.Module):
    """Residual dense block: ``layers`` growth convs with dense concat + 1×1 LFF."""

    def __init__(self, channels: int, growth: int = 32, layers: int = 4):
        super().__init__()
        self.convs = nn.ModuleList(
            Conv2d(channels + i * growth, growth) for i in range(layers)
        )
        self.lff = Conv2d(channels + layers * growth, channels, 1)

    def forward(self, x):
        feats = [x]
        for conv in self.convs:
            feats.append(leaky_relu(conv(torch.cat(feats, 1))))
        return x + self.lff(torch.cat(feats, 1))


class UpBlock(nn.Module):
    """conv→PixelShuffle(2) upsample, skip concat, fuse conv, RDB, ResBlock."""

    def __init__(self, in_ch: int, skip_ch: int, out_ch: int):
        super().__init__()
        self.conv_ps = Conv2d(in_ch, out_ch * 4)
        self.fuse = Conv2d(out_ch + skip_ch, out_ch)
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

    ``dtype``: compute dtype (None: float32); setting the attribute later
    switches every conv and GroupNorm. ``remat``: recompute blocks during
    backward (``torch.utils.checkpoint``, non-reentrant) instead of keeping
    their activations. At resolution level L (H/2^L) the RDB and ResBlock
    of ``downs[L]`` are recomputed, ``ups[i]`` as a whole at level
    depth−1−i, and the bottleneck's at level ``depth``, when ``remat`` and
    (``remat_depth`` is None or L < ``remat_depth``). The down levels' lead
    conv is never recomputed. Both are read at forward time.
    """

    def __init__(self, in_nc: int = 3, out_nc: int = 3, n_feature: int = 48,
                 depth: int = 4, noise: bool = True,
                 dtype: Optional[torch.dtype] = None, remat: bool = False,
                 remat_depth: Optional[int] = None):
        super().__init__()
        self.in_nc, self.out_nc = in_nc, out_nc
        self.n_feature, self.depth, self.noise = n_feature, depth, noise
        self.remat, self.remat_depth = remat, remat_depth
        if noise:
            self.noise_estimator = nn.Sequential(
                Conv2d(in_nc, n_feature), nn.LeakyReLU(LEAKY_SLOPE),
                Conv2d(n_feature, 1), nn.Sigmoid(),
            )
        cin = in_nc + (1 if noise else 0)
        widths = [n_feature * 2 ** i for i in range(depth)]
        self.downs = nn.ModuleList()
        for nf in widths:
            self.downs.append(nn.Sequential(
                Conv2d(cin, nf), nn.LeakyReLU(LEAKY_SLOPE), RDB(nf), ResBlock(nf),
            ))
            cin = nf
        self.bottle = nn.Sequential(RDB(cin), ResBlock(cin))
        self.ups = nn.ModuleList()
        for skip in reversed(widths):
            self.ups.append(UpBlock(cin, skip, cin // 2))
            cin //= 2
        self.final = Conv2d(cin + in_nc, out_nc)
        self.dtype = dtype

    @property
    def dtype(self) -> Optional[torch.dtype]:
        return self._dtype

    @dtype.setter
    def dtype(self, dt: Optional[torch.dtype]) -> None:
        self._dtype = dt
        for m in self.modules():
            if isinstance(m, (Conv2d, GroupNorm)):
                m.compute_dtype = dt

    def _block(self, block: nn.Module, level: int, *args):
        """``block(*args)`` at resolution ``level``, recomputed in backward
        when ``remat`` reaches that level."""
        if (self.remat and (self.remat_depth is None or level < self.remat_depth)
                and torch.is_grad_enabled()):
            return checkpoint(block, *args, use_reentrant=False)
        return block(*args)

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
        for level, (lead, act, rdb, res) in enumerate(self.downs):
            x = act(lead(x))
            x = self._block(res, level, self._block(rdb, level, x))
            skips.append(x)
            x = max_pool_2x2(x)
        rdb, res = self.bottle
        x = self._block(res, self.depth, self._block(rdb, self.depth, x))
        for i, (up, skip) in enumerate(zip(self.ups, reversed(skips))):
            x = self._block(up, self.depth - 1 - i, x, skip)
        return torch.sigmoid(self.final(torch.cat([x, orig], 1)))
