"""N2N-style UNet with the optional blind-spot mode, NCHW (counterpart of
``image_denoising_tpu/models/unet.py``).

The reference ``arch_unet.py:100-260``: a 5-level encoder of 48-channel 3×3
convs and 2×2 max-pools, a transpose-conv decoder with skip
concatenations, a 96-channel NIN head, LeakyReLU(0.2) everywhere and
Kaiming·0.1 init. With ``blindspot=True`` the four rotations of the input
run as one batch through shifted convs and pools, and the NIN head merges
them on channels (``nin_a`` takes 96·4 and gives 96·4).

The parameters carry the reference's state-dict names (``enc_conv0`` …
``nin_c``, ``up5.deconv`` … ``up1.deconv``), so a reference or
JAX-exported ``.pth`` loads with ``strict=True``. ``dtype`` is the compute
dtype with flax's semantics (parameters stay float32; every conv casts its
input and weights); concatenating the float32 input with lower-precision
maps promotes to float32, as ``jnp.concatenate`` does.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .layers import (Conv2d, Deconv2x2, blindspot_conv, blindspot_output_shift,
                     blindspot_pool, leaky_relu, rotate)

__all__ = ["UNet", "UpsampleCat"]

ROTATIONS = (0, 90, 180, 270)
UNROTATIONS = (0, 270, 180, 90)


class UpsampleCat(nn.Module):
    """2×2 stride-2 deconv, then the skip concatenated on channels
    (arch_unet.py:51-62)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.deconv = Deconv2x2(cin, cout)

    def forward(self, x1, x2):
        return torch.cat([self.deconv(x1), x2], 1)


class BlindSpotNet(nn.Module):
    """What UNet and RESNET share: the 3×3 convs with the blind-spot shift,
    the rotation stack, the NIN head (``nin_a``/``nin_b``/``nin_c``) with
    its 4-way merge, and the compute ``dtype``."""

    def __init__(self, in_nc: int, out_nc: int, n_feature: int, blindspot: bool,
                 zero_last: bool):
        super().__init__()
        self.in_nc, self.out_nc, self.n_feature = in_nc, out_nc, n_feature
        self.blindspot, self.zero_last = blindspot, zero_last

    def _build_head(self) -> None:
        k = 4 if self.blindspot else 1
        self.nin_a = Conv2d(96 * k, 96 * k, 1, init="kaiming01")
        self.nin_b = Conv2d(96 * k, 96, 1, init="kaiming01")
        self.nin_c = Conv2d(96, self.out_nc, 1,
                            init="torch" if self.zero_last else "kaiming01")

    @property
    def dtype(self) -> Optional[torch.dtype]:
        return self._dtype

    @dtype.setter
    def dtype(self, dt: Optional[torch.dtype]) -> None:
        self._dtype = dt
        for m in self.modules():
            if isinstance(m, (Conv2d, Deconv2x2)):
                m.compute_dtype = dt

    def _conv(self, name: str, x):
        """LReLU(conv ``name``), shifted in blind-spot mode."""
        return leaky_relu(blindspot_conv(x, getattr(self, name), 3, self.blindspot))

    def _stack(self, x):
        return torch.cat([rotate(x, a) for a in ROTATIONS], 0) if self.blindspot else x

    def _head(self, x):
        x = self._conv("dec_conv1b", self._conv("dec_conv1a", x))
        if self.blindspot:
            parts = torch.chunk(blindspot_output_shift(x), 4, 0)
            x = torch.cat([rotate(p, a) for p, a in zip(parts, UNROTATIONS)], 1)
        x = leaky_relu(self.nin_b(leaky_relu(self.nin_a(x))))
        return self.nin_c(x)


class UNet(BlindSpotNet):
    """NCHW ``[B, in_nc, H, W]`` → ``[B, out_nc, H, W]``; H and W divisible by 32."""

    def __init__(self, in_nc: int = 3, out_nc: int = 3, n_feature: int = 48,
                 blindspot: bool = False, zero_last: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(in_nc, out_nc, n_feature, blindspot, zero_last)
        nf = n_feature

        def conv(cin, cout):
            return Conv2d(cin, cout, 3, init="kaiming01")

        self.enc_conv0 = conv(in_nc, nf)
        for i in range(1, 7):
            setattr(self, f"enc_conv{i}", conv(nf, nf))
        self.up5 = UpsampleCat(nf, nf)
        self.dec_conv5a = conv(nf * 2, nf * 2)
        self.dec_conv5b = conv(nf * 2, nf * 2)
        for lvl in (4, 3, 2):
            setattr(self, f"up{lvl}", UpsampleCat(nf * 2, nf * 2))
            setattr(self, f"dec_conv{lvl}a", conv(nf * 3, nf * 2))
            setattr(self, f"dec_conv{lvl}b", conv(nf * 2, nf * 2))
        self.up1 = UpsampleCat(nf * 2, nf * 2)
        self.dec_conv1a = conv(nf * 2 + in_nc, 96)
        self.dec_conv1b = conv(96, 96)
        self._build_head()
        self.dtype = dtype

    def forward(self, x):
        h, w = x.shape[2], x.shape[3]
        if h % 32 or w % 32:
            raise ValueError(
                f"UNet needs H and W divisible by 32 (5 pool levels); got "
                f"({h},{w}). The torch reference has the same constraint (its "
                f"decoder concat fails on odd pooled dims). For N2N training "
                f"the 2x2 subsampler halves the frame, so frames must be "
                f"divisible by 64."
            )
        bs = self.blindspot
        x = self._stack(x)
        skips = [x]
        x = self._conv("enc_conv1", self._conv("enc_conv0", x))
        for i in range(2, 6):  # pool1 … pool4
            x = blindspot_pool(x, bs)
            skips.append(x)
            x = self._conv(f"enc_conv{i}", x)
        x = self._conv("enc_conv6", blindspot_pool(x, bs))
        for lvl in (5, 4, 3, 2):
            x = getattr(self, f"up{lvl}")(x, skips[lvl - 1])
            x = self._conv(f"dec_conv{lvl}b", self._conv(f"dec_conv{lvl}a", x))
        return self._head(self.up1(x, skips[0]))
