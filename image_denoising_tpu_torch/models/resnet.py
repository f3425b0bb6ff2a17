"""Pool-free RESNET, NCHW (counterpart of ``image_denoising_tpu/models/resnet.py``).

The reference ``arch_unet.py:263-409``: a full-resolution stack of 3×3
convs with skip concatenations and a global residual, ``out = head(x) +
input``; the init, activation, blind-spot mode and compute ``dtype`` of
``unet.py``. It owns the ``up5`` ``UpsampleCat`` that the reference builds
and never calls (``arch_unet.py:301`` against ``:373``), so reference and
JAX-exported ``.pth`` files load with ``strict=True``; the JAX package's
params tree has no ``up5`` (``ckpt/io.py`` drops it from a ``.ckpt``).
"""
from __future__ import annotations

from typing import Optional

import torch

from .layers import Conv2d
from .unet import BlindSpotNet, UpsampleCat

__all__ = ["RESNET"]


class RESNET(BlindSpotNet):
    """NCHW ``[B, in_nc, H, W]`` → ``[B, out_nc, H, W]``, any H and W."""

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
        self.up5 = UpsampleCat(nf, nf)  # built, never called (see above)
        self.dec_conv5a = conv(nf * 2, nf * 2)
        self.dec_conv5b = conv(nf * 2, nf * 2)
        for lvl in (4, 3, 2):
            setattr(self, f"dec_conv{lvl}a", conv(nf * 3, nf * 2))
            setattr(self, f"dec_conv{lvl}b", conv(nf * 2, nf * 2))
        self.dec_conv1a = conv(nf * 2 + in_nc, 96)
        self.dec_conv1b = conv(96, 96)
        self._build_head()
        self.dtype = dtype

    def forward(self, in_):
        x = self._stack(in_)
        skips = [x]
        x = self._conv("enc_conv1", self._conv("enc_conv0", x))
        for i in range(2, 5):  # pool1 … pool3 are enc_conv1 … enc_conv3's outputs
            skips.append(x)
            x = self._conv(f"enc_conv{i}", x)
        skips.append(x)  # pool4
        x = self._conv("enc_conv6", self._conv("enc_conv5", x))
        for lvl in (5, 4, 3, 2):
            x = torch.cat([x, skips[lvl - 1]], 1)
            x = self._conv(f"dec_conv{lvl}b", self._conv(f"dec_conv{lvl}a", x))
        return self._head(torch.cat([x, skips[0]], 1)) + in_
