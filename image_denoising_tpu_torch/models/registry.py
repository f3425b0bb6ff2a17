"""Architecture registry (counterpart of ``image_denoising_tpu/models/registry.py``).

``build_model(arch=...)`` is the explicit dispatch of the finetune and
eval CLIs (reference ``finetune.py:189-204``); ``build_model_from_log_name``
is the substring dispatch of ``train.py:298-314`` / ``evaluation.py:32-48``,
priority order kept, raising a clear error where the reference leaves the
network undefined. ``UNET`` is the log-name spelling only: as ``--arch`` it
is unknown, as in the JAX package.
"""
from __future__ import annotations

from typing import Optional

import torch

from .improved_unet import ImprovedUNet
from .resnet import RESNET
from .unet import UNet

__all__ = ["ARCHS", "build_model", "build_model_from_log_name"]

ARCHS = ("UNet", "RESNET", "UNetImproved")


def build_model(arch: str, n_channel: int = 1, n_feature: int = 48,
                blindspot: bool = False, dtype: Optional[torch.dtype] = None,
                remat: bool = False, remat_depth: Optional[int] = None) -> torch.nn.Module:
    """``dtype`` is the compute dtype (parameters stay float32);
    ``blindspot`` applies to UNet and RESNET, ``remat`` and ``remat_depth``
    (recompute blocks in backward) to ImprovedUNet, as in the JAX package."""
    if arch == "UNet":
        return UNet(in_nc=n_channel, out_nc=n_channel, n_feature=n_feature,
                    blindspot=blindspot, dtype=dtype)
    if arch == "RESNET":
        return RESNET(in_nc=n_channel, out_nc=n_channel, n_feature=n_feature,
                      blindspot=blindspot, dtype=dtype)
    if arch == "UNetImproved":
        return ImprovedUNet(in_nc=n_channel, out_nc=n_channel, n_feature=n_feature,
                            dtype=dtype, remat=remat, remat_depth=remat_depth)
    raise ValueError(f"Unknown arch: {arch!r} (choose from {ARCHS})")


def build_model_from_log_name(log_name: str, n_channel: int = 1, n_feature: int = 48,
                              dtype: Optional[torch.dtype] = None, remat: bool = False,
                              remat_depth: Optional[int] = None) -> torch.nn.Module:
    """Reference substring dispatch (train.py:298-314), priority order kept."""
    if "UNET" in log_name:
        return build_model("UNet", n_channel, n_feature,
                           blindspot="blindspot" in log_name, dtype=dtype)
    if "RESNET" in log_name:
        return build_model("RESNET", n_channel, n_feature, dtype=dtype)
    if "UNetImproved" in log_name:
        return build_model("UNetImproved", n_channel, n_feature, dtype=dtype,
                           remat=remat, remat_depth=remat_depth)
    raise ValueError(
        f"log_name {log_name!r} matches no architecture "
        "(need one of UNET / RESNET / UNetImproved as a substring)")
