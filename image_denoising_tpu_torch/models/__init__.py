from .fused_forward import improved_unet_fused_apply, make_fused_forward
from .improved_unet import RDB, GroupNorm, ImprovedUNet, ResBlock, UpBlock

__all__ = [
    "GroupNorm",
    "ImprovedUNet",
    "RDB",
    "ResBlock",
    "UpBlock",
    "improved_unet_fused_apply",
    "make_fused_forward",
]
