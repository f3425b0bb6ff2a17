from .fused_forward import improved_unet_fused_apply, make_forward, make_fused_forward
from .improved_unet import RDB, GroupNorm, ImprovedUNet, ResBlock, UpBlock
from .registry import build_model, build_model_from_log_name
from .resnet import RESNET
from .unet import UNet, UpsampleCat

__all__ = [
    "GroupNorm",
    "ImprovedUNet",
    "RDB",
    "RESNET",
    "ResBlock",
    "UNet",
    "UpBlock",
    "UpsampleCat",
    "build_model",
    "build_model_from_log_name",
    "improved_unet_fused_apply",
    "make_forward",
    "make_fused_forward",
]
