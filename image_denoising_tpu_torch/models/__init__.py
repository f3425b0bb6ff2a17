from .fused_forward import improved_unet_fused_apply, make_fused_forward
from .improved_unet import RDB, GroupNorm, ImprovedUNet, ResBlock, UpBlock
from .registry import build_model, build_model_from_log_name

__all__ = [
    "GroupNorm",
    "ImprovedUNet",
    "RDB",
    "ResBlock",
    "UpBlock",
    "build_model",
    "build_model_from_log_name",
    "improved_unet_fused_apply",
    "make_fused_forward",
]
