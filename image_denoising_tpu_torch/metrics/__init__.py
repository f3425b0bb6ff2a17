from .iq_iou import compute_iq_iou, quantize_3class, to_gray_float01
from .psnr import calculate_psnr
from .ssim import calculate_ssim, ssim

__all__ = [
    "calculate_psnr",
    "calculate_ssim",
    "compute_iq_iou",
    "quantize_3class",
    "ssim",
    "to_gray_float01",
]
