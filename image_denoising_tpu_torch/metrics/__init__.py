from .device import frame_iq_iou, frame_psnr_ssim, make_device_metrics
from .iq_iou import compute_iq_iou, quantize_3class, to_gray_float01
from .psnr import calculate_psnr
from .ssim import calculate_ssim, ssim, ssim_torch

__all__ = [
    "calculate_psnr",
    "calculate_ssim",
    "compute_iq_iou",
    "frame_iq_iou",
    "frame_psnr_ssim",
    "make_device_metrics",
    "quantize_3class",
    "ssim",
    "ssim_torch",
    "to_gray_float01",
]
