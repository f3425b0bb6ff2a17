from .iqsl import estimate_intensity_thresholds, iqsl_loss
from .n2n import n2n_regularized_loss
from .pixel import gradient_loss, l1_loss, l1fft_loss, l2_loss, structure_loss

__all__ = ["estimate_intensity_thresholds", "gradient_loss", "iqsl_loss", "l1_loss",
           "l1fft_loss", "l2_loss", "n2n_regularized_loss", "structure_loss"]
