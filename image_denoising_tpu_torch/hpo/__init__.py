"""Hyper-parameter optimization: the TPE engine of the HPO trainer
(``cli/train_opt.py``), counterpart of ``image_denoising_tpu/hpo``."""
from .engine import Study, Trial, create_study

__all__ = ["Study", "Trial", "create_study"]
