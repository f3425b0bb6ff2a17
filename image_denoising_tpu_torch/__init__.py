"""image_denoising_tpu_torch — the SEM denoiser on PyTorch and CUDA (NVIDIA Hopper).

A port of ``image_denoising_tpu`` (JAX/Pallas on a TPU), which stays the
reference. Plain tensor code is PyTorch; each Pallas kernel becomes a CUDA
kernel written for ``sm_90a``, built by ``nvcc`` at first use into
``build/kernels/``. This package imports no JAX and nothing of
``image_denoising_tpu``.
"""

__version__ = "0.1.0"
