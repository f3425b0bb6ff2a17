#!/bin/bash
# CUDA twin of scripts/train.sh: the same preset and flags through the PyTorch
# port's CLI (image_denoising_tpu_torch) on the GPU.
# A-domain training preset (reference train.sh parity)
python3 -m image_denoising_tpu_torch.cli.train --log_name UNetImproved
