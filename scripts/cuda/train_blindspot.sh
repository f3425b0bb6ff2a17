#!/bin/bash
# CUDA twin of scripts/train_blindspot.sh: the same preset and flags through the PyTorch
# port's CLI (image_denoising_tpu_torch) on the GPU.
# Blindspot-UNet A-domain training preset: the reference's `blindspot`
# log_name substring dispatch (train.py:298-302) selects the 4-rotation
# shifted-conv UNet. Structure loss, reference defaults otherwise.
python3 -m image_denoising_tpu_torch.cli.train --log_name UNET_blindspot_gauss25 --n_feature 48
