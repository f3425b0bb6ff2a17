#!/bin/bash
# CUDA twin of scripts/train_opt.sh: the same preset and flags through the PyTorch
# port's CLI (image_denoising_tpu_torch) on the GPU.
# HPO preset (reference train_opt.py defaults: 4 trials, tune 1 epoch each)
python3 -m image_denoising_tpu_torch.cli.train_opt \
  --data_dir data \
  --log_name UNetImproved \
  --n_trials 4 \
  --tune_epochs 1 \
  --n_epoch 20 \
  --batchsize 4
