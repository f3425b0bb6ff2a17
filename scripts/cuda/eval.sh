#!/bin/bash
# CUDA twin of scripts/eval.sh: the same preset and flags through the PyTorch
# port's CLI (image_denoising_tpu_torch) on the GPU.
# Whole-image evaluation preset (reference eval.sh parity)
DATA_DIR="./dataset/m1"
CHECKPOINT="results/UNetImproved/<run>/epoch_model_100.ckpt"   # .ckpt or reference .pth
SAVE_DIR="./eval_improvedunet_test"
N_CHANNEL=1
N_FEATURE=48

python3 -m image_denoising_tpu_torch.cli.evaluation \
    --data_dir $DATA_DIR \
    --checkpoint $CHECKPOINT \
    --save_dir $SAVE_DIR \
    --n_channel $N_CHANNEL \
    --n_feature $N_FEATURE \
    --log_name "UNetImproved"
