#!/bin/bash
# CUDA twin of scripts/eval_704.sh: the same preset and flags through the PyTorch
# port's CLI (image_denoising_tpu_torch) on the GPU.
# Tiled-352 evaluation preset (reference eval_704.sh parity)
DATA_DIR="./dataset/m1"
CHECKPOINT="results/UNetImproved/<run>/epoch_model_100.ckpt"
SAVE_DIR="./eval_improvedunet_test_704"
N_CHANNEL=1
N_FEATURE=48

python3 -m image_denoising_tpu_torch.cli.evaluation_704 \
    --data_dir $DATA_DIR \
    --checkpoint $CHECKPOINT \
    --save_dir $SAVE_DIR \
    --n_channel $N_CHANNEL \
    --n_feature $N_FEATURE
