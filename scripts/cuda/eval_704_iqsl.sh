#!/bin/bash
# CUDA twin of scripts/eval_704_iqsl.sh: the same preset and flags through the PyTorch
# port's CLI (image_denoising_tpu_torch) on the GPU.
# Tiled-352 + IQ-IoU evaluation preset (reference eval_704_iqsl.sh parity)
DATA_DIR="./dataset/m1"
CHECKPOINT="results/UNetImproved/<run>/epoch_model_100.ckpt"
SAVE_DIR="./eval_improvedunet_test_704_iqsl"
N_CHANNEL=1
N_FEATURE=48

python3 -m image_denoising_tpu_torch.cli.evaluation_704_iqsl \
    --data_dir $DATA_DIR \
    --checkpoint $CHECKPOINT \
    --save_dir $SAVE_DIR \
    --n_channel $N_CHANNEL \
    --n_feature $N_FEATURE \
    --compute_iq_iou \
    --iq_low_q 0.25 \
    --iq_high_q 0.75
