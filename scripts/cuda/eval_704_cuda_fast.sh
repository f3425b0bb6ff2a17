#!/bin/bash
# CUDA twin of scripts/eval_704_tpu_fast.sh: tiled-352 evaluation with the
# port's serving preset (PERF.md §4-5): the chain kernel in bf16, bursts of
# 8 frames, chunks of 8 tiles. Add --parallel on a multi-GPU host to split
# each burst's tile stack over the cards.
# Differences from scripts/eval_704_tpu_fast.sh:
#   + --device_metrics   PSNR and SSIM on the card (within 1e-3 dB and 1e-4
#                        of the host path, PERF.md §2), so the host pass
#                        only writes PNGs
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
    --n_feature $N_FEATURE \
    --dtype bfloat16 \
    --frame_burst 8 \
    --tile_batch -8 \
    --device_metrics
