#!/bin/bash
# CUDA twin of scripts/denoise_tpu.sh: denoise a directory of NEW frames (no
# clean/ ground truth) with the port's serving preset (PERF.md §4-5): the
# tiled-352 pyramid through the chain kernel in bf16, bursts of 8 frames,
# chunks of 8 tiles. Outputs are byte-identical to eval_704.sh's
# *_denoised.png at --dtype float32 --tile_batch -1 --rounding floor.
# Differences from scripts/denoise_tpu.sh:
#   + --host_workers 4   the per-frame host pass (fetch, PNG encode) in 4
#                        threads: the same PNGs as inline (PERF.md §5)
INPUT_DIR="./dataset/m1/noise"
CHECKPOINT="results/UNetImproved/<run>/epoch_model_100.ckpt"
SAVE_DIR="./denoised"
N_CHANNEL=1
N_FEATURE=48

python3 -m image_denoising_tpu_torch.cli.denoise \
    --input_dir $INPUT_DIR \
    --checkpoint $CHECKPOINT \
    --save_dir $SAVE_DIR \
    --n_channel $N_CHANNEL \
    --n_feature $N_FEATURE \
    --dtype bfloat16 \
    --frame_burst 8 \
    --tile_batch -8 \
    --host_workers 4
