#!/bin/bash
# CUDA twin of scripts/eval_704_iqsl_memory_tpu_fast.sh: the memory-adapter
# Hann evaluation (E6) at the full reference memory config (patch 128 /
# overlap 64 / 5 memory pairs / stride 4: a 105,125-patch bank), with the
# port's serving preset (PERF.md §4-5): the base in bf16 through the chain
# kernel, bursts of 4 frames, chunks of 8 tiles, an int8 noise bank and a
# uint8 clean bank searched once per burst by the retrieval kernel.
# Differences from scripts/eval_704_iqsl_memory_tpu_fast.sh:
#   - --pallas_retrieval  on the card the retrieval kernel runs either way;
#                         the flag would only pad the bank to 512 rows
#   + --device_metrics    PSNR and IQ-IoU on the card (PERF.md §2)
DATA_DIR="./dataset/m1"
BASE_CKPT="results/UNetImproved/<run>/epoch_model_100.ckpt"
ADAPTER_CKPT="results_ft/UNetImproved_memory_adapter_ft/epoch_adapter_only_050.ckpt"
SAVE_DIR="./results_704_eval_adapter_memory"

python3 -m image_denoising_tpu_torch.cli.evaluation_704_iqsl_memory \
    --data_dir $DATA_DIR \
    --base_ckpt $BASE_CKPT \
    --adapter_ckpt $ADAPTER_CKPT \
    --save_dir $SAVE_DIR \
    --n_channel 1 \
    --n_feature 48 \
    --adapter_hidden 16 \
    --patch_size 128 \
    --overlap 64 \
    --num_memory_images 5 \
    --memory_stride 4 \
    --compute_iq_iou \
    --dtype bfloat16 \
    --frame_burst 4 \
    --tile_batch -8 \
    --bank_dtype int8 \
    --clean_bank_dtype uint8 \
    --device_metrics
