#!/bin/bash
set -e
# CUDA twin of scripts/finetune_memory.sh: the same preset and flags through the PyTorch
# port's CLI (image_denoising_tpu_torch) on the GPU.
# Memory-adapter (v5) finetune preset (reference finetune_memory.sh parity)
B_DOMAIN_DATA="./data/syn"
PRETRAINED_CKPT="results/UNetImproved/<run>/epoch_model_001.ckpt"
SAVE_ROOT="./results_ft_syn_memory_v5"
LOG_NAME="UNetImproved_memory_adapter_IQSL_v5"

ARCH="UNetImproved"
N_FEATURE=48
N_CHANNEL=1
LR=1e-4
N_EPOCH=50
BATCH_SIZE=4
PATCH_SIZE=128
PATCHES_PER_IMAGE=16
ADAPTER_HIDDEN=16
LAMBDA_GRAD=0.1
NUM_MEMORY_IMAGES=5
MEMORY_STRIDE=4
LAMBDA_IQSL=0.1
IQSL_Q1=0.2
IQSL_Q2=0.8
IQSL_TAU=0.1
IQSL_MARGIN=0.0
IQSL_MAX_IMAGES=50
IQSL_CE_FACTOR=0.5

python3 -m image_denoising_tpu_torch.cli.finetune_memory \
  --data_dir "${B_DOMAIN_DATA}" \
  --pretrained_ckpt "${PRETRAINED_CKPT}" \
  --arch "${ARCH}" \
  --save_model_path "${SAVE_ROOT}" \
  --log_name "${LOG_NAME}" \
  --n_feature ${N_FEATURE} \
  --n_channel ${N_CHANNEL} \
  --lr ${LR} \
  --n_epoch ${N_EPOCH} \
  --batchsize ${BATCH_SIZE} \
  --adapter_hidden ${ADAPTER_HIDDEN} \
  --lambda_grad ${LAMBDA_GRAD} \
  --save_every 1 \
  --patch_size ${PATCH_SIZE} \
  --patches_per_image ${PATCHES_PER_IMAGE} \
  --num_memory_images ${NUM_MEMORY_IMAGES} \
  --memory_stride ${MEMORY_STRIDE} \
  --lambda_iqsl ${LAMBDA_IQSL} \
  --iqsl_q1 ${IQSL_Q1} \
  --iqsl_q2 ${IQSL_Q2} \
  --iqsl_tau ${IQSL_TAU} \
  --iqsl_margin ${IQSL_MARGIN} \
  --iqsl_max_images ${IQSL_MAX_IMAGES} \
  --iqsl_ce_factor ${IQSL_CE_FACTOR}
