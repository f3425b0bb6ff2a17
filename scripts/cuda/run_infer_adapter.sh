#!/bin/bash
set -e
# CUDA twin of scripts/run_infer_adapter.sh: the same preset and flags through the PyTorch
# port's CLI (image_denoising_tpu_torch) on the GPU.
# Adapter inference preset (reference run_infer_adapter.sh parity)
ADAPTER_CKPT="results_ft/UNetImproved_adapter_ft/epoch_adapter_020.ckpt"
DATA_B_TEST="data"
SAVE_DIR="results_ft/UNetImproved_adapter_ft/infer_ep020"

python3 -m image_denoising_tpu_torch.cli.evaluation_adapter \
  --data_dir ${DATA_B_TEST} \
  --ckpt ${ADAPTER_CKPT} \
  --arch UNetImproved \
  --n_channel 1 \
  --n_feature 48 \
  --adapter_hidden 16 \
  --save_dir ${SAVE_DIR}
