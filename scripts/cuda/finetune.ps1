$ErrorActionPreference = "Stop"
# CUDA twin of scripts/finetune.ps1: the same preset and flags through the PyTorch
# port's CLI (image_denoising_tpu_torch) on the GPU.
# Adapter finetune preset (reference finetune.sh parity)
$BASE_CKPT = "results/UNetImproved/<run>/epoch_model_100.ckpt"
$DATA_B = "data"

python3 -m image_denoising_tpu_torch.cli.finetune `
  --data_dir $DATA_B `
  --pretrained_ckpt $BASE_CKPT `
  --arch UNetImproved `
  --log_name UNetImproved_adapter_ft `
  --save_model_path results_ft `
  --n_channel 1 `
  --n_feature 48 `
  --batchsize 4 `
  --n_epoch 20 `
  --lr 1e-4 `
  --adapter_hidden 16 `
  --lambda_grad 0.1 `
  --patch_size 128 `
  --patches_per_image 16 `
  --save_every 5
