$ErrorActionPreference = "Stop"
# CUDA twin of scripts/finetune_iqsl.ps1: the same preset and flags through the PyTorch
# port's CLI (image_denoising_tpu_torch) on the GPU.
# Adapter + IQSL finetune preset (reference finetune_iqsl.sh parity)
$B_DOMAIN_DATA = "./data"
$PRETRAINED_CKPT = "results/UNetImproved/<run>/epoch_model_001.ckpt"
$SAVE_ROOT = "./results_ft"
$LOG_NAME = "UNetImproved_adapter_IQSL"

$ARCH = "UNetImproved"
$N_FEATURE = 48
$N_CHANNEL = 1
$LR = 1e-4
$N_EPOCH = 20
$BATCH_SIZE = 4
$PATCH_SIZE = 128
$PATCHES_PER_IMAGE = 16
$ADAPTER_HIDDEN = 16
$LAMBDA_GRAD = 0.1
$LAMBDA_IQSL = 0.1
$IQSL_Q1 = 0.2
$IQSL_Q2 = 0.8
$IQSL_TAU = 0.1
$IQSL_MARGIN = 0.0
$IQSL_MAX_IMAGES = 50
$IQSL_CE_FACTOR = 0.5

python3 -m image_denoising_tpu_torch.cli.finetune_iqsl `
  --data_dir "$B_DOMAIN_DATA" `
  --pretrained_ckpt "$PRETRAINED_CKPT" `
  --arch "$ARCH" `
  --save_model_path "$SAVE_ROOT" `
  --log_name "$LOG_NAME" `
  --n_feature $N_FEATURE `
  --n_channel $N_CHANNEL `
  --lr $LR `
  --n_epoch $N_EPOCH `
  --batchsize $BATCH_SIZE `
  --adapter_hidden $ADAPTER_HIDDEN `
  --lambda_grad $LAMBDA_GRAD `
  --save_every 1 `
  --patch_size $PATCH_SIZE `
  --patches_per_image $PATCHES_PER_IMAGE `
  --lambda_iqsl $LAMBDA_IQSL `
  --iqsl_q1 $IQSL_Q1 `
  --iqsl_q2 $IQSL_Q2 `
  --iqsl_tau $IQSL_TAU `
  --iqsl_margin $IQSL_MARGIN `
  --iqsl_max_images $IQSL_MAX_IMAGES `
  --iqsl_ce_factor $IQSL_CE_FACTOR
