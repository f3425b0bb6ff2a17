$ErrorActionPreference = "Stop"
# CUDA twin of scripts/eval_704_iqsl_memory.ps1: the same preset and flags through the PyTorch
# port's CLI (image_denoising_tpu_torch) on the GPU.
# Memory-bounded tiled eval preset (reference eval_704_iqsl_memory.sh parity)
$B_DOMAIN_DATA = "./data/syn"
$BASE_CKPT = "results/UNetImproved/<run>/epoch_model_001.ckpt"
$ADAPTER_CKPT = "./results_ft_syn_memory_v5/UNetImproved_memory_adapter_IQSL_v5/epoch_adapter_only_050.ckpt"
$SAVE_DIR = "./results_704_eval_adapter_memory_v5"

$ARCH = "UNetImproved"
$N_FEATURE = 48
$N_CHANNEL = 1
$ADAPTER_HIDDEN = 16
$PATCH_SIZE = 128
$PATCH_OVERLAP = 64
$NUM_MEMORY_IMAGES = 5
$MEMORY_STRIDE = 4

python3 -m image_denoising_tpu_torch.cli.evaluation_704_iqsl_memory `
  --data_dir "$B_DOMAIN_DATA" `
  --base_ckpt "$BASE_CKPT" `
  --adapter_ckpt "$ADAPTER_CKPT" `
  --arch "$ARCH" `
  --save_dir "$SAVE_DIR" `
  --n_feature $N_FEATURE `
  --n_channel $N_CHANNEL `
  --adapter_hidden $ADAPTER_HIDDEN `
  --patch_size $PATCH_SIZE `
  --overlap $PATCH_OVERLAP `
  --num_memory_images $NUM_MEMORY_IMAGES `
  --memory_stride $MEMORY_STRIDE
  # --compute_iq_iou `
  # --iq_low_q 0.25 `
  # --iq_high_q 0.75
