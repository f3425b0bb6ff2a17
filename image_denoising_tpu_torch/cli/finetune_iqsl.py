"""Adapter finetune + IQSL CLI — counterpart of
``image_denoising_tpu/cli/finetune_iqsl.py`` (reference ``finetune_iqsl.py``).

The plain adapter finetune (``cli/finetune.py``) with the
Intensity-Quantized Structural Loss: thresholds (t1, t2) estimated once as
global quantiles of the clean set, loss = L1 + λ_grad·gradient +
λ_iqsl·IQSL. Writes the adapter's own tree as
``epoch_adapter_only_XXX.ckpt`` (reference role, finetune_iqsl.py:114-132)
and validates on the first 10 pairs (finetune_iqsl.py:218).

Run: ``python -m image_denoising_tpu_torch.cli.finetune_iqsl --data_dir d
--pretrained_ckpt model.ckpt``.
"""
from __future__ import annotations

from .finetune import parse_args as _parse_args
from .finetune import train_adapter


def parse_args(argv=None):
    return _parse_args(argv, iqsl=True)


def main(argv=None):
    return train_adapter(parse_args(argv), iqsl=True)


if __name__ == "__main__":
    main()
