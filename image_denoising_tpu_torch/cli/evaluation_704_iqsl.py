"""Tiled eval + IQ-IoU CLI — counterpart of
``image_denoising_tpu/cli/evaluation_704_iqsl.py`` (E3).

The same engine and flags as ``evaluation_704`` (E2), with the 3-class
intensity-quantized IoU under ``--compute_iq_iou`` (thresholds from the
clean frame's quantiles): a thin wrapper over the shared tiled evaluator.

Run: ``python -m image_denoising_tpu_torch.cli.evaluation_704_iqsl --data_dir
d --checkpoint model.ckpt --compute_iq_iou`` (``--device cpu`` off the card).
"""
from __future__ import annotations

from .evaluation_704 import evaluate, parse_args


def main(argv=None):
    return evaluate(parse_args(argv))


if __name__ == "__main__":
    main()
