"""Checkpoint loading (counterpart of ``image_denoising_tpu/ckpt/io.py``).

The port reads reference-layout ``.pth`` state dicts, such as the JAX
package's ``ckpt/pth_export.py::export_pth`` writes. The JAX ``.ckpt``
msgpack format is not read yet (ROADMAP.md).
"""
from __future__ import annotations

from typing import Dict

import torch

__all__ = ["load_checkpoint"]


def load_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A ``.pth`` state dict on the CPU, with any ``module.`` prefix stripped."""
    if not path.endswith(".pth"):
        raise NotImplementedError(
            f"{path}: only .pth checkpoints load in the port; the .ckpt "
            "msgpack format is queued in ROADMAP.md")
    state = torch.load(path, map_location="cpu", weights_only=True)
    if any(k.startswith("module.") for k in state):
        state = {k.replace("module.", "", 1): v for k, v in state.items()}
    return state
