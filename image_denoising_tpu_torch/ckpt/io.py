"""Checkpoint saving and loading (counterpart of ``image_denoising_tpu/ckpt/io.py``).

The port reads and writes reference-layout ``.pth`` state dicts (the module
names of ``arch_unet.py``), such as the JAX package's
``ckpt/pth_export.py::export_pth`` writes and its ``load_checkpoint(path,
arch=...)`` reads. The JAX ``.ckpt`` msgpack format is neither read nor
written yet (ROADMAP.md).
"""
from __future__ import annotations

import os
from typing import Dict

import torch

__all__ = ["checkpoint_path", "load_checkpoint", "save_checkpoint"]


def checkpoint_path(save_root: str, role: str, epoch: int) -> str:
    return os.path.join(save_root, f"epoch_{role}_{epoch:03d}.pth")


def save_checkpoint(model: torch.nn.Module, save_root: str, role: str,
                    epoch: int) -> str:
    """Write ``model``'s state dict (on the CPU) as
    ``epoch_{role}_{epoch:03d}.pth``; returns the path."""
    os.makedirs(save_root, exist_ok=True)
    path = checkpoint_path(save_root, role, epoch)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save(state, path)
    print(f"Checkpoint saved to {path}")
    return path


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
