"""Checkpoint saving and loading (counterpart of ``image_denoising_tpu/ckpt/io.py``).

The port reads and writes reference-layout ``.pth`` state dicts (the module
names of ``arch_unet.py``), such as the JAX package's
``ckpt/pth_export.py::export_pth`` writes and its ``load_checkpoint(path,
arch=...)`` reads. The JAX ``.ckpt`` msgpack format is neither read nor
written yet (ROADMAP.md).

``save_train_state`` / ``restore_train_state`` keep a whole train state
(parameters, Adam moments and step counts, the ``step`` and ``skipped``
counters) in the port's own ``torch.save`` file, so a resumed run takes
the same next step as one that was never stopped.
"""
from __future__ import annotations

import os
from typing import Dict

import torch

__all__ = ["checkpoint_path", "load_checkpoint", "restore_train_state",
           "save_checkpoint", "save_train_state"]


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


def save_train_state(state, save_root: str, epoch: int) -> str:
    """Write ``state`` as ``train_state_{epoch:03d}.pt``; returns the path."""
    os.makedirs(save_root, exist_ok=True)
    path = os.path.join(save_root, f"train_state_{epoch:03d}.pt")
    torch.save({"model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "step": state.step, "skipped": state.skipped}, path)
    print(f"Full train state saved to {path}")
    return path


def restore_train_state(state, path: str):
    """Load a ``save_train_state`` file into ``state`` (built by
    ``create_train_state`` for the same model) in place; returns it. Each
    tensor lands on the device of the one it replaces, and the optimizer
    keeps its own ``capturable`` setting, so a state saved on the card
    resumes on the CPU and back."""
    saved = torch.load(path, map_location="cpu", weights_only=True)
    state.model.load_state_dict(saved["model"], strict=True)
    opt = saved["optimizer"]
    for group, cur in zip(opt["param_groups"], state.optimizer.param_groups):
        group["capturable"] = cur["capturable"]
    state.optimizer.load_state_dict(opt)
    state.step.copy_(saved["step"])
    state.skipped.copy_(saved["skipped"])
    return state
