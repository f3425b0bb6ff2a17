"""Checkpoint saving and loading (counterpart of ``image_denoising_tpu/ckpt/io.py``).

The port writes the JAX package's ``.ckpt`` files: the msgpack of a flax
params tree (``ckpt/msgpack.py``, byte-equal to flax's
``msgpack_serialize``), with the optional meta dict in a ``.json``
beside it. The four roles are the reference's: ``epoch_model_XXX`` (the
A-domain trainer), ``epoch_final_XXX`` (the HPO retrain),
``epoch_adapter_XXX`` (the ``{"base": …, "adapter": …}`` tree of a
frozen base with its output adapter) and ``epoch_adapter_only_XXX`` (the
adapter's own tree). Trees and state dicts cross through
``pth_import.py::state_dict_to_params`` and
``pth_export.py::params_to_state_dict``, which are exact inverses.

``load_checkpoint`` reads a ``.ckpt`` (with ``arch=``) or a
reference-layout ``.pth`` state dict, such as the JAX package's
``export_pth`` writes, and returns a state dict that loads with
``strict=True``.

``save_train_state`` / ``restore_train_state`` keep a whole train state
(parameters, Adam moments and step counts, the ``step`` and ``skipped``
counters) in the port's own ``torch.save`` file, so a resumed run takes
the same next step as one that was never stopped.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from . import msgpack
from .pth_export import params_to_state_dict
from .pth_import import read_pth, state_dict_to_params

__all__ = ["checkpoint_path", "load_checkpoint", "load_params_tree", "module_arch",
           "restore_train_state", "save_checkpoint", "save_train_state",
           "to_params"]


def checkpoint_path(save_root: str, role: str, epoch: int) -> str:
    return os.path.join(save_root, f"epoch_{role}_{epoch:03d}.ckpt")


def module_arch(module: torch.nn.Module) -> str:
    """The ``arch`` name of a ported module: 'UNet', 'RESNET',
    'UNetImproved', 'output_adapter' or its memory-adapter variant (JAX's
    ``cli/common.py::_arch_name`` for the networks)."""
    from ..adapters.memory_adapters import MEMORY_ADAPTERS
    from ..adapters.output_adapter import OutputAdapter
    from ..models.improved_unet import ImprovedUNet
    from ..models.resnet import RESNET
    from ..models.unet import UNet

    if isinstance(module, ImprovedUNet):
        return "UNetImproved"
    if isinstance(module, RESNET):
        return "RESNET"
    if isinstance(module, UNet):
        return "UNet"
    if isinstance(module, OutputAdapter):
        return "output_adapter"
    for name, cls in MEMORY_ADAPTERS.items():
        if type(module) is cls:
            return name
    raise TypeError(f"no checkpoint layout for {type(module).__name__}")


def to_params(tree: Any) -> Any:
    """A module, or a nested dict of modules and arrays → the JAX params
    tree of numpy arrays (modules through their state dicts). A RESNET's
    tree has no ``up5``: the JAX module has none, and the reference's is
    never called."""
    if isinstance(tree, torch.nn.Module):
        arch = module_arch(tree)
        params = state_dict_to_params(tree.state_dict(), arch)
        if arch == "RESNET":
            params.pop("up5")
        return params
    if isinstance(tree, dict):
        return {k: to_params(v) for k, v in tree.items()}
    return np.asarray(tree)


def save_checkpoint(params_or_module: Any, save_root: str, role: str, epoch: int,
                    meta: Optional[Dict[str, Any]] = None) -> str:
    """Write ``epoch_{role}_{epoch:03d}.ckpt`` (and ``.ckpt.json`` when
    ``meta`` is given), as the JAX package does; returns the path."""
    os.makedirs(save_root, exist_ok=True)
    path = checkpoint_path(save_root, role, epoch)
    payload = msgpack.pack(to_params(params_or_module))
    with open(path, "wb") as f:
        f.write(payload)
    if meta:
        with open(path + ".json", "w") as f:
            json.dump(meta, f, indent=2, default=str)
    print(f"Checkpoint saved to {path}")
    return path


def load_params_tree(path: str) -> Dict[str, Any]:
    """The params tree of a ``.ckpt`` file, as nested dicts of numpy arrays."""
    with open(path, "rb") as f:
        return msgpack.unpack(f.read())


def load_checkpoint(path: str, arch: Optional[str] = None,
                    prefix: str = "") -> Dict[str, torch.Tensor]:
    """A state dict on the CPU that loads into the ``arch`` module with
    ``strict=True``.

    ``.pth``: the reference-layout state dict, any ``module.`` prefix
    stripped. Anything else is a ``.ckpt`` params tree, mapped through
    ``params_to_state_dict(tree, arch)``. ``prefix`` picks a submodule out
    of a wrapper checkpoint: ``"base"`` or ``"adapter"`` of an
    ``epoch_adapter`` file.
    """
    if path.endswith(".pth"):
        state = read_pth(path)
        if prefix:
            state = {k[len(prefix) + 1:]: v for k, v in state.items()
                     if k.startswith(prefix + ".")}
        return state
    if arch is None:
        raise ValueError(f"{path}: loading a .ckpt checkpoint requires arch=")
    tree = load_params_tree(path)
    if prefix:
        tree = tree[prefix]
    elif set(tree) == {"base", "adapter"}:
        raise ValueError(f"{path} holds a base and an adapter: pass "
                         "prefix='base' or prefix='adapter'")
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in params_to_state_dict(tree, arch).items()}


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
