"""Reference-layout state dicts → JAX param trees.

Counterpart of ``image_denoising_tpu/ckpt/pth_import.py`` (``load_state_dict``,
``import_pth``) for
every network (UNet, RESNET, ImprovedUNet), the output adapter and the
five memory-adapter variants, and the exact inverse of
``pth_export.py::params_to_state_dict``: OIHW conv weights become flax
HWIO kernels, deconv weights are copied as they are, Linear weights are
transposed into Dense kernels, GroupNorm weight/bias become ``gn``
scale/bias. A RESNET state dict keeps the ``up5`` of the reference's
unused ``UpsampleCat`` in the tree, as JAX's ``import_pth`` does. A
transpose moves bytes and rounds nothing, so state dict → tree → state
dict gives the same arrays bit for bit. A conv carries ``bias`` exactly
when the state dict has one (the ResBlock convs have none).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np

from ..adapters.memory_adapters import MEMORY_ADAPTERS

__all__ = ["import_pth", "load_state_dict", "read_pth", "state_dict_to_params"]


def read_pth(path: str) -> Dict[str, Any]:
    """A ``.pth`` state dict on the CPU, as torch tensors, with
    ``nn.DataParallel``'s ``module.`` prefix stripped (``finetune.py:207-218``)
    and BasicSR's ``{"params": state_dict}`` wrapper (Restormer's released
    weights) taken off."""
    import torch

    state = torch.load(path, map_location="cpu", weights_only=True)
    if set(state) == {"params"} and isinstance(state["params"], dict):
        state = state["params"]
    if any(k.startswith("module.") for k in state):
        state = {k.replace("module.", "", 1): v for k, v in state.items()}
    return state


def load_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A ``.pth`` file as numpy arrays, ``module.`` stripped."""
    return {k: _np(v) for k, v in read_pth(path).items()}


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _conv(sd, prefix) -> Dict[str, Any]:
    out = {"kernel": np.ascontiguousarray(np.transpose(_np(sd[f"{prefix}.weight"]),
                                                       (2, 3, 1, 0)))}
    if f"{prefix}.bias" in sd:
        out["bias"] = _np(sd[f"{prefix}.bias"])
    return {"conv": out}


def _deconv(sd, prefix) -> Dict[str, Any]:
    return {"deconv": {"kernel": _np(sd[f"{prefix}.weight"]),
                       "bias": _np(sd[f"{prefix}.bias"])}}


def _gn(sd, prefix) -> Dict[str, Any]:
    return {"gn": {"scale": _np(sd[f"{prefix}.weight"]), "bias": _np(sd[f"{prefix}.bias"])}}


def _dense(sd, prefix) -> Dict[str, Any]:
    return {"kernel": np.ascontiguousarray(np.transpose(_np(sd[f"{prefix}.weight"]))),
            "bias": _np(sd[f"{prefix}.bias"])}


def _rdb(sd, prefix, layers=4) -> Dict[str, Any]:
    p = {f"conv{i}": _conv(sd, f"{prefix}.convs.{i}") for i in range(layers)}
    p["lff"] = _conv(sd, f"{prefix}.lff")
    return p


def _resblock(sd, prefix) -> Dict[str, Any]:
    return {"conv0": _conv(sd, f"{prefix}.block.0"), "norm0": _gn(sd, f"{prefix}.block.1"),
            "conv1": _conv(sd, f"{prefix}.block.3"), "norm1": _gn(sd, f"{prefix}.block.4")}


UNET_LIKE_CONVS = tuple(f"enc_conv{i}" for i in range(7)) + (
    "dec_conv5a", "dec_conv5b", "dec_conv4a", "dec_conv4b", "dec_conv3a", "dec_conv3b",
    "dec_conv2a", "dec_conv2b", "dec_conv1a", "dec_conv1b", "nin_a", "nin_b", "nin_c")


def _unet_like(sd) -> Dict[str, Any]:
    """UNet and RESNET (one naming in the reference); ``up*`` where present."""
    p: Dict[str, Any] = {name: _conv(sd, name) for name in UNET_LIKE_CONVS}
    for name in ("up5", "up4", "up3", "up2", "up1"):
        if f"{name}.deconv.weight" in sd:
            p[name] = _deconv(sd, f"{name}.deconv")
    return p


def _improved_unet(sd, depth=4, noise=None) -> Dict[str, Any]:
    p: Dict[str, Any] = {}
    if noise is None:
        noise = "noise_estimator.0.weight" in sd
    if noise:
        p["noise_est_conv0"] = _conv(sd, "noise_estimator.0")
        p["noise_est_conv1"] = _conv(sd, "noise_estimator.2")
    for i in range(depth):
        p[f"down{i}_conv"] = _conv(sd, f"downs.{i}.0")
        p[f"down{i}_rdb"] = _rdb(sd, f"downs.{i}.2")
        p[f"down{i}_res"] = _resblock(sd, f"downs.{i}.3")
    p["bottle_rdb"] = _rdb(sd, "bottle.0")
    p["bottle_res"] = _resblock(sd, "bottle.1")
    for i in range(depth):
        pre = f"ups.{i}"
        p[f"up{i}"] = {"conv_ps": _conv(sd, f"{pre}.conv_ps"), "fuse": _conv(sd, f"{pre}.fuse"),
                       "rdb": _rdb(sd, f"{pre}.rdb"), "res": _resblock(sd, f"{pre}.res")}
    p["final"] = _conv(sd, "final")
    return p


def _seq_convs(sd, prefix) -> Dict[str, Any]:
    return {name: _conv(sd, f"{prefix}.{idx}")
            for name, idx in (("conv0", 0), ("conv1", 2), ("conv2", 4))}


def _memory_adapter(sd, variant: str) -> Dict[str, Any]:
    """Flax module names of ``image_denoising_tpu/adapters/memory_adapters.py``."""
    if variant == "memory_residual":
        return {"body": _seq_convs(sd, "body")}
    if variant == "lowfreq_blend":
        # gate_conv1 is a bare flax nn.Conv (no wrapper submodule)
        return {"gate_conv0": _conv(sd, "gate_net.0"),
                "gate_conv1": _conv(sd, "gate_net.2")["conv"]}
    if variant == "tone_curve":
        return {"mlp0": _dense(sd, "mlp.0"), "mlp1": _dense(sd, "mlp.2")}
    return {"local": _seq_convs(sd, "local_net"),
            "hyper": {"hyper0": _dense(sd, "hyper_mlp.0"),
                      "hyper1": _dense(sd, "hyper_mlp.2")}}


def state_dict_to_params(sd, arch: str = "UNetImproved", depth: int = 4,
                         noise=None) -> Dict[str, Any]:
    """Reference state dict (torch tensors or numpy arrays) → JAX param
    tree of numpy arrays. ``arch``: 'UNet', 'RESNET', 'UNetImproved',
    'output_adapter' or a memory-adapter variant. For 'UNetImproved',
    ``depth`` is its number of levels and ``noise`` whether it has the
    noise estimator (None: whether the state dict holds it)."""
    if arch in ("UNet", "RESNET"):
        return _unet_like(sd)
    if arch == "UNetImproved":
        return _improved_unet(sd, depth, noise)
    if arch == "output_adapter":
        return {"conv0": _conv(sd, "net.0"), "conv1": _conv(sd, "net.2")}
    if arch in MEMORY_ADAPTERS:
        return _memory_adapter(sd, arch)
    raise ValueError(f"unknown arch {arch!r}: UNet, RESNET, UNetImproved, "
                     f"output_adapter or one of {list(MEMORY_ADAPTERS)}")


def import_pth(path_or_sd, arch: str, prefix: str = "", **kwargs) -> Dict[str, Any]:
    """A reference checkpoint (a ``.pth`` path or a state dict) → JAX param
    tree, as the JAX package's ``import_pth``. ``prefix`` pulls a submodule
    out of a wrapper checkpoint (``"base"`` / ``"adapter"``); ``kwargs``
    (``depth=``, ``noise=``) go to ``state_dict_to_params``."""
    sd = path_or_sd if isinstance(path_or_sd, dict) else load_state_dict(path_or_sd)
    if prefix:
        sd = {k[len(prefix) + 1:]: v for k, v in sd.items() if k.startswith(prefix + ".")}
    return state_dict_to_params(sd, arch, **kwargs)
