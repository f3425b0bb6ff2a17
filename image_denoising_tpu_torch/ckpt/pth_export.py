"""Carry JAX-layout weights into the port's modules.

``params_to_state_dict`` maps a JAX param tree (nested dicts of numpy
arrays, as ``jax.tree_util.tree_map(np.asarray, params)`` gives it) to the
reference state-dict layout (``arch_unet.py``, ``adapter.py``,
``finetune_memory.py``): flax HWIO conv kernels become OIHW, Dense kernels
are transposed, GroupNorm scale/bias become weight/bias, and deconv
kernels, already in torch's (in, out, 2, 2) layout, are copied. It is the
port's own copy of ``image_denoising_tpu/ckpt/pth_export.py`` for every
network (UNet, RESNET, ImprovedUNet), the output adapter and the five
memory-adapter variants.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..adapters.memory_adapters import MEMORY_ADAPTERS

__all__ = ["params_to_state_dict", "load_jax_params"]


def _np(x):
    return np.asarray(x)


def _conv_out(out, prefix, p):
    out[f"{prefix}.weight"] = np.transpose(_np(p["conv"]["kernel"]), (3, 2, 0, 1))
    if "bias" in p["conv"]:
        out[f"{prefix}.bias"] = _np(p["conv"]["bias"])


def _deconv_out(out, prefix, p):
    out[f"{prefix}.weight"] = _np(p["deconv"]["kernel"])
    out[f"{prefix}.bias"] = _np(p["deconv"]["bias"])


def _dense_out(out, prefix, p):
    out[f"{prefix}.weight"] = np.transpose(_np(p["kernel"]))
    out[f"{prefix}.bias"] = _np(p["bias"])


def _gn_out(out, prefix, p):
    out[f"{prefix}.weight"] = _np(p["gn"]["scale"])
    out[f"{prefix}.bias"] = _np(p["gn"]["bias"])


def _rdb_out(out, prefix, p, layers=4):
    for i in range(layers):
        _conv_out(out, f"{prefix}.convs.{i}", p[f"conv{i}"])
    _conv_out(out, f"{prefix}.lff", p["lff"])


def _res_out(out, prefix, p):
    _conv_out(out, f"{prefix}.block.0", p["conv0"])
    _gn_out(out, f"{prefix}.block.1", p["norm0"])
    _conv_out(out, f"{prefix}.block.3", p["conv1"])
    _gn_out(out, f"{prefix}.block.4", p["norm1"])


def _up_out(out, prefix, p):
    _conv_out(out, f"{prefix}.conv_ps", p["conv_ps"])
    _conv_out(out, f"{prefix}.fuse", p["fuse"])
    _rdb_out(out, f"{prefix}.rdb", p["rdb"])
    _res_out(out, f"{prefix}.res", p["res"])


def _unet_like_out(params, arch: str = "UNet") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for name, p in params.items():
        if name.startswith("up") and "deconv" in p:
            _deconv_out(out, f"{name}.deconv", p)
        else:
            _conv_out(out, name, p)
    if arch == "RESNET" and "up5.deconv.weight" not in out:
        # the reference RESNET builds an UpsampleCat it never calls
        # (arch_unet.py:301 against forward :373): its keys are made up so
        # that strict loads succeed; the forward never reads them
        nf = out["enc_conv0.weight"].shape[0]
        out["up5.deconv.weight"] = np.zeros((nf, nf, 2, 2), np.float32)
        out["up5.deconv.bias"] = np.zeros((nf,), np.float32)
    return out


def _improved_out(params, depth=4) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if "noise_est_conv0" in params:
        _conv_out(out, "noise_estimator.0", params["noise_est_conv0"])
        _conv_out(out, "noise_estimator.2", params["noise_est_conv1"])
    for i in range(depth):
        _conv_out(out, f"downs.{i}.0", params[f"down{i}_conv"])
        _rdb_out(out, f"downs.{i}.2", params[f"down{i}_rdb"])
        _res_out(out, f"downs.{i}.3", params[f"down{i}_res"])
    _rdb_out(out, "bottle.0", params["bottle_rdb"])
    _res_out(out, "bottle.1", params["bottle_res"])
    for i in range(depth):
        _up_out(out, f"ups.{i}", params[f"up{i}"])
    _conv_out(out, "final", params["final"])
    return out


def _output_adapter_out(params) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    _conv_out(out, "net.0", params["conv0"])
    _conv_out(out, "net.2", params["conv1"])
    return out


def _memory_adapter_out(params, variant) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if variant == "memory_residual":
        for name, idx in (("conv0", 0), ("conv1", 2), ("conv2", 4)):
            _conv_out(out, f"body.{idx}", params["body"][name])
    elif variant == "lowfreq_blend":
        _conv_out(out, "gate_net.0", params["gate_conv0"])
        _conv_out(out, "gate_net.2", {"conv": params["gate_conv1"]})
    elif variant == "tone_curve":
        _dense_out(out, "mlp.0", params["mlp0"])
        _dense_out(out, "mlp.2", params["mlp1"])
    else:  # hyper_gated, hyper_gated_fft
        for name, idx in (("conv0", 0), ("conv1", 2), ("conv2", 4)):
            _conv_out(out, f"local_net.{idx}", params["local"][name])
        _dense_out(out, "hyper_mlp.0", params["hyper"]["hyper0"])
        _dense_out(out, "hyper_mlp.2", params["hyper"]["hyper1"])
    return out


def params_to_state_dict(params: Any, arch: str = "UNetImproved") -> Dict[str, np.ndarray]:
    """JAX param tree → reference state dict of numpy arrays. ``arch``:
    'UNet', 'RESNET', 'UNetImproved', 'output_adapter' or a memory-adapter
    variant."""
    if arch in ("UNet", "RESNET"):
        return _unet_like_out(params, arch)
    if arch == "UNetImproved":
        return _improved_out(params)
    if arch == "output_adapter":
        return _output_adapter_out(params)
    if arch in MEMORY_ADAPTERS:
        return _memory_adapter_out(params, arch)
    raise ValueError(f"unknown arch {arch!r}: UNet, RESNET, UNetImproved, "
                     f"output_adapter or one of {list(MEMORY_ADAPTERS)}")


def load_jax_params(model: torch.nn.Module, params: Any,
                    arch: str = "UNetImproved") -> torch.nn.Module:
    """Load a JAX param tree of ``arch`` into ``model`` with ``strict=True``."""
    sd = {k: torch.from_numpy(np.array(v))
          for k, v in params_to_state_dict(params, arch).items()}
    model.load_state_dict(sd, strict=True)
    return model
