"""Carry JAX-layout weights into the port's modules.

``params_to_state_dict`` maps a JAX ImprovedUNet param tree (nested dicts of
numpy arrays, as ``jax.tree_util.tree_map(np.asarray, params)`` gives it) to
the reference ``arch_unet.py`` state-dict layout: flax HWIO conv kernels
become OIHW, GroupNorm scale/bias become weight/bias. It is the port's own
copy of ``image_denoising_tpu/ckpt/pth_export.py`` for the ImprovedUNet.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

__all__ = ["params_to_state_dict", "load_jax_params"]


def _np(x):
    return np.asarray(x)


def _conv_out(out, prefix, p):
    out[f"{prefix}.weight"] = np.transpose(_np(p["conv"]["kernel"]), (3, 2, 0, 1))
    if "bias" in p["conv"]:
        out[f"{prefix}.bias"] = _np(p["conv"]["bias"])


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


def params_to_state_dict(params: Any, arch: str = "UNetImproved") -> Dict[str, np.ndarray]:
    """JAX param tree → reference state dict of numpy arrays."""
    if arch != "UNetImproved":
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet (only UNetImproved); see ROADMAP.md")
    return _improved_out(params)


def load_jax_params(model: torch.nn.Module, params: Any) -> torch.nn.Module:
    """Load a JAX ImprovedUNet param tree into ``model`` with ``strict=True``."""
    sd = {k: torch.from_numpy(np.array(v))
          for k, v in params_to_state_dict(params).items()}
    model.load_state_dict(sd, strict=True)
    return model
