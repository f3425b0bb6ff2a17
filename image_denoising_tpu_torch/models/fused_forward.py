"""The serving forward of every network: ImprovedUNet through the fused
level-block chain, UNet, RESNET and Restormer as their modules.

Counterpart of ``image_denoising_tpu/models/fused_forward.py``.
``improved_unet_fused_apply`` computes what ``ImprovedUNet.forward``
computes, but sends each of the 9 level blocks' lead conv → RDB → ResBlock
conv0 through ``ops/fused_block.py::fused_rdb_chain`` (on CUDA, the
hand-written kernel), and the rest of each ResBlock (GN0 → LeakyReLU → conv1
→ GN1 → + the RDB's output) through ``ops/group_norm.py``'s kernel pair
(on CUDA, ``csrc/group_norm.cu``: statistics and affine in float32, fused
with the LeakyReLU and with the residual add; the plain version on the CPU)
around a cuDNN conv1. The noise estimator, ``conv_ps`` + PixelShuffle,
max-pool and the final conv stay plain PyTorch, as the JAX package leaves
them to XLA.

Activations are NCHW-shaped in ``channels_last`` memory, so the NHWC view
the chain takes costs no copy, and they stay ``channels_last`` through the
ResBlock tail: GroupNorm reads and writes NHWC, and conv1 gets and returns
``channels_last``. On CUDA each tail adds 1 to the ``forward.gn_tail``
counter of ``utils/profiling.py``.

A float32 forward is float32 throughout: the chain kernel runs 3xTF32, and
``make_fused_forward`` runs the plain cuDNN convs with TF32 off whatever
``torch.backends.cudnn.allow_tf32`` (True by default) says.

``make_forward`` is what the CLIs call, the port's ``jitted_apply``
(``image_denoising_tpu/cli/common.py``): ``make_fused_forward`` for an
ImprovedUNet; for UNet and RESNET, whose convs the JAX package also leaves
to XLA's convolutions, and for Restormer, which the JAX package lacks, a
no-grad forward of a frozen copy of the module on the device, in the
compute dtype and ``channels_last``, with TF32 off in float32.
"""
from __future__ import annotations

import contextlib
import copy
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from ..ops.fused_block import FusedChainWeights, fused_rdb_chain
from ..ops.group_norm import gn_apply, gn_stats
from ..utils.device import resolve_device
from ..utils.profiling import count
from .improved_unet import ImprovedUNet
from .layers import gn_groups, leaky_relu, max_pool_2x2, pixel_shuffle

__all__ = ["chain_weights", "improved_unet_fused_apply", "make_forward",
           "make_fused_forward"]

_CL = torch.channels_last


def _conv(x, sd, name: str):
    """SAME 2-D conv from reference state-dict keys ``{name}.weight/.bias``."""
    w = sd[f"{name}.weight"]
    return F.conv2d(x, w, sd.get(f"{name}.bias"), padding=w.shape[-1] // 2)


def _group_norm(x, sd, name: str, **epilogue):
    """GroupNorm of NHWC ``x`` with the reference group-count fallback
    (statistics and affine in float32) and ``gn_apply``'s ``epilogue``."""
    mean, rstd = gn_stats(x, gn_groups(x.shape[-1]))
    return gn_apply(x, mean, rstd, sd[f"{name}.weight"], sd[f"{name}.bias"], **epilogue)


def _res_tail(rdb_out, c0, sd, prefix: str):
    """ResBlock minus conv0 (the chain produced it) on the chain's NHWC
    results: GN0 + LReLU → conv1 → GN1 + rdb_out; NCHW (channels_last) out."""
    if c0.device.type == "cuda":
        count("forward.gn_tail")
    h = _group_norm(c0, sd, f"{prefix}.block.1", act=True)
    h = _conv(h.permute(0, 3, 1, 2), sd, f"{prefix}.block.3").permute(0, 2, 3, 1)
    return _group_norm(h, sd, f"{prefix}.block.4", residual=rdb_out).permute(0, 3, 1, 2)


def _chain(x, wts: FusedChainWeights):
    """NCHW (channels_last) in → the NHWC (rdb_out, c0)."""
    return fused_rdb_chain(x.contiguous(memory_format=_CL).permute(0, 2, 3, 1), wts)


def chain_weights(sd, depth: int = 4) -> List[FusedChainWeights]:
    """The 9 (at depth 4) level blocks' chain weights: downs, bottleneck, ups."""
    out = [FusedChainWeights.from_state_dict(
        sd, lead=f"downs.{i}.0", rdb=f"downs.{i}.2", res=f"downs.{i}.3")
        for i in range(depth)]
    out.append(FusedChainWeights.from_state_dict(
        sd, lead=None, rdb="bottle.0", res="bottle.1"))
    out += [FusedChainWeights.from_state_dict(
        sd, lead=f"ups.{i}.fuse", rdb=f"ups.{i}.rdb", res=f"ups.{i}.res")
        for i in range(depth)]
    return out


def improved_unet_fused_apply(
    sd: Dict[str, torch.Tensor],
    x,
    *,
    chains: List[FusedChainWeights],
    in_nc: int = 1,
    depth: int = 4,
    noise: bool = True,
):
    """sd: the ImprovedUNet reference state dict on x's device, conv weights
    in the working dtype, GroupNorm affine parameters in float32. x: NCHW ``[B, in_nc, H, W]`` in [0, 1]. ``chains``:
    ``chain_weights(sd, depth)``, built once by the caller."""
    div = 2 ** depth
    if x.shape[2] % div or x.shape[3] % div:
        raise ValueError(
            f"ImprovedUNet(depth={depth}) needs H and W divisible by {div}; "
            f"got ({x.shape[2]},{x.shape[3]})")
    x = x.to(sd["final.weight"].dtype).contiguous(memory_format=_CL)
    if noise:
        h = leaky_relu(_conv(x, sd, "noise_estimator.0"))
        sigma = torch.sigmoid(_conv(h, sd, "noise_estimator.2"))
        x = torch.cat([x, sigma], 1)
    orig = x[:, :in_nc]

    skips = []
    for i in range(depth):
        rdb_out, c0 = _chain(x, chains[i])
        x = _res_tail(rdb_out, c0, sd, f"downs.{i}.3")
        skips.append(x)
        x = max_pool_2x2(x)

    rdb_out, c0 = _chain(x, chains[depth])
    x = _res_tail(rdb_out, c0, sd, "bottle.1")

    for i in range(depth):
        x = pixel_shuffle(_conv(x, sd, f"ups.{i}.conv_ps"), 2)
        x = torch.cat([x, skips[-(i + 1)]], 1)
        rdb_out, c0 = _chain(x, chains[depth + 1 + i])
        x = _res_tail(rdb_out, c0, sd, f"ups.{i}.res")

    x = _conv(torch.cat([x, orig], 1), sd, "final")
    return torch.sigmoid(x)


@contextlib.contextmanager
def _cudnn_tf32_off():
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def make_fused_forward(model, device="cuda", dtype: Optional[torch.dtype] = None):
    """``fwd(x)`` with the contract of ``model(x)`` (NCHW in and out) that
    runs the fused forward on ``device`` in ``dtype`` (default: the model's).

    The weights are copied to the device, cast and repacked once here;
    GroupNorm's affine parameters stay float32, as in the JAX package. In
    float32 the plain convs run with cuDNN's TF32 off.
    """
    dev = resolve_device(device)
    dt = dtype or model.final.weight.dtype
    gn = {f"{name}.{p}" for name, m in model.named_modules()
          if isinstance(m, torch.nn.GroupNorm) for p in ("weight", "bias")}
    sd = {k: v.detach().to(device=dev, dtype=torch.float32 if k in gn else dt)
          for k, v in model.state_dict().items()}
    chains = chain_weights(sd, model.depth)
    precise = _cudnn_tf32_off if dt == torch.float32 else contextlib.nullcontext

    @torch.inference_mode()
    def fwd(x):
        with precise():
            return improved_unet_fused_apply(
                sd, x.to(dev), in_nc=model.in_nc, depth=model.depth,
                noise=model.noise, chains=chains)

    return fwd


def make_forward(model, device="cuda", dtype: Optional[torch.dtype] = None,
                 mesh=None):
    """``fwd(x)`` with the contract of ``model(x)`` (NCHW in and out) on
    ``device`` in the compute ``dtype`` (default float32), the forward every
    serving CLI and frozen base runs: ``make_fused_forward`` for an
    ImprovedUNet (the chain kernel), else the module itself.

    With a ``mesh`` (``parallel.make_mesh``) it is a ``parallel.PerDevice``:
    one such forward per distinct device of the mesh (the weights copied
    once to each; a repeated device shares one copy), ``fwd.on(device)``
    that device's forward, and ``fwd(x)`` the batch split over the mesh and
    gathered on its first device; ``device`` is then not used.

    For UNet, RESNET and Restormer the module is copied to the device once,
    in ``channels_last``, its weights cast to ``dtype`` (the convs would cast
    them on every call; the values are the same) and its compute dtype set,
    so the input and every concatenation keep the JAX package's dtypes. The
    parameters whose names end in one of the module's ``FLOAT32_PARAMS``
    (Restormer's LayerNorm weights and temperatures) stay float32, as the
    statistics they scale are. The caller's module is not touched.
    """
    if mesh is not None:
        from ..parallel.mesh import PerDevice

        return PerDevice(mesh, lambda d: make_forward(model, device=d, dtype=dtype))
    if isinstance(model, ImprovedUNet):
        return make_fused_forward(model, device=device, dtype=dtype)
    dev = resolve_device(device)
    dt = dtype or torch.float32
    net = copy.deepcopy(model).eval().requires_grad_(False)
    net.dtype = None if dt == torch.float32 else dt
    net = net.to(device=dev, dtype=dt, memory_format=_CL)
    keep = getattr(model, "FLOAT32_PARAMS", ())
    for name, p in net.named_parameters():
        if name.endswith(keep):  # copied again from the caller's float32 module
            p.data = model.get_parameter(name).detach().to(dev, torch.float32)
    precise = _cudnn_tf32_off if dt == torch.float32 else contextlib.nullcontext

    @torch.inference_mode()
    def fwd(x):
        with precise():
            return net(x.to(dev).contiguous(memory_format=_CL))

    return fwd
