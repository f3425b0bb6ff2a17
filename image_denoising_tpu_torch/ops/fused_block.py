"""The ImprovedUNet level-block conv chain: a CUDA kernel and its plain version.

Counterpart of ``image_denoising_tpu/ops/fused_block_pallas.py``. One level
block is: optional lead 3×3 conv + bias + LeakyReLU(0.2), then a residual
dense block (``n_growth`` dense 3×3 growth convs + bias + LeakyReLU over a
growing feature buffer, a 1×1 local-feature-fusion conv + bias, the residual
add), then an optional ResBlock conv0 (3×3, no bias). SAME zero padding.

Layout is NHWC, as in the JAX package, so the tests compare like with like.
Every conv accumulates in float32 and its output is rounded once to the
working dtype (``x.dtype``: float32 or bfloat16), as the Pallas kernel does.

* ``fused_rdb_chain`` on a CUDA tensor runs ``csrc/fused_block.cu`` (one
  launch per conv of the chain, all writing into one NHWC feature buffer so
  the dense concat never materialises); on a CPU tensor it runs
  ``fused_rdb_chain_reference``. There is no fallback on CUDA: if the kernel
  cannot build or launch, the call raises.
* ``fused_rdb_chain.launches`` counts the chain calls that ran on the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

__all__ = [
    "FusedChainWeights",
    "fused_rdb_chain",
    "fused_rdb_chain_reference",
]

LEAKY_SLOPE = 0.2
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_EPI_BIAS_LEAKY, _EPI_BIAS_RESIDUAL, _EPI_PLAIN = 0, 1, 2


def _hwio(w: torch.Tensor) -> torch.Tensor:
    """torch OIHW conv weight → contiguous HWIO (the kernel's layout)."""
    return w.permute(2, 3, 1, 0).contiguous()


class FusedChainWeights:
    """Weights of one level block in the kernel's layout, in one dtype.

    3×3 kernels are HWIO ``[3, 3, Cin, Cout]``; the LFF kernel is
    ``[C_cat, nf]``; biases are ``[Cout]``. ``lead_w``/``lead_b`` are None
    for the bottleneck, ``res0_w`` is None for a chain without ResBlock conv0.
    """

    def __init__(self, lead_w, lead_b, growth_w, growth_b, lff_w, lff_b,
                 res0_w=None):
        self.lead_w, self.lead_b = lead_w, lead_b
        self.growth_w, self.growth_b = list(growth_w), list(growth_b)
        self.lff_w, self.lff_b = lff_w, lff_b
        self.res0_w = res0_w
        tensors = [t for t in self._tensors() if t is not None]
        dtypes = {t.dtype for t in tensors}
        devices = {t.device for t in tensors}
        if len(dtypes) != 1 or len(devices) != 1:
            raise ValueError(
                f"chain weights must share one dtype and device; got "
                f"{sorted(map(str, dtypes))} on {sorted(map(str, devices))}")

    def _tensors(self):
        return [self.lead_w, self.lead_b, *self.growth_w, *self.growth_b,
                self.lff_w, self.lff_b, self.res0_w]

    @property
    def nf(self) -> int:
        return self.lff_w.shape[1]

    @property
    def dtype(self) -> torch.dtype:
        return self.lff_w.dtype

    @property
    def device(self) -> torch.device:
        return self.lff_w.device

    @classmethod
    def from_state_dict(cls, sd, *, lead: Optional[str], rdb: str,
                        res: Optional[str] = None, n_growth: int = 4,
                        dtype: Optional[torch.dtype] = None,
                        device=None) -> "FusedChainWeights":
        """From reference-layout state-dict keys (``arch_unet.py`` names).

        Examples (ImprovedUNet): encoder level i: lead='downs.{i}.0',
        rdb='downs.{i}.2', res='downs.{i}.3'; bottleneck: lead=None,
        rdb='bottle.0', res='bottle.1'; decoder level i: lead='ups.{i}.fuse',
        rdb='ups.{i}.rdb', res='ups.{i}.res'.
        """
        def t(key):
            v = sd[key]
            v = v.detach() if isinstance(v, torch.Tensor) else torch.tensor(v)
            return v.to(device=device, dtype=dtype or v.dtype)

        lead_w = _hwio(t(f"{lead}.weight")) if lead else None
        lead_b = t(f"{lead}.bias").contiguous() if lead else None
        growth_w = [_hwio(t(f"{rdb}.convs.{i}.weight")) for i in range(n_growth)]
        growth_b = [t(f"{rdb}.convs.{i}.bias").contiguous()
                    for i in range(n_growth)]
        lff_w = t(f"{rdb}.lff.weight")[:, :, 0, 0].t().contiguous()
        lff_b = t(f"{rdb}.lff.bias").contiguous()
        res0_w = _hwio(t(f"{res}.block.0.weight")) if res else None
        return cls(lead_w, lead_b, growth_w, growth_b, lff_w, lff_b, res0_w)

    @classmethod
    def from_modules(cls, rdb, lead=None, res=None, *, dtype=None,
                     device=None) -> "FusedChainWeights":
        """From an ``RDB`` module, its lead ``nn.Conv2d`` and ``ResBlock``."""
        sd = {f"rdb.{k}": v for k, v in rdb.state_dict().items()}
        if lead is not None:
            sd.update({f"lead.{k}": v for k, v in lead.state_dict().items()})
        if res is not None:
            sd.update({f"res.{k}": v for k, v in res.state_dict().items()})
        return cls.from_state_dict(
            sd, lead="lead" if lead is not None else None, rdb="rdb",
            res="res" if res is not None else None, n_growth=len(rdb.convs),
            dtype=dtype, device=device)


def _check(x: torch.Tensor, weights: FusedChainWeights, growth: int,
           n_growth: int) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC [B,H,W,C]; got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"fused_rdb_chain takes float32 or bfloat16; got {x.dtype}")
    if weights.dtype != x.dtype or weights.device != x.device:
        raise ValueError(
            f"weights are {weights.dtype} on {weights.device}, x is "
            f"{x.dtype} on {x.device}")
    if len(weights.growth_w) != n_growth:
        raise ValueError(f"expected {n_growth} growth convs, got "
                         f"{len(weights.growth_w)}")
    # the kernel reads raw pointers: every shape must be the one it assumes
    nf, cin = weights.nf, x.shape[-1]
    want = [("lff_w", weights.lff_w, (nf + n_growth * growth, nf)),
            ("lff_b", weights.lff_b, (nf,))]
    if weights.lead_w is not None:
        want += [("lead_w", weights.lead_w, (3, 3, cin, nf)),
                 ("lead_b", weights.lead_b, (nf,))]
    elif cin != nf:
        raise ValueError(f"x has {cin} channels; a chain without a lead conv "
                         f"takes nf = {nf}")
    if weights.res0_w is not None:
        want.append(("res0_w", weights.res0_w, (3, 3, nf, nf)))
    for i, (w, b) in enumerate(zip(weights.growth_w, weights.growth_b)):
        want += [(f"growth_w[{i}]", w, (3, 3, nf + i * growth, growth)),
                 (f"growth_b[{i}]", b, (growth,))]
    for name, t, shape in want:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape} for x of shape {tuple(x.shape)}")


def _leaky(v):
    return F.leaky_relu(v, LEAKY_SLOPE)


def fused_rdb_chain_reference(x, weights: FusedChainWeights, *,
                              growth: int = 32, n_growth: int = 4):
    """Plain PyTorch version: ``F.conv2d`` per conv, an explicit concat.

    Each conv runs in float32 on float32 copies of its (working-dtype)
    inputs and weights, and its result is cast to the working dtype after
    the epilogue — the casts of ``_chain_kernel``. On a CUDA device the
    caller disables TF32 (``torch.backends.cudnn.allow_tf32``) for an f32
    comparison.
    """
    _check(x, weights, growth, n_growth)
    dt = x.dtype

    def conv(inp, w_hwio, b, pad):
        return F.conv2d(inp.float(), w_hwio.permute(3, 2, 0, 1).float(),
                        None if b is None else b.float(), padding=pad)

    xc = x.permute(0, 3, 1, 2)
    if weights.lead_w is not None:
        h = _leaky(conv(xc, weights.lead_w, weights.lead_b, 1)).to(dt)
    else:
        h = xc
    feats = [h]
    for w, b in zip(weights.growth_w, weights.growth_b):
        feats.append(_leaky(conv(torch.cat(feats, 1), w, b, 1)).to(dt))
    lff_w = weights.lff_w[None, None]  # [1, 1, C_cat, nf] HWIO
    lff = conv(torch.cat(feats, 1), lff_w, weights.lff_b, 0).to(dt)
    rdb = (h.float() + lff.float()).to(dt)
    rdb_out = rdb.permute(0, 2, 3, 1).contiguous()
    if weights.res0_w is None:
        return rdb_out
    c0 = conv(rdb, weights.res0_w, None, 1).to(dt)
    return rdb_out, c0.permute(0, 2, 3, 1).contiguous()


def _launch(lib, code, ks, epi, inp, in_stride, cin, w, bias, res, res_stride,
            out, out_stride, out_off, cout, b, h, wd, stream):
    err = lib.idt_chain_conv(
        code, ks, epi, inp.data_ptr(), in_stride, cin, w.data_ptr(),
        bias.data_ptr() if bias is not None else None,
        res.data_ptr() if res is not None else None, res_stride,
        out.data_ptr(), out_stride, out_off, cout, b, h, wd, stream)
    if err != 0:
        raise RuntimeError(
            f"fused_block conv kernel launch failed: CUDA error {err} "
            f"(ks={ks}, epi={epi}, cin={cin}, cout={cout}, shape={b}x{h}x{wd})")


def _fused_rdb_chain_cuda(x, weights: FusedChainWeights, growth, n_growth):
    from ._build import load_fused_block

    b, h, wd, cin = x.shape
    nf = weights.nf
    width = nf + n_growth * growth
    code = _DTYPE_CODE[x.dtype]
    if not x.is_contiguous() or not all(
            t.is_contiguous() for t in weights._tensors() if t is not None):
        raise ValueError("fused_rdb_chain needs contiguous x and weights")
    lib = load_fused_block()
    stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
    # the growing NHWC feature buffer: conv i reads channels [0, c) and
    # writes [c, c + growth) in place
    feats = torch.empty((b, h, wd, width), dtype=x.dtype, device=x.device)
    rdb_out = torch.empty((b, h, wd, nf), dtype=x.dtype, device=x.device)
    c0 = None
    common = (b, h, wd, stream)
    with torch.cuda.device(x.device):
        if weights.lead_w is not None:
            _launch(lib, code, 3, _EPI_BIAS_LEAKY, x, cin, cin,
                    weights.lead_w, weights.lead_b, None, 0,
                    feats, width, 0, nf, *common)
        else:
            feats[..., :nf].copy_(x)
        c = nf
        for w, bias in zip(weights.growth_w, weights.growth_b):
            _launch(lib, code, 3, _EPI_BIAS_LEAKY, feats, width, c, w, bias,
                    None, 0, feats, width, c, growth, *common)
            c += growth
        _launch(lib, code, 1, _EPI_BIAS_RESIDUAL, feats, width, width,
                weights.lff_w, weights.lff_b, feats, width,
                rdb_out, nf, 0, nf, *common)
        if weights.res0_w is not None:
            c0 = torch.empty_like(rdb_out)
            _launch(lib, code, 3, _EPI_PLAIN, rdb_out, nf, nf, weights.res0_w,
                    None, None, 0, c0, nf, 0, nf, *common)
    fused_rdb_chain.launches += 1
    return rdb_out if c0 is None else (rdb_out, c0)


def fused_rdb_chain(x, weights: FusedChainWeights, *, growth: int = 32,
                    n_growth: int = 4):
    """lead conv → LReLU (optional) → RDB → ResBlock conv0 (optional).

    x: NHWC ``[B, H, W, Cin]`` (Cin = nf without a lead conv), float32 or
    bfloat16, in the dtype and on the device of ``weights``. Returns
    ``rdb_out`` ``[B, H, W, nf]``, or ``(rdb_out, c0)`` when the chain has
    ResBlock conv0. A CPU tensor takes ``fused_rdb_chain_reference``; a CUDA
    tensor runs the kernel or raises.
    """
    _check(x, weights, growth, n_growth)
    if x.device.type == "cpu":
        return fused_rdb_chain_reference(x, weights, growth=growth,
                                         n_growth=n_growth)
    if x.device.type != "cuda":
        raise ValueError(f"fused_rdb_chain runs on CUDA or CPU, not {x.device}")
    return _fused_rdb_chain_cuda(x, weights, growth, n_growth)


fused_rdb_chain.launches = 0
