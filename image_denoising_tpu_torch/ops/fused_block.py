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
  the dense concat never materialises; an implicit GEMM on the tensor
  cores, bf16 or 3xTF32); on a CPU tensor it runs
  ``fused_rdb_chain_reference``. There is no fallback on CUDA: if the kernel
  cannot build or launch, the call raises.
* ``fused_rdb_chain.launches`` counts the chain calls that ran on the kernel.
* The kernel reads weights repacked once per ``FusedChainWeights``
  (``pack_conv_weight``; float32 also split into TF32 hi + lo by
  ``split_tf32``) and launches by ``conv_plan``: the output-channel tile and,
  where a launch would have fewer than ``MIN_BLOCKS`` blocks, a K split.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

__all__ = [
    "FusedChainWeights",
    "chain_conv_plans",
    "conv_plan",
    "fused_rdb_chain",
    "fused_rdb_chain_reference",
    "pack_conv_weight",
    "split_tf32",
    "unpack_conv_weight",
]

LEAKY_SLOPE = 0.2
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_EPI_BIAS_LEAKY, _EPI_BIAS_RESIDUAL, _EPI_PLAIN = 0, 1, 2
# the kernel's output-channel tile widths (wgmma's N; csrc/fused_block.cu
# compiles these) and the widest per dtype: float32 carries hi and lo
# weights, so its tile is half as wide for the same shared memory
_WIDTHS = (16, 32, 48, 64, 96, 128, 192)
_MAX_WIDTH = {torch.float32: 96, torch.bfloat16: 192}
TILE = 8  # output rows per block; a block's M-tiles of TILE x TILE pixels
# a launch with fewer blocks than this (one per SM of an H100) splits K
MIN_BLOCKS = 132


def _chunk(dtype) -> int:
    """Channels per 16-byte chunk: the kernel's unit of K."""
    return 16 // torch.empty((), dtype=dtype).element_size()


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def conv_plan(batch: int, h: int, w: int, cin: int, cout: int,
              dtype: torch.dtype) -> dict:
    """How the kernel launches one conv: the output-channel tile ``np`` (of
    ``n_tiles``), ``mt`` M-tiles of ``TILE``² pixels side by side per block
    (as csrc/fused_block.cu's ``m_tiles``), K-stages of two chunks, and
    ``splits`` of K across blocks when pixel tiles × channel tiles give
    fewer than ``MIN_BLOCKS``."""
    cap = _MAX_WIDTH[dtype]
    need = _cdiv(cout, _cdiv(cout, cap))
    np_ = next(v for v in _WIDTHS if v >= need)
    mt = 4 if np_ <= 48 else (2 if np_ <= 96 else 1)
    n_tiles = _cdiv(cout, np_)
    k_stages = _cdiv(_cdiv(cin, _chunk(dtype)), 2)
    base = _cdiv(h, TILE) * _cdiv(w, TILE * mt) * batch * n_tiles
    splits = 1
    if base < MIN_BLOCKS:
        per = max(1, k_stages // _cdiv(MIN_BLOCKS, base))
        splits = _cdiv(k_stages, per)
    return dict(np=np_, mt=mt, n_tiles=n_tiles, k_stages=k_stages, splits=splits,
                blocks=base * splits)


def pack_conv_weight(w_hwio: torch.Tensor, np_: int) -> torch.Tensor:
    """HWIO ``[kh, kw, Cin, Cout]`` → the kernel's K-major layout
    ``[n_tiles, chunks, kh·kw, np_, chunk]``: output channels in tiles of
    ``np_``, input channels in 16-byte chunks (an even count), zeros where
    a tile or chunk runs past Cout or Cin."""
    kh, kw, cin, cout = w_hwio.shape
    chunk = _chunk(w_hwio.dtype)
    chunks = 2 * _cdiv(_cdiv(cin, chunk), 2)
    n_tiles = _cdiv(cout, np_)
    w = w_hwio.reshape(kh * kw, cin, cout)
    w = F.pad(w, (0, n_tiles * np_ - cout, 0, chunks * chunk - cin))
    w = w.reshape(kh * kw, chunks, chunk, n_tiles, np_)
    return w.permute(3, 1, 0, 4, 2).contiguous()


def unpack_conv_weight(packed: torch.Tensor, kh: int, kw: int, cin: int,
                       cout: int) -> torch.Tensor:
    """The inverse of ``pack_conv_weight``: back to HWIO."""
    n_tiles, chunks, taps, np_, chunk = packed.shape
    w = packed.permute(2, 1, 4, 0, 3).reshape(taps, chunks * chunk, n_tiles * np_)
    return w[:, :cin, :cout].reshape(kh, kw, cin, cout)


def split_tf32(x: torch.Tensor):
    """float32 ``x`` → (hi, lo) with hi = x rounded to TF32 (10 mantissa
    bits, to nearest, ties away from zero: PTX ``cvt.rna.tf32.f32``) and
    lo = x − hi, exact, so hi + lo == x."""
    bits = x.contiguous().view(torch.int32)
    mag = (bits & 0x7FFFFFFF) + 0x1000
    hi = ((bits & -0x80000000) | (mag & 0x7FFFE000)).view(torch.float32)
    return hi, x - hi


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
        self._packed = None
        self._launch_tables = {}  # (shape, growth, n_growth) -> launches
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

    def convs(self):
        """[(name, HWIO weight, bias or None)] in the order the chain runs."""
        out = [("lead", self.lead_w, self.lead_b)] if self.lead_w is not None else []
        out += [(f"growth{i}", w, b)
                for i, (w, b) in enumerate(zip(self.growth_w, self.growth_b))]
        out.append(("lff", self.lff_w[None, None], self.lff_b))
        if self.res0_w is not None:
            out.append(("res0", self.res0_w, None))
        return out

    def packed(self) -> dict:
        """{conv name: (hi, lo or None, np)}: each conv's weights in the
        kernel's layout (``pack_conv_weight``), float32 split into TF32 hi
        and lo. Computed once and kept on the object."""
        if self._packed is None:
            packed = {}
            for name, w, _ in self.convs():
                np_ = conv_plan(1, 1, 1, w.shape[2], w.shape[3], w.dtype)["np"]
                p = pack_conv_weight(w, np_)
                hi, lo = split_tf32(p) if p.dtype == torch.float32 else (p, None)
                packed[name] = (hi, lo, np_)
            self._packed = packed
        return self._packed

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


def chain_conv_plans(batch: int, h: int, w: int, cin: int, weights,
                     growth: int = 32, n_growth: int = 4):
    """[(conv name, ``conv_plan``)] for each launch of one chain call on
    x ``[batch, h, w, cin]``: what the kernel runs at a shape."""
    chunk = _chunk(weights.dtype)
    nf, width = weights.nf, weights.nf + n_growth * growth
    cins = {"lead": _cdiv(cin, chunk) * chunk, "lff": width, "res0": nf}
    cins.update({f"growth{i}": nf + i * growth for i in range(n_growth)})
    return [(name, conv_plan(batch, h, w, cins[name], wt.shape[3], weights.dtype))
            for name, wt, _ in weights.convs()]


def _launch_table(weights: FusedChainWeights, b, h, wd, cin, growth, n_growth):
    """The chain's launches at one input shape, everything but the
    activation buffers resolved (packed weights, biases, plans): built once
    per shape and kept on ``weights``, so a call costs one ctypes call per
    conv. Rows: (name, ks, epi, input, cin, w_hi, w_lo, bias, residual,
    output, out_off, cout, np, splits); buffers by name."""
    key = (b, h, wd, cin, growth, n_growth)
    table = weights._launch_tables.get(key)
    if table is not None:
        return table
    packed = weights.packed()
    plans = dict(chain_conv_plans(b, h, wd, cin, weights, growth, n_growth))
    nf, width = weights.nf, weights.nf + n_growth * growth

    def row(name, ks, epi, inp, cin_, bias, res, out, out_off, cout):
        hi, lo, np_ = packed[name]
        return (name, ks, epi, inp, cin_, hi.data_ptr(),
                lo.data_ptr() if lo is not None else None,
                bias.data_ptr() if bias is not None else None, res, out, out_off,
                cout, np_, plans[name]["splits"])

    rows = []
    if weights.lead_w is not None:
        rows.append(row("lead", 3, _EPI_BIAS_LEAKY, "x", cin, weights.lead_b, None,
                        "feats", 0, nf))
    for i, bias in enumerate(weights.growth_b):
        c = nf + i * growth
        rows.append(row(f"growth{i}", 3, _EPI_BIAS_LEAKY, "feats", c, bias, None,
                        "feats", c, growth))
    rows.append(row("lff", 1, _EPI_BIAS_RESIDUAL, "feats", width, weights.lff_b,
                    "feats", "rdb", 0, nf))
    if weights.res0_w is not None:
        rows.append(row("res0", 3, _EPI_PLAIN, "rdb", nf, None, None, "c0", 0, nf))
    # one scratch for the split-K partial sums of every conv of the call
    ws_floats = max([r[-1] * b * h * wd * r[11] for r in rows if r[-1] > 1], default=0)
    table = weights._launch_tables[key] = (rows, ws_floats)
    return table


def _fused_rdb_chain_cuda(x, weights: FusedChainWeights, growth, n_growth):
    from ._build import load_fused_block

    b, h, wd, cin = x.shape
    nf = weights.nf
    width = nf + n_growth * growth
    code = _DTYPE_CODE[x.dtype]
    chunk = _chunk(x.dtype)
    if not x.is_contiguous() or not all(
            t.is_contiguous() for t in weights._tensors() if t is not None):
        raise ValueError("fused_rdb_chain needs contiguous x and weights")
    if nf % chunk or growth % chunk:
        raise ValueError(f"the kernel needs nf and growth in multiples of "
                         f"{chunk} channels (16 bytes); got nf={nf}, growth={growth}")
    if cin % chunk:  # the lead conv's x (Cin = 2): TMA rows must be 16 bytes
        x = F.pad(x, (0, chunk - cin % chunk))
    if x.data_ptr() % 16:
        x = x.clone()
    lib = load_fused_block()
    rows, ws_floats = _launch_table(weights, b, h, wd, x.shape[-1], growth, n_growth)
    stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
    # the growing NHWC feature buffer: conv i reads channels [0, c) and
    # writes [c, c + growth) in place
    feats = torch.empty((b, h, wd, width), dtype=x.dtype, device=x.device)
    rdb_out = torch.empty((b, h, wd, nf), dtype=x.dtype, device=x.device)
    c0 = torch.empty_like(rdb_out) if weights.res0_w is not None else None
    ws = (torch.empty(ws_floats, dtype=torch.float32, device=x.device)
          if ws_floats else None)
    ws_ptr = ws.data_ptr() if ws is not None else None
    bufs = {name: (t.data_ptr(), t.shape[-1]) for name, t in
            (("x", x), ("feats", feats), ("rdb", rdb_out), ("c0", c0)) if t is not None}
    with torch.cuda.device(x.device):
        if weights.lead_w is None:
            feats[..., :nf].copy_(x)
        for (name, ks, epi, inp, cin_, hi, lo, bias, res, out, out_off, cout, np_,
             splits) in rows:
            res_ptr, res_stride = bufs[res] if res else (None, 0)
            err = lib.idt_chain_conv(
                code, ks, epi, *bufs[inp], cin_, hi, lo, bias, res_ptr, res_stride,
                *bufs[out], out_off, cout, np_, splits, ws_ptr if splits > 1 else None,
                b, h, wd, stream)
            if err != 0:
                raise RuntimeError(
                    f"fused_block conv kernel launch failed: CUDA error {err} "
                    f"({name}: ks={ks}, epi={epi}, cin={cin_}, cout={cout}, "
                    f"shape={b}x{h}x{wd}, {splits} K splits)")
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
